"""Full reference training protocol on synthetic KITTI, end to end, in the port:
``python -m frustum_convnet_tpu_torch.tools.run_synth_protocol [--device cuda] [--dtype float32] [--epochs 50] [--override KEY VALUE]...``

Counterpart of ``tools/run_synth_protocol.py``: synthetic KITTI generation
(``data/kitti/synthetic``) -> the stage-1 prep CLI (perturbed x5 train / val /
rgb-detection pickles) -> ``engine.train`` on ``cfgs/det_sample.yaml``
verbatim (+ overrides) -> ``engine.test`` on the rgb-detection split with
``model_best.pth`` -> the official-protocol Car AP. The dataset's cache key
(``proto-v1`` or ``proto-v2-mix``, frames and cars) and the generator seed
are the JAX tool's, so both write the same synthetic set and the same
pickles, and a port run compares with a JAX control row on the same data.

It prints ``PROTOCOL_RESULT {json}`` and writes ``protocol_result.json`` into
the run's ``OUTPUT_DIR``, with the JAX tool's keys. The synthetic protocol's
ceiling is 90.91 (41-point AP with perfect recall).
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(tempfile.gettempdir(), "fcn_tpu_protocol")


def build_dataset(frames: int, cars: int, cache_root: str, workers: int,
                  difficulty_mix: bool = False):
    """Synthetic raw KITTI + stage-1 pickles, cached by generation key.
    Returns (kitti_root, pickle_dir)."""
    from frustum_convnet_tpu_torch.data.kitti import prepare
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti

    gen = "proto-v2-mix" if difficulty_mix else "proto-v1"
    key = hashlib.md5(f"{gen}-{frames}-{cars}".encode()).hexdigest()[:10]
    root = os.path.join(cache_root, f"synth_{key}")
    kitti_root = os.path.join(root, "kitti_raw")
    pickle_dir = os.path.join(root, "pickles")
    done = os.path.join(pickle_dir, ".done")
    if not os.path.exists(done):
        t0 = time.time()
        make_synthetic_kitti(kitti_root, num_frames=frames,
                             cars_per_frame=cars, seed=1,
                             difficulty_mix=difficulty_mix)
        prepare.main([
            "--gen_train", "--gen_val", "--gen_val_rgb_detection",
            "--car_only", "--data_root", kitti_root,
            "--save_dir", pickle_dir,
            "--rgb_det_dir", os.path.join(kitti_root, "rgb_detections"),
            "--workers", str(workers),
        ])
        with open(done, "w") as f:
            f.write("ok\n")
        print(f"prepared synthetic protocol data in {time.time() - t0:.1f}s "
              f"-> {root}", flush=True)
    return kitti_root, pickle_dir


def common_args(description: str) -> argparse.ArgumentParser:
    """The arguments both runners share (the JAX tools' plus ``--device``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--cars", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    ap.add_argument("--tag", default=None, help="output dir suffix")
    ap.add_argument("--cache", default=DEFAULT_CACHE)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    ap.add_argument("--override", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"),
                    help="extra cfg override pairs, e.g. "
                         "--override TRAIN.BATCH_SIZE 128 "
                         "--override TRAIN.BASE_LR 0.004 (linear-scaling rule)")
    return ap


def run_overrides(pickle_dir: str, out_dir: str, args) -> list:
    """The cfg overrides of both CLIs: the JAX tools', then ``--override``."""
    overrides = [
        "DATA.DATA_ROOT", pickle_dir,
        "OUTPUT_DIR", out_dir,
        "TRAIN.MAX_EPOCH", str(args.epochs),
        "TPU.COMPUTE_DTYPE", args.dtype,
        "USE_TFBOARD", "True",
    ]
    for k, v in args.override:
        overrides += [k, v]
    return overrides


def train_then_test(cfg_path: str, overrides: list, device: str, weights_key: str,
                    kitti_root: str, label: str, matmul_precision: str = "highest"):
    """``engine.train.main``, then ``engine.test.main`` with the run's
    ``model_<weights_key>.pth`` on the rgb-detection split. Returns
    (train seconds, AP results).

    The port keeps no module-global cfg, so nothing is reset between the two
    calls; what the train call leaves in the process is checked instead: the
    float32 backend flags are still the strict ones (the diagnostic
    ``matmul_precision`` is the training call's alone: the trainer sets it
    back), and the trained model and optimizer state are dropped and the
    CUDA cache emptied before the test call builds its own model from the
    checkpoint.
    """
    from frustum_convnet_tpu_torch.engine import checkpoints
    from frustum_convnet_tpu_torch.engine import test as test_cli
    from frustum_convnet_tpu_torch.engine import train as train_cli

    t0 = time.time()
    res = train_cli.main(["--cfg", cfg_path, "--device", device] + overrides,
                         matmul_precision=matmul_precision)
    train_s = time.time() - t0
    steady = [e["ms_per_step"] for e in res["epochs"][1:]] or [
        e["ms_per_step"] for e in res["epochs"]]
    print(f"{label}training done in {train_s:.0f}s; median ms/step after the "
          f"first epoch {sorted(steady)[len(steady) // 2]:.3f}", flush=True)
    out_dir = res["output_dir"]
    del res
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 was turned on during training" + (
            f" (--matmul_precision {matmul_precision})"
            if matmul_precision != "highest" else ""))

    weights = checkpoints.checkpoint_paths(out_dir)[weights_key]
    results = test_cli.main([
        "--cfg", cfg_path, "--device", device,
        "--gt_dir", os.path.join(kitti_root, "training", "label_2"),
        "--idx_path", os.path.join(kitti_root, "image_sets", "val.txt"),
    ] + overrides + ["TEST.WEIGHTS", weights])["ap"]
    return train_s, results


def ap_summary(results) -> dict:
    """The JAX tools' AP keys: 3D and BEV AP (easy, moderate, hard) per class."""
    return {
        "ap": {k: [round(x, 2) for x in v["detection_3d"]]
               for k, v in (results or {}).items()},
        "ap_bev": {k: [round(x, 2) for x in v["detection_ground"]]
                   for k, v in (results or {}).items()},
    }


def write_result(summary: dict, out_dir: str) -> None:
    print("PROTOCOL_RESULT " + json.dumps(summary), flush=True)
    with open(os.path.join(out_dir, "protocol_result.json"), "w") as f:
        json.dump(summary, f, indent=2)


def main(argv=None) -> dict:
    """Run the protocol; returns the ``PROTOCOL_RESULT`` summary."""
    ap = common_args("Stage-1 training protocol on synthetic KITTI (PyTorch)")
    ap.add_argument("--difficulty_mix", action="store_true",
                    help="generate easy/moderate/hard GT populations "
                         "(occlusion slices, truncation, sparse far objects) "
                         "so the three KITTI difficulty gates separate; "
                         "APs are NOT comparable to the v1 protocol band")
    ap.add_argument("--matmul_precision", default="highest",
                    choices=("highest", "medium"),
                    help="diagnostic, not a recipe: the float32 matmul "
                         "precision of the training call only "
                         "(torch.set_float32_matmul_precision; the "
                         "convolutions and serving stay strict float32). "
                         "The JAX rows were trained where float32 matmuls "
                         "run single-pass bfloat16")
    args = ap.parse_args(argv)

    kitti_root, pickle_dir = build_dataset(args.frames, args.cars, args.cache,
                                           args.workers,
                                           difficulty_mix=args.difficulty_mix)
    tag = args.tag or (f"{args.dtype}_{args.epochs}ep"
                       + ("_mix" if args.difficulty_mix else ""))
    out_dir = os.path.join(args.cache, f"run_{tag}")
    train_s, results = train_then_test(
        os.path.join(ROOT, "cfgs", "det_sample.yaml"),
        run_overrides(pickle_dir, out_dir, args), args.device, "best",
        kitti_root, "", matmul_precision=args.matmul_precision)

    summary = {
        "dtype": args.dtype,
        "epochs": args.epochs,
        "frames": args.frames,
        "difficulty_mix": args.difficulty_mix,
        "overrides": args.override,
        "train_seconds": round(train_s, 1),
        **ap_summary(results),
    }
    if args.matmul_precision != "highest":
        summary["matmul_precision"] = args.matmul_precision
    write_result(summary, out_dir)
    return summary


if __name__ == "__main__":
    main()
