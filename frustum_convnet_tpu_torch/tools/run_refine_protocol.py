"""Refinement-stage training protocol on synthetic KITTI, end to end, in the port:
``python -m frustum_convnet_tpu_torch.tools.run_refine_protocol --stage1 <stage-1 OUTPUT_DIR> [--device cuda] [--dtype float32] [--override KEY VALUE]...``

Counterpart of ``tools/run_refine_protocol.py``, following the reference
cascade (``scripts/car_all.sh:7-17``, ``scripts/car_train_refine.sh``): a
trained stage-1 run's val detections (the ``val_nms/result/data`` KITTI label
files a stage-1 protocol run leaves behind) are re-cut into refine frustums by
the port's ``data.kitti.prepare_refine`` (GT-jittered x5 train path, the
labeled val path and the rgb-detection val path from the stage-1 results),
then ``cfgs/refine_car.yaml`` is trained verbatim (50 epochs, 512 points,
strides 0.1..0.8) and evaluated against the synthetic GT with the
official-protocol Car AP.

The reference evaluates the final epoch's checkpoint
(``scripts/car_train_refine.sh:9``), and so does this runner
(``model_final.pth``): the refine stage's in-loop IoU_0.7 saturates at 1.0
within a few epochs on the synthetic cascade, so best-selection would stop
on an early checkpoint with an unconverged heading head.
"""

from __future__ import annotations

import os
import time

from frustum_convnet_tpu_torch.tools.run_synth_protocol import (
    ROOT, ap_summary, build_dataset, common_args, run_overrides, train_then_test,
    write_result)


def build_refine_pickles(kitti_root: str, stage1_results: str, out_dir: str,
                         workers: int):
    """Refine-stage pickles: GT train path + stage-1-detections val path."""
    from frustum_convnet_tpu_torch.data.kitti import prepare_refine

    done = os.path.join(out_dir, ".done")
    if os.path.exists(done):
        return
    t0 = time.time()
    prepare_refine.main([
        "--gen_train", "--gen_val", "--gen_val_rgb_detection", "--car_only",
        "--data_root", kitti_root,
        "--save_dir", out_dir,
        "--val_res_dir", stage1_results,
        "--workers", str(workers),
    ])
    with open(done, "w") as f:
        f.write("ok\n")
    print(f"prepared refine pickles in {time.time() - t0:.1f}s -> {out_dir}",
          flush=True)


def main(argv=None) -> dict:
    """Run the protocol; returns the ``PROTOCOL_RESULT`` summary."""
    ap = common_args("Refine-stage training protocol on synthetic KITTI (PyTorch)")
    ap.add_argument("--stage1", required=True,
                    help="stage-1 protocol OUTPUT_DIR whose val_nms results "
                         "seed the refine val frustums")
    args = ap.parse_args(argv)

    kitti_root, _ = build_dataset(args.frames, args.cars, args.cache,
                                  args.workers)
    stage1_results = os.path.join(args.stage1, "val_nms", "result", "data")
    if not os.path.isdir(stage1_results):
        raise FileNotFoundError(f"no stage-1 results at {stage1_results}")
    s1tag = os.path.basename(os.path.normpath(args.stage1))
    refine_pickles = os.path.join(args.cache, f"refine_pickles_{s1tag}")
    build_refine_pickles(kitti_root, stage1_results, refine_pickles,
                         args.workers)

    tag = args.tag or f"refine_{args.dtype}_{args.epochs}ep"
    out_dir = os.path.join(args.cache, f"run_{tag}")
    train_s, results = train_then_test(
        os.path.join(ROOT, "cfgs", "refine_car.yaml"),
        run_overrides(refine_pickles, out_dir, args), args.device, "final",
        kitti_root, "refine ")

    summary = {
        "stage": "refine",
        "dtype": args.dtype,
        "epochs": args.epochs,
        "frames": args.frames,
        "stage1": args.stage1,
        "weights": "model_final",
        "overrides": args.override,
        "train_seconds": round(train_s, 1),
        **ap_summary(results),
    }
    write_result(summary, out_dir)
    return summary


if __name__ == "__main__":
    main()
