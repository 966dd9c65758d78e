"""End-to-end test-driver throughput on synthetic KITTI at reference shapes:
``python -m frustum_convnet_tpu_torch.tools.bench_driver [--frames 2000] [--cars 2] [--sweep 8:2,8:4,16:2] [--dtypes float16,float32] [--method top|nms] [--device cuda]``

Counterpart of ``tools/bench_driver.py``. Measures what the bench cannot:
the full streaming driver (``engine.test.run_test``) including host
batching, the host-to-device upload, the grouped forward, the device-to-host
copy of the compacted selections and the numpy decode — the rebuild of the
reference hot path ``train/test_net_det.py:204-293``.

Generates (and caches, under the JAX tool's key) a synthetic KITTI val split
with the port's generator, preps frustum pickles with the port's prep at
the flagship config's shapes (1024 points, MAX_DEPTH 70, strides
.25/.5/1/2), seeds the model, and streams the whole set. For each (point
upload dtype, group, inflight) combination it logs the driver's lines and
prints ``run_test``'s stats as one JSON line: the frustums/s, the frustums
streamed, the overflow re-runs, the host seconds and entries of each of the
``run_test``'s spans (``serve.upload``, ``serve.loader_wait``, ...) and kernel-1
launches. ``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(tempfile.gettempdir(), "fcn_torch_bench")


def build_dataset(frames: int, cars: int, cache_root: str):
    """Synthetic KITTI val frustums, cached by generation key; returns the
    pickle directory."""
    from frustum_convnet_tpu_torch.data.kitti.prepare import extract_frustum_data
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti

    key = hashlib.md5(f"v1-{frames}-{cars}".encode()).hexdigest()[:10]
    root = os.path.join(cache_root, f"bench_driver_{key}")
    pickle_path = os.path.join(root, "pickles", "frustum_caronly_val.pickle")
    if not os.path.exists(pickle_path):
        kitti_root = os.path.join(root, "kitti_raw")
        t0 = time.time()
        make_synthetic_kitti(kitti_root, num_frames=frames,
                             cars_per_frame=cars, seed=1)
        os.makedirs(os.path.dirname(pickle_path), exist_ok=True)
        extract_frustum_data(
            os.path.join(kitti_root, "image_sets", "val.txt"), "training",
            pickle_path, kitti_root, perturb_box2d=False, augmentX=1,
            type_whitelist=("Car",))
        print(f"prepared synthetic val in {time.time() - t0:.1f}s -> {root}")
    return os.path.join(root, "pickles")


def main(argv=None) -> list:
    """Returns each combination's stats line (a dict)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--cars", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--method", default="top", choices=("top", "nms"))
    ap.add_argument("--sweep", default="8:2",
                    help="comma-separated group:inflight pairs")
    ap.add_argument("--dtypes", default="float16",
                    help="comma-separated point upload dtypes to sweep "
                         "(compare them within one process)")
    ap.add_argument("--cache", default=DEFAULT_CACHE)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass --device cpu to run on the CPU")

    from frustum_convnet_tpu_torch import bench, configs
    from frustum_convnet_tpu_torch.data.registry import get_provider_class
    from frustum_convnet_tpu_torch.engine.test import load_state_for_test, run_test
    from frustum_convnet_tpu_torch.ops.select_cuda import group_depth_point_multi_cuda
    from frustum_convnet_tpu_torch.utils.timing import card_name

    # resolve the config before the (expensive) dataset build, and anchor
    # the cfg path at the repo root so the script runs from any cwd
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(os.path.join(ROOT, "cfgs", "det_sample.yaml"), cfg)
    pickle_dir = build_dataset(args.frames, args.cars, args.cache)
    configs.merge_cfg_from_list(["DATA.DATA_ROOT", pickle_dir,
                                 "TEST.BATCH_SIZE", str(args.batch),
                                 "TEST.METHOD", args.method], cfg)
    configs.assert_and_infer_cfg(cfg)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger = logging.getLogger("bench_driver")

    spec = configs.get_model_spec(cfg)
    model = bench.seeded_model(spec, device,
                               dtype=configs.get_compute_dtype(cfg, train=False),
                               trunk_dtype=configs.get_trunk_dtype(cfg))
    provider_cls = get_provider_class(cfg)
    dataset = provider_cls(cfg, "val", one_hot=True)
    card = card_name(device)
    logger.info(f"val frustums: {len(dataset)} on {card}")

    load_state_for_test(model, cfg, logger)

    lines = []
    for dtype in args.dtypes.split(","):
        for pair in args.sweep.split(","):
            g, infl = (int(x) for x in pair.split(":"))
            logger.info(f"--- points_dtype={dtype} group={g} inflight={infl} ---")
            launches = group_depth_point_multi_cuda.launches
            t0 = time.time()
            _, stats = run_test(model, spec, dataset, args.batch, args.method,
                                logger, group=g, inflight=infl,
                                points_dtype=bench.DTYPES[dtype])
            wall = time.time() - t0
            logger.info(f"total wall {wall:.2f}s")
            line = {"points_dtype": dtype, "group": g, "inflight": infl,
                    "batch": args.batch, "method": args.method,
                    **{k: stats[k] for k in ("frustums", "frustums_per_s",
                                             "overflow_reruns", "spans")},
                    "launches": group_depth_point_multi_cuda.launches - launches,
                    "wall_s": wall, "device": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
