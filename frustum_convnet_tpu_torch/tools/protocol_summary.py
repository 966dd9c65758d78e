"""The readings of one protocol run, from the files it leaves:
``python -m frustum_convnet_tpu_torch.tools.protocol_summary RUN_DIR [--jax E M H] [--port_f32 E M H] [--gt_dir LABELS]``

RUN_DIR is a runner's ``OUTPUT_DIR`` (``<cache>/run_<tag>``) or the copy
``scripts/protocol_controls.sh`` keeps of it (``OUT/<run>``): its
``protocol_result.json``, ``train.log`` (every leg's lines, in order, when
the run was cut into legs) and the serving driver's ``test.log`` (in
``val_nms/result/`` or beside the others). Prints one JSON object:

* ``ap`` / ``ap_bev``: Car 3D and BEV AP (easy, moderate, hard), and with
  ``--jax`` / ``--port_f32`` the 3D AP's distance to those rows;
* ``train_seconds`` (the last leg's, from ``protocol_result.json``) and
  ``epoch_seconds`` (the sum of every epoch's time over all legs);
* ``ms_per_step``: the median ms/step of each compute dtype's epochs, not
  counting the first epoch of a leg (it carries the warm-up); an epoch
  computes in the run's ``dtype`` before the logged switch to float32 and
  in float32 from it;
* ``best_iou`` / ``best_epoch`` (the trainer's last "best" line), and
  ``val_iou``: the val IoU of every epoch;
* ``switch_epochs``: the epochs that logged the switch to float32, and
  ``finite``: whether every logged loss and metric is finite;
* ``launches``: kernel 1's launches in the run, as the drivers log the
  wrapper's count (every leg's training and the last leg's serving), or
  None for a run whose logs do not carry them;
* with ``--gt_dir`` (the split's ``label_2``), ``by_difficulty``: for BEV
  and 3D and each difficulty, the Car ground truths the evaluator counts,
  how many of them some detection overlaps at its IoU (0.7; their share is
  the recall the AP can reach) and the precision at the 11 recall samples
  the AP averages (0, 0.1, ..., 1), from the run's kept result files.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics

from frustum_convnet_tpu_torch.evaluation import kitti_eval

_LEG = re.compile(r"INFO config: ")
_DONE = re.compile(r"INFO epoch (\d+) done in ([\d.]+)s \(([\d.]+) ms/step.* "
                   r"IoU_[\d.]+=([\d.]+) best=")
_SWITCH = re.compile(r"INFO epoch (\d+): switching to float32")
_BEST = re.compile(r"training done; best IoU_[\d.]+=([\d.]+) at epoch (\d+)")
_VALUES = re.compile(r"(?:INFO epoch \d+ it \d+/\d+|INFO \[val\] epoch \d+) (.*)")
_LAUNCHES = re.compile(r"INFO (\d+) grouping kernel launches in (?:training|serving)")


def _find(run_dir: str, name: str) -> str:
    for path in (os.path.join(run_dir, name),
                 os.path.join(run_dir, "val_nms", "result", name)):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {name} in {run_dir}")


def parse_train_log(text: str, dtype: str) -> dict:
    """The trainer's log of a ``dtype`` run, leg by leg: each "config:" line
    starts a leg."""
    epochs, switches, launches, finite = {}, [], [], True
    best = None
    first_of_leg = False
    for line in text.splitlines():
        if _LEG.search(line):
            first_of_leg = True
        elif m := _DONE.search(line):
            e = int(m.group(1))
            f32 = bool(switches) and e >= switches[0]
            epochs[e] = {"seconds": float(m.group(2)), "ms_per_step": float(m.group(3)),
                         "iou": float(m.group(4)),
                         "dtype": "float32" if f32 else dtype,
                         "first_of_leg": first_of_leg}
            first_of_leg = False
        elif m := _SWITCH.search(line):
            switches.append(int(m.group(1)))
        elif m := _BEST.search(line):
            best = (float(m.group(1)), int(m.group(2)))
        elif m := _LAUNCHES.search(line):
            launches.append(int(m.group(1)))
        if m := _VALUES.search(line):
            nums = re.findall(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)", m.group(1),
                              flags=re.I)
            finite &= all(math.isfinite(float(v)) for v in nums)
    return {"epochs": epochs, "switches": switches, "best": best,
            "launches": launches, "finite": finite}


def by_difficulty(result_dir: str, gt_dir: str, cls: str = "car") -> dict:
    """{"bev" | "3d": [{"gt", "matched", "samples"} for each difficulty]} of
    the result files ``result_dir/*.txt``; see the module docstring."""
    gt_by_img, det_by_img = {}, {}
    for name in sorted(os.listdir(result_dir)):
        idx = int(os.path.splitext(name)[0])
        gt_by_img[idx] = kitti_eval.parse_label_file(
            os.path.join(gt_dir, f"{idx:06d}.txt"), is_det=False)
        det_by_img[idx] = kitti_eval.parse_label_file(
            os.path.join(result_dir, name), is_det=True)
    out = {}
    for key, metric in (("bev", 1), ("3d", 2)):
        cache, rows = {}, []
        for difficulty in range(3):
            n_gt = matched = 0
            for idx, gts in gt_by_img.items():
                dets = det_by_img[idx]
                ignored_gt, dontcare, ignored_det, n = kitti_eval.clean_data(
                    gts, dets, cls, difficulty)
                if idx not in cache:
                    cache[idx] = kitti_eval.pairwise_overlaps(gts, dets, dontcare, metric)
                # one score a matched ground truth (no score threshold)
                scores = kitti_eval.compute_statistics(
                    cls, gts, dets, dontcare, ignored_gt, ignored_det, compute_fp=False,
                    metric=metric, min_overlap=kitti_eval.MIN_OVERLAP[cls],
                    overlaps=cache[idx])[3]
                n_gt += n
                matched += len(scores)
            precision, _ = kitti_eval.eval_class(gt_by_img, det_by_img, cls, difficulty,
                                                 metric, ov_cache=cache)
            rows.append({"gt": n_gt, "matched": matched,
                         "samples": [round(float(p), 4) for p in precision[0::4]]})
        out[key] = rows
    return out


def summarize(run_dir: str, jax=None, port_f32=None, gt_dir=None) -> dict:
    """The readings of ``run_dir``; see the module docstring."""
    with open(_find(run_dir, "protocol_result.json")) as f:
        result = json.load(f)
    with open(_find(run_dir, "train.log")) as f:
        log = parse_train_log(f.read(), result["dtype"])
    with open(_find(run_dir, "test.log")) as f:
        served = [int(n) for n in _LAUNCHES.findall(f.read())]

    epochs = log["epochs"]
    steady = {}
    for e in sorted(epochs):
        if not epochs[e]["first_of_leg"]:
            steady.setdefault(epochs[e]["dtype"], []).append(epochs[e]["ms_per_step"])
    launches = sum(log["launches"] + served) if log["launches"] and served else None

    ap = result["ap"]["car"]
    out = {
        "run": os.path.basename(os.path.normpath(run_dir)),
        "ap": ap, "ap_bev": result["ap_bev"]["car"],
        "train_seconds": result["train_seconds"],
        "epoch_seconds": round(sum(e["seconds"] for e in epochs.values()), 1),
        "epochs": len(epochs),
        "ms_per_step": {k: round(statistics.median(v), 3) for k, v in steady.items()},
        "best_iou": log["best"][0] if log["best"] else None,
        "best_epoch": log["best"][1] if log["best"] else None,
        "val_iou": [epochs[e]["iou"] for e in sorted(epochs)],
        "switch_epochs": log["switches"],
        "finite": log["finite"],
        "launches": launches,
    }
    for key, row in (("delta_jax", jax), ("delta_port_f32", port_f32)):
        if row:
            out[key] = [round(a - b, 2) for a, b in zip(ap, row)]
    if gt_dir:
        out["by_difficulty"] = by_difficulty(_find(run_dir, "data"), gt_dir)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--jax", nargs=3, type=float, metavar=("E", "M", "H"),
                    help="the JAX row's Car 3D AP")
    ap.add_argument("--port_f32", nargs=3, type=float, metavar=("E", "M", "H"),
                    help="the port's float32 batch-32 row's Car 3D AP")
    ap.add_argument("--gt_dir", help="the split's label_2, for by_difficulty")
    args = ap.parse_args(argv)
    out = summarize(args.run_dir, args.jax, args.port_f32, args.gt_dir)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
