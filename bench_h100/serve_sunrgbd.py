"""The SUN-RGBD serving job: ``engine.test_sunrgbd.run_test_sunrgbd`` over
frustums made in set-up.

Set-up makes the traffic's frustums from the seed
(``frozen.sunrgbd_synthetic``), the provider's served items of them
(``frozen.sunrgbd_items``), the weights on the device
(``reference.model.seeded_params``) with the cls head fitted to the
provider's section-label rule on the reference's features
(``frozen.fit_head``), and loads a copy into the program's detector. The
window is ``serve.window``'s, every serving job's; ``SUNRGBD`` is the
``serve.Family`` it is handed: its check recomputes every section with the
reference and applies SUN-RGBD's serving rule
(``reference.serve_sunrgbd``), and its traced call's kernel-1 bound is one
launch a group on the points as uploaded and the 5 ladders.

Each call of ``run_test_sunrgbd`` is recorded (``CALLS``): its frustums,
``fetch_waited``, ``spans`` and whether the profiler was recording. The
result's ``ctx`` gains ``groups`` (a call's) and ``calls``, the window's
calls, which ``postprocess_us_per_frustum.serve`` and
``fetch_waited_pct.serve`` read. A program whose ``run_test_sunrgbd``
reports no spans or no ``fetch_waited`` cannot run the job: the first call
raises.

Each call starts with ``gc.freeze()``: the window keeps every call's
detections until the check, 20 evaluation passes' worth of lists where a
deployment holds one, and without it Python's full collections walk that
heap inside later calls (93-347 ms a pass on the card). A call's own
objects are collected as they would be. ``run`` and ``readings`` unfreeze
when done.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_h100 import common, serve
from bench_h100.frozen import sunrgbd_items, sunrgbd_synthetic
from bench_h100.frozen.fit_head import fit_cls_head
from bench_h100.frozen.kernel1_cost import launch_bound
from bench_h100.reference import model as ref_model
from bench_h100.reference import serve as ref_serve
from bench_h100.reference import serve_sunrgbd as ref_sun
from bench_h100.reference.spec import ModelSpec

# the job's traffic at the CPU tests' size (bench_h100/tests/tiny.py) and at
# the card control test's (test_h100bench_control.py); ``cfg`` merges key by key
TINY = {"frustums": 32, "warm_calls": 1, "fit_frustums": 32,
        "cfg": {"TEST.BATCH_SIZE": 8, "TPU.INFER_GROUP": 2}}
SMALL = {"frustums": 1024}

CALLS: list = []  # every call of run_test_sunrgbd in this process, in order


class PreparedSplit:
    """A served split of prepared items, in the shape ``run_test_sunrgbd``
    reads: items by index (the loader's draw is ignored: the items are drawn
    already) and ``data['id' | 'type' | 'box2d']``."""

    def __init__(self, items: list, rec: dict):
        self.items = items
        self.data = {k: rec[k] for k in ("id", "type", "box2d")}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int, rng=None) -> dict:
        return self.items[index]


def reference_inputs(items: list, upload_dtype: str, scales: int) -> dict:
    """The inputs both sides take, stacked: the points as the upload dtype
    leaves them, the 5 ladders as they are."""
    pts = np.stack([it["point_cloud"] for it in items])
    if upload_dtype == "float16":
        pts = pts.astype(np.float16).astype(np.float32)
    return {"points": pts,
            "refs": [np.stack([it["refs"][i] for it in items]) for i in range(scales)],
            **{k: np.stack([np.asarray(it[k]) for it in items])
               for k in ("one_hot", "rot_angle", "rgb_prob")}}


def fitted_params(spec: ModelSpec, seed: int, rec: dict, items: list, inputs: dict,
                  device, log, fit: int) -> dict:
    """The seeded weights with the cls head fitted to the label rule on the
    first ``fit`` frustums and the size residuals scaled as
    ``serve.fitted_params`` scales KITTI's."""
    params = ref_model.seeded_params(spec, seed, device)
    n = min(fit, len(items))
    with torch.no_grad():
        ref_model.strict_fp32()
        _, _, feats = ref_model.forward(
            params, spec, torch.from_numpy(inputs["points"][:n]).to(device),
            torch.from_numpy(inputs["one_hot"][:n]).to(device),
            [torch.from_numpy(r[:n]).to(device) for r in inputs["refs"]])
    fg = np.stack([sunrgbd_items.foreground(rec, i, items[i]["refs"][1]) for i in range(n)])
    log("[fit] " + fit_cls_head(params, feats, torch.from_numpy(fg)))
    rows = slice(3 + 2 * spec.num_bins + spec.num_sizes, spec.reg_size)
    w = params["reg_out.weight"]
    spread = (feats.flatten(0, 1) @ w[rows, :, 0].T).std()
    w[rows] *= serve.SIZE_RES_STD / spread
    return params


def prepare(job: dict) -> dict:
    """Set-up short of the warm pass: the inputs, the weights, the program's
    detector and ``serve()``, one call of ``run_test_sunrgbd`` over the
    split."""
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.engine.test_sunrgbd import run_test_sunrgbd

    config, traffic, device, log = job["config"], job["traffic"], job["device"], job["log"]
    spec = ModelSpec.from_config(config["model"])
    cfg = common.program_cfg(config, traffic.get("cfg", {}))
    spec_p = configs.get_model_spec(cfg)
    common.check_spec(spec_p, spec)
    rng = np.random.default_rng(job["seed"])
    rec = sunrgbd_synthetic.make_frustums(rng, traffic["frustums"], tuple(config["classes"]),
                                          traffic.get("objects_per_frame", 4))
    items = sunrgbd_items.make_items(rec, spec.num_points, spec.strides, spec.max_depth, rng)
    log(f"[setup] {len(items)} items made at {time.time() - job['t_start']:.2f} s")
    split = PreparedSplit(items, rec)
    inputs = reference_inputs(items, cfg.TPU.INFER_POINTS_DTYPE, spec.num_scales)
    params = fitted_params(spec, job["seed"], rec, items, inputs, device, log,
                           traffic.get("fit_frustums", serve.FIT_FRUSTUMS))
    if device.type == "cuda":  # the fit's reference forward is not the program's peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model = common.program_model(spec_p, params, device,
                                 dtype=configs.get_compute_dtype(cfg, train=False))
    logger = common.quiet_logger()

    def run_call():
        gc.freeze()  # the heap of the calls before this one: see the module's docstring
        det, stats = run_test_sunrgbd(model, spec_p, split, cfg.TEST.BATCH_SIZE,
                                      cfg.TEST.METHOD, logger, group=cfg.TPU.INFER_GROUP,
                                      inflight=cfg.TPU.INFER_INFLIGHT,
                                      points_dtype=configs.get_points_upload_dtype(cfg))
        if "spans" not in stats or "fetch_waited" not in stats:
            raise RuntimeError("the program's run_test_sunrgbd reports no spans or no "
                               "fetch_waited: it does not run the group pipeline this job "
                               "measures")
        CALLS.append({"frustums": stats["frustums"], "fetch_waited": stats["fetch_waited"],
                      "spans": stats["spans"],
                      "profiled": torch.autograd._profiler_enabled()})
        return det, stats

    log(f"[setup] inputs and weights ready at {time.time() - job['t_start']:.2f} s")
    return {"cfg": cfg, "spec": spec, "rec": rec, "inputs": inputs, "params": params,
            "model": model, "serve": run_call,
            "frustum_of": {(int(f), tuple(float(v) for v in b)): i
                           for i, (f, b) in enumerate(zip(rec["id"], rec["box2d"]))}}


def check(s: dict, served: list, device) -> tuple:
    """The numbers of the detections ``served`` (``arrays`` of each call)
    against the reference, and the reference's table."""
    table = ref_sun.section_table(s["params"], s["spec"], s["inputs"], device)
    gaps = [ref_sun.compare(sv, table, s["cfg"].TEST.METHOD) for sv in served]
    return {"box_gap": max(g["box_gap"] for g in gaps),
            "decision_gap": max(g["decision_gap"] for g in gaps)}, table, gaps


def arrays(det, s: dict):
    """A call's detections as the arrays ``check`` reads."""
    return ref_serve.served_arrays(det, s["frustum_of"])


def kernel1(s: dict, device) -> tuple:
    """The least device seconds of the traced call's kernel-1 launches, one
    a group of ``INFER_GROUP`` batches on the points as uploaded and the 5
    ladders, and their count."""
    cfg, spec, inputs = s["cfg"], s["spec"], s["inputs"]
    per = cfg.TEST.BATCH_SIZE * cfg.TPU.INFER_GROUP
    total, launches = 0.0, 0
    for lo in range(0, len(inputs["points"]) - per + 1, per):
        sl = slice(lo, lo + per)
        pts = torch.from_numpy(inputs["points"][sl]).to(device)
        refs = [torch.from_numpy(r[sl]).to(device) for r in inputs["refs"]]
        total += launch_bound(pts, refs, spec.height_half, spec.nsamples)["seconds"]
        launches += 1
    return total, launches


SUNRGBD = serve.Family(prepare, arrays, check, kernel1, counters=("fetch_waited",))


def run(job: dict) -> dict:
    CALLS.clear()
    try:
        out = serve.window(job, SUNRGBD)
    finally:
        gc.unfreeze()
    calls = CALLS[job["traffic"]["warm_calls"]:]
    out["ctx"].update(groups=calls[-1]["spans"]["serve.fetch"]["n"], calls=calls)
    return out


def readings(job: dict, control: bool) -> dict:
    """The check's numbers of one call of ``run_test_sunrgbd`` over the split
    (``program``) and, with ``control``, those of the reference computed in
    TF32 put in the program's place, its detections by the serving rule
    (``control``)."""
    device = job["device"]
    s = prepare(job)
    det, _ = s["serve"]()
    gc.unfreeze()
    serve.release(s, device)
    out = {}
    out["program"], table, _ = check(s, [arrays(det, s)], device)
    if control:
        method = s["cfg"].TEST.METHOD
        ctl = ref_sun.section_table(s["params"], s["spec"], s["inputs"], device,
                                    allow_tf32=True)
        dets = ref_sun.rule_detections(ctl, s["rec"]["id"], s["rec"]["box2d"], method)
        gaps = ref_sun.compare(arrays(dets, s), table, method)
        out["control"] = {k: gaps[k] for k in out["program"]}
    return out
