"""The serving job: ``engine.test.run_test`` over frustums made in set-up.

Set-up makes the traffic's frustums from the seed (``frozen.synthetic``),
the provider's served items of them (``frozen.items``), the weights on the
device (``reference.model.seeded_params``) with the cls head fitted to the
label rule on the reference's features (``frozen.fit_head``), loads a copy
into the program's detector and streams the whole split ``warm_calls``
times: the first builds kernel 1 where it is not built yet and warms every
shape. The window then calls ``run_test`` on the same split again and
again until ``seconds`` have passed, and the rate is every frustum the
calls streamed over the whole time from the first call's start to the last
call's end. Each call's detections are kept as the program returns them
and turned into arrays for the check after the window. With ``trace`` the
second call runs under the profiler, whose start, export and reduction are
left out of the rate.

After the window the program's model is freed and the reference works out
every section again; each call's detections are compared with it
(``reference.serve.compare``).

The window (``window``) is every serving job's; what is KITTI's is the
``Family`` it is handed (``KITTI``): set-up, how a call's detections become
the arrays the check reads, the check, the traced call's kernel-1 bound and
the counters of a call's stats. Another family's serving job is a module
whose ``run(job)`` calls ``window`` with a ``Family`` of its own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from bench_h100 import common
from bench_h100.frozen import items as frozen_items
from bench_h100.frozen.fit_head import fit_cls_head
from bench_h100.frozen.kernel1_cost import launch_bound
from bench_h100.reference import model as ref_model
from bench_h100.reference import serve as ref_serve
from bench_h100.reference.spec import ModelSpec
from bench_h100.trace import Traced

FIT_FRUSTUMS = 256
SIZE_RES_STD = 0.1

# the job's traffic at the CPU tests' size (bench_h100/tests/tiny.py) and at
# the card control test's (test_h100bench_control.py); ``cfg`` merges key by key
TINY = {"frustums": 64, "warm_calls": 1, "fit_frustums": 32,
        "cfg": {"TEST.BATCH_SIZE": 8, "TPU.INFER_GROUP": 2}}
SMALL = {"frustums": 1024}


class PreparedSplit:
    """A served split of prepared items, in the shape ``run_test`` reads: items
    by index (the loader's draw is ignored: the items are drawn already),
    ``ref_basis`` (the driver then rebuilds the ladders on the device),
    ``ref_depths()`` and ``data['id' | 'type' | 'box2d']``."""

    ref_basis = True

    def __init__(self, items: list, rec: dict, spec: ModelSpec):
        self.items = items
        self.data = {k: rec[k] for k in ("id", "type", "box2d")}
        self._depths = frozen_items.ref_depths(spec.strides, spec.max_depth)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int, rng=None) -> dict:
        return self.items[index]

    def ref_depths(self):
        return self._depths


def reference_inputs(items: list, upload_dtype: str) -> dict:
    """The inputs both sides take, stacked: the points as the upload dtype
    leaves them."""
    pts = np.stack([it["point_cloud"] for it in items])
    if upload_dtype == "float16":
        pts = pts.astype(np.float16).astype(np.float32)
    return {"points": pts,
            **{k: np.stack([np.asarray(it[k]) for it in items])
               for k in ("one_hot", "ref_dir", "ref_off", "rot_angle", "rgb_prob")}}


def fitted_params(spec: ModelSpec, seed: int, rec: dict, items: list, inputs: dict,
                  device, log, fit: int) -> dict:
    params = ref_model.seeded_params(spec, seed, device)
    n = min(fit, len(items))
    sub = {k: v[:n] for k, v in inputs.items()}
    with torch.no_grad():
        ref_model.strict_fp32()
        refs = ref_model.ladders(torch.from_numpy(sub["ref_dir"]).to(device),
                                 torch.from_numpy(sub["ref_off"]).to(device), spec)
        _, _, feats = ref_model.forward(params, spec, torch.from_numpy(sub["points"]).to(device),
                                        torch.from_numpy(sub["one_hot"]).to(device), refs)
    fg = np.stack([frozen_items.foreground(rec, i, items[i]["refs"][1]) for i in range(n)])
    log("[fit] " + fit_cls_head(params, feats, torch.from_numpy(fg)))
    # the seeded head's size residuals spread so wide that most boxes come
    # out with a negative side and are dropped; a trained head's stay near
    # the templates, so scale those rows to a spread of SIZE_RES_STD
    rows = slice(3 + 2 * spec.num_bins + spec.num_sizes, spec.reg_size)
    w = params["reg_out.weight"]
    spread = (feats.flatten(0, 1) @ w[rows, :, 0].T).std()
    w[rows] *= SIZE_RES_STD / spread
    return params


def prepare(job: dict) -> dict:
    """Set-up short of the warm pass: the inputs, the weights, the program's
    detector and ``serve()``, one call of ``run_test`` over the split."""
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.engine.test import run_test

    config, traffic, device, log = job["config"], job["traffic"], job["device"], job["log"]
    spec = ModelSpec.from_config(config["model"])
    cfg = common.program_cfg(config, traffic.get("cfg", {}))
    spec_p = configs.get_model_spec(cfg)
    common.check_spec(spec_p, spec)
    rng = np.random.default_rng(job["seed"])
    rec = common.frustum_records(config, traffic, rng, labeled=False)
    items = common.make_items(rec, spec, rng)
    log(f"[setup] {len(items)} items made at {time.time() - job['t_start']:.2f} s")
    split = PreparedSplit(items, rec, spec)
    inputs = reference_inputs(items, cfg.TPU.INFER_POINTS_DTYPE)
    params = fitted_params(spec, job["seed"], rec, items, inputs, device, log,
                           traffic.get("fit_frustums", FIT_FRUSTUMS))
    if device.type == "cuda":  # the fit's reference forward is not the program's peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model = common.program_model(spec_p, params, device,
                                 dtype=configs.get_compute_dtype(cfg, train=False))
    logger = common.quiet_logger()

    def serve():
        return run_test(model, spec_p, split, cfg.TEST.BATCH_SIZE, cfg.TEST.METHOD, logger,
                        group=cfg.TPU.INFER_GROUP, inflight=cfg.TPU.INFER_INFLIGHT,
                        points_dtype=configs.get_points_upload_dtype(cfg))

    log(f"[setup] inputs and weights ready at {time.time() - job['t_start']:.2f} s")
    return {"cfg": cfg, "spec": spec, "rec": rec, "inputs": inputs, "params": params,
            "model": model, "serve": serve,
            "frustum_of": {(int(f), tuple(float(v) for v in b)): i
                           for i, (f, b) in enumerate(zip(rec["id"], rec["box2d"]))}}


def release(s: dict, device) -> None:
    """Frees the program's detector before the reference runs."""
    s.pop("model", None)
    s.pop("serve", None)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check(s: dict, served: list, device) -> tuple:
    """The numbers of the detections ``served`` (``served_arrays`` of each
    call) against the reference, and the reference's table."""
    table = ref_serve.section_table(s["params"], s["spec"], s["inputs"], device)
    gaps = [ref_serve.compare(sv, table) for sv in served]
    return {"box_gap": max(g["box_gap"] for g in gaps),
            "decision_gap": max(g["decision_gap"] for g in gaps)}, table, gaps


def served_arrays(det, s: dict):
    """A call's detections as the arrays ``check`` reads."""
    return ref_serve.served_arrays(det, s["frustum_of"])


def kernel1(s: dict, device) -> tuple:
    """The traced call's kernel-1 bound (``serve_kernel1_bound``) and its
    launches, one a group of ``INFER_GROUP`` batches."""
    cfg = s["cfg"]
    return (serve_kernel1_bound(s["inputs"], s["spec"], cfg, device),
            len(s["inputs"]["points"]) // (cfg.TEST.BATCH_SIZE * cfg.TPU.INFER_GROUP))


@dataclasses.dataclass(frozen=True)
class Family:
    """What one family of frustums brings to the serving window.

    ``prepare(job)``: set-up short of the warm pass, a dict holding at least
    ``serve()`` (one call of the family's driver over the split, returning
    its detections and stats), ``model`` and ``spec``.
    ``arrays(det, s)``: a call's detections as the arrays ``check`` reads.
    ``check(s, served, device)``: the compared numbers over every call's
    arrays, the reference's table, and a call's gaps, each with ``served``
    and ``expected`` (detections served and due by the rule).
    ``kernel1(s, device)``: the least device seconds of the traced call's
    kernel-1 launches, and their count.
    ``counters``: keys of a call's stats that ``ctx`` sums over the calls.
    """

    prepare: Callable
    arrays: Callable
    check: Callable
    kernel1: Callable
    counters: tuple = ()


KITTI = Family(prepare, served_arrays, check, kernel1, counters=("overflow_reruns",))


def window(job: dict, family: Family) -> dict:
    """The warm calls, the timed calls (the second traced with ``trace``),
    then, with the program's model freed, the check of every call; the
    job's result."""
    device, log = job["device"], job["log"]
    s = family.prepare(job)
    for _ in range(job["traffic"]["warm_calls"]):  # the first builds and warms every shape
        s["serve"]()
    setup_s = time.time() - job["t_start"]
    log(f"[setup] warm pass done at {setup_s:.2f} s")
    calls, tr = [], None

    def elapsed():
        # the profiler's start, export and reduction are not the program's time
        return time.time() - t_first - (tr.overhead_s if tr is not None else 0.0)

    t_first = time.time()
    while not calls or elapsed() < job["seconds"] or (job["trace"] and len(calls) < 2):
        if job["trace"] and len(calls) == 1:
            tr = Traced(device)
            with tr:
                det, stats = s["serve"]()
        else:
            det, stats = s["serve"]()
        calls.append({"end": elapsed(), "frustums": stats["frustums"],
                      **{k: stats[k] for k in family.counters}, "det": det})
    window_s = calls[-1]["end"]
    frustums = sum(c["frustums"] for c in calls)
    log("[window] seconds a call " + " ".join(
        f"{b['end'] - a:.4f}" for a, b in zip([0.0] + [c["end"] for c in calls], calls)))
    device_numbers = common.device_info(device, job["chips"])
    release(s, device)

    t_check = time.time()
    served = [family.arrays(c.pop("det"), s) for c in calls]
    numbers, _, gaps = family.check(s, served, device)
    log(f"[check] {len(calls)} calls in {window_s:.2f} s; served {gaps[-1]['served']} "
        f"detections a call against {gaps[-1]['expected']} by the rule; the check took "
        f"{time.time() - t_check:.2f} s")
    summary = tr.summary if tr is not None else None
    ctx = {"job": "serve", "spec": s["spec"], "rate": frustums / window_s,
           "frustums": frustums,
           **{k: sum(c[k] for c in calls) for k in family.counters},
           "trace": summary, "kernel1_bound_s": None}
    if summary is not None:
        ctx["kernel1_bound_s"], ctx["kernel1_launches"] = family.kernel1(s, device)
    return {"end_to_end": {"serve_frustums_per_s": frustums / window_s, "setup_s": setup_s},
            "numbers": numbers, "attempted": frustums, "failed": 0,
            "device": device_numbers, "ctx": ctx, "window_s": window_s}


def run(job: dict) -> dict:
    return window(job, KITTI)


def readings(job: dict, control: bool) -> dict:
    """The check's numbers of one call of ``run_test`` over the split
    (``program``) and, with ``control``, those of the reference computed in
    TF32 put in the program's place, its detections by the serving rule
    (``control``)."""
    device = job["device"]
    s = prepare(job)
    det, _ = s["serve"]()
    release(s, device)
    out = {}
    out["program"], table, _ = check(s, [served_arrays(det, s)], device)
    if control:
        ctl = ref_serve.section_table(s["params"], s["spec"], s["inputs"], device,
                                      allow_tf32=True)
        dets = ref_serve.rule_detections(ctl, s["rec"]["id"], s["rec"]["box2d"])
        gaps = ref_serve.compare(served_arrays(dets, s), table)
        out["control"] = {k: gaps[k] for k in out["program"]}
    return out


def serve_kernel1_bound(inputs: dict, spec: ModelSpec, cfg, device) -> float:
    """The least device seconds of the traced call's kernel-1 launches: one a
    group of ``INFER_GROUP`` batches, on the points as uploaded and the
    ladders rebuilt from their basis."""
    per = cfg.TEST.BATCH_SIZE * cfg.TPU.INFER_GROUP
    total = 0.0
    for lo in range(0, len(inputs["points"]) - per + 1, per):
        sl = slice(lo, lo + per)
        pts = torch.from_numpy(inputs["points"][sl]).to(device)
        refs = ref_model.ladders(torch.from_numpy(inputs["ref_dir"][sl]).to(device),
                                 torch.from_numpy(inputs["ref_off"][sl]).to(device), spec)
        total += launch_bound(pts, refs, spec.height_half, spec.nsamples)["seconds"]
    return total
