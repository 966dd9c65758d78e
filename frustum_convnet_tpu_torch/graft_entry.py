"""The port's driver entry points: the single-card check and the multi-rank
dry-run.

Counterpart of ``__graft_entry__.py``:

* :func:`entry` returns the flagship's eval forward plus decode and its
  example arguments; on the card the call launches kernel 1 once;
* :func:`dryrun_multichip` runs ``n`` ranks over ``parallel/mesh.py``: one
  full train step of the tiny flagship (losses, gradients, Adam,
  global-batch BatchNorm) under an audit of its collectives, a grouped
  batch-sharded inference, weak scaling at 1, 2, 4, ... ranks, and one train
  step of the refine and SUN-RGBD families.

JAX runs the dry-run in one process over a mesh of devices. The port runs
one process a device, so the ranks are child processes
(``python -m frustum_convnet_tpu_torch.graft_entry rank <job.json>``) in a
process group: gloo on the CPU, NCCL when the machine has a card for each
rank, and gloo ranks sharing the card otherwise (NCCL refuses two ranks on
one card). Where JAX audits the compiled HLO, the port records the
collectives each rank issues (:func:`parallel.mesh.audit`).

    python -m frustum_convnet_tpu_torch.graft_entry [--device cpu]
    python -m frustum_convnet_tpu_torch.graft_entry multichip N [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.data.fixtures import make_batch
from frustum_convnet_tpu_torch.models.det import decode_outputs
from frustum_convnet_tpu_torch.models.net import FrustumConvNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_SEED = 3  # the JAX entry's PRNGKey(3)
STEPS = 6  # timed steps a weak-scaling level, after one warm-up step
RANK_TIMEOUT = 600  # seconds a run of ranks may take


def _flagship(tiny: bool = False):
    """(cfg, spec, model) of the flagship KITTI model at full width, or at
    the tests' tiny shapes."""
    cfg = configs.get_default_cfg()
    overrides = ["MODEL.FILE", "det_base", "DATA.WITH_EXTRA_FEAT", "False"]
    if tiny:
        overrides += ["DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "16"]
    configs.merge_cfg_from_list(overrides, cfg)
    spec = configs.get_model_spec(cfg)
    return cfg, spec, FrustumConvNet(spec)


def _spec_for(name: str, tiny: bool = True):
    """(cfg, spec, model) for a named experiment family, at tiny shapes."""
    cfg = configs.get_default_cfg()
    if name == "refine_car":
        configs.merge_cfg_from_file(os.path.join(ROOT, "cfgs", "refine_car.yaml"), cfg)
        if tiny:
            configs.merge_cfg_from_list(["DATA.NUM_SAMPLES", "128",
                                         "DATA.REFINE_MAX_SPAN", "6.4"], cfg)
    elif name == "det_sample_sunrgbd":
        configs.merge_cfg_from_file(
            os.path.join(ROOT, "cfgs", "det_sample_sunrgbd.yaml"), cfg)
        if tiny:
            configs.merge_cfg_from_list(["DATA.NUM_SAMPLES", "256",
                                         "DATA.MAX_DEPTH", "4"], cfg)
    else:
        raise ValueError(name)
    spec = configs.get_model_spec(cfg)
    return cfg, spec, FrustumConvNet(spec)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device='cpu' to run on the CPU")
    return dev


def _seeded(model: FrustumConvNet, device) -> FrustumConvNet:
    model.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    return model.to(device)


def entry(device="cuda"):
    """(fn, example_args): the flagship's eval forward plus decode.

    ``fn(model, pts, one_hot, refs)`` runs the model in eval mode and
    decodes ``refs[1]`` (``models/det.decode_outputs``); the example
    arguments are the model at full width with the port's seeded init (an
    explicit ``torch.Generator``, seed 3) and ``data/fixtures.make_batch``
    at batch 4, seed 0, on ``device``."""
    dev = _device(device)
    _cfg, spec, model = _flagship(tiny=False)
    _seeded(model, dev).eval()
    batch = make_batch(spec, batch=4, seed=0, with_labels=False)
    pts = torch.from_numpy(batch["point_cloud"]).to(dev)
    one_hot = torch.from_numpy(batch["one_hot"]).to(dev)
    refs = tuple(torch.from_numpy(r).to(dev) for r in batch["refs"])

    @torch.inference_mode()
    def forward(model, pts, one_hot, refs):
        cls_logits, reg = model(pts, one_hot, list(refs))
        return decode_outputs(spec, cls_logits, reg, refs[1])

    return forward, (model, pts, one_hot, refs)


def check_step_collectives(records, params) -> dict:
    """Hold one train step's collectives (``mesh.audit`` records) to the
    JAX dry-run's audit (``__graft_entry__.py:236-240``): only all-reduces;
    one of them, a dtype, the flat gradient buffer of the parameters of
    that dtype; every other no larger than twice the largest parameter's
    bytes. The BatchNorm statistics, loss normalisers and metrics are
    channel-sized, so a batch-sized activation breaks the bound. Raises
    AssertionError; returns {"counts", "largest", "bound"} in bytes."""
    params = [p for p in params if p.grad is not None]
    counts = collections.Counter(r.kind for r in records)
    if set(counts) - {"all-reduce"}:
        raise AssertionError(f"the step issued collectives other than all-reduce: "
                             f"{dict(counts)}")
    bound = 2 * max(p.numel() * p.element_size() for p in params)
    numel = collections.Counter()
    for p in params:
        numel[p.dtype] += p.numel()
    rest = list(records)
    for dtype, n in numel.items():
        flat = [r for r in rest if r.dtype == dtype and r.shape == (n,)]
        if len(flat) != 1:
            raise AssertionError(f"{len(flat)} all-reduces of the {dtype} gradient "
                                 f"buffer ({n} elements), want 1")
        rest.remove(flat[0])
    over = [r for r in rest if r.nbytes > bound]
    if over:
        raise AssertionError(f"{len(over)} all-reduces over the bound of {bound} bytes "
                             f"(twice the largest parameter): {over[:4]}")
    return {"counts": dict(counts), "largest": max((r.nbytes for r in rest), default=0),
            "bound": bound}


def _rank_batch(spec, world: int, rank: int, seed: int, device) -> dict:
    """This rank's 2 frustums of the global batch of 2 a rank."""
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    full = make_batch(spec, batch=2 * world, seed=seed, with_labels=True)
    lo, hi = 2 * rank, 2 * rank + 2
    return ts.to_device({k: (tuple(r[lo:hi] for r in v) if k == "refs" else v[lo:hi])
                         for k, v in full.items()}, device)


def _train_state(spec, model, device):
    """(state, step): the seeded model on ``device`` with Adam, and the train
    step of the JAX dry-run's ``TrainStepConfig(steps_per_epoch=10)``."""
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    cfg = ts.TrainStepConfig(steps_per_epoch=10)
    model = _seeded(model, device)
    state = ts.TrainState(model, ts.make_optimizer(model.parameters(), cfg),
                          ts.multistep_lr(cfg))
    return state, ts.build_train_step(spec, cfg)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(job_path: str) -> int:
    """One rank of :func:`dryrun_multichip`: joins the group the environment
    names, runs the job and writes what it saw to ``<out>.rank<r>.json``."""
    from frustum_convnet_tpu_torch.engine.test import build_infer_group_fn, strict_fp32
    from frustum_convnet_tpu_torch.ops import select_cuda
    from frustum_convnet_tpu_torch.parallel import mesh

    with open(job_path) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mesh.maybe_initialize_distributed(dev, backend=job["backend"])
    dev = mesh.rank_device(dev)
    strict_fp32()
    rank, world = mesh.process_index(), mesh.process_count()
    select_cuda.group_depth_point_multi_cuda.launches = 0
    forwards = 0
    out = {"rank": rank, "world": world, "backend": mesh.backend()}
    try:
        _cfg, spec, model = _flagship(tiny=True)
        state, step = _train_state(spec, model, dev)
        batch = _rank_batch(spec, world, rank, 0, dev)
        with mesh.audit() as records:
            losses, metrics = step(state, batch)
            _sync(dev)
        forwards += 1
        out["audit"] = check_step_collectives(records, state.model.parameters())
        out["total_loss"] = losses["total_loss"].item()
        if not np.isfinite(out["total_loss"]):
            raise AssertionError(f"rank {rank}: total_loss {losses}")
        if job["full"]:
            out["IoU_3D"] = metrics["IoU_3D"].item()
            out["step"] = state.step
            # the test driver's grouped dispatch on this rank's shard: a
            # group of one batch of 2 frustums, as one device of the JAX mesh
            infer = build_infer_group_fn(state.model.eval(), spec, "nms")
            packed, cnt = infer(batch["point_cloud"][None], batch["one_hot"][None],
                                tuple(r[None] for r in batch["refs"]))
            forwards += 1
            if packed.shape[:2] != (1, 2) or not torch.isfinite(packed).all():
                raise AssertionError(f"rank {rank}: packed {tuple(packed.shape)} "
                                     f"or non-finite")
            out["infer_dets"] = int(cnt.sum())
        if job["time"]:
            step(state, batch)  # warm-up
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(STEPS):
                losses, _ = step(state, batch)
            _sync(dev)
            out["step_s"] = (time.perf_counter() - t0) / STEPS
            forwards += 1 + STEPS
        if job["full"]:
            out["families"] = {}
            for fam in ("refine_car", "det_sample_sunrgbd"):
                _cfg_f, spec_f, model_f = _spec_for(fam, tiny=True)
                state_f, step_f = _train_state(spec_f, model_f, dev)
                losses_f, _ = step_f(state_f, _rank_batch(spec_f, world, rank, 1, dev))
                forwards += 1
                lf = losses_f["total_loss"].item()
                if not np.isfinite(lf):
                    raise AssertionError(f"rank {rank} {fam}: {losses_f}")
                out["families"][fam] = {"total_loss": lf, "scales": spec_f.num_scales}
        out["launches"] = select_cuda.group_depth_point_multi_cuda.launches
        out["forwards"] = forwards
    finally:
        mesh.shutdown()
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(job: dict, world: int, work: str, tag: str) -> list:
    """``world`` child ranks of ``job``; their outputs, by rank. A rank that
    fails or outlasts ``RANK_TIMEOUT`` raises, with its log's tail."""
    job = dict(job, out=os.path.join(work, tag))
    path = os.path.join(work, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    try:
        for rank in range(world):
            log = open(os.path.join(work, f"{tag}.rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "frustum_convnet_tpu_torch.graft_entry", "rank", path],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, FRUSTUM_COORDINATOR=f"localhost:{port}",
                         FRUSTUM_NUM_PROCESSES=str(world), FRUSTUM_PROCESS_ID=str(rank))),
                log))
        deadline = time.monotonic() + RANK_TIMEOUT
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        if p.returncode:
            with open(os.path.join(work, f"{tag}.rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"dry-run {tag}: rank {rank} exited {p.returncode}:\n{tail}")
    outs = []
    for rank in range(world):
        with open(f"{job['out']}.rank{rank}.json") as f:
            outs.append(json.load(f))
    return outs


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full data-parallel train step, grouped inference, weak scaling
    and the other families on ``n_devices`` ranks (``__graft_entry__.
    dryrun_multichip``). Prints the JAX dry-run's lines and returns
    {"total_loss", "IoU_3D", "step", "infer_dets", "backend", "scaling":
    [(ranks, step seconds, collective counts)], "families", "audits",
    "launches", "forwards"}: ``launches`` counts kernel 1 over every rank
    of every run, ``forwards`` the model forwards they ran.

    The ranks share the host, and the card when there are fewer cards than
    ranks, so per-step time may grow about linearly with the ranks; JAX's
    loose bound, ``dt_n <= 4 * n * dt_1 + 0.5`` s, catches only an
    order-of-magnitude pathology. The byte audit of each level's first step
    is the precise gate."""
    dev = _device(device)
    backend = ("nccl" if dev.type == "cuda" and torch.cuda.device_count() >= n_devices
               else "gloo")
    levels = [1 << i for i in range(n_devices.bit_length()) if 1 << i <= n_devices]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-") as work:
        for nd in sorted(set(levels) | {n_devices}):
            job = {"device": dev.type, "backend": backend, "full": nd == n_devices,
                   "time": nd in levels}
            runs[nd] = _run_ranks(job, nd, work, f"world{nd}")
    full = runs[n_devices]
    total, iou = full[0]["total_loss"], full[0]["IoU_3D"]
    if any(r["total_loss"] != total for r in full):
        raise AssertionError(f"the ranks' global losses differ: {[r['total_loss'] for r in full]}")
    dets = sum(r["infer_dets"] for r in full)
    print(f"dryrun_multichip({n_devices}): total_loss={total:.4f} IoU_3D={iou:.3f} "
          f"step={full[0]['step']} infer_dets={dets}")
    scaling = [(nd, max(r["step_s"] for r in runs[nd]), runs[nd][0]["audit"]["counts"])
               for nd in levels]
    t1 = scaling[0][1]
    for nd, dt, counts in scaling:
        print(f"weak_scaling devices={nd} per_device_batch=2 step_ms={dt * 1e3:.1f} "
              f"ratio_vs_1dev={dt / t1:.2f} collectives={counts}")
    nd_max, dt_max, _ = scaling[-1]
    if not dt_max <= 4.0 * nd_max * t1 + 0.5:
        raise AssertionError(f"weak scaling past the bound: {scaling}")
    for fam, res in full[0]["families"].items():
        print(f"dryrun_multichip({n_devices}) family={fam} "
              f"total_loss={res['total_loss']:.4f} scales={res['scales']}")
    ranks = [r for outs in runs.values() for r in outs]
    return {"total_loss": total, "IoU_3D": iou, "step": full[0]["step"], "infer_dets": dets,
            "backend": full[0]["backend"], "scaling": scaling,
            "families": full[0]["families"],
            "audits": {nd: outs[0]["audit"] for nd, outs in runs.items()},
            "launches": sum(r["launches"] for r in ranks),
            "forwards": sum(r["forwards"] for r in ranks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="entry", choices=["entry", "multichip", "rank"])
    ap.add_argument("arg", nargs="?", default=None,
                    help="multichip: the number of ranks (default 8); rank: the job file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "rank":
        return rank_main(args.arg)
    if args.mode == "multichip":
        dryrun_multichip(int(args.arg or 8), args.device)
        return 0
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry forward OK:", {k: tuple(v.shape) for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
