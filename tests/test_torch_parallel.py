"""Data parallelism of the port (``parallel/mesh.py``) on the CPU, over gloo.

Two child processes join one gloo group through the environment contract
(``FRUSTUM_COORDINATOR``, ``FRUSTUM_NUM_PROCESSES``, ``FRUSTUM_PROCESS_ID``)
and are held to one process on the same global batch, as
``tests/test_multihost.py`` holds the JAX package's processes to its single
process:

* the bootstrap with no environment (rank 0 of 1, chief, identity sum and
  gather), the environment parsed into ``init_process_group`` arguments, a
  device held by two NCCL ranks found, and a mesh other than the data axis
  over all ranks refused;
* one float64 train step at global batch 4 (2 a rank) of the tiny flagship,
  with sync BatchNorm, ghost BatchNorm (groups of the local batch),
  ``FAST_BN`` and ``REMAT_POINTNET``, and with all the foreground on one
  rank or the other: losses, metrics, gradients and the running
  statistics agree with the port's single-process step within 1e-10 of
  each tensor's magnitude, the parameters after one Adam step within that
  plus what Adam makes of the gradients' difference (at most lr / eps
  times it), the ranks' parameters and statistics are bitwise equal, and
  the sync step matches
  the JAX single-device step in x64 under ``test_torch_train_step.py``'s
  tolerances;
* ``engine.train.main`` on 2 ranks against one process (float32, 2 steps
  at batch 4, the second the metric-free twin, and a val set that leaves a
  global tail): one chief, which alone writes,
  bitwise-equal ranks, equal val metrics on both ranks, parameters,
  losses and val IoU within ``test_multihost.py``'s bounds of one process,
  and under 1% of the parameters' entries more than lr / 2 from it;
* ``engine.test.main`` on the stage-1 and refine configs and
  ``engine.test_sunrgbd.main`` on 2 ranks: the same result rows as one
  process (compared as ``test_multihost.py`` compares them) and AP, the
  detections merged on both ranks, and only the chief wrote;
* a batch that the world size does not divide, a ghost group that does not
  divide a rank's batch and a CUDA device that is not there raise on both
  ranks.

The loader keys each batch's item draws (point resampling, flip, shift) by
the process index, as the JAX loader does, so the trainer comparison runs
the provider through ``chip_smoke.FixedDraws``, whose draws depend on the
item alone;
serving shards whole batches and draws as one process does.

Run as a script, the file is a child rank and imports only the port:
``python tests/test_torch_parallel.py <job.json>``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from frustum_convnet_tpu_torch import configs  # noqa: E402
from frustum_convnet_tpu_torch.engine import checkpoints  # noqa: E402
from frustum_convnet_tpu_torch.engine import test as serve  # noqa: E402
from frustum_convnet_tpu_torch.engine import test_sunrgbd as serve_sun  # noqa: E402
from frustum_convnet_tpu_torch.engine import train as trainer  # noqa: E402
from frustum_convnet_tpu_torch.models.net import FrustumConvNet  # noqa: E402
from frustum_convnet_tpu_torch.parallel import mesh  # noqa: E402
from frustum_convnet_tpu_torch.parallel import train_step as ts  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-10
ADAM_GAIN = 1e-3 / 1e-8  # the step's learning rate over Adam's eps
CFG = os.path.join(ROOT, "cfgs", "det_sample.yaml")
REFINE_CFG = os.path.join(ROOT, "cfgs", "refine_car.yaml")
SUN_CFG = os.path.join(ROOT, "cfgs", "det_sample_sunrgbd.yaml")
STEP_OVERRIDES = ["MODEL.FILE", "det_base", "DATA.WITH_EXTRA_FEAT", "False",
                  "DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "16"]
TINY = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
        "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)", "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)",
        "NUM_WORKERS", "1"]
TINY_REFINE = ["DATA.NUM_SAMPLES", "128", "NUM_WORKERS", "1"]
TINY_SUN = ["DATA.NUM_SAMPLES", "256", "DATA.MAX_DEPTH", "4", "NUM_WORKERS", "1"]
# stage-1 serving: 15 frustums in 8 batches of 2, so one process and each of
# 2 ranks run every batch in a group of two (a batch left out of a group
# takes the full path, whose host-built ladders lie a rounding from the
# grouped path's device-built ones); the refine and SUN-RGBD providers
# carry no ladder basis, so their paths take the same ladders
SERVE = ["TEST.BATCH_SIZE", "2", "TPU.INFER_GROUP", "2"]
# variant, and the order of the edge batch's 4 frustums: items 0 (all
# ignore) and 1 (all background) go to rank 0, so the foreground lies on
# rank 1 alone, or on rank 0 alone in the last case
STEP_CASES = {"sync": ({}, [0, 1, 2, 3]), "ghost": ({"bn_group": 2}, [0, 1, 2, 3]),
              "fast_bn": ({"fast_bn": True}, [0, 1, 2, 3]),
              "remat": ({"remat_pointnet": True}, [0, 1, 2, 3]),
              "sync_fg_on_rank0": ({}, [2, 3, 0, 1])}


def _spec(cfg_file=None, overrides=()):
    cfg = configs.get_default_cfg()
    if cfg_file:
        configs.merge_cfg_from_file(cfg_file, cfg)
    configs.merge_cfg_from_list(list(overrides), cfg)
    return configs.get_model_spec(cfg)


def _shard(batch: dict, lo: int, hi: int) -> dict:
    return {k: (tuple(r[lo:hi] for r in v) if k == "refs" else v[lo:hi])
            for k, v in batch.items()}


def _step(spec, state_dict, batch, variant) -> dict:
    """One float64 train step with Adam; what it leaves behind."""
    model = FrustumConvNet(spec, **variant).to(torch.float64)
    model.load_state_dict(state_dict, strict=True)
    cfg = ts.TrainStepConfig(compute_metrics=True)
    state = ts.TrainState(model, ts.make_optimizer(model.parameters(), cfg),
                          ts.multistep_lr(cfg))
    losses, metrics = ts.build_train_step(spec, cfg)(
        state, ts.to_device(batch, "cpu", torch.float64))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _plain(o):
    """Detections and stats as plain Python numbers."""
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    return o


def _child(job_path: str) -> None:
    """One rank: join the group, run the job's steps and calls, save what
    they left behind to ``<out>.rank<r>.pt``."""
    with open(job_path) as f:
        job = json.load(f)
    if not mesh.maybe_initialize_distributed("cpu"):
        raise RuntimeError("no process group in the environment")
    rank, world = mesh.process_index(), mesh.process_count()
    trainer.make_datasets = chip_smoke.fixed_draws(trainer.make_datasets)
    out = {"rank": rank, "world": world, "backend": mesh.backend(),
           "chief": mesh.is_chief(), "steps": {}, "calls": []}
    try:
        if "steps" in job:
            spec = _spec(overrides=STEP_OVERRIDES)
            state_dict = torch.load(job["steps"]["weights"], weights_only=True)
            full = dict(np.load(job["steps"]["batch"]))
            refs = tuple(full.pop(f"refs{i}") for i in range(spec.num_scales))
            half = len(full["point_cloud"]) // world
            for name, (variant, order) in STEP_CASES.items():
                batch = {k: v[order] for k, v in full.items()}
                batch["refs"] = tuple(r[order] for r in refs)
                out["steps"][name] = _step(spec, state_dict,
                                           _shard(batch, rank * half, (rank + 1) * half),
                                           variant)
        for call in job.get("calls", []):
            argv = [a.replace("<rank>", str(rank)) for a in call["argv"]]
            main = {"train": trainer.main, "test": serve.main,
                    "test_sunrgbd": serve_sun.main}[call["main"]]
            if call.get("raises"):
                try:
                    main(argv)
                    out["calls"].append(None)
                except (ValueError, RuntimeError) as exc:
                    out["calls"].append(f"{type(exc).__name__}: {exc}")
                continue
            res = main(argv)
            if call["main"] == "train":
                out["calls"].append({
                    "epochs": [{k: e[k] for k in ("prec", "train", "val", "frustums")}
                               for e in res["epochs"]],
                    "backend": res["backend"], "world": res["world"],
                    "state": {k: v.clone() for k, v in res["state"].model.state_dict().items()}})
            else:
                out["calls"].append(_plain({k: res[k] for k in
                                            ("ap", "stats", "result_dir", "det_results")}))
    finally:
        mesh.shutdown()
    torch.save(out, f"{job['out']}.rank{rank}.pt")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(work, job: dict, world: int = 2, timeout: int = 300) -> list:
    """The job on ``world`` child ranks over gloo; their outputs, by rank. A
    rank that fails or hangs fails the test."""
    job = dict(job, out=str(work / "ranks"))
    path = str(work / "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   FRUSTUM_COORDINATOR=f"localhost:{port}",
                   FRUSTUM_NUM_PROCESSES=str(world), FRUSTUM_PROCESS_ID=str(rank))
        env.pop("FRUSTUM_DIST", None)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), path],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank hung for {timeout} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    return [torch.load(f"{job['out']}.rank{r}.pt", weights_only=False) for r in range(world)]


def _close(got, want, what: str, tol: float = TOL) -> None:
    """max |got - want| within ``tol`` of want's largest magnitude."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= tol * scale, (what, err, scale)


# --- the bootstrap, with no process group ---------------------------------

def test_bootstrap_without_environment_is_one_chief_rank(monkeypatch):
    for key in ("FRUSTUM_COORDINATOR", "FRUSTUM_NUM_PROCESSES", "FRUSTUM_PROCESS_ID",
                "FRUSTUM_DIST"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False
    assert not mesh.initialized() and mesh.backend() is None
    assert (mesh.process_index(), mesh.process_count(), mesh.is_chief()) == (0, 1, True)
    t = torch.arange(3.0, requires_grad=True)
    assert mesh.global_sum(t) is t
    det = {3: {"Car": [[1.0] * 12]}}
    assert mesh.allgather_detections(det) is det
    t.grad = torch.ones(3)
    calls = mesh.all_reduce.calls
    mesh.all_reduce_grads([t])
    assert torch.equal(t.grad, torch.ones(3)) and mesh.all_reduce.calls == calls
    assert mesh.rank_device("cuda") == torch.device("cuda")
    assert mesh.rank_device("cpu") == torch.device("cpu")
    with mesh.distributed("cpu") as device:
        assert device == torch.device("cpu") and not mesh.initialized()


def test_environment_contract_gives_the_init_arguments():
    coord = {"FRUSTUM_COORDINATOR": "10.0.0.1:2345", "FRUSTUM_NUM_PROCESSES": "4",
             "FRUSTUM_PROCESS_ID": "3"}
    assert mesh.init_args({}, "cuda") is None
    assert mesh.init_args({"FRUSTUM_DIST": "no"}, "cpu") is None
    assert mesh.init_args(coord, "cuda") == {
        "backend": "nccl", "init_method": "tcp://10.0.0.1:2345", "world_size": 4, "rank": 3}
    assert mesh.init_args(coord, "cpu")["backend"] == "gloo"
    assert mesh.init_args(coord, "cuda", backend="gloo")["backend"] == "gloo"
    assert mesh.init_args({"FRUSTUM_DIST": "auto"}, "cuda") == {
        "backend": "nccl", "init_method": "env://"}


def test_ranks_sharing_a_device_are_found():
    assert mesh.shared_devices([("a", 0), ("a", 1), ("b", 0), ("b", 1)]) == {}
    assert mesh.shared_devices([("a", 0), ("a", 0), ("a", 1), ("b", 1)]) == {
        ("a", 0): [0, 1]}


@pytest.mark.parametrize("shape,axes", [([-1], ["data"]), ([1], ["data"])])
def test_mesh_is_the_data_axis_over_every_rank(shape, axes):
    assert mesh.make_mesh(shape, axes) == 1


@pytest.mark.parametrize("shape,axes", [([2], ["data"]), ([-1, 1], ["data", "model"]),
                                        ([-1], ["model"])])
def test_other_meshes_are_refused(shape, axes):
    with pytest.raises(ValueError, match="TPU.MESH_SHAPE"):
        mesh.make_mesh(shape, axes)


# --- one train step on 2 ranks ---------------------------------------------

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The tiny flagship with a Flax init (perturbed running statistics)
    and the edge batch of ``test_torch_train_step.py``; every case's step on
    2 ranks and in one process."""
    import __graft_entry__ as graft
    from frustum_convnet_tpu_torch.models.weights import from_jax
    from test_torch_train_step import _edge_batch, _variables

    _cfg, jspec, _ = graft._flagship(tiny=True)
    spec = _spec(overrides=STEP_OVERRIDES)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    batch = _edge_batch(jspec, 4, 6)
    params, stats = _variables(jspec, batch)
    state_dict = from_jax(params, stats, spec.num_scales, dtype=torch.float64)
    work = tmp_path_factory.mktemp("torch_parallel_steps")
    torch.save(state_dict, str(work / "weights.pt"))
    arrays = {k: v for k, v in batch.items() if k in ts.BATCH_KEYS and k != "refs"}
    arrays.update({f"refs{i}": r for i, r in enumerate(batch["refs"])})
    np.savez(str(work / "batch.npz"), **arrays)
    ranks = _run_ranks(work, {"steps": {"weights": str(work / "weights.pt"),
                                        "batch": str(work / "batch.npz")}})
    single = {}
    for name, (variant, order) in STEP_CASES.items():
        b = {k: v[order] for k, v in arrays.items() if not k.startswith("refs")}
        b["refs"] = tuple(r[order] for r in batch["refs"])
        single[name] = _step(spec, state_dict, b, variant)
    return {"ranks": ranks, "single": single, "jspec": jspec, "batch": batch,
            "params": params, "stats": stats}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_rank_step_matches_one_process(steps, case):
    r0, r1 = (r["steps"][case] for r in steps["ranks"])
    want = steps["single"][case]
    assert [r["backend"] for r in steps["ranks"]] == ["gloo", "gloo"]
    # the ranks hold bitwise-equal parameters, statistics and gradients
    for key in ("state", "grads"):
        for name, v in r0[key].items():
            assert torch.equal(v, r1[key][name]), (key, name)
    assert r0["losses"] == r1["losses"] and r0["metrics"] == r1["metrics"]
    # and agree with one process on the whole batch
    for key in ("losses", "metrics"):
        assert set(r0[key]) == set(want[key])
        for name, v in want[key].items():
            _close(r0[key][name], v, name)
    for name, g in want["grads"].items():
        _close(r0["grads"][name], g, name)
    for name, v in want["state"].items():
        if name in want["grads"]:
            # Adam's first step moves p by lr * g / (|g| + eps), which turns
            # a gradient's rounding noise into up to lr / eps times as much
            dg = (r0["grads"][name] - want["grads"][name]).abs()
            bound = TOL * v.abs().max() + ADAM_GAIN * dg
            assert ((r0["state"][name] - v).abs() <= bound).all(), name
        elif v.is_floating_point():
            _close(r0["state"][name], v, name)
        else:
            assert torch.equal(r0["state"][name], v), name
    fg = [(steps["batch"]["cls_label"][STEP_CASES[case][1]][2 * r:2 * r + 2] == 1).any()
          for r in range(2)]
    assert fg == ([True, False] if case == "sync_fg_on_rank0" else [False, True])


def test_two_rank_step_matches_jax(steps):
    """The sync step of 2 ranks against JAX's single-device step (x64) on
    the same global batch and weights."""
    from test_torch_train_step import _jax_grads

    want_losses, want = _jax_grads(steps["jspec"], steps["params"], steps["stats"],
                                   steps["batch"], f64=True)
    got = steps["ranks"][0]["steps"]["sync"]
    for k, v in want_losses.items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-10, err_msg=k)
    for name, g in got["grads"].items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-30), err_msg=name)
    for name, v in got["state"].items():
        if ".running_" in name:
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=name)


# --- the CLIs on 2 ranks ---------------------------------------------------

def _seeded_weights(path: str, cfg_file: str, overrides) -> str:
    model = FrustumConvNet(_spec(cfg_file, overrides))
    model.reset_parameters(torch.Generator().manual_seed(7))
    checkpoints.save_checkpoint(path, model)
    return path


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The trainer, both KITTI stages' serving and SUN-RGBD serving, each
    on 2 ranks (one child run) and in this process."""
    from frustum_convnet_tpu_torch.data.kitti import prepare_refine
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
    from frustum_convnet_tpu_torch.data.sunrgbd import prepare as sun_prepare
    from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd
    from test_torch_standalone import fake_stage1_results

    work = tmp_path_factory.mktemp("torch_parallel_clis")
    spec = _spec(CFG, TINY)
    train_dir = str(work / "train")
    chip_smoke.make_train_split(train_dir, spec, num_train=8, num_val=10)
    split = chip_smoke.make_val_split(str(work / "serve"), spec, num_frames=5,
                                      cars_per_frame=3)
    kitti = str(work / "kitti_raw")
    make_synthetic_kitti(kitti, num_frames=6, cars_per_frame=2, seed=2)
    fake_stage1_results(os.path.join(kitti, "training", "label_2"), str(work / "stage1"))
    refine_dir = str(work / "refine")
    prepare_refine.main(["--car_only", "--gen_val_rgb_detection", "--data_root", kitti,
                         "--save_dir", refine_dir, "--val_res_dir", str(work / "stage1")])
    sun_raw = str(work / "sunrgbd")
    make_synthetic_sunrgbd(sun_raw, num_frames=4, objects_per_frame=2, seed=4)
    sun_dir = str(work / "sun_pickles")
    sun_prepare.main(["--gen_val_rgb_detection", "--sunrgbd_dir", sun_raw,
                      "--det_file", os.path.join(sun_raw, "det_val.txt"),
                      "--save_dir", sun_dir])

    def out(tag):
        return str(work / f"{tag}_<rank>")

    train = ["--cfg", CFG, "--device", "cpu"] + TINY + [
        "DATA.DATA_ROOT", train_dir, "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4",
        "TRAIN.MAX_EPOCH", "1", "disp", "3", "TPU.METRIC_INTERVAL", "-1",
        "USE_TFBOARD", "True"]
    stage1 = ["--cfg", CFG, "--device", "cpu", "--gt_dir", split["gt_dir"],
              "--idx_path", split["idx_path"]] + TINY + SERVE + [
        "DATA.DATA_ROOT", split["pickle_dir"],
        "TEST.WEIGHTS", _seeded_weights(str(work / "stage1.pth"), CFG, TINY)]
    refine = ["--cfg", REFINE_CFG, "--device", "cpu",
              "--gt_dir", os.path.join(kitti, "training", "label_2"),
              "--idx_path", os.path.join(kitti, "image_sets", "val.txt")] + TINY_REFINE + SERVE + [
        "DATA.DATA_ROOT", refine_dir,
        "TEST.WEIGHTS", _seeded_weights(str(work / "refine.pth"), REFINE_CFG, TINY_REFINE)]
    sun = ["--cfg", SUN_CFG, "--device", "cpu", "--sunrgbd_dir", sun_raw,
           "--val_idx", os.path.join(sun_raw, "image_sets", "val.txt")] + TINY_SUN + SERVE + [
        "DATA.DATA_ROOT", sun_dir, "OVER_WRITE_TEST_FILE", os.path.join(sun_dir, "sunrgbd_rgb_det_val.pickle"),
        "TEST.WEIGHTS", _seeded_weights(str(work / "sun.pth"), SUN_CFG, TINY_SUN)]
    calls = [{"main": "train", "argv": train + ["OUTPUT_DIR", out("train")]},
             {"main": "test", "argv": stage1 + ["OUTPUT_DIR", out("stage1")]},
             {"main": "test", "argv": refine + ["OUTPUT_DIR", out("refine")]},
             {"main": "test_sunrgbd", "argv": sun + ["OUTPUT_DIR", out("sun")]},
             {"main": "train", "raises": True,
              "argv": train + ["TRAIN.BATCH_SIZE", "5", "OUTPUT_DIR", out("odd")]},
             {"main": "train", "raises": True,
              "argv": train + ["TPU.BN_GROUP_SIZE", "4", "OUTPUT_DIR", out("ghost")]},
             {"main": "test", "raises": True,
              "argv": [("cuda" if a == "cpu" else a) for a in stage1]
              + ["OUTPUT_DIR", out("cuda")]}]
    ranks = _run_ranks(work, {"calls": calls})

    def single(call):
        return [a.replace("<rank>", "single") for a in call["argv"]]

    mp = pytest.MonkeyPatch()
    mp.setattr(trainer, "make_datasets", chip_smoke.fixed_draws(trainer.make_datasets))
    try:
        ref = [trainer.main(single(calls[0])), serve.main(single(calls[1])),
               serve.main(single(calls[2])), serve_sun.main(single(calls[3]))]
    finally:
        mp.undo()
    with open(os.path.join(kitti, "image_sets", "val.txt")) as f:
        n_refine = sum(1 for line in f if line.strip())
    return {"work": work, "ranks": ranks, "ref": ref,
            "sizes": {"stage1": 5, "refine": n_refine}}


def test_two_rank_trainer_matches_one_process(clis):
    work, (r0, r1), ref = clis["work"], clis["ranks"], clis["ref"][0]
    assert (r0["chief"], r1["chief"]) == (True, False)
    t0, t1 = r0["calls"][0], r1["calls"][0]
    assert (t0["backend"], t0["world"]) == ("gloo", 2)
    # only the chief wrote: its log, scalars, snapshot and checkpoints
    chief_dir = work / "train_0"
    assert sorted(os.listdir(chief_dir)) == ["checkpoints", "config_snapshot.yaml",
                                             "tb_logger", "train.log"]
    assert os.path.exists(checkpoints.checkpoint_paths(str(chief_dir))["final"])
    assert not os.path.exists(work / "train_1")
    # the ranks are bitwise equal and report the same global values
    for name, v in t0["state"].items():
        assert torch.equal(v, t1["state"][name]), name
    assert t0["epochs"] == t1["epochs"]
    assert [e["frustums"] for e in t0["epochs"]] == [8]
    with open(chief_dir / "train.log") as f:
        assert "rank 0 of 2" in f.read()
    # one process on the same global batches, after the same 2 Adam steps
    # as test_multihost.py's, within its bounds
    state = ref["state"].model.state_dict()
    dist = max((t0["state"][k].double() - v.double()).abs().max().item()
               for k, v in state.items() if v.is_floating_point())
    assert dist < 5e-3, dist
    # Adam's first steps move an entry by about lr in its gradient's sign, so
    # runs whose gradients agree lie more than lr / 2 apart only where a
    # gradient is rounding noise (1.4e-4 of the entries here); gradients
    # whose BatchNorm backward is not summed over the ranks put 43% there
    moved = torch.cat([(t0["state"][k].double() - v.double()).abs().reshape(-1)
                       for k, v in state.items()
                       if v.is_floating_point() and ".running_" not in k])
    assert (moved > 5e-4).double().mean().item() < 1e-2
    for got, want in zip(t0["epochs"], ref["epochs"]):
        loss = want["train"]["total_loss"]
        assert abs(got["train"]["total_loss"] - loss) < 2e-3 + 1e-4 * abs(loss)
        assert abs(got["prec"] - want["prec"]) < 2e-3
        assert abs(got["val"]["total_loss"] - want["val"]["total_loss"]) < (
            2e-3 + 1e-4 * abs(want["val"]["total_loss"]))


def _rows(result_dir: str, name: str) -> list:
    """A result file's rows in a canonical order (``test_multihost.py``)."""
    out = []
    with open(os.path.join(result_dir, name)) as f:
        for line in f.read().splitlines():
            parts = line.split()
            out.append((parts[0], np.asarray([float(x) for x in parts[1:]])))
    out.sort(key=lambda r: (r[0],) + tuple(np.round(r[1], 4)))
    return out


@pytest.mark.parametrize("stage,index", [("stage1", 1), ("refine", 2)])
def test_two_rank_serving_matches_one_process(clis, stage, index):
    (r0, r1), ref = clis["ranks"], clis["ref"][index]
    s0, s1 = r0["calls"][index], r1["calls"][index]
    assert s1["result_dir"] is None and s1["ap"] is None
    assert not os.path.exists(clis["work"] / f"{stage}_1")
    assert s0["det_results"] == s1["det_results"]  # merged on both ranks
    assert s0["stats"]["frustums"] + s1["stats"]["frustums"] == ref["stats"]["frustums"]
    assert min(s0["stats"]["frustums"], s1["stats"]["frustums"]) > 0
    files = sorted(os.listdir(s0["result_dir"]))
    assert files == sorted(os.listdir(ref["result_dir"])) and len(files) == clis["sizes"][stage]
    n = 0
    for name in files:
        got, want = _rows(s0["result_dir"], name), _rows(ref["result_dir"], name)
        assert len(got) == len(want), name
        for (gc, gv), (wc, wv) in zip(got, want):
            assert gc == wc, name
            np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-4, err_msg=name)
            n += 1
    assert n > 0
    assert s0["ap"] == _plain(ref["ap"])


def _det_rows(det: dict) -> list:
    return sorted((idx, cls, tuple(np.round(row, 4))) for idx, per_class in det.items()
                  for cls, rows in per_class.items() for row in rows)


def test_two_rank_sunrgbd_serving_matches_one_process(clis):
    (r0, r1), ref = clis["ranks"], clis["ref"][3]
    s0, s1 = r0["calls"][3], r1["calls"][3]
    assert s1["result_dir"] is None and s1["ap"] is None
    assert not os.path.exists(clis["work"] / "sun_1")
    assert s0["stats"]["frustums"] + s1["stats"]["frustums"] == ref["stats"]["frustums"]
    assert s0["det_results"] == s1["det_results"]
    got, want = _det_rows(s0["det_results"]), _det_rows(_plain(ref["det_results"]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2], w[2], rtol=1e-4, atol=1e-4)
    assert s0["ap"] == _plain(ref["ap"]) and s0["ap"]


def test_bad_layouts_raise_on_every_rank(clis):
    """A batch the world size does not divide, a ghost group that does not
    divide a rank's batch, and a CUDA device that is not there."""
    for r in clis["ranks"]:
        odd, ghost, cuda = r["calls"][4:7]
        assert odd.startswith("ValueError") and "divisible by the process count 2" in odd
        assert ghost.startswith("ValueError") and "TPU.BN_GROUP_SIZE 4" in ghost
        assert "TRAIN.BATCH_SIZE 4 over 2 rank(s) is 2 a rank" in ghost
        if not torch.cuda.is_available():
            assert cuda.startswith("RuntimeError") and "no CUDA device" in cuda


if __name__ == "__main__":
    _child(sys.argv[1])
