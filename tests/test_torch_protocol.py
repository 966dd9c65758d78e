"""The port's protocol runners against the JAX tools, on the CPU.

* ``frustum_convnet_tpu_torch.tools.run_synth_protocol.build_dataset`` writes
  the same synthetic KITTI and the same stage-1 pickles, byte for byte, as
  ``tools/run_synth_protocol.build_dataset`` (loaded by file path; it
  imports only jax-free modules of the JAX package), under the same cache
  key, for ``proto-v1`` and for ``--difficulty_mix``;
* ``run_refine_protocol.build_refine_pickles`` writes the same refine
  pickles as ``tools/run_refine_protocol.build_refine_pickles`` from one
  stage-1 result directory;
* both runners end to end on the CPU in a fresh interpreter (``--device
  cpu``, 6 frames, 1 epoch, the tiny overrides of ``test_torch_train``):
  each writes ``protocol_result.json`` with the JAX tool's keys and finite
  APs, stage 1 serves ``model_best.pth`` and refine ``model_final.pth``, and
  nothing of jax or the JAX package is imported;
* the port's twins of ``scripts/{car_all,people_all,car_train,
  car_train_refine,eval_pretrained_models,sunrgbd_train}.sh`` name only
  modules of the port, each CLI's argparse accepts the flags it is given
  (``--device cuda`` by default), every cfg override names a key of the cfg,
  and the weights they serve are ``.pth`` files (``model_best`` at stage 1,
  ``model_final`` at the refine stage, the checkpoints given to
  ``eval_pretrained_models.sh``);
* ``scripts/protocol_controls.sh`` takes each of the JAX package's supported
  training recipes (``bench.py``'s ``SUPPORTED_TRAIN_RECIPES``) and no other,
  and each of its legs (stage 1, a short leg, a resumed leg, the difficulty
  mix, another seed, the two stage-1 diagnostics, refine) calls its runner
  with exactly its recipe's dtype and overrides, under a run tag of its own;
* the runner's ``--matmul_precision`` reaches the training call alone, and
  its TF32 guard still refuses a training call that left TF32 on.
"""

import argparse
import ast
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import PROTOCOL_KEYS
from frustum_convnet_tpu_torch.tools import (protocol_summary, run_refine_protocol,
                                             run_synth_protocol)
from test_torch_standalone import fake_stage1_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_train.py TINY; IOU_THRESH 0.1 so that the one epoch of an
# untrained model scores a best (IoU_0.7 is 0) and model_best.pth is written
STAGE1_TINY = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
               "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)", "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)",
               "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8", "NUM_WORKERS", "1",
               "disp", "2", "IOU_THRESH", "0.1"]
# tests/test_torch_refine.py TINY
REFINE_TINY = ["DATA.NUM_SAMPLES", "128", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "5",
               "NUM_WORKERS", "1", "disp", "1"]


def _load_tool(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)  # run_refine_protocol imports it so
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(got, want):
    a, b = _tree(got), _tree(want)
    assert sorted(a) == sorted(b)
    differ = [k for k in a if a[k] != b[k]]
    assert not differ, differ


@pytest.mark.parametrize("mix", [False, True], ids=["proto-v1", "difficulty_mix"])
def test_build_dataset_writes_the_jax_tools_files(tmp_path, monkeypatch, mix):
    jax_tool = _load_tool("run_synth_protocol", monkeypatch)
    want = jax_tool.build_dataset(5, 2, str(tmp_path / "jax"), 1, difficulty_mix=mix)
    got = run_synth_protocol.build_dataset(5, 2, str(tmp_path / "port"), 1,
                                           difficulty_mix=mix)
    # the same cache key, so the same directory names under each cache
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == [
        os.path.relpath(p, tmp_path / "jax") for p in want]
    assert any(n.endswith("_train.pickle") for n in os.listdir(got[1]))
    _assert_same_tree(os.path.dirname(got[0]), os.path.dirname(want[0]))
    # a second call finds the cache and writes nothing
    stamp = os.path.getmtime(os.path.join(got[1], ".done"))
    assert run_synth_protocol.build_dataset(5, 2, str(tmp_path / "port"), 1,
                                            difficulty_mix=mix) == got
    assert os.path.getmtime(os.path.join(got[1], ".done")) == stamp


def test_build_refine_pickles_writes_the_jax_tools_files(tmp_path, monkeypatch):
    _load_tool("run_synth_protocol", monkeypatch)
    jax_tool = _load_tool("run_refine_protocol", monkeypatch)
    kitti_root, _ = run_synth_protocol.build_dataset(6, 2, str(tmp_path), 1)
    res = str(tmp_path / "stage1" / "data")
    fake_stage1_results(os.path.join(kitti_root, "training", "label_2"), res)
    jax_tool.build_refine_pickles(kitti_root, res, str(tmp_path / "jax"), 1)
    run_refine_protocol.build_refine_pickles(kitti_root, res, str(tmp_path / "port"), 1)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == [".done", "frustum_caronly_train.pickle", "frustum_caronly_val.pickle",
                     "frustum_caronly_val_rgb_detection.pickle"]
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_both_runners_end_to_end_on_cpu(tmp_path):
    def flags(tiny):
        return [w for k, v in zip(tiny[::2], tiny[1::2]) for w in ("--override", k, v)]

    cache = str(tmp_path / "cache")
    common = ["--device", "cpu", "--frames", "6", "--epochs", "1", "--cache", cache]
    stage1_args = common + flags(STAGE1_TINY)
    refine_args = common + ["--stage1", os.path.join(cache, "run_float32_1ep")] + flags(REFINE_TINY)
    code = f"""
import json, sys
import torch
torch.set_num_threads(1)
from frustum_convnet_tpu_torch.models import net
from frustum_convnet_tpu_torch.ops import select_cuda
from frustum_convnet_tpu_torch.tools import run_refine_protocol, run_synth_protocol
calls = []
auto = net.group_depth_point_multi_auto
def spy(*args):  # on a card, each call is one kernel-1 launch the wrapper counts
    calls[-1] += 1
    select_cuda.group_depth_point_multi_cuda.launches += 1
    return auto(*args)
net.group_depth_point_multi_auto = spy
out = []
for runner, args in ((run_synth_protocol, {stage1_args!r}), (run_refine_protocol, {refine_args!r})):
    calls.append(0)
    out.append(runner.main(args))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("frustum_convnet_tpu", "jax", "jaxlib", "flax", "optax"))
print("RESULT " + json.dumps({{"summaries": out, "leaked": leaked, "calls": calls}}))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    result = json.loads(lines[-1][len("RESULT "):])
    assert result["leaked"] == []
    printed = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines()
               if ln.startswith("PROTOCOL_RESULT ")]
    for summary, keys, run, weights, stdout, calls in zip(
            result["summaries"], (PROTOCOL_KEYS["stage1"], PROTOCOL_KEYS["refine"]),
            ("run_float32_1ep", "run_refine_float32_1ep"),
            ("model_best.pth", "model_final.pth"), printed, result["calls"]):
        assert set(summary) == keys and summary == stdout
        # the run's readings from its files: the launches the drivers log
        # are the calls the run made
        readings = protocol_summary.summarize(os.path.join(cache, run))
        assert readings["launches"] == calls > 0
        assert readings["ap"] == summary["ap"]["car"] and readings["epochs"] == 1
        assert readings["finite"] and readings["switch_epochs"] == []
        with open(os.path.join(cache, run, "protocol_result.json")) as f:
            assert json.load(f) == summary
        assert set(summary["ap"]) == set(summary["ap_bev"]) == {"car"}
        assert all(len(v) == 3 and np.isfinite(v).all()
                   for v in list(summary["ap"].values()) + list(summary["ap_bev"].values()))
        assert summary["epochs"] == 1 and summary["frames"] == 6 and summary["train_seconds"] > 0
        with open(os.path.join(cache, run, "val_nms", "result", "test.log")) as f:
            assert f"loaded weights {os.path.join(cache, run, 'checkpoints', weights)}" in f.read()
    assert result["summaries"][1]["weights"] == "model_final"


class _Parsed(Exception):
    pass


def supported_recipes():
    """The JAX package's ``bench.SUPPORTED_TRAIN_RECIPES`` (read from the
    file, not imported) under ``protocol_controls.sh``'s names: {name:
    (dtype, its overrides beyond the batch-32 float32 recipe as
    ``[key, float]`` pairs)}."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    rows = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets] == ["SUPPORTED_TRAIN_RECIPES"])
    short = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
    recipes = {}
    for batch, dtype, trunk, bn_group, ft, lr, _ in rows:
        assert trunk == "" and bn_group == 0  # none of the rows sets them
        pairs = [["TRAIN.BATCH_SIZE", batch]] if batch != 32 else []
        pairs += [["TRAIN.BASE_LR", lr]] if lr != 1e-3 else []
        pairs += [["TPU.F32_FINETUNE_EPOCHS", ft]] if ft else []
        recipes[f"{short[dtype]}_b{batch}" + (f"_ft{ft}" if ft else "")] = (dtype, pairs)
    return recipes


# script: (its arguments, the CLI calls it makes, the (cfg, weights) each
# serving call loads)
SCRIPTS = {
    "car_all.sh": ((), 6, [("cfgs/det_sample.yaml", "model_best.pth"),
                           ("cfgs/refine_car.yaml", "model_final.pth")]),
    "people_all.sh": ((), 6, [("cfgs/det_sample_people.yaml", "model_best.pth"),
                              ("cfgs/refine_people.yaml", "model_final.pth")]),
    "car_train.sh": (("TRAIN.MAX_EPOCH", "2"), 1, []),
    "car_train_refine.sh": ((), 1, []),
    "eval_pretrained_models.sh": (("stage1.pth", "refine.pth"), 3,
                                  [("cfgs/det_sample.yaml", "stage1.pth"),
                                   ("cfgs/refine_car.yaml", "refine.pth")]),
    "sunrgbd_train.sh": ((), 3, [("cfgs/det_sample_sunrgbd.yaml", "model_best.pth")] * 2),
}
# protocol_controls.sh legs: id -> (RECIPE, stage, FROM's name or None,
# environment beyond RECIPE); each makes one runner call
PROTOCOL_LEGS = {
    "f32_b32": ("f32_b32", "stage1", None, {}),
    "bf16_b32": ("bf16_b32", "stage1", None, {}),
    "f32_b128": ("f32_b128", "stage1", None, {}),
    "f16_b128_ft40": ("f16_b128_ft40", "stage1", None, {}),
    "f16_b128_ft40-leg25": ("f16_b128_ft40", "stage1", None, {"EPOCHS": "25"}),
    "f16_b128_ft40-resume": ("f16_b128_ft40", "stage1", "stage1_f16_b128_ft40_s4", {}),
    "f32_b32-mix": ("f32_b32", "stage1", None, {"MIX": "1"}),
    "f32_b32-mix-s3": ("f32_b32", "stage1", None, {"MIX": "1", "SEED": "3"}),
    "f32_b32-mix-s3-medium": ("f32_b32", "stage1", None,
                              {"MIX": "1", "SEED": "3", "PRECISION": "medium"}),
    "f32_b32-mix-s3-init": ("f32_b32", "stage1", None,
                            {"MIX": "1", "SEED": "3", "INIT": "_resume/jax_init_s3.pth"}),
    "bf16_b32-refine": ("bf16_b32", "refine", "stage1_bf16_b32_s4", {}),
}
CASES = sorted(SCRIPTS) + [f"protocol_controls.sh-{leg}" for leg in sorted(PROTOCOL_LEGS)]


def _run_script(tmp_path, script, args, env=()):
    """Source ``script`` under bash with ``python``/``python3`` recording
    their arguments (and ``cp``, ``nvidia-smi`` doing nothing); the calls."""
    record = str(tmp_path / "calls")
    path = os.path.join(ROOT, "frustum_convnet_tpu_torch", "scripts", script)
    proc = subprocess.run(
        ["bash", "-c", 'python() { printf "%s\\0" "$@" >> "$REC"; printf "\\n" >> "$REC"; }; '
                       'python3() { python "$@"; }; cp() { :; }; nvidia-smi() { :; }; '
                       'source "$SCRIPT" "$@"', "bash", *args],
        env=dict(os.environ, REC=record, SCRIPT=path, **dict(env)), capture_output=True,
        text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    with open(record) as f:
        return [c.split("\0") for c in f.read().split("\0\n")[:-1]]


@pytest.mark.parametrize("case", CASES)
def test_port_scripts_call_port_clis_with_flags_they_accept(tmp_path, monkeypatch, case):
    """The script runs under bash with ``python`` recording its arguments;
    each recorded call's module is imported and its ``main`` parses them.
    Each ``protocol_controls.sh`` leg calls its runner with exactly its
    recipe's row of the JAX package's supported recipes: the dtype and
    the overrides (after TRAIN.SEED at stage 1: ``SEED``, 4 by default), in
    a run of the recipe's own tag, which ends in ``_s<SEED>`` (and the
    diagnostics' ``_<PRECISION>`` and ``_init``: ``--matmul_precision`` and
    ``TRAIN.WEIGHTS`` last)."""
    from frustum_convnet_tpu_torch import configs

    if case in SCRIPTS:
        args, n_calls, want_served = SCRIPTS[case]
        calls = _run_script(tmp_path, case, args)
    else:
        recipe, stage, from_name, env = PROTOCOL_LEGS[case.split("-", 1)[1]]
        n_calls, want_served = 1, []
        args = [str(tmp_path / "out"), str(tmp_path / "cache"), stage]
        args += [str(tmp_path / "resume" / from_name)] if from_name else []
        calls = _run_script(tmp_path, "protocol_controls.sh", args,
                            dict(env, RECIPE=recipe))
        calls = [c for c in calls if c[0] == "-m"]  # not a short leg's checkpoint copy
    assert len(calls) == n_calls, calls
    parse = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_then_stop)
    served = []
    for call in calls:
        assert call[0] == "-m" and call[1].startswith("frustum_convnet_tpu_torch."), call
        module = importlib.import_module(call[1])
        with pytest.raises(_Parsed) as parsed:
            module.main(call[2:])
        ns = parsed.value.args[0]
        if hasattr(ns, "opts"):
            assert ns.device == "cuda" and os.path.exists(os.path.join(ROOT, ns.cfg_file))
            cfg = configs.get_default_cfg()
            configs.merge_cfg_from_file(os.path.join(ROOT, ns.cfg_file), cfg)
            configs.merge_cfg_from_list(ns.opts, cfg)
            if cfg.TEST.WEIGHTS:
                served.append((ns.cfg_file, os.path.basename(cfg.TEST.WEIGHTS)))
    assert served == want_served
    if case in SCRIPTS:
        return

    dtype, pairs = supported_recipes()[recipe]
    epochs = int(env.get("EPOCHS", 50))
    # the fine-tune epochs count back from the leg's last epoch: a short leg
    # keeps the switch at the recipe's epoch
    pairs = [[k, max(v - (50 - epochs), 0) if k == "TPU.F32_FINETUNE_EPOCHS" else v]
             for k, v in pairs]
    # stage 1 trains at SEED (the control seed 4 by default), refine at its
    # cfg's seed
    seed = int(env.get("SEED", 4))
    seed_pairs = [["TRAIN.SEED", seed]] if stage == "stage1" else []
    resume = [["RESUME", True]] if stage == "stage1" and from_name else []
    init = [["TRAIN.WEIGHTS", env["INIT"]]] if "INIT" in env else []
    assert ns.dtype == dtype and ns.epochs == epochs
    assert ([[k, yaml.safe_load(v)] for k, v in ns.override]
            == seed_pairs + pairs + resume + init)
    tag = f"{recipe}{'_mix' if env.get('MIX') else ''}_s{seed}"
    tag += f"_{env['PRECISION']}" if "PRECISION" in env else ""
    tag += "_init" if init else ""
    if stage == "stage1":
        assert call[1] == "frustum_convnet_tpu_torch.tools.run_synth_protocol"
        assert ns.tag == tag and ns.difficulty_mix == bool(env.get("MIX"))
        assert ns.matmul_precision == env.get("PRECISION", "highest")
    else:  # the stage-1 run of FROM's tag seeds the refine run
        assert call[1] == "frustum_convnet_tpu_torch.tools.run_refine_protocol"
        s1_tag = from_name[len("stage1_"):]
        assert ns.stage1 == os.path.join(str(tmp_path / "cache"), f"run_{s1_tag}")
        assert ns.tag == f"refine_{recipe}_from_{s1_tag}"


def test_protocol_controls_recipes_are_the_supported_ones():
    """``protocol_controls.sh`` takes every supported recipe and no other
    (its case arms), and the legs above cover each."""
    with open(os.path.join(ROOT, "frustum_convnet_tpu_torch", "scripts",
                           "protocol_controls.sh")) as f:
        arms = re.findall(r"^([a-z0-9]+_b\d+\w*)\)", f.read(), flags=re.M)
    assert sorted(arms) == sorted(supported_recipes())
    assert {leg[0] for leg in PROTOCOL_LEGS.values()} == set(arms)


def _log_line(msg):
    return f"2026-01-01 00:00:00,000 INFO {msg}"


def test_protocol_summary_reads_a_run_cut_into_legs(tmp_path):
    """A float16 run of 4 epochs (float32 from epoch 2) in two legs, the
    first stopped at epoch 2, its files as ``protocol_controls.sh`` keeps
    them: each epoch's dtype, the medians without each leg's first epoch,
    the switch, the best, the finiteness of the logged values and the
    kernel-1 launches the drivers logged (each leg's training and the
    serving), or None where the logs carry none."""
    cfg = os.path.join(ROOT, "cfgs", "det_sample.yaml")

    def leg(max_epoch, ft, extra=()):
        opts = ["TPU.COMPUTE_DTYPE", "float16", "TRAIN.MAX_EPOCH", str(max_epoch),
                "TPU.F32_FINETUNE_EPOCHS", str(ft), *extra]
        return [_log_line(f"config: {cfg} overrides: {opts!r} on cuda"),
                _log_line("train 96 frustums / 3 batches; val 20 frustums")]

    def epoch(e, ms, iou, loss="1.5000"):
        return [_log_line(f"epoch {e} it 2/3 total_loss {loss} IoU_0.7 0.5000"),
                _log_line(f"[val] epoch {e} total_loss:2.0000 IoU_0.7:{iou}"),
                _log_line(f"epoch {e} done in 3.5s ({ms} ms/step, 10.0 frustums/s training) "
                          f"IoU_0.7={iou:.4f} best={iou:.4f}@{e + 1}")]

    def done(best, best_epoch, launches):
        return [_log_line(f"training done; best IoU_0.7={best:.4f} at epoch {best_epoch}"),
                _log_line(f"{launches} grouping kernel launches in training")]

    lines = (leg(2, 0) + epoch(0, 90.0, 0.5) + epoch(1, 80.0, 0.6) + done(0.6, 2, 12)
             + leg(4, 2, ["RESUME", "True"])
             + [_log_line("resumed from model_final.pth at epoch 2"),
                _log_line("epoch 2: switching to float32 fine-tune steps "
                          "(TPU.F32_FINETUNE_EPOCHS=2)")]
             + epoch(2, 70.0, 0.7) + epoch(3, 60.0, 0.8) + done(0.8, 4, 11))
    run = tmp_path / "stage1_f16_b128_ft40_s4"
    run.mkdir()
    (run / "train.log").write_text("\n".join(lines) + "\n")
    served = [_log_line("streamed 700 frustums in 1.00s = 700 frustums/s end-to-end (900 "
                        "foreground sections, 650 detections, 1 overflow re-runs)"),
              _log_line("13 grouping kernel launches in serving")]
    (run / "test.log").write_text("\n".join(served) + "\n")
    (run / "protocol_result.json").write_text(json.dumps(
        {"dtype": "float16", "train_seconds": 12.5, "ap": {"car": [90.1, 90.2, 90.3]},
         "ap_bev": {"car": [90.4, 90.5, 90.6]}}))

    got = protocol_summary.summarize(str(run), jax=[90.15, 90.31, 90.31],
                                     port_f32=[90.72, 90.77, 90.77])
    assert got["ms_per_step"] == {"float16": 80.0, "float32": 60.0}
    assert got["switch_epochs"] == [2] and got["epochs"] == 4
    assert (got["best_iou"], got["best_epoch"]) == (0.8, 4)
    assert got["val_iou"] == [0.5, 0.6, 0.7, 0.8] and got["finite"]
    assert got["epoch_seconds"] == 14.0 and got["train_seconds"] == 12.5
    assert got["delta_jax"] == [-0.05, -0.11, -0.01]
    assert got["delta_port_f32"] == [-0.62, -0.57, -0.47]
    assert got["launches"] == 12 + 11 + 13

    (run / "test.log").write_text(served[0] + "\n")  # a run from before the count
    assert protocol_summary.summarize(str(run))["launches"] is None
    lines[2] = lines[2].replace("total_loss 1.5000", "total_loss nan")
    (run / "train.log").write_text("\n".join(lines) + "\n")
    assert not protocol_summary.summarize(str(run))["finite"]


def test_protocol_summary_breaks_the_ap_down_by_difficulty(tmp_path):
    """``by_difficulty`` on the difficulty mix's val labels served back as
    detections, less one car that counts at the hard difficulty: for BEV
    and 3D and each difficulty it counts the evaluator's ground truths,
    matches all of them but that car where it counts, and its 11 samples
    average to the evaluator's AP (to their 4 printed digits)."""
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
    from frustum_convnet_tpu_torch.evaluation import kitti_eval

    kitti = str(tmp_path / "kitti")
    make_synthetic_kitti(kitti, num_frames=12, cars_per_frame=2, seed=1, difficulty_mix=True)
    labels = os.path.join(kitti, "training", "label_2")
    with open(os.path.join(kitti, "image_sets", "val.txt")) as f:
        ids = [int(line) for line in f if line.strip()]
    data = tmp_path / "run" / "data"
    data.mkdir(parents=True)
    gts, dropped = {}, None
    for i in ids:
        path = os.path.join(labels, f"{i:06d}.txt")
        with open(path) as f:
            lines = [line.strip() for line in f if line.strip()]
        gts[i] = kitti_eval.parse_label_file(path, is_det=False)
        cars = [(line, box) for line, box in zip(lines, gts[i]) if box.type == "car"]
        if dropped is None:
            hard = [k for k, (_, box) in enumerate(cars)
                    if kitti_eval.clean_data([box], [], "car", 2)[3]]
            if hard:
                dropped = [cars.pop(hard[0])[1]]
        (data / f"{i:06d}.txt").write_text("".join(f"{line} 0.9\n" for line, _ in cars))
    assert dropped is not None

    got = protocol_summary.by_difficulty(str(data), labels)
    want = kitti_eval.evaluate(labels, str(tmp_path / "run"), classes=("car",),
                               compute_aos=False)["car"]
    for key, name in (("bev", "detection_ground"), ("3d", "detection_3d")):
        for d, row in enumerate(got[key]):
            n_gt = sum(kitti_eval.clean_data(g, [], "car", d)[3] for g in gts.values())
            assert row["gt"] == n_gt > 0
            assert row["matched"] == n_gt - kitti_eval.clean_data(dropped, [], "car", d)[3]
            assert np.mean(row["samples"]) * 100 == pytest.approx(want[name][d], abs=1e-2)
    assert [row["gt"] for row in got["3d"]] == [row["gt"] for row in got["bev"]]


@pytest.mark.parametrize("precision", ["highest", "medium"])
def test_runner_tf32_guard_and_the_matmul_precision_diagnostic(monkeypatch, precision):
    """``train_then_test`` hands ``--matmul_precision`` to the training call
    alone, and serving runs strict float32. The TF32 guard still refuses a
    training call that left TF32 on, and names the diagnostic when it is
    on."""
    from frustum_convnet_tpu_torch.engine import test as test_cli
    from frustum_convnet_tpu_torch.engine import train as train_cli
    from frustum_convnet_tpu_torch.engine.test import strict_fp32

    seen = {}
    leak = []

    def fake_train(argv, matmul_precision="highest"):
        seen["train"] = matmul_precision
        for mod in leak:
            mod.allow_tf32 = True
        return {"epochs": [{"ms_per_step": 1.0}], "output_dir": "out"}

    def fake_test(argv):
        seen["serve"] = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
        return {"ap": {}}

    monkeypatch.setattr(test_cli, "main", fake_test)
    monkeypatch.setattr(train_cli, "main", fake_train)
    flag = "" if precision == "highest" else rf" \(--matmul_precision {precision}\)"
    try:
        strict_fp32()
        run_synth_protocol.train_then_test("cfg.yaml", [], "cpu", "best", "kitti", "",
                                           matmul_precision=precision)
        assert seen == {"train": precision, "serve": (False, False)}
        for mod in (torch.backends.cuda.matmul, torch.backends.cudnn):
            leak[:] = [mod]
            with pytest.raises(RuntimeError, match=f"TF32 was turned on during training{flag}$"):
                run_synth_protocol.train_then_test("cfg.yaml", [], "cpu", "best", "kitti",
                                                   "", matmul_precision=precision)
            strict_fp32()
    finally:
        strict_fp32()
