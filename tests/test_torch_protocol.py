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
  ``eval_pretrained_models.sh``).
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from chip_smoke import PROTOCOL_KEYS
from frustum_convnet_tpu_torch.tools import run_refine_protocol, run_synth_protocol
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
from frustum_convnet_tpu_torch.tools import run_refine_protocol, run_synth_protocol
out = [run_synth_protocol.main({stage1_args!r}), run_refine_protocol.main({refine_args!r})]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("frustum_convnet_tpu", "jax", "jaxlib", "flax", "optax"))
print("RESULT " + json.dumps({{"summaries": out, "leaked": leaked}}))
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
    for summary, keys, run, weights, stdout in zip(
            result["summaries"], (PROTOCOL_KEYS["stage1"], PROTOCOL_KEYS["refine"]),
            ("run_float32_1ep", "run_refine_float32_1ep"),
            ("model_best.pth", "model_final.pth"), printed):
        assert set(summary) == keys and summary == stdout
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


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_scripts_call_port_clis_with_flags_they_accept(tmp_path, monkeypatch, script):
    """The script runs under bash with ``python`` recording its arguments;
    each recorded call's module is imported and its ``main`` parses them."""
    from frustum_convnet_tpu_torch import configs

    args, n_calls, want_served = SCRIPTS[script]
    record = str(tmp_path / "calls")
    path = os.path.join(ROOT, "frustum_convnet_tpu_torch", "scripts", script)
    proc = subprocess.run(
        ["bash", "-c", 'python() { printf "%s\\0" "$@" >> "$REC"; printf "\\n" >> "$REC"; }; '
                       'source "$SCRIPT" "$@"', "bash", *args],
        env=dict(os.environ, REC=record, SCRIPT=path), capture_output=True, text=True,
        timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    with open(record) as f:
        calls = [c.split("\0") for c in f.read().split("\0\n")[:-1]]
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
