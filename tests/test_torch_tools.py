"""The port's tools against the repo's, on the CPU.

* ``tools/profile_train.py`` and ``tools/profile_mlp.py`` of the port run
  their rows at the tiny shapes with ``--device cpu`` and return finite
  times under the JAX tools' row names, one model forward a timed call;
  without ``--device cpu`` and without a card they refuse to run;
* ``viz_kitti`` and ``viz_sunrgbd`` of the port, in batch mode on the same
  synthetic scenes as ``tests/test_viz_tools.py``, write the file names that
  test expects of the originals, and the same bytes as the originals;
* ``jsonl_to_tb`` of the port decodes a scalar log written by the port's
  ``ScalarWriter`` into the same scalar records (tag, step, value, wall
  time) as the repo's tool, read back by TensorBoard's own loader.
"""

import glob
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd
from frustum_convnet_tpu_torch.tools import (jsonl_to_tb, profile_mlp, profile_train,
                                             viz_kitti, viz_sunrgbd)
from frustum_convnet_tpu_torch.utils.logger import ScalarWriter

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ROWS = ("eval forward + losses/metrics", "train-mode fwd + loss + metrics (no grad)",
              "full train step (metrics OFF)", "full train step (grads+adam+BN+metrics)")


def _repo_tool(name):
    """A module of the repo's ``tools/`` loaded by file path."""
    spec = importlib.util.spec_from_file_location(f"repo_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("flags", [[], ["--dtype", "bfloat16", "--metrics", "0", "--fast_bn",
                                        "--remat", "--bn_group", "2"]],
                         ids=["float32", "bfloat16_variants"])
def test_profile_train_rows_on_cpu(flags, capsys):
    res = profile_train.main(["--device", "cpu", "--tiny", "--batch", "4"] + flags)
    assert tuple(res["rows"]) == TRAIN_ROWS
    assert all(np.isfinite(v) and v > 0 for v in res["rows"].values())
    assert np.isfinite(res["frustums_per_s"]) and res["profile"] == {}
    assert res["device"] == "cpu" and res["forwards"] == len(TRAIN_ROWS) * (1 + 2)
    out = capsys.readouterr().out
    assert "device: cpu, batch 4" in out and "train throughput:" in out
    for row in TRAIN_ROWS:
        assert row in out


def test_profile_mlp_rows_on_cpu(capsys):
    res = profile_mlp.main(["--device", "cpu", "--tiny", "--batch", "2"])
    assert set(res) == {"float32", "bfloat16"}
    for rows in res.values():
        assert len(rows) == 4 * 4 + 1  # 3 layers and a pool a scale, and the total
        assert "scale1 layer1 (3->64) + bn/relu" in rows
        assert "scale4 layer3 (256->512) + bn/relu" in rows and "scale4 masked max-pool" in rows
        assert all(np.isfinite(v) and v > 0 for v in rows.values())
        assert rows["TOTAL"] == pytest.approx(sum(v for k, v in rows.items() if k != "TOTAL"))
    out = capsys.readouterr().out
    assert "=== dtype bfloat16, batch 2, cpu ===" in out and "TOTAL (sum of isolated" in out


@pytest.mark.parametrize("tool", ["profile_train", "profile_mlp"])
def test_profilers_time_a_card_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        {"profile_train": profile_train, "profile_mlp": profile_mlp}[tool].main(["--tiny"])


def test_viz_kitti_batch_mode_matches_the_repo_tool(tmp_path):
    root = str(tmp_path / "kitti")
    make_synthetic_kitti(root, num_frames=2, cars_per_frame=1, seed=0)
    outs = {}
    for tag, mod in (("port", viz_kitti), ("repo", _repo_tool("viz_kitti"))):
        outs[tag] = str(tmp_path / f"viz_{tag}")
        mod.main(["--data_root", root, "--idx", "0", "--save_dir", outs[tag]])
    port, repo = _files(outs["port"]), _files(outs["repo"])
    assert list(port) == ["000000_boxes.png", "000000_lidar3d.png", "000000_lidar_img.png"]
    assert all(len(b) > 1000 for b in port.values())
    assert port == repo


def test_viz_sunrgbd_batch_and_ply_match_the_repo_tool(tmp_path):
    root = str(tmp_path / "sun")
    make_synthetic_sunrgbd(root, num_frames=1)
    outs = {}
    for tag, mod in (("port", viz_sunrgbd), ("repo", _repo_tool("viz_sunrgbd"))):
        outs[tag] = str(tmp_path / f"viz_{tag}")
        mod.main(["--data_root", root, "--idx", "1", "--save_dir", outs[tag], "--ply"])
    port, repo = _files(outs["port"]), _files(outs["repo"])
    assert "000001_scene.png" in port and "000001_points.ply" in port
    assert any(f.startswith("000001_box") for f in port)
    assert port == repo


def _scalars(log_dir):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    files = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    out = []
    for ev in EventFileLoader(files[0]).Load():
        for v in ev.summary.value if ev.HasField("summary") else ():
            val = v.tensor.float_val[0] if v.HasField("tensor") else v.simple_value
            out.append((v.tag, ev.step, val, ev.wall_time))
    return out


def test_jsonl_to_tb_decodes_like_the_repo_tool(tmp_path, capsys):
    run = tmp_path / "run"
    writer = ScalarWriter(str(run), "train")
    rng = np.random.default_rng(5)
    for step in range(4):
        writer.scalars({"total_loss": float(rng.uniform(1, 9)), "IoU_0.7": float(rng.uniform())},
                       step=step)
    writer.close()
    for f in glob.glob(str(run / "tb_logger" / "*" / "events.out.tfevents.*")):
        os.remove(f)  # keep only the JSONL, as a run without the TB sink
    jsonl = sorted(glob.glob(str(run / "tb_logger" / "*.jsonl")))
    assert jsonl
    repo_run = tmp_path / "repo_run"
    shutil.copytree(run, repo_run)
    assert jsonl_to_tb.main([str(run)]) == 0
    assert _repo_tool("jsonl_to_tb").main([str(repo_run)]) == 0
    tags = [os.path.splitext(os.path.basename(j))[0] for j in jsonl]
    for tag in tags:
        got = _scalars(str(run / "tb_logger" / tag))
        assert len(got) == 8 and got == _scalars(str(repo_run / "tb_logger" / tag))
    assert jsonl_to_tb.main([str(tmp_path / "empty")]) == 1
