"""The port's training driver on the CPU (``--device cpu``), end to end.

A tiny labeled synthetic split, written by ``chip_smoke.make_train_split``
(the generator the card's smoke run trains on), goes through
``frustum_convnet_tpu_torch.engine.train.main``:

* checkpoints at the reference cadence (``model_0005.pth``, ``model_final``,
  ``model_best`` on a new best IoU), in the reference state-dict layout that
  ``tools/import_reference_checkpoint.py`` reads;
* RESUME continues at the checkpointed epoch; resuming a finished run takes
  the fine-tune quirk (epoch 0, schedule count 0, Adam state kept);
* EVAL_MODE runs one validation pass and writes no checkpoint;
* a non-finite loss aborts the run;
* every precision and BatchNorm variant of ``cfg.TPU`` trains a tiny epoch
  with finite losses, and ``TPU.F32_FINETUNE_EPOCHS`` switches a float16
  run to float32 for its last epochs with the schedule carried on; such a
  run cut into two legs across the switch ends equal to the uncut run;
* a checkpoint the trainer wrote serves through ``engine.test.main``, also
  at half-precision ``TPU.INFER_DTYPE`` and ``TPU.TRUNK_DTYPE``.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.engine import checkpoints
from frustum_convnet_tpu_torch.engine import test as serve
from frustum_convnet_tpu_torch.engine import train as trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "det_sample.yaml")
TINY = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
        "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)",
        "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)",
        "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8", "NUM_WORKERS", "1",
        "disp", "2", "TPU.METRIC_INTERVAL", "-1", "USE_TFBOARD", "True"]


def _spec():
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(CFG, cfg)
    configs.merge_cfg_from_list(TINY, cfg)
    return configs.get_model_spec(cfg)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The split, and one 5-epoch training run on it."""
    work = tmp_path_factory.mktemp("torch_train")
    pickle_dir = str(work / "pickles")
    chip_smoke.make_train_split(pickle_dir, _spec(), num_train=24, num_val=12)
    out = str(work / "out")
    base = ["--cfg", CFG, "--device", "cpu"] + TINY + [
        "DATA.DATA_ROOT", pickle_dir, "OUTPUT_DIR", out]
    res = trainer.main(base + ["TRAIN.MAX_EPOCH", "5"])
    return {"work": work, "base": base, "out": out, "res": res}


def _val_epochs(out):
    with open(os.path.join(out, "tb_logger", "train.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r["key"] == "val/total_loss"]


def test_trains_and_writes_checkpoints_at_the_reference_cadence(run):
    res, out = run["res"], run["out"]
    assert [e["epoch"] for e in res["epochs"]] == [0, 1, 2, 3, 4]
    assert all(e["steps"] == 3 and e["frustums"] == 24 for e in res["epochs"])
    paths = checkpoints.checkpoint_paths(out)
    assert os.path.exists(paths["periodic"](5)) and os.path.exists(paths["final"])
    assert not os.path.exists(paths["periodic"](4))
    assert os.path.exists(paths["best"]) == (res["best_epoch"] > 0)
    payload = torch.load(paths["final"], map_location="cpu", weights_only=True)
    assert set(payload) == {"state_dict", "optimizer", "epoch", "best_prec",
                            "best_epoch", "step"}
    assert payload["epoch"] == 5 and payload["step"] == 15
    assert payload["optimizer"]["param_groups"][0]["schedule_count"] == 15
    assert os.path.exists(os.path.join(out, "config_snapshot.yaml"))
    assert _val_epochs(out) == [0, 1, 2, 3, 4]
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert "epoch 4 done" in log and "nan" not in log.lower()

    # the trained weights reload strictly, and the JAX package's importer
    # reads the file as a reference checkpoint
    from tools.import_reference_checkpoint import load_torch_state_dict, map_state_dict

    model = res["state"].model
    fresh = trainer.FrustumConvNet(model.spec)
    checkpoints.load_checkpoint(paths["final"], fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    params, stats = map_state_dict(load_torch_state_dict(paths["final"]),
                                   model.spec.num_scales)
    np.testing.assert_array_equal(
        np.asarray(params["cls_out"]["bias"]), model.cls_out.bias.detach().numpy())


def test_resume_then_finetune_quirk_and_eval_mode(run):
    base, out = run["base"], run["out"]
    resumed = trainer.main(base + ["TRAIN.MAX_EPOCH", "6", "RESUME", "True"])
    assert resumed["start_epoch"] == 5
    assert [e["epoch"] for e in resumed["epochs"]] == [5]
    assert _val_epochs(out)[-1] == 5
    opt = resumed["state"].optimizer
    assert opt.param_groups[0]["schedule_count"] == 18 and resumed["state"].step == 18

    # a finished run (epoch 6 == MAX_EPOCH) resumes as a fine-tune: epoch 0,
    # LR schedule restarted, Adam's moments and step counts kept; EVAL_MODE
    # stops after one validation pass
    evald = trainer.main(base + ["TRAIN.MAX_EPOCH", "6", "RESUME", "True",
                                 "EVAL_MODE", "True", "OUTPUT_DIR",
                                 str(run["work"] / "evalmode"),
                                 "TRAIN.WEIGHTS",
                                 checkpoints.checkpoint_paths(out)["final"]])
    assert evald["start_epoch"] == 0 and evald["epochs"] == []
    assert np.isfinite(evald["prec"])
    opt = evald["state"].optimizer
    assert opt.param_groups[0]["schedule_count"] == 0 and evald["state"].step == 0
    assert all(int(s["step"]) == 18 for s in opt.state.values())
    assert not os.path.exists(str(run["work"] / "evalmode" / "checkpoints"))


def test_non_finite_loss_aborts(run):
    with pytest.raises(RuntimeError, match="non-finite total_loss"):
        trainer.main(run["base"] + ["TRAIN.MAX_EPOCH", "1",
                                    "LOSS.CORNER_LOSS_WEIGHT", "1e999",
                                    "OUTPUT_DIR", str(run["work"] / "inf")])


VARIANTS = [["TPU.BN_GROUP_SIZE", "4"], ["TPU.FAST_BN", "True"],
            ["TPU.FAST_BN_FIRST", "True"], ["TPU.REMAT_POINTNET", "True"],
            ["TPU.COMPUTE_DTYPE", "bfloat16"], ["TPU.COMPUTE_DTYPE", "float16"],
            ["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.TRUNK_DTYPE", "float32"],
            ["TPU.F32_FINETUNE_EPOCHS", "1"]]


def test_every_variant_trains_an_epoch(run):
    """The variants the JAX package takes train here too: a tiny epoch of
    each, with finite losses, in its compute dtype, parameters float32 (a
    float32 run ignores F32_FINETUNE_EPOCHS); the trainer still refuses a
    card it cannot see."""
    for i, opts in enumerate(VARIANTS):
        out = str(run["work"] / f"variant{i}")
        res = trainer.main(run["base"] + opts + ["TRAIN.MAX_EPOCH", "1", "OUTPUT_DIR", out])
        compute = opts[opts.index("TPU.COMPUTE_DTYPE") + 1] if "TPU.COMPUTE_DTYPE" in opts \
            else "float32"
        assert [(e["epoch"], e["steps"], e["dtype"]) for e in res["epochs"]] == [
            (0, 3, compute)], opts
        with open(os.path.join(out, "train.log")) as f:
            log = f.read()
        assert "epoch 0 done" in log and "nan" not in log.lower(), opts
        assert "switching to float32" not in log
        model = res["state"].model
        assert all(t.dtype == torch.float32 for t in model.state_dict().values()
                   if t.is_floating_point())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.main(["--cfg", CFG, "--device", "cuda"])


def test_f32_finetune_epochs_switch_a_float16_run(run, monkeypatch):
    """float16 with F32_FINETUNE_EPOCHS 1 over 2 epochs: the switch is
    logged at epoch 1, epoch 0's train steps compute in float16 and epoch
    1's in float32 (the PointNet layers' outputs), and the schedule count
    runs on across the switch (6 steps)."""
    seen = []
    forward = trainer.FrustumConvNet.forward

    def spy(self, *args):
        if self.training:  # the first PointNet layer's output, no statistics updated
            with torch.no_grad():
                probe = self.feat_net.pointnet1.conv1(torch.zeros(2, 3), False)
            seen.append(probe.dtype)
        return forward(self, *args)

    monkeypatch.setattr(trainer.FrustumConvNet, "forward", spy)
    out = str(run["work"] / "finetune")
    res = trainer.main(run["base"] + ["TRAIN.MAX_EPOCH", "2", "OUTPUT_DIR", out,
                                      "TPU.COMPUTE_DTYPE", "float16",
                                      "TPU.F32_FINETUNE_EPOCHS", "1"])
    assert [(e["epoch"], e["dtype"]) for e in res["epochs"]] == [
        (0, "float16"), (1, "float32")]
    assert seen == [torch.float16] * 3 + [torch.float32] * 3
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert ("epoch 1: switching to float32 fine-tune steps "
            "(TPU.F32_FINETUNE_EPOCHS=1)") in log
    state = res["state"]
    assert state.step == 6 and state.optimizer.param_groups[0]["schedule_count"] == 6
    assert all(int(s["step"]) == 6 for s in state.optimizer.state.values())


def test_float16_run_cut_into_legs_across_the_f32_switch_equals_the_uncut_run(run):
    """float16 with F32_FINETUNE_EPOCHS 1 over 3 epochs (float32 from epoch
    2), once uncut and once in two legs: epoch 0, then RESUME from epoch 1 to
    the end. The switch counts back from TRAIN.MAX_EPOCH, so a leg stopping
    at epoch E of T takes max(N - (T - E), 0) fine-tune epochs, as
    ``scripts/protocol_controls.sh`` gives a short leg; the recipe's own N
    would put that leg's epoch 0 in float32. Parameters, BatchNorm
    statistics and optimizer state end equal to the uncut run's (tolerance
    0: the same float ops on the CPU in the same order)."""
    f16 = ["TPU.COMPUTE_DTYPE", "float16"]
    uncut_out, legs_out = str(run["work"] / "ft_uncut"), str(run["work"] / "ft_legs")
    uncut = trainer.main(run["base"] + f16 + ["OUTPUT_DIR", uncut_out, "TRAIN.MAX_EPOCH", "3",
                                              "TPU.F32_FINETUNE_EPOCHS", "1"])
    assert [e["dtype"] for e in uncut["epochs"]] == ["float16", "float16", "float32"]

    naive = trainer.main(run["base"] + f16 + ["OUTPUT_DIR", str(run["work"] / "ft_naive"),
                                              "TRAIN.MAX_EPOCH", "1",
                                              "TPU.F32_FINETUNE_EPOCHS", "1"])
    assert [e["dtype"] for e in naive["epochs"]] == ["float32"]

    leg1 = trainer.main(run["base"] + f16 + ["OUTPUT_DIR", legs_out, "TRAIN.MAX_EPOCH", "1",
                                             "TPU.F32_FINETUNE_EPOCHS", "0"])
    assert [e["dtype"] for e in leg1["epochs"]] == ["float16"]
    leg2 = trainer.main(run["base"] + f16 + ["OUTPUT_DIR", legs_out, "TRAIN.MAX_EPOCH", "3",
                                             "TPU.F32_FINETUNE_EPOCHS", "1", "RESUME", "True"])
    assert leg2["start_epoch"] == 1
    assert [(e["epoch"], e["dtype"]) for e in leg2["epochs"]] == [(1, "float16"), (2, "float32")]
    with open(os.path.join(legs_out, "train.log")) as f:
        leg2_log = f.read().split("resumed from ")[1]
    assert ("epoch 2: switching to float32 fine-tune steps "
            "(TPU.F32_FINETUNE_EPOCHS=1)") in leg2_log

    a, b = uncut["state"], leg2["state"]
    assert a.step == b.step == 9
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(sb["state"][i][k], v), (i, k)
    pa, pb = (torch.load(checkpoints.checkpoint_paths(out)["final"], map_location="cpu",
                         weights_only=True) for out in (uncut_out, legs_out))
    assert {k: pa[k] for k in ("epoch", "best_prec", "best_epoch", "step")} == {
        k: pb[k] for k in ("epoch", "best_prec", "best_epoch", "step")}
    assert (os.path.exists(checkpoints.checkpoint_paths(uncut_out)["best"])
            == os.path.exists(checkpoints.checkpoint_paths(legs_out)["best"]))


def test_trained_checkpoint_serves_through_the_test_driver(run):
    work = run["work"]
    split = chip_smoke.make_val_split(str(work / "serve"), _spec(), num_frames=3,
                                      cars_per_frame=2)
    res = serve.main(["--cfg", CFG, "--device", "cpu", "--gt_dir", split["gt_dir"],
                      "--idx_path", split["idx_path"]] + TINY + [
        "DATA.DATA_ROOT", split["pickle_dir"], "OUTPUT_DIR", str(work / "serve_out"),
        "TPU.INFER_GROUP", "1",
        "TEST.WEIGHTS", checkpoints.checkpoint_paths(run["out"])["final"]])
    assert res["stats"]["frustums"] == 6
    assert sorted(os.listdir(res["result_dir"])) == ["000000.txt", "000001.txt",
                                                     "000002.txt"]
    assert res["ap"] is not None and "car" in res["ap"]


@pytest.mark.parametrize("opts", [["TPU.INFER_DTYPE", "bfloat16"],
                                  ["TPU.INFER_DTYPE", "float16", "TPU.TRUNK_DTYPE", "float32"]],
                         ids=["bf16", "f16_trunk_f32"])
def test_trained_checkpoint_serves_at_half_precision(run, opts):
    """The float32 checkpoint serves at the half-precision inference dtypes:
    every frame's result file, finite values, and the AP."""
    work = run["work"]
    split = chip_smoke.make_val_split(str(work / f"serve_{opts[1]}"), _spec(),
                                      num_frames=3, cars_per_frame=2)
    res = serve.main(["--cfg", CFG, "--device", "cpu", "--gt_dir", split["gt_dir"],
                      "--idx_path", split["idx_path"]] + TINY + [
        "DATA.DATA_ROOT", split["pickle_dir"], "OUTPUT_DIR", str(work / f"out_{opts[1]}"),
        "TPU.INFER_GROUP", "1",
        "TEST.WEIGHTS", checkpoints.checkpoint_paths(run["out"])["final"]] + opts)
    assert res["stats"]["frustums"] == 6 and res["stats"]["detections"] > 0
    files = sorted(os.listdir(res["result_dir"]))
    assert files == ["000000.txt", "000001.txt", "000002.txt"]
    for name in files:
        with open(os.path.join(res["result_dir"], name)) as f:
            values = [float(v) for line in f for v in line.split()[3:]]
        assert np.isfinite(values).all()
    assert res["ap"] is not None and "car" in res["ap"]
