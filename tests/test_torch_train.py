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
* a checkpoint the trainer wrote serves through ``engine.test.main``.
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


def test_unported_variants_raise(run):
    for key, val in (("TPU.BN_GROUP_SIZE", "4"), ("TPU.FAST_BN", "True"),
                     ("TPU.FAST_BN_FIRST", "True"), ("TPU.REMAT_POINTNET", "True"),
                     ("TPU.COMPUTE_DTYPE", "bfloat16")):
        with pytest.raises(NotImplementedError, match=key):
            trainer.main(run["base"] + [key, val])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.main(["--cfg", CFG, "--device", "cuda"])


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
