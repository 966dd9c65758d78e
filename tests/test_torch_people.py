"""The KITTI people cascade (Pedestrian and Cyclist) in the port against the
JAX package, on the CPU, command for command as ``scripts/people_all.sh``.

A tiny synthetic people KITTI (``make_synthetic_kitti(..., classes=
("Pedestrian", "Cyclist"))``) goes through the port's ``data.kitti.prepare
--people_only``; a stage-1 result directory (the ground-truth boxes moved by
a few decimetres) through ``data.kitti.prepare_refine --people_only``. Then,
for ``cfgs/det_sample_people.yaml`` (128 points here) and for
``cfgs/refine_people.yaml``:

* one CPU epoch through ``engine.train.main``, with finite losses (stage 1
  on a 16 m ladder);
* the port's ``engine.test.main`` against the JAX ``run_test`` + writer with
  the same weights, stage 1 at its full ladder (MAX_DEPTH 70, strides
  0.1..0.8: 700/350/175/88 = 1313 sections) (``models.weights.from_jax``): the same result files,
  each number within one unit of its last printed digit, Pedestrian and
  Cyclist lines among them, and equal AP for every class the evaluator runs
  (CAR_ONLY is False: car, pedestrian and cyclist).
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from frustum_convnet_tpu.configs import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list
from frustum_convnet_tpu.data.provider import FrustumProvider as JaxProvider
from frustum_convnet_tpu.data.provider_refine import FrustumRefineProvider as JaxRefineProvider
from frustum_convnet_tpu.engine import test as jtest
from frustum_convnet_tpu.evaluation import kitti_eval
from frustum_convnet_tpu.evaluation.kitti_writer import write_detection_results
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
from frustum_convnet_tpu.models.registry import get_model_spec
from frustum_convnet_tpu_torch.data.kitti import prepare, prepare_refine
from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
from frustum_convnet_tpu_torch.engine import checkpoints
from frustum_convnet_tpu_torch.engine import test as ttest
from frustum_convnet_tpu_torch.engine import train as trainer
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax
from test_torch_standalone import fake_stage1_results

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (cfg, pickles, JAX provider, the training epoch's extra overrides): stage
# 1 trains on a 16 m ladder (160/80/40/20 sections), a CPU step at 1313
# sections takes seconds; both drivers serve the full ladder
STAGES = {
    "stage1": (os.path.join(ROOT, "cfgs", "det_sample_people.yaml"), "stage1_pickles",
               JaxProvider, ["DATA.MAX_DEPTH", "16"]),
    "refine": (os.path.join(ROOT, "cfgs", "refine_people.yaml"), "refine_pickles",
               JaxRefineProvider, []),
}
TINY = ["DATA.NUM_SAMPLES", "128", "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "6",
        "NUM_WORKERS", "1", "disp", "1", "USE_TFBOARD", "False"]
CLASSES = ("car", "pedestrian", "cyclist")


@pytest.fixture(scope="module")
def people(tmp_path_factory):
    """Synthetic people KITTI (10 frames of 3 objects), its stage-1 pickles,
    a stage-1 result directory and the refine pickles cut from it."""
    root = tmp_path_factory.mktemp("torch_people")
    raw = str(root / "kitti_raw")
    make_synthetic_kitti(raw, num_frames=10, cars_per_frame=3, seed=5,
                         classes=("Pedestrian", "Cyclist"))
    prepare.main(["--people_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                  "--data_root", raw, "--rgb_det_dir", os.path.join(raw, "rgb_detections"),
                  "--save_dir", str(root / "stage1_pickles")])
    res = str(root / "stage1_results" / "data")
    fake_stage1_results(os.path.join(raw, "training", "label_2"), res)
    # scripts/people_all.sh passes --gen_train and --gen_val_rgb_detection;
    # the refine trainer's validation epoch also reads the labeled val pickle
    prepare_refine.main(["--people_only", "--gen_train", "--gen_val",
                         "--gen_val_rgb_detection", "--data_root", raw,
                         "--save_dir", str(root / "refine_pickles"), "--val_res_dir", res])
    return {"root": root, "raw": raw}


def _cfg(people, stage):
    cfg_file, pickles, _, _ = STAGES[stage]
    cfg = get_default_cfg()
    merge_cfg_from_file(cfg_file, cfg)
    merge_cfg_from_list(TINY + ["DATA.DATA_ROOT", str(people["root"] / pickles)], cfg)
    return cfg


@pytest.mark.parametrize("stage", list(STAGES))
def test_people_trains_one_epoch_on_cpu(people, stage):
    cfg_file, pickles, _, opts = STAGES[stage]
    out = str(people["root"] / f"train_{stage}")
    res = trainer.main(["--cfg", cfg_file, "--device", "cpu"] + TINY + opts + [
        "DATA.DATA_ROOT", str(people["root"] / pickles), "OUTPUT_DIR", out,
        "TRAIN.MAX_EPOCH", "1", "TPU.METRIC_INTERVAL", "-1"])
    assert [e["epoch"] for e in res["epochs"]] == [0] and res["epochs"][0]["steps"] > 1
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert "total_loss" in log and "IoU_0.5" in log and "nan" not in log.lower()
    assert os.path.exists(checkpoints.checkpoint_paths(out)["final"])


@pytest.mark.parametrize("stage", list(STAGES))
def test_people_driver_writes_same_results_as_jax(people, stage):
    """JAX run_test + writer against the port's CLI with the same weights:
    batch 6, group 2, so a grouped dispatch and a padded tail batch run."""
    cfg_file, pickles, provider, _ = STAGES[stage]
    cfg = _cfg(people, stage)
    spec = get_model_spec(cfg)
    if stage == "stage1":
        assert spec.num_refs == (700, 350, 175, 88)
    dataset = provider(cfg, "val", one_hot=True, from_rgb_detection=True)
    assert {"Pedestrian", "Cyclist"} <= set(dataset.data["type"])
    assert -(-len(dataset) // 6) % 2 and len(dataset) > 12 and len(dataset) % 6, len(dataset)
    logger = logging.getLogger("torch_people_test")
    jmodel = JaxNet(spec)
    state = jtest.load_state_for_test(jmodel, spec, cfg, dataset, logger)
    det_j = jtest.run_test(jmodel, spec, state, dataset, batch_size=6, method="nms",
                           logger=logger, num_workers=1, group=2)
    idx_path = os.path.join(people["raw"], "image_sets", "val.txt")
    with open(idx_path) as f:
        ids = [int(line) for line in f if line.strip()]
    jdir = write_detection_results(str(people["root"] / f"jax_{stage}"), det_j, ids,
                                   nms_threshold=cfg.TEST.THRESH)

    net = FrustumConvNet(spec)
    net.load_state_dict(from_jax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats), spec.num_scales),
                        strict=True)
    weights = str(people["root"] / f"init_{stage}.pth")
    torch.save({"state_dict": net.state_dict()}, weights)
    gt_dir = os.path.join(people["raw"], "training", "label_2")
    out = ttest.main(["--cfg", cfg_file, "--device", "cpu", "--gt_dir", gt_dir,
                      "--idx_path", idx_path] + TINY + [
        "DATA.DATA_ROOT", str(people["root"] / pickles), "TPU.INFER_GROUP", "2",
        "OUTPUT_DIR", str(people["root"] / f"torch_{stage}"), "TEST.WEIGHTS", weights])
    tdir = out["result_dir"]
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) and len(files) == len(ids)
    assert out["stats"]["frustums"] == len(dataset) and out["stats"]["detections"] > 0
    types = set()
    for name in files:
        with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
            lines_j, lines_t = a.read().splitlines(), b.read().splitlines()
        assert len(lines_j) == len(lines_t), name
        for lj, lt in zip(lines_j, lines_t):
            fj, ft = lj.split(), lt.split()
            assert fj[:3] == ft[:3] and len(fj) == len(ft) == 16, (lj, lt)
            # one unit of the last printed digit: %.4f fields, %f score
            np.testing.assert_allclose(np.float64(ft[3:15]), np.float64(fj[3:15]),
                                       rtol=0, atol=1.01e-4, err_msg=name)
            np.testing.assert_allclose(float(ft[15]), float(fj[15]),
                                       rtol=0, atol=2.01e-6, err_msg=name)
            types.add(ft[0])
    assert types == {"Pedestrian", "Cyclist"}
    ap_j = kitti_eval.evaluate(gt_dir, os.path.dirname(jdir), classes=CLASSES)
    assert set(out["ap"]) == set(CLASSES) and out["ap"] == ap_j
