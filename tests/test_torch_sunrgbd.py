"""The SUN-RGBD family and the people config in the port against the JAX
package, on the CPU.

Tiny synthetic SUN-RGBD scenes and the pickles the port's prep writes from
them feed both packages, at the 5-scale model's widths with a short ladder
(MAX_DEPTH 4: 40/20/10/5/3 sections, K 128/128/256/256/256, N=256):

* the eval forward against Flax with the same weights, carried over by
  ``models.weights.from_jax`` over 5 scales: float32 within 1e-4, float64
  within 1e-10;
* ``run_test_sunrgbd`` of both packages on the same weights, for 'top' and
  'nms': the same frustums, the same number of detections each, boxes and
  scores within 1e-4, equal ``to_corner_results`` keys and equal VOC APs;
* the forward at DATA.NUM_SAMPLES 128, under the 256 slots of scales 3-5
  (nsample above the point count), against Flax grouping with its Pallas
  kernel in interpret mode (its CPU ``lax.top_k`` grouping needs K <= N);
* one CPU epoch of ``engine.train.main`` on ``cfgs/det_sample_sunrgbd.yaml``,
  then ``engine.test_sunrgbd.main --device cpu`` writing ``sunrgbd_ap.json``,
  in float32 and at TPU.INFER_DTYPE bfloat16;
* ``cfgs/det_sample_people.yaml`` (Pedestrian and Cyclist) through the port's
  stage-1 provider and forward at a short depth, against the JAX provider
  and Flax.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frustum_convnet_tpu.configs import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list
from frustum_convnet_tpu.data.provider import FrustumProvider as JaxProvider
from frustum_convnet_tpu.data.provider import collate_batch
from frustum_convnet_tpu.data.provider_sunrgbd import FrustumSunrgbdProvider as JaxSunProvider
from frustum_convnet_tpu.engine import test as jtest
from frustum_convnet_tpu.engine import test_sunrgbd as jsun
from frustum_convnet_tpu.evaluation.sunrgbd_eval import build_gt_all, eval_det
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
from frustum_convnet_tpu.models.registry import get_model_spec
from frustum_convnet_tpu_torch.data.kitti import prepare as kitti_prepare
from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
from frustum_convnet_tpu_torch.data.provider import FrustumProvider
from frustum_convnet_tpu_torch.data.sunrgbd import prepare as sun_prepare
from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd
from frustum_convnet_tpu_torch.engine import checkpoints
from frustum_convnet_tpu_torch.engine import test_sunrgbd as tsun
from frustum_convnet_tpu_torch.engine import train as trainer
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax
from test_torch_standalone import assert_same
from test_torch_model import F32_TOL, F64_TOL, _jax_forward, _torch_forward, _variables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "det_sample_sunrgbd.yaml")
PEOPLE_CFG = os.path.join(ROOT, "cfgs", "det_sample_people.yaml")
TINY = ["DATA.NUM_SAMPLES", "256", "DATA.MAX_DEPTH", "4", "TRAIN.BATCH_SIZE", "4",
        "TEST.BATCH_SIZE", "7", "NUM_WORKERS", "1", "disp", "1", "USE_TFBOARD", "False",
        "TPU.INFER_GROUP", "2"]
BOX_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def sun(tmp_path_factory):
    """Synthetic scenes (8 frames of 2 objects) and their train, val and
    rgb-detection pickles."""
    root = tmp_path_factory.mktemp("torch_sunrgbd")
    raw = str(root / "mysunrgbd")
    make_synthetic_sunrgbd(raw, num_frames=8, objects_per_frame=2, seed=4)
    pickles = str(root / "pickles")
    sets = os.path.join(raw, "image_sets")
    sun_prepare.main(["--gen_train", "--gen_val", "--gen_val_rgb_detection",
                      "--sunrgbd_dir", raw, "--save_dir", pickles,
                      "--train_idx", os.path.join(sets, "train.txt"),
                      "--val_idx", os.path.join(sets, "val.txt"),
                      "--det_file", os.path.join(raw, "det_val.txt")])
    rgb_det = os.path.join(pickles, "sunrgbd_rgb_det_val.pickle")
    overrides = TINY + ["DATA.DATA_ROOT", pickles, "OVER_WRITE_TEST_FILE", rgb_det]
    cfg = get_default_cfg()
    merge_cfg_from_file(CFG, cfg)
    merge_cfg_from_list(overrides, cfg)
    return {"root": root, "raw": raw, "pickles": pickles, "rgb_det": rgb_det,
            "overrides": overrides, "cfg": cfg, "spec": get_model_spec(cfg),
            "val_idx": os.path.join(sets, "val.txt")}


def _batch(dataset, spec, n, seed=4):
    rng = np.random.default_rng(seed)
    return collate_batch([dataset.__getitem__(i % len(dataset), rng) for i in range(n)],
                         spec.num_scales)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.float64, F64_TOL)],
                         ids=["f32", "f64"])
def test_sunrgbd_forward_matches_flax(sun, dtype, tol):
    spec = sun["spec"]
    assert spec.num_scales == 5 and spec.num_refs == (40, 20, 10, 5, 3)
    assert spec.nsamples == (128, 128, 256, 256, 256)
    assert spec.block_channels == (64, 128, 256, 512, 512)
    batch = _batch(JaxSunProvider(sun["cfg"], "train", random_flip=True,
                                  random_shift=True), spec, 3)
    params, stats = _variables(spec, batch)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        want = _jax_forward(spec, params, stats, batch, jdt)
    got = _torch_forward(spec, params, stats, batch, dtype)
    for g, w, name in zip(got, want, ("cls_logits", "reg")):
        assert g.shape == w.shape and g.dtype == w.dtype and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_sunrgbd_forward_with_nsample_above_the_point_count(sun, monkeypatch):
    from frustum_convnet_tpu.models import net as jax_net
    from frustum_convnet_tpu.ops.query_depth_point import query_depth_point_np
    from frustum_convnet_tpu.ops.select_pallas import group_depth_point_multi

    monkeypatch.setattr(jax_net, "group_depth_point_multi_auto",
                        lambda *args: group_depth_point_multi(*args, interpret=True))
    cfg = get_default_cfg()
    merge_cfg_from_file(CFG, cfg)
    merge_cfg_from_list(sun["overrides"] + ["DATA.NUM_SAMPLES", "128"], cfg)
    spec = get_model_spec(cfg)
    assert spec.num_points == 128 and spec.nsamples == (128, 128, 256, 256, 256)
    batch = _batch(JaxSunProvider(cfg, "train", random_flip=True, random_shift=True),
                   spec, 3)
    assert batch["point_cloud"].shape[1] == 128
    for ref, d, k in zip(batch["refs"], spec.height_half, spec.nsamples):
        _, cnt = query_depth_point_np(batch["point_cloud"][..., 2], ref[..., 2], d, k)
        assert cnt.max() <= 128 < k or k == 128
    params, stats = _variables(spec, batch)
    want = _jax_forward(spec, params, stats, batch, jnp.float32)
    got = _torch_forward(spec, params, stats, batch, torch.float32)
    for g, w, name in zip(got, want, ("cls_logits", "reg")):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)


def _decisive_state(sun):
    """The JAX driver's seeded init, with the cls head scaled 30 times so
    that no section's fg probability sits within float32 noise of the 0.5
    threshold or of another section's."""
    dataset = JaxSunProvider(sun["cfg"], "val", from_rgb_detection=True,
                             overwritten_data_path=sun["rgb_det"])
    model = JaxNet(sun["spec"])
    state = jtest.load_state_for_test(model, sun["spec"], sun["cfg"], dataset,
                                      logging.getLogger("torch_sunrgbd_test"))
    params = dict(jax.tree_util.tree_map(np.asarray, jax.device_get(state.params)))
    params["cls_out"] = {k: v * 30 for k, v in params["cls_out"].items()}
    return model, dataclasses.replace(state, params=params), dataset


@pytest.mark.parametrize("method", ["top", "nms"])
def test_run_test_sunrgbd_matches_jax(sun, method):
    spec = sun["spec"]
    jmodel, state, dataset = _decisive_state(sun)
    logger = logging.getLogger("torch_sunrgbd_test")
    batch_size = sun["cfg"].TEST.BATCH_SIZE
    det_j = jsun.run_test_sunrgbd(jmodel, spec, state, dataset, batch_size, method, logger,
                                  num_workers=1, group=2)
    net = FrustumConvNet(spec)
    net.load_state_dict(from_jax(state.params, jax.device_get(state.batch_stats),
                                 spec.num_scales), strict=True)
    tdataset = tsun.FrustumSunrgbdProvider(sun["cfg"], "val", from_rgb_detection=True,
                                           overwritten_data_path=sun["rgb_det"])
    det_t, stats = tsun.run_test_sunrgbd(net, spec, tdataset, batch_size, method, logger,
                                         num_workers=1, group=2)
    # an odd number of batches, the last one padded: the tail group repeats it
    n_batches = -(-len(dataset) // batch_size)
    assert n_batches >= 3 and n_batches % 2 == 1 and len(dataset) % batch_size
    assert stats["frustums"] == len(dataset)
    assert stats["sections"] == stats["detections"] + stats["degenerate"]
    if method == "top":
        assert stats["sections"] == len(dataset)
    else:
        assert stats["sections"] > len(dataset)  # more than the argmax fallback
    assert sorted(det_t) == sorted(det_j)
    for img in det_j:
        assert sorted(det_t[img]) == sorted(det_j[img])
        for cls, rows in det_j[img].items():
            assert len(det_t[img][cls]) == len(rows), (img, cls)
            if rows:
                np.testing.assert_allclose(np.asarray(det_t[img][cls]), np.asarray(rows),
                                           **BOX_TOL)
    nms = 0.1 if method == "nms" else None
    pred_j = jsun.to_corner_results(det_j, nms)
    pred_t = tsun.to_corner_results(det_t, nms)
    assert {c: sorted(v) for c, v in pred_t.items()} == {c: sorted(v) for c, v in pred_j.items()}
    with open(sun["val_idx"]) as f:
        ids = [int(line) for line in f if line.strip()]
    gt = build_gt_all(sun["raw"], ids, jsun.TYPE_WHITELIST_10)
    assert eval_det(pred_t, gt, ovthresh=0.25)[2] == eval_det(pred_j, gt, ovthresh=0.25)[2]


def test_sunrgbd_trains_then_serves_on_cpu(sun):
    out = str(sun["root"] / "out")
    res = trainer.main(["--cfg", CFG, "--device", "cpu"] + sun["overrides"] + [
        "OUTPUT_DIR", out, "TRAIN.MAX_EPOCH", "1"])
    assert [e["epoch"] for e in res["epochs"]] == [0] and res["epochs"][0]["steps"] > 1
    final = checkpoints.checkpoint_paths(out)["final"]
    assert os.path.exists(final)
    served = tsun.main(["--cfg", CFG, "--device", "cpu", "--sunrgbd_dir", sun["raw"],
                        "--val_idx", sun["val_idx"]] + sun["overrides"] + [
        "OUTPUT_DIR", out, "TEST.WEIGHTS", final])
    stats = served["stats"]
    assert stats["sections"] == stats["frustums"] > 0  # 'top': one a frustum
    with open(os.path.join(served["result_dir"], "sunrgbd_ap.json")) as f:
        written = json.load(f)
    assert written["ap"] == served["ap"] and all(np.isfinite(list(served["ap"].values())))
    half = tsun.main(["--cfg", CFG, "--device", "cpu", "--sunrgbd_dir", sun["raw"],
                      "--val_idx", sun["val_idx"]] + sun["overrides"] + [
        "OUTPUT_DIR", str(sun["root"] / "out_bf16"), "TEST.WEIGHTS", final,
        "TPU.INFER_DTYPE", "bfloat16"])
    assert half["stats"]["sections"] == half["stats"]["frustums"] == stats["frustums"]
    assert sorted(half["ap"]) == sorted(served["ap"])
    assert all(np.isfinite(list(half["ap"].values())))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsun.main(["--cfg", CFG] + sun["overrides"])


def test_people_config_through_port_provider_and_forward(tmp_path):
    """``cfgs/det_sample_people.yaml`` at MAX_DEPTH 16 (160/80/40/20
    sections): the port's stage-1 provider gives the JAX provider's items
    on Pedestrian and Cyclist frustums, and the forward matches Flax."""
    raw = str(tmp_path / "kitti_raw")
    make_synthetic_kitti(raw, num_frames=4, cars_per_frame=3, seed=3,
                         classes=("Pedestrian", "Cyclist"))
    kitti_prepare.main(["--people_only", "--gen_val_rgb_detection", "--data_root", raw,
                        "--rgb_det_dir", os.path.join(raw, "rgb_detections"),
                        "--save_dir", str(tmp_path / "pickles")])
    overrides = ["DATA.DATA_ROOT", str(tmp_path / "pickles"), "DATA.NUM_SAMPLES", "256",
                 "DATA.MAX_DEPTH", "16"]
    cfg = get_default_cfg()
    merge_cfg_from_file(PEOPLE_CFG, cfg)
    merge_cfg_from_list(overrides, cfg)
    spec = get_model_spec(cfg)
    assert spec.num_refs == (160, 80, 40, 20) and spec.num_vec == 3
    jds = JaxProvider(cfg, "val", from_rgb_detection=True)
    tds = FrustumProvider(cfg, "val", from_rgb_detection=True)
    assert len(tds) == len(jds) >= 3
    assert {t for t in tds.data["type"]} <= {"Pedestrian", "Cyclist"}
    batch, tbatch = _batch(jds, spec, 3), _batch(tds, spec, 3)
    assert_same(tbatch, batch)
    params, stats = _variables(spec, batch)
    want = _jax_forward(spec, params, stats, batch, jnp.float32)
    got = _torch_forward(spec, params, stats, tbatch, torch.float32)
    for g, w, name in zip(got, want, ("cls_logits", "reg")):
        np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)
