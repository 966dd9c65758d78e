"""The KITTI refine cascade in the port against the JAX package, on the CPU.

A tiny synthetic KITTI, a stage-1 result directory (the ground-truth boxes
moved by a few decimetres) and the refine pickles the port's prep writes from
them feed both packages. At the refine shapes (N=128 here, a fixed ladder of
64/32/16/8 sections whose tails repeat the last section):

* the eval forward and decode against Flax with the same weights
  (``models.weights.from_jax``): float32 within 1e-4, float64 within 1e-10;
* ``build_infer_group_fn`` without the ladder basis (the refine provider
  has none) against the JAX one, for 'nms' and 'top';
* one CPU epoch of ``engine.train.main`` on ``cfgs/refine_car.yaml``;
* the port's test CLI against the JAX ``run_test`` + writer with the same
  weights: the same result files, each number within one unit of its last
  printed digit, and equal AP.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frustum_convnet_tpu.configs import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list
from frustum_convnet_tpu.data.provider import collate_batch
from frustum_convnet_tpu.data.provider_refine import FrustumRefineProvider as JaxRefineProvider
from frustum_convnet_tpu.engine import test as jtest
from frustum_convnet_tpu.evaluation import kitti_eval
from frustum_convnet_tpu.evaluation.kitti_writer import write_detection_results
from frustum_convnet_tpu.models.det import decode_outputs as jax_decode
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
from frustum_convnet_tpu.models.registry import get_model_spec
from frustum_convnet_tpu_torch.data.kitti import prepare_refine
from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
from frustum_convnet_tpu_torch.engine import checkpoints
from frustum_convnet_tpu_torch.engine import test as ttest
from frustum_convnet_tpu_torch.engine import train as trainer
from frustum_convnet_tpu_torch.models.det import decode_outputs
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax
from test_torch_select import _duplicated_sections
from test_torch_model import F32_TOL, F64_TOL, _jax_forward, _torch_forward, _variables
from test_torch_standalone import fake_stage1_results

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "refine_car.yaml")
TINY = ["DATA.NUM_SAMPLES", "128", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "5",
        "NUM_WORKERS", "1", "disp", "1", "USE_TFBOARD", "False"]


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    """Synthetic KITTI (12 frames of 2 cars), a stage-1 result directory and
    the refine pickles (ground-truth path for train and val, rgb-detection
    path for val)."""
    root = tmp_path_factory.mktemp("torch_refine")
    kitti = str(root / "kitti_raw")
    make_synthetic_kitti(kitti, num_frames=12, cars_per_frame=2, seed=2)
    res = str(root / "stage1" / "data")
    fake_stage1_results(os.path.join(kitti, "training", "label_2"), res)
    pickles = str(root / "refine")
    prepare_refine.main(["--car_only", "--gen_train", "--gen_val",
                         "--gen_val_rgb_detection", "--data_root", kitti,
                         "--save_dir", pickles, "--val_res_dir", res])
    cfg = get_default_cfg()
    merge_cfg_from_file(CFG, cfg)
    merge_cfg_from_list(TINY + ["DATA.DATA_ROOT", pickles], cfg)
    return {"root": root, "kitti": kitti, "pickles": pickles, "cfg": cfg,
            "spec": get_model_spec(cfg)}


def _batch(cascade, split, n, **kw):
    ds = JaxRefineProvider(cascade["cfg"], split, **kw)
    rng = np.random.default_rng(4)
    return collate_batch([ds.__getitem__(i % len(ds), rng) for i in range(n)],
                         cascade["spec"].num_scales)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.float64, F64_TOL)],
                         ids=["f32", "f64"])
def test_refine_forward_and_decode_match_flax(cascade, dtype, tol):
    """Labeled refine items (flipped and shifted): the forward and the
    decode against Flax with the same weights."""
    spec = cascade["spec"]
    assert spec.num_refs == (64, 32, 16, 8) and spec.num_points == 128
    batch = _batch(cascade, "train", 3, random_flip=True, random_shift=True)
    assert _duplicated_sections(batch["refs"]) > 0
    params, stats = _variables(spec, batch)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        want = _jax_forward(spec, params, stats, batch, jdt)
        want_dec = jax_decode(spec, jnp.asarray(want[0]), jnp.asarray(want[1]),
                              jnp.asarray(batch["refs"][1], jdt))
        want_dec = {k: np.asarray(v) for k, v in want_dec.items()}
    got = _torch_forward(spec, params, stats, batch, dtype)
    for g, w, name in zip(got, want, ("cls_logits", "reg")):
        assert g.shape == w.shape and g.dtype == w.dtype and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    dec = decode_outputs(spec, torch.from_numpy(got[0]), torch.from_numpy(got[1]),
                         torch.from_numpy(batch["refs"][1]).to(dtype))
    assert set(dec) == set(want_dec)
    for k, v in dec.items():
        np.testing.assert_allclose(v.numpy(), want_dec[k], err_msg=k, **tol)


def _jax_state(cascade):
    dataset = JaxRefineProvider(cascade["cfg"], "val", from_rgb_detection=True)
    model = JaxNet(cascade["spec"])
    state = jtest.load_state_for_test(model, cascade["spec"], cascade["cfg"], dataset,
                                      logging.getLogger("torch_refine_test"))
    return model, state, dataset


def _port_model(spec, state):
    net = FrustumConvNet(spec)
    net.load_state_dict(from_jax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats), spec.num_scales),
                        strict=True)
    return net.eval()


@pytest.mark.parametrize("method", ["nms", "top"])
def test_refine_infer_group_matches_jax(cascade, method):
    """Grouped dispatch with the ladders uploaded as they are (no basis):
    the same foreground counts and packed selections within 1e-4."""
    spec = cascade["spec"]
    jmodel, state, _ = _jax_state(cascade)
    net = _port_model(spec, state)
    g, b = 2, 3
    batch = _batch(cascade, "val", g * b, from_rgb_detection=True)
    assert _duplicated_sections(batch["refs"]) > 0
    pts_g = batch["point_cloud"].reshape(g, b, spec.num_points, 3).astype(np.float16)
    oh_g = batch["one_hot"].reshape(g, b, -1)
    refs_g = tuple(r.reshape(g, b, *r.shape[1:]) for r in batch["refs"])
    cap = 1 if method == "top" else spec.num_out  # the port packs every section
    jfn = jtest.build_infer_group_fn(jmodel, spec, method, cap)
    jpacked, jcnt = jfn(state.params, state.batch_stats, jnp.asarray(pts_g),
                        jnp.asarray(oh_g), tuple(jnp.asarray(r) for r in refs_g))
    tfn = ttest.build_infer_group_fn(net, spec, method)
    packed, cnt = tfn(torch.from_numpy(pts_g), torch.from_numpy(oh_g),
                      tuple(torch.from_numpy(r) for r in refs_g))
    assert packed.shape == jpacked.shape == (g, b, cap, 8)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked), **F32_TOL)


def test_refine_trains_one_epoch_on_cpu(cascade):
    out = str(cascade["root"] / "train_out")
    res = trainer.main(["--cfg", CFG, "--device", "cpu"] + TINY + [
        "DATA.DATA_ROOT", cascade["pickles"], "OUTPUT_DIR", out,
        "TRAIN.MAX_EPOCH", "1", "TPU.METRIC_INTERVAL", "-1"])
    assert [e["epoch"] for e in res["epochs"]] == [0] and res["epochs"][0]["steps"] > 1
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert "total_loss" in log and "nan" not in log.lower()
    assert os.path.exists(checkpoints.checkpoint_paths(out)["final"])


def test_refine_driver_writes_same_results_as_jax(cascade):
    """JAX run_test + writer against the port's CLI: batch 5, group 2, so a
    grouped dispatch and a padded tail batch both run."""
    spec, cfg = cascade["spec"], cascade["cfg"]
    jmodel, state, dataset = _jax_state(cascade)
    n_batches = -(-len(dataset) // 5)
    assert n_batches >= 3 and n_batches % 2 == 1 and len(dataset) % 5, len(dataset)
    logger = logging.getLogger("torch_refine_test")
    det_j = jtest.run_test(jmodel, spec, state, dataset, batch_size=5, method="nms",
                           logger=logger, num_workers=1, group=2)
    idx_path = os.path.join(cascade["kitti"], "image_sets", "val.txt")
    with open(idx_path) as f:
        ids = [int(line) for line in f if line.strip()]
    jdir = write_detection_results(str(cascade["root"] / "jax"), det_j, ids,
                                   nms_threshold=cfg.TEST.THRESH)

    weights = str(cascade["root"] / "init.pth")
    torch.save({"state_dict": _port_model(spec, state).state_dict()}, weights)
    gt_dir = os.path.join(cascade["kitti"], "training", "label_2")
    out = ttest.main(["--cfg", CFG, "--device", "cpu", "--gt_dir", gt_dir,
                      "--idx_path", idx_path] + TINY + [
        "DATA.DATA_ROOT", cascade["pickles"], "TPU.INFER_GROUP", "2",
        "OUTPUT_DIR", str(cascade["root"] / "torch"), "TEST.WEIGHTS", weights])
    tdir = out["result_dir"]
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) and len(files) == len(ids)
    assert out["stats"]["frustums"] == len(dataset) and out["stats"]["detections"] > 0
    n_lines = 0
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
            n_lines += 1
    assert n_lines > 0
    ap_j = kitti_eval.evaluate(gt_dir, os.path.dirname(jdir), classes=("car",))
    assert out["ap"] == ap_j
