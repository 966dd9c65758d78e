"""The port's inference driver against the JAX driver, on the CPU.

* ``rebuild_ladders`` reproduces the JAX driver's ladder rebuild
  (``engine/test.py:96-99``) bit for bit op by op, and to the product's
  rounding where XLA contracts it into FMAs under jit;
* ``build_infer_group_fn`` gives the same packed selections (atol/rtol 1e-4,
  the float32 forward's tolerance) and exactly the same foreground counts,
  for 'nms' and 'top', with and without ``z_grids``;
* the slice as a whole: the port's CLI (``main --device cpu``) on a tiny
  synthetic KITTI val split, with weights exported from the JAX init as a
  reference-layout ``.pth``, writes the same KITTI result files as the JAX
  ``run_test`` + writer with the same weights (same files, lines, classes
  and order; numbers equal up to one unit of their last printed digit), and
  the same AP. Byte identity is out of reach in float32: the two CPU
  backends sum the matmuls and convolutions in different orders, the logits
  differ by ~2e-6, and that flips the sixth decimal of some ``%f`` scores.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frustum_convnet_tpu.configs import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list
from frustum_convnet_tpu.data.fixtures import make_batch
from frustum_convnet_tpu.data.kitti.prepare import extract_frustum_data_rgb_detection
from frustum_convnet_tpu.data.kitti.synthetic import make_synthetic_kitti
from frustum_convnet_tpu.data.provider import FrustumProvider
from frustum_convnet_tpu.engine import test as jtest
from frustum_convnet_tpu.evaluation import kitti_eval
from frustum_convnet_tpu.evaluation.kitti_writer import write_detection_results
from frustum_convnet_tpu.models.registry import get_model_spec
from frustum_convnet_tpu.parallel.train_step import (TrainStepConfig, init_state,
                                                     make_optimizer)
from frustum_convnet_tpu_torch.engine import test as ttest
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_end_to_end.py TINY_OVERRIDES (its module is marked slow)
TINY_OVERRIDES = [
    "DATA.MAX_DEPTH", "48",
    "DATA.NUM_SAMPLES", "128",
    "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)",
    "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)",
    "TRAIN.BATCH_SIZE", "8",
    "TEST.BATCH_SIZE", "8",
    "TRAIN.MAX_EPOCH", "2",
    "USE_TFBOARD", "True",
    "disp", "1",
]


def _state(model, spec, seed=5):
    b = make_batch(spec, batch=2, seed=0, with_labels=False)
    return init_state(model, make_optimizer(TrainStepConfig()), {
        "point_cloud": jnp.asarray(b["point_cloud"]),
        "one_hot": jnp.asarray(b["one_hot"]),
        "refs": tuple(jnp.asarray(r) for r in b["refs"])}, seed=seed)


def _port_model(spec, state):
    net = FrustumConvNet(spec)
    net.load_state_dict(from_jax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats),
                                 spec.num_scales), strict=True)
    return net.eval()


def test_ladder_rebuild_matches_jax(rng):
    """The ladders are ``off + dir * z`` in the JAX source's order: bit for
    bit what JAX computes op by op. Jitted, XLA on the CPU contracts part of
    the fused multiply-add into FMAs (which elements depends on the fused
    shape), so there the port agrees to the product's rounding and no
    closer: one ulp of ``dir * z`` plus one of the result."""
    z32 = [(np.arange(0, 70, s) + s / 2.0).astype(np.float32)
           for s in (0.25, 0.5, 1.0, 2.0)]
    rdir = rng.normal(0, 0.3, (64, 3)).astype(np.float32)
    rdir[:, 2] = rng.uniform(0.8, 1.0, 64)
    roff = rng.normal(0, 2.0, (64, 3)).astype(np.float32)

    def jax_rebuild(rdir, roff):  # frustum_convnet_tpu/engine/test.py:96-99
        return tuple(roff[:, None, :] + rdir[:, None, :] * jnp.asarray(z)[None, :, None]
                     for z in z32)

    got = ttest.rebuild_ladders(torch.from_numpy(rdir), torch.from_numpy(roff),
                                [torch.from_numpy(z) for z in z32])
    eager = jax_rebuild(jnp.asarray(rdir), jnp.asarray(roff))
    jitted = jax.jit(jax_rebuild)(jnp.asarray(rdir), jnp.asarray(roff))
    for g, e, j, z in zip(got, eager, jitted, z32):
        g, j = g.numpy(), np.asarray(j)
        np.testing.assert_array_equal(g, np.asarray(e))
        bound = (np.spacing(np.abs(rdir[:, None, :] * z[None, :, None]))
                 + np.spacing(np.abs(g)))
        assert (np.abs(g - j) <= bound).all()


@pytest.mark.parametrize("method,use_basis", [("nms", True), ("nms", False),
                                              ("top", True)])
def test_infer_group_matches_jax(rng, method, use_basis):
    _cfg, spec, jmodel = graft._flagship(tiny=True)
    state = _state(jmodel, spec)
    net = _port_model(spec, state)
    g, b, n = 2, 3, spec.num_points
    pts = make_batch(spec, batch=g * b, seed=1, with_labels=False)
    pts_g = pts["point_cloud"].reshape(g, b, n, 3).astype(np.float16)
    oh_g = pts["one_hot"].reshape(g, b, -1)
    z_grids = None
    if use_basis:
        z_grids = [np.arange(0, spec.max_depth, s) + s / 2.0 for s in spec.strides]
        rdir = rng.normal(0, 0.05, (g, b, 3)).astype(np.float32)
        rdir[..., 2] = 1.0
        roff = rng.normal(0, 0.5, (g, b, 3)).astype(np.float32)
        refs_g = (rdir, roff)
    else:
        refs_g = tuple(r.reshape(g, b, *r.shape[1:]) for r in pts["refs"])
    cap = 1 if method == "top" else min(16, spec.num_out)

    jfn = jtest.build_infer_group_fn(jmodel, spec, method, cap, z_grids=z_grids)
    jpacked, jcnt = jfn(state.params, state.batch_stats, jnp.asarray(pts_g),
                        jnp.asarray(oh_g), tuple(jnp.asarray(r) for r in refs_g))
    tfn = ttest.build_infer_group_fn(net, spec, method, cap, z_grids=z_grids)
    packed, cnt = tfn(torch.from_numpy(pts_g), torch.from_numpy(oh_g),
                      tuple(torch.from_numpy(r) for r in refs_g))
    assert packed.shape == jpacked.shape == (g, b, cap, 8)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked), **TOL)
    if method == "nms":
        assert (cnt.numpy() > 1).any()  # more than the argmax fallback


def _kitti_val(root, difficulty_mix=False):
    kitti_root = str(root / "kitti_raw")
    make_synthetic_kitti(kitti_root, num_frames=12, cars_per_frame=2, seed=1,
                         difficulty_mix=difficulty_mix)
    pickle_dir = str(root / "pickles")
    os.makedirs(pickle_dir)
    extract_frustum_data_rgb_detection(
        os.path.join(kitti_root, "rgb_detections", "rgb_detection_val.txt"),
        "training",
        os.path.join(pickle_dir, "frustum_caronly_val_rgb_detection.pickle"),
        kitti_root, type_whitelist=("Car",))
    return {"root": str(root), "kitti_root": kitti_root,
            "pickle_dir": pickle_dir}


@pytest.fixture(scope="module")
def kitti_val(tmp_path_factory):
    return _kitti_val(tmp_path_factory.mktemp("torch_e2e"))


def test_driver_writes_same_results_as_jax(kitti_val):
    """JAX run_test + writer vs the port's CLI on the CPU: batch 5, group 2,
    so a grouped dispatch and a padded tail batch both run."""
    _driver_matches_jax(kitti_val)


def test_driver_writes_same_results_as_jax_on_the_difficulty_mix(tmp_path):
    """The same on the protocol's difficulty mix (occluded, truncated and
    sparse cars, so sparse and clipped frustums), with the same AP per
    difficulty."""
    _driver_matches_jax(_kitti_val(tmp_path, difficulty_mix=True))


def _driver_matches_jax(kitti_val):
    overrides = TINY_OVERRIDES + ["DATA.DATA_ROOT", kitti_val["pickle_dir"],
                                  "TEST.BATCH_SIZE", "5", "TPU.INFER_GROUP", "2"]
    cfg = get_default_cfg()
    merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    merge_cfg_from_list(overrides, cfg)
    spec = get_model_spec(cfg)
    jmodel = graft._flagship(tiny=True)[2].clone(spec=spec)
    dataset = FrustumProvider(cfg, "val", one_hot=True, from_rgb_detection=True)
    n_batches = -(-len(dataset) // 5)
    assert n_batches >= 3 and n_batches % 2 == 1, len(dataset)

    logger = logging.getLogger("torch_e2e_test")
    state = jtest.load_state_for_test(jmodel, spec, cfg, dataset, logger)
    det_j = jtest.run_test(jmodel, spec, state, dataset, batch_size=5,
                           method="nms", logger=logger, num_workers=2, group=2)
    idx_path = os.path.join(kitti_val["kitti_root"], "image_sets", "val.txt")
    with open(idx_path) as f:
        ids = [int(line) for line in f if line.strip()]
    jdir = write_detection_results(os.path.join(kitti_val["root"], "jax"),
                                   det_j, ids, nms_threshold=cfg.TEST.THRESH)

    weights = os.path.join(kitti_val["root"], "init.pth")
    torch.save({"state_dict": _port_model(spec, state).state_dict()}, weights)
    gt_dir = os.path.join(kitti_val["kitti_root"], "training", "label_2")
    out = ttest.main(["--cfg", "cfgs/det_sample.yaml", "--device", "cpu",
                      "--gt_dir", gt_dir, "--idx_path", idx_path] + overrides
                     + ["OUTPUT_DIR", os.path.join(kitti_val["root"], "torch"),
                        "TEST.WEIGHTS", weights])
    tdir = out["result_dir"]
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) and len(files) == len(ids)
    stats = out["stats"]
    assert stats["sections"] >= max(stats["detections"], stats["frustums"])  # nms
    assert stats["detections"] > 0
    assert any(os.path.getsize(os.path.join(tdir, f)) for f in files)
    n_lines = n_same = 0
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
            n_same += lj == lt
    assert n_lines > 0 and n_same >= n_lines // 2, (n_same, n_lines)
    ap_j = kitti_eval.evaluate(gt_dir, os.path.dirname(jdir), classes=("car",))
    assert out["ap"] == ap_j
