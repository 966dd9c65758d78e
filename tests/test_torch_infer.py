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
  differ by ~2e-6, and that flips the sixth decimal of some ``%f`` scores;
* in float64 it is not: both packages' ``build_infer_group_fn`` on the same
  weights and the provider's ladders, each package's host postprocess and
  KITTI writer, write byte-identical result files on the 12-frame v1 split
  and on the difficulty mix;
* in float64, ``run_test``'s detections equal, bit for bit, JAX's host
  selection and postprocess (``postprocess_batch``) over the port's own
  grouped forward and full decode, the padded tail group on the provider's
  ladders, for 'top' and 'nms', and for 'nms' with a cls head that keeps
  all 70 sections of every frustum, more than the 64 an earlier cap kept.
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
from frustum_convnet_tpu.engine.loader import BatchLoader
from frustum_convnet_tpu.evaluation import kitti_eval
from frustum_convnet_tpu.evaluation.kitti_writer import write_detection_results
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
from frustum_convnet_tpu.models.registry import get_model_spec
from frustum_convnet_tpu.parallel.train_step import (TrainStepConfig, init_state,
                                                     make_optimizer)
from frustum_convnet_tpu_torch import configs as tconfigs
from frustum_convnet_tpu_torch.data.provider import FrustumProvider as TFrustumProvider
from frustum_convnet_tpu_torch.engine import test as ttest
from frustum_convnet_tpu_torch.engine.loader import BatchLoader as TBatchLoader
from frustum_convnet_tpu_torch.evaluation.kitti_writer import (
    write_detection_results as port_write_detection_results)
from frustum_convnet_tpu_torch.models.det import decode_outputs
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
    cap = 1 if method == "top" else spec.num_out  # the port packs every section

    jfn = jtest.build_infer_group_fn(jmodel, spec, method, cap, z_grids=z_grids)
    jpacked, jcnt = jfn(state.params, state.batch_stats, jnp.asarray(pts_g),
                        jnp.asarray(oh_g), tuple(jnp.asarray(r) for r in refs_g))
    tfn = ttest.build_infer_group_fn(net, spec, method, z_grids=z_grids)
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


def _grouped_full_decode(model, spec, dataset, method, batch_size, group) -> dict:
    """``run_test``'s serving written out with JAX's host selection: groups
    of whole batches (the tail padded by repeating its last) through the
    port's forward, whole groups on the ladders rebuilt from the basis as
    ``build_infer_group_fn`` rebuilds them and the tail on the provider's,
    every section decoded and brought back, then JAX's ``postprocess_batch``
    batch by batch."""
    loader = TBatchLoader(dataset, batch_size, spec.num_scales, shuffle=False,
                          drop_last=False, pad_last=True, seed=0, num_workers=1)
    batches = list(loader.epoch(0))
    z = [torch.from_numpy(np.asarray(d, np.float32)) for d in dataset.ref_depths()]
    det: dict = {}
    for lo in range(0, len(batches), group):
        real = batches[lo:lo + group]
        padded = real + [real[-1]] * (group - len(real))

        def flat(x):
            return torch.from_numpy(np.concatenate(x))

        with torch.inference_mode():
            pts = flat([b["point_cloud"] for b in padded]).to(torch.float16).float()
            if len(real) == group:
                refs = ttest.rebuild_ladders(flat([b["ref_dir"] for b in padded]),
                                             flat([b["ref_off"] for b in padded]), z)
            else:
                refs = [flat([b["refs"][i] for b in padded]) for i in range(spec.num_scales)]
            cls_logits, reg = model(pts, flat([b["one_hot"] for b in padded]), list(refs))
            out = {k: v.numpy() for k, v in
                   decode_outputs(spec, cls_logits, reg, refs[1]).items()}
        for j, batch in enumerate(real):
            jtest.postprocess_batch({k: v[j * batch_size:(j + 1) * batch_size]
                                     for k, v in out.items()}, batch, dataset, method, det)
    return det


@pytest.mark.parametrize("method, fg_bias", [("top", 1.5), ("nms", 1.5), ("nms", 300.0)],
                         ids=["top", "nms", "nms-every-section"])
def test_detections_equal_the_grouped_full_decode_bit_for_bit(kitti_val, method, fg_bias):
    """float64, batches of 5 in groups of 2 with a partial last group, 70
    sections a frustum (strides 0.5-4 to 70 m); the cls head 30 times as
    decisive, so 'nms' keeps several sections in some frustums and none in
    others (``fg_bias`` 300: every section of every frustum)."""
    cfg = tconfigs.get_default_cfg()
    tconfigs.merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    tconfigs.merge_cfg_from_list(TINY_OVERRIDES + [
        "DATA.DATA_ROOT", kitti_val["pickle_dir"], "DATA.MAX_DEPTH", "70",
        "DATA.STRIDE", "(0.5, 1.0, 2.0, 4.0)", "DATA.HEIGHT_HALF", "(0.5, 1.0, 2.0, 4.0)"],
        cfg)
    spec = tconfigs.get_model_spec(cfg)
    assert spec.num_out == 70
    dataset = TFrustumProvider(cfg, "val", one_hot=True, from_rgb_detection=True)
    batch_size, group = 5, 2
    n_batches = -(-len(dataset) // batch_size)
    assert n_batches % group and len(dataset) % batch_size  # a padded tail
    model = FrustumConvNet(spec)
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.cls_out.weight.mul_(30.0)
        model.cls_out.bias.copy_(torch.tensor([-fg_bias, fg_bias]))
    model = model.double().eval()
    logger = logging.getLogger("torch_grouped_full_decode")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False

    got, stats = ttest.run_test(model, spec, dataset, batch_size, method, logger,
                                num_workers=1, group=group, inflight=2,
                                points_dtype=torch.float16)
    want = _grouped_full_decode(model, spec, dataset, method, batch_size, group)
    assert list(got) == list(want)
    for img, by_cls in want.items():
        assert list(got[img]) == list(by_cls), img
        for cls, rows in by_cls.items():
            g, w = np.asarray(got[img][cls], np.float64), np.asarray(rows, np.float64)
            assert g.shape == w.shape and np.array_equal(g, w), (img, cls)
    assert stats["detections"] == sum(len(r) for c in want.values() for r in c.values()) > 0
    assert stats["overflow_reruns"] == 0 and stats["frustums"] == len(dataset)
    if method == "nms":
        assert stats["sections"] > stats["frustums"]  # more than the argmax fallback
    if fg_bias > 10:  # every section comes back
        assert stats["sections"] == stats["frustums"] * spec.num_out


@pytest.mark.parametrize("difficulty_mix,flagship", [(False, False), (True, False), (True, True)],
                         ids=["v1", "mix", "mix-flagship"])
def test_float64_serving_writes_byte_identical_files(tmp_path, difficulty_mix, flagship):
    """The float64 witness: each package's grouped inference in float64 (JAX
    under ``jax.enable_x64``) on the same weights, on the path that takes the
    provider's ladders (no device rebuild, which XLA contracts into FMAs),
    then each package's host postprocess (``postprocess_packed``) and KITTI
    writer with the driver's NMS threshold: the result files are equal byte
    for byte, at the tiny width and at the protocol's. Both infer functions
    cast the points to float32 first, as the provider already stores them,
    so the first layer sees the same inputs. JAX's cap is every section, so
    no batch of its overflows to its full path."""
    val = _kitti_val(tmp_path, difficulty_mix=difficulty_mix)
    cfg = get_default_cfg()
    merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    merge_cfg_from_list((["TEST.BATCH_SIZE", "8"] if flagship else TINY_OVERRIDES)
                        + ["DATA.DATA_ROOT", val["pickle_dir"]], cfg)
    spec = get_model_spec(cfg)
    assert (spec.num_points, spec.num_out) == ((1024, 140) if flagship else (128, 24))
    dataset = FrustumProvider(cfg, "val", one_hot=True, from_rgb_detection=True)
    batches = list(BatchLoader(dataset, 5, spec.num_scales, shuffle=False,
                               drop_last=False, pad_last=True, seed=0).epoch(0))
    assert batches[0]["point_cloud"].dtype == np.float32
    cap = spec.num_out
    state = _state(graft._flagship(tiny=True)[2].clone(spec=spec), spec)

    with jax.enable_x64():
        f64 = lambda x: jnp.asarray(x, jnp.float64)
        jfn = jtest.build_infer_group_fn(JaxNet(spec, dtype=jnp.float64), spec,
                                         "nms", cap)
        params = jax.tree_util.tree_map(f64, state.params)
        stats = jax.tree_util.tree_map(f64, state.batch_stats)
        jax_out = [jax.device_get(jfn(params, stats, jnp.asarray(b["point_cloud"][None]),
                                      jnp.asarray(b["one_hot"][None]),
                                      tuple(jnp.asarray(r[None]) for r in b["refs"])))
                   for b in batches]
    net = _port_model(spec, state).double()
    tfn = ttest.build_infer_group_fn(net, spec, "nms")
    port_out = [tuple(t.numpy() for t in tfn(
        torch.from_numpy(b["point_cloud"][None]), torch.from_numpy(b["one_hot"][None]),
        tuple(torch.from_numpy(r[None]) for r in b["refs"]))) for b in batches]

    def jax_post(*args):
        n, overflow = jtest.postprocess_packed(*args, cap)
        assert not overflow
        return n

    with open(os.path.join(val["kitti_root"], "image_sets", "val.txt")) as f:
        ids = [int(line) for line in f if line.strip()]
    dirs = []
    for name, outs, post, write in (
            ("jax", jax_out, jax_post, write_detection_results),
            ("port", port_out, ttest.postprocess_packed, port_write_detection_results)):
        det, n_dets = {}, 0
        for (packed, cnt), b in zip(outs, batches):
            assert packed.dtype == np.float64, name
            n_dets += post(packed[0], cnt[0], b, dataset, det)
        assert n_dets > 0, name
        dirs.append(write(str(tmp_path / name), det, ids, nms_threshold=cfg.TEST.THRESH))
    files = sorted(os.listdir(dirs[0]))
    assert files == sorted(os.listdir(dirs[1])) and len(files) == len(ids)
    n_lines = 0
    for fname in files:
        with open(os.path.join(dirs[0], fname), "rb") as a, \
                open(os.path.join(dirs[1], fname), "rb") as b:
            want, got = a.read(), b.read()
        assert got == want, fname
        n_lines += want.count(b"\n")
    assert n_lines > 0
