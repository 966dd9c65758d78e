"""``run_test_sunrgbd`` on the group pipeline it shares with ``run_test``.

Tiny synthetic SUN-RGBD scenes through the port's own prep and provider, at
the 5-scale model's widths with a short ladder (MAX_DEPTH 4: 40/20/10/5/3
sections, K 128/128/256/256/256, N=256), 16 frustums in batches of 7
(the last padded) and groups of 2, so the tail group is padded too:

* in float64, the driver's detections equal, bit for bit, those of the
  per-frustum loop it replaced (written out here: the full decode of every
  section brought back, the selection and the label conversion frustum by
  frustum), for 'top' and 'nms', and for 'nms' with a cls head that keeps
  every section of every frustum, which all come back;
* its stats and spans: one ``serve.upload``, ``serve.dispatch`` and
  ``serve.fetch`` a group, one ``serve.postprocess`` a batch,
  ``fetch_waited`` 0 off a card, sections = detections + degenerate;
* the port's forward and decode against the benchmark's plain reference
  (``bench_h100/reference/model.py``) on its seeded weights: float32 and
  float64;
* on a card, a call after a warm one runs under
  ``torch.cuda.set_sync_debug_mode("error")`` and serves what the warm call
  served.

This file imports no jax, so on a machine with the card it runs alone:

    python -m pytest --noconftest -q tests/test_torch_sunrgbd_pipeline.py

Here, without a card, the card's test skips.
"""

import logging
import os

import numpy as np
import pytest
import torch

from bench_h100.reference import model as ref_model
from bench_h100.reference.spec import ModelSpec
from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.data.provider_sunrgbd import (FrustumSunrgbdProvider,
                                                            from_prediction_to_label_format)
from frustum_convnet_tpu_torch.data.sunrgbd import prepare as sun_prepare
from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd
from frustum_convnet_tpu_torch.engine import test_sunrgbd as tsun
from frustum_convnet_tpu_torch.engine.loader import BatchLoader
from frustum_convnet_tpu_torch.models.det import decode_outputs
from frustum_convnet_tpu_torch.models.net import FrustumConvNet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "det_sample_sunrgbd.yaml")
TINY = ["DATA.NUM_SAMPLES", "256", "DATA.MAX_DEPTH", "4", "TEST.BATCH_SIZE", "7",
        "NUM_WORKERS", "1"]
BATCH, GROUP = 7, 2
# float32 against the reference: both compute in float32 with TF32 off, in
# other orders of summation (GEMMs against per-slot matmuls, cuDNN or MKL
# against conv1d, a folded BatchNorm against its formula) through 5 PointNet
# scales and a 5-block trunk with 1024 head channels; on these inputs the
# outputs (logits and regression of order 1-10) differ by at most 4.3e-6, so
# 1e-4 leaves over 20 times that, and a wrong weight or section moves them
# by far more
F32_TOL = dict(rtol=1e-4, atol=1e-4)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
LOGGER = logging.getLogger("test_torch_sunrgbd_pipeline")
LOGGER.addHandler(logging.NullHandler())
LOGGER.propagate = False


@pytest.fixture(scope="module")
def sun(tmp_path_factory):
    """8 synthetic frames of 2 objects through the port's prep: their
    rgb-detection frustums, the provider over them, the config and spec."""
    root = tmp_path_factory.mktemp("sunrgbd_pipeline")
    raw = str(root / "mysunrgbd")
    make_synthetic_sunrgbd(raw, num_frames=8, objects_per_frame=2, seed=4)
    pickles = str(root / "pickles")
    sun_prepare.main(["--gen_val_rgb_detection", "--sunrgbd_dir", raw,
                      "--save_dir", pickles,
                      "--det_file", os.path.join(raw, "det_val.txt")])
    rgb_det = os.path.join(pickles, "sunrgbd_rgb_det_val.pickle")
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(CFG, cfg)
    configs.merge_cfg_from_list(TINY + ["DATA.DATA_ROOT", pickles,
                                        "OVER_WRITE_TEST_FILE", rgb_det], cfg)
    spec = configs.get_model_spec(cfg)
    dataset = FrustumSunrgbdProvider(cfg, "val", from_rgb_detection=True,
                                     overwritten_data_path=rgb_det)
    batches = -(-len(dataset) // BATCH)
    assert batches >= 3 and batches % GROUP and len(dataset) % BATCH  # padded tail
    return {"cfg": cfg, "spec": spec, "dataset": dataset, "batches": batches}


def _model(spec, dtype=torch.float64, device="cpu", fg_bias: float = 1.5):
    """The seeded init with a cls head 30 times as decisive, so that 'nms'
    selects several sections in some frustums and none in others (``fg_bias``
    300: every section of every frustum)."""
    model = FrustumConvNet(spec)
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.cls_out.weight.mul_(30.0)
        model.cls_out.bias.copy_(torch.tensor([-fg_bias, fg_bias]))
    return model.to(device=device, dtype=dtype).eval()


def per_frustum_loop(model, spec, dataset, method: str) -> dict:
    """The driver's serving as it was before the group pipeline: groups of
    whole batches (the tail padded by repeating its last), the full decode
    of every section brought back, then selection, score and label
    conversion frustum by frustum."""
    loader = BatchLoader(dataset, BATCH, spec.num_scales, shuffle=False, drop_last=False,
                         pad_last=True, seed=0, num_workers=1)
    batches = list(loader.epoch(0))
    det_results: dict = {}
    for lo in range(0, len(batches), GROUP):
        real = batches[lo:lo + GROUP]
        padded = real + [real[-1]] * (GROUP - len(real))
        with torch.inference_mode():
            pts = torch.from_numpy(np.stack([b["point_cloud"] for b in padded]))
            pts = pts.to(torch.float16).reshape(-1, *pts.shape[2:]).float()
            one_hot = torch.from_numpy(np.stack([b["one_hot"] for b in padded]))
            refs = [torch.from_numpy(np.stack([b["refs"][i] for b in padded]))
                    .reshape(-1, *padded[0]["refs"][i].shape[1:])
                    for i in range(spec.num_scales)]
            cls_logits, reg = model(pts, one_hot.reshape(-1, one_hot.shape[-1]), refs)
            out = {k: v.reshape(GROUP, BATCH, *v.shape[1:]).numpy()
                   for k, v in decode_outputs(spec, cls_logits, reg, refs[1]).items()}
        for j, batch in enumerate(real):
            rgb_probs = batch["rgb_prob"].reshape(-1)
            rot_angles = batch["rot_angle"].reshape(-1)
            for k, gi in enumerate(int(i) for i in batch["_indices"][:int(batch["_real"])]):
                probs = out["cls_probs"][j][k]
                fg_idx = np.nonzero(probs[:, 1] > 0.5)[0] if method == "nms" else []
                if len(fg_idx) == 0:
                    fg_idx = np.array([np.argmax(probs[:, 1])])
                scores = rgb_probs[k] + out["size_probs"][j][k][fg_idx].max(axis=1)
                box2d = np.asarray(dataset.data["box2d"][gi])
                per_cls = det_results.setdefault(int(dataset.data["id"][gi]), {}).setdefault(
                    dataset.data["type"][gi], [])
                for m, s in zip(fg_idx, scores):
                    tx, ty, tz, l, w, h, ry = from_prediction_to_label_format(
                        out["centers"][j][k][m], out["headings"][j][k][m],
                        out["sizes"][j][k][m], rot_angles[k])
                    if h < 0.01 or w < 0.01 or l < 0.01:
                        continue
                    per_cls.append([box2d[0], box2d[1], box2d[2], box2d[3],
                                    tx, ty, tz, l, w, h, ry, float(s)])
    return det_results


def _serve(model, sun, method, device="cpu", **kwargs):
    return tsun.run_test_sunrgbd(model, sun["spec"], sun["dataset"], BATCH, method, LOGGER,
                                 num_workers=1, group=GROUP, inflight=2,
                                 points_dtype=torch.float16, **kwargs)


def _assert_same_detections(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for img, by_cls in want.items():
        assert sorted(got[img]) == sorted(by_cls), img
        for cls, rows in by_cls.items():
            g, w = np.asarray(got[img][cls], np.float64), np.asarray(rows, np.float64)
            assert g.shape == w.shape and np.array_equal(g, w), (img, cls)


@pytest.mark.parametrize("method, fg_bias", [("top", 1.5), ("nms", 1.5), ("nms", 300.0)],
                         ids=["top", "nms", "nms-every-section"])
def test_detections_equal_the_per_frustum_loop_bit_for_bit(sun, method, fg_bias):
    model = _model(sun["spec"], fg_bias=fg_bias)
    got, stats = _serve(model, sun, method)
    want = per_frustum_loop(model, sun["spec"], sun["dataset"], method)
    _assert_same_detections(got, want)
    assert stats["detections"] == sum(len(r) for c in want.values() for r in c.values()) > 0
    if method == "nms":
        assert stats["sections"] > stats["frustums"]  # more than the argmax fallback
    if fg_bias > 10:  # the selection holds every section: none is left out
        assert stats["sections"] == stats["frustums"] * sun["spec"].num_out


@pytest.mark.parametrize("method", ["top", "nms"])
def test_spans_and_stats_count_the_groups_and_batches(sun, method):
    _, stats = _serve(_model(sun["spec"], torch.float32), sun, method)
    batches, spans = sun["batches"], stats["spans"]
    groups = -(-batches // GROUP)
    assert stats["frustums"] == len(sun["dataset"])
    assert stats["sections"] == stats["detections"] + stats["degenerate"]
    if method == "top":
        assert stats["sections"] == stats["frustums"]
    assert stats["fetch_waited"] == 0
    assert {k: v["n"] for k, v in spans.items()} == {
        "serve.call": 1, "serve.start": 1, "serve.loader_wait": batches + 1,
        "serve.upload": groups, "serve.dispatch": groups, "serve.fetch": groups,
        "serve.postprocess": batches}
    assert all(v["s"] >= 0 for v in spans.values())
    assert spans["serve.call"]["s"] >= sum(v["s"] for k, v in spans.items()
                                           if k != "serve.call")


def _reference_spec(spec) -> ModelSpec:
    return ModelSpec(**{f: getattr(spec, f) for f in ModelSpec.__dataclass_fields__})


@pytest.mark.parametrize("dtype, tol", [(torch.float32, F32_TOL), (torch.float64, F64_TOL)],
                         ids=["f32", "f64"])
def test_forward_and_decode_match_the_plain_reference(sun, dtype, tol):
    spec = sun["spec"]
    ref_spec = _reference_spec(spec)
    assert ref_spec.num_refs == (40, 20, 10, 5, 3) and ref_spec.head_channels == 1024
    params = ref_model.seeded_params(ref_spec, 2**31 + 17, torch.device("cpu"))
    model = FrustumConvNet(spec)
    state = model.state_dict()
    model.load_state_dict({k: params.get(k, state[k]) for k in state}, strict=True)
    model = model.to(dtype).eval()
    params = {k: v.to(dtype) for k, v in params.items()}
    items = [sun["dataset"].__getitem__(i, np.random.default_rng(i)) for i in range(5)]
    pts = torch.from_numpy(np.stack([it["point_cloud"] for it in items])).to(dtype)
    one_hot = torch.from_numpy(np.stack([it["one_hot"] for it in items])).to(dtype)
    refs = [torch.from_numpy(np.stack([it["refs"][i] for it in items])).to(dtype)
            for i in range(spec.num_scales)]
    with torch.no_grad():
        ref_model.strict_fp32()
        cls, reg, _ = ref_model.forward(params, ref_spec, pts, one_hot, refs)
        got_cls, got_reg = model(pts, one_hot, refs)
        got = decode_outputs(spec, got_cls, got_reg, refs[1])
    center_off, h_scores, h_res, s_scores, s_res = ref_model.split_reg(reg, ref_spec)
    mean_sizes = torch.tensor(ref_spec.mean_sizes, dtype=dtype)
    want = {"cls_probs": torch.softmax(cls, dim=-1), "centers": refs[1] + center_off,
            "headings": ref_model.heading_of(h_res, h_scores.argmax(dim=-1), ref_spec.num_bins),
            "sizes": ref_model.size_of(s_res, s_scores.argmax(dim=-1), mean_sizes),
            "size_probs": torch.softmax(s_scores, dim=-1)}
    for name, g, w in [("cls_logits", got_cls, cls), ("reg", got_reg, reg)] + [
            (k, got[k], v) for k, v in want.items()]:
        assert g.dtype == dtype and g.shape == w.shape and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned uploads, the events and kernel 1 "
                    "run on a card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_warm_call_waits_for_the_card_only_at_the_fetches(sun, cuda):
    model = _model(sun["spec"], torch.float32, cuda)
    warm, _ = _serve(model, sun, "top", cuda)  # builds kernel 1, the size table, the pool
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        served, stats = _serve(model, sun, "top", cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stats["spans"]["serve.fetch"]["n"] == -(-sun["batches"] // GROUP)
    assert "serve.full_path" not in stats["spans"]
    assert 0 <= stats["fetch_waited"] <= stats["spans"]["serve.fetch"]["n"]
    assert served == warm and served
