"""The serving pipeline's parts that keep the host from waiting for the card.

* The size table of ``models.det._mean_sizes`` is made once per device,
  dtype and ``spec.mean_sizes``: ``decode_outputs`` and ``compute_losses``
  (losses, metrics and the gradient of the network outputs) agree bit for
  bit with a table made on every call, in float32 and float64; a table
  first made inside ``torch.inference_mode()`` (a serving call) still
  serves a training loss's backward; two dtypes or two size templates get
  tables of their own.
* On a card, a ``run_test`` call after a warm one runs under
  ``torch.cuda.set_sync_debug_mode("error")``: nothing in it waits for the
  card but the fetches' events, and it serves what the warm call served.

This file imports no jax, so on a machine with the card it runs alone:

    python -m pytest --noconftest -q tests/test_torch_serve_pipeline.py

Here, without a card, the card's test skips.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import chip_smoke
from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.engine import test as serve
from frustum_convnet_tpu_torch.engine import train as trainer
from frustum_convnet_tpu_torch.models import det

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "det_sample.yaml")
TINY = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
        "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)",
        "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)"]
WEIGHTS = {"box": 1.0, "corner": 10.0, "head_res": 20.0, "size_res": 20.0}
DTYPES = [torch.float32, torch.float64]
SERVE_BATCH, GROUP, VAL = 4, 2, 16  # 2 groups, no tail batch


def _cfg():
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(CFG, cfg)
    configs.merge_cfg_from_list(TINY, cfg)
    return cfg


@pytest.fixture(scope="module")
def spec():
    return configs.get_model_spec(_cfg())


@pytest.fixture
def fresh_tables(monkeypatch):
    """An empty table cache for the test."""
    tables: dict = {}
    monkeypatch.setattr(det, "_SIZE_TABLES", tables)
    return tables


def _per_call_table(spec, reg):
    """The table as it was made before the cache: anew on every call."""
    return torch.as_tensor(np.asarray(spec.mean_sizes, np.float64),
                           dtype=torch.promote_types(reg.dtype, torch.float32),
                           device=reg.device)


def _outputs(spec, dtype, seed=7, b=3):
    """Seeded network outputs and labels: ignore labels, and one frustum
    without foreground."""
    g = torch.Generator().manual_seed(seed)
    length = spec.num_out
    cls_logits = torch.randn(b, length, 2, generator=g, dtype=dtype)
    reg = 0.3 * torch.randn(b, length, spec.reg_size, generator=g, dtype=dtype)
    ref2 = torch.rand(b, length, 3, generator=g, dtype=dtype) * 20.0
    cls_label = torch.randint(-1, 2, (b, length), generator=g)
    cls_label[0] = 0
    sizes = torch.as_tensor(np.asarray(spec.mean_sizes), dtype=dtype)
    size_class = torch.randint(0, spec.num_sizes, (b,), generator=g)
    labels = {"cls_label": cls_label,
              "box3d_center": torch.randn(b, 3, generator=g, dtype=dtype) * 5.0,
              "box3d_heading": (torch.rand(b, generator=g, dtype=dtype) - 0.5) * 6.0,
              "box3d_size": sizes[size_class] * (0.9 + 0.2 * torch.rand(b, 3, generator=g,
                                                                       dtype=dtype)),
              "size_class": size_class.to(torch.int32)}
    return cls_logits, reg, ref2, labels


def _losses_and_grad(spec, dtype):
    cls_logits, reg, ref2, labels = _outputs(spec, dtype)
    reg.requires_grad_(True)
    losses, metrics = det.compute_losses(spec, cls_logits, reg, ref2, labels, WEIGHTS)
    losses["total_loss"].backward()
    return {**losses, **metrics, "reg_grad": reg.grad}


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_with_the_kept_table_matches_a_table_per_call(spec, fresh_tables, monkeypatch,
                                                             dtype):
    cls_logits, reg, ref2, _ = _outputs(spec, dtype)
    got = det.decode_outputs(spec, cls_logits, reg, ref2)
    again = det.decode_outputs(spec, cls_logits, reg, ref2)
    assert len(fresh_tables) == 1
    monkeypatch.setattr(det, "_mean_sizes", _per_call_table)
    want = det.decode_outputs(spec, cls_logits, reg, ref2)
    _assert_same(got, want)
    _assert_same(again, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_losses_with_the_kept_table_match_a_table_per_call(spec, fresh_tables, monkeypatch,
                                                           dtype):
    got = _losses_and_grad(spec, dtype)
    again = _losses_and_grad(spec, dtype)
    assert len(fresh_tables) == 1
    monkeypatch.setattr(det, "_mean_sizes", _per_call_table)
    want = _losses_and_grad(spec, dtype)
    _assert_same(got, want)
    _assert_same(again, want)


def test_a_table_made_in_inference_mode_serves_a_backward(spec, fresh_tables):
    cls_logits, reg, ref2, labels = _outputs(spec, torch.float32)
    with torch.inference_mode():
        det.decode_outputs(spec, cls_logits, reg, ref2)
    (table,) = fresh_tables.values()
    assert not table.is_inference() and not table.requires_grad
    reg.requires_grad_(True)
    losses, _ = det.compute_losses(spec, cls_logits, reg, ref2, labels, WEIGHTS)
    losses["total_loss"].backward()
    assert torch.isfinite(reg.grad).all() and reg.grad.abs().sum() > 0
    assert det._mean_sizes(spec, reg) is table


def test_dtypes_and_size_templates_get_tables_of_their_own(spec, fresh_tables):
    other = dataclasses.replace(spec, mean_sizes=tuple(
        tuple(2.0 * v for v in row) for row in spec.mean_sizes))
    tables = {(s.mean_sizes, dtype): det._mean_sizes(s, torch.zeros(1, dtype=dtype))
              for s in (spec, other) for dtype in DTYPES}
    assert len(fresh_tables) == 4
    for (sizes, dtype), table in tables.items():
        assert table.dtype == dtype
        assert torch.equal(table, torch.as_tensor(np.asarray(sizes, np.float64), dtype=dtype))
    # below float32 a table is float32: one entry serves both
    half = det._mean_sizes(spec, torch.zeros(1, dtype=torch.float16))
    assert half is tables[(spec.mean_sizes, torch.float32)] and len(fresh_tables) == 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned uploads, the events and kernel 1 "
                    "run on a card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_group_loop_waits_for_the_card_only_at_the_fetches(cuda, tmp_path):
    cfg = _cfg()
    spec = configs.get_model_spec(cfg)
    chip_smoke.make_train_split(str(tmp_path), spec, num_train=SERVE_BATCH, num_val=VAL)
    configs.merge_cfg_from_list(["DATA.DATA_ROOT", str(tmp_path)], cfg)
    _, val_ds = trainer.make_datasets(cfg)
    model = trainer.FrustumConvNet(spec)
    model.reset_parameters(torch.Generator().manual_seed(3))
    model.to(cuda)
    logger = logging.getLogger("test_torch_serve_pipeline")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False

    def call():
        return serve.run_test(model, spec, val_ds, SERVE_BATCH, "nms", logger,
                              num_workers=1, group=GROUP, inflight=2,
                              points_dtype=torch.float16)

    warm, _ = call()  # builds kernel 1, its plans, the size table and the pinned pool
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        served, stats = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    groups = VAL // (SERVE_BATCH * GROUP)
    assert stats["spans"]["serve.fetch"]["n"] == groups
    assert "serve.full_path" not in stats["spans"]
    assert 0 <= stats["fetch_waited"] <= groups
    assert served == warm and served
