"""The fused PointNet eval epilogue (``ops/pointnet_epilogue``) and its
dispatch in ``models/net.py``.

On the card: both entry points bit for bit against their plain versions at
every (M, K, C) of the car, people and SUN-RGBD models at batch 256, with
empty sections, a NaN and non-trivial statistics; a whole eval forward of
the car and SUN-RGBD models at serving batch, the kernels against the plain
path, bit for bit; the launches a forward. This file imports no jax, so on a
machine with the card it runs alone:

    python -m pytest --noconftest -q tests/test_torch_pointnet_epilogue.py

On the CPU: the dispatch rule (the kernels only for float32 eval on a card
with grad off), a PointNet scale's plain eval path as the plain versions
chained, the model's wiring with the plain versions standing in for the
kernels, and the wrappers' refusals.
"""

import types

import pytest
import torch

from frustum_convnet_tpu_torch import graft_entry
from frustum_convnet_tpu_torch.data.fixtures import make_batch
from frustum_convnet_tpu_torch.models import net
from frustum_convnet_tpu_torch.models.net import DenseBNReLU, FrustumConvNet, PointNetScale
from frustum_convnet_tpu_torch.ops import pointnet_epilogue as epi
from frustum_convnet_tpu_torch.tools.profile_mlp import FAMILY_CFGS, eval_bn, family_scales

torch.set_num_threads(1)

# every (M, K, C) a PointNet layer of the serving cells' models gives
SHAPES = sorted({(m, k, c) for family in FAMILY_CFGS for m, k, mlp in family_scales(family)
                 for c in mlp})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, NaN at the same places, equal elsewhere. Filled, not
    indexed: a boolean index of a 4-D tensor first builds an (n, 4) int64
    index, 32 bytes an element, 47 GB at the largest shape here."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)))


def _inputs(b, m, k, c, device, seed=0):
    """y (B, M, K, C) with a NaN, cnt with empty sections (the NaN's among
    them once, and once not), and an eval BatchNorm with non-trivial
    statistics."""
    g = torch.Generator(device).manual_seed(seed)
    y = torch.randn((b, m, k, c), generator=g, device=device)
    y[0, 0, k - 1, 1] = float("nan")  # a served section
    y[-1, -1, 0, 0] = float("nan")  # an empty section
    cnt = torch.randint(0, 3, (b, m), generator=g, device=device, dtype=torch.int32)
    cnt[0, 0], cnt[-1, -1] = 1, 0
    return y, cnt, eval_bn(c, g, device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=[f"M{m}-K{k}-C{c}" for m, k, c in SHAPES])
def test_kernels_match_plain_at_the_cells_shapes(cuda, shape):
    y, cnt, bn = _inputs(256, *shape, cuda)
    want = epi.bn_relu_plain(y, bn)
    pooled = epi.bn_relu_mask_maxpool_plain(y, cnt, bn)
    got_pooled = epi.bn_relu_mask_maxpool_cuda(y, cnt, bn)
    got = epi.bn_relu_cuda_(y, bn)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr()  # in place
    assert _same(got, want)
    assert _same(got_pooled, pooled)
    assert torch.isnan(pooled[0, 0, 1]) and pooled[-1, -1].eq(0).all()


def _stats(model: FrustumConvNet, seed: int) -> FrustumConvNet:
    """Non-trivial BatchNorm parameters and running statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                c = mod.num_features
                mod.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
                mod.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.1)
                mod.weight.copy_(1 + torch.randn(c, generator=g) * 0.2)
                mod.bias.copy_(torch.randn(c, generator=g) * 0.2)
    return model


def _model_and_batch(family: str, batch: int, tiny: bool):
    if family == "car":
        _cfg, spec, model = graft_entry._flagship(tiny=tiny)
    else:
        _cfg, spec, model = graft_entry._spec_for("det_sample_sunrgbd", tiny=tiny)
    model.reset_parameters(torch.Generator().manual_seed(3))
    return spec, _stats(model, 5).eval(), make_batch(spec, batch=batch, seed=0,
                                                     with_labels=False)


def _forward(model, batch, device):
    pts = torch.from_numpy(batch["point_cloud"]).to(device)
    one_hot = torch.from_numpy(batch["one_hot"]).to(device)
    refs = [torch.from_numpy(r).to(device) for r in batch["refs"]]
    with torch.inference_mode():
        return model(pts, one_hot, refs)


def _reset():
    epi.bn_relu_cuda_.launches = epi.bn_relu_mask_maxpool_cuda.launches = 0


def _launches():
    return epi.bn_relu_cuda_.launches, epi.bn_relu_mask_maxpool_cuda.launches


def _per_forward(spec):
    return sum(len(m) - 1 for m in spec.mlps), spec.num_scales


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["car", "sunrgbd"])
def test_eval_forward_on_the_card_is_bit_identical(cuda, family, monkeypatch):
    spec, model, batch = _model_and_batch(family, 256, tiny=False)
    model.to(cuda)
    _reset()
    fused = _forward(model, batch, cuda)
    torch.cuda.synchronize()
    assert _launches() == _per_forward(spec)  # car: 8 and 4; SUN-RGBD: 10 and 5
    monkeypatch.setattr(DenseBNReLU, "fuses", lambda self, x: False)
    plain = _forward(model, batch, cuda)
    assert _launches() == _per_forward(spec)
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


def _cuda_like():
    """What ``DenseBNReLU.fuses`` reads of its input, on a card."""
    return types.SimpleNamespace(device=torch.device("cuda"))


def test_dispatch_takes_the_kernels_only_for_float32_eval_on_a_card_without_grad():
    layer = DenseBNReLU(8, 16).eval()
    with torch.no_grad():
        assert layer.fuses(_cuda_like())
        assert not layer.fuses(torch.zeros(2, 8))  # the CPU
        layer.train()
        assert not layer.fuses(_cuda_like())  # training
        layer.eval()
        for dtype in (torch.float16, torch.bfloat16, torch.float64):
            layer.dtype = dtype
            assert not layer.fuses(_cuda_like())
        layer.dtype = None
        assert not layer.double().fuses(_cuda_like())  # a float64 model
        layer.float()
        assert layer.fuses(_cuda_like())
    assert not layer.fuses(_cuda_like())  # eval with grad on
    with torch.inference_mode():
        assert layer.fuses(_cuda_like())
    with pytest.raises(ValueError, match="only where the epilogue fuses"):
        layer(torch.zeros(1, 2, 3, 8), cnt=torch.ones(1, 2, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_versions_are_the_models_eval_sequence(dtype):
    """A PointNet scale's plain eval path (the CPU's) is, bit for bit, its
    GEMMs chained with ``bn_relu_plain`` and, after the last,
    ``bn_relu_mask_maxpool_plain``: what the kernels stand in for."""
    scale = PointNetScale(3, (16, 16, 32), 0.5, 4, False)
    g = torch.Generator().manual_seed(2)
    for layer in scale.children():
        layer[1].load_state_dict(eval_bn(layer[1].num_features, g, "cpu").state_dict())
    scale.to(dtype).eval()
    x, cnt, _ = _inputs(3, 5, 4, 3, torch.device("cpu"), seed=1)
    x = x.to(dtype)
    *layers, last = scale.children()
    with torch.no_grad():
        want = scale._mlp_pool(x, cnt, True)
        h = x
        for layer in layers:
            h = epi.bn_relu_plain(net._dense(h, layer[0].weight[..., 0, 0], None), layer[1])
        got = epi.bn_relu_mask_maxpool_plain(net._dense(h, last[0].weight[..., 0, 0], None),
                                             cnt, last[1])
    assert _same(got, want)
    assert got[-1, -1].eq(0).all() and torch.isnan(got[0, 0]).all()


def _plain_in_place(y, bn):
    epi.bn_relu_cuda_.launches += 1
    return y.copy_(epi.bn_relu_plain(y, bn))


def _plain_pool(y, cnt, bn):
    epi.bn_relu_mask_maxpool_cuda.launches += 1
    return epi.bn_relu_mask_maxpool_plain(y, cnt, bn)


@pytest.mark.parametrize("family", ["car", "sunrgbd"])
def test_fused_wiring_gives_the_plain_forward(family, monkeypatch):
    """The model's fused branch, with the plain versions standing in for the
    kernels on the CPU: the eval forward is bit for bit the plain one, and a
    forward launches one epilogue a PointNet layer (car 8 and 4)."""
    spec, model, batch = _model_and_batch(family, 2, tiny=True)
    cpu = torch.device("cpu")
    _reset()
    want = _forward(model, batch, cpu)
    assert _launches() == (0, 0)  # the CPU takes the plain path
    monkeypatch.setattr(DenseBNReLU, "fuses", lambda self, x: not self[1].training)
    monkeypatch.setattr(epi, "bn_relu_cuda_", _plain_in_place)
    monkeypatch.setattr(epi, "bn_relu_mask_maxpool_cuda", _plain_pool)
    _reset()
    got = _forward(model, batch, cpu)
    assert _launches() == _per_forward(spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    y, cnt, bn = _inputs(1, 2, 3, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA device"):
        epi.bn_relu_cuda_(y, bn)
    with pytest.raises(ValueError, match="CUDA device"):
        epi.bn_relu_mask_maxpool_cuda(y, cnt, bn)
