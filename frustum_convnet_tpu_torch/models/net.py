"""FrustumConvNet in PyTorch: multi-scale PointNet + 1D FCN + heads.

Counterpart of ``frustum_convnet_tpu/models/net.py`` (``FrustumConvNet``,
``PointNetScale``, ``DenseBNReLU``, ``ConvBNReLU``, ``DeConvBNReLU``,
``slice_reg_output``). Parameters are named in the reference state-dict
layout that ``tools/export_reference_checkpoint.map_to_torch`` emits, so a
reference ``.pth`` loads with ``load_state_dict(strict=True)``:

* ``feat_net.pointnet{n}.conv{j}.{0,1}``: 1x1 Conv2d weight (O, I, 1, 1),
  applied channels-last with ``F.linear``, and its BatchNorm;
* ``conv_net.block{b}_{conv1,conv2,merge,deconv}.{0,1}``: Conv1d /
  ConvTranspose1d and BatchNorm;
* ``cls_out`` and ``reg_out``: (O, C, 1) heads with bias.

The public tensors keep the JAX layout: points (B, N, C), refs (B, M_i, 3),
outputs (B, L, 2) and (B, L, R). The model follows ``module.train()`` and
``.eval()`` as the JAX model follows its ``train`` argument:

* eval: BatchNorm normalizes with its running statistics, in the JAX
  package's operation order, and the slot pool is a plain max;
* train: BatchNorm normalizes with the biased batch variance and updates
  the running variance with the Bessel-corrected one over
  ``n = numel // C`` values, momentum 0.1 (flax's 0.9): ``TorchBN``,
  ``net.py:155-195``, written out rather than ``F.batch_norm`` (see
  ``_bn``). The slot pool routes the gradient to the first tied slot
  (``slot_max_pool``, ``net.py:109-131``).

GhostBN, FAST_BN, REMAT_POINTNET and half precision are not ported
(``configs.check_train_supported`` raises on them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from frustum_convnet_tpu_torch.models.spec import DetModelSpec
from frustum_convnet_tpu_torch.ops.select_cuda import (group_depth_point_auto,
                                                       group_depth_point_multi_auto)


def _bn(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d, dim: int):
    """BatchNorm over channel axis ``dim`` (1 or -1), in ``bn``'s mode, with
    the JAX package's operation order (``TorchBN``, ``net.py:178-195``):
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    Eval normalizes with the running statistics. Train normalizes with the
    batch mean and biased variance (``torch.var_mean``) and updates the
    running statistics in place: ``r = (1 - momentum) * r + momentum * s``,
    with the variance Bessel-corrected over ``n = numel // C`` values. The
    CPU's fused ``F.batch_norm`` backward loses up to ~10% of a float32
    gradient leaf at flagship width against float64; this form stays
    within ~1e-3.
    """
    shape = [1] * x.dim()
    shape[dim] = -1
    if bn.training:
        axes = [d for d in range(x.dim()) if d != dim % x.dim()]
        var, mean = torch.var_mean(x, dim=axes, correction=0)
        with torch.no_grad():
            n = x.numel() // x.shape[dim]
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(m * mean)
            bn.running_var.mul_(1.0 - m).add_(m * (var * (n / max(n - 1, 1))))
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = torch.reciprocal(torch.sqrt(var + bn.eps)) * bn.weight
    return (x - mean.view(shape)) * inv.view(shape) + bn.bias.view(shape)


def slot_max_pool(x: torch.Tensor, train: bool) -> torch.Tensor:
    """Max over the slot axis, (B, M, K, C) -> (B, M, C). In train mode the
    gradient goes to the FIRST slot attaining the max (``argmax`` then
    ``gather``, whose backward scatters to exactly that slot), as the JAX
    ``slot_max_pool`` and the reference's ``Tensor.max(dim)`` route it;
    ``amax`` would split it across tied slots, and the first-hit fill makes
    ties common in sparse sections."""
    if train:
        first = torch.argmax(x, dim=2, keepdim=True)
        return torch.gather(x, 2, first).squeeze(2)
    return x.amax(dim=2)


class DenseBNReLU(nn.Sequential):
    """1x1 conv + BN + ReLU on channels-last (..., C): the (O, I, 1, 1)
    weight is applied with ``F.linear``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x):
        conv, bn = self[0], self[1]
        y = F.linear(x, conv.weight.view(conv.out_channels, conv.in_channels))
        return F.relu(_bn(y, bn, -1))


class ConvBNReLU(nn.Sequential):
    """k-tap 1D conv + BN + ReLU over channels-first (B, C, L)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, pad: int):
        super().__init__(nn.Conv1d(cin, cout, kernel, stride, pad, bias=False),
                         nn.BatchNorm1d(cout, eps=1e-5))

    def forward(self, x):
        return F.relu(_bn(self[0](x), self[1], 1))


class DeConvBNReLU(nn.Sequential):
    """Transposed 1D conv (exact x``stride`` upsampler) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__(nn.ConvTranspose1d(cin, cout, kernel, kernel, bias=False),
                         nn.BatchNorm1d(cout, eps=1e-5))

    def forward(self, x):
        return F.relu(_bn(self[0](x), self[1], 1))


class PointNetScale(nn.Module):
    """One grouping scale: depth-window grouping -> shared MLP -> slot pool.

    ``forward(points, ref, grouped=None)``: with ``grouped=None`` the scale
    groups for itself (``net.py:428-430``): ``points`` or its xyz, by
    ``use_feature``, through ``group_depth_point_auto`` with this scale's
    ``dist`` and ``nsample``. ``FrustumConvNet`` passes the (grouped, cnt)
    of its one multi-scale launch instead. The zero mask for sections with
    no hit comes after the MLP and before the pool (``net.py:438-440``), so
    their index-0 duplicates still enter the BatchNorm statistics.
    """

    def __init__(self, cin: int, mlp, dist: float, nsample: int,
                 use_feature: bool):
        super().__init__()
        self.dist, self.nsample, self.use_feature = dist, nsample, use_feature
        for j, width in enumerate(mlp):
            self.add_module(f"conv{j + 1}", DenseBNReLU(cin, width))
            cin = width

    def forward(self, points, ref, grouped=None):
        if grouped is None:
            feats = points if self.use_feature else points[..., :3].contiguous()
            grouped = group_depth_point_auto(feats, ref, self.dist, self.nsample)
        g, cnt = grouped
        for layer in self.children():
            g = layer(g)
        g = g.masked_fill((cnt == 0)[..., None, None], 0.0)
        return slot_max_pool(g, self.training)  # (B, M, mlp[-1])


class FrustumConvNet(nn.Module):
    """The full detector. Returns (cls_logits (B, L, 2), reg (B, L, R))."""

    def __init__(self, spec: DetModelSpec):
        super().__init__()
        self.spec = s = spec
        pn_in = 3 + (s.extra_feat_dim if s.use_extra_feature else 0)
        self.feat_net = nn.Module()
        for i in range(s.num_scales):
            self.feat_net.add_module(
                f"pointnet{i + 1}",
                PointNetScale(pn_in, s.mlps[i], s.height_half[i],
                              s.nsamples[i], s.use_extra_feature))
        scale_ch = [m[-1] + s.num_vec for m in s.mlps]
        ch = s.block_channels
        self.conv_net = nn.Module()
        add = self.conv_net.add_module
        add("block1_conv1", ConvBNReLU(scale_ch[0], ch[0], 3, 1, 1))
        for b in range(1, len(ch)):
            add(f"block{b + 1}_conv1", ConvBNReLU(ch[b - 1], ch[b], 3, 2, 1))
            add(f"block{b + 1}_conv2", ConvBNReLU(ch[b], ch[b], 3, 1, 1))
            add(f"block{b + 1}_merge",
                ConvBNReLU(ch[b] + scale_ch[b], ch[b], 1, 1, 0))
        for b in range(1, len(ch)):
            add(f"block{b + 1}_deconv",
                DeConvBNReLU(ch[b], s.deconv_channels, 2 ** (b - 1)))
        self.cls_out = nn.Conv1d(s.head_channels, s.num_classes, 1)
        self.reg_out = nn.Conv1d(s.head_channels, s.reg_size, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers (``net.py:34-35``) drawn from
        ``generator``: kaiming-normal(fan_in) conv weights, unit/zero BN,
        kaiming-uniform(fan_in) heads with zero bias; identity running
        statistics."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                w = mod.weight
                if isinstance(mod, nn.ConvTranspose1d):
                    fan_in = w.shape[0] * w.shape[2]  # (I, O, k)
                else:
                    fan_in = w[0].numel()  # (O, I, k...)
                if mod.bias is None:
                    w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                else:
                    bound = math.sqrt(6.0 / fan_in)
                    w.uniform_(-bound, bound, generator=generator)
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                mod.reset_parameters()

    def forward(self, points, one_hot, refs):
        """
        Args:
          points: (B, N, 3 + extra) frustum points, channels-last.
          one_hot: (B, num_vec) category one-hot.
          refs: list of (B, M_i, 3) section centers, one per scale.
        """
        s = self.spec
        if len(refs) != s.num_scales:
            raise ValueError(f"{len(refs)} ladders for {s.num_scales} scales")
        feats = points if s.use_extra_feature else points[..., :3].contiguous()
        groups = group_depth_point_multi_auto(
            feats, list(refs), list(s.height_half), list(s.nsamples))

        scale_feats = []  # channels-first (B, C_i + num_vec, M_i)
        for i, grouped in enumerate(groups):
            f = getattr(self.feat_net, f"pointnet{i + 1}")(points, refs[i],
                                                            grouped)
            oh = one_hot.to(f.dtype)[:, None, :].expand(-1, f.shape[1], -1)
            scale_feats.append(torch.cat([f, oh], dim=-1).transpose(1, 2))

        net = self.conv_net
        ch = s.block_channels
        x = net.block1_conv1(scale_feats[0])
        laterals = []
        for b in range(1, len(ch)):
            x = getattr(net, f"block{b + 1}_conv1")(x)
            x = getattr(net, f"block{b + 1}_conv2")(x)
            x = torch.cat([x, scale_feats[b]], dim=1)
            x = getattr(net, f"block{b + 1}_merge")(x)
            laterals.append(x)

        out_len = laterals[0].shape[2]
        ups = [getattr(net, f"block{b + 2}_deconv")(lat)[:, :, :out_len]
               for b, lat in enumerate(laterals)]
        x = torch.cat(ups, dim=1).transpose(1, 2)  # (B, L, head_channels)

        cls_logits = F.linear(x, self.cls_out.weight[:, :, 0], self.cls_out.bias)
        reg = F.linear(x, self.reg_out.weight[:, :, 0], self.reg_out.bias)
        return cls_logits, reg


def slice_reg_output(reg: torch.Tensor, spec: DetModelSpec):
    """Split the regression output into its box-codec parts.

    reg (..., 3 + 2*num_bins + 4*num_sizes) ->
      center (..., 3), heading_scores (..., B), heading_res (..., B),
      size_scores (..., S), size_res (..., S, 3).
    """
    nb, ns = spec.num_bins, spec.num_sizes
    center = reg[..., 0:3]
    heading_scores = reg[..., 3:3 + nb]
    heading_res = reg[..., 3 + nb:3 + 2 * nb]
    size_scores = reg[..., 3 + 2 * nb:3 + 2 * nb + ns]
    size_res = reg[..., 3 + 2 * nb + ns:].reshape(*reg.shape[:-1], ns, 3)
    return center, heading_scores, heading_res, size_scores, size_res
