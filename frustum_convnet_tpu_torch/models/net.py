"""FrustumConvNet in PyTorch: multi-scale PointNet + 1D FCN + heads.

Counterpart of ``frustum_convnet_tpu/models/net.py`` (``FrustumConvNet``,
``PointNetScale``, ``DenseBNReLU``, ``ConvBNReLU``, ``DeConvBNReLU``,
``TorchBN``, ``GhostBN``, ``_StatsBN``, ``_f16_dense_dot``,
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
  package's operation order, and the slot pool is a plain max; in float32
  on a card with grad off, everything after each PointNet GEMM (BatchNorm,
  ReLU and, after a scale's last, the mask and the pool) is one CUDA pass
  of ``ops/pointnet_epilogue``, bit for bit the same;
* train: BatchNorm normalizes with the biased batch variance and updates
  the running variance with the Bessel-corrected one over
  ``n = numel // C`` values, momentum 0.1 (flax's 0.9): ``TorchBN``,
  ``net.py:155-195``, written out rather than ``F.batch_norm`` (see
  ``_bn``). The slot pool routes the gradient to the first tied slot
  (``slot_max_pool``, ``net.py:109-131``).

Precision, as Flax's ``dtype`` does it (explicit casts, no autocast):
parameters, BatchNorm statistics and optimizer state stay in their own dtype
(float32) in every mode. A Dense or conv casts its input and weight to the
compute dtype at the call; BatchNorm computes its statistics and the
normalize in ``promote(float32, dtype)`` and casts the result back; ReLU,
the empty-section mask and the pool run in the compute dtype; the trunk and
heads may run in their own dtype; the heads' outputs are at least float32.
Under float16 every PointNet Dense (and the heads, under a float16 trunk)
runs ``_F16DenseDot``, whose weight gradient is summed and stored in float32.

Train-mode variants (``cfg.TPU``): ghost BatchNorm over groups of the batch
(``BN_GROUP_SIZE``, every BatchNorm), analytic statistics from the layer
input (``FAST_BN``, ``FAST_BN_FIRST``, PointNet Denses only, not under
ghost BatchNorm) and rematerialized PointNet scales (``REMAT_POINTNET``).

Data parallelism: under a process group (``parallel.mesh``) every
train-mode BatchNorm statistic is the global batch's, as JAX computes it
under the mesh. Each rank takes its local mean and mean of squares (for
``FAST_BN``, the input's mean and second moment), and the ranks average
them with ``mesh.global_sum``, which carries the gradient back to every
rank's rows; the shards are equal, so the mean of the ranks' means is the
global mean. The variance is then ``clamp(mean2 - mean^2, 0)``, JAX's own
formula, and the running variance's Bessel count is the global one. Ghost
BatchNorm keeps its groups within a rank and averages the running
statistics over every rank's groups. Eval mode runs no collective.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from frustum_convnet_tpu_torch.models.spec import DetModelSpec
from frustum_convnet_tpu_torch.ops import pointnet_epilogue
from frustum_convnet_tpu_torch.parallel import mesh
from frustum_convnet_tpu_torch.ops.select_cuda import (group_depth_point_auto,
                                                       group_depth_point_multi_auto)


class _F16DenseDot(torch.autograd.Function):
    """``y = x @ w^T`` for float16 ``x`` and a float32 (O, I) weight ``w``,
    cast inside the op (``_f16_dense_dot``, ``net.py:58-83``).

    y and dx are float16. dW = g2^T x2 reduces over every batch row, where
    float16 overflows, so it is summed and stored in float32: the product
    of two float16 values is exact in float32, so upcasting both operands
    gives what ``preferred_element_type=float32`` gives."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.linear(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = g @ w.to(g.dtype)
        if ctx.needs_input_grad[1]:
            g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
            x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
            dw = g2.T @ x2
        return dx, dw


def _dense(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype | None,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """Channels-last ``x @ w^T (+ bias)`` in ``dtype`` (None: ``w``'s).
    float16 takes ``_F16DenseDot`` and keeps the bias float32, so the output
    is float32 there (``_f16_promote_bias``, ``net.py:93-100``)."""
    if dtype == torch.float16:
        y = _F16DenseDot.apply(x.to(dtype), w)
        return y if bias is None else y + bias
    dt = w.dtype if dtype is None else dtype
    return F.linear(x.to(dt), w.to(dt), None if bias is None else bias.to(dt))


def _update_running(bn, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
    """``r = (1 - momentum) * r + momentum * s`` with the variance
    Bessel-corrected over ``n`` values (``_bessel``, ``net.py:145-152``)."""
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(m * mean)
        bn.running_var.mul_(1.0 - m).add_(m * (var * (n / max(n - 1, 1))))


def _normalize(yt: torch.Tensor, bn, mean, var, shape) -> torch.Tensor:
    """``(y - mean) * (rsqrt(var + eps) * scale) + bias``, the JAX package's
    operation order, with the statistics reshaped to ``shape``."""
    inv = torch.reciprocal(torch.sqrt(var + bn.eps)) * bn.weight
    return (yt - mean.reshape(shape)) * inv.reshape(shape) + bn.bias.reshape(shape)


def _bn(y: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d, dim: int,
        group: int = 0, update: bool = True) -> torch.Tensor:
    """BatchNorm over channel axis ``dim`` (1 or -1), in ``bn``'s mode, with
    the JAX package's operation order (``TorchBN``, ``net.py:178-195``):
    ``(y - mean) * (rsqrt(var + eps) * scale) + bias`` in
    ``promote(float32, y.dtype)``, cast back to ``y``'s dtype.

    Eval normalizes with the running statistics. Train normalizes with the
    batch mean and biased variance (``torch.var_mean``) and, if ``update``,
    updates the running statistics in place over ``n = numel // C`` values.
    The CPU's fused ``F.batch_norm`` backward loses up to ~10% of a float32
    gradient leaf at flagship width against float64; this form stays
    within ~1e-3. With ``group`` > 0 in train mode it is ``GhostBN``
    (``_ghost_bn``).
    """
    if bn.training and group > 0:
        return _ghost_bn(y, bn, dim, group, update)
    yt = y.to(torch.promote_types(torch.float32, y.dtype))
    shape = [1] * y.dim()
    shape[dim] = -1
    if bn.training:
        axes = [d for d in range(y.dim()) if d != dim % y.dim()]
        n = y.numel() // y.shape[dim]
        if mesh.initialized():
            mean, mean2 = _global_mean([yt.mean(dim=axes), (yt * yt).mean(dim=axes)])
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            n *= mesh.process_count()
        else:
            var, mean = torch.var_mean(yt, dim=axes, correction=0)
        if update:
            _update_running(bn, mean, var, n)
    else:
        mean, var = (s.to(yt.dtype) for s in (bn.running_mean, bn.running_var))
    return _normalize(yt, bn, mean, var, shape).to(y.dtype)


def _global_mean(parts):
    """The mean over the ranks of each local statistic in ``parts``, in one
    gradient-carrying all-reduce (equal shards: the global batch's mean)."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    total = mesh.global_sum(flat) / mesh.process_count()
    return [t.view_as(p) for t, p in zip(total.split([p.numel() for p in parts]), parts)]


def _ghost_bn(y: torch.Tensor, bn, dim: int, group: int,
              update: bool) -> torch.Tensor:
    """Train-mode BatchNorm with per-group statistics (``GhostBN``,
    ``net.py:233-288``): dim 0 splits into B/group groups, each normalized
    with its own biased ``mean2 - mean^2`` statistics; the running
    statistics take the mean of the groups' over ``n_group`` values a group.
    The reference's multi-GPU DataParallel semantics, with ``group`` the
    per-GPU batch. Under a process group the groups lie within each rank's
    batch, and the running statistics average every rank's groups."""
    b = y.shape[0]
    if b % group:
        where = (f" (the local batch of one of {mesh.process_count()} ranks)"
                 if mesh.initialized() else "")
        raise ValueError(f"batch {b}{where} not divisible by BN group {group}")
    g = b // group
    yg = y.to(torch.promote_types(torch.float32, y.dtype)).reshape(
        (g, group) + tuple(y.shape[1:]))
    cdim = dim % y.dim() + 1
    axes = [d for d in range(1, yg.dim()) if d != cdim]
    mean = yg.mean(dim=axes)  # (g, C)
    var = torch.clamp((yg * yg).mean(dim=axes) - mean * mean, min=0.0)
    if update:
        n_group = y.numel() // (y.shape[dim] * g)
        if mesh.initialized():
            with torch.no_grad():
                sums = mesh.all_reduce(torch.stack([mean.sum(0), var.sum(0)]))
            _update_running(bn, *(sums / (g * mesh.process_count())), n_group)
        else:
            _update_running(bn, mean.mean(0), var.mean(0), n_group)
    shape = [g] + [1] * (yg.dim() - 1)
    shape[cdim] = -1
    inv = torch.reciprocal(torch.sqrt(var + bn.eps)) * bn.weight
    cshape = [1] * yg.dim()
    cshape[cdim] = -1
    out = (yg - mean.reshape(shape)) * inv.reshape(shape) + bn.bias.reshape(cshape)
    return out.reshape(y.shape).to(y.dtype)


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


def pool_sections(g: torch.Tensor, cnt: torch.Tensor, train: bool) -> torch.Tensor:
    """0 over each section whose ``cnt`` (B, M) is 0, then ``slot_max_pool``:
    (B, M, K, C) -> (B, M, C)."""
    return slot_max_pool(g.masked_fill((cnt == 0)[..., None, None], 0.0), train)


class DenseBNReLU(nn.Sequential):
    """1x1 conv + BN + ReLU on channels-last (..., C): the (O, I, 1, 1)
    weight is applied with ``F.linear`` in ``self.dtype`` (None: the
    weight's), which ``FrustumConvNet.set_precision`` sets.

    ``fast_stats`` (train mode, no ghost BatchNorm): the batch statistics
    come from the layer input (``DenseBNReLU``, ``net.py:320-352``): with
    W^T the (I, O) kernel, mean = mu_x W^T and var = sum((cov W^T) * W^T,
    axis 0), cov the centred (I, I) input covariance, in
    ``promote(float32, x.dtype)``; the running statistics count the rows
    (under a process group, the global batch's moments and rows)."""

    def __init__(self, cin: int, cout: int, fast_stats: bool = False,
                 bn_group: int = 0):
        super().__init__(nn.Conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout, eps=1e-5))
        self.dtype, self.fast_stats, self.bn_group = None, fast_stats, bn_group

    def fuses(self, x) -> bool:
        """Whether everything after this layer's GEMM of ``x`` runs as one
        ``ops/pointnet_epilogue`` pass, bit for bit the plain sequence:
        BatchNorm in eval, float32 on a card (parameters and statistics
        included) and grad mode off. Otherwise the plain sequence runs (the CPU, training,
        half precisions, float64, eval with grad on)."""
        bn = self[1]
        dtype = self[0].weight.dtype if self.dtype is None else self.dtype
        return (not bn.training and x.device.type == "cuda" and dtype == torch.float32
                and not torch.is_grad_enabled()
                and all(t.dtype == torch.float32 for t in
                        (bn.weight, bn.bias, bn.running_mean, bn.running_var)))

    def forward(self, x, update: bool = True, cnt=None):
        """``relu(bn(x @ w^T))``. ``cnt`` (B, M), taken only where
        ``fuses(x)``, makes this a scale's last layer: the same pass masks
        its (B, M, K, C) output to 0 where ``cnt == 0`` and pools it over
        the slots, (B, M, C)."""
        conv, bn = self[0], self[1]
        w = conv.weight.view(conv.out_channels, conv.in_channels)
        y = _dense(x, w, self.dtype)
        if self.fuses(x):
            if cnt is None:
                return pointnet_epilogue.bn_relu_cuda_(y, bn)
            return pointnet_epilogue.bn_relu_mask_maxpool_cuda(y, cnt, bn)
        if cnt is not None:
            raise ValueError("cnt is taken only where the epilogue fuses")
        if not (bn.training and self.fast_stats and self.bn_group == 0):
            return F.relu(_bn(y, bn, -1, self.bn_group, update))
        stat = torch.promote_types(torch.float32, x.dtype)
        wt = w.to(stat).T  # (I, O), the JAX kernel
        xf = x.to(stat).reshape(-1, x.shape[-1])
        rows = xf.shape[0]
        mu = xf.mean(dim=0)
        m2 = (xf.T @ xf) / rows
        if mesh.initialized():  # the global batch's moments and row count
            mu, m2 = _global_mean([mu, m2])
            rows *= mesh.process_count()
        mean = mu @ wt
        cov = m2 - torch.outer(mu, mu)
        var = ((cov @ wt) * wt).sum(dim=0)
        if update:
            _update_running(bn, mean, var, rows)
        yt = y.to(torch.promote_types(torch.float32, y.dtype))
        return F.relu(_normalize(yt, bn, mean, var, [-1]).to(y.dtype))


class ConvBNReLU(nn.Sequential):
    """k-tap 1D conv + BN + ReLU over channels-first (B, C, L), in
    ``self.dtype`` (None: the weight's)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, pad: int,
                 bn_group: int = 0):
        super().__init__(nn.Conv1d(cin, cout, kernel, stride, pad, bias=False),
                         nn.BatchNorm1d(cout, eps=1e-5))
        self.dtype, self.bn_group = None, bn_group

    def forward(self, x):
        conv, bn = self[0], self[1]
        dt = conv.weight.dtype if self.dtype is None else self.dtype
        y = F.conv1d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding)
        return F.relu(_bn(y, bn, 1, self.bn_group))


class DeConvBNReLU(nn.Sequential):
    """Transposed 1D conv (exact x``stride`` upsampler) + BN + ReLU, in
    ``self.dtype`` (None: the weight's)."""

    def __init__(self, cin: int, cout: int, kernel: int, bn_group: int = 0):
        super().__init__(nn.ConvTranspose1d(cin, cout, kernel, kernel, bias=False),
                         nn.BatchNorm1d(cout, eps=1e-5))
        self.dtype, self.bn_group = None, bn_group

    def forward(self, x):
        conv, bn = self[0], self[1]
        dt = conv.weight.dtype if self.dtype is None else self.dtype
        y = F.conv_transpose1d(x.to(dt), conv.weight.to(dt), None, conv.stride)
        return F.relu(_bn(y, bn, 1, self.bn_group))


class PointNetScale(nn.Module):
    """One grouping scale: depth-window grouping -> shared MLP -> slot pool.

    ``forward(points, ref, grouped=None)``: with ``grouped=None`` the scale
    groups for itself (``net.py:428-430``): ``points`` or its xyz, by
    ``use_feature``, through ``group_depth_point_auto`` with this scale's
    ``dist`` and ``nsample``. ``FrustumConvNet`` passes the (grouped, cnt)
    of its one multi-scale launch instead. The grouped points stay float32;
    the first Dense casts them. The zero mask for sections with no hit comes
    after the MLP and before the pool (``net.py:438-440``), so their index-0
    duplicates still enter the BatchNorm statistics.

    With ``remat`` in train mode the MLP, mask and pool run under
    ``torch.utils.checkpoint``: their activations are recomputed in the
    backward instead of saved (``nn.checkpoint``, ``net.py:509-510``). The
    recompute skips the running-statistics update, so a step updates them
    once, as JAX does.
    """

    def __init__(self, cin: int, mlp, dist: float, nsample: int,
                 use_feature: bool, fast_bn: bool = False, fast_bn_first: bool = False,
                 bn_group: int = 0, remat: bool = False):
        super().__init__()
        self.dist, self.nsample, self.use_feature = dist, nsample, use_feature
        self.remat = remat
        for j, width in enumerate(mlp):
            self.add_module(f"conv{j + 1}", DenseBNReLU(
                cin, width, fast_bn or (j == 0 and fast_bn_first), bn_group))
            cin = width

    def forward(self, points, ref, grouped=None):
        if grouped is None:
            feats = points if self.use_feature else points[..., :3].contiguous()
            grouped = group_depth_point_auto(feats, ref, self.dist, self.nsample)
        g, cnt = grouped
        if not (self.remat and self.training):
            return self._mlp_pool(g, cnt, True)
        first = [True]

        def run(g):
            update, first[0] = first[0], False  # the recompute updates nothing
            return self._mlp_pool(g, cnt, update)

        return checkpoint(run, g, use_reentrant=False)

    def _mlp_pool(self, g, cnt, update: bool):
        *layers, last = self.children()
        for layer in layers:
            g = layer(g, update)
        if last.fuses(g):  # the last epilogue, the mask and the pool in one pass
            return last(g, update, cnt)
        return pool_sections(last(g, update), cnt, self.training)  # (B, M, mlp[-1])


class FrustumConvNet(nn.Module):
    """The full detector. Returns (cls_logits (B, L, 2), reg (B, L, R)).

    ``dtype`` is the computation dtype (None: the parameters', so a model
    cast to float64 computes in float64); ``trunk_dtype`` the conv trunk's
    and heads' (None: ``dtype``). Both can change between steps
    (``set_precision``) with the same parameters. ``fast_bn``,
    ``fast_bn_first``, ``remat_pointnet`` and ``bn_group`` are
    ``cfg.TPU.{FAST_BN, FAST_BN_FIRST, REMAT_POINTNET, BN_GROUP_SIZE}``.
    """

    def __init__(self, spec: DetModelSpec, dtype: torch.dtype | None = None,
                 trunk_dtype: torch.dtype | None = None, fast_bn: bool = False,
                 fast_bn_first: bool = False, remat_pointnet: bool = False,
                 bn_group: int = 0):
        super().__init__()
        self.spec = s = spec
        pn_in = 3 + (s.extra_feat_dim if s.use_extra_feature else 0)
        self.feat_net = nn.Module()
        for i in range(s.num_scales):
            self.feat_net.add_module(
                f"pointnet{i + 1}",
                PointNetScale(pn_in, s.mlps[i], s.height_half[i], s.nsamples[i],
                              s.use_extra_feature, fast_bn=fast_bn,
                              fast_bn_first=fast_bn_first, bn_group=bn_group,
                              remat=remat_pointnet))
        scale_ch = [m[-1] + s.num_vec for m in s.mlps]
        ch = s.block_channels
        self.conv_net = nn.Module()
        add = self.conv_net.add_module
        kw = dict(bn_group=bn_group)
        add("block1_conv1", ConvBNReLU(scale_ch[0], ch[0], 3, 1, 1, **kw))
        for b in range(1, len(ch)):
            add(f"block{b + 1}_conv1", ConvBNReLU(ch[b - 1], ch[b], 3, 2, 1, **kw))
            add(f"block{b + 1}_conv2", ConvBNReLU(ch[b], ch[b], 3, 1, 1, **kw))
            add(f"block{b + 1}_merge",
                ConvBNReLU(ch[b] + scale_ch[b], ch[b], 1, 1, 0, **kw))
        for b in range(1, len(ch)):
            add(f"block{b + 1}_deconv",
                DeConvBNReLU(ch[b], s.deconv_channels, 2 ** (b - 1), **kw))
        self.cls_out = nn.Conv1d(s.head_channels, s.num_classes, 1)
        self.reg_out = nn.Conv1d(s.head_channels, s.reg_size, 1)
        self.set_precision(dtype, trunk_dtype)

    def set_precision(self, dtype: torch.dtype | None = None,
                      trunk_dtype: torch.dtype | None = None) -> None:
        """Compute in ``dtype``, the trunk and heads in ``trunk_dtype``
        (None: ``dtype``), from the next forward on; the parameters keep
        their dtype."""
        self.dtype = dtype
        self.trunk_dtype = dtype if trunk_dtype is None else trunk_dtype
        for scale in self.feat_net.children():
            for layer in scale.children():
                layer.dtype = dtype
        for block in self.conv_net.children():
            block.dtype = self.trunk_dtype

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

        td = self.trunk_dtype
        scale_feats = []  # channels-first (B, C_i + num_vec, M_i), in td
        for i, grouped in enumerate(groups):
            f = getattr(self.feat_net, f"pointnet{i + 1}")(points, refs[i],
                                                            grouped)
            # the one-hot in the feature dtype, so the concat keeps it
            oh = one_hot.to(f.dtype)[:, None, :].expand(-1, f.shape[1], -1)
            f = torch.cat([f, oh], dim=-1)
            scale_feats.append((f if td is None else f.to(td)).transpose(1, 2))

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

        cls_logits = _dense(x, self.cls_out.weight[:, :, 0], td, self.cls_out.bias)
        reg = _dense(x, self.reg_out.weight[:, :, 0], td, self.reg_out.bias)
        # never below float32; a float64 model stays float64
        out = torch.promote_types(torch.float32, cls_logits.dtype)
        return cls_logits.to(out), reg.to(out)


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
