"""The detector in plain PyTorch: the benchmark's reference and its weights.

Written from the model's description (PointNet scales over depth-window
groups, a 1D conv trunk with lateral merges and deconvolutions, heads over
the output sections; the box codec of 12 heading bins and size templates),
with no kernel, no cache and no batching of its own. It imports nothing of
the program. Tensors are channels-last as the program's public layout is:
points (B, N, 3), ladders (B, M_i, 3), outputs (B, L, 2) and (B, L, R).

The grouping is stated directly: a section takes the first ``nsample``
points in storage order with ``|z_p - z_section| < half-window``; the slots
past its hits repeat its first hit, a section without a hit takes point 0
and its features are zeroed before the max over the slots. BatchNorm is
``(x - mean) / sqrt(var + 1e-5) * gamma + beta``: the running statistics in
eval, the batch's biased statistics in train. The max over the slots
routes its gradient to the first maximal slot (``Tensor.max(dim)``).

Parameters carry the reference state-dict names
(``feat_net.pointnet{i}.conv{j}.{0,1}``, ``conv_net.block*``, ``cls_out``,
``reg_out``), so one dict loads into the program and feeds this module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference.spec import ModelSpec

BN_EPS = 1e-5


def strict_fp32(allow_tf32: bool = False) -> None:
    """float32 matmuls and convolutions in full float32 (TF32 off), or in
    TF32 for the control."""
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32


def layers(spec: ModelSpec):
    """(name, kind, weight shape) of every layer, in a fixed order. ``kind``
    is 'dense' (1x1 conv applied channels-last), 'conv' (k, stride, pad),
    'deconv' (k) or 'head'."""
    out = []
    for i, mlp in enumerate(spec.mlps):
        cin = 3
        for j, width in enumerate(mlp):
            out.append((f"feat_net.pointnet{i + 1}.conv{j + 1}", ("dense",),
                        (width, cin, 1, 1)))
            cin = width
    scale_ch = [m[-1] + spec.num_vec for m in spec.mlps]
    ch = spec.block_channels
    out.append(("conv_net.block1_conv1", ("conv", 1, 1), (ch[0], scale_ch[0], 3)))
    for b in range(1, len(ch)):
        out.append((f"conv_net.block{b + 1}_conv1", ("conv", 2, 1), (ch[b], ch[b - 1], 3)))
        out.append((f"conv_net.block{b + 1}_conv2", ("conv", 1, 1), (ch[b], ch[b], 3)))
        out.append((f"conv_net.block{b + 1}_merge", ("conv", 1, 0),
                    (ch[b], ch[b] + scale_ch[b], 1)))
    for b in range(1, len(ch)):
        k = 2 ** (b - 1)
        out.append((f"conv_net.block{b + 1}_deconv", ("deconv", k),
                    (ch[b], spec.deconv_channels, k)))
    out.append(("cls_out", ("head",), (spec.num_classes, spec.head_channels, 1)))
    out.append(("reg_out", ("head",), (spec.reg_size, spec.head_channels, 1)))
    return out


def _fan_in(kind, shape) -> int:
    if kind[0] == "deconv":
        return shape[0] * shape[2]
    return math.prod(shape[1:])


@torch.no_grad()
def seeded_params(spec: ModelSpec, seed: int, device) -> dict:
    """Weights from ``seed``, made on ``device`` in four calls of one
    generator: kaiming-normal(fan_in) conv weights, kaiming-uniform heads
    with zero bias, unit scale and zero shift in every BatchNorm, and
    running statistics moved off identity (mean ~ N(0, 0.1), var ~ U(0.5,
    1.5)) so that eval-mode normalization does work."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    specs = layers(spec)
    convs = [(n, k, s) for n, k, s in specs if k[0] != "head"]
    heads = [(n, k, s) for n, k, s in specs if k[0] == "head"]
    normal = torch.randn(sum(math.prod(s) for _, _, s in convs), generator=gen,
                         device=device)
    uniform = torch.rand(sum(math.prod(s) for _, _, s in heads), generator=gen,
                         device=device)
    widths = [s[1] if k[0] == "deconv" else s[0] for _, k, s in convs]
    means = torch.randn(sum(widths), generator=gen, device=device) * 0.1
    varis = torch.rand(sum(widths), generator=gen, device=device) + 0.5
    params, at, bn_at = {}, 0, 0
    for (name, kind, shape), width in zip(convs, widths):
        n = math.prod(shape)
        params[f"{name}.0.weight"] = (normal[at:at + n].view(shape)
                                      * math.sqrt(2.0 / _fan_in(kind, shape)))
        at += n
        params[f"{name}.1.weight"] = torch.ones(width, device=device)
        params[f"{name}.1.bias"] = torch.zeros(width, device=device)
        params[f"{name}.1.running_mean"] = means[bn_at:bn_at + width].clone()
        params[f"{name}.1.running_var"] = varis[bn_at:bn_at + width].clone()
        bn_at += width
    at = 0
    for name, kind, shape in heads:
        n = math.prod(shape)
        bound = math.sqrt(6.0 / _fan_in(kind, shape))
        params[f"{name}.weight"] = (uniform[at:at + n].view(shape) * 2 - 1) * bound
        params[f"{name}.bias"] = torch.zeros(shape[0], device=device)
        at += n
    return params


def group(points: torch.Tensor, ref: torch.Tensor, half: float, nsample: int):
    """Depth-window grouping of one scale: (B, N, 3), (B, M, 3) ->
    grouped xyz minus the section center (B, M, K, 3) and hits (B, M)."""
    hit = (points[:, None, :, 2] - ref[:, :, None, 2]).abs() < half  # (B, M, N)
    rank = torch.cumsum(hit.to(torch.int32), dim=-1)  # 1-based rank of each hit
    take = hit & (rank <= nsample)
    b, m, n = take.nonzero(as_tuple=True)
    idx = torch.zeros(hit.shape[:2] + (nsample,), dtype=torch.long, device=points.device)
    idx[b, m, rank[b, m, n].long() - 1] = n
    cnt = hit.sum(dim=-1).clamp(max=nsample)
    slot = torch.arange(nsample, device=points.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, idx] - ref[:, :, None, :], cnt


def _bn(x, params, name, dim, train: bool):
    shape = [1] * x.dim()
    shape[dim] = -1
    if train:
        axes = [d for d in range(x.dim()) if d != dim % x.dim()]
        mean = x.mean(dim=axes)
        var = ((x - mean.view(shape)) ** 2).mean(dim=axes)
    else:
        mean, var = params[f"{name}.1.running_mean"], params[f"{name}.1.running_var"]
    return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
            * params[f"{name}.1.weight"].view(shape) + params[f"{name}.1.bias"].view(shape))


def forward(params: dict, spec: ModelSpec, points, one_hot, refs, train: bool = False):
    """(cls_logits (B, L, 2), reg (B, L, R), head input (B, L, C))."""
    kinds = {n: k for n, k, _ in layers(spec)}
    scale_feats = []
    for i in range(spec.num_scales):
        x, cnt = group(points[..., :3], refs[i], spec.height_half[i], spec.nsamples[i])
        for j in range(len(spec.mlps[i])):
            name = f"feat_net.pointnet{i + 1}.conv{j + 1}"
            w = params[f"{name}.0.weight"]
            x = torch.relu(_bn(x @ w.view(w.shape[0], w.shape[1]).T, params, name, -1, train))
        x = x.masked_fill((cnt == 0)[..., None, None], 0.0)
        x = x.max(dim=2).values  # (B, M, C)
        oh = one_hot[:, None, :].expand(-1, x.shape[1], -1).to(x.dtype)
        scale_feats.append(torch.cat([x, oh], dim=-1).transpose(1, 2))

    def conv(name, x):
        _, stride, pad = kinds[name]
        y = F.conv1d(x, params[f"{name}.0.weight"], None, stride, pad)
        return torch.relu(_bn(y, params, name, 1, train))

    ch = spec.block_channels
    x = conv("conv_net.block1_conv1", scale_feats[0])
    laterals = []
    for b in range(1, len(ch)):
        x = conv(f"conv_net.block{b + 1}_conv1", x)
        x = conv(f"conv_net.block{b + 1}_conv2", x)
        x = conv(f"conv_net.block{b + 1}_merge", torch.cat([x, scale_feats[b]], dim=1))
        laterals.append(x)
    out_len = laterals[0].shape[2]
    ups = []
    for b, lat in enumerate(laterals):
        name = f"conv_net.block{b + 2}_deconv"
        k = kinds[name][1]
        y = F.conv_transpose1d(lat, params[f"{name}.0.weight"], None, k)
        ups.append(torch.relu(_bn(y, params, name, 1, train))[:, :, :out_len])
    feat = torch.cat(ups, dim=1).transpose(1, 2)  # (B, L, C)
    cls = feat @ params["cls_out.weight"][:, :, 0].T + params["cls_out.bias"]
    reg = feat @ params["reg_out.weight"][:, :, 0].T + params["reg_out.bias"]
    return cls, reg, feat


def split_reg(reg, spec: ModelSpec):
    """center (.., 3), heading scores and residuals (.., nb), size scores
    (.., ns) and residuals (.., ns, 3)."""
    nb, ns = spec.num_bins, spec.num_sizes
    return (reg[..., 0:3], reg[..., 3:3 + nb], reg[..., 3 + nb:3 + 2 * nb],
            reg[..., 3 + 2 * nb:3 + 2 * nb + ns],
            reg[..., 3 + 2 * nb + ns:].reshape(*reg.shape[:-1], ns, 3))


def heading_of(h_res, bins, num_bins: int):
    """The angle of heading bin ``bins`` with its residual, wrapped to
    (-pi, pi]."""
    per = 2.0 * math.pi / num_bins
    res = torch.gather(h_res, -1, bins[..., None])[..., 0]
    angle = bins.to(h_res.dtype) * per + res * (per / 2.0)
    return torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)


def size_of(s_res, classes, mean_sizes):
    """(l, w, h) of size template ``classes`` with its residual."""
    idx = classes[..., None, None].expand(*classes.shape, 1, 3)
    res = torch.gather(s_res, -2, idx)[..., 0, :]
    ex = mean_sizes[classes]
    return res * ex + ex


def ladders(ref_dir, ref_off, spec: ModelSpec):
    """The section ladders ``off + dir * z`` of every scale (multiply, then
    add, in float32), z the static depth grids."""
    out = []
    for s in spec.strides:
        z = torch.from_numpy((np.arange(0, spec.max_depth, s) + s / 2.0).astype(np.float32))
        z = z.to(ref_dir.device)
        out.append(ref_off[:, None, :] + ref_dir[:, None, :] * z[None, :, None])
    return out
