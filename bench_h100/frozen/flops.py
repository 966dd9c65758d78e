"""The model's forward operations a frustum.

Frozen copy of ``flops_per_frustum`` from
``frustum_convnet_tpu_torch/bench.py`` at commit ca7cd01, unchanged. It takes
any object with the model spec's fields (``reference.spec.ModelSpec``).
A training step counts three times the forward (``TRAIN_FLOPS_MULT``).
"""

from __future__ import annotations

TRAIN_FLOPS_MULT = 3.0


def flops_per_frustum(spec) -> float:
    """Analytic forward model FLOPs per frustum (matmul/conv MACs x 2).

    Counts the useful dense math only — per-scale PointNet MLPs over the
    (M_i, K_i) grouped points, the 1D conv encoder/decoder, and the heads.
    Excluded: the grouping kernel's scan (bookkeeping, not model math), BN
    statistics/normalize, ReLU, max-pool, and the box decode — all
    bandwidth-bound elementwise work.
    """
    cin0 = 3 + (spec.extra_feat_dim if spec.use_extra_feature else 0)
    f = 0.0
    for i in range(spec.num_scales):  # shared MLPs (PointNetScale)
        chs = (cin0,) + tuple(spec.mlps[i])
        macs = sum(a * b for a, b in zip(chs[:-1], chs[1:]))
        f += 2.0 * spec.num_refs[i] * spec.nsamples[i] * macs
    # conv trunk (FrustumConvNet blocks; stride-2 lengths == next scale's
    # section count by ladder construction)
    ch, L = spec.block_channels, spec.num_refs
    feat_ch = [spec.mlps[i][-1] + spec.num_vec for i in range(spec.num_scales)]
    f += 2.0 * L[0] * 3 * feat_ch[0] * ch[0]  # block1_conv1 (3-tap)
    for b in range(1, len(ch)):
        f += 2.0 * L[b] * 3 * ch[b - 1] * ch[b]  # stride-2 3-tap
        f += 2.0 * L[b] * 3 * ch[b] * ch[b]  # 3-tap
        f += 2.0 * L[b] * (ch[b] + feat_ch[b]) * ch[b]  # merge 1x1
        # deconv back to the stride-2 length: k-tap transpose, k = 2^(b-1)
        f += 2.0 * L[b] * (2 ** (b - 1)) * ch[b] * spec.deconv_channels
    f += 2.0 * spec.num_out * spec.head_channels * (spec.num_classes
                                                    + spec.reg_size)
    return f
