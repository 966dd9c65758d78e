"""Micro-profile of the per-scale PointNet MLP at serving batch on one CUDA
card: ``python -m frustum_convnet_tpu_torch.tools.profile_mlp [--batch 256]``

Counterpart of ``tools/profile_mlp.py``, with its rows: for float32 and
bfloat16, each (rows, cin)->(rows, cout) dense layer of every grouping
scale with its BatchNorm+ReLU epilogue (a matmul, then ``relu(y * scale +
shift)``), and each scale's masked max-pool, each timed in isolation, then
their sum. The products are ``torch.matmul``, as the model's are: the JAX
package computes them outside any Pallas kernel.

On the card it then times, in float32 at the serving cells' shapes
(car, people and SUN-RGBD at ``--batch``), each PointNet layer's eval
epilogue as the model runs it there: one pass of
``ops/pointnet_epilogue`` (``bn_relu_cuda_``, in place, for every layer
but a scale's last; ``bn_relu_mask_maxpool_cuda`` for the last), beside
its plain version and its bound, the bytes it must move (y read and
written; the served sections' slots of y read, the pooled output written
and ``cnt`` read) over 3.35 TB/s. Each fused row is first checked bit for
bit against its plain version on its inputs (returned under ``"fused"``).

Each row is the best of 3 trials of 30 back-to-back calls, timed with CUDA
events on the card, TF32 off (``engine/test.strict_fp32``), on inputs made
on the device from a seed. ``--device cpu --tiny`` runs the rows with 2
calls each on the host clock; those times are the CPU's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.engine.test import strict_fp32
from frustum_convnet_tpu_torch.ops import pointnet_epilogue as epi
from frustum_convnet_tpu_torch.utils.timing import time_calls

ITERS = 30
TRIALS = 3
# (M, K, mlp) per scale: the flagship det_base shapes
SCALES = ((280, 32, (64, 64, 128)), (140, 64, (64, 64, 128)),
          (70, 64, (128, 128, 256)), (35, 128, (256, 256, 512)))
# each serving cell's model: the reference's config, at its published widths
FAMILY_CFGS = {"car": "det_sample.yaml", "people": "det_sample_people.yaml",
               "sunrgbd": "det_sample_sunrgbd.yaml"}
CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cfgs")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def family_scales(family: str) -> tuple:
    """(M, K, mlp) per scale of a serving family's model: its sections,
    slots and PointNet widths, from ``cfgs/<FAMILY_CFGS[family]>``."""
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(os.path.join(CFG_DIR, FAMILY_CFGS[family]), cfg)
    spec = configs.get_model_spec(cfg)
    return tuple(zip(spec.num_refs, spec.nsamples, spec.mlps))


def fused_bytes(y: torch.Tensor, cnt: torch.Tensor | None = None) -> int:
    """The HBM bytes a fused epilogue must move: y read and written in
    place (``bn_relu_cuda_``), or, given ``cnt``, the served sections' slots
    of y read (an empty section's are never read), the pooled output
    written and ``cnt`` read (``bn_relu_mask_maxpool_cuda``)."""
    if cnt is None:
        return 8 * y.numel()
    b, m, k, c = y.shape
    return 4 * (int((cnt > 0).sum()) * k * c + b * m * c + b * m)


def eval_bn(c: int, gen, device) -> torch.nn.BatchNorm2d:
    """An eval BatchNorm of ``c`` channels with non-trivial running
    statistics and affine parameters, drawn from ``gen``."""
    bn = torch.nn.BatchNorm2d(c, eps=1e-5).to(device).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=gen, device=device) * 0.2)
        bn.running_var.copy_(torch.rand(c, generator=gen, device=device) * 2 + 0.05)
        bn.weight.copy_(1 + torch.randn(c, generator=gen, device=device) * 0.2)
        bn.bias.copy_(torch.randn(c, generator=gen, device=device) * 0.2)
    return bn


def main(argv=None) -> dict:
    """Time every row; returns {dtype name: {row: seconds a call, "TOTAL":
    their sum}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="2 calls a row (for the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible; pass --device cpu to run on the CPU")
        strict_fp32()
    iters, trials = (2, 1) if args.tiny else (ITERS, TRIALS)
    b = args.batch
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    gen = torch.Generator(device).manual_seed(0)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def layer(x, w, sc, sh):
        return torch.relu(torch.matmul(x, w) * sc + sh)

    def pool(x, cnt):
        valid = (cnt > 0)[..., None, None]
        return torch.amax(torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device)), dim=2)

    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            print(f"\n=== dtype {dname}, batch {b}, {name} ===", flush=True)
            rows = out[dname] = {}
            for si, (m, k, mlp) in enumerate(SCALES):
                print(f"scale{si + 1} (M={m}, K={k}):", flush=True)
                cin = 3
                x = normal((b, m, k, cin), dtype)
                for li, cout in enumerate(mlp):
                    w = torch.as_tensor(np.random.default_rng(1).standard_normal((cin, cout))
                                        * 0.1, dtype=dtype, device=device)
                    sc = torch.ones(cout, dtype=dtype, device=device)
                    sh = torch.zeros(cout, dtype=dtype, device=device)
                    row = f"scale{si + 1} layer{li + 1} ({cin}->{cout}) + bn/relu"
                    rows[row] = time_calls(lambda: layer(x, w, sc, sh), device, iters, trials)
                    print(f"  {row[len(f'scale{si + 1} '):]:44s} {rows[row] * 1e3:8.3f} ms",
                          flush=True)
                    x = normal((b, m, k, cout), dtype)
                    cin = cout
                cnt = torch.as_tensor(np.random.default_rng(2).integers(0, 3, (b, m)),
                                      dtype=torch.int32, device=device)
                row = f"scale{si + 1} masked max-pool"
                rows[row] = time_calls(lambda: pool(x, cnt), device, iters, trials)
                print(f"  {'masked max-pool':44s} {rows[row] * 1e3:8.3f} ms", flush=True)
            rows["TOTAL"] = sum(rows.values())
            print(f"TOTAL (sum of isolated stages): {rows['TOTAL'] * 1e3:.2f} ms")
        if device.type == "cuda":
            out["fused"] = fused_rows(b, device, gen, iters, trials)
    return out


def fused_rows(b: int, device, gen, iters: int, trials: int) -> dict:
    """{row: {"ms", "plain_ms", "bound_ms", "share"}} of each PointNet
    layer's fused eval epilogue at every serving family's shapes, each
    checked bit for bit against its plain version first."""
    rows = {}
    print(f"\n=== fused eval epilogue, float32, batch {b} (bound: bytes over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) ===", flush=True)
    for family in FAMILY_CFGS:
        for si, (m, k, mlp) in enumerate(family_scales(family)):
            cnt = torch.randint(0, 3, (b, m), generator=gen, device=device,
                                dtype=torch.int32)
            for li, c in enumerate(mlp):
                y = torch.randn((b, m, k, c), generator=gen, device=device)
                bn = eval_bn(c, gen, device)
                last = li == len(mlp) - 1
                kernel, plain = ((epi.bn_relu_mask_maxpool_cuda, epi.bn_relu_mask_maxpool_plain)
                                 if last else (epi.bn_relu_cuda_, epi.bn_relu_plain))
                args = (cnt, bn) if last else (bn,)
                same = torch.equal(kernel(y.clone(), *args), plain(y, *args))
                nbytes = fused_bytes(y, cnt if last else None)
                row = (f"{family} scale{si + 1} layer{li + 1} (M={m}, K={k}, C={c}) "
                       + ("bn/relu/mask/max-pool" if last else "bn/relu"))
                if not same:
                    raise AssertionError(f"{row}: the fused epilogue differs from its plain version")
                ms = time_calls(lambda: kernel(y, *args), device, iters, trials) * 1e3
                plain_ms = time_calls(lambda: plain(y, *args), device, iters, trials) * 1e3
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                rows[row] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "share": bound_ms / ms}
                print(f"  {row:66s} fused {ms:8.4f} ms, plain {plain_ms:8.4f} ms, bound "
                      f"{bound_ms:8.4f} ms ({bound_ms / ms:6.1%})", flush=True)
                del y
    return rows


if __name__ == "__main__":
    main()
