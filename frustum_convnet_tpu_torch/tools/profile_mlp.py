"""Micro-profile of the per-scale PointNet MLP at serving batch on one CUDA
card: ``python -m frustum_convnet_tpu_torch.tools.profile_mlp [--batch 256]``

Counterpart of ``tools/profile_mlp.py``, with its rows: for float32 and
bfloat16, each (rows, cin)->(rows, cout) dense layer of every grouping
scale with its BatchNorm+ReLU epilogue (a matmul, then ``relu(y * scale +
shift)``), and each scale's masked max-pool, each timed in isolation, then
their sum. The products are ``torch.matmul``, as the model's are: the JAX
package computes them outside any Pallas kernel.

Each row is the best of 3 trials of 30 back-to-back calls, timed with CUDA
events on the card, TF32 off (``engine/test.strict_fp32``), on inputs made
on the device from a seed. ``--device cpu --tiny`` runs the rows with 2
calls each on the host clock; those times are the CPU's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from frustum_convnet_tpu_torch.engine.test import strict_fp32
from frustum_convnet_tpu_torch.utils.timing import time_calls

ITERS = 30
TRIALS = 3
# (M, K, mlp) per scale: the flagship det_base shapes
SCALES = ((280, 32, (64, 64, 128)), (140, 64, (64, 64, 128)),
          (70, 64, (128, 128, 256)), (35, 128, (256, 256, 512)))


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
    return out


if __name__ == "__main__":
    main()
