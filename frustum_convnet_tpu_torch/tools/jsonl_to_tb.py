"""The port's twin of ``tools/jsonl_to_tb.py``, on the port's
``utils/tfevents.py``; the port's trainer writes the same JSONL
(``utils/logger.py``).

Convert a ScalarWriter JSONL scalar log into TensorBoard event files.

Runs written before the dual-sink ScalarWriter (or with TB output stripped)
only have ``<output_dir>/tb_logger/<tag>.jsonl``; this rewrites them as
``events.out.tfevents.*`` next to the JSONL (``tb_logger/<tag>/``) using the
dependency-free encoder in ``frustum_convnet_tpu_torch/utils/tfevents.py``, so
stock TensorBoard can plot historical runs.

Usage:
  python -m frustum_convnet_tpu_torch.tools.jsonl_to_tb <output_dir> [...]    # one or more run dirs
"""

from __future__ import annotations

import glob
import json
import os
import sys

from frustum_convnet_tpu_torch.utils.tfevents import TFEventWriter


def convert_run(output_dir: str) -> int:
    n = 0
    for jf in sorted(glob.glob(os.path.join(output_dir, "tb_logger", "*.jsonl"))):
        tag = os.path.splitext(os.path.basename(jf))[0]
        w = TFEventWriter(os.path.join(output_dir, "tb_logger", tag))
        with open(jf) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                w.scalar(rec["key"], rec["value"], rec["step"],
                         wall_time=rec.get("ts"))
                n += 1
        w.close()
        print(f"{jf} -> {w.path} ({n} scalars)")
    return n


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__)
        return 1
    total = 0
    for d in args:
        total += convert_run(d)
    if total == 0:
        print("no tb_logger/*.jsonl found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
