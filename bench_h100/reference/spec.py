"""The detector's shapes, as a configuration file of the benchmark states them.

The reference builds the model from this and nothing of the program; the
harness checks that the program's own spec agrees with it field by field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    strides: Tuple[float, ...]
    height_half: Tuple[float, ...]
    nsamples: Tuple[int, ...]
    mlps: Tuple[Tuple[int, ...], ...]
    block_channels: Tuple[int, ...]
    deconv_channels: int
    num_classes: int
    num_vec: int
    num_bins: int
    num_sizes: int
    mean_sizes: Tuple[Tuple[float, float, float], ...]
    max_depth: float
    num_points: int
    extra_feat_dim: int = 0
    use_extra_feature: bool = False

    @classmethod
    def from_config(cls, model: dict) -> "ModelSpec":
        return cls(**{f.name: _tuples(model[f.name]) for f in dataclasses.fields(cls)
                      if f.name in model})

    @property
    def num_scales(self) -> int:
        return len(self.strides)

    @property
    def num_refs(self) -> Tuple[int, ...]:
        """Sections a scale: the length of ``arange(0, max_depth, stride)``."""
        return tuple(int(math.ceil(self.max_depth / s - 1e-9)) for s in self.strides)

    @property
    def num_out(self) -> int:
        return self.num_refs[1]

    @property
    def reg_size(self) -> int:
        return 3 + self.num_bins * 2 + self.num_sizes * 4

    @property
    def head_channels(self) -> int:
        return self.deconv_channels * (len(self.block_channels) - 1)


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v
