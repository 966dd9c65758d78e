"""Deterministic synthetic fixtures: frustum batches with consistent labels.

No KITTI/SUN-RGBD raw data ships with this image, so tests and benchmarks
drive the pipeline with generated frustums: a ground-truth 3D box on the
optical ray, points sampled inside it plus background clutter, the sliding
section ladder from the config strides, and section labels assigned exactly
like the provider (reference `datasets/provider_sample.py:272-289`):
+1 inside the half-size box, -1 (ignore) inside the full box, else 0, with
the nearest section forced positive when none falls inside.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.models.spec import DetModelSpec


def section_ladder(spec: DetModelSpec, batch: int) -> list[np.ndarray]:
    """Reference-style ref grids along the optical axis (x=y=0)."""
    refs = []
    for m, s in zip(spec.num_refs, spec.strides):
        z = (np.arange(m) * s + s / 2.0).astype(np.float32)
        r = np.zeros((batch, m, 3), np.float32)
        r[:, :, 2] = z
        refs.append(r)
    return refs


def assign_section_labels(ref_xyz: np.ndarray, center, size, heading) -> np.ndarray:
    """Provider label rule on one ref grid — delegates to the providers'
    single source (ref provider_sample.py:272-289)."""
    from frustum_convnet_tpu_torch.data.provider import section_labels
    return section_labels(center, size, heading, ref_xyz, fractions=(0.5, 1.0))


def make_batch(spec: DetModelSpec, batch: int, seed: int = 0,
               with_labels: bool = True) -> Dict[str, np.ndarray]:
    """A full training/inference batch in the model's input format."""
    rng = np.random.default_rng(seed)
    n, c = spec.num_points, 3 + spec.extra_feat_dim
    refs = section_ladder(spec, batch)

    pts = np.zeros((batch, n, c), np.float32)
    centers = np.zeros((batch, 3), np.float32)
    headings = np.zeros(batch, np.float32)
    sizes = np.zeros((batch, 3), np.float32)
    size_cls = rng.integers(0, spec.num_sizes, batch)
    cls_labels = np.zeros((batch, spec.num_out), np.int64)

    # refine specs ladder a fixed span (not [0, max_depth)); keep fixture
    # boxes and clutter inside whatever the sections actually cover
    span = spec.ref_span if spec.ref_span is not None else spec.max_depth
    for b in range(batch):
        mean = spec.mean_size_array[size_cls[b]]
        size = mean * rng.uniform(0.85, 1.15, 3)
        depth = rng.uniform(span * 0.1, span * 0.8)
        center = np.array([rng.uniform(-1, 1), rng.uniform(-0.5, 0.5), depth], np.float32)
        heading = rng.uniform(-np.pi, np.pi)

        n_fg = n // 2
        # local box frame: x~l, y~h, z~w
        local = rng.uniform(-0.5, 0.5, (n_fg, 3)) * np.array([size[0], size[2], size[1]])
        R = gnp.roty(heading)
        fg_pts = local @ R.T + center[None]
        bg = rng.uniform(
            [-3, -2, 0], [3, 2, span], (n - n_fg, 3)
        )
        xyz = np.concatenate([fg_pts, bg], 0)
        perm = rng.permutation(n)
        pts[b, :, :3] = xyz[perm]
        if spec.extra_feat_dim:
            pts[b, :, 3:] = rng.uniform(0, 1, (n, spec.extra_feat_dim))

        centers[b] = center
        headings[b] = heading
        sizes[b] = size
        if with_labels:
            cls_labels[b] = assign_section_labels(refs[1][b], center, size, heading)

    batch_dict = {
        "point_cloud": pts,
        "one_hot": np.eye(spec.num_vec, dtype=np.float32)[size_cls % spec.num_vec],
        "refs": tuple(refs),
    }
    if with_labels:
        batch_dict.update(
            cls_label=cls_labels,
            box3d_center=centers,
            box3d_heading=headings,
            box3d_size=sizes,
            size_class=size_cls.astype(np.int64),
        )
    return batch_dict
