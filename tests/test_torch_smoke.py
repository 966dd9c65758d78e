"""``chip_smoke.py`` on the CPU: what can be held here without a card.

* the script names only the port, torch, numpy and the standard library,
  never the JAX package or jax;
* it exits non-zero, with no result line, when no CUDA device is visible;
* the synthetic KITTI val split it writes (7-stream rgb-detection pickle,
  ``label_2`` ground truth, ``image_sets/val.txt``) reads through the
  port's driver, and its foreground labels follow the training label rule
  (``data/provider.section_labels``).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from frustum_convnet_tpu.core.geometry_np import points_in_box3d
from frustum_convnet_tpu.data.provider import section_labels
from frustum_convnet_tpu_torch.engine import test as driver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_names_only_the_port():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert "frustum_convnet_tpu_torch" in roots
    third_party = roots - set(sys.stdlib_module_names)
    assert third_party == {"frustum_convnet_tpu_torch", "numpy", "torch"}, roots


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture(scope="module")
def smoke_split(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke_split"))
    spec = driver.configs.get_model_spec(chip_smoke.flagship_cfg())
    split = chip_smoke.make_val_split(work, spec, num_frames=3, cars_per_frame=2)
    return spec, split


def test_smoke_split_reads_through_the_driver(smoke_split):
    spec, split = smoke_split
    dataset = driver.make_dataset(chip_smoke.flagship_cfg(split["pickle_dir"]))
    assert len(dataset) == 6
    pts, one_hot, refs = chip_smoke.split_batch(dataset, range(6), spec.num_scales)
    assert pts.shape == (6, spec.num_points, 3) and torch.isfinite(pts).all()
    np.testing.assert_array_equal(one_hot.numpy(), np.tile([1.0, 0, 0], (6, 1)))
    assert [r.shape for r in refs] == [(6, m, 3) for m in spec.num_refs]
    # points lie in the frustum: in front of the camera, near the ladder
    assert (pts[..., 2] > 0).all()
    with open(split["idx_path"]) as f:
        ids = f.read().split()
    assert ids == ["000000", "000001", "000002"]
    for i in ids:
        with open(os.path.join(split["gt_dir"], f"{i}.txt")) as f:
            rows = [line.split() for line in f if line.strip()]
        assert len(rows) == 2 and all(r[0] == "Car" and len(r) == 15 for r in rows)
    labels = split["fg_labels"]
    assert labels.shape == (6, spec.num_out) and labels.dtype == bool
    assert (labels.sum(axis=1) >= 1).all() and (labels.sum(axis=1) <= 10).all()


def test_smoke_foreground_labels_are_the_label_rule():
    """``label_rule`` marks the sections ``section_labels`` marks positive,
    on the scale-2 ladder through the 2D box center."""
    rng = np.random.default_rng(0)
    z = np.arange(0, 70, 0.5) + 0.25
    fallbacks = 0
    for i in range(40):
        center = np.array([rng.uniform(-4, 4), 0.9, rng.uniform(5, 40)])
        lwh = np.array([3.9, 1.6, 1.5]) + rng.normal(0, 0.1, 3)
        ry = rng.uniform(-np.pi, np.pi)
        # every other ladder misses the box: the nearest-section fallback
        miss = 80.0 if i % 2 else 5.0
        uv = chip_smoke._to_image(center[None])[0] + rng.uniform(-miss, miss, 2)
        ladder = chip_smoke._to_rect(uv[0], uv[1], z)
        ours = chip_smoke.label_rule(ladder, center, lwh[[0, 2, 1]],
                                     chip_smoke._roty(ry))
        want = section_labels(center, lwh, ry, ladder) == 1
        np.testing.assert_array_equal(ours, want)
        fallbacks += not points_in_box3d(ladder, center, lwh * 0.5, ry).any()
    assert fallbacks >= 5


def test_labeled_split_reads_through_the_trainer():
    """``make_train_split`` writes the 11-stream labeled layout: through the
    trainer's provider (rotated to the frustum center, no augmentation on
    val) the car's points lie in the labeled box, the box's corners, heading
    and size agree, and every frustum has a foreground section."""
    import tempfile

    from frustum_convnet_tpu.core import geometry_np as gnp
    from frustum_convnet_tpu_torch.engine import train as trainer

    spec = driver.configs.get_model_spec(chip_smoke.flagship_cfg())
    with tempfile.TemporaryDirectory() as work:
        chip_smoke.make_train_split(work, spec, num_train=4, num_val=6)
        train_ds, val_ds = trainer.make_datasets(chip_smoke.flagship_cfg(work))
        assert (len(train_ds), len(val_ds)) == (4, 6)
        rng = np.random.default_rng(0)
        for i in range(6):
            raw = {k: val_ds.data[k][i] for k in ("box3d", "heading", "size")}
            np.testing.assert_allclose(
                raw["box3d"], gnp.box3d_corners((raw["box3d"][0] + raw["box3d"][6]) / 2,
                                                raw["size"], raw["heading"]), atol=1e-9)
            item = val_ds.__getitem__(i, rng)
            car = item["seg_label"] == 1
            assert car.sum() > 10
            inside = gnp.points_in_box3d(item["point_cloud"], item["box3d_center"],
                                         item["box3d_size"], item["box3d_heading"],
                                         eps=1e-4)
            assert inside[car].all() and not inside[~car].all()
            labels = item["cls_label"]
            assert (labels == 1).any() and labels.shape == (spec.num_out,)
