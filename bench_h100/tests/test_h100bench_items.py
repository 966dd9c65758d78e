"""The frozen data path against the program's own provider."""

import numpy as np
import pytest

from bench_h100.frozen import items, synthetic
from frustum_convnet_tpu_torch.data.dataset_info import DATASET_INFO
from frustum_convnet_tpu_torch.data.provider import FrustumProvider

STRIDES = {"car": (0.25, 0.5, 1.0, 2.0), "people": (0.1, 0.2, 0.4, 0.8)}
CLASSES = {"car": ("Car",), "people": ("Pedestrian", "Cyclist")}


def provider(rec, strides, labeled):
    """The program's provider over ``rec``, as the driver (served) or the
    trainer (flip and shift) builds it."""
    p = object.__new__(FrustumProvider)
    p.npoints, p.one_hot, p.rotate_to_center, p.with_extra_feat = 1024, True, True, False
    p.random_flip = p.random_shift = labeled
    p.from_rgb_detection = not labeled
    p.category_info = DATASET_INFO["KITTI"]
    p.strides, p.max_depth = list(strides), 70.0
    p.data = dict(rec, calib=[{"P2": synthetic.P2}] * len(rec["id"]))
    return p


@pytest.mark.parametrize("labeled", [False, True], ids=["served", "training"])
@pytest.mark.parametrize("family", ["car", "people"])
def test_items_equal_the_providers_bit_for_bit(family, labeled):
    rec = synthetic.make_frustums(np.random.default_rng(11), 48, CLASSES[family],
                                  labeled=labeled)
    got = items.make_items(rec, synthetic.P2, 1024, STRIDES[family], 70.0,
                           np.random.default_rng(5), labeled=labeled,
                           random_flip=labeled, random_shift=labeled)
    prov, rng = provider(rec, STRIDES[family], labeled), np.random.default_rng(5)
    for i, item in enumerate(got):
        want = prov.__getitem__(i, rng)
        assert set(item) == set(want)
        for k, v in want.items():
            pairs = zip(v, item[k]) if k == "refs" else [(v, item[k])]
            for a, b in pairs:
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, (i, k)
                assert np.array_equal(a, b), (i, k)


def test_frustums_hold_their_objects():
    rec = synthetic.make_frustums(np.random.default_rng(3), 64, ("Car",), labeled=True)
    assert len(rec["id"]) == 64 and all(s.sum() > 0 for s in rec["seg"])
    assert all(len(p) > 0 and p.dtype == np.float32 for p in rec["points"])
    served = synthetic.make_frustums(np.random.default_rng(3), 64, ("Pedestrian", "Cyclist"))
    assert set(served["type"]) == {"Pedestrian", "Cyclist"}
    assert all(0.7 <= p < 0.99 for p in served["prob"])
