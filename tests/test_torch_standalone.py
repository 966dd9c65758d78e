"""The port's copies of the JAX package's jax-free modules, held to their
originals.

The port imports nothing of ``frustum_convnet_tpu``: it keeps its own copy of
every jax-free module it needs, under the same relative path, with only the
imports pointed at the port. Each case below runs the same seeded inputs
through the original and through the copy and requires equal results: equal
arrays of equal dtype, equal floats, equal files.
"""

import dataclasses
import glob
import importlib
import os
import socket
import time

import numpy as np
import pytest

import chip_smoke

JAX_PKG, PORT = "frustum_convnet_tpu", "frustum_convnet_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILES = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yaml")))
TINY = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(x):
    """Config trees, specs and constant classes as plain Python, for comparison across the two
    packages' classes."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, type):  # a class of constants
        return {k: _plain(v) for k, v in vars(x).items() if not k.startswith("_")}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def assert_same(a, b, where="result"):
    """Exact equality: same types and keys, arrays of equal dtype and shape
    and equal values (NaN equal to NaN), floats bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float):
        assert type(a) is type(b) and (a == b or (a != a and b != b)), f"{where}: {a} {b}"
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} {b!r}"


def _cfg(pkg, cfg_file=None, overrides=()):
    configs = _mod(pkg, "configs")
    cfg = configs.get_default_cfg()
    if cfg_file:
        configs.merge_cfg_from_file(cfg_file, cfg)
    configs.merge_cfg_from_list(list(overrides), cfg)
    return cfg


def _files(directory):
    """{relative path: bytes} of every file under ``directory``."""
    out = {}
    for dirpath, _, names in os.walk(directory):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return dict(sorted(out.items()))


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """A tiny labeled split and a tiny rgb-detection split with its KITTI
    ground truth, written from seeded numpy."""
    work = str(tmp_path_factory.mktemp("standalone"))
    spec = _mod(PORT, "configs").get_model_spec(
        _cfg(PORT, CFG_FILES[0], TINY))
    chip_smoke.make_train_split(os.path.join(work, "train"), spec, num_train=12,
                                num_val=4)
    val = chip_smoke.make_val_split(os.path.join(work, "serve"), spec,
                                    num_frames=3, cars_per_frame=2)
    return {"work": work, "train": os.path.join(work, "train"), **val}


# -- cases: each takes (package, splits, out_dir) and returns its result ----

def case_config_default(pkg, splits, out):
    return _plain(_mod(pkg, "configs").get_default_cfg())


def case_config_flagship(pkg, splits, out):
    cfg = _cfg(pkg, CFG_FILES[0], ["TRAIN.BATCH_SIZE", "8", "DATA.STRIDE",
                                   "(0.5, 1.0, 2.0, 4.0)"])
    return _plain(_mod(pkg, "configs").assert_and_infer_cfg(cfg))


def _spec_case(cfg_file):
    def case(pkg, splits, out):
        spec = _mod(pkg, "models.registry").get_model_spec(_cfg(pkg, cfg_file))
        return _plain(spec), spec.num_refs, spec.num_out, spec.reg_size, \
            spec.mean_size_array, spec.head_channels
    return case


def case_config_modules(pkg, splits, out):
    attrdict = _mod(pkg, "configs.attrdict")
    config = _mod(pkg, "configs.config")
    d = attrdict.AttrDict({"a": 1, "b": attrdict.AttrDict({"c": (1.0, 2.0)})})
    d.b.e = "x"
    d.immutable(True)
    try:
        d.a = 2
        refused = False
    except AttributeError:
        refused = True
    cfg = config.get_default_cfg()
    config.merge_cfg_from_list(["TRAIN.BASE_LR", "0.01", "DATA.STRIDE", "(1.0,)"], cfg)
    return _plain(d), d.is_immutable(), refused, _plain(cfg)


def case_kitti_spec(pkg, splits, out):
    spec = _mod(pkg, "models.spec")
    return (_plain(spec.kitti_spec(_cfg(pkg, CFG_FILES[0], TINY))),
            _plain(spec.sunrgbd_spec(_cfg(pkg, CFG_FILES[2]))))


def case_provider_registry(pkg, splits, out):
    cls = _mod(pkg, "data.registry").get_provider_class(_cfg(pkg, CFG_FILES[0]))
    return cls.__name__, cls.name


def case_dataset_info(pkg, splits, out):
    return _plain(_mod(pkg, "data.dataset_info").DATASET_INFO)


def _provider(pkg, splits, split, **kw):
    cfg = _cfg(pkg, CFG_FILES[0], TINY + ["DATA.DATA_ROOT", kw.pop("root")])
    return _mod(pkg, "data.provider").FrustumProvider(cfg, split, **kw)


def case_provider_items_labeled(pkg, splits, out):
    ds = _provider(pkg, splits, "train", root=splits["train"], random_flip=True,
                   random_shift=True)
    rng = np.random.default_rng(5)
    return [ds.__getitem__(i, rng) for i in (0, 3, 5, 11, 1)]


def case_provider_items_rgb_detection(pkg, splits, out):
    ds = _provider(pkg, splits, "val", root=splits["pickle_dir"],
                   from_rgb_detection=True)
    rng = np.random.default_rng(6)
    return [ds.__getitem__(i, rng) for i in range(len(ds))]


def case_batch_loader(pkg, splits, out):
    ds = _provider(pkg, splits, "train", root=splits["train"], random_flip=True,
                   random_shift=True)
    loader = _mod(pkg, "engine.loader").BatchLoader(
        ds, batch_size=5, num_scales=4, shuffle=True, seed=7, pad_last=True,
        num_workers=2)
    return [list(loader.epoch(e)) for e in (0, 1)]


def case_collate_and_decode(pkg, splits, out):
    provider = _mod(pkg, "data.provider")
    ds = _provider(pkg, splits, "train", root=splits["train"])
    batch = provider.collate_batch(
        [ds.__getitem__(i, np.random.default_rng(i)) for i in range(4)], 4)
    rng = np.random.default_rng(8)
    d = 6
    args = (rng.normal(size=(d, 3)), rng.normal(size=d), rng.uniform(1, 4, (d, 3)),
            rng.normal(size=d), rng.normal(size=(d, 3)))
    return batch, provider.from_prediction_to_label_format_batch(*args), \
        provider.from_prediction_to_label_format(args[0][0], args[1][0], args[2][0],
                                                 args[3][0], args[4][0])


def case_make_batch(pkg, splits, out):
    spec = _mod(pkg, "models.registry").get_model_spec(_cfg(pkg, CFG_FILES[0]))
    fixtures = _mod(pkg, "data.fixtures")
    return (fixtures.make_batch(spec, batch=3, seed=1),
            fixtures.make_batch(spec, batch=2, seed=2, with_labels=False))


def case_pickle_io(pkg, splits, out):
    pickle_io = _mod(pkg, "data.pickle_io")
    data = {f: [np.arange(3.0) * i for i in range(4)]
            for f in pickle_io.KITTI_LABELED_FIELDS}
    path = os.path.join(out, "stream.pickle")
    pickle_io.write_stream_pickle(path, data, pickle_io.KITTI_LABELED_FIELDS)
    dict_path = os.path.join(out, "dict.pickle")
    pickle_io.write_dict_pickle(dict_path, {"a": np.ones(2), "b": [1, 2]})
    return (pickle_io.read_stream_pickle(path, pickle_io.KITTI_LABELED_FIELDS),
            pickle_io.read_dict_pickle(dict_path), _files(out))


def _corners(rng, n):
    centers = rng.uniform(-5, 5, (n, 3))
    sizes = rng.uniform(1, 4, (n, 3))
    headings = rng.uniform(-np.pi, np.pi, n)
    return centers, sizes, headings


def case_geometry_and_iou(pkg, splits, out):
    gnp, iou_np = _mod(pkg, "core.geometry_np"), _mod(pkg, "core.iou_np")
    rng = np.random.default_rng(9)
    centers, sizes, headings = _corners(rng, 6)
    corners = [gnp.box3d_corners(c, s, h) for c, s, h in zip(centers, sizes, headings)]
    pts = rng.uniform(-6, 6, (200, 3))
    p2 = chip_smoke.KITTI_P2
    uvd = np.hstack([rng.uniform(0, 1000, (20, 2)), rng.uniform(2, 60, (20, 1))])
    return (gnp.rotx(0.3), gnp.roty(-1.1), gnp.rotz(2.0),
            gnp.rotate_pc_along_y(pts, 0.7), corners,
            gnp.points_in_box3d(pts, centers[0], sizes[0], headings[0], eps=0.01),
            gnp.points_in_box3d_corners(pts, corners[1]),
            gnp.project_image_to_rect(uvd, p2),
            gnp.project_rect_to_image(pts + [0, 0, 10], p2),
            gnp.compute_alpha(pts[:, 0], pts[:, 2], pts[:, 1]),
            [iou_np.rotated_iou_3d_np(a, b) for a in corners for b in corners],
            iou_np.polygon_area(iou_np.box_bev_polygon(corners[2])))


def _dets(rng, n):
    centers, sizes, headings = _corners(rng, n)
    centers[:, :2] *= 0.4  # overlapping boxes
    return np.hstack([centers, sizes, headings[:, None], rng.uniform(0, 1, (n, 1))])


def case_nms(pkg, splits, out):
    native, nms = _mod(pkg, "ops.native"), _mod(pkg, "core.nms")
    rng = np.random.default_rng(10)
    dets = _dets(rng, 40)
    boxes = np.sort(rng.uniform(0, 100, (30, 2, 2)), axis=1).reshape(30, 4)[:, [0, 2, 1, 3]]
    scores = rng.uniform(0, 1, 30)
    c1 = np.stack([_mod(pkg, "core.geometry_np").box3d_corners(d[:3], d[3:6], d[6])
                   for d in dets[:8]])
    return (native.native_available(),
            native.rotate_nms_3d(dets, 0.1), native.rotate_nms_3d(dets, 0.5, top_k=7),
            native.rotate_nms_bev(dets, 0.3),
            native.rbbox_iou_3d_pair(c1, c1[::-1]), native.rbbox_iou_3d_matrix(c1, c1),
            nms.rotate_nms_3d(dets, 0.1), nms.rotate_nms_bev(dets, 0.3),
            nms.nms_axis_aligned(boxes, scores, 0.3))


def _det_results(rng):
    """{frame: {class: [[x1, y1, x2, y2, tx, ty, tz, h, w, l, ry, score]]}}."""
    out = {}
    for frame in range(4):
        d = _dets(rng, 5)
        box2d = np.sort(rng.uniform(0, 600, (5, 2, 2)), axis=1).reshape(5, 4)[:, [0, 2, 1, 3]]
        out[frame] = {"Car": np.hstack([box2d, d[:, :3], d[:, [5, 4, 3]], d[:, 6:]]).tolist()}
    return out


def case_kitti_writer(pkg, splits, out):
    writer = _mod(pkg, "evaluation.kitti_writer")
    dets = _det_results(np.random.default_rng(11))
    data_dir = writer.write_detection_results(os.path.join(out, "res"), dets,
                                              split_ids=range(6), nms_threshold=0.1)
    return writer.apply_cube_nms(dets, 0.2), os.path.relpath(data_dir, out), _files(out)


def _eval_fixture(directory):
    """The hand-traced fixture of ``tests/test_eval_fixture.py``: 12 cars,
    10 detected, 3 false positives, a DontCare region and a Van."""
    import test_eval_fixture as fx

    gt_dir = os.path.join(directory, "gt")
    data_dir = os.path.join(directory, "res", "data")
    os.makedirs(gt_dir)
    os.makedirs(data_dir)
    fp_scores = {0: 0.93, 1: 0.72, 2: 0.55}
    for i in range(12):
        gts, dets = [fx._car(i)], []
        if i < 10:
            dets.append(fx._car(i, score=0.95 - 0.05 * i))
        if i in fp_scores:
            dets.append(fx._line("Car", (300, 100, 400, 200), 1.5, 1.6, 3.9,
                                 (float(10 * i + 500), 1.5, 20.0), score=fp_scores[i]))
        if i == 0:
            gts.append(fx._line("DontCare", (500, 100, 600, 200), -1, -1, -1,
                                (-1000, -1000, -1000), ry=-10))
            dets.append(fx._line("Car", (520, 120, 580, 180), 1.5, 1.6, 3.9,
                                 (700.0, 1.5, 20.0), score=0.85))
        if i == 3:
            van = ("Van", (700, 100, 800, 200), 2.0, 2.0, 5.0, (900.0, 1.5, 20.0))
            gts.append(fx._line(*van))
            dets.append(fx._line("Car", *van[1:], score=0.88))
        for d, lines in ((gt_dir, gts), (data_dir, dets)):
            with open(os.path.join(d, f"{i:06d}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return gt_dir, os.path.join(directory, "res")


def case_kitti_eval_fixture(pkg, splits, out):
    kitti_eval = _mod(pkg, "evaluation.kitti_eval")
    gt_dir, res_dir = _eval_fixture(out)
    aps = kitti_eval.evaluate(gt_dir, res_dir, classes=("car",))
    stats = {k: v for k, v in _files(res_dir).items() if k.startswith("stats_")}
    plots = sorted(k for k in _files(res_dir) if k.startswith("plot"))
    return aps, stats, plots, _mod(pkg, "ops.native").evaluate_kitti_native(gt_dir, res_dir)


def case_kitti_eval_synthetic(pkg, splits, out):
    kitti_eval = _mod(pkg, "evaluation.kitti_eval")
    dets = _det_results(np.random.default_rng(12))
    writer = _mod(pkg, "evaluation.kitti_writer")
    res = os.path.join(out, "res")
    writer.write_detection_results(res, {i: dets[i % 4] for i in range(3)},
                                   split_ids=range(3))
    aps = kitti_eval.evaluate(splits["gt_dir"], res, classes=("car", "pedestrian"))
    return aps, {k: v for k, v in _files(res).items() if k.startswith("stats_")}


def case_training_states(pkg, splits, out):
    metrics = _mod(pkg, "utils.metrics")
    states = metrics.TrainingStates()
    rng = np.random.default_rng(13)
    for step in range(5):
        states.update_states({"total_loss": rng.uniform(), "iou": np.float32(rng.uniform()),
                              **({"late": step} if step > 2 else {})}, n=step + 1)
    meter = metrics.AverageMeter()
    meter.update(2.5, 3)
    meter.update(1.0)
    got = (states.get_states(), states.get_states(avg=False), states.format_states(),
           states.format_states(avg=False), meter.avg, meter.val, meter.count)
    states.reset()
    return got + (states.get_states(),)


def case_scalar_writer(pkg, splits, out, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    logger = _mod(pkg, "utils.logger")
    writer = logger.ScalarWriter(out, "train")
    rng = np.random.default_rng(14)
    writer.scalars({"total_loss": 2.0, "cls_loss": np.float32(0.5)}, step=7)
    writer.image_summary("img", [rng.uniform(size=(4, 5, 3)),
                                 (rng.uniform(size=(3, 3)) * 255).astype(np.uint8)], step=8)
    writer.histo_summary("w", rng.normal(size=100), step=9, bins=10)
    writer.close()
    log = logger.get_logger(os.path.join(out, "log", "run.log"), name=f"standalone-{pkg}")
    log.info("hello %d", 3)
    for h in log.handlers:
        h.close()
    with open(os.path.join(out, "log", "run.log")) as f:
        lines = [line.split(" ", 2)[2] for line in f]  # drop the timestamp
    tfevents = _mod(pkg, "utils.tfevents")
    return (_files(os.path.join(out, "tb_logger")), lines,
            tfevents.crc32c(b"123456789"),
            tfevents.encode_png((rng.uniform(size=(2, 3)) * 255).astype(np.uint8)))


def case_pr_plot(pkg, splits, out):
    pytest.importorskip("matplotlib")
    plots = _mod(pkg, "evaluation.plots")
    rng = np.random.default_rng(15)
    path = os.path.join(out, "plot", "car.png")
    plots.save_pr_plot(path, "car detection", [rng.uniform(size=41) for _ in range(3)],
                       labels=("Easy", "Moderate", "Hard"))
    return os.path.exists(path) and os.path.getsize(path) > 0


CASES = {
    "config_default": case_config_default,
    "config_flagship": case_config_flagship,
    **{f"model_spec_{os.path.basename(f)[:-5]}": _spec_case(f) for f in CFG_FILES},
    "config_modules": case_config_modules,
    "kitti_spec": case_kitti_spec,
    "provider_registry": case_provider_registry,
    "dataset_info": case_dataset_info,
    "provider_items_labeled": case_provider_items_labeled,
    "provider_items_rgb_detection": case_provider_items_rgb_detection,
    "batch_loader": case_batch_loader,
    "collate_and_decode": case_collate_and_decode,
    "make_batch": case_make_batch,
    "pickle_io": case_pickle_io,
    "geometry_and_iou": case_geometry_and_iou,
    "nms": case_nms,
    "kitti_writer": case_kitti_writer,
    "kitti_eval_fixture": case_kitti_eval_fixture,
    "kitti_eval_synthetic": case_kitti_eval_synthetic,
    "training_states": case_training_states,
    "scalar_writer": case_scalar_writer,
    "pr_plot": case_pr_plot,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_matches_original(name, splits, tmp_path, monkeypatch):
    case = CASES[name]
    results = []
    for pkg in (JAX_PKG, PORT):
        out = tmp_path / pkg
        out.mkdir()
        extra = (monkeypatch,) if name == "scalar_writer" else ()
        results.append(case(pkg, splits, str(out), *extra))
    assert_same(*results)


@pytest.mark.parametrize("name", ["provider_sample_refine", "provider_sample_sunrgbd"])
def test_unported_providers_raise(name):
    registry = _mod(PORT, "data.registry")
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        registry.get_provider_class(_cfg(PORT, overrides=["DATA.FILE", name]))


def test_every_copy_is_tested():
    """Each module the port copied from the JAX package appears in a case."""
    copied = []
    port_root = os.path.join(ROOT, PORT)
    for dirpath, _, names in os.walk(port_root):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), port_root)
            if (name.endswith(".py") and name != "__init__.py"
                    and os.path.exists(os.path.join(ROOT, JAX_PKG, rel))):
                copied.append(rel[:-3].replace(os.sep, "."))
    import inspect

    source = inspect.getsource(inspect.getmodule(test_every_copy_is_tested))
    port_own = {"core.codecs", "core.geometry", "core.iou", "ops.query_depth_point",
                "models.net", "models.det", "models.losses", "parallel.train_step",
                "engine.train", "engine.test", "engine.checkpoints",
                "tools.profile_stages"}
    untested = [m for m in copied if m not in port_own and f'"{m}"' not in source]
    assert copied and not untested, untested
