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
import pickle
import socket
import time
import warnings

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


def fake_stage1_results(label_dir: str, res_dir: str, seed: int = 0) -> None:
    """A stage-1 result directory: each ground-truth box of ``label_dir``
    moved by a few decimetres, with a detector score."""
    rng = np.random.default_rng(seed)
    os.makedirs(res_dir)
    for name in sorted(os.listdir(label_dir)):
        lines = []
        with open(os.path.join(label_dir, name)) as f:
            for line in f:
                p = line.split()
                vals = [float(x) for x in p[1:]]
                vals[10] += rng.normal(0, 0.1)  # tx
                vals[12] += rng.normal(0, 0.1)  # tz
                lines.append(p[0] + " " + " ".join(f"{v:.2f}" for v in vals)
                             + f" {rng.uniform(0.6, 0.95):.3f}")
        with open(os.path.join(res_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """A tiny labeled split and a tiny rgb-detection split with its KITTI
    ground truth, written from seeded numpy; the refine pickles of a tiny
    synthetic KITTI and the SUN-RGBD pickles of tiny synthetic scenes,
    written by the port (the prep cases hold the port's prep to the
    original's)."""
    work = str(tmp_path_factory.mktemp("standalone"))
    spec = _mod(PORT, "configs").get_model_spec(
        _cfg(PORT, CFG_FILES[0], TINY))
    chip_smoke.make_train_split(os.path.join(work, "train"), spec, num_train=12,
                                num_val=4)
    val = chip_smoke.make_val_split(os.path.join(work, "serve"), spec,
                                    num_frames=3, cars_per_frame=2)

    kitti = os.path.join(work, "kitti_raw")
    _mod(PORT, "data.kitti.synthetic").make_synthetic_kitti(
        kitti, num_frames=4, cars_per_frame=2, seed=2)
    res = os.path.join(work, "stage1", "data")
    fake_stage1_results(os.path.join(kitti, "training", "label_2"), res)
    people = os.path.join(work, "people_raw")
    _mod(PORT, "data.kitti.synthetic").make_synthetic_kitti(
        people, num_frames=4, cars_per_frame=3, seed=3,
        classes=("Pedestrian", "Cyclist"))
    refine = os.path.join(work, "refine")
    _mod(PORT, "data.kitti.prepare_refine").main([
        "--car_only", "--gen_train", "--gen_val", "--gen_val_det",
        "--gen_val_rgb_detection", "--data_root", kitti, "--save_dir", refine,
        "--train_res_dir", res, "--val_res_dir", res])

    sun = os.path.join(work, "sun_raw")
    _mod(PORT, "data.sunrgbd.synthetic").make_synthetic_sunrgbd(
        sun, num_frames=4, objects_per_frame=2, seed=4)
    sun_pickles = os.path.join(work, "sun_pickles")
    _mod(PORT, "data.sunrgbd.prepare").main([
        "--gen_train", "--gen_val", "--gen_val_rgb_detection", "--sunrgbd_dir", sun,
        "--save_dir", sun_pickles, "--train_idx",
        os.path.join(sun, "image_sets", "train.txt"), "--val_idx",
        os.path.join(sun, "image_sets", "val.txt"), "--det_file",
        os.path.join(sun, "det_val.txt")])
    return {"work": work, "train": os.path.join(work, "train"), **val,
            "kitti_raw": kitti, "people_raw": people, "stage1": res, "refine": refine,
            "sun_raw": sun, "sun_pickles": sun_pickles}


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
    registry = _mod(pkg, "data.registry")
    return [(cls.__name__, cls.name) for cls in
            (registry.get_provider_class(_cfg(pkg, f)) for f in CFG_FILES)]


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


CFG = {os.path.basename(f)[:-5]: f for f in CFG_FILES}


def _attrs(obj):
    """An object's attributes as a dict, for comparison across packages."""
    return dict(vars(obj))


def case_prep_util(pkg, splits, out):
    prep_util = _mod(pkg, "data.prep_util")
    frames = prep_util.parallel_map_frames(abs, [-3, 1, -2])
    merged = prep_util.merge_frame_outputs(
        [{"a": [i], "b": [i, -i]} for i in frames], ("a", "b"))
    return frames, merged


def _synthetic_kitti(pkg, out, **kw):
    _mod(pkg, "data.kitti.synthetic").make_synthetic_kitti(
        os.path.join(out, "raw"), num_frames=4, cars_per_frame=2, seed=2, **kw)
    return _files(out)


def case_kitti_synthetic(pkg, splits, out):
    return _synthetic_kitti(pkg, out)


def case_kitti_synthetic_people(pkg, splits, out):
    return _synthetic_kitti(pkg, out, classes=("Pedestrian", "Cyclist"))


def case_kitti_calib_and_object(pkg, splits, out):
    calib = _mod(pkg, "data.kitti.calib")
    ds = _mod(pkg, "data.kitti.object").KittiObjectDataset(splits["kitti_raw"])
    c = ds.get_calibration(1)
    rng = np.random.default_rng(16)
    pts = rng.uniform(-10, 40, (50, 3))
    uvd = np.hstack([rng.uniform(0, 1200, (20, 2)), rng.uniform(2, 60, (20, 1))])
    objs = ds.get_label_objects(2)
    line = objs[0].to_kitti_line() + " 0.87"
    scored = calib.Object3d(line)
    return (len(ds), c.as_dict(), c.velo_to_ref(pts), c.ref_to_velo(pts),
            c.ref_to_rect(pts), c.rect_to_ref(pts), c.velo_to_rect(pts),
            c.rect_to_velo(pts), c.rect_to_image(pts + [0, 0, 10]),
            c.velo_to_image(pts), c.image_to_rect(uvd), c.image_to_velo(uvd),
            [_attrs(o) for o in objs], [o.to_kitti_line() for o in objs],
            _attrs(scored), scored.to_kitti_line(), ds.get_lidar(3),
            ds.get_image_size(0), ds.get_image(0).shape,
            calib.Calibration(c.as_dict()).as_dict())


def case_kitti_prepare(pkg, splits, out):
    """The stage-1 prep CLI, every pickle of the car split (the GT path over
    2 worker processes) and of the people split."""
    prepare = _mod(pkg, "data.kitti.prepare")
    raw = splits["kitti_raw"]
    common = ["--data_root", raw, "--rgb_det_dir", os.path.join(raw, "rgb_detections")]
    prepare.main(["--car_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                  "--gen_train_det", "--gen_avg_dim", "--workers", "2",
                  "--save_dir", os.path.join(out, "car")] + common)
    people = splits["people_raw"]
    prepare.main(["--people_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                  "--data_root", people, "--rgb_det_dir",
                  os.path.join(people, "rgb_detections"),
                  "--save_dir", os.path.join(out, "people")])
    stats = prepare.get_box3d_dim_statistics(
        os.path.join(people, "image_sets", "train.txt"), people)
    return _files(out), stats


def case_kitti_prepare_refine(pkg, splits, out):
    """The refine prep CLI: the GT path (over 2 worker processes), the
    detection-assignment path and the rgb-detection path."""
    prepare_refine = _mod(pkg, "data.kitti.prepare_refine")
    res = splits["stage1"]
    prepare_refine.main(["--car_only", "--gen_train", "--gen_val", "--gen_val_det",
                         "--gen_val_rgb_detection", "--workers", "2",
                         "--data_root", splits["kitti_raw"], "--save_dir", out,
                         "--train_res_dir", res, "--val_res_dir", res])
    rng = np.random.default_rng(20)
    box = np.array([1.0, 1.5, 20.0, 3.9, 1.6, 1.5, 0.3])
    return (_files(out), prepare_refine.random_shift_rotate_box3d(box, 0.05, rng),
            prepare_refine.center_array_corners(box))


def case_box_overlaps(pkg, splits, out):
    bo = _mod(pkg, "core.box_overlaps")
    rng = np.random.default_rng(19)
    b1 = np.sort(rng.uniform(0, 10, (6, 2)), axis=1)
    b2 = np.sort(rng.uniform(0, 100, (6, 2, 2)), axis=1).reshape(6, 4)[:, [0, 2, 1, 3]]
    lo = rng.uniform(0, 5, (5, 3))
    b3 = np.hstack([lo, lo + rng.uniform(0.5, 3, (5, 3))])
    centers, sizes, headings = _corners(rng, 5)
    centers[:, :2] *= 0.3
    boxes3d = np.hstack([centers, sizes, headings[:, None]])
    bev = boxes3d[:, [0, 2, 3, 4, 6]]
    corners = bo.boxes3d2corners(boxes3d)
    return (bo.bbox_overlaps_1d(b1, b1[::-1]), bo.bbox_overlaps_2d(b2, b2[::-1]),
            bo.bbox_overlaps_3d(b3, b3[::-1]), bo.rbbox2corner(bev), corners,
            bo.corner2standup(corners), bo.rbbox_iou(bev, bev[::-1]),
            bo.rbbox_iou_3d(boxes3d, boxes3d[::-1]),
            bo.rbbox_iou_3d_pair(corners, corners[::-1]))


def _refine_provider(pkg, splits, split, cfg_name="refine_car", **kw):
    cfg = _cfg(pkg, CFG[cfg_name], ["DATA.DATA_ROOT", splits["refine"],
                                    "DATA.NUM_SAMPLES", "128"])
    return _mod(pkg, "data.provider_refine").FrustumRefineProvider(cfg, split, **kw)


def case_provider_refine_items(pkg, splits, out):
    """Labeled, rgb-detection and extend_from_det items from one seeded rng;
    the ladders of a degenerate box (all zeros) and the decode."""
    labeled = _refine_provider(pkg, splits, "train", random_flip=True,
                               random_shift=True)
    rgb = _refine_provider(pkg, splits, "val", from_rgb_detection=True)
    extended = _refine_provider(pkg, splits, "train", extend_from_det=True)
    rng = np.random.default_rng(17)
    items = ([labeled.__getitem__(i, rng) for i in range(len(labeled))]
             + [rgb.__getitem__(i, rng) for i in range(len(rgb))]
             + [extended.__getitem__(i, rng) for i in range(len(labeled), len(extended))])
    provider_refine = _mod(pkg, "data.provider_refine")
    decoded = provider_refine.from_prediction_to_label_format(
        rng.normal(size=3), 0.4, rng.uniform(1, 4, 3), 1.2, rng.normal(size=3))
    with warnings.catch_warnings():  # a box with no extent has no front face
        warnings.simplefilter("ignore", RuntimeWarning)
        empty = labeled.generate_ref(np.zeros((8, 3)))
    return items, len(extended), labeled.num_refs, empty, decoded


def case_sunrgbd_synthetic(pkg, splits, out):
    _mod(pkg, "data.sunrgbd.synthetic").make_synthetic_sunrgbd(
        os.path.join(out, "raw"), num_frames=4, objects_per_frame=2, seed=4)
    return _files(out)


def case_sunrgbd_calib_and_object(pkg, splits, out):
    calib = _mod(pkg, "data.sunrgbd.calib")
    ds = _mod(pkg, "data.sunrgbd.object").SunrgbdObjectDataset(splits["sun_raw"])
    c = ds.get_calibration(2)
    rng = np.random.default_rng(21)
    pc = ds.get_pointcloud(2)[:200]
    uvd = np.hstack([rng.uniform(0, 700, (20, 2)), rng.uniform(0.5, 8, (20, 1))])
    objs = ds.get_label_objects(2)
    np.savetxt(os.path.join(out, "pts.txt"), pc[:5])
    return (c.calib_text(), c.upright_depth_to_camera(pc), c.upright_depth_to_image(pc),
            c.upright_depth_to_upright_camera(pc), c.upright_camera_to_upright_depth(pc),
            c.image_to_camera(uvd), c.image_to_upright_camera(uvd),
            calib.project_image_to_upright_camera(uvd, c.K, c.Rtilt),
            [_attrs(o) for o in objs], [o.to_label_line() for o in objs],
            [calib.compute_box3d_upright_depth(o) for o in objs],
            calib.random_shift_box2d(objs[0].box2d, 0.1, rng), calib.rotz(0.7),
            calib.flip_axis_to_camera(pc), calib.flip_axis_to_depth(pc),
            calib.load_depth_points(os.path.join(out, "pts.txt")))


def case_sunrgbd_prepare(pkg, splits, out):
    """The SUN-RGBD prep CLI over 2 worker processes; the voxel downsample
    and the detection-pickle reader."""
    prepare = _mod(pkg, "data.sunrgbd.prepare")
    sun = splits["sun_raw"]
    sets = os.path.join(sun, "image_sets")
    prepare.main(["--gen_train", "--gen_val", "--gen_val_rgb_detection",
                  "--workers", "2", "--sunrgbd_dir", sun, "--save_dir", out,
                  "--train_idx", os.path.join(sets, "train.txt"),
                  "--val_idx", os.path.join(sets, "val.txt"),
                  "--det_file", os.path.join(sun, "det_val.txt")])
    down = os.path.join(out, "down", "val.pickle")
    os.makedirs(os.path.dirname(down))
    prepare.extract_frustum_data(sun, os.path.join(sets, "val.txt"), "training", down,
                                 with_down_sample=True)
    rng = np.random.default_rng(22)
    dets = [[[] for _ in range(2)] for _ in range(len(prepare.DET_CLASSES_19))]
    dets[2][0] = [np.array([10.0, 20.0, 200.0, 220.0, 0.9])]
    dets[5][1] = [np.array([5.0, 6.0, 50.0, 70.0, 0.7])]
    det_pkl = os.path.join(out, "dets.pkl")
    with open(det_pkl, "wb") as f:
        pickle.dump(dets, f)
    return (_files(out), prepare.down_sample(rng.uniform(0, 0.05, (300, 3))),
            prepare.read_det_pkl_file(det_pkl))


@pytest.fixture(scope="module")
def mini_toolbox(tmp_path_factory):
    """A 2-sample SUN-RGBD toolbox dump (``tests/test_sunrgbd_ingest.py``'s
    layout): depth and rgb images and ``SUNRGBDMeta.mat``."""
    import test_sunrgbd_ingest as ti
    from PIL import Image
    from scipy import io as scipy_io

    root = tmp_path_factory.mktemp("toolbox")
    scene = root / "SUNRGBD" / "kv1" / "scene0"
    (scene / "image").mkdir(parents=True)
    (scene / "depth").mkdir()
    rng = np.random.default_rng(0)
    mm = np.full((ti.H, ti.W), int(ti.DEPTH_M * 1000), dtype=np.uint32)
    mm += rng.integers(-200, 200, size=(ti.H, ti.W)).astype(np.uint32)
    mm[0, :4] = 0
    Image.fromarray(ti._encode_depth(mm), mode="I;16").save(str(scene / "depth" / "d.png"))
    Image.fromarray(rng.integers(0, 255, size=(ti.H, ti.W, 3), dtype=np.uint8),
                    mode="RGB").save(str(scene / "image" / "i.jpg"))
    K = np.array([[ti.FX, 0, ti.W / 2.0], [0, ti.FY, ti.H / 2.0], [0, 0, 1.0]])
    meta = np.zeros((1, 2), dtype=[
        ("depthpath", "O"), ("rgbpath", "O"), ("Rtilt", "O"), ("K", "O"),
        ("groundtruth3DBB", "O"), ("groundtruth2DBB", "O")])
    for i, rtilt in enumerate((ti._rot_x(0.1), np.eye(3))):
        centroid = rtilt @ np.array([0.0, ti.DEPTH_M, 0.0])
        bb3 = [ti._bb3("bed", centroid, (1.2, 1.2, 1.2), (1.0, 0.0, 0.0)),
               ti._bb3("chair", centroid + 2.0, (0.3, 0.3, 0.5), (0.0, 1.0, 0.0))]
        bb2 = [ti._bb2((10, 10, 44, 28)), ti._bb2(None if i else (3, 4, 20, 30))]
        meta[0, i] = ("/n/fs/sun3d/data/SUNRGBD/kv1/scene0/depth/d.png",
                      "/n/fs/sun3d/data/SUNRGBD/kv1/scene0/image/i.jpg", rtilt, K,
                      np.concatenate(bb3).reshape(1, -1), np.concatenate(bb2).reshape(1, -1))
    meta_path = str(root / "SUNRGBDMeta.mat")
    scipy_io.savemat(meta_path, {"SUNRGBDMeta": meta})
    return {"meta": meta_path, "sunrgbd_root": str(root / "SUNRGBD")}


def case_sunrgbd_ingest(pkg, splits, out, mini_toolbox):
    ingest = _mod(pkg, "data.sunrgbd.ingest")
    ingest.main(["--meta", mini_toolbox["meta"], "--sunrgbd_root",
                 mini_toolbox["sunrgbd_root"], "--save_root",
                 os.path.join(out, "training"), "--image_sets",
                 os.path.join(out, "image_sets")])
    basis = np.array([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8], [0.9, 0.1, 0.0]])
    return (_files(out), ingest.order_basis(basis, np.array([1.0, 2.0, 3.0]),
                                            np.array([0.0, 4.0, 0.0])))


def _sun_provider(pkg, splits, split, **kw):
    cfg = _cfg(pkg, CFG["det_sample_sunrgbd"], ["DATA.DATA_ROOT", splits["sun_pickles"],
                                                "DATA.NUM_SAMPLES", "256"])
    return _mod(pkg, "data.provider_sunrgbd").FrustumSunrgbdProvider(cfg, split, **kw)


def case_provider_sunrgbd_items(pkg, splits, out):
    """Labeled (augmented), labeled val and rgb-detection items from one
    seeded rng, and the decode with and without a reference center."""
    train = _sun_provider(pkg, splits, "train", random_flip=True, random_shift=True)
    val = _sun_provider(pkg, splits, "val")
    rgb = _sun_provider(pkg, splits, "val", from_rgb_detection=True,
                        overwritten_data_path=os.path.join(
                            splits["sun_pickles"], "sunrgbd_rgb_det_val.pickle"))
    rng = np.random.default_rng(23)
    items = [ds.__getitem__(i, rng) for ds in (train, val, rgb) for i in range(len(ds))]
    decode = _mod(pkg, "data.provider_sunrgbd").from_prediction_to_label_format
    args = (rng.normal(size=3), 0.4, rng.uniform(0.5, 2, 3), 1.2)
    return items, decode(*args), decode(*args, rng.normal(size=3))


def case_sunrgbd_eval(pkg, splits, out):
    """``build_gt_all``, then ``eval_det`` (both AP rules, with the json it
    writes) on jittered ground truth with false positives, ``voc_ap`` and
    the MATLAB ground-truth reader."""
    ev = _mod(pkg, "evaluation.sunrgbd_eval")
    whitelist = _mod(pkg, "data.sunrgbd.prepare").TYPE_WHITELIST_10
    with open(os.path.join(splits["sun_raw"], "image_sets", "val.txt")) as f:
        ids = [int(line) for line in f if line.strip()]
    gt = ev.build_gt_all(splits["sun_raw"], ids, whitelist)
    rng = np.random.default_rng(18)
    pred = {cls: {img: [(b + rng.normal(0, 0.05, b.shape), float(rng.uniform()))
                        for b in boxes] + [(boxes[0] + 1.5, 0.35)]
                  for img, boxes in per.items()} for cls, per in gt.items()}
    recs, precs, aps = ev.eval_det(pred, gt, ovthresh=0.25, result_dir=out)
    aps07 = ev.eval_det(pred, gt, ovthresh=0.25, use_07_metric=True)[2]
    rec, prec = np.array([0.1, 0.2, 0.5, 1.0]), np.array([1.0, 1.0, 0.8, 0.6])
    rows = np.hstack([rng.uniform(-2, 2, (3, 8)), np.array([[0.0, 1.0]] * 3)])
    np.savetxt(os.path.join(out, "chair_gt_boxes.dat"), rows)
    np.savetxt(os.path.join(out, "chair_gt_imgids.txt"), [3, 3, 4])
    files = _files(out)
    return (gt, recs, precs, aps, aps07, ev.voc_ap(rec, prec),
            ev.voc_ap(rec, prec, use_07_metric=True),
            files["sunrgbd_ap.json"], sorted(k for k in files if k.endswith(".png")),
            ev.load_matlab_gt_cls(out, "chair"))


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
    "data.prep_util": case_prep_util,
    "kitti_synthetic": case_kitti_synthetic,
    "kitti_synthetic_people": case_kitti_synthetic_people,
    "kitti_calib_and_object": case_kitti_calib_and_object,
    "kitti_prepare": case_kitti_prepare,
    "kitti_prepare_refine": case_kitti_prepare_refine,
    "core.box_overlaps": case_box_overlaps,
    "provider_refine_items": case_provider_refine_items,
    "sunrgbd_synthetic": case_sunrgbd_synthetic,
    "sunrgbd_calib_and_object": case_sunrgbd_calib_and_object,
    "sunrgbd_prepare": case_sunrgbd_prepare,
    "sunrgbd_ingest": case_sunrgbd_ingest,
    "provider_sunrgbd_items": case_provider_sunrgbd_items,
    "sunrgbd_eval": case_sunrgbd_eval,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_matches_original(name, splits, tmp_path, monkeypatch, request):
    case = CASES[name]
    extra = {"scalar_writer": lambda: (monkeypatch,),
             "sunrgbd_ingest": lambda: (request.getfixturevalue("mini_toolbox"),)}
    results = []
    for pkg in (JAX_PKG, PORT):
        out = tmp_path / pkg
        out.mkdir()
        results.append(case(pkg, splits, str(out), *extra.get(name, tuple)()))
    assert_same(*results)


@pytest.mark.parametrize("name,module,cls", [
    ("provider_sample_refine", "data.provider_refine", "FrustumRefineProvider"),
    ("provider_sample_sunrgbd", "data.provider_sunrgbd", "FrustumSunrgbdProvider")])
def test_ported_providers_resolve(name, module, cls):
    """The refine and SUN-RGBD provider names resolve to the port's own
    classes."""
    registry = _mod(PORT, "data.registry")
    got = registry.get_provider_class(_cfg(PORT, overrides=["DATA.FILE", name]))
    assert got is getattr(_mod(PORT, module), cls) and got.name == name
    assert got.__module__ == f"{PORT}.{module}"


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
                "parallel.mesh",
                "engine.train", "engine.test", "engine.test_sunrgbd",
                "engine.checkpoints", "tools.profile_stages"}
    untested = [m for m in copied if m not in port_own and f'"{m}"' not in source]
    assert copied and not untested, untested
