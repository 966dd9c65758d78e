"""The serving and training spans (``frustum_convnet_tpu_torch/utils/trace.py``)
on the CPU.

``engine.test.run_test`` and ``engine.train.run_epoch_train`` run at a tiny
size on a labeled synthetic split (``chip_smoke.make_train_split``), once
under ``torch.profiler`` (CPU activity only) and once with no profile
recording and ``record_function`` patched to raise:

* (a, b) every span is a ``user_annotation`` of the trace, nested under
  its call's root (``serve.call``, ``train.epoch``), and the step's own
  spans under ``train.step``; the counts are the call's groups, batches,
  steps and loader ``next()`` calls, and ``stats["spans"]`` counts what
  the trace holds;
* (c) with no profile recording a span never enters ``record_function``;
* (d) the detections and the trained state are the same with and without
  the profiler.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.engine import test as serve
from frustum_convnet_tpu_torch.engine import train as trainer
from frustum_convnet_tpu_torch.engine.loader import BatchLoader
from frustum_convnet_tpu_torch.models import det
from frustum_convnet_tpu_torch.parallel import train_step as ts
from frustum_convnet_tpu_torch.utils import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "det_sample.yaml")
TINY = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
        "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)",
        "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)"]
SERVE_BATCH, GROUP, VAL = 4, 2, 20  # 5 batches: 2 groups and a tail batch
TRAIN_BATCH, TRAIN = 8, 24  # 3 steps
DISP = METRIC_INTERVAL = 2


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profile recording")


def _annotations(prof, tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _serve(model, spec, dataset):
    return serve.run_test(model, spec, dataset, SERVE_BATCH, "nms", _logger(),
                          num_workers=1, group=GROUP, inflight=2,
                          points_dtype=torch.float32)


def _logger():
    logger = logging.getLogger("test_torch_trace")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def _train(spec, dataset, seed=4):
    model = trainer.FrustumConvNet(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    step_cfg = ts.TrainStepConfig(steps_per_epoch=TRAIN // TRAIN_BATCH)
    state = ts.TrainState(model, ts.make_optimizer(model.parameters(), step_cfg),
                          ts.multistep_lr(step_cfg))
    fast = ts.build_train_step_accum(spec, dataclasses.replace(step_cfg,
                                                               compute_metrics=False))
    step = trainer._Step(ts.build_train_step_accum(spec, step_cfg), torch.device("cpu"),
                         fast_fn=fast, loss_keys=det.LOSS_KEYS)
    loader = BatchLoader(dataset, TRAIN_BATCH, spec.num_scales, shuffle=True,
                         drop_last=True, seed=seed, num_workers=1)
    accum = ts.init_accum(det.LOSS_KEYS + det.metric_keys(step_cfg.iou_thresh),
                          torch.device("cpu"))
    avg, stats = trainer.run_epoch_train(step, state, accum, loader, 0, _logger(), None,
                                         DISP, metric_interval=METRIC_INTERVAL)
    return avg, stats, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Serving and one training epoch, each under the profiler and with no
    profile recording (``record_function`` patched to raise)."""
    work = tmp_path_factory.mktemp("torch_trace")
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(CFG, cfg)
    configs.merge_cfg_from_list(TINY, cfg)
    spec = configs.get_model_spec(cfg)
    pickle_dir = str(work / "pickles")
    chip_smoke.make_train_split(pickle_dir, spec, num_train=TRAIN, num_val=VAL)
    configs.merge_cfg_from_list(["DATA.DATA_ROOT", pickle_dir], cfg)
    train_ds, val_ds = trainer.make_datasets(cfg)
    model = trainer.FrustumConvNet(spec)
    model.reset_parameters(torch.Generator().manual_seed(3))

    out = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["serve_traced"] = _serve(model, spec, val_ds)
    out["serve_events"] = _annotations(prof, work, "serve")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["train_traced"] = _train(spec, train_ds)
    out["train_events"] = _annotations(prof, work, "train")
    with pytest.MonkeyPatch.context() as mp:
        # the name a span calls (torch's own code, Adam's step among it,
        # calls torch.autograd.profiler's)
        mp.setattr(torch.profiler, "record_function", _raise)
        out["serve_plain"] = _serve(model, spec, val_ds)
        out["train_plain"] = _train(spec, train_ds)
    return out


def _trace_counts(events, prefix):
    counts: dict = {}
    for name, _, _ in events:
        if name.startswith(prefix):
            counts[name] = counts.get(name, 0) + 1
    return counts


def _inside(events, child, parent):
    """Each ``child`` event lies within some ``parent`` event."""
    parents = [(t0, t1) for n, t0, t1 in events if n == parent]
    kids = [(t0, t1) for n, t0, t1 in events if n == child]
    return bool(kids) and all(any(p0 <= c0 and c1 <= p1 for p0, p1 in parents)
                              for c0, c1 in kids)


def test_serve_spans_nest_under_the_call_and_count_its_parts(runs):
    """(a) Every serve span is an annotation under ``serve.call``; the counts
    are the groups, batches and ``next()`` calls, and the stats' counts are
    the trace's."""
    _, stats = runs["serve_traced"]
    spans, events = stats["spans"], runs["serve_events"]
    batches = -(-VAL // SERVE_BATCH)
    groups = -(-batches // GROUP)  # the tail group is padded and streamed as one
    assert {k: v["n"] for k, v in spans.items()} == {
        "serve.call": 1, "serve.start": 1, "serve.loader_wait": batches + 1,
        "serve.upload": groups, "serve.dispatch": groups, "serve.fetch": groups,
        "serve.postprocess": batches}
    assert _trace_counts(events, "serve.") == {k: v["n"] for k, v in spans.items()}
    for name in spans:
        if name != "serve.call":
            assert _inside(events, name, "serve.call"), name
    assert all(v["s"] >= 0 for v in spans.values())
    parts = sum(v["s"] for k, v in spans.items() if k != "serve.call")
    assert parts <= spans["serve.call"]["s"]


def test_serve_stats_count_the_fetches_that_waited(runs):
    """``fetch_waited`` counts the groups whose outputs were not back when
    the host came to fetch them: at most the groups, and none off a card,
    where nothing is copied back."""
    groups = -(-VAL // SERVE_BATCH) // GROUP
    for key in ("serve_traced", "serve_plain"):
        waited = runs[key][1]["fetch_waited"]
        assert 0 <= waited <= groups and waited == 0, key


def test_train_spans_nest_under_the_epoch_and_the_step(runs):
    """(b) Every train span is an annotation under ``train.epoch``; forward,
    backward and optimizer lie under ``train.step``; the counts are the
    steps, the ``next()`` calls and the disp-interval reads."""
    _, stats, _ = runs["train_traced"]
    spans, events = stats["spans"], runs["train_events"]
    steps = TRAIN // TRAIN_BATCH
    syncs = sum(1 for i in range(steps) if (i + 1) % DISP == 0 or i == 0) + 1
    assert stats["steps"] == steps
    assert {k: v["n"] for k, v in spans.items()} == {
        "train.epoch": 1, "train.loader_wait": steps + 1, "train.upload": steps,
        "train.step": steps, "train.forward": steps, "train.backward": steps,
        "train.optimizer": steps, "train.sync": syncs}
    assert _trace_counts(events, "train.") == {k: v["n"] for k, v in spans.items()}
    for name in spans:
        if name != "train.epoch":
            assert _inside(events, name, "train.epoch"), name
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert _inside(events, name, "train.step"), name


def test_no_annotation_without_a_profile(runs):
    """(c) With no profile recording both loops ran with ``record_function``
    raising, and still counted every span."""
    assert runs["serve_plain"][1]["spans"].keys() == runs["serve_traced"][1]["spans"].keys()
    plain = runs["train_plain"][1]["spans"]
    assert {k: v["n"] for k, v in plain.items()} == {
        k: v["n"] for k, v in runs["train_traced"][1]["spans"].items()}


def test_the_profiler_changes_no_result(runs):
    """(d) The same detections and the same trained state with and without
    the profiler."""
    assert runs["serve_traced"][0] == runs["serve_plain"][0]
    assert runs["serve_traced"][0]  # something was served
    avg_t, _, state_t = runs["train_traced"]
    avg_p, _, state_p = runs["train_plain"]
    assert avg_t == avg_p
    sd_p = state_p.model.state_dict()
    for k, v in state_t.model.state_dict().items():
        assert torch.equal(v, sd_p[k]), k
    assert state_t.spans is None and state_p.spans is None


def test_a_span_survives_the_profiler_starting_or_stopping_inside_it(monkeypatch):
    """A span entered with the profiler off closes no annotation when it is
    on at the exit; one entered while it records closes its own after it
    stopped; both count."""
    totals: dict = {}
    prof = profile(activities=[ProfilerActivity.CPU])
    with trace.span("outer", totals):
        prof.__enter__()
    with trace.span("inner", totals):
        prof.__exit__(None, None, None)
    assert {k: v["n"] for k, v in totals.items()} == {"outer": 1, "inner": 1}
    names = [e.name for e in prof.events()]
    assert "inner" in names and "outer" not in names
    items = list(trace.spanned(range(3), "wait", totals))
    assert items == [0, 1, 2] and totals["wait"]["n"] == 4
    with trace.span("off", None):  # no totals: nothing counted, nothing raised
        pass
    assert "off" not in totals
    np.testing.assert_array_less(-1e-12, [v["s"] for v in totals.values()])
