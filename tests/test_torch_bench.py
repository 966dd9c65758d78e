"""The port's benchmark (``frustum_convnet_tpu_torch/bench.py``,
``tools/bench_models.py``, ``tools/bench_driver.py``) against the
repository's JAX bench, on the CPU.

The analytic FLOPs and the bench's constants must equal the JAX file's (the
constants read from it with ``ast``, as ``tests/test_torch_protocol.py``
reads its recipes), the amortized and cadence rates must equal its
expressions, and the last line must carry its keys, with its nesting, plus
``device`` and ``skipped``. The bench runs at the tests' tiny shapes
(``tests/torch_bench_tiny.py``) with one iteration and one trial; its times
here are the CPU's and are only checked to be finite and positive.
"""

import ast
import importlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from frustum_convnet_tpu_torch import bench, configs
from frustum_convnet_tpu_torch.tools import bench_driver, bench_models
from torch_bench_tiny import BATCHES, tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_NAMES = ("det_sample", "det_sample_people", "refine_car", "refine_people",
             "det_sample_sunrgbd")
ONE = ["--device", "cpu", "--iters", "1", "--trials", "1"]


def _jax_tree():
    with open(os.path.join(ROOT, "bench.py")) as f:
        return ast.parse(f.read())


def _jax_constant(name: str):
    return next(ast.literal_eval(node.value) for node in _jax_tree().body
                if isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets] == [name])


def _function(tree, name: str) -> ast.FunctionDef:
    return next(node for node in ast.walk(tree)
                if isinstance(node, ast.FunctionDef) and node.name == name)


def _assigned(func: ast.FunctionDef, target: str, mentions: str) -> ast.expr:
    """The expression ``func`` assigns to ``target`` that names ``mentions``."""
    return next(node.value for node in ast.walk(func)
                if isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets] == [target]
                and mentions in ast.unparse(node.value))


def _eval(expr: ast.expr, **names):
    return eval(compile(ast.Expression(expr), "bench.py", "eval"), {}, names)


def _last_line_keys():
    """{key: nested key set or None} of the dict literal the JAX ``main``
    prints, with ``**hw(...)`` expanded to the keys ``hw`` returns."""
    main = _function(_jax_tree(), "main")
    hw_keys = {k.value for k in next(node.value for node in ast.walk(_function(main, "hw"))
                                     if isinstance(node, ast.Return)).keys}
    literal = next(node.args[0].args[0] for node in ast.walk(main)
                   if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print")

    def keys(d: ast.Dict) -> dict:
        out = {}
        for k, v in zip(d.keys, d.values):
            if k is None:
                out.update(dict.fromkeys(hw_keys))
            else:
                out[k.value] = keys(v) if isinstance(v, ast.Dict) else None
        return out

    return keys(literal)


def _port_spec(name: str):
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(os.path.join(ROOT, "cfgs", name + ".yaml"), cfg)
    return configs.get_model_spec(cfg)


@pytest.mark.parametrize("name", CFG_NAMES)
def test_flops_per_frustum_equals_jax(name):
    """(a) The analytic forward FLOPs of each config, on each package's own
    spec, are equal."""
    jax_bench = importlib.import_module("bench")
    from frustum_convnet_tpu.configs import config as jax_config
    from frustum_convnet_tpu.models.registry import get_model_spec

    cfg = jax_config.get_default_cfg()
    jax_config.merge_cfg_from_file(os.path.join(ROOT, "cfgs", name + ".yaml"), cfg)
    want = jax_bench.flops_per_frustum(get_model_spec(cfg))
    got = bench.flops_per_frustum(_port_spec(name))
    assert type(got) is float and got == want and got > 1e8


def test_constants_equal_jax():
    """(b) The bench's constants equal the JAX file's; the recipes in their
    first six fields (the notes name the port's own protocol runs)."""
    for name in ("PROTOCOL_EPOCHS", "PER_CONFIG_YAMLS", "BATCHES", "TRAIN_BATCHES",
                 "TRAIN_FLOPS_MULT", "ITERS", "TRIALS", "REF_GPU_FRUSTUMS_PER_SEC",
                 "REF_GPU_TRAIN_FRUSTUMS_PER_SEC", "BASELINE_ESTIMATE"):
        assert getattr(bench, name) == _jax_constant(name), name
    jax_rows = _jax_constant("SUPPORTED_TRAIN_RECIPES")
    assert [row[:6] for row in bench.SUPPORTED_TRAIN_RECIPES] == [row[:6] for row in jax_rows]
    assert all("PERF.md §5" in row[6] for row in bench.SUPPORTED_TRAIN_RECIPES)
    assert set(bench.SEED_APS) == {row[:2] for row in jax_rows}


def test_amortized_and_cadence_rates_equal_jax_expressions():
    """(c) The f16 recipe's amortized rate and the metric-cadence mix equal
    the JAX bench's expressions on fixed inputs; the amortized peak lies
    between its legs' peaks and makes the MFU the FLOPs over what the two
    legs' times allow."""
    tree = _jax_tree()
    amortized = _assigned(_function(tree, "main"), "fps", "PROTOCOL_EPOCHS")
    cadence = _assigned(_function(tree, "scan_bench_train"), "t", "metric_interval")
    for half, f32, ft in ((3412.5, 1530.25, 40), (900.0, 1100.0, 10), (77.7, 12.5, 49)):
        want = _eval(amortized, PROTOCOL_EPOCHS=50, f32_ft=ft, fps=half, f32_fps=f32)
        assert bench.amortized_rate(half, f32, ft) == want
        peak = bench.amortized_peak(half, f32, ft, 989e12, 67e12)
        assert 67e12 < peak < 989e12
        t_half, t_f32 = (50 - ft) / half, ft / f32
        flops = 50 * 2.977e9 * 3.0
        mfu = bench.hw(want, 2.977e9, peak, 3.0)["mfu_pct"]
        assert math.isclose(mfu, 100 * flops / (989e12 * t_half + 67e12 * t_f32), rel_tol=1e-12)
    assert bench.amortized_peak(5.0, 3.0, 0, 989e12, 67e12) == 989e12
    assert bench.amortized_peak(5.0, 3.0, 50, 989e12, 67e12) == 67e12
    for free, metric, interval in ((0.0551, 0.0712, 50), (0.2, 0.9, 7), (1.0, 2.0, 2)):
        times = {False: free, True: metric}
        want = _eval(cadence, metric_interval=interval, time_step=times.__getitem__)
        assert bench.cadence_seconds(free, metric, interval) == want


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _numbers(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _numbers(v, f"{path}.{k}" if path else k)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def test_main_prints_jax_keys_and_positive_rates(monkeypatch, capsys, tmp_path):
    """(d) ``main`` at tiny shapes prints a parseable line for each block
    as it goes, then the last line: its key set, and ``train_throughput``'s
    and ``serving_batch32``'s, are the JAX literal's plus ``device`` and
    ``skipped``; every rate, TFLOP/s and MFU is finite and positive, and
    ``BENCH_TRACE_DIR`` gets a trace for each inference batch."""
    tiny(bench, monkeypatch.setattr)
    monkeypatch.setenv("BENCH_TRACE_DIR", str(tmp_path))
    res = bench.main(ONE)
    lines = _json_lines(capsys.readouterr().out)
    *blocks, last = lines
    assert blocks == res["blocks"] and last == res["result"]
    names = [b["block"] for b in blocks]
    assert names == ([f"infer_b{b}" for b in BATCHES] + ["serving_batch32"]
                     + [f"train_float32_b{b}" for b in BATCHES]
                     + ["train_bfloat16_b2", "train_float16_b4_ft40"]
                     + [f"per_config_{n}" for n in bench.PER_CONFIG_YAMLS]
                     + ["refine_train_float32_b2", "refine_train_bfloat16_b2"])
    for b in blocks:
        assert all(math.isfinite(b[k]) and b[k] > 0
                   for k in ("value", "tflops_per_sec", "mfu_pct", "seconds")), b
        assert b["launches"] == 0 and b["peak_mib"] is None  # the plain version here
    f16 = blocks[names.index("train_float16_b4_ft40")]
    assert f16["value"] == bench.amortized_rate(f16["half_fps"], f16["float32_fps"], 40)
    assert f16["float32_fps"] == blocks[names.index("train_float32_b4")]["value"]

    want = _last_line_keys()
    assert set(last) == set(want) | {"device", "skipped"}
    for nested in ("train_throughput", "serving_batch32"):
        assert set(last[nested]) == set(want[nested]), nested
    assert last["device"] == "cpu" and last["skipped"] == []
    assert last["value"] == max(last["per_batch"].values())
    assert last["train_throughput"]["recipe"]["ap_validated"] is True
    rates = [(p, x) for p, x in _numbers(last)
             if not p.startswith(("baseline_estimate", "train_throughput.recipe"))]
    assert len(rates) > 20 and all(math.isfinite(x) and x > 0 for _, x in rates), rates
    assert sorted(os.listdir(tmp_path)) == sorted(f"b{b}.json" for b in BATCHES)


def test_budget_skips_later_blocks(monkeypatch, capsys):
    """(e) A budget spent before the second block: the first inference block
    runs, every later one is null in the last line and listed under
    ``skipped``, and the last line still parses with its keys."""
    tiny(bench, monkeypatch.setattr)
    bench.main(ONE + ["--budget", "0"])
    *blocks, last = _json_lines(capsys.readouterr().out)
    assert [b["block"] for b in blocks] == [f"infer_b{BATCHES[0]}"]
    assert last["skipped"] == ([f"infer_b{BATCHES[1]}", "serving_batch32"]
                               + [f"train_float32_b{b}" for b in BATCHES]
                               + ["train_bfloat16_b2", "train_float16_b4_ft40"]
                               + [f"per_config_{n}" for n in bench.PER_CONFIG_YAMLS]
                               + ["refine_train_float32_b2", "refine_train_bfloat16_b2"])
    assert last["value"] == blocks[0]["value"] and last["batch"] == BATCHES[0]
    assert last["per_batch"] == {str(BATCHES[0]): blocks[0]["value"], str(BATCHES[1]): None}
    assert last["serving_batch32"]["value"] is None
    assert last["serving_batch32"]["mfu_pct"] is None
    assert set(last) == set(_last_line_keys()) | {"device", "skipped"}
    train = last["train_throughput"]
    assert train["value"] is None and train["recipe"] is None
    assert set(train["per_batch"].values()) == {None}
    assert set(last["per_config_batch256"].values()) == {None}
    assert set(last["train_throughput_refine"].values()) == {None}


@pytest.mark.parametrize("tool,argv", [
    (bench, []), (bench_models, ["--only", "refine_people"]),
    (bench_driver, ["--frames", "2"])], ids=["bench", "bench_models", "bench_driver"])
def test_cuda_is_the_default_and_raises_without_a_card(tool, argv):
    """(f) Each tool defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(argv + ["--device", "cuda"])


def test_bench_runs_as_a_file_and_raises_without_a_card():
    """The bench runs as ``python frustum_convnet_tpu_torch/bench.py``: it
    imports the package from the repository root and raises without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = subprocess.run([sys.executable, os.path.join("frustum_convnet_tpu_torch", "bench.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "RuntimeError: no CUDA card is visible" in proc.stderr, proc.stderr[-2000:]


def _tiny_model():
    tiny_cfg = configs.get_default_cfg()
    configs.merge_cfg_from_list(["MODEL.FILE", "det_base", "DATA.WITH_EXTRA_FEAT", "False",
                                 "DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "16"], tiny_cfg)
    spec = configs.get_model_spec(tiny_cfg)
    return spec, bench.seeded_model(spec, torch.device("cpu"))


def test_chained_inference_returns_the_plain_sum():
    """(g) The chained loop's carry after one call is the plain call's sum,
    and after two calls (the second on ``pts + carry * 1e-20``) within 1e-6
    relative of it."""
    spec, model = _tiny_model()
    step, plain = bench.infer_chain(model, spec, 3)
    want = plain()
    assert want.dtype == torch.float32 and want.dim() == 0 and torch.isfinite(want)
    assert torch.equal(step(), want)
    got = step()
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())


def test_each_train_trial_starts_from_the_same_state(monkeypatch):
    """(h) Every trial of both timed steps (metrics off and on) starts from
    the model's initial parameters, BatchNorm statistics and an empty Adam
    state at schedule count 0, the steps do move them, and the model is
    left in its initial state."""
    spec, model = _tiny_model()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    starts, ends = [], []
    real = bench.time_calls

    def spy(fn, device, iters, trials, before_trial=None):
        def trial():
            if starts:
                ends.append({k: v.clone() for k, v in model.state_dict().items()})
            before_trial()
            starts.append({k: v.clone() for k, v in model.state_dict().items()})
        return real(fn, device, iters, trials, before_trial=trial)

    opts = []
    make = bench.ts.make_optimizer
    monkeypatch.setattr(bench.ts, "make_optimizer", lambda *a: opts.append(make(*a)) or opts[-1])
    monkeypatch.setattr(bench, "time_calls", spy)
    rate = bench.scan_bench_train(model, spec, 2, iters=2, trials=3)
    assert math.isfinite(rate) and rate > 0
    assert len(starts) == 6 and len(opts) == 2
    for state in starts:
        assert all(torch.equal(state[k], init[k]) for k in init)
    assert ends and all(any(not torch.equal(e[k], init[k]) for k in init) for e in ends)
    assert all(torch.equal(v, init[k]) for k, v in model.state_dict().items())
    assert all(not opt.state and opt.param_groups[0]["schedule_count"] == 0 for opt in opts)


def test_time_calls_runs_before_trial_untimed_before_each_trial():
    """``utils.timing.time_calls``: one warm-up call, then ``trials`` runs of
    ``iters`` calls, each run preceded by ``before_trial()``; the best
    seconds a call is finite and positive."""
    from frustum_convnet_tpu_torch.utils.timing import time_calls

    log = []
    best = time_calls(lambda: log.append("call"), torch.device("cpu"), 2, 3,
                      before_trial=lambda: log.append("restore"))
    assert log == ["call"] + ["restore", "call", "call"] * 3
    assert math.isfinite(best) and best > 0


def test_bench_secondary_config_builds_the_config_in_its_dtype(monkeypatch):
    """``bench_secondary_config`` returns the config's own spec, the
    config's compute dtype unless one is given, and a positive rate, for
    inference and for the train step."""
    tiny(bench, monkeypatch.setattr)
    want = configs.get_model_spec(bench.load_cfg("refine_car"))
    spec, dtype, fps = bench.bench_secondary_config("refine_car", 2, iters=1, trials=1,
                                                    device="cpu")
    assert spec == want and dtype == torch.float32 and math.isfinite(fps) and fps > 0
    spec, dtype, fps = bench.bench_secondary_config("refine_car", 2, iters=1, train=True,
                                                    dtype=torch.bfloat16, trials=1,
                                                    device="cpu")
    assert spec == want and dtype == torch.bfloat16 and math.isfinite(fps) and fps > 0


def test_bench_models_prints_its_row_and_table(capsys):
    """(i) ``tools/bench_models.py --only refine_people --batches 2 --iters 1
    --device cpu`` prints the config's row as it goes, then the table."""
    rows = bench_models.main(["--only", "refine_people", "--batches", "2", "--iters", "1",
                              "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [r[0] for r in rows] == ["refine_people"] and rows[0][2][2] > 0
    row = next(line for line in out if line.startswith("refine_people "))
    assert "N=512 scales=4 sections=240" in row and "b2:" in row
    table = out[out.index("| config | shapes | batch 2 |"):]
    assert table[1] == "|---|---|---|"
    assert table[2].startswith("| refine_people | N=512 scales=4 sections=240 | ")


def test_bench_driver_prints_a_stats_line(capsys, tmp_path):
    """(j) ``tools/bench_driver.py --frames 8 --cars 1 --sweep 1:1 --device
    cpu`` streams the synthetic split and prints one stats line."""
    argv = ["--frames", "8", "--cars", "1", "--sweep", "1:1", "--device", "cpu",
            "--cache", str(tmp_path)]
    lines = bench_driver.main(argv)
    printed = _json_lines(capsys.readouterr().out)
    assert printed == lines and len(lines) == 1
    line = lines[0]
    assert line["frustums"] > 0 and line["overflow_reruns"] == 0
    assert np.isfinite(line["frustums_per_s"]) and line["frustums_per_s"] > 0
    assert (line["group"], line["inflight"], line["points_dtype"]) == (1, 1, "float16")
    assert os.path.isdir(os.path.join(tmp_path, [d for d in os.listdir(tmp_path)
                                                 if d.startswith("bench_driver_")][0]))
