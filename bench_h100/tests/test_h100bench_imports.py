"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program, by whole top-level name."""

import ast
import os
import subprocess
import sys

import pytest

from bench_h100 import run

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.dirname(HERE)
ROOT = os.path.dirname(PACKAGE)
PROGRAM = "frustum_convnet_tpu_torch"


def imported_names(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    for folder, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(folder, name)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PACKAGE))
def test_no_guarded_import(path):
    names = imported_names(path)
    assert not names & set(run.GUARDED), names & set(run.GUARDED)
    if os.path.relpath(path, PACKAGE).startswith("reference"):
        assert PROGRAM not in names


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "frustum_convnet_tpu_torch_lookalike", sys)
    assert "frustum_convnet_tpu" not in run.guarded_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.guarded_modules() == ["jaxlib"]


def test_a_cpu_run_leaves_no_guarded_module():
    code = ("import argparse, sys, torch, pytest\n"
            "from bench_h100 import run\n"
            "from bench_h100.tests import tiny\n"
            "mp = pytest.MonkeyPatch(); tiny.apply(mp)\n"
            "a = argparse.Namespace(workload='kitti_car.train_f32_b128', seed=3, seconds=0.1, trace=0)\n"
            "r = run.run_cell(a, device=torch.device('cpu'), log=lambda m: None)\n"
            "print(run.guarded_modules(), r['correct'] in (True, False))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                          "kitti_car.serve_g8b32", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    subprocess.run(["cp", "-r", PACKAGE, os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path)],
                   check=True)
    out = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                          "kitti_car.serve_g8b32", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
