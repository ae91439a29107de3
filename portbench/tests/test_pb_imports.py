"""What the benchmark imports: never the JAX side (top-level names compared
whole, since the port's name begins with the JAX package's), and the
references nothing of the program; and the timed path refuses to run
without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "crispy_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_module_of_the_benchmark_imports_the_jax_side(path):
    assert not (_top_level_imports(path) & JAX_SIDE)


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    assert "crispy_tpu_torch" not in _top_level_imports(path)
    assert not any(isinstance(n, ast.ImportFrom) and n.level > 0 for n in ast.walk(tree))


def test_a_loaded_benchmark_holds_no_jax_module():
    code = ("import sys, importlib, pkgutil, portbench\n"
            "from portbench.run import forbidden_modules\n"
            "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
            "    if '.tests' not in m.name and not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "import crispy_tpu_torch.dsp.rnnoise.pipeline, crispy_tpu_torch.models.whisper\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench.run import forbidden_modules

    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "crispy_tpu_torch.probe", object())
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "crispy_tpu.probe", object())
    assert "crispy_tpu" in forbidden_modules()


def _run_bench(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "denoise-batch-s128", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_the_timed_path_refuses_to_run_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run_bench(ROOT, env)
    assert out.returncode != 0
    assert not out.stdout.strip(), out.stdout
    assert "CUDA device" in out.stderr


def test_without_the_program_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run_bench(tmp_path, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_result_line_keys():
    """The result object's keys, as ``run`` builds it on the CPU."""
    from portbench.cells import load_cell
    from portbench.run import run

    cell = load_cell("denoise-batch-s128")
    cell.traffic = json.loads(json.dumps(cell.traffic))
    cell.traffic.update(streams=8, seconds_per_stream=1, block_frames=50, pool=1)
    out = run(cell, 2**31 + 11, 0.1, False, "cpu")
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"denoise_x_realtime", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert set(out["check"]) == {"frames_off_pct"}
