"""What a run loads: nothing of JAX or the JAX package (compared by
whole top-level names), and a reference that imports nothing of the
program."""

import ast
import subprocess
import sys

import pytest

from perfbench import core

ROOT = core.ROOT
BANNED_IN_REFERENCE = {"ray_tpu_torch", "ray_tpu", "jax", "jaxlib", "flax"}


def _python(code, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_loads_no_jax():
    out = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench.tests import tiny\n"
        "for cell in tiny.SERVE[:1] + tiny.TRAIN:\n"
        "    assert tiny.run(cell, seconds=0.3)['result']['correct']\n"
        "from perfbench import core\n"
        "assert 'ray_tpu_torch' in sys.modules\n"
        "print(core.forbidden_modules())\n")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert core.forbidden_modules() == [] or "ray_tpu" not in [
        m.split(".")[0] for m in core.forbidden_modules()]
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "ray_tpu_torch_extra" not in core.forbidden_modules()
    assert "jaxtyping_like" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ray_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert {"ray_tpu.models", "jax"} <= set(core.forbidden_modules())


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & \
                BANNED_IN_REFERENCE, (path.name, names)
    out = _python("import sys; sys.path.insert(0, '.')\n"
                  "import perfbench.reference.decoder\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & BANNED_IN_REFERENCE


def _no_result(out):
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_command_prints_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "serve.deepseek-llm-7b.long-decode", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    _no_result(out)
    assert "CUDA device" in out.stderr


def test_the_command_needs_the_program_beside_it(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "train.smollm2-1.7b.seq2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    _no_result(out)
    assert "ray_tpu_torch" in out.stderr
