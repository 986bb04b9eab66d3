"""Rules of the port package itself.

* ``ray_tpu_torch``, ``chip_smoke.py`` and ``bwd_fault_check.py`` import
  neither jax nor the JAX package (the port keeps its own copy of what
  it needs); the port starts processes with the ``spawn`` method only,
  in ``parallel/launch.py``.
* Entry points run on CUDA unless the caller asks for the CPU: without
  CUDA, ``device=None`` raises instead of carrying on on the CPU.
* The CUDA kernels build from source with nvcc and have no fallback: no
  nvcc, or a failed compile, raises with the compiler's output. A build
  is keyed by its source and the shared headers.
"""

import ast
from pathlib import Path

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "ray_tpu_torch"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_ray_tpu():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "bwd_fault_check.py"]
    assert len(files) > 10
    bad = [(f.relative_to(REPO).as_posix(), mod) for f in files
           for mod in _imported_roots(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "ray_tpu")]
    assert bad == []


PARALLEL_MODULES = ("__init__", "collectives", "launch", "mesh", "moe",
                    "pipeline", "ring_attention", "sharding", "ulysses")


def _start_methods(path: Path):
    """String arguments of every multiprocessing get_context /
    set_start_method call in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", getattr(node.func, "id", None))
                in ("get_context", "set_start_method")):
            yield from (a.value for a in node.args
                        if isinstance(a, ast.Constant))


def test_parallel_modules_import_no_jax_and_only_spawn():
    files = sorted((PKG / "parallel").glob("*.py"))
    assert [f.stem for f in files] == list(PARALLEL_MODULES)
    bad = [(f.name, mod) for f in files for mod in _imported_roots(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "ray_tpu")]
    assert bad == []
    methods = [(f.name, m) for f in sorted(PKG.rglob("*.py"))
               + [REPO / "chip_smoke.py"] for m in _start_methods(f)]
    assert methods == [("launch.py", "spawn")]


def test_resolve_device_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ray_tpu_torch.entry()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_LIBS", {})
    return tmp_path


def test_build_without_nvcc_raises(build_dir, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(build_dir))
    monkeypatch.setattr(kernels, "DEFAULT_CUDA_HOME", build_dir / "none")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library("flash_fwd")
    assert not (build_dir / "build").exists()


def test_failed_compile_raises_with_compiler_output(build_dir, monkeypatch):
    bindir = build_dir / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'flash_fwd.cu(1): error: no card'\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(build_dir / "cuda"))
    with pytest.raises(RuntimeError, match="no card"):
        kernels.build()
    assert list((build_dir / "build").iterdir()) == []


def test_library_name_tracks_sources():
    path = kernels.library_path("flash_fwd")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert kernels.kernel_names() == ["flash_bwd", "flash_bwd_sm90",
                                      "flash_fwd", "flash_fwd_sm90",
                                      "sched_scan"]


def test_library_name_tracks_the_shared_header(tmp_path, monkeypatch):
    # the sm90 kernels include csrc/sm90.cuh: an edit there rebuilds them
    src = tmp_path / "csrc"
    src.mkdir()
    for f in kernels.SOURCE_DIR.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "SOURCE_DIR", src)
    before = {n: kernels.library_path(n) for n in kernels.kernel_names()}
    header = src / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernels.library_path(n) for n in kernels.kernel_names()}
    assert all(before[n] != after[n] for n in before)
