"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
loaded with ``ctypes``. Libraries land in ``ray_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the sources and flags, so
an edit rebuilds and a stale build is never loaded. The build happens
at first use; ``build()`` runs one ``nvcc`` per source, all at once.

There is no fallback: a missing ``nvcc`` or a failed compile raises
``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for path in candidates:
        if path.is_file() and os.access(path, os.X_OK):
            return str(path)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels of ray_tpu_torch "
        "are built from source at first use and have no fallback")


def kernel_names() -> list[str]:
    return sorted(p.stem for p in SOURCE_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Build output for ``csrc/<name>.cu``, keyed by its sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SOURCE_DIR / f"{name}.cu", *sorted(SOURCE_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile each named kernel (default: all) that is not built yet,
    one ``nvcc`` per source, all started together. Returns the compiler
    output (``-Xptxas=-v``: registers, shared memory, spills) by name."""
    names = kernel_names() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(SOURCE_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failures = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {name}.cu: nvcc exited "
                            f"{proc.returncode}\n{log}")
    if failures:
        raise RuntimeError("building CUDA kernels failed:\n"
                           + "\n".join(failures))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
