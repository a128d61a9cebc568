"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources into a shared library with a plain C
interface at first use, under ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags (a changed source is a
new file; an unchanged one is built once per checkout). ``ctypes`` loads it.
Every pointer and the stream cross as ``c_void_p``; each C function returns
the ``cudaError_t`` of its launch, and :func:`check` raises on anything but
0. Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "topk_twophase.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default install prefix
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found: the two-phase search kernels are compiled from "
        "image_search_engine_tpu_torch/csrc at first use on a CUDA device and "
        "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"topk_twophase-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless this exact build exists. Returns the
    library path and the seconds spent compiling (0.0 when it existed).
    The compiler's output (registers, shared memory, spills per kernel)
    is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ise_groupmin.argtypes = [i, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_groupmin.restype = i
            lib.ise_select_topt.argtypes = [p, p, p, i, i, i, p]
            lib.ise_select_topt.restype = i
            lib.ise_rescore.argtypes = [i, p, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_rescore.restype = i
            lib.ise_error_string.argtypes = [i]
            lib.ise_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().ise_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
