"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles every source to an object file, all of them
at once in parallel, and links them into one shared library with a plain C
interface, under ``build/kernels/`` at the root of the checkout, named by a
hash of the sources, headers and flags (a changed source is a new file; an
unchanged one is built once per checkout). ``ctypes`` loads it.
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
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
SOURCES = (_CSRC / "topk_twophase.cu", _CSRC / "topk_twophase_q8.cu",
           _CSRC / "ivf_probed_scan.cu", _CSRC / "kmeans_assign.cu",
           _CSRC / "topk_running.cu", _CSRC / "topk_merged.cu", _CSRC / "groupmin_variants.cu",
           _CSRC / "groupmin_width_mma.cu", _CSRC / "groupmin_two_level_mma.cu",
           _CSRC / "rescore_variants.cu", _CSRC / "groupmin_tf32.cu",
           _CSRC / "select_topt.cu")
HEADERS = (_CSRC / "scoring.cuh", _CSRC / "select.cuh", _CSRC / "mma.cuh",
           _CSRC / "groupmin_mma.cuh", _CSRC / "wgmma.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default install prefix
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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
        "nvcc not found: the search and k-means kernels are compiled from "
        "image_search_engine_tpu_torch/csrc at first use on a CUDA device and "
        "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"ise_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless this exact build exists: one ``nvcc -c``
    per source, all started together, then one link. Returns the library
    path and the seconds spent (0.0 when it existed). The compiler's output
    (registers, shared memory, spills per kernel) is kept beside the
    library as ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(SOURCES, procs)]
        failed = [src.name for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        tmp = Path(tmpdir) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".log").write_text("\n".join(logs) + link.stdout + link.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ise_groupmin.argtypes = [p, p, p, p, i, ll, i, i, i, p]
            lib.ise_groupmin.restype = i
            lib.ise_groupmin_mma.argtypes = [p, p, p, p, i, ll, i, i, i, i, i, i, i, i, p]
            lib.ise_groupmin_mma.restype = i
            lib.ise_groupmin_tf32.argtypes = [p, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_groupmin_tf32.restype = i
            lib.ise_select_topt.argtypes = [p, p, p, i, i, i, p]
            lib.ise_select_topt.restype = i
            lib.ise_select_radix.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
            lib.ise_select_radix.restype = i
            lib.ise_rescore.argtypes = [p, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_rescore.restype = i
            lib.ise_rescore_mma.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, i, i, p]
            lib.ise_rescore_mma.restype = i
            lib.ise_rescore_tf32.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_rescore_tf32.restype = i
            lib.ise_groupmin_q8.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_groupmin_q8.restype = i
            lib.ise_groupmin_q8_mma.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, i, i, i, i, i, p]
            lib.ise_groupmin_q8_mma.restype = i
            lib.ise_rescore_q8.argtypes = [p, p, p, p, p, p, p, p, i, ll, i, i, i, p]
            lib.ise_rescore_q8.restype = i
            lib.ise_group_order.argtypes = [p, p, p, p, i, i, p]
            lib.ise_group_order.restype = i
            lib.ise_probed_scan.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.ise_probed_scan.restype = i
            lib.ise_probed_scan_bucket.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                                   i, i, i, p]
            lib.ise_probed_scan_bucket.restype = i
            lib.ise_kmeans_assign.argtypes = [p, p, p, p, p, p, i, ll, i, i, ll, ll, p]
            lib.ise_kmeans_assign.restype = i
            lib.ise_topk_running.argtypes = [i, p, p, p, p, p, p, p, i, ll, i, i, i, i, i, p]
            lib.ise_topk_running.restype = i
            lib.ise_topk_merged.argtypes = [i, p, p, p, p, p, p, p, i, ll, i, i, i, i, p]
            lib.ise_topk_merged.restype = i
            lib.ise_groupmin_width.argtypes = [p, p, p, p, i, ll, i, i, i, i, p]
            lib.ise_groupmin_width.restype = i
            lib.ise_groupmin_width_mma.argtypes = [p, p, p, p, i, ll, i, i, i, i, i, i, i, i, i,
                                                   p]
            lib.ise_groupmin_width_mma.restype = i
            lib.ise_groupmin_two_level.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, p]
            lib.ise_groupmin_two_level.restype = i
            lib.ise_groupmin_two_level_mma.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, i, i, i,
                                                       i, i, p]
            lib.ise_groupmin_two_level_mma.restype = i
            lib.ise_groupmin_chunked.argtypes = [p, p, p, p, i, ll, i, i, p]
            lib.ise_groupmin_chunked.restype = i
            lib.ise_rescore_gather.argtypes = [p, p, p, p, i, ll, i, i, i, i, p]
            lib.ise_rescore_gather.restype = i
            lib.ise_rescore_cross.argtypes = [p, p, p, p, i, ll, i, i, i, i, p]
            lib.ise_rescore_cross.restype = i
            lib.ise_error_string.argtypes = [i]
            lib.ise_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().ise_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")
