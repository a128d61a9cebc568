"""ctypes bindings for the native C++ image loader (native/).

A copy of the JAX package's ``utils/native_loader.py``, building the same
sources at the repository root (``native/``, which belongs to neither
package). PNG (zlib), BMP, PPM and baseline JPEG decoders plus bilinear
resize run in a GIL-free C++ thread pool. Builds the shared library on
first use with the system toolchain; any failure (missing g++, unsupported
format) falls back to the PIL path in utils/imageio.py.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libise_loader.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "libise_loader.so"], cwd=_NATIVE_DIR, check=True,
            capture_output=True, timeout=300,
        )
        return True
    except Exception as e:  # noqa: BLE001
        log.warning("native loader build failed (%s); falling back to PIL", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        # run make even when the .so exists: it is timestamp-checked, so
        # this is a no-op unless loader.cpp changed (stale-binary guard)
        if not _build() and not _LIB_PATH.exists():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError as e:
            log.warning("native loader dlopen failed: %s", e)
            _build_failed = True
            return None
        lib.ise_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ise_decode_file.restype = ctypes.c_int
        lib.ise_decode_bytes.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ise_decode_bytes.restype = ctypes.c_int
        lib.ise_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.ise_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.ise_load_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decode_file(path: str | Path) -> Optional[np.ndarray]:
    """Decode one image -> (H, W, 3) uint8 RGB, or None if undecodable."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ise_decode_file(str(path).encode(), ctypes.byref(out),
                             ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    n = h.value * w.value * 3
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy().reshape(h.value, w.value, 3)
    lib.ise_free(out)
    return arr


def decode_bytes(data: bytes) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ise_decode_bytes(data, len(data), ctypes.byref(out),
                              ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    n = h.value * w.value * 3
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy().reshape(h.value, w.value, 3)
    lib.ise_free(out)
    return arr


def load_batch(
    paths: Sequence[str | Path], height: int, width: int, n_threads: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode+resize a batch in C++ threads.

    Returns ((n, H, W, 3) float32 in [0,1], (n,) bool ok-flags). Requires
    the native library (call ``available()`` first).
    """
    lib = get_lib()
    assert lib is not None, "native loader unavailable"
    n = len(paths)
    out = np.zeros((n, height, width, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.ise_load_batch(
        c_paths, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )
    return out, ok.astype(bool)


def load_batch_u8(
    paths: Sequence[str | Path], height: int, width: int, n_threads: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Like ``load_batch`` but keeps pixels uint8 ((n, H, W, 3), rounded
    post-resize) so the device upload moves 4x fewer bytes; the [0,1]
    cast happens on the device (ops/image_ops)."""
    lib = get_lib()
    assert lib is not None, "native loader unavailable"
    n = len(paths)
    out = np.zeros((n, height, width, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.ise_load_batch_u8(
        c_paths, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )
    return out, ok.astype(bool)
