"""ctypes bindings for the repo's C++ host library, ``native/src/slode_native.cc``
(the JAX package's ``native/__init__.py``, without JAX): the plate-reader CSV
parse of the proc pipeline and the epoch packer (a row gather with zero
padding).

The library is built at first use with the flags of ``native/Makefile`` into
``build/native/libslode_native.so``, apart from the JAX package's
``native/build/``, and again whenever the source is newer. The compiler
writes to a name of its own process and the result is moved into place with
``os.replace``, so a process that loads the library never finds half a file,
however many build it at once. :func:`lib` returns None where no compiler is
found or the build fails, and the callers then take their Python paths, which
compute the same; :func:`build` raises instead, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO, "native", "src", "slode_native.cc")
LIBRARY = os.path.join(REPO, "build", "native", "libslode_native.so")
# native/Makefile's CXXFLAGS, and -shared
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()  # the proc files are parsed in threads: one builds, the others wait


def compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else g++) if it is on PATH."""
    return shutil.which(os.environ.get("CXX", "g++"))


def build() -> str:
    """Build the library if it is missing or older than its source, and
    return its path. Raises RuntimeError when there is no compiler or it
    fails."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler on PATH (CXX={os.environ.get('CXX', 'g++')})")
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {LIBRARY} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _bind(path: str) -> ctypes.CDLL:
    L = ctypes.CDLL(path)
    L.slode_proc_parse.restype = ctypes.c_void_p
    L.slode_proc_parse.argtypes = [ctypes.c_char_p] * 4
    L.slode_proc_rows.restype = ctypes.c_int64
    L.slode_proc_rows.argtypes = [ctypes.c_void_p]
    L.slode_proc_times_len.restype = ctypes.c_int64
    L.slode_proc_times_len.argtypes = [ctypes.c_void_p]
    L.slode_proc_error.restype = ctypes.c_char_p
    L.slode_proc_error.argtypes = [ctypes.c_void_p]
    L.slode_proc_fill.restype = None
    L.slode_proc_fill.argtypes = [ctypes.c_void_p] * 5
    L.slode_proc_free.restype = None
    L.slode_proc_free.argtypes = [ctypes.c_void_p]
    L.slode_pack_epoch.restype = None
    L.slode_pack_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_void_p]
    return L


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(build())
            except (RuntimeError, OSError, subprocess.TimeoutExpired):
                _lib = None
        return _lib


def parse_proc_csv_native(path: str, devices, conditions, signals):
    """The native parse of one plate-reader CSV: (device_idx, treatments,
    times, observations) as ``data/proc.parse_file`` returns them, or None
    if the library is unavailable or no configured device appears."""
    L = lib()
    if L is None:
        return None
    h = L.slode_proc_parse(path.encode(), ";".join(devices).encode(), ";".join(conditions).encode(),
                           ";".join(signals).encode())
    if not h:
        return None
    try:
        err = L.slode_proc_error(h)
        if err:
            raise ValueError(f"native CSV parse failed for {path}: {err.decode()}")
        n = L.slode_proc_rows(h)
        T = L.slode_proc_times_len(h)
        if n == 0:
            return None
        obs = np.empty((n, len(signals), T), dtype=np.float32)
        treat = np.empty((n, len(conditions)), dtype=np.float32)
        dev = np.empty((n,), dtype=np.int32)
        times = np.empty((T,), dtype=np.float32)
        L.slode_proc_fill(h, obs.ctypes.data, treat.ctypes.data, dev.ctypes.data, times.ctypes.data)
        return dev.astype(int), treat, times, obs
    finally:
        L.slode_proc_free(h)


def pack_epoch_native(src: np.ndarray, perm: np.ndarray, padded_rows: int):
    """Rows of ``src`` gathered by ``perm`` (``padded_rows`` entries; an
    entry < 0 or past the last row gives a zero row), natively. Returns the
    packed float32 array, or None if the library is unavailable."""
    L = lib()
    if L is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.float32)
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    if perm.shape != (padded_rows,):
        raise ValueError(f"perm has shape {perm.shape}, expected ({padded_rows},)")
    row_elems = int(np.prod(src.shape[1:])) if src.ndim > 1 else 1
    dst = np.empty((padded_rows,) + src.shape[1:], dtype=np.float32)
    L.slode_pack_epoch(src.ctypes.data, src.shape[0], row_elems, perm.ctypes.data, padded_rows, dst.ctypes.data)
    return dst
