"""ctypes binding of the multithreaded C++ npy batch loader (port of
egoego_release_tpu/data/native_loader.py).

``native/npy_loader.cpp`` is built with g++ at first use into
``build/native/`` beside the package (rebuilt when the source is newer than
the library), as the CUDA kernels are, never next to the source. As in the
JAX package, a machine without g++ reads through numpy, and a batch the
native loader fails on is read again by numpy, so that the error a caller
sees for a missing or malformed file is numpy's. ``counts`` records which
path read each batch ("native" or "numpy"), so that a run can show its
batches took the native path. ``data.formats.load_of_feats`` reads the
per-frame optical-flow features through it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from collections import Counter
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "npy_loader.cpp"
LIBRARY = PACKAGE_DIR.parent / "build" / "native" / "libegoego_npy_loader.so"

counts: Counter = Counter()  # batches read by each path
_lock = threading.Lock()
_lib: list = []  # [ctypes.CDLL or None] once a build was tried


def _build() -> Path | None:
    """The library, built when missing or older than its source; None when
    g++ is missing or fails (the caller reads through numpy)."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"native npy loader unavailable ({e}); using numpy")
        return None
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL | None:
    """The loaded native loader, built at the first call; None without g++."""
    with _lock:
        if not _lib:
            path = _build()
            lib = None
            if path is not None:
                lib = ctypes.CDLL(str(path))
                lib.load_npy_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int]
                lib.load_npy_batch.restype = ctypes.c_int
            _lib.append(lib)
        return _lib[0]


def load_npy_batch(paths: list[str], floats_per_file: int, n_threads: int = 8) -> np.ndarray:
    """Same-shaped float32 or float64 npy files -> (N, floats_per_file)
    float32: the native loader's threads, or numpy where it is missing or
    failed on a file."""
    n = len(paths)
    out = np.empty((n, floats_per_file), dtype=np.float32)
    lib = library()
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        rc = lib.load_npy_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), floats_per_file,
                                n_threads)
        if rc == 0:
            counts["native"] += 1
            return out
        print(f"native loader failed on {paths[rc - 1]}; retrying with numpy")
    for i, p in enumerate(paths):
        out[i] = np.load(p).reshape(-1).astype(np.float32)
    counts["numpy"] += 1
    return out
