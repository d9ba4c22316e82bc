"""Native (C) components of the runtime, bound via ctypes.

Currently the EGA table parser (tabparse.c) — the analogue of the
reference's OpenMP-parallel init_tbl ASCII parse (jurassic.c:311-416,
parallel over channels at :329).  The shared library builds lazily on
first use with the system compiler into ``jurassic_torch/_build/``; when
no compiler is available the callers fall back to the pure-Python parser
transparently, as in the JAX package (``jurassic_tpu/native``, of which
this is a copy; both parsers produce the same arrays).

Parallelism: ctypes releases the GIL for the duration of the C call, so
:func:`parse_tab_files` runs the per-(gas, channel) file parses on a
thread pool — the same shape as the reference's ``#pragma omp parallel
for`` over channels.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "tabparse.c"
_BUILD_DIR = _HERE.parent / "_build"
_LIB: ctypes.CDLL | None | bool = None   # False = build failed


def _build() -> Path | None:
    """Compile tabparse.c to a cached shared library; None on failure."""
    tag = f"cpython{sys.version_info.major}{sys.version_info.minor}"
    lib = _BUILD_DIR / f"_tabparse_{tag}.so"
    if lib.exists() and lib.stat().st_mtime >= _SRC.stat().st_mtime:
        return lib
    cc = os.environ.get("CC", "gcc")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        tmp = Path(td) / lib.name
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        try:
            os.replace(tmp, lib)
        except OSError:
            return None
    return lib


def _load() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is None:
        path = _build()
        if path is None:
            _LIB = False
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            # A stale/foreign-arch cached .so (e.g. checked out on a
            # different platform): force one rebuild, then give up and
            # let callers fall back to the pure-Python parser.
            try:
                path.unlink()
                path = _build()
                lib = ctypes.CDLL(str(path)) if path else None
            except OSError:
                lib = None
            if lib is None:
                _LIB = False
                return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.jr_scan_dims.argtypes = [ctypes.c_char_p, c_int_p, c_int_p,
                                     c_int_p]
        lib.jr_scan_dims.restype = ctypes.c_int
        lib.jr_parse_tab.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_int_p, c_int_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.jr_parse_tab.restype = ctypes.c_int
        _LIB = lib
    return _LIB or None


def available() -> bool:
    return _load() is not None


def parse_tab_file(path) -> dict | None:
    """Parse one LUT file into dense per-file arrays.

    Returns {"np": int, "nt": [P] i32, "nu": [P, T] i32, "p": [P] f64,
    "t": [P, T] f64, "u": [P, T, U] f32, "eps": [P, T, U] f32} with the
    file's own (P, T, U) maxima, or None when the native library is
    unavailable (caller falls back to the Python parser)."""
    lib = _load()
    if lib is None:
        return None
    b = str(path).encode()
    nP = ctypes.c_int()
    maxT = ctypes.c_int()
    maxU = ctypes.c_int()
    rc = lib.jr_scan_dims(b, ctypes.byref(nP), ctypes.byref(maxT),
                          ctypes.byref(maxU))
    if rc < 0:
        raise OSError(f"cannot read {path}")
    P, T, U = max(nP.value, 1), max(maxT.value, 1), max(maxU.value, 1)
    nt = np.zeros(P, np.int32)
    nu = np.zeros((P, T), np.int32)
    p = np.zeros(P, np.float64)
    t = np.zeros((P, T), np.float64)
    u = np.zeros((P, T, U), np.float32)
    eps = np.zeros((P, T, U), np.float32)
    rc = lib.jr_parse_tab(
        b, P, T, U,
        nt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        nu.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        eps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc < 0:
        raise OSError(f"cannot read {path}")
    return {"np": rc, "nt": nt, "nu": nu, "p": p, "t": t, "u": u,
            "eps": eps}


def parse_tab_files(paths, max_workers: int | None = None) -> list:
    """Parse many LUT files concurrently (GIL released inside the C
    parser) — the reference's OpenMP-over-channels table init
    (jurassic.c:329)."""
    if not available():
        return [None] * len(list(paths))
    workers = max_workers or min(32, (os.cpu_count() or 4))
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(parse_tab_file, paths))
