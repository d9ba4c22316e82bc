"""Build and load the port's CUDA kernels.

The sources in ``jurassic_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per ``.cu`` file, all started together, then one link.  The
build runs at first use into ``jurassic_torch/_build/`` (git-ignored),
under a file name keyed by a hash of the sources (``.cu`` and the ``.cuh``
they include) and flags, so an edited source rebuilds and an unchanged one
is reused.  ``nvcc -Xptxas -v`` output (registers, spills per kernel) is
kept beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# -fmad=false: every float operation rounds on its own, as in the plain
# PyTorch version the kernel is held to (FMA contraction moved the
# flagship tau by up to 8.5e-5 over 400 segments on the H100)
# --split-compile=0 (nvcc 12.1 or newer): the instantiations of one source
# compile on all cores; same registers and kernel times, half the build
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "--split-compile=0", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# tensors and sizes every fused EGA entry point takes (JT_EGA_C_PARAMS in
# csrc/ega_common.cuh): 13 pointers, then R S F W G P T D n_src flags
_EGA = [_P] * 13 + [_I] * 10
# C entry point -> argument types; every one returns a cudaError as int
ENTRY_POINTS = {
    "jt_ega_fused_turbo": _EGA + [_I, _I, _I, _P],   # Q deg_f deg_i stream
    "jt_ega_fused_table": _EGA + [_I, _I, _P],       # K monotone stream
    "jt_peak_fma": [_P, _P, _F, _F, _I, _I, _P],
    "jt_peak_sfu": [_P, _P, _I, _I, _I, _P],
    "jt_peak_copy": [_P, _P, ctypes.c_longlong, _I, _P],
}

_lib = None


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libjurassic_torch_{source_hash()}.so"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels build from source at first use")
    return found


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(cus, objs)]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    log, ok = "", True
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        for c, pr in zip(cmds, procs):
            text, _ = pr.communicate()
            log += f"$ {' '.join(c)}\n{text}"
            ok = ok and pr.returncode == 0
        if ok:
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            log += f"$ {' '.join(link)}\n{res.stdout}{res.stderr}"
            ok = res.returncode == 0
        out.with_suffix(".log").write_text(log)
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def build_log() -> str:
    """The compiler output of the current library's build."""
    f = library_path().with_suffix(".log")
    return f.read_text() if f.exists() else ""


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C entry
    points."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
