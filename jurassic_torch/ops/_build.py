"""Build and load the port's CUDA kernels.

The sources in ``jurassic_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use into ``jurassic_torch/_build/`` (git-ignored),
under a file name keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  ``nvcc -Xptxas -v``
output (registers, spills per kernel) is kept beside the library.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

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
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources() if s.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    out.with_suffix(".log").write_text(log)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, out)
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
        fn = lib.jt_ega_fused_turbo
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
