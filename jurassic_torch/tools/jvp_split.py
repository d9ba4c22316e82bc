"""Where the time of the RT tangent contraction goes, on the CUDA card.

The contraction kernel of ``csrc/ega_jvp_fast.cu`` (drad = A_r dLOS_r +
a_surf dtsurf per ray) is timed at the flagship Jacobian (1084 rays, 100
channels, n = 130 tangents, 12 LOS fields) in variants built with a
preprocessor macro each and timed in turns on the same records:

  full        the kernel as it is;
  noload      ``-DJT_SPLIT_NOLOAD``: the ring issues no copy, the
              arithmetic runs on whatever the shared memory holds: the
              multiply, the barriers and the ring's bookkeeping;
  nomma       ``-DJT_SPLIT_NOMMA``: the chunks are copied and never
              multiplied: the loads and barriers alone;
  ks1, ks4    ``-DJT_CT_SMEM=...``: the ring's budget at 55 KB and 210 KB
              instead of 110 KB, so a K chunk of 1 and 4 segments in
              float64 (2 by default) and 4 and 1 blocks a multiprocessor;
  stages2, stages4  ``-DJT_CT_STAGES=2`` / ``4``: two or four ring
              stages instead of three (the chunk shrinks to fit).

The variants go into ``jurassic_torch/_build/jvp_split/``.  noload and
nomma are wrong by design; every other variant must give the full
kernel's drad bit for bit (the K order of the sums does not change), and
the tool says whether it does.  Beside them it times one ``torch.bmm``
of the rays' dense A [D, S F] and LOS tangents [S F, n], and prints
each variant's registers (``jt_ega_jvp_registers``).

Run on a machine with a card, from the repository root::

    python -m jurassic_torch.tools.jvp_split [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

import torch

from ..ops import _build
from ..ops import ega_jvp as ej
from .ega_split import cuda_ms

SPLIT_DIR = _build.BUILD_DIR / "jvp_split"
SOURCE = "ega_jvp_fast.cu"
VARIANTS = {"full": [], "noload": ["JT_SPLIT_NOLOAD"],
            "nomma": ["JT_SPLIT_NOMMA"], "ks1": ["JT_CT_SMEM=56320"],
            "ks4": ["JT_CT_SMEM=215040"], "stages2": ["JT_CT_STAGES=2"],
            "stages4": ["JT_CT_STAGES=4"]}
WRONG_BY_DESIGN = ("noload", "nomma")


def start_variant(name: str, defines: list[str]):
    """Start nvcc on the tangent source with ``defines``."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    obj = SPLIT_DIR / f"{name}.o"
    flags = [*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    proc = subprocess.Popen([_build.find_nvcc(), *flags, "-c", "-o",
                             str(obj), str(_build.CSRC / SOURCE)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, obj, proc


def finish_variant(name, obj, proc) -> ctypes.CDLL:
    """The variant's library, its entry points declared."""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
    out = SPLIT_DIR / f"libjvp_{name}.so"
    subprocess.run([_build.find_nvcc(), "-shared", "-o", str(out),
                    str(obj)], check=True)
    lib = ctypes.CDLL(str(out))
    for entry, argtypes in _build.ENTRY_POINTS.items():
        if entry.startswith("jt_ega_jvp_"):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def flagship_records(dtype, dev):
    """(records, segment indices, first records, a_surf, LOS tangents, G,
    W, S) of the flagship Jacobian's one package in ``dtype``: the state
    of the flagship retrieval (HYDZ 20, T and the 4 gases' vmr at 10-60
    km, n = 130), its LOS tangents from the tracer tangent kernel, the
    records from the record kernel."""
    from ..forward import ForwardModel
    from ..ops.trace_jvp import trace_rays_jvp_cuda
    from ..retrieval import autodiff_seed, package_tangents
    from ..workloads import flagship
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.kernel, ctl.hydz = 1, "jax", 20.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 60.0
    ctl.retq_zmin, ctl.retq_zmax = [10.0] * ctl.ng, [60.0] * ctl.ng
    m = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=dtype)
    prof, ptan, geo = package_tangents(ctl, atm, obs, m,
                                       autodiff_seed(ctl, atm, m))
    los, tan, _ = trace_rays_jvp_cuda(prof, ptan, geo, ctl.rayds,
                                      ctl.raydz, bool(ctl.refrac), ctl.nlos)
    e = m.eager_tables()
    _, rec, sidx, first, asurf = ej.rt_jvp_records_cuda(
        e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, m.flags, m.ig_co2,
        m.ig_h2o, bool(ctl.write_bbt))
    return rec, sidx, first, asurf, tan, ctl.ng, ctl.nw, ctl.nlos


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("jvp_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "ms": {}, "registers": {}, "bit_for_bit": {}}
    t0 = time.perf_counter()
    jobs = [start_variant(name, d) for name, d in VARIANTS.items()]
    package_lib = _build.load_library()
    libs = {job[0]: finish_variant(*job) for job in jobs}
    print(f"variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        for dtype in (torch.float64, torch.float32):
            name = str(dtype)[6:]
            rec, sidx, first, asurf, tan, G, W, S = flagship_records(dtype,
                                                                     dev)
            n_rec = int(first[-1])
            call = lambda: ej.rt_jvp_contract_cuda(rec, sidx, first, asurf,
                                                   tan, G, W)
            ref = call()
            times = {v: [] for v in VARIANTS}
            for v in list(VARIANTS) + list(reversed(VARIANTS)):
                _build._lib = libs[v]
                times[v].append(cuda_ms(call))
                if len(times[v]) == 1:
                    got = call()
                    torch.cuda.synchronize()
                    result["bit_for_bit"][f"{name} {v}"] = bool(
                        torch.equal(got, ref))
                    regs = ej.registers(G, W, S, True, dtype)
                    result["registers"][f"{name} {v}"] = regs[1]
            _build._lib = package_lib
            for v in VARIANTS:
                result["ms"][f"{name} {v}"] = times[v]
                print(f"{name} {v:8s} " + " / ".join(
                    f"{t:.3f}" for t in times[v]) + " ms (medians of 10, "
                    f"two turns); registers "
                    f"{result['registers'][f'{name} {v}']}; drad bit for "
                    f"bit the full kernel's: "
                    + ("wrong by design" if v in WRONG_BY_DESIGN else
                       str(result["bit_for_bit"][f"{name} {v}"])),
                    flush=True)
            F = 3 + 2 * G + W
            R, D, n = first.shape[0] - 1, rec.shape[2], tan.seg.shape[3]
            Ad = ej.dense_adjoint(rec, sidx, first, S, G, W).permute(
                0, 3, 1, 2).reshape(R, D, S * F).contiguous()
            del rec, sidx
            Bd = tan.seg.reshape(R, S * F, n)
            result["ms"][f"{name} torch.bmm"] = [
                cuda_ms(lambda: torch.bmm(Ad, Bd))]
            print(f"{name} torch.bmm of the dense A [{R}, {D}, {S * F}] "
                  f"and LOS tangents [{R}, {S * F}, {n}]: "
                  f"{result['ms'][f'{name} torch.bmm'][0]:.3f} ms; "
                  f"{n_rec} records", flush=True)
            del Ad, Bd, tan, asurf, ref
            torch.cuda.empty_cache()
    finally:
        _build._lib = package_lib
    print(card, flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if ns.out is not None:
        with open(ns.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
