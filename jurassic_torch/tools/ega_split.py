"""Where the time of the fused EGA kernels goes, on the CUDA card.

No hardware counter can be read on every machine, so this tool splits a
kernel's time by building variants of ``csrc/ega_fused_*.cu`` with a
preprocessor macro each and timing them in turns at the flagship shapes
(1084 rays x 400 segments x 4 gases x 100 channels):

  full         the kernel as it is;
  cell0        ``-DJT_SPLIT_CELL0``: every corner reads table cell 0 of
               its gas, so every table load hits the L1 cache: the scheduler
               and arithmetic floor of this code;
  loads        ``-DJT_SPLIT_LOADS`` (turbo): every row is loaded and
               summed, the corner's arithmetic is left out: the load path
               alone;
  index        ``-DJT_SPLIT_INDEX`` (table mode): the row search is
               replaced by an index computed from the target without a
               load: what the search costs;
  and their combinations with cell0.

The variants go into ``jurassic_torch/_build/split/``.  Their results are
wrong by design; only ``full`` is what the package runs.  For every
variant the tool prints ptxas's register count of the 4-gas
instantiations and, where ``cuobjdump`` is installed, their SASS
instruction counts.

With ``--parent ROOT`` (a checkout of an earlier commit, for example
unpacked with ``git archive`` into the git-ignored
``jurassic_torch/_build/parent``) it also loads that checkout's package
beside this one, builds its kernels, times them in turns with this
tree's on the same LOS, and reports whether the outputs are bit for bit
the same.

Run on a machine with a card, from the repository root::

    python -m jurassic_torch.tools.ega_split [--parent ROOT] [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import _build, ega_fused

SPLIT_DIR = _build.BUILD_DIR / "split"
EGA_SOURCES = ("ega_fused_turbo.cu", "ega_fused_table.cu")
EGA_ENTRIES = ("jt_ega_fused_turbo", "jt_ega_fused_table")
VARIANTS = {
    "turbo": {"full": [], "cell0": ["JT_SPLIT_CELL0"],
              "loads": ["JT_SPLIT_LOADS"],
              "cell0+loads": ["JT_SPLIT_CELL0", "JT_SPLIT_LOADS"]},
    "table": {"full": [], "cell0": ["JT_SPLIT_CELL0"],
              "index": ["JT_SPLIT_INDEX"],
              "cell0+index": ["JT_SPLIT_CELL0", "JT_SPLIT_INDEX"]},
}
N_RUNS = 10


def start_variant(name: str, defines: list[str]):
    """Start the compilers of the two EGA sources with ``defines``;
    :func:`finish_variant` waits for them and links."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"\W", "_", name)
    objs = [SPLIT_DIR / f"{tag}.{Path(s).stem}.o" for s in EGA_SOURCES]
    flags = [*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    procs = [subprocess.Popen([_build.find_nvcc(), *flags, "-c", "-o",
                               str(o), str(_build.CSRC / s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(EGA_SOURCES, objs)]
    return name, SPLIT_DIR / f"libsplit_{tag}.so", objs, procs


def finish_variant(name, out, objs, procs):
    """(library, compiler log, path) of a variant started by
    :func:`start_variant`."""
    log = ""
    for pr in procs:
        text, _ = pr.communicate()
        log += text
        if pr.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
    subprocess.run([_build.find_nvcc(), "-shared", "-o", str(out),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(out))
    for entry in EGA_ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
    return lib, log, out


def registers(log: str) -> dict[str, int]:
    """Registers of the 4-gas instantiations by (corner, taint) from
    ``nvcc -Xptxas -v`` output."""
    found, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry and "ILi4E" in entry:
            corner = "turbo" if "Turbo" in entry else "table"
            key = corner + ("+taint" if "ILi4ELb1E" in entry else "")
            found[key] = int(m.group(1))
            spill = re.search(r"(\d+) bytes spill stores", ln)
            if spill and int(spill.group(1)):
                found[key + " spill bytes"] = int(spill.group(1))
    return found


def sass_counts(lib_path: Path) -> dict[str, dict[str, int]]:
    """SASS instructions (all, global loads, special-function) of the
    4-gas instantiations without taint, or {} without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.find_nvcc()).parent / "cuobjdump")
    try:
        res = subprocess.run([tool, "-sass", str(lib_path)],
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return {}
    counts, key = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            key = None
            if "ILi4ELb0E" in name:
                key = "turbo" if "Turbo" in name else "table"
                counts[key] = {"all": 0, "ldg": 0, "mufu": 0}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(\S+)", ln)
        if m and key:
            counts[key]["all"] += 1
            counts[key]["ldg"] += m.group(1).startswith("LDG")
            counts[key]["mufu"] += m.group(1).startswith("MUFU")
    return counts


def cuda_ms(fn, n: int = N_RUNS) -> float:
    """Median milliseconds of fn() over n runs (CUDA events) after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_parent(root: Path):
    """The package of another checkout under the name ``jt_parent`` (its
    imports are relative, so both packages live in one process)."""
    pkg = root / "jurassic_torch"
    spec = importlib.util.spec_from_file_location(
        "jt_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jt_parent"] = mod
    spec.loader.exec_module(mod)


def flagship_models(pkg: str, dev):
    """(turbo model, table model, atm, obs) of the flagship from package
    ``pkg``; the turbo fit comes from this tree's cache."""
    imp = importlib.import_module
    ctl, ft, atm, obs = imp(f"{pkg}.workloads").flagship()
    ctl.usetpu = 1
    tt, stats = imp(f"{pkg}.ops.turbo_fit").build_turbo_tables_cached(
        ft, _build.BUILD_DIR / "turbo_cache", dev)
    forward = imp(f"{pkg}.forward")
    fm = forward.ForwardModel(ctl, fast_tables=ft, turbo_tables=tt,
                              turbo_stats=stats, device=dev)
    ctl_p = imp(f"{pkg}.workloads").flagship()[0]
    ctl_p.usetpu, ctl_p.kernel = 1, "pallas"
    fm_p = forward.ForwardModel(ctl_p, fast_tables=ft, device=dev)
    return fm, fm_p, atm, obs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout to time in turns")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON result to this file")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ega_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "variants": {}, "registers": {}, "sass": {}}

    t0 = time.perf_counter()
    fm, fm_p, atm, obs = flagship_models("jurassic_torch", dev)
    los = fm.trace(atm.copy(), obs.copy())
    torch.cuda.synchronize()
    common = (fm.cc_rows, los, fm.flags, fm.ig_co2, fm.ig_h2o)
    calls = {
        "turbo": lambda: ega_fused.rt_fused_turbo(fm.turbo_tbl, *common),
        "table": lambda: ega_fused.rt_fused_table(fm_p.table_tbl, *common),
    }
    print(f"flagship set-up {time.perf_counter() - t0:.1f} s, "
          f"{int(los.valid.sum())} active segments", flush=True)

    # every variant library, built once
    libs = {}
    names = sorted({n for v in VARIANTS.values() for n in v},
                   key=lambda n: (n != "full", n))
    t0 = time.perf_counter()
    jobs = [start_variant(name, next(v[name] for v in VARIANTS.values()
                                     if name in v)) for name in names]
    for job in jobs:                     # all compilers run together
        name = job[0]
        lib, log, path = finish_variant(*job)
        libs[name] = lib
        result["registers"][name] = registers(log)
        result["sass"][name] = sass_counts(path)
        print(f"variant {name}: registers {result['registers'][name]}, "
              f"SASS {result['sass'][name]}", flush=True)
    print(f"variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    package_lib = _build.load_library()
    try:
        for mode, variants in VARIANTS.items():
            order = list(variants) + list(reversed(variants))
            times = {n: [] for n in variants}
            for name in order:          # in turns: there and back
                _build._lib = libs[name]
                times[name].append(cuda_ms(calls[mode]))
            for name in variants:
                result["variants"][f"{mode} {name}"] = times[name]
                print(f"{mode:5s} {name:12s} "
                      + " / ".join(f"{t:.3f}" for t in times[name])
                      + " ms (medians of %d, two turns)" % N_RUNS,
                      flush=True)
    finally:
        _build._lib = package_lib

    if ns.parent is not None:
        load_parent(ns.parent.resolve())
        pm, pm_p, _, _ = flagship_models("jt_parent", dev)
        p_fused = importlib.import_module("jt_parent.ops.ega_fused")
        p_calls = {
            "turbo": lambda: p_fused.rt_fused_turbo(pm.turbo_tbl, *common),
            "table": lambda: p_fused.rt_fused_table(pm_p.table_tbl, *common),
        }
        p_build = importlib.import_module("jt_parent.ops._build")
        p_build.load_library()
        result["registers"]["parent"] = registers(p_build.build_log())
        result["registers"]["package"] = registers(_build.build_log())
        print(f"registers: parent {result['registers']['parent']}, this "
              f"tree {result['registers']['package']}", flush=True)
        for mode in VARIANTS:
            new = calls[mode]()
            old = p_calls[mode]()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(new[:2], old[:2]))
            diff = max(float((a - b).abs().max())
                       for a, b in zip(new[:2], old[:2]))
            t = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                t[who].append(cuda_ms(p_calls[mode] if who == "parent"
                                      else calls[mode]))
            result["variants"][f"{mode} parent"] = t["parent"]
            result["variants"][f"{mode} this tree"] = t["this"]
            result[f"{mode} bit for bit"] = same
            print(f"{mode}: parent "
                  + " / ".join(f"{x:.3f}" for x in t["parent"])
                  + " ms, this tree "
                  + " / ".join(f"{x:.3f}" for x in t["this"])
                  + f" ms (parent, this, this, parent); outputs bit for bit "
                  f"equal: {same} (max difference {diff:.3e})", flush=True)

    print(card, flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if ns.out is not None:
        ns.out.parent.mkdir(parents=True, exist_ok=True)
        ns.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
