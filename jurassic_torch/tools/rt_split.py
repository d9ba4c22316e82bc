"""Where the time of the RT kernel (``csrc/ega_rt.cu``) and of the
record kernel (``csrc/ega_jvp_fast.cu``, ``ega_rec_kernel``) goes, on
the CUDA card.

No hardware counter can be read on every machine, so this tool splits a
kernel's time by building variants of the two sources with a
preprocessor macro each (into ``jurassic_torch/_build/split/``) and
timing them in turns at the flagship (1084 rays x 400 segments x 4 gases
x 100 channels), on the exact tables in float64 and float32, the fast
tables in float32 and float64, and per-channel axes
(``workloads.perturbed_axes``, float32):

  full     the kernels as the package builds them;
  cell0    ``-DJT_SPLIT_CELL0``: every corner reads cell 0 of its gas,
           so the table loads hit L1;
  index    ``-DJT_SPLIT_INDEX``: the row searches are replaced by the
           hint, unchecked;
  nobar    ``-DJT_SPLIT_NOBAR``: no barrier per segment (one after each
           chunk of brackets);
  noahead  ``-DJT_SPLIT_NOAHEAD``: the fast RT kernel computes no
           brackets, continua or source a chunk ahead (their time);
  nocont   ``-DJT_SPLIT_NOCONT``: ... no continua or source;
  bil32    ``-DJT_SPLIT_BIL32``: the exact float32 bilinear step in
           float32 (exact float32 only);
  blocks1 .. blocks4  ``-DJT_RT_BLOCKS=n -DJT_REC_BLOCKS=n``:
           launch bounds asking n resident blocks an SM on either table
           kind (the package: 2 on exact tables and for the fast RT
           kernel's blocks of up to 448 threads, 3 for the fast record
           kernel), which caps the registers;
  corners1, corners2  ``-DJT_RT_CORNERS=n``: the first trips of n exact
           corners in flight together (the package: 4);
  win5     ``-DJT_RTF_WIN=5``: the fast RT kernel's first trip loads five
           eps row entries a corner (the package: four);
  onewave  ``full`` on the first ``slots`` groups' rays: one round of
           resident blocks;
  hints    ``-DJT_SPLIT_HINTS``: not timed; the fast RT kernel counts,
           per (gas, corner), the corners checked against their hint,
           the checks that failed (a halving follows), the windows loaded
           again (the hint beyond the cell's count) and the forward pairs
           outside the window (two more loads), on one launch;

and the floor: ``full`` on the busiest ray alone and on the 132 busiest.
With ``--sass`` it also counts the SASS instructions of each RT and
record kernel instantiation (``cuobjdump -sass``; static counts, not the
instructions a launch issues) in ``full`` and the parent.
The variants' results are wrong by design; only ``full`` is what the
package runs.  For each it prints ptxas's registers, the resident blocks
a multiprocessor (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
through the library's ``jt_ega_rt_shape``), the rounds and the time (CUDA events around each launch, median of
N_RUNS, two turns).

With ``--parent ROOT`` (an earlier checkout, for example unpacked with
``git archive <commit> jurassic_torch | tar -x -C
jurassic_torch/_build/parent``) it also builds that checkout's kernels,
times them in turns with this tree's on the same LOS (parent, this,
this, parent) and reports whether the outputs are bit for bit the same.

Run on a machine with a card, from the repository root::

    python -m jurassic_torch.tools.rt_split [--parent ROOT] [--out FILE]
        [--configs "exact float64,..."] [--variants full,index,...] [--sass]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import _build, ega_fused, ega_jvp, ega_rt
from .ega_split import load_parent

SPLIT_DIR = _build.BUILD_DIR / "split"
SOURCES = ("ega_rt.cu", "ega_jvp_fast.cu")
ENTRIES = ("jt_ega_rt", "jt_ega_rt_registers", "jt_ega_rt_shape",
           "jt_ega_rt_hint_counts", "jt_ega_jvp_record",
           "jt_ega_jvp_scratch", "jt_ega_jvp_registers")
VARIANTS = {"full": [], "cell0": ["JT_SPLIT_CELL0"],
            "index": ["JT_SPLIT_INDEX"], "nobar": ["JT_SPLIT_NOBAR"],
            "noahead": ["JT_SPLIT_NOAHEAD"], "nocont": ["JT_SPLIT_NOCONT"],
            "bil32": ["JT_SPLIT_BIL32"],
            "blocks1": ["JT_RT_BLOCKS=1", "JT_REC_BLOCKS=1"],
            "blocks2": ["JT_RT_BLOCKS=2", "JT_REC_BLOCKS=2"],
            "blocks3": ["JT_RT_BLOCKS=3", "JT_REC_BLOCKS=3"],
            "blocks4": ["JT_RT_BLOCKS=4", "JT_REC_BLOCKS=4"],
            "corners1": ["JT_RT_CORNERS=1"], "corners2": ["JT_RT_CORNERS=2"],
            "win5": ["JT_RTF_WIN=5"], "hints": ["JT_SPLIT_HINTS"]}
UNTIMED = ("hints",)
# (label, KERNEL, dtype, axes)
CONFIGS = (("exact float64", "exact", torch.float64, "uniform"),
           ("exact float32", "exact", torch.float32, "uniform"),
           ("fast float32", "jax", torch.float32, "uniform"),
           ("fast float64", "jax", torch.float64, "uniform"),
           ("per-channel float32", "auto", torch.float32, "per_channel"))
KERNELS = {"rt": "jt_ega_rt", "record": "jt_ega_jvp_record"}
N_RUNS = 10
N_SM_FLOOR = 132


def start_variant(name: str, defines: list[str]):
    """Start the compilers of the two sources with ``defines``, unless
    this checkout built the variant before (the library is keyed by the
    sources and the flags); :func:`finish_variant` waits and links."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    key = hashlib.sha256((_build.source_hash() + " ".join(flags)).encode())
    out = SPLIT_DIR / f"librt_split_{name}_{key.hexdigest()[:12]}.so"
    objs = [SPLIT_DIR / f"rt_{name}.{Path(s).stem}.o" for s in SOURCES]
    procs = [] if out.exists() else [
        subprocess.Popen([_build.find_nvcc(), *flags, "-c", "-o", str(o),
                          str(_build.CSRC / s)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)]
    return name, out, objs, procs


def finish_variant(name, out, objs, procs):
    """(library, compiler log) of a variant started by
    :func:`start_variant`."""
    log = ""
    for pr in procs:
        text, _ = pr.communicate()
        log += text
        if pr.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
    if procs:
        subprocess.run([_build.find_nvcc(), "-shared", "-o", str(out),
                        *map(str, objs)], check=True)
        out.with_suffix(".log").write_text(log)
    else:
        log = out.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(out))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
    return lib, log


def job_path(jobs, name: str) -> Path:
    """The library of the variant ``name`` among started jobs."""
    return next(job[1] for job in jobs if job[0] == name)


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction counts of the RT and record kernels'
    instantiations in the library ``lib`` (``cuobjdump -sass``), keyed as
    :func:`ptxas_registers`, and of their out-of-line helpers by name;
    for each fast RT kernel also its 16 most frequent opcodes
    (key + " opcodes")."""
    cuobjdump = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, ops, entry = {}, {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            entry = m.group(1)
            counts[entry], ops[entry] = 0, {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      ln)
        if entry and m:
            counts[entry] += 1
            ops[entry][m.group(1)] = ops[entry].get(m.group(1), 0) + 1
    out = {}
    for name, n in counts.items():
        if re.search(r"ega_(rt|rec)_kernel", name):
            key = ptxas_key(name)
            if key.startswith("rt fast"):
                out[key + " opcodes"] = dict(sorted(
                    ops[name].items(), key=lambda kv: -kv[1])[:16])
        else:
            m = re.search(r"(fast_halving|row_index_rows|corner_exact_rows)"
                          r"I([df])", name)
            if m is None:
                continue
            key = m.group(0)
        out[key] = out.get(key, 0) + n
    return out


def ptxas_key(entry: str) -> str:
    """(kernel, exact|fast, dtype, uniform) of a mangled kernel name."""
    kind = "rt" if "ega_rt_kernel" in entry else "record"
    tab = "exact" if "ExactTab" in entry else "fast"
    dt = ("float64" if re.search(r"kernel(?:_exact|_fast)?I[dD]", entry)
          else "float32")
    uni = "uniform" if re.search(r"Lb1E", entry) else "per-channel"
    return f"{kind} {tab} {dt} {uni}"


def ptxas_registers(log: str) -> dict[str, int]:
    """Registers (and spill stores, where any) of the RT and record
    kernels' instantiations by (kernel, exact|fast, dtype, uniform) from
    ``nvcc -Xptxas -v`` output."""
    found, entry, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)  # the line before
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if not (m and entry) or not re.search(r"ega_(rt|rec)_kernel",
                                              entry):
            continue
        key = ptxas_key(entry)
        found[key] = int(m.group(1))
        if spill:
            found[key + " spill bytes"] = spill
    return found


def launch_ms(events_owner, fn, name: str, n: int = N_RUNS) -> float:
    """Median milliseconds of the launches of ``name`` over ``n`` calls
    of ``fn`` after one warm-up, by the CUDA events the wrappers record
    around each launch (``events_owner.LAUNCH_EVENTS``, the ega_fused
    module of the package that launches)."""
    fn()
    torch.cuda.synchronize()
    before, events_owner.LAUNCH_EVENTS = events_owner.LAUNCH_EVENTS, []
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for k, a, b in events_owner.LAUNCH_EVENTS
              if k == name]
    finally:
        events_owner.LAUNCH_EVENTS = before
    if len(ms) != n:
        raise RuntimeError(f"{len(ms)} launches of {name}, not {n}")
    return statistics.median(ms)


def los_rows(los, idx):
    """The LOS of the rays ``idx`` (a long tensor), contiguous."""
    return los._replace(**{f: getattr(los, f)[idx].contiguous()
                           for f in los._fields})


def config_model(label, kernel, dtype, axes, dev):
    """(model, LOS, rt call, record call) of the flagship in one
    configuration; the calls take a LOS."""
    from ..forward import ForwardModel
    from ..models.synthetic import fast_to_ega_tables
    from ..workloads import flagship, perturbed_axes
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.kernel = 1, kernel
    if axes == "per_channel":
        ft = perturbed_axes(ft, seed=1)
    tables = fast_to_ega_tables(ft) if kernel == "exact" else None
    m = ForwardModel(ctl, tables, fast_tables=ft, device=dev, dtype=dtype)
    los = m.trace(atm.copy(), obs.copy())
    e = m.eager_tables()
    common = (m.sr, m.st, m.nu, e.cc, e.window)
    tail = (m.flags, m.ig_co2, m.ig_h2o, bool(ctl.write_bbt))
    calls = {
        "rt": lambda tbl, lo, mod=ega_rt: mod.rt_integrate_cuda(
            tbl, *common, lo, *tail),
        "record": lambda tbl, lo, mod=ega_jvp: mod.rt_jvp_records_cuda(
            tbl, *common, lo, *tail)}
    return m, los, e.tbl, calls


def parent_tables(tbl, parent_root: Path):
    """The tables as the parent package's NamedTuple class (its wrappers
    tell exact from fast tables by class), the exact u and eps rows in the
    parent's layout: [G, P, T, D, U] before this tree made them
    channel-innermost."""
    p_ega = importlib.import_module("jt_parent.ops.ega")
    exact = type(tbl).__name__ == "EgaDeviceTables"
    cls = p_ega.EgaDeviceTables if exact else p_ega.FastDeviceTables
    fields = {k: getattr(tbl, k) for k in cls._fields}
    src = (parent_root / "jurassic_torch/ops/ega.py").read_text()
    if exact and "u: torch.Tensor     # [G, P, T, D, U]" in src:
        for k in ("u", "eps"):
            fields[k] = fields[k].transpose(3, 4).contiguous()
    return cls(**fields)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout to time in turns")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON result to this file")
    ap.add_argument("--configs", default=None,
                    help="comma-separated configurations (default: all)")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to build and time "
                    "(default: all; full is always built)")
    ap.add_argument("--sass", action="store_true",
                    help="count the kernels' SASS instructions")
    ns = ap.parse_args()
    configs = [c for c in CONFIGS if ns.configs is None
               or c[0] in ns.configs.split(",")]
    timed = list(VARIANTS) if ns.variants is None \
        else ns.variants.split(",")
    if not torch.cuda.is_available():
        sys.exit("rt_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "registers": {}, "configs": {}}

    t0 = time.perf_counter()
    built = [n for n in VARIANTS if n in ("full", *timed)]
    jobs = [start_variant(n, VARIANTS[n]) for n in built]
    p_mods = None
    if ns.parent is not None:
        load_parent(ns.parent.resolve())
        p_build = importlib.import_module("jt_parent.ops._build")
        p_build.load_library()           # builds while the variants do
        p_mods = {k: importlib.import_module(f"jt_parent.ops.{k}")
                  for k in ("ega_rt", "ega_jvp", "ega_fused")}
    libs = {}
    for job in jobs:
        lib, log = finish_variant(*job)
        libs[job[0]] = lib
        result["registers"][job[0]] = ptxas_registers(log)
    if p_mods is not None:
        result["registers"]["parent"] = ptxas_registers(
            p_build.build_log())
    print(f"variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    if ns.sass:
        libs_sass = {"full": job_path(jobs, "full")}
        if p_mods is not None:
            libs_sass["parent"] = p_build.library_path()
        result["sass"] = {k: sass_counts(v) for k, v in libs_sass.items()}
        for k, v in result["sass"].items():
            print(f"SASS instructions, {k}: {v}", flush=True)
    for name, regs in result["registers"].items():
        print(f"registers, {name}: {regs}", flush=True)

    package_lib = _build.load_library()
    for label, kernel, dtype, axes in configs:
        t0 = time.perf_counter()
        m, los, tbl, calls = config_model(label, kernel, dtype, axes, dev)
        R, S = los.ds.shape
        G, D = los.u.shape[2], m.ctl.nd
        counts = los.valid.sum(dim=1)
        busiest = torch.argsort(counts, descending=True, stable=True)
        res = result["configs"][label] = {}
        print(f"\n{label}: model and LOS in {time.perf_counter() - t0:.1f}"
              f" s; {R} rays, {int(counts.sum())} valid segments, the "
              f"busiest {int(counts.max())}", flush=True)
        exact = type(tbl).__name__ == "EgaDeviceTables"
        for kname, entry in KERNELS.items():
            call = calls[kname]
            r = res[kname] = {"variants": {}, "shape": {}}
            names = [n for n in timed if n not in UNTIMED
                     and (n != "bil32" or label == "exact float32")]
            try:
                for name in dict.fromkeys(["full", *names]):
                    _build._lib = libs[name]
                    r["shape"][name] = ega_rt.launch_shape(
                        R, D, G, tbl.uniform, exact, dtype,
                        record=kname == "record")
                _build._lib = libs["full"]
                sh = r["shape"]["full"]
                n_one = min(R, sh["slots"] * sh["rays_per_block"])
                subsets = {"onewave": torch.arange(n_one, device=dev),
                           "busiest ray": busiest[:1],
                           f"{N_SM_FLOOR} busiest": busiest[:N_SM_FLOOR]}
                for k, v in subsets.items():
                    r["shape"][k] = ega_rt.launch_shape(
                        int(v.numel()), D, G, tbl.uniform, exact, dtype,
                        record=kname == "record")
                sub_los = {k: los_rows(los, v) for k, v in subsets.items()}
                times = {n: [] for n in names + list(subsets)}
                turn = names + list(subsets)
                for who in turn + turn[::-1]:      # there and back
                    if who in VARIANTS:
                        _build._lib = libs[who]
                        fn = lambda: call(tbl, los)
                    else:
                        _build._lib = libs["full"]
                        fn = lambda lo=sub_los[who]: call(tbl, lo)
                    times[who].append(launch_ms(ega_fused, fn, entry))
            finally:
                _build._lib = package_lib
            r["variants"] = times
            for who, t in times.items():
                s = r["shape"].get(who, {})
                print(f"  {kname:6s} {who:12s} "
                      + " / ".join(f"{x:.3f}" for x in t) + " ms; "
                      f"{s.get('blocks_per_sm')} blocks an SM, "
                      f"{s.get('threads')} threads, {s.get('blocks')} "
                      f"blocks for {s.get('groups')} groups of "
                      f"{s.get('rays_per_block')} rays, {s.get('rounds')} "
                      f"round(s), {s.get('gas_threads')} thread(s) a lane, "
                      f"{s.get('lanes_per_pass')} lanes a pass, "
                      f"{s.get('passes')} pass(es)", flush=True)
            if kname == "rt" and not exact and "hints" in libs:
                r["hints"] = hint_split(libs["hints"], package_lib, call,
                                        tbl, los, G)
            if p_mods is not None:
                ptbl = parent_tables(tbl, ns.parent)
                pcall = lambda lo, mod=p_mods["ega_rt" if kname == "rt"
                                              else "ega_jvp"]: (
                    m_call(calls[kname], mod, ptbl, lo))
                new = call(tbl, los)
                old = pcall(los)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in
                           zip(flat(new), flat(old)))
                t = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent"):
                    fn = ((lambda: pcall(los)) if who == "parent"
                          else (lambda: call(tbl, los)))
                    own = p_mods["ega_fused"] if who == "parent" \
                        else ega_fused
                    t[who].append(launch_ms(own, fn, entry))
                r["parent"], r["this tree"] = t["parent"], t["this"]
                r["bit for bit the parent"] = same
                print(f"  {kname}: parent " + " / ".join(
                    f"{x:.3f}" for x in t["parent"]) + " ms, this tree "
                    + " / ".join(f"{x:.3f}" for x in t["this"])
                    + f" ms (parent, this, this, parent); outputs bit for "
                    f"bit the parent's: {same}", flush=True)
                del new, old
        del m, los, tbl, calls
        torch.cuda.empty_cache()

    print(card, flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if ns.out is not None:
        ns.out.parent.mkdir(parents=True, exist_ok=True)
        ns.out.write_text(line + "\n")


def hint_counts(lib) -> dict:
    """The fast RT kernel's hint count since the last call, from a library
    built with ``-DJT_SPLIT_HINTS`` (``jt_ega_rt_hint_counts``, which
    zeroes it): per counter ("checked", "failed", "window again",
    "forward outside") a [64][4] list, [gas][corner] (gases from 63 on in
    63)."""
    out = (ctypes.c_ulonglong * (4 * 64 * 4))()
    rc = lib.jt_ega_rt_hint_counts(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"jt_ega_rt_hint_counts failed (cudaError {rc})")
    v = list(out)
    return {k: [v[(i * 64 + g) * 4:(i * 64 + g) * 4 + 4] for g in range(64)]
            for i, k in enumerate(("checked", "failed", "window again",
                                   "forward outside"))}


def hint_split(lib, package_lib, call, tbl, los, G: int) -> dict:
    """The fast RT kernel's hint count on one launch at ``los`` (the
    ``hints`` variant): per (gas, corner) the corners checked, failed,
    windows loaded again and forward pairs outside the window, printed
    with the failed share."""
    try:
        _build._lib = lib
        hint_counts(lib)                         # zero it
        call(tbl, los)
        torch.cuda.synchronize()
        hc = hint_counts(lib)
    finally:
        _build._lib = package_lib
    out = {k: v[:G] for k, v in hc.items()}
    checked = sum(map(sum, out["checked"]))
    for k in ("failed", "window again", "forward outside"):
        n = sum(map(sum, out[k]))
        print(f"  hints: {k} {n} of {checked} checked corners "
              f"({n / max(checked, 1):.4%}); per gas, corners 0-3: "
              + "; ".join(" ".join(str(x) for x in row)
                          for row in out[k]), flush=True)
    out["checked corners"] = checked
    return out


def m_call(call, mod, tbl, lo):
    """``call`` (a lambda of :func:`config_model`) through the module
    ``mod`` of another package."""
    return call(tbl, lo, mod=mod)


def flat(out):
    """The tensors of a wrapper's result, in order (RtOut first)."""
    got = []
    for x in out:
        if isinstance(x, torch.Tensor):
            got.append(x)
        else:
            got.extend(x)
    return got


if __name__ == "__main__":
    main()
