"""Where the time of the Jacobian's tracer kernels goes, on the CUDA card.

The record and tangent kernels of ``csrc/trace_rays_jvp.cu`` at the
flagship Jacobian (1084 rays, NLOS 400, 4 gases, the retrieval's
130-element state: HYDZ 20, T and the 4 gases' vmr at 10-60 km), in
float64 and float32:

  * each kernel's time alone, CUDA events around each launch, median of
    5: on every ray, the record kernel also on the busiest ray alone (one
    ray's chain, its floor), and on every fourth ray (271) in packages of
    91;
  * float64, an n-sweep: both kernels at n = 32, 130 and 256 tangents (the
    state's tangents cut, or repeated);
  * the registers and local memory (stack frame, spills) of both
    kernels and of the ``formod`` tracer kernel;
  * the holds: the records against ``geometry.trace_step_records_ref``
    (the fields bit for bit counted, the largest difference of the
    others), the tangents against ``geometry.trace_tangents_from_records_ref``
    on the kernel's records and, in float64, against
    ``geometry.trace_rays_jvp_ref`` (every flagship ray).

With ``--parent ROOT`` (a checkout of an earlier commit, for example
``git archive <commit> jurassic_torch | tar -x -C jurassic_torch/_build/parent``
here, which the chip copy takes along) it loads that checkout's package,
builds its library (beside this one's, started together) and runs its
tracer tangent entry on the same inputs: the LOS and the tangents compared
bit for bit on every ray, and the two entries' kernels timed in turns
(parent, this, this, parent).

With ``--variants`` it builds the tangent kernel's source in variants,
each with preprocessor macros (``VARIANTS``; ``--source NAME=PATH`` adds
another source with the same entry points, such as an earlier form of
it), and times their tangent kernels in turns on the same records, with
their registers and SASS instruction counts; the variants that are not
wrong by design must give the tangents bit for bit, and the tool says
whether they do.

With ``--profiler`` it repeats the sequence after which the CUDA-activity
profiler once recorded no launch of the table kernel (``chip_smoke.py``,
``profiled_call``): a profile of the eager float64 RT pass at the
flagship (about 10^5 launches), then a profile of one table-kernel pass,
``PROFILER_ROUNDS`` times, counting the hand-written launches each
profile recorded.

Run on a machine with a card, from the repository root::

    python -m jurassic_torch.tools.trace_jvp_split [--parent ROOT]
        [--variants] [--source NAME=PATH] [--profiler] [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from ..ops import _build, ega_fused
from ..ops import trace as ktrace
from ..ops import trace_jvp as tj

N_RUNS = 5
SWEEP_N = (32, 130, 256)
PACKAGE = 91
PROFILER_ROUNDS = 8
SPLIT_DIR = _build.BUILD_DIR / "trace_jvp_split"
SOURCE = _build.CSRC / "trace_rays_jvp.cu"
VARIANTS = {"full": [], "blocks2": ["JT_TAN_BLOCKS=2"],
            "blocks3": ["JT_TAN_BLOCKS=3"], "blocks4": ["JT_TAN_BLOCKS=4"],
            "noload": ["JT_SPLIT_NOLOAD"], "nodiv": ["JT_SPLIT_NODIV"]}
WRONG_BY_DESIGN = ("noload", "nodiv")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flagship_inputs(pkg: str, dtype, dev, rows=None):
    """(ctl, model, profiles, profile tangents, geometry) of the flagship
    retrieval's one package (the rays ``rows``, default all) from package
    ``pkg``."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")
    ctl, ft, atm, obs = imp("workloads").flagship()
    ctl.usetpu = 1 if torch.device(dev).type == "cuda" else 0
    ctl.kernel, ctl.hydz = "jax", 20.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 60.0
    ctl.retq_zmin, ctl.retq_zmax = [10.0] * ctl.ng, [60.0] * ctl.ng
    if rows is not None:
        obs = imp("forward")._obs_rows(obs, rows)
    m = imp("forward").ForwardModel(ctl, fast_tables=ft, device=dev,
                                    dtype=dtype)
    ret = imp("retrieval")
    prof, ptan, geo = ret.package_tangents(ctl, atm, obs, m,
                                           ret.autodiff_seed(ctl, atm, m))
    return ctl, m, prof, ptan, geo


def launch_ms(events_mod, fn, names, n: int = N_RUNS) -> dict:
    """{name: median ms} of the launches named ``names`` over ``n`` calls
    of ``fn`` after a warm-up, from the CUDA events the wrappers record
    around each launch into ``events_mod.LAUNCH_EVENTS``."""
    fn()
    torch.cuda.synchronize()
    events_mod.LAUNCH_EVENTS = []
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms = {k: [a.elapsed_time(b) for name, a, b in
                  events_mod.LAUNCH_EVENTS if name == k] for k in names}
    finally:
        events_mod.LAUNCH_EVENTS = None
    return {k: statistics.median(v) for k, v in ms.items()}


def both_ms(prof, ptan, geo, ctl) -> dict:
    args = (ctl.rayds, ctl.raydz, bool(ctl.refrac), ctl.nlos)
    ms = launch_ms(ega_fused, lambda: tj.trace_rays_jvp_cuda(
        prof, ptan, geo, *args), ("jt_trace_jvp_records",
                                  "jt_trace_jvp_tangents"))
    return {"record": ms["jt_trace_jvp_records"],
            "tangent": ms["jt_trace_jvp_tangents"]}


def rel_errs(got: dict, ref: dict) -> dict:
    out = {}
    for k, r in ref.items():
        sc = float(r.abs().max()) if r.numel() else 0.0
        d = float((got[k] - r).abs().max()) if r.numel() else 0.0
        out[k] = d / sc if sc > 0 else d
    return out


def holds(ctl, prof, ptan, geo, dtype) -> dict:
    """The kernels against their plain statements (and the whole against
    ``trace_rays_jvp_ref`` in float64) on these inputs."""
    from ..geometry import (TRACE_RECORD_PARTIALS, los_tangent_fields,
                            trace_record_fields, trace_rays_jvp_ref,
                            trace_step_records_ref,
                            trace_tangents_from_records_ref)
    args = (ctl.rayds, ctl.raydz, bool(ctl.refrac), ctl.nlos)
    G, W = ctl.ng, ctl.nw
    los, rec, flag = tj.trace_jvp_records_cuda(prof, geo, *args)
    los_t, _ = ktrace.trace_rays_cuda(prof, geo, *args)
    same_los = all(torch.equal(a, b) or bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        for a, b in zip(los, los_t))
    plain = trace_step_records_ref(ctl, prof, geo)
    got = trace_record_fields(rec.step)
    bits, part = {}, {}
    for k, r in trace_record_fields(plain.step).items():
        bits[k] = bool(torch.equal(got[k], r))
        if k in TRACE_RECORD_PARTIALS:
            part[k] = rel_errs({k: got[k]}, {k: r})[k]
    tan = tj.trace_jvp_tangents_cuda(prof, ptan, los, rec, ctl.refrac)
    tan_r = trace_tangents_from_records_ref(ctl, prof, ptan, los, rec)
    out = {"los_bit_for_bit": same_los, "flags": int(flag.sum()),
           "ray_records_bit_for_bit": bool(torch.equal(rec.ray, plain.ray)),
           "record_fields_bit_for_bit": bits, "record_partials": part,
           "tangent_vs_records_plain": rel_errs(
               los_tangent_fields(tan, G, W),
               los_tangent_fields(tan_r, G, W)),
           "tangent_vs_records_plain_bit_for_bit": bool(
               torch.equal(tan.seg, tan_r.seg)
               and torch.equal(tan.tsurf, tan_r.tsurf))}
    del plain, tan_r
    if dtype == torch.float64:
        _, tan_j = trace_rays_jvp_ref(ctl, prof, ptan, geo)
        out["tangent_vs_trace_rays_jvp_ref"] = rel_errs(
            los_tangent_fields(tan, G, W), los_tangent_fields(tan_j, G, W))
    return out, los, tan


def subset(prof, ptan, geo, rows):
    import numpy as np
    idx = torch.as_tensor(rows, device=prof.z.device)
    sub = prof._replace(**{f: getattr(prof, f)[idx].contiguous() for f in
                           ("z", "p", "t", "q", "k", "nlev", "zmin",
                            "zmax")})
    return (sub, ptan._replace(gi=ptan.gi[idx].contiguous()),
            {k: np.asarray(v)[rows] for k, v in geo.items()})


def with_n(ptan, n: int):
    d = ptan.d
    reps = -(-n // d.shape[2])
    return ptan._replace(d=d.repeat(1, 1, reps)[:, :, :n].contiguous())


def parent_compare(pkg: str, dtype, dev, los, tan, ctl, prof, ptan, geo):
    """The parent's tracer tangent entry on the same inputs: bit for bit,
    and its kernel and this tree's timed in turns."""
    pj = importlib.import_module(f"{pkg}.ops.trace_jvp")
    pf = importlib.import_module(f"{pkg}.ops.ega_fused")
    args = (ctl.rayds, ctl.raydz, bool(ctl.refrac), ctl.nlos)
    los_p, tan_p, _ = pj.trace_rays_jvp_cuda(prof, ptan, geo, *args)
    torch.cuda.synchronize()
    d = (tan.seg - tan_p.seg).abs()
    out = {"tangents_bit_for_bit": bool(torch.equal(tan.seg, tan_p.seg)
                                        and torch.equal(tan.tsurf,
                                                        tan_p.tsurf)),
           "los_bit_for_bit": all(
               bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
               for a, b in zip(los, los_p)),
           "max_abs_diff": float(d.max()),
           "max_rel_diff": float(d.max() / tan_p.seg.abs().max()),
           "lanes_differing": int((tan.seg != tan_p.seg).sum()),
           "ms": {"parent": [], "this": []}}
    for who in ("parent", "this", "this", "parent"):
        if who == "parent":
            ms = launch_ms(pf, lambda: pj.trace_rays_jvp_cuda(
                prof, ptan, geo, *args), ("jt_trace_rays_jvp",))
            out["ms"]["parent"].append(ms["jt_trace_rays_jvp"])
        else:
            ms = both_ms(prof, ptan, geo, ctl)
            out["ms"]["this"].append(ms["record"] + ms["tangent"])
    return out


def start_variant(name: str, source: Path, defines: list):
    """Start nvcc on ``source`` with ``defines``."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    obj = SPLIT_DIR / f"{name}.o"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
           *(f"-D{d}" for d in defines), "-c", "-o", str(obj), str(source)]
    return name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def finish_variant(name, obj, proc):
    """(the variant's library, its path), its entry points declared."""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
    out = SPLIT_DIR / f"libtrace_jvp_{name}.so"
    subprocess.run([_build.find_nvcc(), "-shared", "-o", str(out),
                    str(obj)], check=True)
    lib = ctypes.CDLL(str(out))
    for entry, argtypes in _build.ENTRY_POINTS.items():
        if entry.startswith("jt_trace_jvp_"):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, out


def sass_counts(lib_path: Path) -> dict:
    """{instantiation: {opcode group: SASS instructions}} of the tangent
    kernel's REFRAC 1 instantiations, or {} without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.find_nvcc()).parent / "cuobjdump")
    try:
        res = subprocess.run([tool, "-sass", str(lib_path)],
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return {}
    groups = {"f64": ("DFMA", "DMUL", "DADD", "DSETP"),
              "f32": ("FFMA", "FMUL", "FADD", "FSETP"), "mufu": ("MUFU",),
              "lds": ("LDS",), "ldg": ("LDG",), "stg": ("STG",),
              "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET")}
    counts, key = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            key = None
            for tag, dt in (("IdLb1E", "float64"), ("IfLb1E", "float32")):
                if "trace_jvp_tangent_kernel" + tag in name:
                    key = dt
                    counts[key] = {"all": 0, **dict.fromkeys(groups, 0)}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(\S+)",
                     ln)
        if m and key:
            op = m.group(1)
            counts[key]["all"] += 1
            for g, prefixes in groups.items():
                counts[key][g] += op.startswith(prefixes)
    return counts


def variants_phase(sources: dict, dev) -> dict:
    """The tangent kernel's variants (``VARIANTS`` of this source, and
    ``sources``) timed in turns on the flagship records, float64 and
    float32; bit for bit against ``full`` where not wrong by design."""
    jobs = [start_variant(name, SOURCE, d) for name, d in VARIANTS.items()]
    jobs += [start_variant(name, Path(path), [])
             for name, path in sources.items()]
    built = {job[0]: finish_variant(*job) for job in jobs}
    names = list(built)
    out = {"sass": {v: sass_counts(path) for v, (_, path) in built.items()}}
    package_lib = _build.load_library()
    try:
        for dtype in (torch.float64, torch.float32):
            name = str(dtype)[6:]
            ctl, _m, prof, ptan, geo = flagship_inputs("jurassic_torch",
                                                       dtype, dev)
            los, rec, _ = tj.trace_jvp_records_cuda(
                prof, geo, ctl.rayds, ctl.raydz, bool(ctl.refrac), ctl.nlos)
            call = lambda: tj.trace_jvp_tangents_cuda(prof, ptan, los, rec,
                                                      ctl.refrac)
            ref = None
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                _build._lib = built[v][0]
                ms[v].append(launch_ms(ega_fused, call,
                                       ("jt_trace_jvp_tangents",))[
                                           "jt_trace_jvp_tangents"])
                if len(ms[v]) == 1:
                    tan = call()
                    torch.cuda.synchronize()
                    if v == "full":
                        ref = tan
                    out.setdefault("registers", {})[f"{name} {v}"] = \
                        tj.registers(dtype, ctl.refrac)["tangent"]
                    out.setdefault("bit_for_bit", {})[f"{name} {v}"] = (
                        "wrong by design" if v in WRONG_BY_DESIGN else
                        None if ref is None else bool(
                            torch.equal(tan.seg, ref.seg)
                            and torch.equal(tan.tsurf, ref.tsurf)))
                    del tan
            _build._lib = package_lib
            out.setdefault("ms", {}).update(
                {f"{name} {v}": t for v, t in ms.items()})
            for v in names:
                print(f"{name} {v:10s} " + " / ".join(
                    f"{t:.3f}" for t in ms[v]) + " ms (medians of "
                    f"{N_RUNS}, two turns); registers, local bytes "
                    f"{out['registers'][f'{name} {v}']}; bit for bit "
                    f"full's: {out['bit_for_bit'][f'{name} {v}']}",
                    flush=True)
            del ref, los, rec, prof, ptan
            torch.cuda.empty_cache()
    finally:
        _build._lib = package_lib
    print(f"SASS of the tangent kernel (REFRAC 1): {json.dumps(out['sass'])}",
          flush=True)
    return out


def device_events(prof) -> list:
    from torch.autograd import DeviceType
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def profiler_probe(dev) -> dict:
    """PROFILER_ROUNDS times: a profile of the eager float64 RT pass at the
    flagship, then a profile of one table-kernel pass; the launches each
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    from ..forward import ForwardModel
    from ..geometry import LosData
    from ..workloads import flagship
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.kernel = 1, "jax"
    fm_e = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=torch.float64)
    ctl_p = flagship()[0]
    ctl_p.usetpu, ctl_p.kernel = 1, "pallas"
    fm_p = ForwardModel(ctl_p, fast_tables=ft, device=dev)
    los64 = fm_e.trace(atm, obs)
    los32 = LosData(*(f.float() if f.is_floating_point() else f
                      for f in los64))
    rounds = []
    for _ in range(PROFILER_ROUNDS):
        row = {}
        for key, fn in (("eager", lambda: fm_e.integrate(los64)),
                        ("table", lambda: fm_p.integrate(los32))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as pr:
                fn()
                torch.cuda.synchronize()
            names = device_events(pr)
            row[key] = len(names)
            if key == "table":
                row["table_kernel"] = sum("ega_fused_kernel" in n
                                          for n in names)
        rounds.append(row)
        print(f"  profiler round: {row}", flush=True)
    return {"rounds": rounds,
            "missed": sum(r["table_kernel"] != 1 for r in rounds)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an earlier checkout to compare with")
    ap.add_argument("--variants", action="store_true",
                    help="time the tangent kernel's variants in turns")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: another tangent source to time")
    ap.add_argument("--profiler", action="store_true",
                    help="run the profiler probe")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("trace_jvp_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    result = {"card": card}
    t0 = time.perf_counter()
    parent_build = None
    if ns.parent is not None:
        from .ega_split import load_parent
        load_parent(ns.parent.resolve())
        pb = importlib.import_module("jt_parent.ops._build")
        parent_build = threading.Thread(target=pb.load_library)
        parent_build.start()
    _build.load_library()
    if parent_build is not None:
        parent_build.join()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    regs = {}
    for dtype in (torch.float64, torch.float32):
        for refrac in (0, 1):
            key = f"{str(dtype)[6:]} refrac {refrac}"
            regs[key] = {"tracer": ktrace.registers(dtype, refrac),
                         **tj.registers(dtype, refrac)}
    if ns.parent is not None:
        pb = importlib.import_module("jt_parent.ops._build")
        regs["parent build log"] = [
            ln.strip() for ln in pb.build_log().splitlines()
            if "trace" in ln and ("registers" in ln or "spill" in ln
                                  or "Compiling entry" in ln)]
    result["registers"] = regs
    print(f"registers, local bytes: {json.dumps(regs)}", flush=True)

    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        ctl, m, prof, ptan, geo = flagship_inputs("jurassic_torch", dtype,
                                                  dev)
        r = {}
        h, los, tan = holds(ctl, prof, ptan, geo, dtype)
        r["holds"] = h
        print(f"{name} holds: {json.dumps(h)}", flush=True)
        if ns.parent is not None:
            r["parent"] = parent_compare("jt_parent", dtype, dev, los, tan,
                                         ctl, prof, ptan, geo)
            print(f"{name} against the parent: {json.dumps(r['parent'])}",
                  flush=True)
        del los, tan
        r["ms"] = both_ms(prof, ptan, geo, ctl)
        np_ = tj.trace_jvp_records_cuda(prof, geo, ctl.rayds, ctl.raydz,
                                        bool(ctl.refrac), ctl.nlos)[0].np_
        one = subset(prof, ptan, geo, [int(torch.argmax(np_))])
        r["ms_busiest_ray"] = both_ms(*one, ctl)
        pk = []
        rows4 = list(range(0, prof.z.shape[0], 4))
        for i in range(0, len(rows4), PACKAGE):
            pk.append(both_ms(*subset(prof, ptan, geo,
                                      rows4[i:i + PACKAGE]), ctl))
        r["ms_271_in_packages_of_91"] = {
            k: sum(p[k] for p in pk) for k in ("record", "tangent")}
        if dtype == torch.float64:
            r["ms_n_sweep"] = {n: both_ms(prof, with_n(ptan, n), geo, ctl)
                               for n in SWEEP_N}
        result[name] = r
        times = {k: v for k, v in r.items() if k.startswith("ms")}
        print(f"{name} times (ms): {json.dumps(times)}", flush=True)
        del m, prof, ptan
        torch.cuda.empty_cache()
    if ns.variants:
        result["variants"] = variants_phase(
            dict(x.split("=", 1) for x in ns.source), dev)
    if ns.profiler:
        result["profiler"] = profiler_probe(dev)
    print(card, flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if ns.out is not None:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
