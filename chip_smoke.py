#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jurassic_torch``) on one GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1.  device -- CUDA must be available; the card's name and power limit;
    the port must have loaded no ``jax*`` and no ``jurassic_tpu*`` module;
2.  build -- every kernel from ``jurassic_torch/csrc`` (one ``nvcc`` per
    source, started together), timed, with registers and spills;
3.  peak probes -- each CUDA probe against its plain PyTorch version
    (1e-5 relative, at loop counts where one step more or fewer would
    miss that bar), then the card's measured FP32 FMA, special-function
    and HBM copy rates through ``tools.peak.measure`` (the probes' main
    path);
4.  turbo kernel vs plain version -- the CUDA kernel and
    ``rt_fused_turbo_ref`` on the same CUDA tensors: the flagship shapes
    on a LOS the port traces on the card (1084 rays, 400 segments, 4
    gases, 100 channels, all continua) and a small odd shape (9
    channels); max errors, the kernel's time (CUDA events, median) and
    the plain version's;
5.  table kernel vs plain version -- the same for ``rt_fused_table`` on
    the exact log-uniform tables (40 x 30 cells x 224 rows);
6.  turbo kernel with taint vs plain version -- the flagship tables with
    three mid-atmosphere cells of one gas and one channel roughened by a
    staircase the Chebyshev fit cannot follow (``n_bad = 3``);
7.  goldens -- ``python -m jurassic_torch.cli.formod ... USEGPU 1`` on the
    ``ega`` and ``nadir`` goldens against the C oracle's ``rad.tab``: in
    turbo mode at the turbo bar (5e-3 of max|rad|, 5e-3 on tau), with
    ``KERNEL pallas`` at the table bar (2e-3), and the float32 tangent
    points within 1e-2 km / 1e-2 degrees;
8.  flagship formod -- ``ForwardModel.formod`` with ``KERNEL = auto``
    (turbo), ``KERNEL = pallas`` (table) and on the roughened tables
    (``turbo+hybrid``): warm-up, median wall time, rays*channels/s, a
    trace / kernel / D2H split.  The launch counts are set to 0 just
    before each path and read just after: one launch of each kernel the
    path runs per formod call.  The table result must lie within 2e-3 of
    max|rad| of the turbo result (the table-vs-turbo chord) and not
    within 1e-7 of it (which would mean the turbo kernel ran); the hybrid
    result within 2e-3 of the table result on the same tables, and bit
    for bit the table kernel's output on tainted lanes and the turbo
    kernel's on all others; then one profiled formod: device busy time
    and kernel launches.

Every model here is built with USEGPU = 1 on the CUDA device and every
CLI run passes ``USEGPU 1``: nothing can fall back to the CPU or to a
plain version.

The second-to-last line is the kernel record as JSON, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNEL_TOL = 5e-5       # kernel vs plain version, both float32
PROBE_TOL = 1e-5        # peak probe vs plain version, relative
# loop counts at which each sfu chain still tells its number of steps
SFU_COUNT_LOOPS = {"expf": (1, 2), "ex2": (1,), "lg2": (1,)}
TAINT_FLIP_MAX = 1e-3   # share of lanes whose taint may differ
# vs the C oracle (test_pallas_kernel.py:105 turbo, :28-38 table)
GOLDEN_TOL = {"turbo": 5e-3, "pallas": 2e-3}
CHORD_TOL = 2e-3        # table vs turbo on the same tables, of max|rad|
# float32 tangent points vs the C oracle, km and degrees, and the rays
# allowed non-finite ones: JAX's float32 tracer's count on each golden
# (tests/test_torch_geometry_f32.py)
TP_TOL = 1e-2
MAX_NONFINITE_TP = {"ega": 0, "nadir": 8}
N_KERNEL_RUNS = 10
N_FORMOD_RUNS = 5
# flagship cells (pressure index, temperature index) of gas 0, channel 2
# that the limb scan reads on ~10,000 segments each; roughening them gives
# the hybrid tainted lanes to re-evaluate
ROUGH_CELLS = ((15, 13), (17, 14), (18, 14))
ROUGH_GAS, ROUGH_CHANNEL, ROUGH_SEED = 0, 2, 7

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores and HBM3.  The bounds below divide by these.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Float32 operations per unit of work of the fused EGA kernels, counted
# from the sources (csrc/ega_*.cu), a transcendental as one operation:
#   turbo corner: two 9-term Clenshaw recurrences (2 x 28), the clips,
#     range extensions and selects (47), exp2, log2, 2 exp, 1 div -> 108
#   table corner: ceil(log2 K) search compares, two guarded lips (14), the
#     index arithmetic and clips (18), 2 exp2, log2 -> 35 + ceil(log2 K)
#   per gas: three guarded lips and clips (27), validity product, opacity
#     cut, tau_path (13), and for turbo eta_of (8 with its two logs)
#   per segment: continua (about 60 with pow, tanh, 2 exp, + 2 per
#     window), source interpolation (8), rad/tau recursion with exp (10)
OPS_TURBO_CORNER = 108
OPS_PER_GAS = {"turbo": 48, "table": 40}
OPS_PER_SEGMENT = 78


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n: int) -> float:
    """Median milliseconds of fn() over n runs, CUDA events, after one
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


def hold(torch, got, ref, label: str, mask=None):
    """(max abs error over rad and tau, kernel rad) of kernel outputs
    ``got`` against the plain version's ``ref`` within KERNEL_TOL (rad
    relative to max|rad|, tau absolute), on the lanes of ``mask``."""
    rad_k, tau_k = got[:2]
    rad_p, tau_p = ref[:2]
    if not (torch.isfinite(rad_k).all() and torch.isfinite(tau_k).all()):
        fail(f"{label}: kernel output not finite")
    e_rad, e_tau = (rad_k - rad_p).abs(), (tau_k - tau_p).abs()
    if mask is not None:
        e_rad, e_tau = e_rad[mask], e_tau[mask]
    d_rad, d_tau = float(e_rad.max()), float(e_tau.max())
    scale = float(rad_p.abs().max())
    rel = d_rad / scale if scale > 0 else d_rad
    print(f"{label}: max|rad_k - rad_p| = {d_rad:.3e} "
          f"({rel:.3e} of max|rad| {scale:.4e}), "
          f"max|tau_k - tau_p| = {d_tau:.3e}", flush=True)
    if not (scale > 0 and rel <= KERNEL_TOL and d_tau <= KERNEL_TOL):
        fail(f"{label}: kernel and plain version disagree beyond "
             f"{KERNEL_TOL}")
    return max(d_rad, d_tau), rad_k


def ega_bound(mode: str, rows, seg_shape, n_active: int, extra, rates):
    """(bound_ms, bound_by) of one fused EGA pass: the larger of the
    compulsory bytes (every input once, every output once) over the HBM
    rate and the float32 operations this run's data needs (``n_active``
    active segments) over the FP32 rate, both published peaks.  The same
    work over the rates the probes measured on this card (``rates``) is
    printed beside it."""
    G, _PT, Q, D = rows.shape
    R, S, F = seg_shape
    W = F - 8 - G
    n_bytes = 4 * (rows.numel() + R * S * F + R) \
        + sum(t.numel() * t.element_size() for t in extra) \
        + 4 * 2 * R * D
    if mode == "turbo":
        corner = OPS_TURBO_CORNER
    else:
        corner = 35 + math.ceil(math.log2(Q - 5))
    ops = n_active * D * (G * (4 * corner + OPS_PER_GAS[mode])
                          + OPS_PER_SEGMENT + 2 * W)
    t_b, t_o = n_bytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    print(f"  bound ({mode}): {n_bytes / 1e6:.1f} MB compulsory -> "
          f"{t_b * 1e3:.4f} ms at {PEAK_HBM_BYTES / 1e12} TB/s; "
          f"{ops / 1e9:.2f} GFLOP for {n_active} active segments -> "
          f"{t_o * 1e3:.4f} ms at {PEAK_FP32_FLOPS / 1e12} TFLOP/s; at "
          f"the measured {rates['hbm_copy_gbs']:.0f} GB/s and "
          f"{rates['fma_tflops']:.2f} TFLOP/s: "
          f"{n_bytes / rates['hbm_copy_gbs'] / 1e6:.4f} ms and "
          f"{ops / rates['fma_tflops'] / 1e9:.4f} ms", flush=True)
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def run_golden(case: str, kernel: str) -> None:
    """The port's CLI on the card for tests/goldens/<case>, against the
    C oracle's rad.tab; ``kernel`` is "turbo" (the ctl's own KERNEL,
    auto) or "pallas"."""
    import numpy as np
    src = REPO / "tests" / "goldens" / case
    work = REPO / "jurassic_torch" / "_build" / "smoke" / f"{case}_{kernel}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, work)
    ctl = next(work.glob("*.ctl")).name
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "jurassic_torch.cli.formod", ctl,
           "obs.tab", "atm.tab", "rad_port.tab", "USEGPU", "1"]
    if kernel == "pallas":
        cmd += ["KERNEL", "pallas"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                         text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"golden {case} ({kernel}): CLI exited {res.returncode}\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    last = [ln for ln in res.stdout.splitlines() if "kernel launches" in ln]
    want = ("variant turbo, fused EGA kernel launches turbo 1 table 0"
            if kernel == "turbo" else
            "variant table, fused EGA kernel launches turbo 0 table 1")
    if not last or "device cuda" not in last[-1] or want not in last[-1]:
        fail(f"golden {case} ({kernel}): the CLI did not run the kernel on "
             f"the card: {last}")
    ref = np.loadtxt(work / "rad.tab")
    out = np.loadtxt(work / "rad_port.tab")
    nd = (ref.shape[1] - 10) // 2
    rad_ref, tau_ref = ref[:, 10:10 + nd], ref[:, 10 + nd:10 + 2 * nd]
    rad, tau = out[:, 10:10 + nd], out[:, 10 + nd:10 + 2 * nd]
    scale = np.abs(rad_ref).max()
    e_rad = np.abs(rad - rad_ref).max() / scale
    e_tau = np.abs(tau - tau_ref).max()
    tp_ok = np.isfinite(out[:, 7:10]).all(axis=1)
    n_tp = int((~tp_ok).sum())
    e_tp = np.abs(out[tp_ok, 7:10] - ref[tp_ok, 7:10]).max(axis=0)
    tol = GOLDEN_TOL[kernel]
    print(f"golden {case} ({kernel}): {ref.shape[0]} rays x {nd} channels, "
          f"rad {e_rad:.3e} of max|rad|, tau {e_tau:.3e} "
          f"(bar {tol}); tangent points z/lon/lat "
          f"{e_tp[0]:.3e} km / {e_tp[1]:.3e} / {e_tp[2]:.3e} deg (bar "
          f"{TP_TOL}), non-finite on {n_tp} rays (at most "
          f"{MAX_NONFINITE_TP[case]}); CLI {dt:.1f} s; {last[-1]}",
          flush=True)
    if not (np.isfinite(rad).all() and np.isfinite(tau).all()
            and e_rad <= tol and e_tau <= tol):
        fail(f"golden {case} ({kernel}): port differs from the C oracle")
    if not ((e_tp <= TP_TOL).all() and n_tp <= MAX_NONFINITE_TP[case]):
        fail(f"golden {case}: tangent points differ from the C oracle")


def timed_formod(torch, ega_fused, fm, atm, obs, label: str, variant: str,
                 per_call: tuple):
    """Warm-up plus N_FORMOD_RUNS timed ``fm.formod`` calls with the
    launch counts set to 0 just before and read just after, then the
    phase split of one more call.  ``per_call`` is the (turbo, table)
    launches one call must make.  Returns (median wall seconds, the last
    timed call's radiances [R, D] float64, launches (turbo, table))."""
    import numpy as np
    R, D = obs.nr, fm.ctl.nd
    ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = 0
    fm.formod(atm.copy(), obs.copy())                  # warm-up
    walls = []
    for _ in range(N_FORMOD_RUNS):
        o_run = obs.copy()
        t0 = time.perf_counter()
        fm.formod(atm.copy(), o_run)
        walls.append(time.perf_counter() - t0)
    launches = (ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE)
    n = N_FORMOD_RUNS + 1
    if launches != (per_call[0] * n, per_call[1] * n):
        fail(f"{label}: the fused kernels launched (turbo, table) = "
             f"{launches} times over {n} formod runs")
    if fm.last_variant != variant:
        fail(f"{label}: ran variant {fm.last_variant}, expected {variant}")
    # phase split of one more formod, synchronising between phases
    a, o = atm.copy(), obs.copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    los_f = fm.trace(a, o)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = fm.integrate(los_f)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host = fm.outputs_to_host((out.rad, out.tau, los_f.tpz, los_f.tplon,
                               los_f.tplat))
    t3 = time.perf_counter()
    wall = statistics.median(walls)
    print(f"{label}: median {wall * 1e3:.1f} ms over "
          f"{N_FORMOD_RUNS} runs (min {min(walls) * 1e3:.1f}, max "
          f"{max(walls) * 1e3:.1f}); {R * D / wall:,.0f} rays*ch/s; "
          f"kernel launches turbo {launches[0]} table {launches[1]}; "
          f"variant {fm.last_variant}", flush=True)
    print(f"{label} phase split: hydrostatics + trace "
          f"{(t1 - t0) * 1e3:.1f} ms, fused kernel(s) + epilogue "
          f"{(t2 - t1) * 1e3:.1f} ms, D2H {(t3 - t2) * 1e3:.1f} ms",
          flush=True)
    rad = o_run.rad
    if rad.shape != (R, D) or not np.isfinite(rad).all():
        fail(f"{label}: output malformed: {rad.shape}")
    if not np.array_equal(host[0], rad):
        fail(f"{label}: formod and its phase-split rerun differ")
    return wall, rad, launches


def profile_formod(torch, fm, atm, obs, wall_ms: float) -> None:
    """Device time and kernel launches of one flagship formod
    (torch.profiler, CUDA activity): where the time goes.  The busy share
    is taken of ``wall_ms``, the median formod time without the
    profiler, which slows the host side many times over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fm.formod(atm.copy(), obs.copy())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms <= 0:
        fail("the profiler recorded no device time")
    print(f"flagship formod profiled: {wall * 1e3:.1f} ms wall (with "
          f"profiler), device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}"
          f" of the {wall_ms:.1f} ms median formod), "
          f"{sum(e.count for e in kernels)} device kernel launches",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d} x  {e.key[:90]}")


def probe_phase(torch, peak, dev):
    """Each probe against its plain version, then the measured rates
    through ``peak.measure`` (the probes' main path) with the launch
    counts set to 0 just before and read just after.  Returns the three
    kernel records."""
    def rel_err(got, ref, label):
        torch.cuda.synchronize()
        err = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        print(f"probe {label}: max relative error vs plain version "
              f"{err:.3e}", flush=True)
        if not err <= PROBE_TOL:
            fail(f"probe {label} disagrees with its plain version")
        return float((got - ref).abs().max())

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * peak.BLOCKS_PER_SM
    init = peak.probe_init(blocks, dev)
    small, loops = 2, peak.LOOPS
    errs = {"fma": 0.0, "sfu": 0.0, "copy": 0.0}
    # Loop counts that tell the number of steps.  The fma chain moves by
    # 1e-3 of its distance to 1 per step.  The sfu chains contract fast,
    # so they are compared after one and two loop iterations, and only
    # where the plain version itself, one step short or long, would miss
    # the bar by ten times (SFU_COUNT_LOOPS).
    errs["fma"] = rel_err(peak.fma_probe(init, small),
                          peak.fma_ref(init, small), f"fma x{small}")
    for op, counts in SFU_COUNT_LOOPS.items():
        for n in counts:
            ref = peak.sfu_ref(init, op, n)
            errs["sfu"] = max(errs["sfu"], rel_err(
                peak.sfu_probe(init, op, n), ref, f"sfu {op} x{n}"))
            steps = n * peak.SFU_INNER
            gap = min(float(((peak.sfu_steps(init, op, k) - ref).abs()
                             / ref.abs()).max())
                      for k in (steps - 1, steps + 1))
            print(f"  ({steps} steps; one step more or fewer moves the "
                  f"plain version by {gap:.1e})", flush=True)
            if not gap > 10 * PROBE_TOL:
                fail(f"probe sfu {op} x{n} does not tell the step count")
    # ... and the shapes the main path runs, timed
    t0 = time.perf_counter()
    ref = peak.fma_ref(init, loops)
    torch.cuda.synchronize()
    plain = {"fma": (time.perf_counter() - t0) * 1e3, "sfu": 0.0}
    errs["fma"] = max(errs["fma"], rel_err(peak.fma_probe(init, loops), ref,
                                           f"fma x{loops}"))
    for op in peak.SFU_OPS:
        t0 = time.perf_counter()
        ref = peak.sfu_ref(init, op, peak.SFU_LOOPS)
        torch.cuda.synchronize()
        plain["sfu"] += (time.perf_counter() - t0) * 1e3
        errs["sfu"] = max(errs["sfu"], rel_err(
            peak.sfu_probe(init, op, peak.SFU_LOOPS), ref,
            f"sfu {op} x{peak.SFU_LOOPS}"))
    n = peak.COPY_BYTES // 4
    src = torch.empty(n, dtype=torch.float32, device=dev).uniform_()
    if not torch.equal(peak.copy_probe(src, blocks), src):
        fail("probe copy disagrees with its plain version")
    plain["copy"] = cuda_ms(torch, lambda: peak.copy_ref(src), 5)
    del src
    torch.cuda.empty_cache()

    for k in peak.LAUNCHES:
        peak.LAUNCHES[k] = 0
    m = peak.measure(force=True)
    launches = dict(peak.LAUNCHES)
    if not all(v > 0 for v in launches.values()):
        fail(f"peak.measure did not launch every probe: {launches}")
    print(f"peak rates on {m['card']} ({m['sm_count']} SMs, clocks sm/mem "
          f"{m['clocks_sm_mem_mhz']}, {m['blocks']} blocks x "
          f"{peak.THREADS} threads x {peak.NACC} chains): FP32 FMA "
          f"{m['fma_tflops']:.2f} TFLOP/s; SFU "
          + ", ".join(f"{op} {m['sfu_gops'][op]:.0f} Gop/s"
                      for op in peak.SFU_OPS)
          + f"; HBM copy {m['hbm_copy_gbs']:.0f} GB/s (read + write)",
          flush=True)
    print(json.dumps({"peak": m}), flush=True)
    steps = m["chain_steps"]
    src_file = "jurassic_torch/csrc/peak_probes.cu"
    t_sfu = sum(m["t_sfu"][op][0] for op in peak.SFU_OPS) * 1e3
    return m, [
        {"name": "peak_fma", "route": "cuda", "source": src_file,
         "replaces": "tools/vpu_peak.py:33", "launches": launches["fma"],
         "max_abs_err": errs["fma"], "ms": m["t_fma"][0] * 1e3,
         "plain_ms": plain["fma"],
         "bound_ms": 2 * steps / PEAK_FP32_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None},
        {"name": "peak_sfu", "route": "cuda", "source": src_file,
         "replaces": "tools/vpu_peak.py:56", "launches": launches["sfu"],
         "max_abs_err": errs["sfu"], "ms": t_sfu, "plain_ms": plain["sfu"],
         "bound_ms": len(peak.SFU_OPS) * steps / PEAK_FP32_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None},
        {"name": "peak_hbm_copy", "route": "cuda", "source": src_file,
         "replaces": "tools/vpu_peak.py:76", "launches": launches["copy"],
         "max_abs_err": 0.0, "ms": m["t_copy"][0] * 1e3,
         "plain_ms": plain["copy"],
         "bound_ms": 2.0 * m["copy_bytes"] / PEAK_HBM_BYTES * 1e3,
         "bound_by": "bytes", "library_ms": plain["copy"]},
    ]


def main() -> None:

    phase("device")
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: the port's smoke run needs a GPU")
    dev = torch.device("cuda", 0)
    sys.path.insert(0, str(REPO))
    try:
        import jurassic_torch
        from jurassic_torch.forward import ForwardModel, rt_epilogue
        from jurassic_torch.ops import _build, ega_fused
        from jurassic_torch.ops.turbo_fit import build_turbo_tables_cached
        from jurassic_torch.tools import peak
        from jurassic_torch.workloads import flagship, small_limb
    except ImportError as e:
        fail(f"the jurassic_torch package is not importable here ({e})")
    if Path(jurassic_torch.__file__).resolve().parent.parent != REPO:
        fail("jurassic_torch does not come from this checkout")

    def import_hygiene():
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "jurassic_tpu"))
        if bad:
            fail(f"the port imported {bad[:5]}")
    import_hygiene()
    import numpy as np
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build + load {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    for ln in _build.build_log().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  {ln.strip()[:200]}")

    phase("peak probes")
    rates, probe_records = probe_phase(torch, peak, dev)

    phase("flagship set-up")
    cache = REPO / "jurassic_torch" / "_build" / "turbo_cache"
    ctl, ft, atm, obs = flagship()
    ctl.usetpu = 1
    if ctl.kernel != "auto":
        fail(f"flagship runs KERNEL = {ctl.kernel}, expected auto")
    t0 = time.perf_counter()
    tt, stats = build_turbo_tables_cached(ft, cache, dev)
    print(f"turbo fit (or cache load) {time.perf_counter() - t0:.1f} s: "
          f"{stats}", flush=True)
    fm = ForwardModel(ctl, fast_tables=ft, turbo_tables=tt,
                      turbo_stats=stats, device=dev)
    R, D = obs.nr, ctl.nd
    ctl_p, _, _, _ = flagship()
    ctl_p.usetpu, ctl_p.kernel = 1, "pallas"
    t0 = time.perf_counter()
    fm_p = ForwardModel(ctl_p, fast_tables=ft, device=dev)
    if fm_p.turbo_tbl is not None or not fm_p.table_tbl.monotone:
        fail("KERNEL = pallas did not build monotone table-mode tables")
    print(f"flagship: {R} rays x {D} channels, {ctl.ng} gases, "
          f"NLOS {ctl.nlos}, flags {fm.flags}, coef "
          f"{tuple(fm.turbo_tbl.coef.shape)}, eps_aug "
          f"{tuple(fm_p.table_tbl.eps_aug.shape)} (packed in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    # the roughened flagship: a staircase the Chebyshev fit cannot follow
    # (tests/test_pallas_kernel.py:381-389) in three cells
    eps = np.array(ft.eps)
    rng = np.random.default_rng(ROUGH_SEED)
    stair = np.cumsum(rng.uniform(0, 1, eps.shape[3]) ** 8)
    stair = (0.1 + 0.8 * stair / stair[-1]).astype(np.float32)
    for (ip, it) in ROUGH_CELLS:
        eps[ROUGH_GAS, ip, it, :, ROUGH_CHANNEL] = stair
    ft_r = ft._replace(eps=eps)
    t0 = time.perf_counter()
    tt_r, stats_r = build_turbo_tables_cached(ft_r, cache, dev)
    print(f"roughened flagship: turbo fit (or cache load) "
          f"{time.perf_counter() - t0:.1f} s: {stats_r}, n_bad "
          f"{tt_r.n_bad}", flush=True)
    if not (0 < tt_r.n_bad and tt_r.n_bad / stats_r.rows <= 0.05):
        fail(f"roughened flagship: n_bad = {tt_r.n_bad} of {stats_r.rows}")
    ctl_h, _, _, _ = flagship()
    ctl_h.usetpu, ctl_h.kernel = 1, "turbo"
    fm_h = ForwardModel(ctl_h, fast_tables=ft_r, turbo_tables=tt_r,
                        turbo_stats=stats_r, device=dev)
    if fm_h.table_tbl is None:
        fail("the hybrid model has no exact backing")
    fm_rp = ForwardModel(ctl_p, fast_tables=ft_r, device=dev)
    del eps, ft_r

    phase("turbo kernel vs plain version")
    los = fm.trace(atm.copy(), obs.copy())
    torch.cuda.synchronize()
    n_active = int(los.valid.sum())
    seg_shape = tuple(ega_fused.pack_segments(los, fm.ig_co2,
                                              fm.ig_h2o).shape)
    common = (fm.cc_rows, los, fm.flags, fm.ig_co2, fm.ig_h2o)
    args = (fm.turbo_tbl, *common)
    got = ega_fused.rt_fused_turbo(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ega_fused.rt_fused_turbo_ref(*args)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    err, rad_flag = hold(torch, got, ref, "turbo flagship 1084x400x4x100")
    k_ms = cuda_ms(torch, lambda: ega_fused.rt_fused_turbo(*args),
                   N_KERNEL_RUNS)
    print(f"turbo flagship: kernel {k_ms:.3f} ms (median of "
          f"{N_KERNEL_RUNS}), plain version {p_ms:.1f} ms (one run)",
          flush=True)
    t = fm.turbo_tbl
    small_extra = lambda t: (t.sr, t.chan_mask, fm.cc_rows, t.p_ax, t.t_ax,
                             t.np_u, t.nt_u)
    b_ms, b_by = ega_bound("turbo", t.coef, seg_shape, n_active,
                           small_extra(t), rates)
    ctl9, ft9, atm9, obs9 = small_limb(ng=4, nd=9, nr=37, nlos=120,
                                       rayds=20.0, raydz=1.0)
    ctl9.usetpu = 1
    fm9 = ForwardModel(ctl9, fast_tables=ft9, device=dev)
    los9 = fm9.trace(atm9, obs9)
    common9 = (fm9.cc_rows, los9, fm9.flags, fm9.ig_co2, fm9.ig_h2o)
    err9, _ = hold(torch, ega_fused.rt_fused_turbo(fm9.turbo_tbl, *common9),
                   ega_fused.rt_fused_turbo_ref(fm9.turbo_tbl, *common9),
                   "turbo small 37x120x4x9")

    phase("table kernel vs plain version")
    args_t = (fm_p.table_tbl, *common)
    got = ega_fused.rt_fused_table(*args_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ega_fused.rt_fused_table_ref(*args_t)
    torch.cuda.synchronize()
    pt_ms = (time.perf_counter() - t0) * 1e3
    err_t, rad_table = hold(torch, got, ref,
                            "table flagship 1084x400x4x100, K = 224")
    kt_ms = cuda_ms(torch, lambda: ega_fused.rt_fused_table(*args_t),
                    N_KERNEL_RUNS)
    print(f"table flagship: kernel {kt_ms:.3f} ms (median of "
          f"{N_KERNEL_RUNS}), plain version {pt_ms:.1f} ms (one run)",
          flush=True)
    t = fm_p.table_tbl
    bt_ms, bt_by = ega_bound("table", t.eps_aug, seg_shape, n_active,
                             small_extra(t), rates)
    ctl9.kernel = "pallas"
    fm9p = ForwardModel(ctl9, fast_tables=ft9, device=dev)
    err_t9, _ = hold(
        torch, ega_fused.rt_fused_table(fm9p.table_tbl, *common9),
        ega_fused.rt_fused_table_ref(fm9p.table_tbl, *common9),
        "table small 37x120x4x9")
    del got, ref

    phase("turbo kernel with taint vs plain version")
    args_h = (fm_h.turbo_tbl, *common)
    rad_k, tau_k, taint_k = ega_fused.rt_fused_turbo(*args_h)
    torch.cuda.synchronize()
    rad_r, tau_r, taint_r = ega_fused.rt_fused_turbo_ref(*args_h)
    torch.cuda.synchronize()
    if taint_k is None or taint_r is None or not taint_r.any():
        fail("the roughened tables tainted no lane")
    same = taint_k == taint_r
    n_flip = int((~same).sum())
    print(f"taint: kernel {int(taint_k.sum())} lanes, plain version "
          f"{int(taint_r.sum())} of {taint_r.numel()}; {n_flip} differ "
          f"(at most {TAINT_FLIP_MAX:.0e} of all lanes)", flush=True)
    if n_flip > TAINT_FLIP_MAX * same.numel():
        fail("kernel and plain version disagree on the taint map")
    err_h, _ = hold(torch, (rad_k, tau_k), (rad_r, tau_r),
                    "turbo with taint, roughened flagship", mask=same)
    kh_ms = cuda_ms(torch, lambda: ega_fused.rt_fused_turbo(*args_h),
                    N_KERNEL_RUNS)
    k2_ms = cuda_ms(torch, lambda: ega_fused.rt_fused_turbo(*args),
                    N_KERNEL_RUNS)
    print(f"turbo kernel with the taint output {kh_ms:.3f} ms, without "
          f"{k2_ms:.3f} ms (medians of {N_KERNEL_RUNS}, in turns)",
          flush=True)
    del rad_k, tau_k, rad_r, tau_r

    phase("goldens through the port's CLI")
    for kernel in ("turbo", "pallas"):
        for case in ("ega", "nadir"):
            run_golden(case, kernel)

    phase("flagship formod (KERNEL = auto)")
    wall, rad, launches = timed_formod(
        torch, ega_fused, fm, atm, obs, "flagship formod auto", "turbo",
        (1, 0))
    d_formod = np.abs(rad - rad_flag.double().cpu().numpy()).max()
    if not d_formod <= KERNEL_TOL * np.abs(rad).max():
        fail(f"flagship formod radiances differ from the checked kernel "
             f"output by {d_formod:.3e}")

    phase("flagship formod (KERNEL = pallas)")
    wall_p, rad_p, launches_p = timed_formod(
        torch, ega_fused, fm_p, atm, obs, "flagship formod pallas", "table",
        (0, 1))
    scale = np.abs(rad).max()
    chord = np.abs(rad_p - rad).max() / scale
    print(f"table vs turbo flagship radiances: {chord:.3e} of max|rad| "
          f"(bar {CHORD_TOL}, and more than 1e-7)", flush=True)
    if not 1e-7 < chord <= CHORD_TOL:
        fail("KERNEL = pallas radiances are not the table kernel's")
    d_formod = np.abs(rad_p - rad_table.double().cpu().numpy()).max()
    if not d_formod <= KERNEL_TOL * scale:
        fail(f"KERNEL = pallas formod radiances differ from the checked "
             f"kernel output by {d_formod:.3e}")

    phase("hybrid flagship formod (roughened tables)")
    wall_h, rad_h, launches_h = timed_formod(
        torch, ega_fused, fm_h, atm, obs, "flagship formod hybrid",
        "turbo+hybrid", (1, 1))
    o_rp = obs.copy()
    fm_rp.formod(atm.copy(), o_rp)
    d_h = np.abs(rad_h - o_rp.rad).max() / np.abs(o_rp.rad).max()
    n_lane = int((rad_h == o_rp.rad).sum())
    print(f"hybrid vs KERNEL = pallas on the roughened tables: {d_h:.3e} of "
          f"max|rad| (bar {CHORD_TOL}); {n_lane} of {rad_h.size} lanes "
          f"equal the table kernel's bit for bit", flush=True)
    if not d_h <= CHORD_TOL:
        fail("the hybrid result is not within the chord of the table "
             "kernel's")
    # The splice, exactly.  On the LOS and the taint map of the kernel
    # phases, integrate() of the hybrid equals the table kernel's output
    # on the roughened tables on every tainted lane and the turbo
    # kernel's on every other lane, bit for bit (the epilogue works lane
    # by lane), and the two kernels differ on tainted lanes.
    n_taint = int(taint_k.sum())
    out_h = fm_h.integrate(los)
    out_t = fm_rp.integrate(los)
    out_u = rt_epilogue(*ega_fused.rt_fused_turbo(*args_h)[:2], fm_h.sr,
                        fm_h.st, fm_h.nu, los.tsurf, bool(ctl_h.write_bbt))
    n_diff = int((out_t.rad[taint_k] != out_u.rad[taint_k]).sum())
    print(f"hybrid splice: {n_taint} tainted lanes, on {n_diff} of them "
          f"the table and turbo kernels differ", flush=True)
    if n_lane < n_taint or n_diff == 0:
        fail("the hybrid formod does not carry the table kernel's lanes")
    for h, t, u in zip(out_h, out_t, out_u):
        if not (torch.equal(h[taint_k], t[taint_k])
                and torch.equal(h[~taint_k], u[~taint_k])):
            fail("the hybrid splice is not the table kernel's output on "
                 "tainted lanes and the turbo kernel's elsewhere")

    profile_formod(torch, fm, atm, obs, wall * 1e3)
    import_hygiene()

    print(card, flush=True)
    fused = {"route": "cuda", "library_ms": None}
    print(json.dumps({"kernels": [
        {"name": "ega_fused_turbo", **fused,
         "source": "jurassic_torch/csrc/ega_fused_turbo.cu",
         "replaces": "jurassic_tpu/ops/pallas/ega_fused.py:1135",
         "launches": launches[0], "max_abs_err": max(err, err9, err_h),
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by},
        {"name": "ega_fused_table", **fused,
         "source": "jurassic_torch/csrc/ega_fused_table.cu",
         "replaces": "jurassic_tpu/ops/pallas/ega_fused.py:859",
         "launches": launches_p[1], "max_abs_err": max(err_t, err_t9),
         "ms": kt_ms, "plain_ms": pt_ms, "bound_ms": bt_ms,
         "bound_by": bt_by},
        *probe_records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
