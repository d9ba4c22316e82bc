#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jurassic_torch``) on one GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device -- CUDA must be available; the card's name and power limit;
2. build -- the fused EGA kernel from ``jurassic_torch/csrc``, timed;
3. kernel vs plain version -- the CUDA kernel and ``rt_fused_turbo_ref``
   on the same CUDA tensors: the flagship shapes on a LOS the port traces
   on the card (1084 rays, 400 segments, 4 gases, 100 channels, all
   continua) and a small odd shape (9 channels); max errors, the
   kernel's time (CUDA events, median) and the plain version's;
4. goldens -- ``python -m jurassic_torch.cli.formod ... USEGPU 1`` on the
   ``ega`` and ``nadir`` goldens against the C oracle's ``rad.tab`` at
   the turbo bar (5e-3 of max|rad|, 5e-3 on tau), and the float32
   tangent points within 1e-2 km / 1e-2 degrees;
5. flagship formod -- ``ForwardModel.formod`` with ``KERNEL = auto``:
   warm-up, median wall time, rays*channels/s, a trace / kernel / D2H
   split; the kernel must have launched once per formod call and the
   radiances must match phase 3's kernel output; then one profiled
   formod: device busy time and kernel launches.

The second-to-last line is the kernel record as JSON, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNEL_TOL = 5e-5       # kernel vs plain version, both float32
GOLDEN_TOL = 5e-3       # turbo vs the C oracle (test_pallas_kernel.py:105)
# float32 tangent points vs the C oracle, km and degrees, and the rays
# allowed non-finite ones: JAX's float32 tracer's count on each golden
# (tests/test_torch_geometry_f32.py)
TP_TOL = 1e-2
MAX_NONFINITE_TP = {"ega": 0, "nadir": 8}
N_KERNEL_RUNS = 10
N_PLAIN_RUNS = 3
N_FORMOD_RUNS = 5


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


def compare(torch, ega_fused, args, label: str):
    """Kernel vs plain version on the same CUDA tensors: (max abs error
    over rad and tau, rad error relative to max|rad|, tau error,
    kernel rad)."""
    rad_k, tau_k = ega_fused.rt_fused_turbo(*args)
    torch.cuda.synchronize()
    rad_p, tau_p = ega_fused.rt_fused_turbo_ref(*args)
    torch.cuda.synchronize()
    if not (torch.isfinite(rad_k).all() and torch.isfinite(tau_k).all()):
        fail(f"{label}: kernel output not finite")
    d_rad = float((rad_k - rad_p).abs().max())
    d_tau = float((tau_k - tau_p).abs().max())
    scale = float(rad_p.abs().max())
    rel = d_rad / scale if scale > 0 else d_rad
    print(f"{label}: max|rad_k - rad_p| = {d_rad:.3e} "
          f"({rel:.3e} of max|rad| {scale:.4e}), "
          f"max|tau_k - tau_p| = {d_tau:.3e}", flush=True)
    if not (scale > 0 and rel <= KERNEL_TOL and d_tau <= KERNEL_TOL):
        fail(f"{label}: kernel and plain version disagree beyond "
             f"{KERNEL_TOL}")
    return max(d_rad, d_tau), rel, d_tau, rad_k


def run_golden(case: str) -> None:
    """The port's CLI on the card for tests/goldens/<case>, against the
    C oracle's rad.tab."""
    import numpy as np
    src = REPO / "tests" / "goldens" / case
    work = REPO / "jurassic_torch" / "_build" / "smoke" / case
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, work)
    ctl = next(work.glob("*.ctl")).name
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "jurassic_torch.cli.formod", ctl,
           "obs.tab", "atm.tab", "rad_port.tab", "USEGPU", "1"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                         text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"golden {case}: CLI exited {res.returncode}\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    last = [ln for ln in res.stdout.splitlines() if "kernel launches" in ln]
    if not last or "device cuda" not in last[-1] \
            or last[-1].split()[-1] == "0":
        fail(f"golden {case}: the CLI did not run the kernel on the card: "
             f"{last}")
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
    print(f"golden {case}: {ref.shape[0]} rays x {nd} channels, "
          f"rad {e_rad:.3e} of max|rad|, tau {e_tau:.3e} "
          f"(bar {GOLDEN_TOL}); tangent points z/lon/lat "
          f"{e_tp[0]:.3e} km / {e_tp[1]:.3e} / {e_tp[2]:.3e} deg (bar "
          f"{TP_TOL}), non-finite on {n_tp} rays (at most "
          f"{MAX_NONFINITE_TP[case]}); CLI {dt:.1f} s; {last[-1]}",
          flush=True)
    if not (np.isfinite(rad).all() and np.isfinite(tau).all()
            and e_rad <= GOLDEN_TOL and e_tau <= GOLDEN_TOL):
        fail(f"golden {case}: port differs from the C oracle")
    if not ((e_tp <= TP_TOL).all() and n_tp <= MAX_NONFINITE_TP[case]):
        fail(f"golden {case}: tangent points differ from the C oracle")


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


def main() -> None:

    phase("device")
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: the port's smoke run needs a GPU")
    dev = torch.device("cuda", 0)
    sys.path.insert(0, str(REPO))
    try:
        import jurassic_torch
        from jurassic_torch.forward import ForwardModel
        from jurassic_torch.ops import _build, ega_fused
        from jurassic_torch.ops.turbo_fit import build_turbo_tables_cached
        from jurassic_torch.workloads import flagship, small_limb
    except ImportError as e:
        fail(f"the jurassic_torch package is not importable here ({e})")
    if Path(jurassic_torch.__file__).resolve().parent.parent != REPO:
        fail("jurassic_torch does not come from this checkout")
    if "jax" in sys.modules:
        fail("the port imported jax")
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
        if "registers" in ln or "spill" in ln:
            print(f"  {ln.strip()}")

    phase("flagship set-up")
    ctl, ft, atm, obs = flagship()
    ctl.usetpu = 1
    t0 = time.perf_counter()
    tt, stats = build_turbo_tables_cached(
        ft, REPO / "jurassic_torch" / "_build" / "turbo_cache", dev)
    print(f"turbo fit (or cache load) {time.perf_counter() - t0:.1f} s: "
          f"{stats}", flush=True)
    fm = ForwardModel(ctl, fast_tables=ft, turbo_tables=tt,
                      turbo_stats=stats, device=dev)
    R, D = obs.nr, ctl.nd
    print(f"flagship: {R} rays x {D} channels, {ctl.ng} gases, "
          f"NLOS {ctl.nlos}, flags {fm.flags}, coef "
          f"{tuple(fm.turbo_tbl.coef.shape)}", flush=True)

    phase("kernel vs plain version")
    los = fm.trace(atm.copy(), obs.copy())
    torch.cuda.synchronize()
    args = (fm.turbo_tbl, fm.cc_rows, los, fm.flags, fm.ig_co2, fm.ig_h2o)
    err, rel, _, rad_flag = compare(torch, ega_fused, args,
                                    "flagship 1084x400x4x100")
    k_ms = cuda_ms(torch, lambda: ega_fused.rt_fused_turbo(*args),
                   N_KERNEL_RUNS)
    p_ms = cuda_ms(torch, lambda: ega_fused.rt_fused_turbo_ref(*args),
                   N_PLAIN_RUNS)
    print(f"flagship: kernel {k_ms:.3f} ms (median of {N_KERNEL_RUNS}), "
          f"plain version {p_ms:.1f} ms (median of {N_PLAIN_RUNS})",
          flush=True)
    ctl9, ft9, atm9, obs9 = small_limb(ng=4, nd=9, nr=37, nlos=120,
                                       rayds=20.0, raydz=1.0)
    ctl9.usetpu = 1
    fm9 = ForwardModel(ctl9, fast_tables=ft9, device=dev)
    los9 = fm9.trace(atm9, obs9)
    err9, _, _, _ = compare(
        torch, ega_fused,
        (fm9.turbo_tbl, fm9.cc_rows, los9, fm9.flags, fm9.ig_co2,
         fm9.ig_h2o), "small 37x120x4x9")

    phase("goldens through the port's CLI")
    for case in ("ega", "nadir"):
        run_golden(case)

    phase("flagship formod (KERNEL = auto)")
    if ctl.kernel != "auto":
        fail(f"flagship runs KERNEL = {ctl.kernel}, expected auto")
    ega_fused.LAUNCHES = 0
    fm.formod(atm.copy(), obs.copy())                  # warm-up
    walls = []
    for _ in range(N_FORMOD_RUNS):
        o_run = obs.copy()
        t0 = time.perf_counter()
        fm.formod(atm.copy(), o_run)
        walls.append(time.perf_counter() - t0)
    launches = ega_fused.LAUNCHES
    if launches != N_FORMOD_RUNS + 1:
        fail(f"the fused kernel launched {launches} times over "
             f"{N_FORMOD_RUNS + 1} formod runs")
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
    print(f"flagship formod: median {wall * 1e3:.1f} ms over "
          f"{N_FORMOD_RUNS} runs (min {min(walls) * 1e3:.1f}, max "
          f"{max(walls) * 1e3:.1f}); {R * D / wall:,.0f} rays*ch/s; "
          f"kernel launches {launches}", flush=True)
    print(f"flagship phase split: hydrostatics + trace "
          f"{(t1 - t0) * 1e3:.1f} ms, fused kernel + epilogue "
          f"{(t2 - t1) * 1e3:.1f} ms, D2H {(t3 - t2) * 1e3:.1f} ms",
          flush=True)
    import numpy as np
    rad = o_run.rad
    if rad.shape != (R, D) or not np.isfinite(rad).all():
        fail(f"flagship formod output malformed: {rad.shape}")
    d_formod = np.abs(rad - rad_flag.double().cpu().numpy()).max()
    if not d_formod <= KERNEL_TOL * np.abs(rad).max():
        fail(f"flagship formod radiances differ from the checked kernel "
             f"output by {d_formod:.3e}")
    if not np.array_equal(host[0], rad):
        fail("flagship formod and its phase-split rerun differ")

    profile_formod(torch, fm, atm, obs, wall * 1e3)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ega_fused_turbo", "route": "cuda",
        "source": "jurassic_torch/csrc/ega_fused_turbo.cu",
        "replaces": "jurassic_tpu/ops/pallas/ega_fused.py:1135",
        "launches": launches, "max_abs_err": max(err, err9),
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
