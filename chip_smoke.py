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
    gases, 100 channels, all continua), a small odd shape (9 channels)
    and two scrambled batches (coarse steps on 8 x 5 tables, so that the
    bracketed cells change at most segments; rays in random order, some
    empty and some with the full segment budget; 4 gases and 9 gases, the
    generic form), on which what the kernel shares between the rays of a
    block does not hold; max errors, the kernel's time (CUDA events,
    median) and the plain version's;
5.  table kernel vs plain version -- the same for ``rt_fused_table`` on
    the exact log-uniform tables (40 x 30 cells x 224 rows); on the
    scrambled batches the row index it remembers from the last segment
    mostly misses;
6.  turbo kernel with taint vs plain version -- the flagship tables with
    three mid-atmosphere cells of one gas and one channel roughened by a
    staircase the Chebyshev fit cannot follow (``n_bad = 3``);
7.  tracer kernel vs plain version -- ``csrc/trace_rays.cu`` against
    ``geometry.trace_rays_ref`` on the same CUDA tensors, in float32 and
    float64, on the flagship (REFRAC 1) and its pencil geometry (REFRAC 0
    on the flat dummy profiles), the ``limb``, ``nadir`` (ground hits,
    one-level windows), ``ega``, ``fov`` and ``gas30`` geometries, and a
    small limb scan with RAYDZ 0, an observer inside the atmosphere, rays
    never traced and one-level windows (``workloads.trace_cases``), and
    on the edge shapes of ``workloads.TRACE_EDGE_SHAPES`` (L at 1, 2 and
    around 32 and 64, G and W of 0, 1 and 30, R of 1, 33 and 1084, tied
    and non-monotone grids, a ray over 48 KB of shared memory): ``np_``
    and ``valid`` identical on every ray and every float field bit for
    bit, tangent points within 1e-3 km / deg, no bisection flag; the kernel's branch-free float sqrt,
    reciprocal and division equal to the operations on every float (sqrt,
    reciprocal) and on 2^28 random pairs (division,
    ``ops.trace.fast_ops_check``); at the flagship the wrapper's time
    (CUDA events around the call, with its allocation and geometry copy,
    median of 10), the kernel's alone (CUDA events around each launch)
    on every ray, on the busiest (one ray's chain latency,
    the floor), on one a SM and in float64, the launch's shared memory,
    the plain version's time, the bound, and the turbo pass on the
    kernel's LOS bit for bit the same pass on the plain version's (the
    build phase prints ptxas's registers, spills and shared memory of
    each instantiation);
8.  goldens -- ``python -m jurassic_torch.cli.formod ... USEGPU 1`` on the
    ``ega`` and ``nadir`` goldens against the C oracle's ``rad.tab`` (the
    ``ega`` turbo run with ``BENCH 3``, whose repeat runs must show no
    deviations: the kernels are reproducible run to run): in
    turbo mode at the turbo bar (5e-3 of max|rad|, 5e-3 on tau), with
    ``KERNEL pallas`` at the table bar (2e-3), and the float32 tangent
    points within 1e-2 km / 1e-2 degrees, none of them non-finite (the
    tracer's guard of the parabola fit, ``geometry.tangent_point``);
9.  flagship formod -- ``ForwardModel.formod`` with ``KERNEL = auto``
    (turbo), ``KERNEL = pallas`` (table) and on the roughened tables
    (``turbo+hybrid``): warm-up, median wall time, rays*channels/s, and
    the phase split of the median call itself (``ForwardModel.phase_log``:
    CUDA events at the boundaries of hydrostatics, trace, kernel(s),
    epilogue, D2H, the hybrid re-run and the host's FOV and mask inside
    each timed call, the host's ray profiles under ``profiles``), whose
    parts must add up to within 5 % of that call's wall time.  The launch
    counts are set to 0 just before each path and read just after: one
    launch of each kernel the path runs per formod call, the tracer's
    included.  The table result must lie within 2e-3 of
    max|rad| of the turbo result (the table-vs-turbo chord) and not
    within 1e-7 of it (which would mean the turbo kernel ran); the hybrid
    result within 2e-3 of the table result on the same tables, and bit
    for bit the table kernel's output on tainted lanes and the turbo
    kernel's on all others; then one profiled formod: device busy time
    (the union of the device activities' intervals, so that two streams'
    overlap counts once) and kernel launches, the profiler's record of
    every hand-written kernel's launch checked against CUDA events
    recorded around them (``ega_fused.LAUNCH_EVENTS``) in the same call.
10. eager oracles -- ``KERNEL = exact`` in float64 on the card on the
    ``limb``, ``nadir``, ``ega``, ``flagship``, ``gas30`` and ``fov``
    goldens at the JAX package's bars (``flagship`` and ``gas30`` with
    their tables made by ``tools/make_synthetic_tables.py``), ``fast`` on
    ``ega`` at 2e-3, through the RT kernel (``csrc/ega_rt.cu``: one
    launch per package, no fused kernel launched); at the flagship one
    float64 trace, the eager ``jax`` loop (``integrate_eager``) in
    float64 against the table kernel on the same LOS cast to float32
    (1e-5 of max|rad|, 1e-5 on tau), each pass's time and device
    launches;
11. packages -- the flagship with ``RAYPACK 271`` (4 packages on two CUDA
    streams) under ``KERNEL = auto``, ``pallas`` and the hybrid: bit for
    bit the one-package run, one fused launch per package (the hybrid's
    table launches: one per package that carries taint), medians beside
    the one-package medians, the device's idle share; ``RAYPACK 0``'s
    sizing (bytes per ray, free memory, rays per package), and the
    estimate against ``torch.cuda.max_memory_allocated()`` of a
    one-package run, which it must not undercut;
12. pencil -- ``IP = 2`` and ``IP = 3`` at the flagship width (every
    eighth ray) on a three-profile track with identical profiles and
    ``REFRAC 0``, against ``IP = 1`` (2e-3 / 0.1 of max|rad|, the JAX
    test's bars), through the turbo kernel;
13. retrieval Jacobians -- first the tangent kernels of the
    forward-mode Jacobian (the tracer's record and tangent kernels,
    ``csrc/trace_rays_jvp.cu``; the RT pass's record and contraction
    kernels, ``csrc/ega_jvp_fast.cu``) against their plain versions
    (``geometry.trace_rays_jvp_ref`` for the tracer's entry, and
    ``trace_step_records_ref`` and ``trace_tangents_from_records_ref`` for
    each tracer kernel: the records bit for bit but for their partials;
    ``ops.ega_jvp.rt_jvp_records_ref`` and ``rt_jvp_contract_ref`` for
    each RT kernel, ``forward.rt_integrate_jvp_ref`` for the RT entry) on
    the same CUDA
    tensors in float64 and float32, on a small limb scan in each tracer
    branch (9 tangents; 40 as well on the plain scan), a ground-hitting
    scan with the brightness conversion and every 30th flagship ray with
    the main path's own 130 tangents (the block shapes and kernel
    instantiations the flagship runs), the plain scan at both n and the
    flagship case also on tables whose axes differ per channel (the
    record kernel's per-channel instantiation), after the tracer tangent
    kernel's division by a block-wide reciprocal against the division on
    2^28 random pairs a dtype (``ops.trace_jvp.quo_check``, bit for bit):
    the tracer's record kernel's LOS bit for bit the tracer kernel's,
    each tangent field, the
    record kernel's A (per LOS field), a_surf, rad and tau, the
    contraction and drad within 1e-10 (float64) / 1e-3 (float32) of
    their max, whether rad, tau and A are bit for bit printed; then the
    flagship with HYDZ 20 (the hydrostatic rebuild in the seed):
    ``kernel_autodiff`` on the 130-element state (T and the 4 gases' vmr
    at the 26 levels of 10-60 km) through the tangent kernels (the main
    path: the launch counts set to 0 just before and read just after,
    each kernel once per package, no other kernel) in float64 and
    float32 (profiled: device launches and busy time), wall time,
    packages, peak memory against the sizing estimate (within 2x); the
    float64 K against ``kernel_autodiff_jacfwd``'s (the
    ``torch.func.jacfwd`` route, float64) per quantity within 1e-9 of its
    max|K|, the float32 K against that at ``AD_F32_TOL``; the jacfwd
    route in float32 on every fourth ray under the profiler (its
    launches and busy time); the host cost of one operation under
    ``jacfwd`` (``jvp_dispatch``); the FD ``retrieval.kernel`` on a
    5-element state (T at 10-18 km) through ``KERNEL = auto`` (n+1 turbo
    launches) and ``KERNEL = pallas`` (n+1 table launches), each held to
    those columns of the float64 autodiff at the JAX package's bars (2e-2
    of max|K| plus 0.05 relative); the float64 autodiff on the card
    against the CPU's plain tangent chain on a small case (1e-10 of
    max|K|); the packages bit for bit: one package of every fourth ray
    (271) against those rays' rows of the 1084-ray run; each tangent
    kernel's time alone at the flagship (float64 and float32; the
    tracer's record and tangent kernels each, the record kernel also on
    the busiest ray alone; the RT record and contraction kernels each),
    its registers, its plain version's time (float64), its bound, and for
    the contraction one ``torch.bmm`` of the same product as a yardstick;
    the tracer tangents against ``trace_rays_jvp_ref`` on every flagship
    ray (float64) and every fourth (float32);
14. multi-GPU (torch.distributed) -- ``parallel.ShardedForwardModel`` at
    the full flagship: on an NCCL group of one process (a 1 x 1 mesh) in
    ``KERNEL = auto`` and ``pallas``, bit for bit plain ``formod``, the
    collective's time and the median beside plain ``formod``'s; then two
    gloo processes sharing the card (NCCL takes one rank per card) on the
    2 x 1 and 1 x 2 meshes in ``auto``, ``pallas`` and the roughened
    hybrid (taint on both ranks of the ray split), each rank on its own
    channel range of the tables, its turbo fit read from the cache: bit
    for bit plain ``formod``, launches of both fused kernels under the
    1 x 2 mesh, medians, and the phase's seconds;
15. RT kernel -- ``csrc/ega_rt.cu``, the counterpart of JAX's jitted
    ``rt_integrate`` scan, at the flagship: ``KERNEL = exact`` on
    ``fast_to_ega_tables`` of the flagship's tables (u and eps rows of
    224) in float64 and float32, ``KERNEL = jax`` on the fast tables in
    float32, and ``KERNEL = auto`` on per-channel axes (demoted to the
    fast eager mode) in float32: one ``formod`` each through the kernel
    (one launch a package, no fused launch); on one LOS the kernel
    against the eager loop (``integrate_eager``), float64 within 1e-13 of
    max|rad| (tau absolute), float32 within 5e-5, and every lane bit for
    bit (phase 10 holds ``KERNEL = jax`` in float64 likewise); the
    kernel's time (CUDA events around each launch, median of 10), its
    floor (the busiest ray alone), registers, launch shape (resident
    blocks an SM, threads a block, threads a lane -- a thread a gas in
    the fast tables' kernel --, lanes a pass, passes, rounds) and bound,
    the loop's time and device launches, a profiled ``formod``'s launches
    and idle share, and under ``jax`` the fused table kernel's time on
    the same LOS;
16. exact-table Jacobian -- the record kernel's exact instantiation and
    the contraction against ``rt_jvp_records_ref``,
    ``rt_jvp_contract_ref`` and ``rt_integrate_jvp_ref`` on the exact
    tables (1e-10 / 1e-3 of max|drad|; float64 every flagship ray,
    float32 every fourth) at the flagship retrieval (n = 130);
    ``kernel_autodiff`` of a ``KERNEL = exact`` model through the tangent
    kernels (the launch counts set to 0 just before and read just after:
    each once per package, no other kernel) in float64 and float32, its
    float64 K against ``kernel_autodiff_jacfwd``'s on every fourth ray
    (1e-9 of each quantity's max|K|); each kernel's time and bound, and
    the seconds of the exact route beside the fast route's and the jacfwd
    route's.

Every model here is built with USEGPU = 1 on the CUDA device and every
CLI run passes ``USEGPU 1``: nothing can fall back to the CPU or to a
plain version.  The launch counts are set to 0 just before each path and
read just after it.

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
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIT_CACHE = REPO / "jurassic_torch" / "_build" / "turbo_cache"
KERNEL_TOL = 5e-5       # kernel vs plain version, both float32
PROBE_TOL = 1e-5        # peak probe vs plain version, relative
# loop counts at which each sfu chain still tells its number of steps
SFU_COUNT_LOOPS = {"expf": (1, 2), "ex2": (1,), "lg2": (1,)}
TAINT_FLIP_MAX = 1e-3   # share of lanes whose taint may differ
# vs the C oracle (test_pallas_kernel.py:105 turbo, :28-38 table)
GOLDEN_TOL = {"turbo": 5e-3, "pallas": 2e-3}
CHORD_TOL = 2e-3        # table vs turbo on the same tables, of max|rad|
# float32 tangent points vs the C oracle, km and degrees
# (tests/test_torch_geometry_f32.py)
TP_TOL = 1e-2
N_KERNEL_RUNS = 10
N_FORMOD_RUNS = 3
N_PACKAGED_RUNS = 2
N_MGPU_RUNS = 2          # timed sharded formods per mesh and mode
N_NCCL_RUNS = 5          # NCCL world size 1: sharded and plain, in turns
PHASE_SPLIT_TOL = 0.05   # the median call's parts vs its wall time
PROFILE_TRIES = 3        # profiles of one call before a short record fails
PROFILE_ATTEMPTS = {}    # profiled call -> the attempts it took
AD_EST_RATIO = 2.0       # autodiff sizing estimate vs measured peak
OUTPUTS = ("rad", "tau", "tpz", "tplon", "tplat")
RAYPACK = 271            # the flagship's 1084 rays in 4 packages
# the JAX package's bars against the C oracle (tests/test_forward_golden.py
# :46-70, tests/test_flagship_golden.py:64-107, tests/test_gas30_golden.py
# :65-74): rad (of max|rad|, per band / per channel where the JAX test
# scales so), tau, tangent points (km / deg; None: not checked)
EAGER_GOLDENS = {"limb": (5e-6, 2e-6, 2e-4), "nadir": (5e-6, 2e-6, 2e-4),
                 "ega": (5e-6, 2e-6, 2e-4), "flagship": (1e-5, 5e-6, 2e-4),
                 "gas30": (1e-5, 5e-6, None), "fov": (5e-6, 2e-6, None)}
FLAGSHIP_BANDS = (slice(0, 40), slice(40, 70), slice(70, 100))
EAGER_VS_TABLE_TOL = 1e-5   # tests/test_pallas_kernel.py:41-68
PENCIL_TOL = {2: 2e-3, 3: 0.1}   # tests/test_interp_atm.py:101-105
# FD vs autodiff Jacobian (tests/test_retrieval.py:75,106): of max|K|, and
# relative
FD_ATOL, FD_RTOL = 2e-2, 0.05
# float32 autodiff vs float64, each quantity's columns of its own max|K|:
# the float32 eager EGA resolves a thin segment's transmittance change to
# a few of its bits, so its derivatives are good to percents (at the
# flagship on the H100: T 2.2e-2, CO2 0.165, H2O 2.2e-2, O3 6.4e-2, F11
# 5.0e-2); CO2, the most opaque gas, the least well
AD_F32_TOL = {"TEMPERATURE": 0.1, "CO2": 0.3, "H2O": 0.1, "O3": 0.1,
              "F11": 0.1}
AD_CARD_CPU_TOL = 1e-10  # float64 card vs CPU, of max|K| (as the formod)
# the tangent kernels against their plain versions, of each field's
# max|tangent|: float64 at 1e-10; float32 at 1e-3 (the kernels write the
# partials in another order than the plain versions, e.g. eip's slope in
# the lower level as p (1 - w) / pa, not exp(.) (1 - w), and float32
# rounds the two apart: ~1e-5 of max|tangent| on the H100)
AD_KERNEL_TOL = {"float64": 1e-10, "float32": 1e-3}
AD_JACFWD_TOL = 1e-9     # float64 K, kernels vs jacfwd, of each quantity's
AD_JVP_CASE_N = 9        # tangents of the small kernel-vs-plain cases
AD_JVP_WIDE_N = 40       # and of the small limb scan at two chunks of 32
# flagship cells (pressure index, temperature index) of gas 0, channel 2
# that the limb scan reads on ~10,000 segments each; roughening them gives
# the hybrid tainted lanes to re-evaluate
ROUGH_CELLS = ((15, 13), (17, 14), (18, 14))
ROUGH_GAS, ROUGH_CHANNEL, ROUGH_SEED = 0, 2, 7

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores and HBM3.  The bounds below divide by these.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float64 outside the tensor cores (the same data sheet)
PEAK_FP64_FLOPS = 34e12
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
# Float operations of the tracer kernel (csrc/trace_rays.cu), counted from
# the source, a transcendental or compare as one operation:
#   per step: step length (18), cart2geo (12), escape tests (2), p by eip
#     (10), t by lin (6), lowest point (4), refraction without its searches
#     (mid and 3 offset points 4 x 26, n, gradient, ex1: 25), direction
#     normalisation (9), advance (10), trapezoid (2) -> 202
#   per level and step: the five interval searches' compare and count (10)
#   per gas and step: q by lin (6) and u (4); per window and step: k (6)
#   per ray: view vectors, entry bisection, tangent point: about 1000
OPS_TRACE_STEP = 202
OPS_TRACE_LEVEL = 10
OPS_TRACE_GAS = 10
OPS_TRACE_WINDOW = 6
OPS_TRACE_RAY = 1000
TRACE_TP_TOL = 1e-3      # tangent points, kernel vs plain version, km / deg
OPS_TURBO_CORNER = 108
OPS_PER_GAS = {"turbo": 48, "table": 40}
OPS_PER_SEGMENT = 78
# Float operations of the tangent kernels (csrc/trace_rays_jvp.cu,
# csrc/ega_jvp_fast.cu) per tangent, counted from the sources, a
# transcendental, compare or select as one operation; the tracer's record
# kernel runs the tracer's primal (OPS_TRACE_*) once a ray:
#   tracer tangent kernel, per step: step length (18), p and t at z
#     (10), refraction's midpoint and offset altitudes (29), their p, t
#     and refractivity (70), gradient and direction (27), normalisation
#     (14), advance and state (18), the trapezoid (3) -> 190; per gas or
#     window and step: q or k by its slope (7); per gas and step: u (12)
#   RT record kernel, per valid segment and channel: a corner's searches,
#     slopes and clamps (43 + 10 with the halving; a corner whose hint
#     holds takes about 28 fewer), a gas's bilinear weights, guards and
#     partials (47), continua with partials and the source slope (110);
#     its adjoint sweep: per record the emissivity, the rad/tau step's
#     adjoints and the extinction's share of A (26), per gas the prefix
#     product, the factor's adjoint and its share of A (13)
#   RT contraction, per valid segment, channel, LOS field and tangent: a
#     multiply and an add (2); per ray, channel and tangent the surface
#     term (2)
OPS_TRACE_JVP_STEP = 190
OPS_TRACE_JVP_FIELD = 7
OPS_TRACE_JVP_GAS = 12
OPS_RT_JVP_CORNER = 53
OPS_RT_JVP_GAS = 47
OPS_RT_JVP_SEGMENT = 110
OPS_RT_ADJ_SEGMENT = 26
OPS_RT_ADJ_GAS = 13
# float64 on the tensor cores (DMMA; the same data sheet): the contraction
PEAK_FP64_TENSOR_FLOPS = 67e12
# The RT kernel (csrc/ega_rt.cu) against the eager loop on the same LOS,
# stated before its first build: float64 rad within 1e-13 of max|rad| and
# tau within 1e-13 (absolute; the step repeats the loop's operations, so
# the bits are expected, and the bar leaves an ulp's room); float32 at
# KERNEL_TOL
RT_KERNEL_TOL = {"float64": 1e-13, "float32": KERNEL_TOL}
# Float operations of the RT kernel per corner, counted from
# csrc/ega_rt_common.cuh: a fast corner as the table kernel's (35 + ceil(
# log2 K): the inversion's halving, two guarded lips, index arithmetic,
# exp2 and log2); an exact corner two searches of ceil(log2 U) compares,
# two guarded lips (14) and the index clamps and loads' arithmetic (10);
# per gas and segment OPS_PER_GAS["table"], per segment OPS_PER_SEGMENT
OPS_RT_EXACT_CORNER = 24
# the record kernel's exact corner: OPS_RT_JVP_CORNER's 43 without the
# fast halving, and two searches of ceil(log2 U) compares
OPS_RT_JVP_EXACT_CORNER = 43


def roughen(ft):
    """The roughened flagship tables: a staircase the Chebyshev fit cannot
    follow (tests/test_pallas_kernel.py:381-389) in three cells."""
    import numpy as np
    eps = np.array(ft.eps)
    rng = np.random.default_rng(ROUGH_SEED)
    stair = np.cumsum(rng.uniform(0, 1, eps.shape[3]) ** 8)
    stair = (0.1 + 0.8 * stair / stair[-1]).astype(np.float32)
    for (ip, it) in ROUGH_CELLS:
        eps[ROUGH_GAS, ip, it, :, ROUGH_CHANNEL] = stair
    return ft._replace(eps=eps)


def fit_flagship(rough: bool) -> float:
    """Fit the flagship's turbo tables (the roughened ones if ``rough``)
    into the cache, in a worker process while the kernels build; returns
    the seconds it took (next to nothing when the cache holds them)."""
    sys.path.insert(0, str(REPO))
    from jurassic_torch.ops.turbo_fit import build_turbo_tables_cached
    from jurassic_torch.workloads import flagship
    ft = flagship()[1]
    t0 = time.perf_counter()
    build_turbo_tables_cached(roughen(ft) if rough else ft, FIT_CACHE)
    return time.perf_counter() - t0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - START:.1f} s)", flush=True)


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


def ega_bound(mode: str, table_shape, seg_shape, n_active: int, extra,
              rates):
    """(bound_ms, bound_by) of one fused EGA pass: the larger of the
    compulsory bytes (every input once, every output once) over the HBM
    rate and the float32 operations this run's data needs (``n_active``
    active segments) over the FP32 rate, both published peaks.
    ``table_shape`` is the logical table [G, P*T, Q, D]: the pad rows of
    the packed layout are not counted, and a table corner counts the
    ceil(log2 K) compares of a cold search however the kernel searches.
    The same work over the rates the probes measured on this card
    (``rates``) is printed beside it."""
    G, PT, Q, D = table_shape
    R, S, F = seg_shape
    W = F - 8 - G
    n_bytes = 4 * (G * PT * Q * D + R * S * F + R) \
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


def scrambled_check(torch, ega_fused, ForwardModel, dev, kernel: str,
                    ng: int, nd: int) -> float:
    """Max error of the ``kernel`` ("turbo" or "pallas") CUDA kernel
    against its plain version on a scrambled small batch: 37 rays of
    coarse steps (RAYDS 150 km, RAYDZ 8 km) on 8 x 5 tables, shuffled,
    some emptied and some with np_ = NLOS (``workloads.scrambled_los``)."""
    from jurassic_torch.workloads import scrambled_los, small_limb
    ctl, ft, atm, obs = small_limb(ng=ng, nd=nd, nr=37, nlos=120,
                                   rayds=150.0, raydz=8.0)
    ctl.usetpu, ctl.kernel = 1, kernel
    fm = ForwardModel(ctl, fast_tables=ft, device=dev)
    los = scrambled_los(fm.trace(atm, obs), seed=3)
    S = los.ds.shape[1]
    if not ((los.np_ == 0).any() and (los.np_ == S).any()):
        fail("the scrambled batch has no empty or no full ray")
    common = (fm.cc_rows, los, fm.flags, fm.ig_co2, fm.ig_h2o)
    if kernel == "turbo":
        got = ega_fused.rt_fused_turbo(fm.turbo_tbl, *common)
        ref = ega_fused.rt_fused_turbo_ref(fm.turbo_tbl, *common)
    else:
        got = ega_fused.rt_fused_table(fm.table_tbl, *common)
        ref = ega_fused.rt_fused_table_ref(fm.table_tbl, *common)
    torch.cuda.synchronize()
    err, _ = hold(torch, got, ref,
                  f"{kernel} scrambled coarse rays 37x120x{ng}x{nd}")
    empty = los.np_ == 0
    if not ((got[0][empty] == 0).all() and (got[1][empty] == 1).all()):
        fail(f"{kernel}: an empty ray did not give rad 0, tau 1")
    return err


def run_golden(case: str, kernel: str, bench: int = 0) -> None:
    """The port's CLI on the card for tests/goldens/<case>, against the
    C oracle's rad.tab; ``kernel`` is "turbo" (the ctl's own KERNEL,
    auto) or "pallas".  ``bench`` > 0 adds ``BENCH <bench>``: that many
    repeat runs, which must show no deviations from the first."""
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
    if bench:
        cmd += ["BENCH", str(bench)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                         text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"golden {case} ({kernel}): CLI exited {res.returncode}\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    last = [ln for ln in res.stdout.splitlines() if "kernel launches" in ln]
    n = 1 + bench
    want = (f"variant turbo, fused EGA kernel launches turbo {n} table 0"
            if kernel == "turbo" else
            f"variant table, fused EGA kernel launches turbo 0 table {n}")
    if not last or "device cuda" not in last[-1] or want not in last[-1]:
        fail(f"golden {case} ({kernel}): the CLI did not run the kernel on "
             f"the card: {last}")
    if bench:
        for ln in res.stdout.splitlines():
            if "deviations" in ln or "formod took" in ln:
                print(f"  {ln}")
        if "shows no deviations" not in res.stdout:
            fail(f"golden {case} ({kernel}): BENCH {bench} shows "
                 "deviations between repeat runs")
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
          f"{TP_TOL}), non-finite on {n_tp} rays (none allowed); CLI "
          f"{dt:.1f} s; {last[-1]}",
          flush=True)
    if not (np.isfinite(rad).all() and np.isfinite(tau).all()
            and e_rad <= tol and e_tau <= tol):
        fail(f"golden {case} ({kernel}): port differs from the C oracle")
    if not ((e_tp <= TP_TOL).all() and n_tp == 0):
        fail(f"golden {case}: tangent points differ from the C oracle")


def trace_bound(torch, prof, los) -> tuple:
    """(bound_ms, bound_by, bytes, operations) of one tracer launch: every
    input read once and every output written once over the HBM rate, and
    the float operations of every step of every ray (all NLOS steps run
    and are stored) over the FP32 rate (``OPS_TRACE_*``)."""
    R, L = prof.z.shape
    G, W = prof.q.shape[1], prof.k.shape[1]
    S = los.z.shape[1]
    n_bytes = sum(t.numel() * t.element_size() for t in (*prof[:8], *los)) \
        + 6 * R * prof.z.element_size() + 4 * R
    ops = R * S * (OPS_TRACE_STEP + OPS_TRACE_LEVEL * L
                   + OPS_TRACE_GAS * G + OPS_TRACE_WINDOW * W) \
        + R * OPS_TRACE_RAY
    t_b, t_o = n_bytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            n_bytes, ops)


def los_diffs(torch, los, ref) -> tuple:
    """(rays whose ``np_`` and ``valid`` agree, {float field: (largest
    difference, bit for bit)}) of two LOS."""
    from jurassic_torch.geometry import LosData
    same = (los.np_ == ref.np_) & (los.valid == ref.valid).all(dim=1)
    diffs = {}
    for f in LosData._fields:
        if f in ("np_", "valid"):
            continue
        a, b = getattr(los, f), getattr(ref, f)
        both_nan = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both_nan, 0.0, (a - b).abs())
        diffs[f] = (float(d.max()) if d.numel() else 0.0,
                    bool(torch.equal(a, b) or (both_nan | (a == b)).all()))
    return int(same.sum()), diffs


def trace_phase(torch, fm, dev):
    """The tracer kernel against ``trace_rays_ref`` on the same CUDA
    tensors, in float32 and float64, on every case of
    ``workloads.trace_cases`` (the flagship and its pencil geometry, the
    goldens' geometries, the branches of a small limb scan) and every
    edge shape of ``workloads.TRACE_EDGE_SHAPES``: ``np_`` and ``valid``
    identical on every ray, every float field bit for bit, tangent points
    within TRACE_TP_TOL, no bisection flag; the branch-free operations
    against the operations; at the flagship the times of
    :func:`trace_timing` (float32) and the kernel's in float64.  Returns
    a dict of the times, the bound and the largest difference of any
    float field over every case and dtype."""
    from jurassic_torch.geometry import (build_ray_profiles,
                                         trace_rays_deferred, trace_rays_ref)
    from jurassic_torch.ops import trace as ktrace
    from jurassic_torch.workloads import (TRACE_EDGE_SHAPES, profiles_to,
                                          trace_cases, trace_edge_case)
    geo_keys = ktrace.GEO_KEYS
    ops = ktrace.fast_ops_check(1 << 28, seed=1)
    print(f"tracer fast paths vs the operations: {ops}", flush=True)
    if ops["sqrt_differ"] or ops["rcp_differ"] or ops["div_differ"] \
            or not ops["div_in_range"]:
        fail("the tracer's branch-free float operations differ from the "
             "operations")
    timing, max_err = None, 0.0
    n_exact = n_fields = 0
    cases = [(name, *case) for name, case in
             trace_cases(REPO / "tests" / "goldens").items()]
    cases += [("edge " + "-".join(map(str, shape)), *trace_edge_case(*shape))
              for shape in TRACE_EDGE_SHAPES]
    for name, ctl, a1, a2 in cases:
        edge = name.startswith("edge")
        for dt in (torch.float32, torch.float64):
            if edge:
                prof, geo = profiles_to(a1, dt, dev), a2
            else:
                geo = {k: getattr(a2, k) for k in geo_keys}
                prof = build_ray_profiles(ctl, a1, a2, dt, dev)
            los, flag = trace_rays_deferred(ctl, prof, geo)
            ref = trace_rays_ref(ctl, prof, geo)
            torch.cuda.synchronize()
            R, L = prof.z.shape
            n_same, diffs = los_diffs(torch, los, ref)
            n_fields += len(diffs)
            n_exact += sum(e for _, e in diffs.values())
            max_err = max([max_err, *(v for v, _ in diffs.values())])
            tp = max(diffs[f][0] for f in ("tpz", "tplon", "tplat"))
            label = f"tracer {name} ({str(dt)[6:]}, {R} rays, L {L}, G " \
                f"{prof.q.shape[1]}, W {prof.k.shape[1]}, NLOS " \
                f"{ctl.nlos}, REFRAC {ctl.refrac}, short {prof.short})"
            inexact = {f: v for f, (v, e) in diffs.items() if not e}
            print(f"{label}: np_ and valid identical on {n_same} of {R} "
                  f"rays; bit for bit in {len(diffs) - len(inexact)} of "
                  f"{len(diffs)} float fields" + (
                      "; largest differences " + ", ".join(
                          f"{f} {v:.3e}" for f, v in inexact.items())
                      if inexact else ""), flush=True)
            if n_same != R or int(flag.sum()) != 0:
                fail(f"{label}: np_/valid differ or a bisection flag is "
                     "set")
            if not tp <= TRACE_TP_TOL:
                fail(f"{label}: tangent points differ by {tp:.3e}")
            if name == "flagship" and dt == torch.float32:
                timing = trace_timing(torch, ctl, prof, geo, los, ref, fm)
            elif name == "flagship":
                k64 = kernel_ms(torch, lambda: ktrace.trace_rays_cuda(
                    prof, geo, ctl.rayds, ctl.raydz, ctl.refrac, ctl.nlos),
                    "jt_trace_rays", N_KERNEL_RUNS)
                smem = ktrace.shared_memory_bytes(
                    L, prof.q.shape[1], prof.k.shape[1], ctl.nlos, dt)
                print(f"tracer flagship, float64: kernel {k64:.4f} ms "
                      f"(median of {N_KERNEL_RUNS}), {smem} B of shared "
                      f"memory a ray", flush=True)
                timing["kernel_ms_f64"] = k64
    print(f"tracer kernel vs plain version: {n_exact} of {n_fields} float "
          f"fields bit for bit over all cases; largest difference "
          f"{max_err}", flush=True)
    if n_exact != n_fields:
        fail("the tracer kernel is not bit for bit its plain version")
    return {**timing, "max_abs_err": max_err}


def kernel_ms(torch, fn, name: str, n: int) -> float:
    """Median milliseconds of the launches of ``name`` over ``n`` calls of
    ``fn``, by the CUDA events a wrapper records around its C launch call
    (``ega_fused.LAUNCH_EVENTS``), after one warm-up call: the kernel
    without the wrapper's allocation and copies, but with the host's
    launch latency (the device idles before each launch, since the
    wrapper's geometry copy synchronises)."""
    from jurassic_torch.ops import ega_fused
    fn()
    torch.cuda.synchronize()
    before, ega_fused.LAUNCH_EVENTS = ega_fused.LAUNCH_EVENTS, []
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for k, a, b in ega_fused.LAUNCH_EVENTS
              if k == name]
    finally:
        ega_fused.LAUNCH_EVENTS = before
    if len(ms) != n:
        fail(f"{len(ms)} launches of {name} recorded, not {n}")
    return statistics.median(ms)


def ray_subset(torch, prof, geo: dict, rows):
    """(profiles, geometry) of the rays ``rows``."""
    import numpy as np
    idx = torch.as_tensor(rows, device=prof.z.device)
    sub = prof._replace(**{f: getattr(prof, f)[idx].contiguous() for f in
                           ("z", "p", "t", "q", "k", "nlev", "zmin",
                            "zmax")})
    return sub, {k: np.asarray(v)[rows] for k, v in geo.items()}


def trace_timing(torch, ctl, prof, geo, los, ref, fm) -> dict:
    """The flagship tracer's times (float32): the wrapper (CUDA events
    around the call, with its allocation and geometry copy; median of
    N_KERNEL_RUNS), the kernel alone (``kernel_ms``) on every ray, on the
    busiest ray (the floor: one ray's chain) and on the 132 busiest (one
    a SM), the plain version (one run), the bound; and the turbo pass of
    ``fm`` on the kernel's LOS against the pass on the plain version's
    (bit for bit)."""
    from jurassic_torch.geometry import trace_rays_ref
    from jurassic_torch.ops import trace as ktrace
    args = (ctl.rayds, ctl.raydz, ctl.refrac, ctl.nlos)
    call = lambda p, g: (lambda: ktrace.trace_rays_cuda(p, g, *args))
    name = "jt_trace_rays"
    w_ms = cuda_ms(torch, call(prof, geo), N_KERNEL_RUNS)
    k_ms = kernel_ms(torch, call(prof, geo), name, N_KERNEL_RUNS)
    n_sm = torch.cuda.get_device_properties(prof.z.device) \
        .multi_processor_count
    busy = torch.argsort(-los.np_, stable=True)[:n_sm].cpu().numpy()
    one_ms, sm_ms = (kernel_ms(torch, call(*ray_subset(torch, prof, geo,
                                                       rows)),
                               name, N_KERNEL_RUNS)
                     for rows in (busy[:1], busy))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace_rays_ref(ctl, prof, geo)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    b_ms, b_by, n_bytes, ops = trace_bound(torch, prof, los)
    R, L = prof.z.shape
    smem = ktrace.shared_memory_bytes(L, prof.q.shape[1], prof.k.shape[1],
                                      ctl.nlos, prof.z.dtype)
    print(f"tracer flagship: the wrapper {w_ms:.4f} ms (CUDA events around "
          f"the call, with its allocation and geometry copy), the kernel "
          f"alone {k_ms:.4f} ms (CUDA events around each launch), on the busiest ray alone "
          f"({int(los.np_[int(busy[0])])} active steps of {ctl.nlos}) "
          f"{one_ms:.4f} ms, on the {n_sm} busiest {sm_ms:.4f} ms "
          f"(medians of {N_KERNEL_RUNS}); plain version {p_ms:.1f} ms "
          f"(one run); bound {b_ms:.4f} ms by {b_by}: "
          f"{n_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; {R} blocks of "
          f"one warp, {smem} B of shared memory each", flush=True)
    out_k = fm.integrate(los)
    out_r = fm.integrate(ref)
    e_rad = float((out_k.rad - out_r.rad).abs().max()
                  / out_r.rad.abs().max())
    e_tau = float((out_k.tau - out_r.tau).abs().max())
    same = torch.equal(out_k.rad, out_r.rad)
    print(f"flagship turbo pass on the kernel's LOS vs on the plain "
          f"version's: rad {e_rad:.3e} of max|rad|, tau {e_tau:.3e} (bar "
          f"{KERNEL_TOL}); bit for bit {same}", flush=True)
    if not (same and e_tau == 0.0):
        fail("the flagship turbo pass on the tracer kernel's LOS is not "
             "bit for bit the pass on the plain version's")
    return {"ms": w_ms, "kernel_ms": k_ms, "floor_kernel_ms": one_ms,
            "kernel_ms_132": sm_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def timed_formod(torch, ega_fused, fm, atm, obs, label: str, variant: str,
                 per_call: tuple):
    """Warm-up plus N_FORMOD_RUNS timed ``fm.formod`` calls with the
    launch counts set to 0 just before and read just after, each call
    splitting its own time (``fm.phase_log``); prints the split of the
    median call, whose parts must add up to within PHASE_SPLIT_TOL of
    its wall time.  ``per_call`` is the (turbo, table) launches one call
    must make; the tracer kernel launches once per call.  Returns
    (median wall seconds, the last timed call's radiances [R, D] float64,
    launches (turbo, table, tracer))."""
    import numpy as np
    from jurassic_torch.ops import trace as ktrace
    R, D = obs.nr, fm.ctl.nd
    ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = ktrace.LAUNCHES = 0
    fm.formod(atm.copy(), obs.copy())                  # warm-up
    walls = []
    fm.phase_log = []
    for _ in range(N_FORMOD_RUNS):
        o_run = obs.copy()
        t0 = time.perf_counter()
        fm.formod(atm.copy(), o_run)
        walls.append(time.perf_counter() - t0)
    splits, fm.phase_log = fm.phase_log, None
    launches = (ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE,
                ktrace.LAUNCHES)
    n = N_FORMOD_RUNS + 1
    if launches != (per_call[0] * n, per_call[1] * n, n):
        fail(f"{label}: the kernels launched (turbo, table, tracer) = "
             f"{launches} times over {n} formod runs")
    if fm.last_variant != variant:
        fail(f"{label}: ran variant {fm.last_variant}, expected {variant}")
    wall = statistics.median(walls)
    print(f"{label}: median {wall * 1e3:.1f} ms over "
          f"{N_FORMOD_RUNS} runs (min {min(walls) * 1e3:.1f}, max "
          f"{max(walls) * 1e3:.1f}); {R * D / wall:,.0f} rays*ch/s; "
          f"kernel launches turbo {launches[0]} table {launches[1]} "
          f"tracer {launches[2]}; variant {fm.last_variant}", flush=True)
    i_med = sorted(range(len(walls)), key=walls.__getitem__)[len(walls) // 2]
    split, wall_ms = splits[i_med], walls[i_med] * 1e3
    total = sum(split.values())
    print(f"{label} phase split of the median call (CUDA events inside "
          "it): " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
          + f"; parts {total:.1f} ms of its {wall_ms:.1f} ms wall "
          f"({total / wall_ms - 1:+.2%})", flush=True)
    if not abs(total - wall_ms) <= PHASE_SPLIT_TOL * wall_ms:
        fail(f"{label}: the phase split does not add up to the call")
    rad = o_run.rad
    if rad.shape != (R, D) or not np.isfinite(rad).all():
        fail(f"{label}: output malformed: {rad.shape}")
    return wall, rad, launches


def profile_formod(torch, fm, atm, obs, wall_ms: float) -> None:
    """Device time and kernel launches of one flagship formod
    (torch.profiler, CUDA activity only; ``profiled_call``): where the
    time goes.  The busy share is
    taken of ``wall_ms``, the median formod time without the profiler."""
    _, wall, n, busy, ks = profiled_call(
        torch, lambda: fm.formod(atm.copy(), obs.copy()), "flagship formod",
        names=True)
    print(f"flagship formod profiled: {wall * 1e3:.1f} ms wall (with "
          f"profiler), device busy {busy:.1f} ms ({busy / wall_ms:.1%}"
          f" of the {wall_ms:.1f} ms median formod), "
          f"{n} device kernel launches", flush=True)
    by_name: dict = {}
    for name, ns, _ in ks:
        count, total = by_name.get(name, (0, 0))
        by_name[name] = (count + 1, total + ns)
    for name, (count, total) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:6]:
        print(f"  {total / 1e6:8.2f} ms {count:6d} x  {name[:90]}")


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
         "launches_on": "tools.peak.measure",
         "max_abs_err": errs["fma"], "ms": m["t_fma"][0] * 1e3,
         "plain_ms": plain["fma"],
         "bound_ms": 2 * steps / PEAK_FP32_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None},
        {"name": "peak_sfu", "route": "cuda", "source": src_file,
         "replaces": "tools/vpu_peak.py:56", "launches": launches["sfu"],
         "launches_on": "tools.peak.measure",
         "max_abs_err": errs["sfu"], "ms": t_sfu, "plain_ms": plain["sfu"],
         "bound_ms": len(peak.SFU_OPS) * steps / PEAK_FP32_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None},
        {"name": "peak_hbm_copy", "route": "cuda", "source": src_file,
         "replaces": "tools/vpu_peak.py:76", "launches": launches["copy"],
         "launches_on": "tools.peak.measure",
         "max_abs_err": 0.0, "ms": m["t_copy"][0] * 1e3,
         "plain_ms": plain["copy"],
         "bound_ms": 2.0 * m["copy_bytes"] / PEAK_HBM_BYTES * 1e3,
         "bound_by": "bytes", "library_ms": plain["copy"]},
    ]


def golden_dir(case: str) -> Path:
    """tests/goldens/<case> copied under jurassic_torch/_build/smoke/,
    with the synthetic tables of ``flagship`` and ``gas30`` made there by
    tools/make_synthetic_tables.py (NumPy; the C oracle read the same
    files), as the JAX tests make them."""
    from jurassic_torch.config import read_ctl
    work = REPO / "jurassic_torch" / "_build" / "smoke" / f"eager_{case}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(REPO / "tests" / "goldens" / case, work)
    if case in ("flagship", "gas30"):
        ctl = read_ctl(["x", str(next(work.glob("*.ctl"))), "o", "a", "r"],
                       verbose=False)
        gases = [g for g in ctl.emitter[:ctl.ng] if g not in ("N2", "O2")]
        subprocess.run(
            [sys.executable, str(REPO / "tools" / "make_synthetic_tables.py"),
             str(work), "--tblbase", "synth", "--gases", *gases,
             "--channels", *[f"{x:.4f}" for x in ctl.nu]],
            check=True, stdout=subprocess.DEVNULL)
    return work


def eager_golden(torch, ega_fused, ForwardModel, dev, case: str,
                 kernel: str) -> None:
    """``KERNEL = exact`` (or ``fast``) in float64 on the card against
    the C oracle's rad.tab at the JAX package's bar: the RT kernel
    (``ops.ega_rt``), once per package, and no fused kernel."""
    import numpy as np
    from jurassic_torch.config import read_ctl
    from jurassic_torch.io_tab import read_atm, read_obs
    from jurassic_torch.ops import ega_rt
    d = golden_dir(case)
    ctl = read_ctl(["formod", str(next(d.glob("*.ctl"))), "o", "a", "r"],
                   verbose=False)
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    if ctl.fov != "-":
        ctl.fov = str(d / Path(ctl.fov).name)
    ctl.kernel, ctl.usetpu = kernel, 1
    obs, atm = read_obs(d / "obs.tab", ctl), read_atm(d / "atm.tab", ctl)
    t0 = time.perf_counter()
    fm = ForwardModel(ctl, directory=str(d), device=dev,
                      dtype=torch.float64)
    npk = -(-obs.nr // (fm.package_size(obs.nr) or obs.nr))
    ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = ega_rt.LAUNCHES = 0
    fm.formod(atm, obs)
    launches = (ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE,
                ega_rt.LAUNCHES)
    dt = time.perf_counter() - t0
    want = "exact kernel" if kernel == "exact" else "fast kernel"
    if (fm.last_variant != want or fm.device.type != "cuda"
            or launches != (0, 0, npk)):
        fail(f"golden {case} ({kernel}): ran {fm.last_variant} on "
             f"{fm.device}, fused and RT kernel launches {launches}, "
             f"expected (0, 0, {npk})")
    ref = np.loadtxt(d / ("rad_fov.tab" if case == "fov" else "rad.tab"))
    nd = ctl.nd
    rad_ref, tau_ref = ref[:, 10:10 + nd], ref[:, 10 + nd:10 + 2 * nd]
    rad_bar, tau_bar, tp_bar = EAGER_GOLDENS[case]
    if kernel != "exact":
        rad_bar = tau_bar = 2e-3
    if case == "flagship":
        scales = [(sl, np.abs(rad_ref[:, sl]).max()) for sl in FLAGSHIP_BANDS]
    elif case == "gas30":
        scales = [(slice(j, j + 1), np.abs(rad_ref[:, j]).max())
                  for j in range(nd)]
    else:
        scales = [(slice(None), np.abs(rad_ref).max())]
    e_rad = max(np.abs(obs.rad[:, sl] - rad_ref[:, sl]).max() / sc
                for sl, sc in scales)
    e_tau = np.abs(obs.tau - tau_ref).max()
    e_tp = 0.0 if tp_bar is None else max(
        np.abs(obs.tpz - ref[:, 7]).max(), np.abs(obs.tplat - ref[:, 9]).max())
    print(f"eager golden {case} ({kernel}, float64 on the card, the RT "
          f"kernel: {launches[2]} launch(es), {npk} package(s)): "
          f"{obs.nr} rays x {nd} channels x {ctl.ng} gases; rad "
          f"{e_rad:.3e} of max|rad| (bar {rad_bar}), tau {e_tau:.3e} (bar "
          f"{tau_bar}), tangent points {e_tp:.3e} (bar {tp_bar}); "
          f"{dt:.1f} s with the table load", flush=True)
    if not (np.isfinite(obs.rad).all() and e_rad <= rad_bar
            and e_tau <= tau_bar and (tp_bar is None or e_tp <= tp_bar)):
        fail(f"golden {case} ({kernel}): the eager pipeline misses the "
             "JAX package's bar")


def device_events(prof) -> list:
    """(name, nanoseconds, start ns) of every device activity a finished
    torch.profiler run recorded, read from its raw Kineto events:
    ``key_averages()`` builds a Python object per event first, which
    takes minutes for the million launches of an autodiff pass."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns(), e.start_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def busy_ms(ks) -> float:
    """Milliseconds in which the device ran at least one activity of
    ``ks``: the union of their intervals, so that kernels overlapping on
    two streams count once."""
    busy, end = 0, None
    for _, ns, start in sorted(ks, key=lambda k: k[2]):
        stop = start + ns
        if end is None or start >= end:
            busy += ns
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e6


def profiled_call(torch, fn, label: str, names: bool = False, reset=None):
    """(result, wall seconds, device kernel launches, device busy ms[,
    (name, ns) events]) of ``fn()`` under torch.profiler with CUDA
    activity only (recording the host's operators too slows a
    launch-bound pass ten times over).  Busy is the union of the device
    activities' intervals (``busy_ms``); the profiler must have recorded
    every launch of the hand-written kernels (the fused kernels, the
    tracer, the tangent kernels: the RT tangent entry's record and
    contraction kernels each), whose time by CUDA events recorded around
    each launch in the same call (``ega_fused.LAUNCH_EVENTS``) is printed
    beside its own.  Right after a profile of a pass of some 10^5
    launches the profiler's records have come up short (0 of 1 table
    kernel launches once, on the H100): a call whose records miss a
    launch is profiled again (``fn`` runs again), PROFILE_TRIES times in
    all, and the run fails unless one attempt recorded every launch;
    ``reset`` runs before each attempt, so that the caller's launch counts
    are one call's.  The attempts go into PROFILE_ATTEMPTS[label], which
    the ``kernels`` line prints."""
    from torch.profiler import ProfilerActivity, profile

    from jurassic_torch.ops import ega_fused
    kinds = ("ega_fused_kernel", "trace_rays_kernel", "trace_jvp_record",
             "trace_jvp_tangent", "ega_rec_kernel", "ega_jvp_contract",
             "ega_rt_kernel")
    for attempt in range(1, PROFILE_TRIES + 1):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        ega_fused.LAUNCH_EVENTS = []
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events, ega_fused.LAUNCH_EVENTS = ega_fused.LAUNCH_EVENTS, None
        ks = device_events(prof)
        hand = [k[1] for k in ks if any(name in k[0] for name in kinds)]
        by_kind = {name: sum(k[1] for k in ks if name in k[0]) / 1e6
                   for name in kinds}
        # one device kernel a launch (the tangent entries record their
        # kernels apart)
        want = len(events)
        hand_ms = sum(a.elapsed_time(b) for _, a, b in events)
        busy, n = busy_ms(ks), len(ks)
        if events:
            print(f"  hand-written kernels: {len(events)} launch(es) of "
                  f"{want} kernel(s), {hand_ms:.2f} ms by CUDA events; the "
                  f"profiler recorded {len(hand)} of them "
                  f"({sum(hand) / 1e6:.2f} ms: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in by_kind.items() if v)
                  + ")", flush=True)
        if len(hand) == want and ks and busy > 0:
            break
        print(f"  profile attempt {attempt} of {PROFILE_TRIES}: the "
              f"profiler recorded {len(hand)} of {want} hand-written "
              f"launches and {len(ks)} device activities", flush=True)
    PROFILE_ATTEMPTS[label] = attempt
    if len(hand) != want:
        fail("the profiler missed launches of the hand-written kernels")
    if not ks or busy <= 0:
        fail("the profiler recorded no device time")
    return (out, wall, n, busy) + ((ks,) if names else ())


def device_pass(torch, fn, label: str):
    """(result, milliseconds on the host clock to a synchronise, device
    kernel launches and busy ms) of ``fn()``: one timed call, one
    profiled call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, ms, *profiled_call(torch, fn, label)[2:])


def eager_vs_table(torch, ForwardModel, flagship, fm_p, dev):
    """At the flagship: one float64 trace, the eager ``jax`` pipeline in
    float64 against the table kernel on the same LOS cast to float32."""
    from jurassic_torch.geometry import LosData
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.kernel = 1, "jax"
    fm_e = ForwardModel(ctl, fast_tables=ft, device=dev,
                        dtype=torch.float64)
    los64 = fm_e.trace(atm, obs)
    los32 = LosData(*(f.float() if f.is_floating_point() else f
                      for f in los64))
    out_e, ms_e, n_e, busy_e = device_pass(
        torch, lambda: fm_e.integrate_eager(los64), "eager float64 RT pass")
    out_t, ms_t, n_t, busy_t = device_pass(
        torch, lambda: fm_p.integrate(los32), "table kernel RT pass")
    scale = float(out_e.rad.abs().max())
    e_rad = float((out_t.rad.double() - out_e.rad).abs().max()) / scale
    e_tau = float((out_t.tau.double() - out_e.tau).abs().max())
    print(f"flagship eager jax pipeline (float64) vs table kernel (float32, "
          f"the same LOS cast): rad {e_rad:.3e} of max|rad| {scale:.4e}, "
          f"tau {e_tau:.3e} (bar {EAGER_VS_TABLE_TOL})", flush=True)
    print(f"flagship RT pass: eager float64 {ms_e:.1f} ms, {n_e} device "
          f"launches, device busy {busy_e:.1f} ms; table kernel + epilogue "
          f"{ms_t:.2f} ms, {n_t} device launches, device busy "
          f"{busy_t:.2f} ms", flush=True)
    if not (fm_e.kernel_mode == "fast" and out_e.rad.dtype == torch.float64
            and e_rad <= EAGER_VS_TABLE_TOL and e_tau <= EAGER_VS_TABLE_TOL):
        fail("the eager float64 pipeline and the table kernel disagree")
    # the RT kernel of this model (KERNEL = jax, float64) on the same LOS
    # against the loop: the fast tables' float64 configuration of phase 15
    from jurassic_torch.ops import ega_rt
    out_k = fm_e.integrate(los64)
    torch.cuda.synchronize()
    off = (int((out_k.rad != out_e.rad).sum()),
           int((out_k.tau != out_e.tau).sum()))
    d_k = (float((out_k.rad - out_e.rad).abs().max()) / scale,
           float((out_k.tau - out_e.tau).abs().max()))
    ms_k = kernel_ms(torch, lambda: fm_e.integrate(los64), "jt_ega_rt",
                     N_KERNEL_RUNS)
    los1 = busiest_ray(torch, los64)
    floor_ms = kernel_ms(torch, lambda: fm_e.integrate(los1), "jt_ega_rt",
                         N_KERNEL_RUNS)
    b_ms, b_by, _, _ = rt_bound(torch, fm_e, los64, False)
    uniform = fm_e.eager_tables().tbl.uniform
    regs = ega_rt.registers(uniform, False, torch.float64)
    shape = ega_rt.launch_shape(los64.ds.shape[0], ctl.nd,
                                los64.u.shape[2], uniform, False,
                                torch.float64)
    print(f"RT kernel, jax float64, vs the eager loop on the same LOS: rad "
          f"{d_k[0]:.3e} of max|rad|, tau {d_k[1]:.3e} (bar "
          f"{RT_KERNEL_TOL['float64']}); lanes not bit for bit: rad "
          f"{off[0]}, tau {off[1]}; {ms_k:.3f} ms (median of "
          f"{N_KERNEL_RUNS}), {regs} registers, {rt_shape_text(shape)}; "
          f"floor (the busiest ray alone) {floor_ms:.3f} ms; bound "
          f"{b_ms:.4f} ms by {b_by}", flush=True)
    if not (fm_e.last_variant == "fast kernel"
            and max(d_k) <= RT_KERNEL_TOL["float64"] and off == (0, 0)):
        fail("the RT kernel (jax, float64) and the eager loop disagree, or "
             "not bit for bit")
    return fm_e, {"ms": ms_k, "plain_ms": ms_e, "plain_device_launches": n_e,
                  "bound_ms": b_ms, "bound_by": b_by, "registers": regs,
                  "floor_ms": floor_ms, **rt_shape_record(shape),
                  "lanes_not_bit_for_bit": off, "max_abs_err": max(
                      float((out_k.rad - out_e.rad).abs().max()), d_k[1])}


def memory_check(torch, fm, atm, obs, label: str) -> None:
    """The sizing estimate of a one-package formod against the measured
    peak of the allocator (tables excluded, as in the estimate)."""
    R = obs.nr
    ctl = fm.ctl
    pack0, ctl.raypack = ctl.raypack, -1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(fm.device)
    base = torch.cuda.memory_allocated(fm.device)
    fm.formod(atm.copy(), obs.copy())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(fm.device) - base
    ctl.raypack = pack0
    est = fm.per_ray_device_bytes() * R
    print(f"sizing {label}: estimate {fm.per_ray_device_bytes()} B/ray x "
          f"{R} rays = {est / 1e6:.1f} MB; measured one-package peak "
          f"{peak / 1e6:.1f} MB ({est / max(peak, 1):.2f} x)", flush=True)
    if est < peak:
        fail(f"sizing {label}: the estimate undercuts the measured peak")


def packaged_runs(torch, ega_fused, fm, atm, obs, label: str, variant: str,
                  per_call: tuple, mono_wall: float):
    """``RAYPACK`` packages against the one-package run of the same model:
    bit for bit, ``per_call`` (turbo, table) launches per formod, and the
    median beside the one-package median.  Returns the packaged median."""
    import numpy as np
    ctl = fm.ctl
    ctl.raypack = -1
    o_m = obs.copy()
    fm.formod(atm.copy(), o_m)
    ctl.raypack = RAYPACK
    npk = -(-obs.nr // fm.package_size(obs.nr))
    from jurassic_torch.ops import trace as ktrace
    ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = ktrace.LAUNCHES = 0
    walls = []
    for _ in range(N_PACKAGED_RUNS):
        o_p = obs.copy()
        t0 = time.perf_counter()
        fm.formod(atm.copy(), o_p)
        walls.append(time.perf_counter() - t0)
    launches = (ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE)
    n_trace = ktrace.LAUNCHES
    ctl.raypack = 0
    n = N_PACKAGED_RUNS
    wall = statistics.median(walls)
    print(f"{label} with RAYPACK {RAYPACK} ({npk} packages of "
          f"{fm.package_size(obs.nr, RAYPACK)} rays, two streams): median "
          f"{wall * 1e3:.1f} ms over {n} runs (min {min(walls) * 1e3:.1f}, "
          f"max {max(walls) * 1e3:.1f}) beside {mono_wall * 1e3:.1f} ms as "
          f"one package; launches turbo {launches[0]} table {launches[1]} "
          f"tracer {n_trace} over {n} calls; variant {fm.last_variant}",
          flush=True)
    if npk != 4 or launches != (per_call[0] * n, per_call[1] * n) \
            or n_trace != npk * n:
        fail(f"{label}: {npk} packages, launches {launches}, expected "
             f"{per_call} per call")
    if fm.last_variant != variant:
        fail(f"{label}: ran {fm.last_variant}, expected {variant}")
    for f in ("rad", "tau", "tpz", "tplon", "tplat"):
        if not np.array_equal(getattr(o_p, f), getattr(o_m, f)):
            fail(f"{label}: packaged {f} differs from the one-package run")
    return wall


def idle_share(torch, fm, atm, obs, wall_ms: float, label: str) -> None:
    """The device's busy and idle share of one formod, taken of the
    median formod time without the profiler."""
    n, busy = profiled_call(torch, lambda: fm.formod(atm.copy(),
                                                     obs.copy()), label)[2:]
    print(f"{label}: device busy {busy:.1f} ms of the {wall_ms:.1f} ms "
          f"median, idle share {1 - busy / wall_ms:.1%}; {n} device kernel "
          "launches", flush=True)


def track_atm(atm, nlat: int = 3):
    """``nlat`` copies of the 1-D profile ``atm`` at latitudes -4, 0, 4:
    a satellite track whose profiles are identical
    (tests/test_interp_atm.py:15-31 with equal temperatures)."""
    import numpy as np
    from jurassic_torch.io_tab import Atm
    n = atm.npts
    out = Atm.zeros(n * nlat, atm.q.shape[0], atm.k.shape[0])
    for j in range(nlat):
        sl = slice(j * n, (j + 1) * n)
        out.z[sl], out.lat[sl], out.lon[sl] = atm.z, -4.0 + 4.0 * j, 0.0
        out.p[sl], out.t[sl] = atm.p, atm.t
        out.q[:, sl], out.k[:, sl] = atm.q, atm.k
    out.time[:] = atm.time[0]
    return out


def pencil_phase(torch, ega_fused, ForwardModel, flagship, tt, stats, dev):
    """IP = 2 and IP = 3 at the flagship width against IP = 1 on
    identical profiles, REFRAC 0, through the turbo kernel."""
    import dataclasses
    import numpy as np
    from jurassic_torch.forward import _obs_rows
    from jurassic_torch.ops import trace as ktrace
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.refrac = 1, 0
    obs = _obs_rows(obs, slice(None, None, 8))
    fm1 = ForwardModel(ctl, fast_tables=ft, turbo_tables=tt,
                       turbo_stats=stats, device=dev)
    o1 = obs.copy()
    fm1.formod(atm.copy(), o1)
    scale = np.abs(o1.rad).max()
    for ip in (2, 3):
        ctl_i = dataclasses.replace(ctl, ip=ip, cz=2.0, cx=8000.0)
        fm = ForwardModel(ctl_i, fast_tables=ft, turbo_tables=tt,
                          turbo_stats=stats, device=dev)
        o = obs.copy()
        ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = ktrace.LAUNCHES = 0
        t0 = time.perf_counter()
        fm.formod(track_atm(atm), o)
        dt = time.perf_counter() - t0
        launches = (ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE,
                    ktrace.LAUNCHES)
        err = np.abs(o.rad - o1.rad).max() / scale
        print(f"pencil IP = {ip}: {obs.nr} rays x {ctl.nd} channels x "
              f"{ctl.ng} gases on a 3-profile track, vs IP = 1: "
              f"{err:.3e} of max|rad| (bar {PENCIL_TOL[ip]}); launches turbo "
              f"{launches[0]} table {launches[1]} tracer {launches[2]}; "
              f"{dt * 1e3:.0f} ms", flush=True)
        if not (launches == (1, 0, 1) and fm.last_variant == "turbo"
                and np.isfinite(o.rad).all() and err <= PENCIL_TOL[ip]):
            fail(f"pencil IP = {ip} failed")


def retrieval_ctl(flagship, kernel: str, state: str):
    """(ctl, fast tables, atm, obs) of the flagship retrieval: HYDZ 20 and
    the state ``small`` (T at 10-18 km, 5 elements) or ``full`` (T and
    the 4 gases' vmr at the 26 levels of 10-60 km, 130 elements)."""
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.kernel, ctl.hydz = 1, kernel, 20.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 18.0 if state == "small" else 60.0
    if state == "full":
        ctl.retq_zmin, ctl.retq_zmax = [10.0] * ctl.ng, [60.0] * ctl.ng
    return ctl, ft, atm, obs


def fd_vs_ad(K_fd, K_ad, label: str) -> float:
    """The FD Jacobian against the autodiff one at the JAX package's bars;
    returns the excess over the relative bar, of max|K_ad|."""
    import numpy as np
    scale = np.abs(K_ad).max()
    d = np.abs(K_fd - K_ad)
    excess = float((d - FD_RTOL * np.abs(K_ad)).max() / scale)
    print(f"{label}: K {K_fd.shape}, max|K_fd - K_ad| {d.max() / scale:.3e} "
          f"of max|K_ad| {scale:.4e}; beyond {FD_RTOL} relative "
          f"{excess:.3e} (bar {FD_ATOL})", flush=True)
    if not (K_fd.shape == K_ad.shape and np.isfinite(K_fd).all()
            and scale > 0 and excess <= FD_ATOL):
        fail(f"{label}: the FD and autodiff Jacobians disagree")
    return excess


JVP_COUNTS = ("tracer tangent entry", "tracer record", "tracer tangent",
              "RT tangent entry", "RT record", "RT contraction", "tracer",
              "turbo", "table", "RT primal")


def jvp_launches(reset: bool = False) -> tuple:
    """The launch counts of ``JVP_COUNTS``, set to 0 first where
    ``reset``."""
    from jurassic_torch.ops import (ega_fused, ega_jvp, ega_rt, trace,
                                    trace_jvp)
    mods = ((trace_jvp, "LAUNCHES"), (trace_jvp, "LAUNCHES_RECORD"),
            (trace_jvp, "LAUNCHES_TANGENT"), (ega_jvp, "LAUNCHES"),
            (ega_jvp, "LAUNCHES_RECORD"), (ega_jvp, "LAUNCHES_CONTRACT"),
            (trace, "LAUNCHES"), (ega_fused, "LAUNCHES"),
            (ega_fused, "LAUNCHES_TABLE"), (ega_rt, "LAUNCHES"))
    if reset:
        for m, k in mods:
            setattr(m, k, 0)
    return tuple(getattr(m, k) for m, k in mods)


def autodiff_run(torch, ForwardModel, flagship, dev, dtype, label: str,
                 raypack: int = 0, rows=None, profiled: bool = True,
                 jacfwd: bool = False, kernel: str = "jax"):
    """``kernel_autodiff`` (``jacfwd``: ``kernel_autodiff_jacfwd``) on the
    full flagship retrieval state (the rays ``rows`` of the scan, default
    all) of a ``KERNEL = kernel`` model (``exact``: on
    ``fast_to_ega_tables`` of the flagship's tables), under the
    CUDA-activity profiler where ``profiled``: returns
    (K, rays, packages, launches of ``jvp_launches``, wall s) after
    printing wall time, launches, busy time, packages and the peak memory
    against the sizing estimate.  The launch counts are set to 0 just
    before the call and read just after it."""
    import numpy as np
    from jurassic_torch.forward import _obs_rows
    from jurassic_torch.retrieval import (atm2x, autodiff_package_size,
                                          autodiff_ray_bytes,
                                          kernel_autodiff,
                                          kernel_autodiff_jacfwd)
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    ctl, ft, atm, obs = retrieval_ctl(flagship, kernel, "full")
    ctl.raypack = raypack
    if rows is not None:
        obs = _obs_rows(obs, rows)
    tables = fast_to_ega_tables(ft) if kernel == "exact" else None
    m = ForwardModel(ctl, tables, fast_tables=ft, device=dev, dtype=dtype)
    n = atm2x(ctl, atm)[0].size
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pack = autodiff_package_size(m, obs.nr, n, jacfwd) or obs.nr
    npk = -(-obs.nr // pack)
    est = autodiff_ray_bytes(m, n, jacfwd) * pack
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn = kernel_autodiff_jacfwd if jacfwd else kernel_autodiff
    run = lambda: fn(ctl, atm.copy(), obs.copy(), m)
    jvp_launches(reset=True)
    if profiled:
        K, wall, launches, busy = profiled_call(
            torch, run, label, reset=lambda: jvp_launches(reset=True))
        on = (f"wall (CUDA-activity profiler on), {launches} device kernel "
              f"launches, device busy {busy:.1f} ms")
    else:
        t0 = time.perf_counter()
        K = run()
        torch.cuda.synchronize()
        wall, on = time.perf_counter() - t0, "wall"
    counts = jvp_launches()
    peak = torch.cuda.max_memory_allocated(dev) - base
    scale = float(np.abs(K).max())
    print(f"{label}: {obs.nr} rays x {ctl.nd} channels, n = {n}, "
          f"{str(dtype)[6:]}: {wall:.3f} s {on}; {npk} package(s) of "
          f"{pack} rays; peak "
          f"{peak / 1e9:.2f} GB against the estimate {est / 1e9:.2f} GB "
          f"({est / max(peak, 1):.2f} x); max|K| {scale:.4e}; launches "
          f"({', '.join(JVP_COUNTS)}) {counts}", flush=True)
    if not (K.shape == (obs.nr * ctl.nd, n) and np.isfinite(K).all()
            and scale > 0):
        fail(f"{label}: the Jacobian is malformed")
    if not peak / AD_EST_RATIO <= est <= AD_EST_RATIO * peak:
        fail(f"{label}: the sizing estimate is not within {AD_EST_RATIO}x "
             "of the measured peak")
    want = (0,) * 10 if jacfwd else (npk,) * 6 + (0,) * 4
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    return K, obs.nr, npk, counts, wall


def jvp_case_inputs(torch, ForwardModel, ctl, ft, atm, obs, dev, dtype,
                    n: int, seed: int = 0):
    """(model, profiles, profile tangents, geometry) of a kernel-vs-plain
    case: the eager fast model in ``dtype`` on the card and n random
    profile tangents at the atm points, each field at its own scale."""
    import numpy as np
    from jurassic_torch.geometry import (ProfileTangents,
                                         build_ray_profiles,
                                         hydrostatic_atm,
                                         ray_window_indices)
    ctl.usetpu, ctl.kernel = 1, "jax"
    hydrostatic_atm(ctl, atm)
    m = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=dtype)
    prof = build_ray_profiles(ctl, atm, obs, dtype, dev)
    gi = torch.from_numpy(ray_window_indices(atm, obs)[2]).to(dev)
    G, W = ctl.ng, ctl.nw
    d = np.random.default_rng(seed).standard_normal(
        (atm.npts, 2 + G + W, n))
    d[:, 0] *= np.abs(atm.p).max() * 1e-2
    d[:, 2:2 + G] *= np.abs(atm.q).max() * 1e-2
    return (m, prof, ProfileTangents(torch.from_numpy(d).to(dev, dtype), gi),
            m._obs_geo(obs))


def rel_field_errs(torch, got: dict, ref: dict) -> dict:
    """{field: largest |got - ref| of max|ref|} (absolute where ref is 0)."""
    out = {}
    for k, r in ref.items():
        d = float((got[k] - r).abs().max()) if r.numel() else 0.0
        sc = float(r.abs().max()) if r.numel() else 0.0
        out[k] = d / sc if sc > 0 else d
    return out


def rel_fields(torch, got, ref) -> float:
    """Largest |got - ref| over each field (axis 2 of [R, S, F, D]) of its
    own max|ref| (absolute where ref is 0)."""
    return max(rel_field_errs(torch, {f: got[:, :, f] for f in
                                      range(got.shape[2])},
                              {f: ref[:, :, f] for f in
                               range(ref.shape[2])}).values())


def rt_kernels_hold(torch, args, S: int, G: int, W: int, timed=None):
    """Each RT tangent kernel against its plain version on the same CUDA
    tensors: the record kernel's rad, tau, A (per LOS field, of its
    max|A|) and a_surf against ``rt_jvp_records_ref``, the contraction on
    the record kernel's records against ``rt_jvp_contract_ref`` on the
    same A, and the entry's drad and rad against ``rt_integrate_jvp_ref``.
    ``timed(key, fn)`` runs each plain version ("record", "contract",
    "rt"; it may time them).  Each dense A is freed once held, before the
    entry and its plain version run.  Returns ({name: relative error},
    whether rad, tau and A are bit for bit the plain versions' and the
    count of rad lanes that are not, {kernel:
    largest absolute difference of its own hold}, the entry's drad)."""
    from jurassic_torch.forward import rt_integrate_jvp_ref
    from jurassic_torch.ops import ega_jvp as ej
    timed = timed or (lambda key, fn: fn())
    tbl, sr, st, nu, cc, window, los, tan, flags, ig_co2, ig_h2o, bbt = args
    rargs = (tbl, sr, st, nu, cc, window, los, flags, ig_co2, ig_h2o, bbt)
    one = lambda a, b: rel_field_errs(torch, {"x": a}, {"x": b})["x"]
    absd = lambda a, b: float((a - b).abs().max())
    out_k, rec, sidx, first, asurf = ej.rt_jvp_records_cuda(*rargs)
    out_p, A_p, as_p = timed("record", lambda: ej.rt_jvp_records_ref(*rargs))
    A_k = ej.dense_adjoint(rec, sidx, first, S, G, W)
    errs = {"A": rel_fields(torch, A_k, A_p), "a_surf": one(asurf, as_p),
            "record rad": one(out_k.rad, out_p.rad),
            "record tau": one(out_k.tau, out_p.tau)}
    bits = {"A": torch.equal(A_k, A_p)}
    d_abs = {"ega_jvp_record": absd(A_k, A_p)}
    del A_p, as_p
    dr_c = ej.rt_jvp_contract_cuda(rec, sidx, first, asurf, tan, G, W)
    del rec, sidx
    dr_cp = timed("contract", lambda: ej.rt_jvp_contract_ref(
        A_k, asurf, los.valid, tan))
    del A_k
    torch.cuda.empty_cache()
    errs["contraction"] = one(dr_c, dr_cp)
    d_abs["ega_jvp_contract"] = absd(dr_c, dr_cp)
    del dr_c, dr_cp
    out_e, dr_e = ej.rt_jvp_fast_cuda(*args)
    out_r, dr_r = timed("rt", lambda: rt_integrate_jvp_ref(*args))
    errs.update(drad=one(dr_e, dr_r), rad=one(out_e.rad, out_r.rad))
    bits.update(rad=torch.equal(out_e.rad, out_r.rad),
                tau=torch.equal(out_e.tau, out_r.tau))
    bits["rad lanes off"] = int((out_e.rad != out_r.rad).sum())
    d_abs["drad"] = absd(dr_e, dr_r)
    return errs, bits, d_abs, dr_e


def record_block_shape_hold(torch, rargs, S: int, G: int, W: int) -> bool:
    """Whether the record kernel's rad, tau, a_surf and A on all the rays
    of ``rargs`` (``rt_jvp_records_cuda``'s arguments) are bit for bit its
    outputs on the same rays in slices of fewer than one ray a
    multiprocessor, where a block holds one ray: every lane's operations
    are its own, so two rays sharing a block (their brackets, barriers
    and segment bounds) must change no bit."""
    from jurassic_torch.geometry import LosData
    from jurassic_torch.ops import ega_jvp as ej
    los = rargs[6]
    R = los.p.shape[0]
    step = torch.cuda.get_device_properties(los.p.device) \
        .multi_processor_count - 1
    out, rec, sidx, first, asurf = ej.rt_jvp_records_cuda(*rargs)
    A = ej.dense_adjoint(rec, sidx, first, S, G, W)
    del rec, sidx
    same = True
    for r0 in range(0, R, step):
        sl = slice(r0, min(r0 + step, R))
        o, rc, si, fi, a_s = ej.rt_jvp_records_cuda(
            *rargs[:6], LosData(*(f[sl] for f in los)), *rargs[7:])
        A_s = ej.dense_adjoint(rc, si, fi, S, G, W)
        same = same and all(torch.equal(x, y) for x, y in (
            (o.rad, out.rad[sl]), (o.tau, out.tau[sl]),
            (a_s, asurf[sl]), (A_s, A[sl])))
        del rc, si, A_s
    return same


def tracer_kernels_hold(torch, ctl, prof, ptan, geo, timed=None):
    """The tracer's record kernel against ``trace_step_records_ref`` (the
    ray records and every primal field bit for bit, the partials
    ``TRACE_RECORD_PARTIALS`` within AD_KERNEL_TOL of their max) and its LOS
    against the tracer kernel's (bit for bit); the tangent kernel on those
    records against ``trace_tangents_from_records_ref`` (each field
    within AD_KERNEL_TOL of its max).  ``timed(key, fn)`` runs each plain
    statement (to time it).  Returns ({"records": bool, "tangents from
    records": bool} bit for bit, {field: largest relative difference},
    largest |record difference|, the record kernel's LOS, tangents)."""
    from jurassic_torch.geometry import (TRACE_RECORD_PARTIALS,
                                         los_tangent_fields,
                                         trace_record_fields,
                                         trace_step_records_ref,
                                         trace_tangents_from_records_ref)
    from jurassic_torch.ops import trace_jvp as tj
    from jurassic_torch.ops.trace import trace_rays_cuda
    timed = timed or (lambda key, fn: fn())
    args = (ctl.rayds, ctl.raydz, bool(ctl.refrac), ctl.nlos)
    los, rec, flag = tj.trace_jvp_records_cuda(prof, geo, *args)
    los_t, _ = trace_rays_cuda(prof, geo, *args)
    same, diffs = los_diffs(torch, los, los_t)
    plain = timed("trace_record",
                  lambda: trace_step_records_ref(ctl, prof, geo))
    got, ref = trace_record_fields(rec.step), trace_record_fields(plain.step)
    primal = (same == prof.z.shape[0] and not flag.any()
              and all(b for _, b in diffs.values())
              and bool(torch.equal(rec.ray, plain.ray))
              and all(torch.equal(got[k], ref[k]) for k in ref
                      if k not in TRACE_RECORD_PARTIALS))
    errs = rel_field_errs(torch, {k: got[k] for k in TRACE_RECORD_PARTIALS},
                          {k: ref[k] for k in TRACE_RECORD_PARTIALS})
    d_abs = float((rec.step - plain.step).abs().max())
    bits = {"records": bool(torch.equal(rec.step, plain.step))}
    del plain
    tan = tj.trace_jvp_tangents_cuda(prof, ptan, los, rec, ctl.refrac)
    tan_r = timed("trace_tangent", lambda: trace_tangents_from_records_ref(
        ctl, prof, ptan, los, rec))
    G, W = ctl.ng, ctl.nw
    errs.update({"from records " + k: v for k, v in rel_field_errs(
        torch, los_tangent_fields(tan, G, W),
        los_tangent_fields(tan_r, G, W)).items()})
    bits["tangents from records"] = bool(torch.equal(tan.seg, tan_r.seg)
                                         and torch.equal(tan.tsurf,
                                                         tan_r.tsurf))
    del tan_r
    name = str(prof.z.dtype)[6:]
    if not (primal and max(errs.values()) <= AD_KERNEL_TOL[name]):
        fail(f"the tracer's record and tangent kernels vs their plain "
             f"statements ({name}): primal bit for bit {primal}, "
             f"{errs}")
    return bits, errs, d_abs, los, tan


def jvp_kernels_check(torch, ForwardModel, flagship, small_limb, dev):
    """The tangent kernels against their plain versions on the same CUDA
    tensors, float64 and float32: a small limb scan (37 rays, NLOS 120, 4
    gases, 9 channels) as it is, with AD_JVP_CASE_N and AD_JVP_WIDE_N
    random profile tangents, and with AD_JVP_CASE_N in each branch of
    ``workloads.TRACE_BRANCHES`` and on a ground-hitting scan with the
    brightness conversion; and every 30th ray of the flagship retrieval
    (37 rays, 100 channels, its tables), in float32 also every 4th (271
    rays), with the main path's own inputs, the seed's n = 130 tangents
    through ``package_tangents``: the kernel instantiations that the
    flagship Jacobian runs, and its record blocks of two rays (a block
    takes min(256 // D, R // multiprocessors) rays, at least one: one ray
    below 264 rays on the H100's 132, two at 271 and at the flagship's
    1084; ``jvp_timing`` holds every flagship ray in float64).
    The scan at both n and the flagship cases run again on tables whose
    axes differ per channel (``workloads.perturbed_axes``): the record
    kernel's per-channel instantiation.  The tracer tangent entry's LOS
    bit for bit the tracer kernel's; each LOS tangent field within
    AD_KERNEL_TOL of its max; the tracer's record and tangent kernels
    each against their plain statements (``tracer_kernels_hold``); each
    RT kernel against its plain version (``rt_kernels_hold``) and drad
    likewise.  Returns ({dtype: largest relative error}, {RT kernel,
    tracer record kernel or drad: largest absolute difference in
    float64}, {RT hold: largest relative error}, {tracer kernels' hold:
    largest relative error})."""
    from jurassic_torch.forward import _obs_rows
    from jurassic_torch.geometry import (los_tangent_fields,
                                         trace_rays_jvp_ref)
    from jurassic_torch.ops.trace import trace_rays_cuda
    from jurassic_torch.ops.trace_jvp import trace_rays_jvp_cuda
    from jurassic_torch.ops.trace_jvp import quo_check
    from jurassic_torch.retrieval import autodiff_seed, package_tangents
    from jurassic_torch.workloads import (TRACE_BRANCHES, perturbed_axes,
                                          trace_branch)

    quo = quo_check(1 << 28, seed=1)
    print(f"tracer tangent kernel's division by a block-wide reciprocal vs "
          f"the division: {quo}", flush=True)
    if quo["float_differ"] or quo["double_differ"] or not (
            quo["float_fast"] and quo["double_fast"]):
        fail("the tracer tangent kernel's division differs from the "
             "division")

    def small(br, n, axes=False):
        def inputs(dtype):
            ctl, ft, atm, obs = small_limb(ng=4, nd=9, nr=37, nlos=120)
            if br == "ground":
                ctl.refrac, ctl.write_bbt = 0, 1
                obs.vpz[::2] = -20.0
            elif br:
                trace_branch(br, ctl, atm, obs)
            if axes:
                ft = perturbed_axes(ft, seed=1)
            return (ctl, obs.nr, *jvp_case_inputs(
                torch, ForwardModel, ctl, ft, atm, obs, dev, dtype, n))
        return inputs

    def flagship_rows(step, axes):
        def inputs(dtype):
            ctl, ft, atm, obs = retrieval_ctl(flagship, "jax", "full")
            if axes:
                ft = perturbed_axes(ft, seed=2)
            m = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=dtype)
            obs = _obs_rows(obs, slice(0, None, step))
            return (ctl, obs.nr, m, *package_tangents(
                ctl, atm, obs, m, autodiff_seed(ctl, atm, m)))
        return inputs

    def cases(dtype):
        yield "limb", small(None, AD_JVP_CASE_N)
        yield f"limb/n{AD_JVP_WIDE_N}", small(None, AD_JVP_WIDE_N)
        for br in TRACE_BRANCHES + ("ground",):
            yield br, small(br, AD_JVP_CASE_N)
        yield "flagship/30", flagship_rows(30, False)
        yield "limb, per-channel axes", small(None, AD_JVP_CASE_N, True)
        yield (f"limb/n{AD_JVP_WIDE_N}, per-channel axes",
               small(None, AD_JVP_WIDE_N, True))
        yield "flagship/30, per-channel axes", flagship_rows(30, True)
        if dtype == torch.float32:     # float64: jvp_timing, every ray
            yield "flagship/4", flagship_rows(4, False)
            yield "flagship/4, per-channel axes", flagship_rows(4, True)
    worst = {"float64": 0.0, "float32": 0.0}
    worst_rt = {}
    worst_abs = {}
    worst_rec = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        for label, inputs in cases(dtype):
            ctl, nr, m, prof, ptan, geo = inputs(dtype)
            G, W = ctl.ng, ctl.nw
            args = (prof, ptan, geo, ctl.rayds, ctl.raydz, bool(ctl.refrac),
                    ctl.nlos)
            los_k, tan_k, flag = trace_rays_jvp_cuda(*args)
            los_t, _ = trace_rays_cuda(prof, geo, *args[3:])
            los_r, tan_r = trace_rays_jvp_ref(ctl, prof, ptan, geo)
            same, diffs = los_diffs(torch, los_k, los_t)
            bitwise = same == nr and all(b for _, b in diffs.values())
            errs = rel_field_errs(torch, los_tangent_fields(tan_k, G, W),
                                  los_tangent_fields(tan_r, G, W))
            del tan_r
            rec_bits, rec_errs, rec_abs, _, _ = tracer_kernels_hold(
                torch, ctl, prof, ptan, geo)
            for k, v in rec_errs.items():
                worst_rec[k] = max(worst_rec.get(k, 0.0), v)
            if dtype == torch.float64:
                worst_abs["trace_jvp_record"] = max(
                    worst_abs.get("trace_jvp_record", 0.0), rec_abs)
            e = m.eager_tables()
            if e.tbl.uniform == ("per-channel" in label):
                fail(f"{label}: the tables' uniform flag is "
                     f"{e.tbl.uniform}")
            rt = (e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los_k, tan_k,
                  m.flags, m.ig_co2, m.ig_h2o, bool(ctl.write_bbt))
            rt_errs, bits, d_abs, dr_k = rt_kernels_hold(torch, rt,
                                                         ctl.nlos, G, W)
            if label.startswith("flagship/4"):
                bits["record blocks"] = record_block_shape_hold(
                    torch, rt[:7] + rt[8:], ctl.nlos, G, W)
            errs["drad"] = rt_errs["drad"]
            worst[name] = max(worst[name], *errs.values())
            for k, v in rt_errs.items():
                worst_rt[k] = max(worst_rt.get(k, 0.0), v)
            if dtype == torch.float64:
                for k, v in d_abs.items():
                    worst_abs[k] = max(worst_abs.get(k, 0.0), v)
            print(f"tangent kernels vs plain, {label}, {name}, n = "
                  f"{ptan.d.shape[2]}, uniform axes {e.tbl.uniform}: tracer "
                  f"LOS bit for bit {bitwise}, flags {int(flag.sum())}; of "
                  "max|tangent|: " + ", ".join(
                      f"{k} {v:.1e}" for k, v in errs.items())
                  + "; RT kernels: " + ", ".join(
                      f"{k} {v:.1e}" for k, v in rt_errs.items())
                  + "; bit for bit " + ", ".join(
                      f"{k} {v}" for k, v in (*bits.items(),
                                              *rec_bits.items()))
                  + "; tracer kernels vs their plain statements: "
                  + ", ".join(f"{k} {v:.1e}" for k, v in rec_errs.items()),
                  flush=True)
            finite = bool(torch.isfinite(dr_k).all())
            if not (bitwise and not flag.any() and finite
                    and bits.get("record blocks", True)
                    and max(errs.values()) <= AD_KERNEL_TOL[name]
                    and max(rt_errs.values()) <= AD_KERNEL_TOL[name]):
                fail(f"tangent kernels vs plain versions ({label}, {name})")
    print(f"tangent kernels vs plain versions: largest {worst} of "
          f"max|tangent|, RT kernels' own holds {worst_rt}, the tracer "
          f"kernels' own holds {worst_rec} (bars {AD_KERNEL_TOL})",
          flush=True)
    return worst, worst_abs, worst_rt, worst_rec


def kernel_ms_each(torch, fn, names: tuple, n: int) -> dict:
    """{name: median milliseconds} of the launches of each of ``names``
    over ``n`` calls of ``fn`` (``kernel_ms``'s CUDA events)."""
    from jurassic_torch.ops import ega_fused
    fn()
    torch.cuda.synchronize()
    before, ega_fused.LAUNCH_EVENTS = ega_fused.LAUNCH_EVENTS, []
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms = {k: [a.elapsed_time(b) for name, a, b in ega_fused.LAUNCH_EVENTS
                  if name == k] for k in names}
    finally:
        ega_fused.LAUNCH_EVENTS = before
    if any(len(v) != n for v in ms.values()):
        fail(f"launches of {names} recorded: "
             f"{[len(v) for v in ms.values()]}, not {n} each")
    return {k: statistics.median(v) for k, v in ms.items()}


def jvp_timing(torch, ForwardModel, flagship, dev, dtype):
    """At the flagship, n = 130, in ``dtype``: each tangent kernel's time
    alone (CUDA events around each launch, median of 5, after a warm-up;
    the tracer's record and tangent kernels each, the record kernel also
    on the busiest ray alone, its chain's floor; the RT entry's record and
    contraction kernels each), its plain version's (one run, float64
    only: ``trace_step_records_ref``, ``trace_tangents_from_records_ref``
    and, for the tracer's entry as a whole, ``trace_rays_jvp_ref``;
    ``rt_jvp_records_ref``, ``rt_jvp_contract_ref`` and, for the RT entry
    as a whole, ``rt_integrate_jvp_ref``, which takes tens of GB in
    float32 and float64 alike; their outputs hold the kernels on every
    flagship ray: the tracer tangents within AD_KERNEL_TOL of
    ``trace_rays_jvp_ref``'s, ``tracer_kernels_hold``,
    ``rt_kernels_hold``), the contraction's yardstick (one
    ``torch.bmm`` of the rays' dense A and LOS tangents, median of 3), the
    registers, and each kernel's bound: each input read once and each
    output written once over the HBM rate, the operations
    (``OPS_TRACE_JVP_*``, ``OPS_RT_*``, the tracer's own ``OPS_TRACE_*``
    once a ray) over the dtype's peak (the contraction's float64 on the
    tensor cores); the record kernel also without its hints and with
    per-channel brackets on the same tables.  Returns ({name: {ms,
    plain_ms, bound_ms, bound_by, ...}}, the float64 run's RT holds
    (``rt_kernels_hold``'s relative errors and absolute differences) or
    None)."""
    from jurassic_torch.geometry import (los_tangent_fields,
                                         trace_rays_jvp_ref)
    from jurassic_torch.ops import ega_jvp as ej
    from jurassic_torch.ops import trace_jvp as tj
    from jurassic_torch.ops.trace_jvp import trace_rays_jvp_cuda
    from jurassic_torch.retrieval import autodiff_seed, package_tangents
    ctl, ft, atm, obs = retrieval_ctl(flagship, "jax", "full")
    m = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=dtype)
    seed = autodiff_seed(ctl, atm, m)
    prof, ptan, geo = package_tangents(ctl, atm, obs, m, seed)
    targs = (prof, ptan, geo, ctl.rayds, ctl.raydz, bool(ctl.refrac),
             ctl.nlos)
    los, tan, _ = trace_rays_jvp_cuda(*targs)
    e = m.eager_tables()
    rargs = (e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, tan, m.flags,
             m.ig_co2, m.ig_h2o, bool(ctl.write_bbt))
    pargs = rargs[:7] + rargs[8:]
    R, L = prof.z.shape
    G, W, D, S = ctl.ng, ctl.nw, ctl.nd, ctl.nlos
    F = 3 + 2 * G + W
    n = ptan.d.shape[2]
    ms_t = kernel_ms_each(torch, lambda: trace_rays_jvp_cuda(*targs),
                          ("jt_trace_jvp_records", "jt_trace_jvp_tangents"),
                          5)
    busy = ray_subset(torch, prof, geo, [int(torch.argmax(los.np_))])
    floor = kernel_ms(torch, lambda: tj.trace_jvp_records_cuda(
        *busy, *targs[3:]), "jt_trace_jvp_records", 5)
    ms_r = kernel_ms_each(torch, lambda: ej.rt_jvp_fast_cuda(*rargs),
                          ("jt_ega_jvp_record", "jt_ega_jvp_contract"), 5)
    # the record kernel's two decisions on these tables undone: the
    # corner searches without hints, the brackets per channel
    ablated = {}
    for key, tbl in (("ms_without_hints", e.tbl._replace(monotone=False)),
                     ("ms_per_channel_brackets",
                      e.tbl._replace(uniform=False))):
        a2 = (tbl,) + rargs[1:]
        ablated[key] = kernel_ms_each(
            torch, lambda a2=a2: ej.rt_jvp_fast_cuda(*a2),
            ("jt_ega_jvp_record",), 3)["jt_ega_jvp_record"]
    plain = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain[key] = (time.perf_counter() - t0) * 1e3
        return out
    hold = None
    if dtype == torch.float64:
        # the tracer tangents on every flagship ray, and each tracer
        # kernel against its plain statement
        _, tan_j = timed("trace", lambda: trace_rays_jvp_ref(ctl, prof, ptan,
                                                             geo))
        t_errs = rel_field_errs(torch, los_tangent_fields(tan, G, W),
                                los_tangent_fields(tan_j, G, W))
        del tan_j
        torch.cuda.empty_cache()
        print(f"tracer tangents vs trace_rays_jvp_ref at the flagship ({R} "
              f"rays, float64, n = {n}), of max|tangent|: " + ", ".join(
                  f"{k} {v:.1e}" for k, v in t_errs.items()), flush=True)
        if not max(t_errs.values()) <= AD_KERNEL_TOL["float64"]:
            fail("the tracer tangents vs trace_rays_jvp_ref at the "
                 "flagship (float64)")
        t_bits, r_errs, _, _, _ = tracer_kernels_hold(torch, ctl, prof, ptan,
                                                      geo, timed)
        torch.cuda.empty_cache()
        print(f"tracer kernels vs their plain statements at the flagship "
              f"(float64): " + ", ".join(f"{k} {v:.1e}" for k, v in
                                        r_errs.items())
              + "; bit for bit " + ", ".join(f"{k} {v}" for k, v in
                                            t_bits.items()), flush=True)
        # the plain runs hold the kernels on every flagship ray, at the
        # record kernel's block shape of the main path (two rays a block)
        errs, bits, d_abs, _ = rt_kernels_hold(torch, rargs, S, G, W, timed)
        torch.cuda.empty_cache()
        bits["record blocks"] = record_block_shape_hold(torch, pargs, S, G,
                                                        W)
        torch.cuda.empty_cache()
        hold = (errs, d_abs, t_errs, r_errs)
        print(f"RT kernels vs plain versions at the flagship ({R} rays, "
              f"float64, n = {n}): " + ", ".join(
                  f"{k} {v:.1e}" for k, v in errs.items())
              + "; bit for bit " + ", ".join(
                  f"{k} {v}" for k, v in bits.items()), flush=True)
        if not (max(errs.values()) <= AD_KERNEL_TOL["float64"]
                and bits["record blocks"]):
            fail("the RT tangent kernels vs their plain versions at the "
                 "flagship (float64)")
    # the yardstick: one batched product of each ray's dense A [D, S F]
    # (zero on invalid segments) with its LOS tangents [S F, n]
    _, rec, sidx, first, _ = ej.rt_jvp_records_cuda(*pargs)
    Ad = ej.dense_adjoint(rec, sidx, first, S, G, W).permute(
        0, 3, 1, 2).reshape(R, D, S * F).contiguous()
    del rec, sidx
    Bd = tan.seg.reshape(R, S * F, n)
    lib = cuda_ms(torch, lambda: torch.bmm(Ad, Bd), 3)
    del Ad, Bd
    torch.cuda.empty_cache()
    b = prof.z.element_size()
    peak = PEAK_FP64_FLOPS if dtype == torch.float64 else PEAK_FP32_FLOPS
    peak_mma = (PEAK_FP64_TENSOR_FLOPS if dtype == torch.float64
                else PEAK_FP32_FLOPS)
    n_active = int(los.valid.sum())

    def bound(n_bytes, ops, peak_ops=peak):
        t_b, t_o = n_bytes / PEAK_HBM_BYTES, ops / peak_ops
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else
                "operations", n_bytes, ops)
    # tracer record kernel: profiles and geometry in; the LOS, the flag
    # and the records out; the tracer's primal operations
    step_len, ray_len = tj.record_lengths()
    rec_bytes = (R * S * step_len + R * ray_len) * b
    t1_bytes = (sum(x.numel() * x.element_size() for x in (*prof[:8], *los))
                + 6 * R * b + 4 * R + rec_bytes)
    t1_ops = (R * S * (OPS_TRACE_STEP + OPS_TRACE_LEVEL * L
                       + OPS_TRACE_GAS * G + OPS_TRACE_WINDOW * W)
              + R * OPS_TRACE_RAY)
    # tracer tangent kernel: profile tangents, window indices, profiles z,
    # q, k, the records and the LOS p, t, ds, q in; the tangents out
    t2_bytes = (ptan.d.numel() * b + R * L * 4 + R * (1 + G + W) * L * b
                + rec_bytes + R * S * (3 + G) * b
                + sum(x.numel() * x.element_size() for x in tan))
    t2_ops = R * S * n * (OPS_TRACE_JVP_STEP + OPS_TRACE_JVP_FIELD * (G + W)
                          + OPS_TRACE_JVP_GAS * G)
    regs_t = tj.registers(dtype, ctl.refrac)
    # record kernel: the LOS fields it reads and the tables in; rad, tau,
    # A of the valid segments, their segment indices and a_surf out
    r_bytes = (sum(x.numel() * x.element_size() for x in (
        los.p, los.t, los.ds, los.q, los.k, los.u, los.valid, los.tsurf,
        e.tbl.eps, e.tbl.log2_u0, e.tbl.p, e.tbl.t))
        + 4 * (e.tbl.nu.numel() + e.tbl.nt.numel() + e.tbl.np_.numel())
        + e.tbl.valid.numel() + m.sr.numel() * b
        + 3 * R * D * b + n_active * (F * D * b + 4))
    r_ops = n_active * D * (4 * G * OPS_RT_JVP_CORNER + G * OPS_RT_JVP_GAS
                            + OPS_RT_JVP_SEGMENT + OPS_RT_ADJ_SEGMENT
                            + G * OPS_RT_ADJ_GAS)
    # contraction: A and the LOS tangents of the valid segments, their
    # indices, tsurf's tangents and a_surf in; drad out
    c_bytes = (n_active * (F * D * b + F * n * b + 4) + R * n * b
               + R * D * b + 8 * (R + 1) + R * D * n * b)
    c_ops = 2 * n_active * F * D * n + 2 * R * D * n
    reg_rec, reg_con = ej.registers(G, W, S, e.tbl.uniform, dtype)
    out = {}
    for key, name, ms, lib_ms, (b_ms, b_by, nb, ops), reg in (
            ("trace_record", "trace_jvp_record",
             ms_t["jt_trace_jvp_records"], None, bound(t1_bytes, t1_ops),
             regs_t["record"]),
            ("trace_tangent", "trace_jvp_tangent",
             ms_t["jt_trace_jvp_tangents"], None, bound(t2_bytes, t2_ops),
             regs_t["tangent"]),
            ("record", "ega_jvp_record", ms_r["jt_ega_jvp_record"], None,
             bound(r_bytes, r_ops), reg_rec),
            ("contract", "ega_jvp_contract", ms_r["jt_ega_jvp_contract"],
             lib, bound(c_bytes, c_ops, peak_mma), reg_con)):
        out[name] = {"ms": ms, "plain_ms": plain.get(key),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "bytes": nb, "operations": ops, "registers": reg}
        print(f"{name} at the flagship ({R} rays, {n_active} valid "
              f"segments, n = {n}, {str(dtype)[6:]}): kernel {ms:.3f} ms "
              f"(median of 5), plain version "
              + (f"{plain[key]:.1f} ms" if key in plain else "not timed")
              + (f", torch.bmm {lib_ms:.3f} ms" if lib_ms else "")
              + f"; bound {b_ms:.3f} ms by {b_by} ({nb / 1e9:.2f} GB, "
              f"{ops / 1e9:.1f} GFLOP); registers {reg}", flush=True)
    both = ms_r["jt_ega_jvp_record"] + ms_r["jt_ega_jvp_contract"]
    print(f"RT tangent entry at the flagship, {str(dtype)[6:]}: both kernels "
          f"{both:.3f} ms, plain version (rt_integrate_jvp_ref) "
          + (f"{plain['rt']:.1f} ms" if "rt" in plain else "not timed"),
          flush=True)
    print(f"ega_jvp_record, {str(dtype)[6:]}: without hints "
          f"{ablated['ms_without_hints']:.3f} ms, with per-channel brackets "
          f"{ablated['ms_per_channel_brackets']:.3f} ms (median of 3; "
          f"both decisions taken: {ms_r['jt_ega_jvp_record']:.3f} ms)",
          flush=True)
    out["ega_jvp_record"].update(entry_ms=both, entry_plain_ms=plain.get(
        "rt"), **ablated)
    out["trace_jvp_record"].update(floor_ms=floor)
    out["trace_jvp_tangent"].update(
        entry_ms=sum(ms_t.values()), entry_plain_ms=plain.get("trace"))
    print(f"tracer tangent entry at the flagship, {str(dtype)[6:]}: both "
          f"kernels {sum(ms_t.values()):.3f} ms, the record kernel on the "
          f"busiest ray alone {floor:.3f} ms; plain version "
          f"(trace_rays_jvp_ref) "
          + (f"{plain['trace']:.1f} ms" if "trace" in plain else
             "not timed"), flush=True)
    return out, hold


def jvp_dispatch(torch, dev, n: int = 130, chain: int = 200) -> None:
    """Host microseconds per operation under ``torch.func.jacfwd``, what
    makes ``kernel_autodiff`` host-bound: a chain of ``chain`` operations
    on one value per flagship ray, untransformed and under ``jacfwd``
    over an n-element input, with both operands carrying a tangent or
    one a Python constant.  A constant gets a ZeroTensor tangent whose
    shape PyTorch computes through the operation's meta kernel, Python
    code in recent releases (``torch/_meta_registrations.py``)."""
    x = torch.rand(n, dtype=torch.float64, device=dev) + 0.5
    spread = torch.rand(1084, dtype=torch.float64, device=dev)

    def chained(op):
        def f(v):
            y = v.mean() + spread
            one = v.mean() / v.mean().detach()    # 1, with a tangent
            for _ in range(chain):
                y = op(y, one)
            return y
        return f

    cases = {
        "plain mul by a constant": (lambda y, one: y * 1.0000001, False),
        "jacfwd sqrt": (lambda y, one: torch.sqrt(y), True),
        "jacfwd mul, both with tangents": (lambda y, one: y * one, True),
        "jacfwd mul by a constant": (lambda y, one: y * 1.0000001, True),
        "jacfwd add of a constant": (lambda y, one: y + 1e-9, True),
    }
    us = {}
    for name, (op, transformed) in cases.items():
        f = torch.func.jacfwd(chained(op)) if transformed else chained(op)
        f(x)                                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f(x)
        torch.cuda.synchronize()
        us[name] = (time.perf_counter() - t0) / chain * 1e6
    print(f"host cost per operation (n = {n}, chains of {chain} on 1084 "
          "values): " + ", ".join(f"{k} {v:.1f} us" for k, v in us.items()),
          flush=True)


def by_quantity(ctl, iqa, got, ref) -> dict:
    """{quantity: largest |got - ref| in its columns of its max|ref|}."""
    import numpy as np
    from jurassic_torch.retrieval import idx2name
    out = {}
    for q in np.unique(iqa):
        cols = iqa == q
        sc = np.abs(ref[:, cols]).max()
        out[idx2name(ctl, q)] = (float(np.abs(got[:, cols] - ref[:, cols])
                                       .max() / sc) if sc > 0 else np.inf)
    return out


def retrieval_phase(torch, ega_fused, ForwardModel, flagship, small_limb,
                    tt, stats, dev):
    """Phase 13: the tangent kernels against their plain versions; the
    130-element Jacobian through them (the main path) in float64 and
    float32, the float64 one against the jacfwd route's, float32 against
    that; the jacfwd route in float32 on every fourth ray (its launches
    and busy time); the FD Jacobian on the small state through both fused
    kernels against the float64 Jacobian's columns of that state, float64
    card against CPU, packages; each tangent kernel's time, plain time
    and bound at the flagship.  The profiler costs a pass as much again,
    so it records the float32 passes.  Returns (the (turbo, table,
    tracer) launches of the FD Jacobians, the tangent kernels' records)."""
    import numpy as np
    from jurassic_torch.ops import trace as ktrace
    from jurassic_torch.retrieval import IDXT, atm2x, kernel, kernel_autodiff

    worst, worst_abs, worst_rt, worst_rec = jvp_kernels_check(
        torch, ForwardModel, flagship, small_limb, dev)
    K64, nr, npk, counts64, wall64 = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float64,
        "flagship retrieval autodiff (tangent kernels)", profiled=False)
    print(f"the float64 flagship Jacobian runs {npk} package(s) on this "
          "card", flush=True)
    K32, _, _, counts32, _ = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float32,
        "flagship retrieval autodiff (tangent kernels)")
    Kj, _, npk_j, _, wall_j = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float64,
        "flagship retrieval autodiff (jacfwd route)", profiled=False,
        jacfwd=True)
    ctl, _, atm, _ = retrieval_ctl(flagship, "jax", "full")
    _, iqa, ipa = atm2x(ctl, atm)
    e_j = by_quantity(ctl, iqa, K64, Kj)
    print("float64 tangent kernels vs the jacfwd route, by quantity, of its "
          f"own max|K| (bar {AD_JACFWD_TOL}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in e_j.items())
          + f"; {wall_j:.1f} s against {wall64:.3f} s", flush=True)
    if not all(v <= AD_JACFWD_TOL for v in e_j.values()):
        fail("the float64 Jacobian through the tangent kernels is not the "
             "jacfwd route's")
    scale = np.abs(Kj).max()
    d32 = np.abs(K32 - Kj)
    print(f"float32 (tangent kernels) vs float64 (jacfwd route): "
          f"{d32.max() / scale:.3e} of max|K|; beyond 0.05 relative "
          f"{float((d32 - 0.05 * np.abs(Kj)).max() / scale):.3e}",
          flush=True)
    errs = by_quantity(ctl, iqa, K32, Kj)
    print("  by quantity, of its own max|K| (bar): " + ", ".join(
        f"{name} {e:.3e} ({AD_F32_TOL.get(name)})"
        for name, e in errs.items()), flush=True)
    if sorted(errs) != sorted(AD_F32_TOL) or any(
            not e <= AD_F32_TOL[name] for name, e in errs.items()):
        fail("the float32 autodiff Jacobian misses its bar")
    del K32, d32
    # the jacfwd route in float32 on every fourth ray, profiled: what the
    # tangent kernels replace
    rows4 = slice(None, None, 4)
    K4, nr4, _, _, _ = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float32,
        "flagship autodiff, every fourth ray (jacfwd route)", rows=rows4,
        jacfwd=True)
    ref4 = Kj.reshape(nr, -1, Kj.shape[1])[rows4].reshape(K4.shape)
    e4 = by_quantity(ctl, iqa, K4, ref4)
    print("  float32 jacfwd route vs float64, every fourth ray: " + ", ".join(
        f"{k} {v:.3e}" for k, v in e4.items()), flush=True)
    del Kj, K4, ref4
    jvp_dispatch(torch, dev)

    # FD on the small state, held to those columns of the float64
    # autodiff (the columns of a forward-mode Jacobian do not depend on
    # the rest of the state)
    K_ad = K64[:, (iqa == IDXT) & (atm.z[ipa] <= 18.0)]
    fd_launches = {}
    for kernel_mode, per in (("auto", (1, 0)), ("pallas", (0, 1))):
        ctl_k, ft, atm, obs = retrieval_ctl(flagship, kernel_mode, "small")
        n = atm2x(ctl_k, atm)[0].size
        extra = ({"turbo_tables": tt, "turbo_stats": stats}
                 if kernel_mode == "auto" else {})
        m = ForwardModel(ctl_k, fast_tables=ft, device=dev, **extra)
        ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = ktrace.LAUNCHES = 0
        t0 = time.perf_counter()
        K_fd = kernel(ctl_k, atm.copy(), obs.copy(), m)
        dt = time.perf_counter() - t0
        launches = (ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE,
                    ktrace.LAUNCHES)
        fd_launches[kernel_mode] = launches
        print(f"FD kernel, KERNEL = {kernel_mode}: n = {n}, {n + 1} "
              f"formods in {dt:.1f} s; launches turbo {launches[0]} table "
              f"{launches[1]} tracer {launches[2]}; variant "
              f"{m.last_variant}", flush=True)
        if launches != (per[0] * (n + 1), per[1] * (n + 1), n + 1):
            fail(f"FD kernel ({kernel_mode}): launches {launches}, expected "
                 f"{per} per formod")
        fd_vs_ad(K_fd, K_ad, f"FD ({kernel_mode}, float32 kernel) vs "
                 "float64 autodiff")
        del m

    # card against CPU, float64, a small case
    ctl, ft, atm, obs = small_limb(ng=3, nd=8, nr=9)
    ctl.kernel, ctl.hydz = "jax", 20.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 26.0
    ctl.retq_zmin = [-999.0, 20.0, -999.0]
    ctl.retq_zmax = [-999.0, 20.0, -999.0]
    Ks = []
    for d in ("cpu", dev):
        ctl.usetpu = 0 if d == "cpu" else 1
        m = ForwardModel(ctl, fast_tables=ft, device=d, dtype=torch.float64)
        t0 = time.perf_counter()
        Ks.append(kernel_autodiff(ctl, atm.copy(), obs.copy(), m))
        print(f"small autodiff (n = {Ks[-1].shape[1]}, 9 rays, NLOS "
              f"{ctl.nlos}) on {d}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    e_dev = float(np.abs(Ks[1] - Ks[0]).max() / np.abs(Ks[0]).max())
    print(f"float64 autodiff card (tangent kernels) vs CPU (plain "
          f"versions): {e_dev:.3e} of max|K| (bar {AD_CARD_CPU_TOL})",
          flush=True)
    if not e_dev <= AD_CARD_CPU_TOL:
        fail("the float64 autodiff differs between card and CPU")

    # packages: every fourth ray as one package (or, where the 1084-ray
    # run was one package, in packages of 91) against those rays' rows
    K_cut, nr_cut, npk_cut, _, _ = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float64,
        "flagship autodiff, every fourth ray (tangent kernels)",
        raypack=-1 if npk > 1 else 91, rows=rows4)
    ref = K64.reshape(nr, -1, K64.shape[1])[rows4].reshape(K_cut.shape)
    same = np.array_equal(K_cut, ref)
    print(f"packages: {npk} package(s) for {nr} rays, {npk_cut} for the "
          f"{nr_cut} rays: their rows bit for bit {same}", flush=True)
    if not (same and (npk > 1 or npk_cut > 1)):
        fail("packaged and one-package Jacobian rows differ")
    del K64, K_cut, ref
    torch.cuda.empty_cache()

    # each tangent kernel at the flagship, float64 and float32
    rec, (errs64, abs64, t_errs64, r_errs64) = jvp_timing(
        torch, ForwardModel, flagship, dev, torch.float64)
    rec32, _ = jvp_timing(torch, ForwardModel, flagship, dev, torch.float32)
    for k, v in errs64.items():
        worst_rt[k] = max(worst_rt.get(k, 0.0), v)
    for k, v in abs64.items():
        worst_abs[k] = max(worst_abs.get(k, 0.0), v)
    for k, v in r_errs64.items():
        worst_rec[k] = max(worst_rec.get(k, 0.0), v)
    worst["float64"] = max(worst["float64"], *t_errs64.values())
    from jurassic_torch.geometry import TRACE_RECORD_PARTIALS as partials
    errs_of = {"trace_jvp_record": {
        k: v for k, v in worst_rec.items() if k in partials},
        "trace_jvp_tangent": {**worst, **{
            k: v for k, v in worst_rec.items() if k not in partials}},
        "ega_jvp_record": {
        k: v for k, v in worst_rt.items() if k in ("A", "a_surf",
                                                   "record rad",
                                                   "record tau")},
        "ega_jvp_contract": {k: v for k, v in worst_rt.items()
                             if k in ("contraction", "drad")}}
    for i, name in ((1, "trace_jvp_record"), (2, "trace_jvp_tangent"),
                    (4, "ega_jvp_record"), (5, "ega_jvp_contract")):
        rec[name].update(
            launches=counts64[i],
            launches_on=f"flagship kernel_autodiff, n = 130, float64, "
                        f"{npk} package(s)",
            launches_f32=counts32[i],
            max_abs_err=worst_abs.get(name, worst_abs["drad"]),
            max_abs_err_of=("largest |record difference| from "
                            "trace_step_records_ref" if i == 1 else
                            "largest |A| difference from "
                            "rt_jvp_records_ref" if i == 4 else
                            "largest |drad| difference from "
                            "rt_jvp_contract_ref on the same A" if i == 5
                            else "largest |drad| difference, the RT tangent "
                            "kernels on the tracer tangent kernels' LOS "
                            "against the plain versions")
            + ", float64, the small cases and every 30th flagship ray "
              "at n = 130 (uniform and per-channel axes), and every "
              "flagship ray",
            max_rel_err=errs_of[name],
            ms_of="the kernel alone at the flagship in float64, CUDA "
                  "events around each launch",
            ms_f32=rec32[name]["ms"], bound_ms_f32=rec32[name]["bound_ms"],
            bound_by_f32=rec32[name]["bound_by"],
            library_ms_f32=rec32[name]["library_ms"],
            registers_f32=rec32[name]["registers"])
    rec["ega_jvp_record"].update(**{
        k + "_f32": rec32["ega_jvp_record"][k] for k in (
            "entry_ms", "ms_without_hints", "ms_per_channel_brackets")})
    rec["trace_jvp_record"].update(
        floor_ms_of="the record kernel alone on the busiest flagship ray",
        floor_ms_f32=rec32["trace_jvp_record"]["floor_ms"])
    rec["trace_jvp_tangent"].update(
        entry_ms_f32=rec32["trace_jvp_tangent"]["entry_ms"])
    return (fd_launches["auto"][0], fd_launches["pallas"][1],
            fd_launches["auto"][2]), rec


def busiest_ray(torch, los):
    """The LOS of its ray with the most valid segments alone: the RT
    kernels' floor, the chain one lane runs."""
    idx = torch.argmax(los.valid.sum(dim=1)).reshape(1)
    return los._replace(**{f: getattr(los, f)[idx].contiguous()
                           for f in los._fields})


def rt_bound(torch, m, los, exact: bool) -> tuple:
    """(bound_ms, bound_by, bytes, operations) of one RT kernel pass on
    ``los``: the LOS fields it reads, the tables, the continua and source
    rows once, rad and tau written once, over the HBM rate; the float
    operations of this run's valid segments over the dtype's peak."""
    e = m.eager_tables()
    tbl = e.tbl
    R, S = los.ds.shape
    G, W, D = los.u.shape[2], los.k.shape[2], m.ctl.nd
    b = los.p.element_size()
    n_active = int(los.valid.sum())
    nb = lambda *xs: sum(x.numel() * x.element_size() for x in xs)
    if exact:
        U = tbl.u.shape[3]
        tables = nb(tbl.u, tbl.eps, tbl.p, tbl.t) + tbl.row_monotone.numel()
        corner = OPS_RT_EXACT_CORNER + 2 * math.ceil(math.log2(U))
    else:
        K = tbl.eps.shape[3]
        tables = nb(tbl.eps, tbl.log2_u0, tbl.p, tbl.t) + tbl.valid.numel()
        corner = 35 + math.ceil(math.log2(K))
    tables += 4 * (tbl.nu.numel() + tbl.nt.numel() + tbl.np_.numel())
    n_bytes = (nb(los.p, los.t, los.ds, los.q, los.k, los.u, los.valid,
                  los.tsurf) + tables + (16 + m.sr.shape[0] + 1) * D * b
               + 2 * R * D * b)
    ops = n_active * D * (G * (4 * corner + OPS_PER_GAS["table"])
                          + OPS_PER_SEGMENT + 2 * W)
    peak = PEAK_FP64_FLOPS if los.p.dtype == torch.float64 \
        else PEAK_FP32_FLOPS
    t_b, t_o = n_bytes / PEAK_HBM_BYTES, ops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            n_bytes, ops)


def rt_shape_text(shape: dict) -> str:
    """An RT kernel's launch shape (``ops.ega_rt.launch_shape``) in words."""
    return (f"{shape['blocks_per_sm']} resident blocks an SM "
            f"({shape['slots']} slots) of {shape['threads']} threads, "
            f"{shape['gas_threads']} thread(s) a (ray, channel) lane, "
            f"{shape['lanes_per_pass']} lanes a pass in {shape['passes']} "
            f"pass(es), a block for each of {shape['groups']} groups of "
            f"{shape['rays_per_block']} rays: {shape['rounds']} round(s), "
            f"{shape['groups_per_slot']:.2f} groups a slot")


def rt_shape_record(shape: dict) -> dict:
    """The kernels line's fields of an RT kernel's launch shape."""
    return {k: shape[k] for k in ("blocks_per_sm", "threads", "gas_threads",
                                  "lanes_per_pass", "passes", "rounds",
                                  "groups", "blocks")}


def rt_kernel_phase(torch, ForwardModel, flagship, dev, jax64: dict) -> dict:
    """Phase 15, the RT kernel (``csrc/ega_rt.cu``, the counterpart of
    JAX's jitted ``rt_integrate``) at the flagship: ``KERNEL = exact`` on
    ``fast_to_ega_tables`` of the flagship's tables in float64 and float32,
    ``KERNEL = jax`` on the fast tables in float32, and ``KERNEL = auto``
    on per-channel axes (``workloads.perturbed_axes``, which demotes to
    the fast eager mode) in float32.  Each: one ``formod`` (the main path:
    the counts set to 0 just before and read just after; one RT launch,
    no fused launch, the variant named); on one LOS the kernel
    (``ForwardModel.integrate``) against the eager loop
    (``integrate_eager``) at RT_KERNEL_TOL, the lanes not bit for bit
    counted; the kernel's ms (median of N_KERNEL_RUNS, CUDA events around
    each launch), registers and bound; the loop's ms and device launches
    (one timed, one profiled pass); a profiled formod's launches and idle
    share; under ``jax`` the fused table kernel's ms on the same LOS.
    ``jax64`` is phase 10's hold and time of the kernel under ``jax`` in
    float64.  Returns the kernels line's record of ``ega_rt``."""
    import numpy as np
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    from jurassic_torch.ops import ega_fused, ega_rt
    from jurassic_torch.workloads import perturbed_axes
    rec = {"jax float64": {k: v for k, v in jax64.items()
                           if k != "max_abs_err"}}
    worst = jax64["max_abs_err"]
    for label, kernel, dtype, axes in (
            ("exact float64", "exact", torch.float64, "uniform"),
            ("exact float32", "exact", torch.float32, "uniform"),
            ("jax float32", "jax", torch.float32, "uniform"),
            ("auto on per-channel axes float32", "auto", torch.float32,
             "per_channel")):
        ctl, ft, atm, obs = flagship()
        ctl.usetpu, ctl.kernel = 1, kernel
        if axes == "per_channel":
            ft = perturbed_axes(ft, seed=1)
        tables = fast_to_ega_tables(ft) if kernel == "exact" else None
        t0 = time.perf_counter()
        m = ForwardModel(ctl, tables, fast_tables=ft, device=dev,
                         dtype=dtype)
        e = m.eager_tables()
        exact = kernel == "exact"
        n_lin = 0 if not exact else int((e.tbl.row_monotone != 3).sum())
        print(f"RT kernel, {label}: model built in "
              f"{time.perf_counter() - t0:.1f} s; kernel_mode "
              f"{m.kernel_mode}, axes uniform {e.tbl.uniform}"
              + (f", {tuple(e.tbl.u.shape)} u and eps rows "
                 f"({2 * e.tbl.u.numel() * 4 / 1e6:.1f} MB), {n_lin} cells "
                 f"counted linearly" if exact else ""), flush=True)
        npk = -(-obs.nr // (m.package_size(obs.nr) or obs.nr))
        ega_rt.LAUNCHES = ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = 0
        o = obs.copy()
        m.formod(atm.copy(), o)
        launches = (ega_rt.LAUNCHES, ega_fused.LAUNCHES,
                    ega_fused.LAUNCHES_TABLE)
        want = f"{m.kernel_mode} kernel"
        if (launches != (npk, 0, 0) or m.last_variant != want
                or not np.isfinite(o.rad).all()):
            fail(f"RT kernel, {label}: formod ran {m.last_variant} with "
                 f"launches (RT, turbo, table) {launches}, expected {want} "
                 f"and ({npk}, 0, 0)")
        los = m.trace(atm.copy(), obs.copy())
        out_k = m.integrate(los)
        out_e, ms_e, n_e, busy_e = device_pass(
            torch, lambda: m.integrate_eager(los), f"eager loop, {label}")
        torch.cuda.synchronize()
        scale = float(out_e.rad.abs().max())
        d_rad = float((out_k.rad - out_e.rad).abs().max())
        d_tau = float((out_k.tau - out_e.tau).abs().max())
        off = (int((out_k.rad != out_e.rad).sum()),
               int((out_k.tau != out_e.tau).sum()))
        bar = RT_KERNEL_TOL[str(dtype)[6:]]
        print(f"RT kernel vs the eager loop, {label}, {los.ds.shape[0]} "
              f"rays: rad {d_rad / scale:.3e} of max|rad| {scale:.4e}, tau "
              f"{d_tau:.3e} (bar {bar}); lanes not bit for bit: rad "
              f"{off[0]}, tau {off[1]} of {out_e.rad.numel()}", flush=True)
        if not (torch.isfinite(out_k.rad).all() and scale > 0
                and d_rad <= bar * scale and d_tau <= bar
                and off == (0, 0)):
            fail(f"RT kernel, {label}: kernel and eager loop disagree, or "
                 "not bit for bit")
        worst = max(worst, d_rad, d_tau)
        ms = kernel_ms(torch, lambda: m.integrate(los), "jt_ega_rt",
                       N_KERNEL_RUNS)
        R, G = los.ds.shape[0], los.u.shape[2]
        shape = ega_rt.launch_shape(R, m.ctl.nd, G, e.tbl.uniform, exact,
                                    dtype)
        los1 = busiest_ray(torch, los)
        floor_ms = kernel_ms(torch, lambda: m.integrate(los1), "jt_ega_rt",
                             N_KERNEL_RUNS)
        regs = ega_rt.registers(e.tbl.uniform, exact, dtype)
        b_ms, b_by, nb, ops = rt_bound(torch, m, los, exact)
        _, wall, n_f, busy_f = profiled_call(
            torch, lambda: m.formod(atm.copy(), obs.copy()),
            f"formod {label}")
        idle = 1.0 - busy_f / (wall * 1e3)
        extra = ""
        r = {"launches": launches[0], "ms": ms, "plain_ms": ms_e,
             "plain_device_launches": n_e,
             "bound_ms": b_ms, "bound_by": b_by, "registers": regs,
             "floor_ms": floor_ms, **rt_shape_record(shape),
             "lanes_not_bit_for_bit": off, "formod_launches": n_f,
             "formod_idle_share": idle}
        if kernel == "jax":
            ctl_p = flagship()[0]
            ctl_p.usetpu, ctl_p.kernel = 1, "pallas"
            fm_p = ForwardModel(ctl_p, fast_tables=ft, device=dev)
            r["table_kernel_ms"] = cuda_ms(
                torch, lambda: ega_fused.rt_fused_table(
                    fm_p.table_tbl, fm_p.cc_rows, los, fm_p.flags,
                    fm_p.ig_co2, fm_p.ig_h2o), N_KERNEL_RUNS)
            extra = (f"; the fused table kernel on the same LOS "
                     f"{r['table_kernel_ms']:.3f} ms")
            del fm_p
        print(f"RT kernel, {label}: {ms:.3f} ms (median of "
              f"{N_KERNEL_RUNS}, CUDA events around each launch), "
              f"{regs} registers, {rt_shape_text(shape)}; floor (the "
              f"busiest ray alone) "
              f"{floor_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} "
              f"({nb / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); the eager loop "
              f"{ms_e:.1f} ms, {n_e} device launches (busy {busy_e:.1f} "
              f"ms); a profiled formod {wall * 1e3:.1f} ms, {n_f} device "
              f"launches, busy {busy_f:.2f} ms, idle {idle:.1%}" + extra,
              flush=True)
        rec[label] = r
        del m, los, out_k, out_e, e
        torch.cuda.empty_cache()
    main = rec["exact float64"]
    return {"name": "ega_rt", "route": "cuda",
            "source": "jurassic_torch/csrc/ega_rt.cu",
            "replaces": "jurassic_tpu/forward.py:99",
            "launches": main["launches"],
            "launches_on": "flagship formod KERNEL = exact, float64, one "
                           "package, one call",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "floor_ms": main["floor_ms"], "rounds": main["rounds"],
            "configurations": rec}


def exact_rt_args(torch, ForwardModel, flagship, dev, dtype, rows=None):
    """(model, LOS, LOS tangents, ``rt_jvp_fast_cuda``'s arguments) of the
    flagship retrieval (n = 130) on a ``KERNEL = exact`` model in
    ``dtype``, the tangents from the tracer's tangent kernels (the rays
    ``rows``, default all)."""
    from jurassic_torch.forward import _obs_rows
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    from jurassic_torch.ops.trace_jvp import trace_rays_jvp_cuda
    from jurassic_torch.retrieval import autodiff_seed, package_tangents
    ctl, ft, atm, obs = retrieval_ctl(flagship, "exact", "full")
    if rows is not None:
        obs = _obs_rows(obs, rows)
    m = ForwardModel(ctl, fast_to_ega_tables(ft), fast_tables=ft, device=dev,
                     dtype=dtype)
    seed = autodiff_seed(ctl, atm, m)
    prof, ptan, geo = package_tangents(ctl, atm, obs, m, seed)
    los, tan, _ = trace_rays_jvp_cuda(prof, ptan, geo, ctl.rayds, ctl.raydz,
                                      bool(ctl.refrac), ctl.nlos)
    e = m.eager_tables()
    return m, los, tan, (e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, tan,
                         m.flags, m.ig_co2, m.ig_h2o, bool(ctl.write_bbt))


def exact_jacobian_phase(torch, ForwardModel, flagship, dev) -> dict:
    """Phase 16, the exact-table Jacobian (JAX's ``jax.jit(jax.jacfwd)``
    on ``ega_eps_exact``) at the flagship retrieval (n = 130): the record
    kernel's exact instantiation and the contraction against their plain
    versions (``rt_kernels_hold``: ``rt_jvp_records_ref``,
    ``rt_jvp_contract_ref``, ``rt_integrate_jvp_ref`` on exact tables) at
    AD_KERNEL_TOL, float64 on every ray, float32 on every fourth;
    ``kernel_autodiff`` on a ``KERNEL = exact`` model (the main path: the
    tangent kernels once per package, no other kernel; float64, and
    float32 profiled) and its float64 K against
    ``kernel_autodiff_jacfwd``'s on every fourth ray, per quantity within
    AD_JACFWD_TOL; each RT tangent kernel's ms (median of 5) and bound,
    the seconds of the exact route beside the fast route's and the jacfwd
    route's.  Returns the kernels line's record of the exact record
    kernel."""
    import numpy as np
    from jurassic_torch.ops import ega_jvp as ej
    from jurassic_torch.retrieval import atm2x
    holds = {}
    plain = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain[key] = (time.perf_counter() - t0) * 1e3
        return out
    timing = {}
    for dtype, rows in ((torch.float64, None),
                        (torch.float32, slice(None, None, 4))):
        key = str(dtype)[6:]
        m, los, tan, rargs = exact_rt_args(torch, ForwardModel, flagship,
                                           dev, dtype, rows)
        R, S = los.ds.shape
        G, W, D, n = los.u.shape[2], los.k.shape[2], m.ctl.nd, \
            tan.seg.shape[3]
        errs, bits, d_abs, _ = rt_kernels_hold(
            torch, rargs, S, G, W, timed if dtype == torch.float64 else None)
        torch.cuda.empty_cache()
        holds[key] = (errs, d_abs)
        print(f"exact RT tangent kernels vs plain versions at the flagship "
              f"({R} rays, {key}, n = {n}): " + ", ".join(
                  f"{k} {v:.1e}" for k, v in errs.items())
              + "; bit for bit " + ", ".join(
                  f"{k} {v}" for k, v in bits.items()), flush=True)
        if not max(errs.values()) <= AD_KERNEL_TOL[key]:
            fail(f"the exact RT tangent kernels vs their plain versions "
                 f"({key})")
        if rows is not None:                 # the timing on every ray
            del m, los, tan, rargs
            torch.cuda.empty_cache()
            m, los, tan, rargs = exact_rt_args(torch, ForwardModel,
                                               flagship, dev, dtype)
        R = los.ds.shape[0]
        ms = kernel_ms_each(torch, lambda: ej.rt_jvp_fast_cuda(*rargs),
                            ("jt_ega_jvp_record", "jt_ega_jvp_contract"), 5)
        e = m.eager_tables()
        b = los.p.element_size()
        n_active = int(los.valid.sum())
        F = 3 + 2 * G + W
        U = e.tbl.u.shape[3]
        r_bytes = (sum(x.numel() * x.element_size() for x in (
            los.p, los.t, los.ds, los.q, los.k, los.u, los.valid, los.tsurf,
            e.tbl.u, e.tbl.eps, e.tbl.p, e.tbl.t))
            + 4 * (e.tbl.nu.numel() + e.tbl.nt.numel() + e.tbl.np_.numel())
            + e.tbl.row_monotone.numel() + m.sr.numel() * b
            + 3 * R * D * b + n_active * (F * D * b + 4))
        corner = OPS_RT_JVP_EXACT_CORNER + 2 * math.ceil(math.log2(U))
        r_ops = n_active * D * (4 * G * corner + G * OPS_RT_JVP_GAS
                                + OPS_RT_JVP_SEGMENT + OPS_RT_ADJ_SEGMENT
                                + G * OPS_RT_ADJ_GAS)
        peak = PEAK_FP64_FLOPS if dtype == torch.float64 else PEAK_FP32_FLOPS
        t_b, t_o = r_bytes / PEAK_HBM_BYTES, r_ops / peak
        reg_rec, reg_con = ej.registers(G, W, S, e.tbl.uniform, dtype,
                                        exact=True)
        from jurassic_torch.ops.ega_rt import launch_shape
        shape = launch_shape(R, D, G, e.tbl.uniform, True, dtype,
                             record=True)
        rargs1 = rargs[:6] + (busiest_ray(torch, los),) + rargs[8:]
        floor_ms = kernel_ms_each(torch, lambda: ej.rt_jvp_records_cuda(
            *rargs1), ("jt_ega_jvp_record",), 5)["jt_ega_jvp_record"]
        timing[key] = {"ms": ms["jt_ega_jvp_record"],
                       "contract_ms": ms["jt_ega_jvp_contract"],
                       "bound_ms": max(t_b, t_o) * 1e3,
                       "bound_by": "bytes" if t_b >= t_o else "operations",
                       "registers": reg_rec, "floor_ms": floor_ms,
                       "blocks_per_sm": shape["blocks_per_sm"],
                       "rounds": shape["rounds"], "groups": shape["groups"],
                       "blocks": shape["blocks"]}
        print(f"ega_jvp_record (exact) at the flagship ({R} rays, "
              f"{n_active} valid segments, n = {n}, {key}): "
              f"{ms['jt_ega_jvp_record']:.3f} ms, the contraction on its "
              f"records {ms['jt_ega_jvp_contract']:.3f} ms (medians of 5); "
              f"bound {max(t_b, t_o) * 1e3:.3f} ms by "
              f"{timing[key]['bound_by']} ({r_bytes / 1e9:.2f} GB, "
              f"{r_ops / 1e9:.1f} GFLOP); registers {reg_rec} / {reg_con}; "
              f"{shape['blocks_per_sm']} resident record blocks an SM, "
              f"a block for each of {shape['groups']} groups: "
              f"{shape['rounds']} round(s), {shape['groups_per_slot']:.2f} "
              f"groups a slot; floor (the busiest ray alone) "
              f"{floor_ms:.3f} ms", flush=True)
        del m, los, tan, rargs, e
        torch.cuda.empty_cache()
    K64, nr, npk, counts64, wall64 = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float64,
        "flagship retrieval autodiff, KERNEL = exact (tangent kernels)",
        profiled=False, kernel="exact")
    K32, _, _, counts32, wall32 = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float32,
        "flagship retrieval autodiff, KERNEL = exact (tangent kernels)",
        kernel="exact")
    _, _, _, _, wall_fast = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float64,
        "flagship retrieval autodiff, KERNEL = jax (tangent kernels)",
        profiled=False)
    rows4 = slice(None, None, 4)
    Kj, nr4, _, _, wall_j = autodiff_run(
        torch, ForwardModel, flagship, dev, torch.float64,
        "flagship autodiff, KERNEL = exact, every fourth ray (jacfwd "
        "route)", rows=rows4, profiled=False, jacfwd=True, kernel="exact")
    ctl, _, atm, _ = retrieval_ctl(flagship, "exact", "full")
    _, iqa, _ = atm2x(ctl, atm)
    ref = K64.reshape(nr, -1, K64.shape[1])[rows4].reshape(Kj.shape)
    e_j = by_quantity(ctl, iqa, ref, Kj)
    e32 = by_quantity(ctl, iqa, K32, K64)
    print("KERNEL = exact, float64 tangent kernels vs the jacfwd route on "
          f"every fourth ray ({nr4} rays), by quantity, of its own max|K| "
          f"(bar {AD_JACFWD_TOL}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in e_j.items()), flush=True)
    print("KERNEL = exact, float32 vs float64 (tangent kernels), by "
          "quantity, of its own max|K|: " + ", ".join(
              f"{k} {v:.3e}" for k, v in e32.items()), flush=True)
    print(f"kernel_autodiff at the flagship (n = {K64.shape[1]}, {nr} rays, "
          f"float64): KERNEL = exact {wall64:.3f} s, KERNEL = jax "
          f"{wall_fast:.3f} s (tangent kernels); the jacfwd route on "
          f"KERNEL = exact {wall_j:.1f} s for {nr4} rays; float32 exact "
          f"{wall32:.3f} s (profiled)", flush=True)
    if not all(v <= AD_JACFWD_TOL for v in e_j.values()):
        fail("the KERNEL = exact Jacobian through the tangent kernels is "
             "not the jacfwd route's")
    t64 = timing["float64"]
    return {"name": "ega_jvp_record_exact", "route": "cuda",
            "source": "jurassic_torch/csrc/ega_jvp_fast.cu",
            "replaces": "jurassic_tpu/retrieval.py:281",
            "launches": counts64[4],
            "launches_on": "kernel_autodiff, flagship, KERNEL = exact, "
                           "float64, n = 130",
            "max_abs_err": max(holds["float64"][1]["ega_jvp_record"],
                               holds["float32"][1]["ega_jvp_record"]),
            "ms": t64["ms"], "plain_ms": plain.get("record"),
            "bound_ms": t64["bound_ms"], "bound_by": t64["bound_by"],
            "library_ms": None, "registers": t64["registers"],
            "floor_ms": t64["floor_ms"], "rounds": t64["rounds"],
            "blocks_per_sm": t64["blocks_per_sm"],
            "contract_ms": t64["contract_ms"],
            "entry_plain_ms": plain.get("rt"),
            "float32": timing["float32"],
            "autodiff_s": {"exact": wall64, "fast": wall_fast,
                           "jacfwd_exact_every_4th_ray": wall_j}}


def mgpu_rank(rank: int, port: int, ref_file: str, out_dir: str) -> None:
    """One of two gloo ranks sharing cuda:0 (phase 14): the flagship
    through ``ShardedForwardModel`` on the 2 x 1 and 1 x 2 meshes in
    ``auto``, ``pallas`` and the roughened hybrid.  The turbo fits are
    read from FIT_CACHE (the build phase fitted them): a fit here fails
    the rank.  Writes its timings, launches and verdicts (bit for bit
    the plain formod outputs in ``ref_file``) to
    ``<out_dir>/mgpu_<rank>.json``; any fault raises, and the parent
    fails."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from jurassic_torch.ops import ega_fused
    from jurassic_torch.ops.turbo_fit import build_turbo_tables_cached
    from jurassic_torch.parallel import (ShardedForwardModel,
                                         init_distributed, make_mesh)
    from jurassic_torch.workloads import flagship
    torch.set_num_threads(2)
    init_distributed("gloo", f"tcp://localhost:{port}", 2, rank)
    try:
        dev = torch.device("cuda", 0)
        ctl, ft, atm, obs = flagship()
        ctl.usetpu = 1
        n_cache = len(list(FIT_CACHE.glob("turbo_*.npz")))
        t0 = time.perf_counter()
        tt, st = build_turbo_tables_cached(ft, FIT_CACHE)
        ft_r = roughen(ft)
        tt_r, st_r = build_turbo_tables_cached(ft_r, FIT_CACHE)
        res = {"fit_cache_load_s": time.perf_counter() - t0}
        if len(list(FIT_CACHE.glob("turbo_*.npz"))) != n_cache:
            raise RuntimeError(f"rank {rank} fitted turbo tables anew")
        ref = np.load(ref_file)
        models = {
            "auto": ("auto", dict(fast_tables=ft, turbo_tables=tt,
                                  turbo_stats=st)),
            "pallas": ("pallas", dict(fast_tables=ft)),
            "hybrid": ("turbo", dict(fast_tables=ft_r, turbo_tables=tt_r,
                                     turbo_stats=st_r))}
        for mesh in ((2, 1), (1, 2)):
            for mode, (kernel, kw) in models.items():
                c = dataclasses.replace(ctl, kernel=kernel)
                m = ShardedForwardModel(c, make_mesh(*mesh), device=dev, **kw)
                ega_fused.LAUNCHES = ega_fused.LAUNCHES_TABLE = 0
                m.formod(atm.copy(), obs.copy())          # warm-up
                walls, gathers = [], []
                for _ in range(N_MGPU_RUNS):
                    o = obs.copy()
                    dist.barrier()
                    t0 = time.perf_counter()
                    m.formod(atm.copy(), o)
                    walls.append(time.perf_counter() - t0)
                    gathers.append(m.last_gather_s)
                res[f"{mesh[0]}x{mesh[1]} {mode}"] = {
                    "median_ms": statistics.median(walls) * 1e3,
                    "gather_ms": statistics.median(gathers) * 1e3,
                    "launches": [ega_fused.LAUNCHES,
                                 ega_fused.LAUNCHES_TABLE],
                    "calls": N_MGPU_RUNS + 1, "variant": m.last_variant,
                    "channels": m.local.ctl.nd,
                    "same": all(np.array_equal(getattr(o, f),
                                               ref[f"{mode}_{f}"])
                                for f in OUTPUTS)}
                del m
                torch.cuda.empty_cache()
        (Path(out_dir) / f"mgpu_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mgpu_expected(key: str, rank: int):
    """(variant, (turbo, table) launches per call) of one rank of phase
    13's two: the roughened cells are in channel 2, so the hybrid taints
    lanes on both ranks of the ray split and on rank 0 only of the
    channel split, whose rank 1 runs pure turbo."""
    mode = key.split()[1]
    if mode == "auto":
        return "turbo", (1, 0)
    if mode == "pallas":
        return "table", (0, 1)
    if key.startswith("1x2") and rank == 1:
        return "turbo", (1, 0)
    return "turbo+hybrid", (1, 1)


def ms_spread(walls) -> str:
    """'median ms (min-max)' of wall seconds."""
    ms = sorted(w * 1e3 for w in walls)
    return f"{statistics.median(ms):.1f} ms ({ms[0]:.1f}-{ms[-1]:.1f})"


def mgpu_phase(torch, ForwardModel, flagship, ft, tt, stats, tt_r, stats_r,
               dev):
    """Phase 13: the sharded model on an NCCL group of one process, timed
    in turns with plain formod, then two gloo ranks on the one card, then
    ``python -m jurassic_torch.parallel.dryrun 2`` (gloo, both ranks on
    the card).  Returns the (turbo, table) launches of both ranks under
    the 1 x 2 mesh (``auto`` / ``pallas``) and the calls they span."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from jurassic_torch.parallel import (ShardedForwardModel,
                                         init_distributed, make_mesh)
    from jurassic_torch.parallel.dryrun import free_port
    t_phase = time.perf_counter()
    ctl, _, atm, obs = flagship()
    ctl.usetpu = 1
    ft_r = roughen(ft)
    models = {
        "auto": ("auto", dict(fast_tables=ft, turbo_tables=tt,
                              turbo_stats=stats)),
        "pallas": ("pallas", dict(fast_tables=ft)),
        "hybrid": ("turbo", dict(fast_tables=ft_r, turbo_tables=tt_r,
                                 turbo_stats=stats_r))}
    refs = {}
    init_distributed("nccl", f"tcp://localhost:{free_port()}", 1, 0)
    try:
        for mode in ("auto", "pallas"):
            kernel, kw = models[mode]
            c = dataclasses.replace(ctl, kernel=kernel)
            pair = {"plain": ForwardModel(c, device=dev, **kw),
                    "sharded": ShardedForwardModel(c, make_mesh(1, 1),
                                                   device=dev, **kw)}
            walls = {k: [] for k in pair}
            outs, gathers = {}, []
            for m in pair.values():
                m.formod(atm.copy(), obs.copy())          # warm-up
            for i in range(N_NCCL_RUNS):                  # in turns
                for k in (("plain", "sharded") if i % 2 == 0
                          else ("sharded", "plain")):
                    o = obs.copy()
                    t0 = time.perf_counter()
                    pair[k].formod(atm.copy(), o)
                    walls[k].append(time.perf_counter() - t0)
                    outs[k] = o
                gathers.append(pair["sharded"].last_gather_s)
            refs.update({f"{mode}_{f}": getattr(outs["plain"], f)
                         for f in OUTPUTS})
            same = all(np.array_equal(getattr(outs["sharded"], f),
                                      getattr(outs["plain"], f))
                       for f in OUTPUTS)
            m = pair["sharded"]
            print(f"NCCL world size 1, 1 x 1 mesh, {mode}: variant "
                  f"{m.last_variant} on {m.device}; {N_NCCL_RUNS} calls "
                  f"each in turns, median (min-max): sharded "
                  f"{ms_spread(walls['sharded'])}, plain formod "
                  f"{ms_spread(walls['plain'])}; the all-gather "
                  f"{statistics.median(gathers) * 1e3:.3f} ms; bit for bit "
                  f"plain formod: {same}", flush=True)
            if not (same and m.last_variant == pair["plain"].last_variant
                    and dist.get_backend() == "nccl"):
                fail(f"NCCL world size 1 ({mode}) differs from plain formod")
            del pair, m
    finally:
        dist.destroy_process_group()
    kernel, kw = models["hybrid"]
    o = obs.copy()
    ForwardModel(dataclasses.replace(ctl, kernel=kernel), device=dev,
                 **kw).formod(atm.copy(), o)
    refs.update({f"hybrid_{f}": getattr(o, f) for f in OUTPUTS})
    torch.cuda.empty_cache()
    work = REPO / "jurassic_torch" / "_build" / "smoke" / "mgpu"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ref_file = work / "plain.npz"
    np.savez(ref_file, **refs)

    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        mgpu_rank, args=(free_port(), str(ref_file), str(work)), nprocs=2,
        join=True, start_method="spawn")
    ranks = [json.loads((work / f"mgpu_{r}.json").read_text())
             for r in range(2)]
    print(f"two gloo ranks on one card: {time.perf_counter() - t0:.1f} s "
          f"with start-up; fit cache reads "
          f"{ranks[0]['fit_cache_load_s']:.1f} / "
          f"{ranks[1]['fit_cache_load_s']:.1f} s", flush=True)
    for key in ranks[0]:
        if key == "fit_cache_load_s":
            continue
        rs = [r[key] for r in ranks]
        print(f"  {key}: " + "; ".join(
            f"rank {i}: {r['channels']} channels, variant {r['variant']}, "
            f"median {r['median_ms']:.1f} ms (all-gather "
            f"{r['gather_ms']:.2f} ms), launches turbo {r['launches'][0]} "
            f"table {r['launches'][1]}, bit for bit {r['same']}"
            for i, r in enumerate(rs)), flush=True)
        for i, r in enumerate(rs):
            variant, per = mgpu_expected(key, i)
            n = r["calls"]
            if not (r["same"] and r["variant"] == variant
                    and r["launches"] == [per[0] * n, per[1] * n]):
                fail(f"two ranks, {key}, rank {i}: variant {r['variant']} "
                     f"(expected {variant}), launches {r['launches']} "
                     f"(expected {per} per call), bit for bit {r['same']}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "jurassic_torch.parallel.dryrun", "2"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("dryrun")]
    print(f"python -m jurassic_torch.parallel.dryrun 2: rc "
          f"{res.returncode}, {time.perf_counter() - t0:.1f} s with "
          "start-up", flush=True)
    for ln in lines:
        print(f"  {ln}", flush=True)
    on_card = [ln for ln in lines if "on cuda:0 (gloo)" in ln]
    if res.returncode != 0 or len(on_card) != 3:
        print(res.stderr[-4000:], file=sys.stderr)
        fail("the dryrun did not run its three kernels on the card")
    dt = time.perf_counter() - t_phase
    print(f"multi-GPU phase: {dt:.1f} s", flush=True)
    l12 = [sum(r[f"1x2 {m}"]["launches"][k] for r in ranks)
           for m, k in (("auto", 0), ("pallas", 1))]
    return l12, ranks[0]["1x2 auto"]["calls"]


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
    # the two flagship turbo fits (host NumPy, about a minute each) run in
    # worker processes while nvcc builds the kernels and the probes run
    fits = ProcessPoolExecutor(2, mp_context=get_context("spawn"))
    fit_jobs = [fits.submit(fit_flagship, rough) for rough in (False, True)]
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
    t0 = time.perf_counter()
    fit_s = [job.result() for job in fit_jobs]
    fits.shutdown()
    print(f"turbo fits (or cache loads) in worker processes: "
          f"{fit_s[0]:.1f} s and {fit_s[1]:.1f} s (roughened), waited "
          f"{time.perf_counter() - t0:.1f} s for them here", flush=True)
    cache = FIT_CACHE
    ctl, ft, atm, obs = flagship()
    ctl.usetpu = 1
    if ctl.kernel != "auto":
        fail(f"flagship runs KERNEL = {ctl.kernel}, expected auto")
    t0 = time.perf_counter()
    tt, stats = build_turbo_tables_cached(ft, cache, dev)
    print(f"turbo cache load {time.perf_counter() - t0:.1f} s: "
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
          f"{tuple(fm_p.table_tbl.eps_aug.shape)} (four rows to a float4; "
          f"packed in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    ft_r = roughen(ft)
    t0 = time.perf_counter()
    tt_r, stats_r = build_turbo_tables_cached(ft_r, cache, dev)
    print(f"roughened flagship: turbo cache load "
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
    del ft_r

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
    logical = lambda packed, q: (*packed.shape[:2], q, packed.shape[3])
    b_ms, b_by = ega_bound("turbo", logical(t.coef, t.q_rows), seg_shape,
                           n_active, small_extra(t), rates)
    ctl9, ft9, atm9, obs9 = small_limb(ng=4, nd=9, nr=37, nlos=120,
                                       rayds=20.0, raydz=1.0)
    ctl9.usetpu = 1
    fm9 = ForwardModel(ctl9, fast_tables=ft9, device=dev)
    los9 = fm9.trace(atm9, obs9)
    common9 = (fm9.cc_rows, los9, fm9.flags, fm9.ig_co2, fm9.ig_h2o)
    err9, _ = hold(torch, ega_fused.rt_fused_turbo(fm9.turbo_tbl, *common9),
                   ega_fused.rt_fused_turbo_ref(fm9.turbo_tbl, *common9),
                   "turbo small 37x120x4x9")
    err_s = max(scrambled_check(torch, ega_fused, ForwardModel, dev, "turbo",
                                ng, nd) for ng, nd in ((4, 9), (9, 100)))

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
    bt_ms, bt_by = ega_bound("table", logical(t.eps_aug, t.k_rows + 5),
                             seg_shape, n_active, small_extra(t), rates)
    ctl9.kernel = "pallas"
    fm9p = ForwardModel(ctl9, fast_tables=ft9, device=dev)
    err_t9, _ = hold(
        torch, ega_fused.rt_fused_table(fm9p.table_tbl, *common9),
        ega_fused.rt_fused_table_ref(fm9p.table_tbl, *common9),
        "table small 37x120x4x9")
    err_ts = max(scrambled_check(torch, ega_fused, ForwardModel, dev,
                                 "pallas", ng, nd)
                 for ng, nd in ((4, 9), (9, 100)))
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

    phase("tracer kernel vs plain version")
    tracer = trace_phase(torch, fm, dev)

    phase("goldens through the port's CLI")
    for kernel in ("turbo", "pallas"):
        for case in ("ega", "nadir"):
            run_golden(case, kernel,
                       bench=3 if (case, kernel) == ("ega", "turbo") else 0)

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

    phase("eager oracles (float64 on the card)")
    for case in EAGER_GOLDENS:
        eager_golden(torch, ega_fused, ForwardModel, dev, case, "exact")
    eager_golden(torch, ega_fused, ForwardModel, dev, "ega", "fast")
    fm_e, rt_jax64 = eager_vs_table(torch, ForwardModel, flagship, fm_p,
                                     dev)

    phase("ray packages (RAYPACK)")
    free, total = torch.cuda.mem_get_info(dev)
    print(f"RAYPACK 0 at the flagship: {fm.per_ray_device_bytes()} B/ray "
          f"(auto), {fm_p.per_ray_device_bytes()} (pallas), "
          f"{fm_h.per_ray_device_bytes()} (hybrid), "
          f"{fm_e.per_ray_device_bytes()} (jax, float64, the RT kernel); "
          f"{free / 1e9:.2f} GB free of {total / 1e9:.2f} GB; "
          f"{fm.package_size(R) or R} rays per package", flush=True)
    for m, label in ((fm, "auto"), (fm_p, "pallas"), (fm_h, "hybrid"),
                     (fm_e, "jax float64 (RT kernel)")):
        memory_check(torch, m, atm, obs, label)
    del fm_e
    pk = RAYPACK
    tainted = {int(r) // pk for r in taint_k.any(dim=1).nonzero()[:, 0]}
    print(f"hybrid: tainted lanes in {len(tainted)} of 4 packages",
          flush=True)
    wall_pk = packaged_runs(torch, ega_fused, fm, atm, obs,
                            "flagship formod auto", "turbo", (4, 0), wall)
    packaged_runs(torch, ega_fused, fm_p, atm, obs, "flagship formod pallas",
                  "table", (0, 4), wall_p)
    packaged_runs(torch, ega_fused, fm_h, atm, obs, "flagship formod hybrid",
                  "turbo+hybrid", (4, len(tainted)), wall_h)
    fm.ctl.raypack = RAYPACK
    idle_share(torch, fm, atm, obs, wall_pk * 1e3,
               f"flagship formod auto, RAYPACK {RAYPACK}")
    fm.ctl.raypack = 0

    phase("pencil (IP = 2/3)")
    pencil_phase(torch, ega_fused, ForwardModel, flagship, tt, stats, dev)

    phase("retrieval Jacobians")
    del fm, fm_p, fm_h, fm_rp, los, common, args, args_t, args_h
    torch.cuda.empty_cache()
    (fd_turbo, fd_table, fd_trace), jvp_rec = retrieval_phase(
        torch, ega_fused, ForwardModel, flagship, small_limb, tt, stats, dev)

    phase("multi-GPU (torch.distributed)")
    torch.cuda.empty_cache()
    (mg_turbo, mg_table), mg_calls = mgpu_phase(
        torch, ForwardModel, flagship, ft, tt, stats, tt_r, stats_r, dev)

    phase("RT kernel (jitted rt_integrate's counterpart)")
    torch.cuda.empty_cache()
    rt_rec = rt_kernel_phase(torch, ForwardModel, flagship, dev, rt_jax64)

    phase("exact-table Jacobian")
    torch.cuda.empty_cache()
    exact_rec = exact_jacobian_phase(torch, ForwardModel, flagship, dev)

    import_hygiene()

    phase("kernel record")
    print(card, flush=True)
    fused = {"route": "cuda", "library_ms": None}
    print(json.dumps({"kernels": [
        {"name": "ega_fused_turbo", **fused,
         "source": "jurassic_torch/csrc/ega_fused_turbo.cu",
         "replaces": "jurassic_tpu/ops/pallas/ega_fused.py:1135",
         "launches": launches[0],
         "launches_on": f"flagship formod KERNEL = auto, one package, "
                        f"{N_FORMOD_RUNS + 1} calls",
         "max_abs_err": max(err, err9, err_s, err_h),
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "jacobian_launches": fd_turbo,
         "jacobian_launches_on": "FD retrieval.kernel, flagship, KERNEL = "
                                 "auto, n = 5 (6 formods)",
         "launches_1x2": mg_turbo,
         "launches_1x2_on": f"flagship formod KERNEL = auto over a 1 x 2 "
                            f"mesh, two gloo ranks on one card, both ranks, "
                            f"{mg_calls} calls"},
        {"name": "ega_fused_table", **fused,
         "source": "jurassic_torch/csrc/ega_fused_table.cu",
         "replaces": "jurassic_tpu/ops/pallas/ega_fused.py:859",
         "launches": launches_p[1],
         "launches_on": f"flagship formod KERNEL = pallas, one package, "
                        f"{N_FORMOD_RUNS + 1} calls",
         "max_abs_err": max(err_t, err_t9, err_ts),
         "ms": kt_ms, "plain_ms": pt_ms, "bound_ms": bt_ms,
         "bound_by": bt_by, "jacobian_launches": fd_table,
         "jacobian_launches_on": "FD retrieval.kernel, flagship, KERNEL = "
                                 "pallas, n = 5 (6 formods)",
         "launches_1x2": mg_table,
         "launches_1x2_on": f"flagship formod KERNEL = pallas over a 1 x 2 "
                            f"mesh, two gloo ranks on one card, both ranks, "
                            f"{mg_calls} calls"},
        {"name": "trace_rays", "route": "cuda", "library_ms": None,
         "source": "jurassic_torch/csrc/trace_rays.cu",
         "replaces": "jurassic_tpu/geometry.py:486",
         "launches": launches[2],
         "launches_on": f"flagship formod KERNEL = auto, one package, "
                        f"{N_FORMOD_RUNS + 1} calls",
         **tracer,
         "max_abs_err_of": "largest kernel - plain version difference of "
                           "any float LosData field over every case, edge "
                           "shape and dtype",
         "ms_of": "the wrapper trace_rays_cuda, CUDA events around the "
                  "call (allocation, geometry copy, launch)",
         "kernel_ms_of": "the kernel alone, CUDA events around each "
                         "launch (with the host's launch latency)",
         "floor_kernel_ms_of": "the kernel alone on the busiest flagship "
                               "ray",
         "kernel_ms_132_of": "the kernel alone on the 132 busiest "
                             "flagship rays",
         "kernel_ms_f64_of": "the kernel alone at the flagship in "
                             "float64",
         "jacobian_launches": fd_trace,
         "jacobian_launches_on": "FD retrieval.kernel, flagship, KERNEL = "
                                 "auto, n = 5 (6 formods)"},
        *({"name": name, "route": "cuda",
           "source": "jurassic_torch/csrc/" + (
               "trace_rays_jvp.cu" if name.startswith("trace_jvp_")
               else "ega_jvp_fast.cu"),
           "replaces": "jurassic_tpu/retrieval.py:281", **r}
          for name, r in jvp_rec.items()),
        rt_rec, exact_rec,
        *probe_records], "profile_attempts": PROFILE_ATTEMPTS}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
