"""The least time the H100 could take for the work of a call: the
yardstick of the ``*_roofline`` metrics.

A bound counts the work the inputs need, whatever implements it: the
active (segment, channel, gas) count from the reference's own tracer,
times the operations of the EGA formulation per unit of work, and the
compulsory bytes (every input read once, every output written once).
The bound is the larger of operations over the peak rate and bytes over
the peak bandwidth, and says which one it is.  Peaks are NVIDIA's
published H100 SXM figures (dense, no sparsity), at the full 700 W; the
card's power limit is printed beside every run.

Operations per unit, counted from the upstream formulation as the
kernels of the program state it, a transcendental, compare or select as
one operation (copied from the program's own bound arithmetic of
``chip_smoke.py``, and frozen here):

* a fast-table corner of the fused turbo pass: two 9-term Clenshaw
  recurrences (56), clips, range extensions and selects (47), exp2,
  log2, 2 exp, 1 div: 108; of the table pass: ceil(log2 K) search
  compares, two guarded lips (14), index arithmetic and clips (18), 2
  exp2, log2: 35 + ceil(log2 K);
* an exact-table corner: two searches of ceil(log2 U) compares, two
  guarded lips (14), index clamps and the loads' arithmetic (10): 24 +
  2 ceil(log2 U);
* per gas and segment: three guarded lips and clips (27), validity,
  opacity cut, tau_path (13), and for turbo eta (8): 40 / 48;
* per segment: continua (about 60, + 2 per window), the source (8), the
  rad / tau recursion (10): 78 + 2 W;
* the tracer, per step: 202, per level and step 10, per gas and step 10,
  per window and step 6, per ray 1000;
* the tracer's tangent pass, per step and tangent: 190, per gas or window
  7, per gas 12;
* the RT tangent record pass, per valid segment and channel: an exact
  corner 43 + 2 ceil(log2 U), per gas 47, per segment 110, its adjoint
  sweep 26 per segment and 13 per gas;
* the contraction: a multiply and an add per (segment, channel, LOS
  field, tangent), 2 per (ray, channel, tangent) for the surface term.
"""
from __future__ import annotations

import math

PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_FP64_TENSOR = 67e12     # DMMA: the contraction only
PEAK_HBM = 3.35e12

OPS_TURBO_CORNER = 108
OPS_PER_GAS = {"turbo": 48, "table": 40}
OPS_PER_SEGMENT = 78
OPS_RT_EXACT_CORNER = 24
OPS_TRACE_STEP = 202
OPS_TRACE_LEVEL = 10
OPS_TRACE_GAS = 10
OPS_TRACE_WINDOW = 6
OPS_TRACE_RAY = 1000
OPS_TRACE_JVP_STEP = 190
OPS_TRACE_JVP_FIELD = 7
OPS_TRACE_JVP_GAS = 12
OPS_RT_JVP_EXACT_CORNER = 43
OPS_RT_JVP_GAS = 47
OPS_RT_JVP_SEGMENT = 110
OPS_RT_ADJ_SEGMENT = 26
OPS_RT_ADJ_GAS = 13
# continuum coefficient rows per channel beside the source table's
CONTINUA_ROWS = 16


def bound(n_bytes: float, ops: float, peak: float) -> tuple:
    """(seconds, "operations" | "bytes", bytes, operations)."""
    t_b, t_o = n_bytes / PEAK_HBM, ops / peak
    return max(t_b, t_o), ("bytes" if t_b > t_o else "operations"), \
        n_bytes, ops


def los_bytes(R: int, S: int, G: int, W: int, b: int) -> int:
    """A traced LOS as the pass reads it: p, t, ds, q [G], u [G], k [W]
    per point in ``b`` bytes, the valid flag, and tsurf per ray."""
    return R * S * ((3 + 2 * G + W) * b + 1) + R * b


def fused_ops(mode: str, n_active: int, D: int, G: int, W: int,
              K: int) -> int:
    """Float32 operations of one fused pass ("turbo" or "table")."""
    corner = OPS_TURBO_CORNER if mode == "turbo" \
        else 35 + math.ceil(math.log2(K))
    return n_active * D * (G * (4 * corner + OPS_PER_GAS[mode])
                           + OPS_PER_SEGMENT + 2 * W)


def turbo(n_active: int, R: int, S: int, G: int, W: int, D: int, P: int,
          T: int, K: int, n_src: int) -> tuple:
    """One fused turbo pass (float32): the LOS and the fast tables (the
    eps rows and their u0) in, rad and tau out."""
    n_bytes = (los_bytes(R, S, G, W, 4) + G * P * T * D * (4 * K + 8)
               + (CONTINUA_ROWS + n_src) * D * 4 + 2 * R * D * 4)
    return bound(n_bytes, fused_ops("turbo", n_active, D, G, W, K), PEAK_FP32)


def rt_exact(n_active: int, R: int, S: int, G: int, W: int, D: int, P: int,
             T: int, U: int, n_src: int, b: int) -> tuple:
    """One RT pass on the exact tables in ``b``-byte floats: the LOS, the
    u and eps rows (float32) with their counts and axes, the continua and
    source rows in; rad and tau out."""
    corner = OPS_RT_EXACT_CORNER + 2 * math.ceil(math.log2(U))
    ops = n_active * D * (G * (4 * corner + OPS_PER_GAS["table"])
                          + OPS_PER_SEGMENT + 2 * W)
    tables = (2 * G * P * T * U * D * 4 + 4 * (G * P * T * D + G * P * D
                                               + G * D)
              + 8 * G * D * (P + P * T))
    n_bytes = (los_bytes(R, S, G, W, b) + tables
               + (CONTINUA_ROWS + n_src) * D * b + 2 * R * D * b)
    return bound(n_bytes, ops, PEAK_FP64 if b == 8 else PEAK_FP32)


def jacobian_exact(n_active: int, R: int, S: int, L: int, N: int, n: int,
                   G: int, W: int, D: int, P: int, T: int, U: int,
                   n_src: int, b: int) -> dict:
    """The four tangent passes of one Jacobian on exact tables, each
    {name: bound()}: the tracer (profiles in, the LOS out), its tangents
    (the profile tangents in, the LOS tangents out), the RT record pass
    (the LOS and tables in, A -- the sensitivity of rad to each LOS field
    of each valid segment -- out) and the contraction (A and the LOS
    tangents in, K out).  ``L`` levels a ray's profile, ``N`` atmosphere
    points, ``n`` state elements."""
    peak = PEAK_FP64 if b == 8 else PEAK_FP32
    F = 3 + 2 * G + W
    prof = R * L * (3 + G + W) * b
    los = los_bytes(R, S, G, W, b)
    tan = R * S * F * n * b
    corner = OPS_RT_JVP_EXACT_CORNER + 2 * math.ceil(math.log2(U))
    tables = 2 * G * P * T * U * D * 4 + 4 * G * P * T * D
    A = n_active * F * D * b
    return {
        "tracer": bound(prof + los, R * S * (
            OPS_TRACE_STEP + OPS_TRACE_LEVEL * L + OPS_TRACE_GAS * G
            + OPS_TRACE_WINDOW * W) + R * OPS_TRACE_RAY, peak),
        "tracer tangents": bound(
            N * (2 + G + W) * n * b + prof + los + tan,
            R * S * n * (OPS_TRACE_JVP_STEP + OPS_TRACE_JVP_FIELD * (G + W)
                         + OPS_TRACE_JVP_GAS * G), peak),
        "RT record": bound(
            los + tables + (CONTINUA_ROWS + n_src) * D * b + A,
            n_active * D * (4 * G * corner + G * OPS_RT_JVP_GAS
                            + OPS_RT_JVP_SEGMENT + OPS_RT_ADJ_SEGMENT
                            + G * OPS_RT_ADJ_GAS), peak),
        "contraction": bound(
            A + tan + R * D * n * b,
            2 * n_active * F * D * n + 2 * R * D * n,
            PEAK_FP64_TENSOR if b == 8 else PEAK_FP32),
    }
