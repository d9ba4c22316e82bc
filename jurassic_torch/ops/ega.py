"""Emissivity Growth Approximation core of the eager pipeline (port of
``jurassic_tpu/ops/ega.py``).

Two implementations of ega_eps (jr_common.h:238-268), plain tensor code
batched over [rays, gases, channels]:

* :func:`ega_eps_exact` -- reference-faithful semantics on the ragged
  padded tables: interval searches replicate locate_id/locate_tbl_id
  (jr_common.h:107-125) as masked compare-sums within each row's count,
  interpolation extrapolates linearly at both ends exactly like ``lip``
  on the clamped index.  With float64 inputs this is the in-repo oracle
  (``KERNEL = exact``).
* :func:`ega_eps_fast` -- the same on :class:`~jurassic_torch.tables.
  FastTables` (``KERNEL = jax|fast``): u-axis positions from log2
  arithmetic on the exact log-uniform grid (the legitimised
  FAST_INVERSE_OF_U, jurassic.c:487-609), the eps->u inversion by a
  binary search of ``ceil(log2 K)`` steps.

The JAX package vmaps both over rays; here the ray axis is the leading
axis of every argument.  The device tables keep each searched axis last
(see the container fields), so one gathered row is ``[R, G, D, N]``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import TAU_OPAQUE
from ..tables import LOG2_RATIO_U, EgaTables, FastTables


def _c01(x):
    """Clamp to [0,1] (c01, jr_common.h:43-45)."""
    return torch.clamp(x, 0.0, 1.0)


def _lip(x0, y0, x1, y1, x):
    """Linear interpolation with a guarded denominator; extrapolates like
    the reference ``lip`` (jr_common.h:48-50)."""
    d = x1 - x0
    d = torch.where(d == 0, 1.0, d)
    return y0 + (x - x0) * (y1 - y0) / d


def _count_index(values, counts, x):
    """ilo = clip(#{values <= x within count} - 1, 0, count - 2): the
    branch-free form of the ascending binary searches locate_id /
    locate_tbl_id (jr_common.h:107-125), over the last axis of
    ``values``.  Only the first ``count`` entries of a row are counted:
    the tables are ragged and padded, and nothing is assumed of the
    padding."""
    iota = torch.arange(values.shape[-1], device=values.device)
    below = (values <= x.unsqueeze(-1)) & (iota < counts.unsqueeze(-1))
    idx = below.sum(-1) - 1
    return torch.minimum(idx.clamp_min(0), (counts - 2).clamp_min(0))


def _last(arr, idx):
    """arr[..., idx] per row, the index clipped into the last axis."""
    idx = idx.clamp(0, arr.shape[-1] - 1)
    return torch.gather(arr, -1, idx.unsqueeze(-1)).squeeze(-1)


def _cell(arr, gi, i, di):
    """arr[g, i, ..., d] with the index i [R, G, D] clipped into axis 1."""
    return arr[gi, i.clamp(0, arr.shape[1] - 1), di]


class EgaDeviceTables(NamedTuple):
    """EgaTables on the device, payloads f32 (real_tblND_t,
    jurassic.h:387), axes in f64 like the reference; the axes' searched
    axis last, the u and eps rows channel-innermost as EgaTables holds
    them (a warp's channels at one row entry read adjacent values in the
    RT kernels; the eager pass gathers each row across the channels).
    ``uniform`` and ``row_monotone`` are facts of the tables, decided
    once on upload (:func:`axes_uniform`, :func:`rows_monotone_exact`):
    the RT kernels bracket once per (segment, gas) where the axes are the
    same in every channel, and search a u or eps row by halving, from a
    hint, where it does not decrease within its count (else they count
    it linearly)."""

    np_: torch.Tensor   # [G, D]
    nt: torch.Tensor    # [G, P, D]
    nu: torch.Tensor    # [G, P, T, D]
    p: torch.Tensor     # [G, D, P]
    t: torch.Tensor     # [G, P, D, T]
    u: torch.Tensor     # [G, P, T, U, D]
    eps: torch.Tensor   # [G, P, T, U, D]
    uniform: bool = False
    # [G, P, T, D] uint8: bit 0 the eps row, bit 1 the u row monotone
    row_monotone: torch.Tensor | None = None


class FastDeviceTables(NamedTuple):
    """FastTables on the device (payloads f32); ``p`` and ``t`` with the
    searched axis last, the rest in the FastTables layout.  ``uniform``
    and ``monotone`` are facts of the tables, decided once on upload
    (:func:`axes_uniform`, :func:`rows_monotone`): the RT tangent kernel
    brackets once per (segment, gas) where the axes are the same in every
    channel, and hints its corner searches where the rows are monotone;
    ``axes_monotone`` (:func:`axes_monotone`) lets the fast RT kernel hint
    its per-channel bracket searches."""

    np_: torch.Tensor      # [G, D]
    nt: torch.Tensor       # [G, P, D]
    p: torch.Tensor        # [G, D, P]
    t: torch.Tensor        # [G, P, D, T]
    nu: torch.Tensor       # [G, P, T, D]
    log2_u0: torch.Tensor  # [G, P, T, D]
    eps: torch.Tensor      # [G, P, T, K, D]
    valid: torch.Tensor    # [G, P, T, D] bool
    uniform: bool = False
    monotone: bool = False
    axes_monotone: bool = False


def _ten(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def ega_tables_to_device(tbl: EgaTables, device) -> EgaDeviceTables:
    """Upload the padded exact tables (``forward.py:51-57`` of the JAX
    package), the axes transposed so that each searched axis is last,
    the u and eps rows as they are (channels innermost), with the two
    decisions the RT kernels take from the tables; prints how many rows
    the kernels count linearly, where there are any."""
    def t(a, *perm):
        return _ten(a, device).permute(*perm).contiguous()
    mono = rows_monotone_exact(tbl)
    n_lin = int((mono != 3).sum())
    if n_lin:
        print(f"# exact tables: {n_lin} of {mono.size} (gas, p, T, "
              "channel) cells hold a u or eps row that decreases within "
              "its count; the RT kernels count those rows linearly")
    return EgaDeviceTables(
        np_=_ten(tbl.np_, device).long(), nt=_ten(tbl.nt, device).long(),
        nu=_ten(tbl.nu, device).long(), p=t(tbl.p, 0, 2, 1),
        t=t(tbl.t, 0, 1, 3, 2), u=_ten(tbl.u, device),
        eps=_ten(tbl.eps, device), uniform=axes_uniform(tbl),
        row_monotone=_ten(mono, device))


def fast_tables_to_device(tbl: FastTables, device) -> FastDeviceTables:
    """Upload FastTables (``forward.py:60-65`` of the JAX package), with
    the two decisions the RT tangent kernel takes from the tables."""
    def t(a, *perm):
        return _ten(a, device).permute(*perm).contiguous()
    return FastDeviceTables(
        np_=_ten(tbl.np_, device).long(), nt=_ten(tbl.nt, device).long(),
        p=t(tbl.p, 0, 2, 1), t=t(tbl.t, 0, 1, 3, 2),
        nu=_ten(tbl.nu, device).long(), log2_u0=_ten(tbl.log2_u0, device),
        eps=_ten(tbl.eps, device), valid=_ten(tbl.valid, device),
        uniform=axes_uniform(tbl), monotone=rows_monotone(tbl),
        axes_monotone=axes_monotone(tbl))


def _same_bits(a: np.ndarray) -> bool:
    """Whether every channel (last axis) of ``a`` holds the bits of
    channel 0."""
    a = np.ascontiguousarray(a)
    u = a.view(np.uint8).reshape(*a.shape, a.itemsize)
    return bool((u == u[..., :1, :]).all())


def axes_uniform(tbl: FastTables | EgaTables) -> bool:
    """Whether the (p, T) axes and their counts are bitwise the same in
    every channel: then channel 0's count searches (:func:`_count_index`)
    give every channel's bracket, and the RT tangent kernel brackets once
    per (segment, gas) for all of them.  Bitwise, not ``np.allclose``: an
    axis one ulp apart can bracket a point differently."""
    return all(_same_bits(a) for a in (tbl.np_, tbl.nt, tbl.p, tbl.t))


def _row_non_decreasing(a: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Per row of ``a`` [..., U, D] (the row axis -2): whether its first
    ``n`` [..., D] entries are non-decreasing and not NaN, with n <= U."""
    U = a.shape[-2]
    k = np.arange(1, U)[:, None]
    live = k < n[..., None, :]               # both ends within the count
    ok = (a[..., 1:, :] >= a[..., :-1, :]) | ~live
    first = np.isnan(a[..., :1, :]) & (n[..., None, :] > 0)
    return ok.all(axis=-2) & ~first[..., 0, :] & (n <= U)


def axes_monotone(tbl: FastTables) -> bool:
    """Whether every p axis is non-decreasing over its ``np`` points and
    every T row over its ``nt`` points (no NaN; the counts at most the
    axes' lengths): there :func:`_count_index`'s index is the one index i
    with (i = 0 or v[i] <= x) and (i = count - 2 or v[i + 1] > x), which a
    hint can be checked against (the fast RT kernel's per-channel
    brackets, ``csrc/ega_rt.cu``)."""
    np_, nt = np.asarray(tbl.np_), np.asarray(tbl.nt)
    return bool(_row_non_decreasing(np.asarray(tbl.p), np_).all()
                and _row_non_decreasing(np.asarray(tbl.t), nt).all())


def rows_monotone(tbl: FastTables) -> bool:
    """Whether every eps row is non-decreasing over its ``nu`` points
    (no NaN; ``nu`` at most K): there the fixed halving of the eps -> u
    inversion has one answer a hint can be checked against
    (``ops.ega_jvp.hinted_halving``)."""
    nu = np.asarray(tbl.nu)          # a gas at a time: 1/G of the bytes
    return all(_row_non_decreasing(np.asarray(tbl.eps[g]), nu[g]).all()
               for g in range(nu.shape[0]))


def rows_monotone_exact(tbl: EgaTables) -> np.ndarray:
    """[G, P, T, D] uint8: bit 0 set where the eps row of the (gas, p, T,
    channel) cell is non-decreasing over its ``nu`` points (no NaN, ``nu``
    at most U), bit 1 where the u row is: on such a row a halving, or a
    hint checked against its defining property, gives
    :func:`_count_index`'s index (``ops.ega_jvp.exact_row_index``)."""
    nu = np.asarray(tbl.nu)
    out = np.zeros(nu.shape, np.uint8)
    for g in range(nu.shape[0]):             # a gas at a time
        out[g] = (_row_non_decreasing(np.asarray(tbl.eps[g]), nu[g])
                  + 2 * _row_non_decreasing(np.asarray(tbl.u[g]), nu[g]))
    return out


def _brackets(tbl, p, t, G, D):
    """Pressure level and temperature rows of every (ray, gas, channel):
    (ipr, t_lo, t_hi, nt_lo, nt_hi, it0, it1, pb, tb) with the
    row-valued ones [R, G, D, T] and the rest [R, G, D]."""
    R = p.shape[0]
    dev = p.device
    gi = torch.arange(G, device=dev).view(1, G, 1)
    di = torch.arange(D, device=dev).view(1, 1, D)
    pb = p.view(R, 1, 1).expand(R, G, D)
    tb = t.view(R, 1, 1).expand(R, G, D)
    ipr = _count_index(tbl.p.unsqueeze(0), tbl.np_, pb)
    t_lo = _cell(tbl.t, gi, ipr, di)
    t_hi = _cell(tbl.t, gi, ipr + 1, di)
    nt_lo = _cell(tbl.nt, gi, ipr, di)
    nt_hi = _cell(tbl.nt, gi, ipr + 1, di)
    it0 = _count_index(t_lo, nt_lo, tb)
    it1 = _count_index(t_hi, nt_hi, tb)
    return gi, di, ipr, t_lo, t_hi, nt_lo, nt_hi, it0, it1, pb, tb


def _factor(tau_path, eps_t, no_table):
    """tau_path's update factor with the guards in reference order
    (jr_common.h:239-246)."""
    opaque = tau_path < TAU_OPAQUE
    tau_safe = torch.where(opaque, 1.0, tau_path)
    factor = (1.0 - eps_t) / tau_safe
    factor = torch.where(no_table, 1.0, factor)
    return torch.where(opaque, 0.0, factor).to(tau_path.dtype)


def ega_eps_exact(tbl: EgaDeviceTables, tau_path, t, u_seg, p):
    """Exact EGA emissivity factor for one LOS segment of every ray.

    Args:
      tbl: device tables (:func:`ega_tables_to_device`).
      tau_path: accumulated per-gas transmittance [R, G, D].
      t, p: segment temperature / pressure [R].
      u_seg: per-gas segment column density [R, G].

    Returns: factor [R, G, D] such that tau_path *= factor
    (ega_eps, jr_common.h:238-268).  Each corner materialises its u and
    eps rows [R, G, D, U].
    """
    return _ega_exact(tbl, tau_path, t, u_seg, p, False)


def ega_eps_exact_partials(tbl: EgaDeviceTables, tau_path, t, u_seg, p):
    """(factor, dfactor/dtau_path, dfactor/dt, dfactor/dp,
    dfactor/du_seg), each [R, G, D]: :func:`ega_eps_exact`'s factor, bit
    for bit, and its local partials by torch's rules at the kinks, as
    :func:`ega_eps_fast_partials` gives them on the fast tables: each
    corner's slope of get_u in the target emissivity and of get_eps in u
    (``_lip``'s guarded denominators), the bilinear (t, p) weights, the
    ``_c01`` clamps (a tangent passes where ``_in01``), ``_factor``'s
    guards; the count searches' indices are piecewise constant.  Of
    ``forward.rt_integrate_jvp_ref`` and of the RT kernels' exact
    corners (``csrc/ega_rt_common.cuh``)."""
    return _ega_exact(tbl, tau_path, t, u_seg, p, True)


def _ega_exact(tbl: EgaDeviceTables, tau_path, t, u_seg, p, partials: bool):
    """Exact-table EGA factor (and with ``partials`` its local partials).
    The corners run in the working dtype; the bilinear weights read the
    float64 axes, so in float32 the (t, p) interpolation and the factor
    are float64 until the factor's cast (torch's type promotion)."""
    G, P, T, U, D = tbl.u.shape
    dtype = tau_path.dtype
    (gi, di, ipr, t_lo, t_hi, nt_lo, nt_hi, it0, it1, pb,
     tb) = _brackets(tbl, p, t, G, D)
    eps_target = 1.0 - tau_path                              # [R, G, D]
    u_add = u_seg.to(dtype).unsqueeze(-1)

    def corner(dp, it):
        """One (pressure, temperature) corner: invert eps->u, add the
        segment's u, re-look-up eps (jr_common.h:249-257); with its
        slopes in the target emissivity and in the segment's u."""
        pc = (ipr + dp).clamp(0, P - 1)
        ic = it.clamp(0, T - 1)
        u_row = tbl.u[gi, pc, ic, :, di].to(dtype)           # [R, G, D, U]
        e_row = tbl.eps[gi, pc, ic, :, di].to(dtype)
        n_u = tbl.nu[gi, pc, ic, di]                         # [R, G, D]
        # get_u (jr_common.h:180-185)
        i = _count_index(e_row, n_u, eps_target)
        e0, e1 = _last(e_row, i), _last(e_row, i + 1)
        v0, v1 = _last(u_row, i), _last(u_row, i + 1)
        u_c = _lip(e0, v0, e1, v1, eps_target)
        # get_eps at u_c + u_seg (jr_common.h:157-177)
        u_new = u_c + u_add
        j = _count_index(u_row, n_u, u_new)
        w0, w1 = _last(u_row, j), _last(u_row, j + 1)
        f0, f1 = _last(e_row, j), _last(e_row, j + 1)
        raw = _lip(w0, f0, w1, f1, u_new)
        if not partials:
            return _c01(raw), n_u >= 2, None, None
        s_inv = (v1 - v0) / _guard(e1 - e0)
        s_fwd = torch.where(_in01(raw), (f1 - f0) / _guard(w1 - w0), 0.0)
        return _c01(raw), n_u >= 2, s_fwd * s_inv, s_fwd

    eps00, ok00, cT00, cu00 = corner(0, it0)
    eps01, ok01, cT01, cu01 = corner(0, it0 + 1)
    eps10, ok10, cT10, cu10 = corner(1, it1)
    eps11, ok11, cT11, cu11 = corner(1, it1 + 1)

    # bilinear: t within each pressure row, then p (jr_common.h:259-265)
    tx = (_last(t_lo, it0), _last(t_lo, it0 + 1), _last(t_hi, it1),
          _last(t_hi, it1 + 1))
    eps_p0 = _c01(_lip(tx[0], eps00, tx[1], eps01, tb))
    eps_p1 = _c01(_lip(tx[2], eps10, tx[3], eps11, tb))
    pr = tbl.p.unsqueeze(0).expand(p.shape[0], G, D, -1)
    px = (_last(pr, ipr), _last(pr, ipr + 1))
    eps_t = _c01(_lip(px[0], eps_p0, px[1], eps_p1, pb))
    no_table = ((tbl.np_ < 2) | (nt_lo < 2) | (nt_hi < 2)
                | ~ok00 | ~ok01 | ~ok10 | ~ok11)
    factor = _factor(tau_path, eps_t, no_table)
    if not partials:
        return factor
    return (factor, *_bilinear_partials(
        (eps00, eps01, eps10, eps11), (cT00, cT01, cT10, cT11),
        (cu00, cu01, cu10, cu11), tx, px, tb, pb, (eps_p0, eps_p1), eps_t,
        tau_path, no_table))


def _bilinear_partials(e4, cT4, cu4, tx, px, tb, pb, eps_p, eps_t, tau_path,
                       no_table):
    """(dfactor/dtau_path, /dt, /dp, /du_seg) from the four corners'
    emissivities ``e4`` and their slopes in the target (``cT4``) and in
    u (``cu4``), the corners' (t00, t01, t10, t11) ``tx`` and (p0, p1)
    ``px``, the point (tb, pb), the two rows' clamped values ``eps_p`` and
    eps_t: the bilinear weights behind each ``_c01`` clamp, then
    ``_factor``'s guards, whose factor (1 - eps_t) / tau_path takes
    eps_t at the target 1 - tau_path where a gas is neither opaque nor
    without a table."""
    def t_lip(ta, tb_, c0, c1):
        """One pressure row's t interpolation: (d/d target, d/du,
        d/dt) of its clamped value."""
        raw = _lip(ta, e4[c0], tb_, e4[c1], tb)
        d = _guard(tb_ - ta)
        w = (tb - ta) / d
        m = _in01(raw)
        mix = lambda a: torch.where(m, (1.0 - w) * a[c0] + w * a[c1], 0.0)
        return (mix(cT4), mix(cu4),
                torch.where(m, (e4[c1] - e4[c0]) / d, 0.0))
    r0, r1 = t_lip(tx[0], tx[1], 0, 1), t_lip(tx[2], tx[3], 2, 3)
    p0, p1 = px
    raw = _lip(p0, eps_p[0], p1, eps_p[1], pb)
    d = _guard(p1 - p0)
    w = (pb - p0) / d
    m = _in01(raw)
    e_T, e_u, e_t = (torch.where(m, (1.0 - w) * a + w * b, 0.0)
                     for a, b in zip(r0, r1))
    e_p = torch.where(m, (eps_p[1] - eps_p[0]) / d, 0.0)
    keep = ~(tau_path < TAU_OPAQUE) & ~no_table
    tp = torch.where(keep, tau_path, 1.0)
    f_raw = (1.0 - eps_t) / tp
    part = lambda a: torch.where(keep, a, 0.0).to(tau_path.dtype)
    return (part((e_T - f_raw) / tp), part(-e_t / tp), part(-e_p / tp),
            part(-e_u / tp))


def ega_eps_fast(tbl: FastDeviceTables, tau_path, t, u_seg, p):
    """Fast-mode EGA factor on log-uniform resampled tables; same
    contract as :func:`ega_eps_exact` (:func:`_ega_fast`)."""
    return _ega_fast(tbl, tau_path, t, u_seg, p, False)


def ega_eps_fast_partials(tbl: FastDeviceTables, tau_path, t, u_seg, p):
    """(factor, dfactor/dtau_path, dfactor/dt, dfactor/dp,
    dfactor/du_seg), each [R, G, D]: :func:`ega_eps_fast`'s factor, bit
    for bit, and its local partials, by torch's rules at the kinks
    (``torch.clamp`` passes a tangent at its bounds, ``torch.where``
    takes the selected side's).  The searches' indices are piecewise
    constant; the slopes are the inversion's (eps -> u), the forward
    lookup's (u -> eps) and the bilinear (t, p) weights', behind the
    ``_c01`` clamps and ``_factor``'s guards.  Of
    ``forward.rt_integrate_jvp_ref`` and of the RT JVP kernel's plain
    arithmetic (``csrc/ega_jvp_fast.cu``)."""
    return _ega_fast(tbl, tau_path, t, u_seg, p, True)


def ega_eps_partials(tbl, tau_path, t, u_seg, p):
    """:func:`ega_eps_exact_partials` on :class:`EgaDeviceTables`,
    :func:`ega_eps_fast_partials` on :class:`FastDeviceTables`."""
    fn = (ega_eps_exact_partials if isinstance(tbl, EgaDeviceTables)
          else ega_eps_fast_partials)
    return fn(tbl, tau_path, t, u_seg, p)


def _in01(x):
    """Where ``_c01`` passes a tangent (torch.clamp's rule)."""
    return (x >= 0.0) & (x <= 1.0)


def _guard(d):
    return torch.where(d == 0, 1.0, d)


def _ega_fast(tbl: FastDeviceTables, tau_path, t, u_seg, p,
              partials: bool):
    """Fast-mode EGA factor (and with ``partials`` its local partials).

    The eps->u inversion (get_u, jr_common.h:180-185) is a binary search
    on the eps row -- ``ceil(log2 K)`` single-element gathers, a fixed
    count of steps (JAX rolls them in a ``fori_loop``) -- with u values
    reconstructed from the log-uniform grid.  The u->eps lookup (get_eps,
    jr_common.h:157-177) is index arithmetic.  All four (p, T) corners
    run on one axis: [R, G, 4, D]."""
    G, P, T, K, D = tbl.eps.shape
    dtype = tau_path.dtype
    eps_flat = tbl.eps.reshape(G, P * T * K, D)
    l2u0_flat = tbl.log2_u0.reshape(G, P * T, D)
    nu_flat = tbl.nu.reshape(G, P * T, D)
    valid_flat = tbl.valid.reshape(G, P * T, D)
    (gi, di, ipr, t_lo, t_hi, nt_lo, nt_hi, it0, it1, pb,
     tb) = _brackets(tbl, p, t, G, D)
    eps_target = 1.0 - tau_path                              # [R, G, D]
    ratio = 2.0 ** LOG2_RATIO_U

    # corner axis: [(p0,t0), (p0,t0+1), (p1,t1), (p1,t1+1)] -> [R, G, 4, D]
    ipt = torch.stack([ipr * T + it0, ipr * T + it0 + 1,
                       (ipr + 1) * T + it1, (ipr + 1) * T + it1 + 1], dim=2)
    # out-of-range cells and rows (only where a gas has no table, whose
    # factor the guards set to 1) read the nearest in range
    g4, d4 = gi.unsqueeze(-1), di.unsqueeze(-2)
    cell = ipt.clamp(0, P * T - 1)
    l2u0 = l2u0_flat[g4, cell, d4].to(dtype)
    nk = nu_flat[g4, cell, d4]
    ok = valid_flat[g4, cell, d4]
    base_k = ipt * K

    def gather(i):
        return eps_flat[g4, (base_k + i).clamp(0, P * T * K - 1),
                        d4].to(dtype)

    target4 = eps_target.unsqueeze(2).expand(ipt.shape)

    # invert: u at accumulated eps (locate_tbl_id, jr_common.h:117-125),
    # one binary search over all corners at once
    lo = torch.zeros_like(nk)
    hi = (nk - 1).clamp_min(1)
    for _ in range(max(1, int(np.ceil(np.log2(max(K, 2)))))):
        active = hi > lo + 1
        mid = (hi + lo) >> 1
        pred = gather(mid) > target4
        hi = torch.where(active & pred, mid, hi)
        lo = torch.where(active & ~pred, mid, lo)
    u0 = torch.exp2(l2u0 + lo.to(dtype) * LOG2_RATIO_U)
    u_c = _lip(gather(lo), u0, gather(lo + 1), u0 * ratio, target4)

    # forward: eps at u_c + u_seg; u index from log2 arithmetic, never
    # below the interval the inversion found: u_new >= u_c >= u[lo]
    # exactly, and where log2(exp2(.)) rounds a node down (u_c on the
    # node u[lo], the segment too thin to move it) the interval below
    # gives the same value to rounding but another slope -- in float32
    # on a saturated limb path the primal then sits on the node step
    # after step while a tangent grows by that slope ratio every step
    # (a deviation from the JAX package's clip, ROADMAP.md section 3)
    u_new = u_c + u_seg.to(dtype).view(*u_seg.shape, 1, 1)
    k = (torch.log2(torch.clamp(u_new, min=1e-300)) - l2u0) / LOG2_RATIO_U
    ki = torch.minimum(k.to(torch.int32).long().clamp_min(0),
                       (nk - 2).clamp_min(0))
    ki = torch.maximum(ki, lo)
    u_lo = torch.exp2(l2u0 + ki.to(dtype) * LOG2_RATIO_U)
    eps_c = _c01(_lip(u_lo, gather(ki), u_lo * ratio, gather(ki + 1),
                      u_new))                                # [R, G, 4, D]

    t00 = _last(t_lo, it0).to(dtype)
    t01 = _last(t_lo, it0 + 1).to(dtype)
    t10 = _last(t_hi, it1).to(dtype)
    t11 = _last(t_hi, it1 + 1).to(dtype)
    eps_p0 = _c01(_lip(t00, eps_c[:, :, 0], t01, eps_c[:, :, 1], tb))
    eps_p1 = _c01(_lip(t10, eps_c[:, :, 2], t11, eps_c[:, :, 3], tb))
    pr = tbl.p.unsqueeze(0).expand(p.shape[0], G, D, -1)
    p0 = _last(pr, ipr).to(dtype)
    p1 = _last(pr, ipr + 1).to(dtype)
    eps_t = _c01(_lip(p0, eps_p0, p1, eps_p1, pb))
    no_table = ((tbl.np_ < 2) | (nt_lo < 2) | (nt_hi < 2)
                | ~ok.all(dim=2))
    factor = _factor(tau_path, eps_t, no_table)
    if not partials:
        return factor

    # corners: d eps_c / d target (through u_c) and / d u_seg
    s_inv = (u0 * ratio - u0) / _guard(gather(lo + 1) - gather(lo))
    raw = _lip(u_lo, gather(ki), u_lo * ratio, gather(ki + 1), u_new)
    s_fwd = torch.where(_in01(raw), (gather(ki + 1) - gather(ki))
                        / _guard(u_lo * ratio - u_lo), 0.0)
    c_T, c_u = s_fwd * s_inv, s_fwd
    four = lambda a: tuple(a[:, :, c] for c in range(4))
    return (factor, *_bilinear_partials(
        four(eps_c), four(c_T), four(c_u), (t00, t01, t10, t11), (p0, p1),
        tb, pb, (eps_p0, eps_p1), eps_t, tau_path, no_table))
