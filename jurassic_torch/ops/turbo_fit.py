"""Chebyshev-compressed EGA tables ("turbo" tables), port of
``jurassic_tpu/ops/pallas/turbo_fit.py:76-430``.

Every (gas, pressure x temperature cell, channel) log-uniform eps row is
fitted at build time with a pair of Chebyshev expansions in the
curve-of-growth transform eta = ln(-ln(1 - eps)): forward eps(k) and
inverse k(eps).  The fused EGA pass (``ops/ega_fused.py``) then evaluates
each table corner with two Clenshaw recurrences instead of a row search.
The fit, its validation and the row packing are copied verbatim in
NumPy, so the coefficient planes are byte-identical to the JAX
package's; only the TPU layout is dropped (the 128-lane channel padding,
the channel shards and the 8-row padding of the coefficient axis).

Row layout of the logical table [G, P*T, Q, D] (``Q = J_f + J_i +
N_TURBO_AUX``, ``A = J_f + J_i``):

  rows 0 .. J_f-1         forward Chebyshev coefficients (of eta(x))
  rows J_f .. A-1         inverse Chebyshev coefficients (of k(xi))
  row  A + 0              log2(u0)
  row  A + 1              k_hi (active-range length, float)
  row  A + 2 .. A + 5     eps row[0], row[1], row[k_hi - 1], row[k_hi]
  row  A + 6              1 if the row truly ends at k_hi, 0 if it
                          saturates there
  row  A + 7, A + 8       eta0, eta_hi
  row  A + 9, A + 10      temperature and pressure axis value of the cell
  row  A + 11             validity: 0 no table, 1 good fit, 2 bad fit
  row  A + 12, A + 13     u0, u_hi
  row  A + 14 .. A + 20   precomputed slopes xi_a, xi_b, s_lo_inv,
                          s_hi_inv, s_lo_fwd, s_hi_fwd, ky

``TurboTables.coef`` holds these rows packed for 16-byte loads (see
:func:`pack_rows`): [G, P*T, ceil(Q/4), D, 4], four consecutive rows of
one channel in one ``float4``.  That is the only copy kept;
:meth:`TurboTables.rows` unpacks the logical table from it.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..tables import LOG2_RATIO_U, FastTables

N_TURBO_AUX = 21   # 14 base rows + 7 precomputed-slope rows (A+14..20)
DEG = 8            # Chebyshev degree of the forward and inverse fits
FIT_TOL = 2e-3     # per-row fit and roundtrip error gate
CHORD_TOL = 3e-3   # per-row gate on the gap to the linear-in-u chords
JAX_LANE = 128     # the JAX tables pad each channel shard to this multiple


def pack_rows(rows):
    """Table rows [G, P*T, Q, D] packed for 16-byte loads:
    [G, P*T, ceil(Q/4), D, 4] float32, element [g, c, a, d, b] = row
    4 a + b of channel d.  A thread of the CUDA kernels then reads four
    consecutive rows of its channel in one ``float4`` and a warp 512
    contiguous bytes.  Q is padded to a multiple of 4 with zero rows,
    which no reader takes as data.  NumPy array or torch tensor in, the
    same kind out."""
    G, PT, Q, D = rows.shape
    Q4 = -(-Q // 4)
    if isinstance(rows, torch.Tensor):
        out = rows.new_zeros((G, PT, Q4 * 4, D), dtype=torch.float32)
        out[:, :, :Q] = rows
        return out.view(G, PT, Q4, 4, D).permute(0, 1, 2, 4, 3).contiguous()
    out = np.zeros((G, PT, Q4 * 4, D), np.float32)
    out[:, :, :Q] = rows
    return np.ascontiguousarray(
        out.reshape(G, PT, Q4, 4, D).transpose(0, 1, 2, 4, 3))


def unpack_rows(packed, q: int):
    """The logical rows [..., Q, D] of a table packed by :func:`pack_rows`
    (any leading axes): a copy, without the pad rows."""
    *lead, Q4, D, four = packed.shape
    if four != 4 or not 0 < q <= 4 * Q4:
        raise ValueError(f"packed table of shape {tuple(packed.shape)} does "
                         f"not hold {q} rows")
    n = len(lead)
    if isinstance(packed, torch.Tensor):
        sw = packed.transpose(n + 1, n + 2)
    else:
        sw = np.swapaxes(packed, n + 1, n + 2)
    return sw.reshape(*lead, Q4 * 4, D)[..., :q, :]


class TurboStats(NamedTuple):
    """Build-time validation of the Chebyshev compression: the fit error
    against the smooth emissivity curve (``max_fwd_err``), the inverse
    roundtrip at interval midpoints (``max_inv_err``) and the gap to the
    table kernels' linear-in-u chords (``max_chord_dev``)."""
    rows: int
    max_fwd_err: float
    max_inv_err: float
    max_chord_dev: float = 0.0


class TurboTables(NamedTuple):
    """Turbo tables of the fused EGA pass.

    The array fields are NumPy arrays after the build and torch tensors
    after :meth:`to`."""

    coef: torch.Tensor       # [G, P*T, ceil(Q/4), D, 4] f32 (pack_rows)
    sr: torch.Tensor         # [S, D] f32 source radiance
    chan_mask: torch.Tensor  # [G, D] f32 (np_ >= 2 per channel)
    p_ax: torch.Tensor       # [G, P] f64 channel-uniform pressure axis
    t_ax: torch.Tensor       # [G, P, T] f64 temperature axes
    np_u: torch.Tensor       # [G] int32
    nt_u: torch.Tensor       # [G, P] int32
    deg_f: int = 8
    deg_i: int = 8
    n_bad: int = 0           # rows whose per-row fit failed the gate

    @property
    def q_rows(self) -> int:
        """Q, the rows per (gas, cell) of the logical table."""
        return self.deg_f + 1 + self.deg_i + 1 + N_TURBO_AUX

    def rows(self):
        """The logical table [G, P*T, Q, D], unpacked (a copy)."""
        return unpack_rows(self.coef, self.q_rows)

    def to(self, device) -> "TurboTables":
        def ten(a):
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.from_numpy(np.array(a)).to(device)
        return self._replace(**{f: ten(getattr(self, f)) for f in
                                ("coef", "sr", "chan_mask", "p_ax", "t_ax",
                                 "np_u", "nt_u")})


def _cheb_vander(x: np.ndarray, deg: int) -> np.ndarray:
    """Chebyshev Vandermonde over the last axis: [..., N, deg+1]."""
    V = np.zeros(x.shape + (deg + 1,))
    V[..., 0] = 1.0
    if deg >= 1:
        V[..., 1] = x
    for j in range(2, deg + 1):
        V[..., j] = 2 * x * V[..., j - 1] - V[..., j - 2]
    return V


N_NODES = 64             # shared Chebyshev sample nodes per row


def _cheb_nodes_and_proj(deg: int):
    """Chebyshev points of the first kind x_m (shared by every row) and
    the projection matrix P [M, deg+1] such that coeffs = f(x) @ P (the
    degree-deg truncation of the M-point Chebyshev interpolant)."""
    M = N_NODES
    xm = np.cos(np.pi * (2 * np.arange(M) + 1) / (2 * M))
    V = _cheb_vander(xm, deg)                     # [M, J]
    P = V * (2.0 / M)
    P[:, 0] *= 0.5
    return xm, P


def _interp_rows(xq, xs, ys):
    """Batched monotone linear interpolation: per row b,
    yq[b, m] = interp(xq[b, m]; xs[b, :], ys[b, :]) with end clamping.
    xs must be non-decreasing along the last axis."""
    B, N = xs.shape
    idx = np.sum(xs[:, None, :] <= xq[:, :, None], axis=2) - 1
    idx = np.clip(idx, 0, N - 2)
    x0 = np.take_along_axis(xs, idx, axis=1)
    x1 = np.take_along_axis(xs, idx + 1, axis=1)
    y0 = np.take_along_axis(ys, idx, axis=1)
    y1 = np.take_along_axis(ys, idx + 1, axis=1)
    d = x1 - x0
    f = np.clip((xq - x0) / np.where(d > 0, d, 1.0), 0.0, 1.0)
    return y0 + f * (y1 - y0)


def _chebval(x, c):
    """Clenshaw per row: x [B, N], c [B, J] -> [B, N]."""
    b1 = np.zeros_like(x)
    b2 = np.zeros_like(x)
    x2 = 2 * x
    for j in range(c.shape[-1] - 1, 0, -1):
        b1, b2 = x2 * b1 - b2 + c[:, j:j + 1], b1
    return x * b1 - b2 + c[:, :1]


EPS_FLOOR = 1e-12        # eta transform clamps (see eta())
EPS_CEIL = 1.0 - 1e-9


def eta(e):
    """Curve-of-growth transform eta = ln(-ln(1 - eps))."""
    e = np.clip(e, EPS_FLOOR, EPS_CEIL)
    return np.log(-np.log1p(-e))


def fit_rows(rows: np.ndarray, nk: np.ndarray, deg_f: int, deg_i: int,
             plateau_tol: float = 1e-6, chunk: int = 8192):
    """Fit a batch of log-uniform eps rows in eta space.

    rows: [B, K] float64, nk: [B] valid point counts (>= 2).
    Returns (cf [B, J_f], ci [B, J_i], k_hi [B], ends [B] bool,
    eta0 [B], eta_hi [B], stats, (row_f, row_rt, row_chord)).
    Forward: eta(x) with x = 2 k / k_hi - 1 on the active range
    (k_hi = plateau start); inverse: k(xi) with xi the
    [-1, 1]-normalized eta.
    """
    B, K = rows.shape
    cf = np.zeros((B, deg_f + 1))
    ci = np.zeros((B, deg_i + 1))
    k_hi_all = np.zeros(B, np.int64)
    ends_all = np.zeros(B, bool)
    eta0_all = np.zeros(B)
    eta_hi_all = np.zeros(B)
    row_f_all = np.zeros(B)    # per-row forward fit error
    row_rt_all = np.zeros(B)   # per-row inverse-roundtrip error
    row_chord = np.zeros(B)    # per-row chord deviation
    max_f = 0.0
    max_rt = 0.0
    max_chord = 0.0
    kk = np.arange(K)[None, :]
    xm_f, P_f = _cheb_nodes_and_proj(deg_f)
    xm_i, P_i = _cheb_nodes_and_proj(deg_i)
    for s in range(0, B, chunk):
        sl = slice(s, min(s + chunk, B))
        r = rows[sl]
        n = nk[sl]
        emax_full = np.take_along_axis(r, n[:, None] - 1, axis=1)
        # active range: k_hi = first index reaching the terminal value
        # (within plateau_tol)
        reach = (r >= emax_full - plateau_tol) & (kk < n[:, None])
        k_hi = np.argmax(reach, axis=1)
        k_hi = np.maximum(k_hi, 1)
        ends = k_hi == (n - 1)          # no plateau: row truly ends
        m = (kk <= k_hi[:, None])
        k_hi_f = k_hi.astype(np.float64)[:, None]
        h = eta(r)

        # forward: sample eta at the shared Chebyshev nodes and project
        k_q = (xm_f[None, :] + 1) * 0.5 * k_hi_f        # [B, M]
        k0 = np.clip(k_q.astype(np.int64), 0, K - 2)
        fr = k_q - k0
        h0 = np.take_along_axis(h, k0, axis=1)
        h1 = np.take_along_axis(h, k0 + 1, axis=1)
        c_f = (h0 + fr * (h1 - h0)) @ P_f
        eps_fit = -np.expm1(-np.exp(_chebval(
            np.clip(2 * kk / k_hi_f - 1, -1, 1), c_f)))
        err_f = np.abs(np.where(m, eps_fit - r, 0)).max(axis=1)
        max_f = max(max_f, float(err_f.max(initial=0.0)))

        eta0 = h[:, :1]
        eta_hi = np.take_along_axis(h, k_hi[:, None], axis=1)
        dh = eta_hi - eta0
        flat = (np.take_along_axis(r, k_hi[:, None], axis=1)
                - r[:, :1])[:, 0] < 1e-10
        dh_g = np.where(np.abs(dh) > 1e-300, dh, 1.0)

        # inverse: sample k(eta) at the shared nodes by batched monotone
        # interpolation of the (eta, k) data, then project
        nc = int(min(K, k_hi.max() + 2))
        h_q = eta0 + (xm_i[None, :] + 1) * 0.5 * dh     # [B, M]
        k_at = _interp_rows(h_q, h[:, :nc],
                            (kk[:, :nc] * np.ones((r.shape[0], 1))))
        c_i = k_at @ P_i

        # roundtrip validation at interval midpoints
        em = 0.5 * (r[:, :-1] + r[:, 1:])
        mm = m[:, 1:] & ~flat[:, None]
        hm = eta(em)
        xm = np.clip((2 * hm - (eta0 + eta_hi)) / dh_g, -1, 1)
        km = np.clip(_chebval(xm, c_i), 0, k_hi_f)
        e_rt = -np.expm1(-np.exp(
            _chebval(np.clip(2 * km / k_hi_f - 1, -1, 1), c_f)))
        err_rt = np.abs(np.where(mm, e_rt - em, 0)).max(axis=1)
        max_rt = max(max_rt, float(err_rt.max(initial=0.0)))

        # chord deviation: the curve at k+1/2 vs the table kernels'
        # linear-in-u chord at the u-grid midpoint (see TurboStats)
        kmid = kk[:, :-1] + 0.5
        e_curve = -np.expm1(-np.exp(_chebval(
            np.clip(2 * kmid / k_hi_f - 1, -1, 1), c_f)))
        fmid = np.float64(2.0 ** (0.5 * 1.0 / 6.0) - 1.0) \
            / np.float64(2.0 ** (1.0 / 6.0) - 1.0)
        e_chord = r[:, :-1] + fmid * (r[:, 1:] - r[:, :-1])
        err_ch = np.abs(np.where(mm, e_curve - e_chord, 0)).max(axis=1)
        max_chord = max(max_chord, float(err_ch.max(initial=0.0)))

        cf[sl] = c_f
        ci[sl] = c_i
        k_hi_all[sl] = k_hi
        ends_all[sl] = ends
        eta0_all[sl] = eta0[:, 0]
        eta_hi_all[sl] = eta_hi[:, 0]
        row_f_all[sl] = err_f
        row_rt_all[sl] = err_rt
        row_chord[sl] = err_ch
    return (cf, ci, k_hi_all, ends_all, eta0_all, eta_hi_all,
            TurboStats(B, max_f, max_rt, max_chord),
            (row_f_all, row_rt_all, row_chord))


def pad_small_axes(ft: FastTables) -> FastTables:
    """Pad tiny (stub) tables to P, T >= 2 with invalid rows: a corner
    pair reads rows ipt and ipt + 1 and the (ipr + 1) pressure level
    (``ega_fused.py:148-163``)."""
    G, P, T, K, D = ft.eps.shape
    if P >= 2 and T >= 2:
        return ft
    P2, T2 = max(P, 2), max(T, 2)
    pad5 = ((0, 0), (0, P2 - P), (0, T2 - T), (0, 0), (0, 0))
    return ft._replace(
        eps=np.pad(ft.eps, pad5),
        nu=np.pad(ft.nu, pad5[:3] + pad5[4:]),
        log2_u0=np.pad(ft.log2_u0, pad5[:3] + pad5[4:]),
        valid=np.pad(ft.valid, pad5[:3] + pad5[4:]),
        t=np.pad(ft.t, pad5[:3] + pad5[4:]),
        nt=np.pad(ft.nt, (pad5[0], pad5[1], pad5[4])),
        p=np.pad(ft.p, (pad5[0], pad5[1], pad5[4])))


def uniform_axes(ft: FastTables):
    """Channel-uniform (p, t) axes per gas, or None when ragged across
    channels (over channels that have a table), ``ega_fused.py:166-189``.
    The fused pass brackets the corners once per (ray, segment, gas) for
    all channels, so it needs one axis set per gas."""
    G, P, T, K, D = ft.eps.shape
    p_ax = np.zeros((G, P))
    t_ax = np.zeros((G, P, T))
    np_u = np.zeros(G, np.int32)
    nt_u = np.zeros((G, P), np.int32)
    for g in range(G):
        chans = np.nonzero(ft.np_[g] >= 2)[0]
        if chans.size == 0:
            continue
        d0 = chans[0]
        np_u[g] = ft.np_[g, d0]
        nt_u[g] = ft.nt[g, :, d0]
        p_ax[g] = ft.p[g, :, d0]
        t_ax[g] = ft.t[g, :, :, d0]
        for d in chans[1:]:
            if (ft.np_[g, d] != np_u[g]
                    or not np.array_equal(ft.nt[g, :, d], nt_u[g])
                    or not np.allclose(ft.p[g, :, d], p_ax[g])
                    or not np.allclose(ft.t[g, :, :, d], t_ax[g])):
                return None
    return p_ax, t_ax, np_u, nt_u


def build_turbo_tables(ft: FastTables, device="cpu"):
    """Fit and pack FastTables into :class:`TurboTables` on ``device``.

    Returns (TurboTables | None, TurboStats | None): None when the table
    axes are not channel-uniform.  Rows whose own fit or chord error
    exceeds (FIT_TOL, CHORD_TOL) are marked bad (validity 2.0) and
    counted in ``n_bad``; the stats cover the good rows only."""
    G, P, T, K, D = ft.eps.shape
    ft = pad_small_axes(ft)
    G, P, T, K, D = ft.eps.shape
    ax = uniform_axes(ft)
    if ax is None:
        return None, None
    p_ax, t_ax, np_u, nt_u = ax

    deg_f = deg_i = DEG
    J_f, J_i = deg_f + 1, deg_i + 1
    A = J_f + J_i
    Q = A + N_TURBO_AUX
    PT = P * T

    eps = ft.eps.reshape(G, PT, K, D)
    nu = ft.nu.reshape(G, PT, D)
    valid = ft.valid.reshape(G, PT, D) & (nu >= 2)
    g_i, c_i_, d_i = np.nonzero(valid)
    rows = eps[g_i, c_i_, :, d_i].astype(np.float64)
    nk = nu[g_i, c_i_, d_i].astype(np.int64)
    (cf, ci, k_hi, ends, eta0_v, eta_hi_v, _stats_all,
     (row_f, row_rt, row_chord)) = fit_rows(rows, nk, deg_f, deg_i)
    bad = (np.maximum(row_f, row_rt) > FIT_TOL) | (row_chord > CHORD_TOL)
    good = ~bad
    stats = TurboStats(
        rows.shape[0],
        float(row_f[good].max(initial=0.0)),
        float(row_rt[good].max(initial=0.0)),
        float(row_chord[good].max(initial=0.0)))

    # scatter the per-row results into dense [G, PT, ., D] planes
    def plane(vals, j=None):
        out = np.zeros((G, PT, D))
        out[g_i, c_i_, d_i] = vals if j is None else vals[:, j]
        return out

    br = np.arange(rows.shape[0])
    e0_v = rows[:, 0] if rows.size else np.zeros(0)
    e1_v = rows[:, min(1, K - 1)] if rows.size else np.zeros(0)
    e2nd_v = rows[br, np.maximum(k_hi - 1, 0)]
    emax_v = rows[br, np.minimum(k_hi, K - 1)]

    t3 = ft.t.reshape(G, P, T, D)
    packed = np.zeros((G, PT, Q, D), np.float32)
    for j in range(J_f):
        packed[:, :, j, :] = plane(cf, j)
    for j in range(J_i):
        packed[:, :, J_f + j, :] = plane(ci, j)
    packed[:, :, A + 0, :] = ft.log2_u0.reshape(G, PT, D)
    packed[:, :, A + 1, :] = plane(k_hi.astype(np.float64))
    packed[:, :, A + 2, :] = plane(e0_v)
    packed[:, :, A + 3, :] = plane(e1_v)
    packed[:, :, A + 4, :] = plane(e2nd_v)
    packed[:, :, A + 5, :] = plane(emax_v)
    packed[:, :, A + 6, :] = plane(ends.astype(np.float64))
    packed[:, :, A + 7, :] = plane(eta0_v)
    packed[:, :, A + 8, :] = plane(eta_hi_v)
    packed[:, :, A + 9, :] = t3.reshape(G, PT, D)
    packed[:, :, A + 10, :] = np.repeat(
        ft.p.reshape(G, P, 1, D), T, axis=2).reshape(G, PT, D)
    vplane = valid.astype(np.float32)
    vplane[g_i, c_i_, d_i] += bad.astype(np.float32)
    packed[:, :, A + 11, :] = vplane
    l2u0 = ft.log2_u0.reshape(G, PT, D)
    packed[:, :, A + 12, :] = np.exp2(l2u0)
    packed[:, :, A + 13, :] = np.exp2(
        l2u0 + plane(k_hi.astype(np.float64)) * LOG2_RATIO_U)
    # precomputed corner-evaluation slopes (guards replicated exactly):
    #   xi = clip(eta_t * xi_a + xi_b)
    #   u_c(lo)  = u0 + (t - e0) * s_lo_inv
    #   u_c(hi)  = u_n2 + (t - e2nd) * s_hi_inv
    #   eps(lo)  = e0 + (u - u0) * s_lo_fwd
    #   eps(hi)  = emax + (u - u_n1) * s_hi_fwd      [ends folded in]
    #   y = clip(k_cl * ky - 1)
    dh_v = eta_hi_v - eta0_v
    dh_g = np.where(np.abs(dh_v) > 1e-30, dh_v, 1.0)
    RATIO = 2.0 ** LOG2_RATIO_U
    u0_v = np.exp2(ft.log2_u0.reshape(G, PT, D)[g_i, c_i_, d_i])
    u1_v = u0_v * RATIO
    u_n1_v = u0_v * RATIO ** k_hi.astype(np.float64)
    u_n2_v = u_n1_v / RATIO
    d01_v = e1_v - e0_v
    d01_g = np.where(d01_v == 0, 1.0, d01_v)
    d2_v = emax_v - e2nd_v
    d2_g = np.where(d2_v == 0, 1.0, d2_v)
    packed[:, :, A + 14, :] = plane(2.0 / dh_g)
    packed[:, :, A + 15, :] = plane(-(eta0_v + eta_hi_v) / dh_g)
    packed[:, :, A + 16, :] = plane((u1_v - u0_v) / d01_g)
    packed[:, :, A + 17, :] = plane((u_n1_v - u_n2_v) / d2_g)
    packed[:, :, A + 18, :] = plane(d01_v / (u1_v - u0_v))
    packed[:, :, A + 19, :] = plane(
        d2_v / (u_n1_v - u_n2_v) * ends.astype(np.float64))
    packed[:, :, A + 20, :] = plane(
        2.0 / np.maximum(k_hi.astype(np.float64), 1.0))

    tt = TurboTables(
        coef=pack_rows(packed), sr=np.asarray(ft.sr, np.float32),
        chan_mask=(ft.np_ >= 2).astype(np.float32),
        p_ax=p_ax, t_ax=t_ax, np_u=np_u, nt_u=nt_u,
        deg_f=deg_f, deg_i=deg_i, n_bad=int(bad.sum()))
    return tt.to(device), stats


_CACHE_KEYS = ("coef", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")


def save_turbo_tables(cf, tt: TurboTables, stats: TurboStats) -> None:
    """Write fitted tables to the ``.npz`` file ``cf`` (through a
    temporary name of this process's own, so a reader never sees half a
    file, also where several ranks write the same fit).  The file holds
    the logical rows, whatever layout the kernels read."""
    cf = Path(cf)
    cf.parent.mkdir(parents=True, exist_ok=True)
    tmp = cf.with_suffix(f".{os.getpid()}.tmp.npz")
    host = tt.to("cpu")
    np.savez(tmp, coef=host.rows().numpy(),
             **{k: getattr(host, k).numpy() for k in _CACHE_KEYS[1:]},
             meta=np.asarray([tt.deg_f, tt.deg_i, tt.n_bad]),
             stats=np.asarray(list(stats), np.float64))
    tmp.replace(cf)


def load_turbo_tables(cf, device="cpu"):
    """(TurboTables on ``device``, TurboStats) from a file of
    :func:`save_turbo_tables`."""
    with np.load(cf, allow_pickle=False) as f:
        tt = TurboTables(pack_rows(f["coef"]),
                         *(f[k] for k in _CACHE_KEYS[1:]),
                         *(int(x) for x in f["meta"]))
        stats = TurboStats(int(f["stats"][0]), *map(float, f["stats"][1:]))
    return tt.to(device), stats


def build_turbo_tables_cached(ft: FastTables, cache_dir, device="cpu"):
    """:func:`build_turbo_tables` behind an ``.npz`` cache in
    ``cache_dir``, keyed by a hash of the FastTables content (the fit of
    a benchmark-size table takes about a minute of host time)."""
    h = hashlib.sha256()
    for f in ft._fields:
        a = np.ascontiguousarray(getattr(ft, f))
        h.update(f"{f}{a.dtype}{a.shape}".encode())
        h.update(a.data)
    cf = Path(cache_dir) / f"turbo_{h.hexdigest()[:20]}.npz"
    if cf.exists():
        return load_turbo_tables(cf, device)
    tt, stats = build_turbo_tables(ft, "cpu")
    if tt is None:
        return None, None
    save_turbo_tables(cf, tt, stats)
    return tt.to(device), stats


def slice_turbo_tables(tt: TurboTables, stats: TurboStats, nd: int,
                       d0: int = 0):
    """(tables, stats) of the ``nd`` channels from ``d0`` on of fitted
    tables.  Every row is fitted on its own, so the slice holds the rows a
    fit of the sliced FastTables gives (``tests/test_torch_cli_all.py``
    holds them byte-equal); ``rows`` and ``n_bad`` are counted in the
    slice, the three error maxima stay those of all channels (bounds of
    the slice's, so the acceptance gate decides as before or stricter)."""
    cut = slice(d0, d0 + nd)
    coef = tt.coef[:, :, :, cut].contiguous()
    valid = unpack_rows(coef, tt.q_rows)[:, :, tt.deg_f + tt.deg_i + 2 + 11]
    sl = tt._replace(coef=coef, sr=tt.sr[:, cut].contiguous(),
                     chan_mask=tt.chan_mask[:, cut].contiguous(),
                     n_bad=int((valid > 1.5).sum()))
    return sl, stats._replace(rows=int((valid > 0.5).sum()))


def unshard_lanes(x, n_chan: int, d_true: int, shard: int | None = None):
    """The channels of a JAX lane axis (the last): ``n_chan`` back-to-back
    shards of ``x.shape[-1] / n_chan`` lanes, each holding ``d_true``
    true channels and then padding (``shard_lanes``,
    ``jurassic_tpu/ops/pallas/ega_fused.py:133-146``; at ``n_chan = 1``
    one shard).  Returns all ``n_chan * d_true`` channels in order, or
    shard ``shard``'s ``d_true``."""
    x = np.asarray(x)
    L = x.shape[-1]
    if (n_chan < 1 or L % n_chan or (L // n_chan) % JAX_LANE
            or not 0 <= d_true <= L // n_chan):
        raise ValueError(f"a lane axis of {L} does not hold {n_chan} "
                         f"shards of {d_true} channels, each padded to a "
                         f"multiple of {JAX_LANE} lanes")
    Dp = L // n_chan
    shards = range(n_chan) if shard is None else (shard,)
    if not all(0 <= j < n_chan for j in shards):
        raise ValueError(f"shard {shard} outside [0, {n_chan})")
    return np.ascontiguousarray(np.concatenate(
        [x[..., j * Dp:j * Dp + d_true] for j in shards], axis=-1))


def turbo_tables_from_jax(eps_aug, sr, chan_mask, p_ax, t_ax, np_u, nt_u,
                          *, d_true: int, deg_f: int, deg_i: int,
                          n_bad: int = 0, n_chan: int = 1,
                          shard: int | None = None,
                          device="cpu") -> TurboTables:
    """The port's container from the fields of a JAX turbo
    ``PallasTables`` given as NumPy arrays: strips the 128-lane channel
    padding of each of the ``n_chan`` channel shards (``d_true`` true
    channels each, :func:`unshard_lanes`) and the 8-row padding of the
    coefficient axis.  This carries tables fitted by the JAX package
    across to the port unchanged: all ``n_chan * d_true`` channels, or
    the channel range of shard ``shard`` (one rank's tables of a
    channel-sharded model; ``n_bad`` is then counted in the range)."""
    Q = deg_f + 1 + deg_i + 1 + N_TURBO_AUX
    coef = np.asarray(eps_aug, np.float32)
    if coef.ndim != 4 or coef.shape[2] < Q:
        raise ValueError(f"eps_aug shape {coef.shape} does not hold "
                         f"{Q} rows")
    lanes = lambda a: unshard_lanes(a, n_chan, int(d_true), shard)
    rows = lanes(coef[:, :, :Q, :])
    if shard is not None:
        n_bad = int((rows[:, :, deg_f + deg_i + 2 + 11] > 1.5).sum())
    tt = TurboTables(
        coef=pack_rows(rows), sr=lanes(np.asarray(sr, np.float32)),
        chan_mask=lanes(np.asarray(chan_mask, np.float32)),
        p_ax=np.asarray(p_ax, np.float64), t_ax=np.asarray(t_ax, np.float64),
        np_u=np.asarray(np_u, np.int32), nt_u=np.asarray(nt_u, np.int32),
        deg_f=int(deg_f), deg_i=int(deg_i), n_bad=int(n_bad))
    return tt.to(device)
