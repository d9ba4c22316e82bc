"""Fused EGA radiative-transfer pass (port of
``jurassic_tpu/ops/pallas/ega_fused.py``), on turbo tables and on the
exact log-uniform tables.

For every (ray, channel) the pass walks the ray's LOS segments and
fuses the continuum optical depth (continua_core, jr_common.h:397-409),
the per-gas EGA transmittance update at the four bracketing (p, T)
table corners, the Planck source (``_source_rows``, :844-856) and the
radiative-transfer recursion (new_obs_core, jr_common.h:294-300).  The
corner is evaluated one of two ways:

* turbo: two Clenshaw recurrences on Chebyshev-compressed rows
  (``_eta_of``/``_turbo_corner``, ega_fused.py:763-841), with a taint
  map of the lanes that consumed a bad-fit row when the tables have any;
* table: the exact row search on the log-uniform emissivity curve
  (``row_lookup``, ega_fused.py:980-1002).

Each has two implementations of one function:

* :func:`rt_fused_turbo_ref` / :func:`rt_fused_table_ref` -- the plain
  PyTorch versions, vectorised over [rays, gases, corners, channels]
  with a Python loop over the LOS segments, sharing everything but the
  corner routine.  They run on any device and are what CPU tensors get.
* the CUDA kernels ``csrc/ega_fused_turbo.cu`` and
  ``csrc/ega_fused_table.cu`` (shared code in ``csrc/ega_common.cuh``)
  -- a few adjacent rays per block, one thread per (ray, channel), the
  per-gas ``tau_path`` in registers, corner bracketing and table-row
  reads (16-byte loads of the packed layout) inside the kernel.

:func:`rt_fused_turbo` and :func:`rt_fused_table` dispatch on the device
of their tensors: the plain version for CPU tensors, the kernel for CUDA
tensors (or an error; nothing falls back).  ``LAUNCHES`` and
``LAUNCHES_TABLE`` count kernel launches.

The TPU feeding machinery of the JAX kernels (tangent-sorted 8-ray
groups, 128-lane padding, the group/pool schedules, slabs, the pool
gather and its capacity flag) is not ported: each CUDA block gathers its
own rows.  Outputs are in input ray order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import NA, P0, TAU_OPAQUE
from ..geometry import LosData
from ..tables import LOG2_RATIO_U
from .table_pack import BIG, N_AUG, TableTables
from .turbo_fit import N_TURBO_AUX, TurboTables, unpack_rows

N_SEG = 8           # fixed per-segment stream fields (see pack_segments)
N_CC = 12           # packed continuum coefficient rows
KERNEL_DEG = 8      # Chebyshev degree the turbo kernel is compiled for
KERNEL_MAX_GASES = 32

LAUNCHES = 0        # launches of the turbo CUDA kernel (rt_fused_turbo)
LAUNCHES_TABLE = 0  # launches of the table CUDA kernel (rt_fused_table)
# None, or a list to which every launch appends (entry point, start, end):
# CUDA events recorded around it on its stream.  torch.profiler records
# none of these ctypes launches; the events give their device time.
LAUNCH_EVENTS: list | None = None


def pack_continua(cc, window, nd: int, nw: int = 0,
                  device="cpu") -> torch.Tensor:
    """Continuum coefficients as [N_CC + W, D] f32 rows with the band
    masks pre-applied (continua_ctm*, jr_common.h:316-390), followed by
    the window one-hot rows of the gray-extinction channel map
    (``ega_fused.py:250-280`` without the lane padding).  ``nw`` is the
    declared window count: one row per declared window."""
    m = np.zeros((N_CC, max(nd, 1)))
    z = lambda a: np.asarray(a, np.float64)
    m[0, :nd] = np.where(cc.co2_mask, z(cc.co2_cw296), 0)
    m[1, :nd] = np.where(cc.co2_mask, z(cc.co2_cw260), 0)
    m[2, :nd] = np.where(cc.co2_mask, z(cc.co2_cw230), 0)
    m[3, :nd] = np.where(cc.h2o_mask, z(cc.h2o_cw296), 0)
    m[4, :nd] = np.where(cc.h2o_mask, z(cc.h2o_cw260), 0)
    m[5, :nd] = np.where(cc.h2o_mask, z(cc.h2o_ctwfrn), 0)
    m[6, :nd] = np.where(cc.h2o_mask, z(cc.h2o_sfac), 0)
    m[7, :nd] = np.where(cc.h2o_mask, z(cc.h2o_nu), 0)
    m[8, :nd] = np.where(cc.n2_mask, z(cc.n2_b), 0)
    m[9, :nd] = np.where(cc.n2_mask, z(cc.n2_beta), 0)
    m[10, :nd] = np.where(cc.o2_mask, z(cc.o2_b), 0)
    m[11, :nd] = np.where(cc.o2_mask, z(cc.o2_beta), 0)
    W = max(int(np.max(window)) + 1 if len(window) else 1, nw, 1)
    oh = np.zeros((W, max(nd, 1)))
    oh[np.asarray(window, int), np.arange(nd)] = 1.0
    rows = np.concatenate([m, oh], 0).astype(np.float32)
    return torch.as_tensor(rows).to(device)


def pack_segments(los: LosData, ig_co2: int, ig_h2o: int) -> torch.Tensor:
    """Per-(ray, segment) stream [R, S, F] f32 (``ega_fused.py:687-708``):

      0 valid, 1 p, 2 t, 3 ds, 4 q_h2o, 5 u_co2, 6 u_h2o, 7 pad,
      8 .. 8+W-1       gray extinction k per window,
      8+W .. 8+W+G-1   column density u per gas."""
    R, S = los.ds.shape
    f32 = torch.float32
    z = torch.zeros((R, S), dtype=f32, device=los.ds.device)
    cols = [los.valid.to(f32), los.p.to(f32), los.t.to(f32),
            los.ds.to(f32),
            los.q[:, :, ig_h2o].to(f32) if ig_h2o >= 0 else z,
            los.u[:, :, ig_co2].to(f32) if ig_co2 >= 0 else z,
            los.u[:, :, ig_h2o].to(f32) if ig_h2o >= 0 else z,
            z]
    return torch.cat([torch.stack(cols, dim=-1), los.k.to(f32),
                      los.u.to(f32)], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# Corner bracketing (channel-independent)

def _count_leq(values, counts, x):
    """#{values <= x within count} - 1, clipped to [0, count-2]
    (locate_id, jr_common.h:107-115); values on the last axis."""
    iota = torch.arange(values.shape[-1], device=values.device)
    below = (values <= x.unsqueeze(-1)) & (iota < counts.unsqueeze(-1))
    idx = below.sum(-1) - 1
    return torch.minimum(idx.clamp_min(0), (counts - 2).clamp_min(0))


def corner_indices(p_ax, t_ax, np_u, nt_u, p, t):
    """Corner-pair start rows (ipt00, ipt10) into the flat [P*T] cell
    axis per (ray, segment, gas): [R, S, G, 2] int64
    (``_corner_indices``, ega_fused.py:296-324).  Brackets in the dtype
    of ``p``/``t``: the axes are cast to it, as JAX casts them to the
    LOS dtype."""
    G, P, T = t_ax.shape
    dt = p.dtype
    p_ax, t_ax = p_ax.to(dt), t_ax.to(dt)
    np_u, nt_u = np_u.long(), nt_u.long()
    R, S = p.shape
    ipr = _count_leq(p_ax.expand(R, S, G, P), np_u.expand(R, S, G),
                     p.unsqueeze(-1).expand(R, S, G))           # [R, S, G]
    gi = torch.arange(G, device=p.device)
    tg = t.unsqueeze(-1).expand(R, S, G)
    it0 = _count_leq(t_ax[gi, ipr], nt_u[gi, ipr], tg)
    it1 = _count_leq(t_ax[gi, ipr + 1], nt_u[gi, ipr + 1], tg)
    return torch.stack([ipr * T + it0, (ipr + 1) * T + it1], dim=-1)


# ---------------------------------------------------------------------------
# Physics of one segment (shared expressions of the JAX kernel, in f32)

def _lipg(x0, y0, x1, y1, x):
    """lip with guarded denominator (jr_common.h:48-50)."""
    d = x1 - x0
    d = torch.where(d == 0, 1.0, d)
    return y0 + (x - x0) * (y1 - y0) / d


def _c01(x):
    return torch.clamp(x, 0.0, 1.0)


LANE_PAD = 64       # elements: two of the widest CPU vectors of float64


def _lanes(fn, *args):
    """``fn(*args)`` elementwise, each element on PyTorch's vector path.
    On the CPU a transcendental rounds its vector body and its scalar
    tail differently in the last bit, so without this an element's bits
    would depend on where its batch ends: a ray split or a package
    boundary would move the last bit of a ray's radiance.  The inputs
    are broadcast, flattened and padded to a multiple of ``LANE_PAD``;
    on a card the call is ``fn(*args)``."""
    if args[0].device.type != "cpu":
        return fn(*args)
    xs = torch.broadcast_tensors(*args)
    shape, n = xs[0].shape, xs[0].numel()
    pad = -n % LANE_PAD
    flat = [torch.nn.functional.pad(x.reshape(-1), (0, pad)) for x in xs]
    return fn(*flat)[:n].reshape(shape)


def _continua_bds(p_s, t_s, ds_s, q_h2o, u_co2, u_h2o, kw, cc, flags):
    """Continuum optical depth of one segment (``_continua_bds``,
    ega_fused.py:725-760): gray extinction ``kw`` plus the enabled
    continua.  cc rows are [D]; the segment scalars broadcast."""
    f_co2, f_h2o, f_n2, f_o2 = flags
    bds = kw * ds_s
    if f_co2:
        dt230, dt260, dt296 = t_s - 230.0, t_s - 260.0, t_s - 296.0
        ctw = (dt260 * 5.050505e-4 * dt296 * cc[2]
               - dt230 * 9.259259e-4 * dt296 * cc[1]
               + dt230 * 4.208754e-4 * dt260 * cc[0])
        bds = bds + u_co2 * p_s * ctw / float(np.float32(NA * 1000.0 * P0))
    if f_h2o:
        cw296, cw260 = cc[3], cc[4]
        base = torch.where(cw296 > 0, cw260
                           / torch.where(cw296 > 0, cw296, 1.0), 1.0)
        ctwslf = cc[6] * cw296 * _lanes(torch.pow, base,
                                        (296.0 - t_s) / 36.0)
        a1 = cc[7] * u_h2o * _lanes(torch.tanh, 0.7193876 / t_s * cc[7])
        a3 = p_s / float(np.float32(P0)) * (q_h2o * ctwslf
                                            + (1 - q_h2o) * cc[5]) \
            * float(np.float32(1e-20))
        bds = bds + a1 * (296.0 / t_s) * a3
    if f_n2 or f_o2:
        pr, tr = p_s / float(np.float32(P0)), 273.0 / t_s
        pp2 = (pr * pr) * (tr * tr)
        tfac = 1.0 / 296.0 - 1.0 / t_s
        if f_n2:
            mix = 0.79 + 0.21 * (1.294 - 0.4545 * t_s / 296.0)
            bds = bds + ds_s * (0.1 * pp2 * _lanes(torch.exp, cc[9] * tfac)
                                * 0.79 * cc[8] * mix)
        if f_o2:
            bds = bds + ds_s * (0.1 * pp2 * _lanes(torch.exp, cc[11] * tfac)
                                * 0.21 * cc[10])
    return bds


def _eta_of(target):
    """Curve-of-growth transform of the inversion target
    (``_eta_of``, ega_fused.py:763-772): the plain log forms with the
    same clips, not log1p."""
    t_c = torch.clamp(target, 1e-12, 1.0 - 1e-7)
    return _lanes(torch.log, torch.clamp(
        -_lanes(torch.log, torch.clamp(1.0 - t_c, min=1e-37)), min=1e-37))


def _turbo_corner(get_row, J_f, J_i, target, eta_t, u_seg):
    """One (p,T) corner: eps->u inversion + eps(u + u_seg) re-lookup
    through the eta-space Chebyshev pair, with the out-of-range linear
    extensions and guards in the order of ``_turbo_corner``
    (ega_fused.py:775-841).  ``get_row(off)`` returns coefficient row
    ``off`` of the corner."""
    R6 = float(np.float32(LOG2_RATIO_U))
    AUX = J_f + J_i

    def cheb(off, J, x):
        x2 = 2.0 * x
        b1 = torch.zeros_like(x)
        b2 = torch.zeros_like(x)
        for j in range(J - 1, 0, -1):
            b1, b2 = x2 * b1 - b2 + get_row(off + j), b1
        return x * b1 - b2 + get_row(off)

    l2u0 = get_row(AUX + 0)
    k_hi = get_row(AUX + 1)
    e0 = get_row(AUX + 2)
    e2nd = get_row(AUX + 4)
    emax = get_row(AUX + 5)
    ends = get_row(AUX + 6)
    u0 = get_row(AUX + 12)
    u_n1 = get_row(AUX + 13)
    xi_a = get_row(AUX + 14)
    xi_b = get_row(AUX + 15)
    s_lo_inv = get_row(AUX + 16)
    s_hi_inv = get_row(AUX + 17)
    s_lo_fwd = get_row(AUX + 18)
    s_hi_fwd = get_row(AUX + 19)
    ky = get_row(AUX + 20)
    u_n2 = u_n1 * float(np.float32(2.0 ** -LOG2_RATIO_U))
    xi = torch.clamp(eta_t * xi_a + xi_b, -1.0, 1.0)
    k_c = torch.minimum(torch.clamp(cheb(J_f, J_i, xi), min=0.0), k_hi)
    u_c = _lanes(torch.exp2, l2u0 + k_c * R6)
    u_c = torch.where(target < e0, u0 + (target - e0) * s_lo_inv, u_c)
    hi_u = u_n2 + (target - e2nd) * s_hi_inv
    u_c = torch.where((target > emax) & (ends > 0), hi_u, u_c)
    u_new = u_c + u_seg
    k_new = (_lanes(torch.log2, torch.clamp(u_new, min=1e-37)) - l2u0) / R6
    k_cl = torch.minimum(torch.clamp(k_new, min=0.0), k_hi)
    y = torch.clamp(k_cl * ky - 1.0, -1.0, 1.0)
    eps = 1.0 - _lanes(torch.exp, -_lanes(torch.exp, cheb(0, J_f, y)))
    eps = torch.where(k_new < 0.0, e0 + (u_new - u0) * s_lo_fwd, eps)
    eps = torch.where(k_new > k_hi, emax + (u_new - u_n1) * s_hi_fwd, eps)
    eps = torch.where(torch.abs(emax - e0) > 1e-10, eps, e0)
    return _c01(eps)


def _source_rows(sr, t):
    """Source radiance [R, D] at segment temperatures t [R] from the
    0.25 K table: index (int)(4 T) - 400 (locate_st, jr_common.h:83-84)
    and node temperature 100 + 0.25 it (``_source_rows``,
    ega_fused.py:844-856)."""
    n_src = sr.shape[0]
    it = ((4.0 * t).to(torch.int32) - 400).clamp(0, n_src - 2)
    st0 = 100.0 + 0.25 * it.to(torch.float32)
    it = it.long()
    sr0 = sr[it]
    return sr0 + (t - st0).unsqueeze(1) * (sr[it + 1] - sr0) * 4.0


# ---------------------------------------------------------------------------
# The plain PyTorch versions

REF_BLOCK_BYTES = 256 << 20   # gathered corner rows per ray chunk


def _row_lookup(row, l2u0, nk2, target, u_seg):
    """One (p,T) corner of the exact tables (``row_lookup``,
    ega_fused.py:980-1002), written out literally: the count and the
    masked max/min of the TPU kernel, not an index.  row [..., K, D] (K
    on the second-to-last axis), the rest [..., D]."""
    R6 = float(np.float32(LOG2_RATIO_U))
    RATIO = float(np.float32(2.0 ** LOG2_RATIO_U))
    K = row.shape[-2]
    iota = torch.arange(K, device=row.device).view(K, 1)

    def bracket(i):
        m = iota <= i.unsqueeze(-2)
        lo = torch.where(m, row, -BIG).amax(dim=-2)
        hi = torch.where(m, BIG, row).amin(dim=-2)
        return lo, hi

    cnt = (row <= target.unsqueeze(-2)).sum(dim=-2)
    i = torch.minimum((cnt - 1).clamp_min(0), nk2)
    e0, e1 = bracket(i)
    u0 = _lanes(torch.exp2, l2u0 + i.to(torch.float32) * R6)
    u_c = _lipg(e0, u0, e1, u0 * RATIO, target)
    u_new = u_c + u_seg
    kf = (_lanes(torch.log2, torch.clamp(u_new, min=1e-37)) - l2u0) / R6
    kf = torch.clamp(kf, 0.0, float(K))
    ki = torch.minimum(kf.to(torch.int64), nk2)
    e_lo, e_hi = bracket(ki)
    u_lo = _lanes(torch.exp2, l2u0 + ki.to(torch.float32) * R6)
    return _c01(_lipg(u_lo, e_lo, u_lo * RATIO, e_hi, u_new))


def _rt_fused_ref(packed, n_rows, rows_tpv, corner, axes, sr, chan_mask,
                  cc_rows, los: LosData, flags, ig_co2: int, ig_h2o: int,
                  want_taint: bool):
    """The segment loop both plain versions share: continua, the four
    corners of every gas through ``corner(blk, target, u_seg)`` (blk
    [R, G, 4, Q, D] the gathered table rows -> eps [R, G, 4, D]),
    bilinear in T then p, the opacity cut, the source and the rad/tau
    recursion.  ``packed`` is the table as the kernels read it
    ([G, P*T, ceil(Q/4), D, 4], ``turbo_fit.pack_rows``) with ``n_rows``
    = Q logical rows: only the gathered corners of a segment are unpacked,
    no second copy of the table is made.  ``rows_tpv`` are the row offsets
    of (temperature, pressure, validity), ``axes`` the channel-uniform
    (p_ax, t_ax, np_u, nt_u).  Rays run in chunks so that the gathered
    rows stay near REF_BLOCK_BYTES.  Returns (rad, tau, taint | None)."""
    seg = pack_segments(los, ig_co2, ig_h2o)
    idx = corner_indices(*axes, los.p, los.t)
    G, PT, Q4, D, _ = packed.shape
    Q = n_rows
    R, S, F = seg.shape
    W = F - N_SEG - G
    dev = seg.device
    ROW_T, ROW_P, ROW_VALID = rows_tpv
    flat = packed.reshape(G * PT, Q4, D, 4)
    sr = sr.to(torch.float32)
    goff = (torch.arange(G, device=dev) * PT).view(1, G, 1)
    corner_off = torch.tensor([0, 1, 0, 1], device=dev)
    pair_sel = torch.tensor([0, 0, 1, 1], device=dev)
    f32 = torch.float32

    rad_out = torch.zeros((R, D), dtype=f32, device=dev)
    tau_out = torch.ones((R, D), dtype=f32, device=dev)
    taint_out = torch.zeros((R, D), dtype=torch.bool, device=dev)
    chunk = max(1, REF_BLOCK_BYTES // max(G * 4 * Q * D * 4, 1))
    for r0 in range(0, R, chunk):
        sl = slice(r0, min(r0 + chunk, R))
        seg_c, idx_c = seg[sl], idx[sl]
        Rc = seg_c.shape[0]
        rad = torch.zeros((Rc, D), dtype=f32, device=dev)
        tau = torch.ones((Rc, D), dtype=f32, device=dev)
        taint = torch.zeros((Rc, D), dtype=torch.bool, device=dev)
        tau_path = torch.ones((Rc, G, D), dtype=f32, device=dev)
        n_steps = int(los.np_[sl].max().clamp(0, S))
        for s in range(n_steps):
            f = seg_c[:, s, :]
            valid_s = f[:, 0:1] > 0.0                          # [R, 1]
            p_s, t_s, ds_s = f[:, 1:2], f[:, 2:3], f[:, 3:4]
            q_h2o, u_co2, u_h2o = f[:, 4:5], f[:, 5:6], f[:, 6:7]

            kw = torch.zeros((Rc, D), dtype=f32, device=dev)
            for w in range(W):
                kw = kw + f[:, N_SEG + w:N_SEG + w + 1] * cc_rows[N_CC + w]
            bds = _continua_bds(p_s, t_s, ds_s, q_h2o, u_co2, u_h2o, kw,
                                cc_rows, flags)

            # EGA, all gases at once: rows [R, G, 4] of the four corners
            tp = tau_path
            target = 1.0 - tp                                  # [R, G, D]
            u_seg = f[:, N_SEG + W:N_SEG + W + G].unsqueeze(-1)
            sel = idx_c[:, s][:, :, pair_sel] + corner_off + goff
            blk = unpack_rows(flat[sel], Q)                # [R, G, 4, Q, D]
            eps4 = corner(blk, target, u_seg)              # [R, G, 4, D]
            vld = blk[:, :, :, ROW_VALID, :]
            okl = chan_mask * vld[:, :, 0] * vld[:, :, 1] * vld[:, :, 2] \
                * vld[:, :, 3]
            t4 = blk[:, :, :, ROW_T, :]
            p0, p1 = blk[:, :, 0, ROW_P, :], blk[:, :, 2, ROW_P, :]
            t_s3, p_s3 = t_s.unsqueeze(1), p_s.unsqueeze(1)
            eps_p0 = _c01(_lipg(t4[:, :, 0], eps4[:, :, 0], t4[:, :, 1],
                                eps4[:, :, 1], t_s3))
            eps_p1 = _c01(_lipg(t4[:, :, 2], eps4[:, :, 2], t4[:, :, 3],
                                eps4[:, :, 3], t_s3))
            eps_t = _c01(_lipg(p0, eps_p0, p1, eps_p1, p_s3))
            opaque = tp < TAU_OPAQUE
            factor = (1.0 - eps_t) / torch.where(opaque, 1.0, tp)
            factor = torch.where(okl > 0, factor, 1.0)
            factor = torch.where(opaque, 0.0, factor)
            tau_gas = factor[:, 0]
            for g in range(1, G):
                tau_gas = tau_gas * factor[:, g]
            tau_path = torch.where(valid_s.unsqueeze(1), tp * factor, tp)
            if want_taint:
                # a bad-fit row (validity 2) at any of the four corners,
                # on an active and not yet opaque segment (the pool
                # kernel's ``hit``, ega_fused.py:1305-1310, 1375-1379)
                hit = valid_s.unsqueeze(1) & ~opaque \
                    & (vld.amax(dim=2) > 1.5)
                taint = taint | hit.any(dim=1)

            src = _source_rows(sr, f[:, 2])
            eps_tot = 1.0 - tau_gas * _lanes(torch.exp, -bds)
            upd = valid_s & (tau_gas > 0.0)
            rad = torch.where(upd, rad + src * eps_tot * tau, rad)
            tau = torch.where(upd, tau * (1.0 - eps_tot), tau)
        rad_out[sl], tau_out[sl], taint_out[sl] = rad, tau, taint
    return rad_out, tau_out, (taint_out if want_taint else None)


def _axes(tables):
    return tables.p_ax, tables.t_ax, tables.np_u, tables.nt_u


def rt_fused_turbo_ref(tables: TurboTables, cc_rows, los: LosData, flags,
                       ig_co2: int, ig_h2o: int):
    """(rad, tau, taint) of the fused turbo EGA pass, in plain PyTorch on
    the device of ``los``: rad, tau [R, D] f32; taint [R, D] bool marks
    the lanes that consumed a bad-fit row, None when the tables have
    none (``n_bad == 0``).

    Vectorised over [rays, gases, corners, channels]; the LOS segments
    run in a Python loop.  A ray's segments beyond its ``np_`` are
    masked no-ops (their ``valid`` is 0), as in the kernel."""
    J_f, J_i = tables.deg_f + 1, tables.deg_i + 1
    AUX = J_f + J_i

    def corner(blk, target, u_seg):
        return _turbo_corner(lambda off: blk[:, :, :, off, :], J_f, J_i,
                             target.unsqueeze(2),
                             _eta_of(target).unsqueeze(2),
                             u_seg.unsqueeze(2))
    return _rt_fused_ref(tables.coef, tables.q_rows,
                         (AUX + 9, AUX + 10, AUX + 11), corner,
                         _axes(tables), tables.sr, tables.chan_mask, cc_rows,
                         los, flags, ig_co2, ig_h2o, tables.n_bad > 0)


def rt_fused_table_ref(tables: TableTables, cc_rows, los: LosData, flags,
                       ig_co2: int, ig_h2o: int):
    """(rad, tau) [R, D] f32 of the fused table-mode EGA pass, in plain
    PyTorch on the device of ``los``: the loop of
    :func:`rt_fused_turbo_ref` with the exact row lookup at each
    corner."""
    K = tables.k_rows

    def corner(blk, target, u_seg):
        return _row_lookup(blk[:, :, :, :K, :], blk[:, :, :, K, :],
                           blk[:, :, :, K + 4, :].to(torch.int64),
                           target.unsqueeze(2), u_seg.unsqueeze(2))
    rad, tau, _ = _rt_fused_ref(
        tables.eps_aug, K + N_AUG, (K + 1, K + 2, K + 3), corner,
        _axes(tables),
        tables.sr, tables.chan_mask, cc_rows, los, flags, ig_co2, ig_h2o,
        False)
    return rad, tau


# ---------------------------------------------------------------------------
# The dispatching wrappers and the CUDA launches

def _on_cuda(name: str, los: LosData) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors
    (kernel); anything else is an error."""
    dev = los.p.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def rt_fused_turbo(tables: TurboTables, cc_rows, los: LosData, flags,
                   ig_co2: int, ig_h2o: int):
    """(rad, tau, taint) of the fused turbo EGA pass; taint is None when
    the tables have no bad-fit rows.

    CPU tensors go through :func:`rt_fused_turbo_ref`; CUDA tensors
    launch the hand-written kernel (``csrc/ega_fused_turbo.cu``) or
    raise."""
    global LAUNCHES
    if not _on_cuda("rt_fused_turbo", los):
        return rt_fused_turbo_ref(tables, cc_rows, los, flags, ig_co2,
                                  ig_h2o)
    if tables.deg_f != KERNEL_DEG or tables.deg_i != KERNEL_DEG:
        raise ValueError(f"the CUDA kernel is compiled for Chebyshev degree "
                         f"{KERNEL_DEG}, got ({tables.deg_f}, "
                         f"{tables.deg_i})")
    rad, tau, taint, launched = _launch(
        "jt_ega_fused_turbo", tables.coef, tables.q_rows, tables, cc_rows,
        los, flags, ig_co2, ig_h2o, tables.n_bad > 0,
        (tables.q_rows, tables.deg_f, tables.deg_i))
    LAUNCHES += launched
    return rad, tau, (None if taint is None else taint > 0.5)


def rt_fused_table(tables: TableTables, cc_rows, los: LosData, flags,
                   ig_co2: int, ig_h2o: int):
    """(rad, tau) [R, D] f32 of the fused table-mode EGA pass.

    CPU tensors go through :func:`rt_fused_table_ref`; CUDA tensors
    launch the hand-written kernel (``csrc/ega_fused_table.cu``) or
    raise.  The kernel searches each emissivity row from the index the
    last segment found (``table_pack.hinted_count``) when
    ``tables.monotone`` (every row non-decreasing, checked at the table
    build) and otherwise scans it with the literal count/max/min of the
    plain version."""
    global LAUNCHES_TABLE
    if not _on_cuda("rt_fused_table", los):
        return rt_fused_table_ref(tables, cc_rows, los, flags, ig_co2,
                                  ig_h2o)
    K = tables.k_rows
    rad, tau, _, launched = _launch(
        "jt_ega_fused_table", tables.eps_aug, K + N_AUG, tables, cc_rows,
        los, flags, ig_co2, ig_h2o, False, (K, int(tables.monotone)))
    LAUNCHES_TABLE += launched
    return rad, tau


def _check(name, x, dtype, shape, dev):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(entry: str, packed, n_rows: int, tables, cc_rows, los: LosData,
            flags, ig_co2: int, ig_h2o: int, want_taint: bool, extra: tuple):
    """Check the tensors, allocate the outputs and launch C entry point
    ``entry`` (``csrc/ega_common.cuh`` has the argument order) on the
    current stream.  ``packed`` is the kernel's table
    [G, P*T, ceil(Q/4), D, 4] with ``n_rows`` = Q logical rows, ``extra``
    the entry point's own integer arguments.  Returns (rad, tau, taint
    f32 | None, launches made: 0 for an empty batch, else 1)."""
    import ctypes

    from ._build import load_library

    dev = los.p.device
    if los.p.dtype != torch.float32 or los.t.dtype != torch.float32:
        raise ValueError("the CUDA kernels bracket table corners in "
                         "float32: trace the LOS in float32 on the card")
    if packed.dim() != 5 or packed.shape[4] != 4 \
            or packed.shape[2] != -(-n_rows // 4):
        raise ValueError(f"table has shape {tuple(packed.shape)}, expected "
                         f"[G, P*T, {-(-n_rows // 4)}, D, 4]")
    G, PT, Q4, D, _ = packed.shape
    if packed.numel() >= 2 ** 31:
        raise ValueError("the CUDA kernels index the table in 32 bits: "
                         f"{packed.numel()} elements are too many")
    if not 1 <= G <= KERNEL_MAX_GASES:
        raise ValueError(f"the CUDA kernels take 1..{KERNEL_MAX_GASES} "
                         f"gases, got {G}")
    P, T = tables.t_ax.shape[1:]
    if P < 2 or T < 2 or P * T != PT:
        raise ValueError(f"table axes (P={P}, T={T}) do not match "
                         f"{PT} cells")
    seg = pack_segments(los, ig_co2, ig_h2o)
    R, S, F = seg.shape
    W = F - N_SEG - G
    n_src = tables.sr.shape[0]
    if W < 0 or n_src < 2:
        raise ValueError("segment stream or source table malformed")
    np_ = los.np_.to(torch.int32).contiguous()
    p_ax = tables.p_ax.to(dev, torch.float32).contiguous()
    t_ax = tables.t_ax.to(dev, torch.float32).contiguous()
    np_u = tables.np_u.to(dev, torch.int32).contiguous()
    nt_u = tables.nt_u.to(dev, torch.int32).contiguous()
    args = (("table rows", packed, torch.float32, (G, PT, Q4, D, 4)),
            ("sr", tables.sr, torch.float32, (n_src, D)),
            ("chan_mask", tables.chan_mask, torch.float32, (G, D)),
            ("cc_rows", cc_rows, torch.float32, (N_CC + W, D)),
            ("np_", np_, torch.int32, (R,)),
            ("p_ax", p_ax, torch.float32, (G, P)),
            ("t_ax", t_ax, torch.float32, (G, P, T)),
            ("np_u", np_u, torch.int32, (G,)),
            ("nt_u", nt_u, torch.int32, (G, P)))
    for name, x, dtype, shape in args:
        _check(name, x, dtype, shape, dev)
    rad = torch.empty((R, D), dtype=torch.float32, device=dev)
    tau = torch.empty((R, D), dtype=torch.float32, device=dev)
    taint = torch.empty((R, D), dtype=torch.float32, device=dev) \
        if want_taint else None
    if R == 0 or D == 0:
        return rad, tau, taint, 0
    bits = sum(int(bool(f)) << i for i, f in enumerate(flags))
    lib = load_library()
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    events = LAUNCH_EVENTS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        rc = getattr(lib, entry)(
            ptr(seg), ptr(np_), ptr(packed), ptr(tables.sr),
            ptr(tables.chan_mask), ptr(cc_rows), ptr(p_ax), ptr(t_ax),
            ptr(np_u), ptr(nt_u), ptr(rad), ptr(tau), ptr(taint),
            R, S, F, W, G, P, T, D, n_src, bits, *extra,
            ctypes.c_void_p(stream.cuda_stream))
        if events is not None:
            ev[1].record(stream)
            events.append((entry, *ev))
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed (cudaError {rc})")
    return rad, tau, taint, 1
