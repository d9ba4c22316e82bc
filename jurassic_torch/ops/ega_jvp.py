"""The RT pass's tangent kernels on the fast tables
(``csrc/ega_jvp_fast.cu``): the RT half of the JAX package's compiled
forward-mode Jacobian (``jax.jit(jax.jacfwd(fwd))``,
``jurassic_tpu/retrieval.py:281``, through ``rt_integrate``,
``jurassic_tpu/forward.py:99-213``, and ``ega_eps_fast``,
``jurassic_tpu/ops/ega.py:171``).

For every (ray, channel) it runs ``forward.rt_integrate(...,
use_fast=True)`` with the surface and brightness epilogue and computes
the tangent of the result in the directions of the LOS tangents of the
tracer's tangent kernel, which its plain version ``forward.
rt_integrate_jvp_ref`` carries forward segment by segment.  The map from
the LOS tangents to drad is linear, with every coefficient a local
partial of one (segment, channel); the kernels take it as an adjoint and
a product (:func:`rt_jvp_adjoint_ref` states that algebra in plain
PyTorch, for the tests):

* the record kernel runs the primal with its local partials, a record per
  valid (segment, channel), then sweeps back over the records turning
  each into A, the radiance's sensitivity to the segment's LOS fields
  (:func:`rt_jvp_records_cuda`; plain statement
  :func:`rt_jvp_records_ref`);
* the contraction kernel multiplies each ray's A with its LOS tangents
  (:func:`rt_jvp_contract_cuda`; :func:`rt_jvp_contract_ref`).

:func:`rt_jvp_fast_cuda` runs both, the entry ``ForwardModel.
integrate_jvp`` dispatches to for CUDA tensors; it checks the tensors,
allocates the outputs and the scratch and launches on the current
stream.  ``LAUNCHES`` counts its calls, ``LAUNCHES_RECORD`` and
``LAUNCHES_CONTRACT`` each kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import C1, C2, NA, P0, TAU_CUTOFF, TAU_OPAQUE
from ..geometry import LosData, LosTangents
from ..tables import LOG2_RATIO_U
from . import ega_fused
from .continua import ContinuaCoeffs
from .ega import EgaDeviceTables, FastDeviceTables

LAUNCHES = 0           # calls of the RT tangent entry (both kernels)
LAUNCHES_RECORD = 0    # launches of the record kernel
LAUNCHES_CONTRACT = 0  # launches of the contraction kernel


def scratch_lengths(G: int, W: int) -> tuple:
    """(values of one record per valid segment and channel, values of
    the epilogue per ray and channel) of the kernels' scratch at G gases
    and W windows: the library's own count (``jt_ega_jvp_scratch``), the
    one place the layout is decided.  Each record also takes one int32,
    its segment index."""
    import ctypes

    from ._build import load_library
    rec, epi = ctypes.c_int(), ctypes.c_int()
    if load_library().jt_ega_jvp_scratch(G, W, ctypes.addressof(rec),
                                         ctypes.addressof(epi)) != 0:
        raise ValueError(f"jt_ega_jvp_scratch refused G = {G}, W = {W}")
    return rec.value, epi.value


def registers(G: int, W: int, S: int, uniform: bool, dtype,
              exact: bool = False) -> tuple:
    """(record kernel, contraction) registers of the instantiations that
    a call at G gases, W windows and S segments launches in ``dtype`` on
    the fast (or ``exact``) tables, as the library itself chooses them
    (``jt_ega_jvp_registers``)."""
    import ctypes

    from ._build import load_library
    rec, con = ctypes.c_int(), ctypes.c_int()
    rc = load_library().jt_ega_jvp_registers(
        G, W, S, int(bool(uniform)), int(bool(exact)),
        int(dtype == torch.float64), ctypes.addressof(rec),
        ctypes.addressof(con))
    if rc != 0:
        raise RuntimeError(f"jt_ega_jvp_registers failed (cudaError {rc})")
    return rec.value, con.value


# ---------------------------------------------------------------------------
# Plain statements of what the record kernel decides (NumPy / PyTorch)

def fixed_halving(row: np.ndarray, nk: int, K: int, target: float) -> int:
    """The eps -> u inversion's index (``ops.ega._ega_fast``): a fixed
    count of ``ceil(log2 max(K, 2))`` halvings of [0, max(nk - 1, 1)] on
    ``row[mid] > target``."""
    lo, hi = 0, max(nk - 1, 1)
    for _ in range(max(1, int(np.ceil(np.log2(max(K, 2)))))):
        if hi > lo + 1:
            mid = (hi + lo) >> 1
            if row[mid] > target:
                hi = mid
            else:
                lo = mid
    return lo


def hinted_halving(row: np.ndarray, nk: int, K: int, target: float,
                   hint: int) -> tuple[int, bool]:
    """(:func:`fixed_halving`'s index, whether the hint found it), as the
    record kernel searches a monotone row (``ops.ega.rows_monotone``).

    On a row non-decreasing over its ``nk`` points the halving keeps
    (lo = 0 or row[lo] <= target) and (hi = max(nk - 1, 1) or row[hi] >
    target) and ends at hi = lo + 1, so its answer is the one i in [0,
    lmax], lmax = max(nk - 2, 0), with (i = 0 or row[i] <= target) and
    (i = lmax or row[i + 1] > target): two answers a < b would give
    row[a + 1] > target >= row[b] with a + 1 <= b.  The kernel tests
    i = h, h + 1 and h - 1 around the hint h (the last segment's forward
    index, clipped into [0, lmax]) from four loads, and halves only where
    none passes; a NaN target passes none (but at nk <= 2, where the
    answer is 0)."""
    lmax = max(nk - 2, 0)
    h = min(max(hint, 0), lmax)

    def ok(i):
        return 0 <= i <= lmax and (i == 0 or row[i] <= target) and (
            i == lmax or row[i + 1] > target)
    for i in (h, h + 1, h - 1):
        if ok(i):
            return i, True
    return fixed_halving(row, nk, K, target), False


def exact_row_index(row: np.ndarray, n: int, target: float,
                    monotone: bool, hint: int) -> tuple[int, str]:
    """(``ops.ega._count_index``'s index of ``target`` in the exact u or
    eps ``row`` of U entries, the first ``n`` counted; how it was found),
    as the RT kernels search it (``csrc/ega_rt_common.cuh``,
    ``row_index``).  A row that does not decrease within its count
    (``monotone``: ``ops.ega.rows_monotone_exact``'s bit for it, which
    also asks n <= U) has one answer i in [0, lmax], lmax = n - 2, with
    (i = 0 or row[i] <= target) and (i = lmax or row[i + 1] > target)
    (:func:`hinted_halving`'s property): the kernels test i = h, h + 1
    and h - 1 around the hint h clipped into [0, lmax] ("hint"), else
    halve for the first entry above the target ("halving"); any other
    row they count over its min(n, U) entries ("count").  At n < 2 the
    index is 0 ("short")."""
    if n < 2:
        return 0, "short"
    lmax = n - 2
    if monotone:
        c = min(max(hint, 0), lmax)

        def ok(i):
            return 0 <= i <= lmax and (i == 0 or row[i] <= target) and (
                i == lmax or row[i + 1] > target)
        for i in (c, c + 1, c - 1):
            if ok(i):
                return i, "hint"
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if row[mid] <= target:
                lo = mid + 1
            else:
                hi = mid
        return min(max(lo - 1, 0), lmax), "halving"
    below = int(np.sum(row[:min(n, row.shape[0])] <= target))
    return min(max(below - 1, 0), lmax), "count"


def exact_corner_indices(e_row: np.ndarray, u_row: np.ndarray, n: int,
                         mono: int, hint: int, target: float,
                         u_seg: float) -> tuple[int, int, str]:
    """(i, j, path): an exact corner's two searches as the RT kernels make
    them (``csrc/ega_rt_common.cuh``, ``exact_load`` / ``exact_finish``):
    i of ``target`` in the eps row, j of u_new = lip(eps[i], u[i],
    eps[i + 1], u[i + 1], target) + ``u_seg`` in the u row (rows of U
    entries, the first ``n`` counted; ``mono`` the cell's
    ``rows_monotone_exact`` bits; ``hint`` the last segment's j).

    Where both rows are monotone and n >= 2, the kernel loads the eps row
    at hint - 1 .. hint + 2 with the cell's count, checks i = hint, hint
    + 1, hint - 1 there (:func:`hinted_halving`'s property; where hint <=
    n - 2), else searches the row (:func:`exact_row_index`); then loads
    the u row at i - 1 .. i + 2 and checks j = i, i + 1, i - 1 there, else
    searches that row.  ``path`` names what answered: "window" (both
    checks), "eps row", "u row" or "rows" (the searches), "corner" (a row
    not monotone, or n < 2: the whole corner as
    :func:`exact_row_index` states it).  Either way the indices are
    ``ops.ega._count_index``'s.  A window read outside its window raises
    here."""
    U = e_row.shape[0]
    last = lambda row, k: float(row[min(max(k, 0), U - 1)])
    if n < 2 or mono != 3:
        i, _ = exact_row_index(e_row, n, target, bool(mono & 1), hint)
        u_new = _lip_scalar(last(e_row, i), last(u_row, i),
                            last(e_row, i + 1), last(u_row, i + 1),
                            target) + u_seg
        j, _ = exact_row_index(u_row, n, u_new, bool(mono & 2), i)
        return i, j, "corner"
    lmax = n - 2

    def check(win, c, x):
        def at(k):                          # 0 beyond the count
            return 0.0 if k < 0 or k >= n else float(win[k])
        for i in (c, c + 1, c - 1):
            if 0 <= i <= lmax and (i == 0 or at(i) <= x) and (
                    i == lmax or at(i + 1) > x):
                return i
        return -1
    ew = {k: e_row[min(max(k, 0), U - 1)] for k in range(hint - 1, hint + 3)}
    i = check(ew, hint, target) if 0 <= hint <= lmax else -1
    searched = []
    if i < 0:
        i, _ = exact_row_index(e_row, n, target, True, hint)
        searched.append("eps row")
    uw = {k: u_row[min(max(k, 0), U - 1)] for k in range(i - 1, i + 3)}
    u_new = _lip_scalar(last(e_row, i), float(uw[i]), last(e_row, i + 1),
                        float(uw[i + 1]), target) + u_seg
    j = check(uw, i, u_new)
    if j < 0:
        j, _ = exact_row_index(u_row, n, u_new, True, i)
        searched.append("u row")
    if not searched:
        return i, j, "window"
    return i, j, searched[0] if len(searched) == 1 else "rows"


def _lip_scalar(x0, y0, x1, y1, x):
    """``ops.ega._lip`` on floats."""
    d = x1 - x0
    return y0 + (x - x0) * (y1 - y0) / (1.0 if d == 0 else d)


def shared_brackets(tbl: FastDeviceTables, p, t):
    """(ipr, it0, it1) [R, G] of the points (p, t) [R] on channel 0's
    axes: the record kernel's bracket of a (segment, gas) for every
    channel where the axes are the same in all (``tbl.uniform``); then it
    equals ``ops.ega._brackets``' per-channel indices."""
    from .ega import _brackets
    one = tbl._replace(np_=tbl.np_[:, :1], nt=tbl.nt[..., :1],
                       p=tbl.p[:, :1], t=tbl.t[:, :, :1])
    _, _, ipr, _, _, _, _, it0, it1, _, _ = _brackets(one, p, t,
                                                      tbl.np_.shape[0], 1)
    return ipr[..., 0], it0[..., 0], it1[..., 0]


# ---------------------------------------------------------------------------
# Plain statement of the adjoint form: records -> A -> contraction

def rt_jvp_records_ref(tbl: EgaDeviceTables | FastDeviceTables, sr, st, nu,
                       cc, window, los: LosData, flags, ig_co2: int,
                       ig_h2o: int, bbt: bool):
    """(RtOut, A [R, S, F, D], a_surf [R, D]), F = 3 + 2 G + W: the eager
    pass on ``los`` with the tables' own lookups, exact or fast
    (``forward.rt_integrate``'s result, bit for bit)
    and the sensitivities of its radiance (after the surface and
    brightness epilogue) to each segment's LOS fields (p, t, q[G], k[W],
    u[G], ds; zero on invalid segments) and to tsurf.  The forward loop
    takes the local partials of ``forward.rt_integrate_jvp_ref``; a sweep
    back carries the adjoints of rad, tau and tau_path[G] -- the record
    kernel's algebra, in its order."""
    from ..forward import (RtOut, _surface_and_bbt, src_planck,
                           src_planck_slope)
    from .continua import beta_ds_partials
    from .ega import ega_eps_partials
    dtype, dev = los.p.dtype, los.p.device
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    D = sr.shape[1]
    sr_, st_ = sr.to(dtype), st.to(dtype)
    rad = torch.zeros((R, D), dtype=dtype, device=dev)
    tau = torch.ones((R, D), dtype=dtype, device=dev)
    tau_path = torch.ones((R, G, D), dtype=dtype, device=dev)
    zq = torch.zeros((R,), dtype=dtype, device=dev)
    recs = []
    for s in range(S):
        p, t, ds = los.p[:, s], los.t[:, s], los.ds[:, s]
        q, u, valid = los.q[:, s], los.u[:, s], los.valid[:, s]
        kw = los.k[:, s][:, window]
        q_h2o = q[:, ig_h2o] if ig_h2o >= 0 else zq
        u_h2o = u[:, ig_h2o] if ig_h2o >= 0 else zq
        u_co2 = u[:, ig_co2] if ig_co2 >= 0 else zq
        bds, b = beta_ds_partials(flags, cc, kw, ds[:, None], p[:, None],
                                  t[:, None], q_h2o[:, None],
                                  u_co2[:, None], u_h2o[:, None])
        part = ega_eps_partials(tbl, tau_path, t, u, p)
        factor = part[0]
        tau_gas = factor[:, 0]
        for g in range(1, G):
            tau_gas = tau_gas * factor[:, g]
        src = src_planck(sr_, st_, t)
        ex = torch.exp(-bds)
        eps = 1.0 - tau_gas * ex
        upd = valid[:, None] & (tau_gas > TAU_CUTOFF)
        recs.append((valid, part, tau_path, b, ex, src,
                     src_planck_slope(sr_, st_, t), tau, tau_gas, eps, upd))
        tau_path = torch.where(valid[:, None, None], tau_path * factor,
                               tau_path)
        rad = torch.where(upd, rad + src * eps * tau, rad)
        tau = torch.where(upd, tau * (1.0 - eps), tau)
    ts = los.tsurf
    hit = (ts > 0.0)[:, None]
    src_s = src_planck(sr_, st_, ts)
    out = _surface_and_bbt(rad, tau, sr, st, nu, ts, bbt)
    coef = torch.ones_like(rad)
    if bbt:
        r = torch.where(hit, rad + src_s * tau, rad)
        nu_ = nu.to(dtype)
        a = C1 * nu_ ** 3 / r
        lg = torch.log1p(a)
        coef = C2 * nu_ * a / (r * (1.0 + a) * lg * lg)
    zero = torch.zeros_like(rad)
    a_tau = torch.where(hit, coef * src_s, zero)
    a_surf = torch.where(hit, coef * src_planck_slope(sr_, st_, ts) * tau,
                         zero)
    a_tp = torch.zeros((R, G, D), dtype=dtype, device=dev)
    F = 3 + 2 * G + W
    A = torch.zeros((R, S, F, D), dtype=dtype, device=dev)
    onehot = [(window == w).to(dtype) for w in range(W)]
    for s in range(S - 1, -1, -1):
        (valid, (f, f_tp, f_t, f_p, f_u), tpo, b, ex, src, slope, tau_b,
         tau_gas, eps, upd) = recs[s]
        a_deps = torch.where(upd, (coef * src - a_tau) * tau_b, zero)
        At = torch.where(upd, coef * slope * eps * tau_b, zero)
        a_tau = torch.where(upd, coef * src * eps + a_tau * (1.0 - eps),
                            a_tau)
        a_dbds = a_deps * tau_gas * ex
        a_dtg = -(a_deps * ex)
        pre = [torch.ones_like(rad)]
        for g in range(1, G):
            pre.append(f[:, 0] if g == 1 else pre[-1] * f[:, g - 1])
        Ap, Au, atp = zero, [None] * G, [None] * G
        for g in range(G - 1, -1, -1):
            a_df = a_tp[:, g] * tpo[:, g] + a_dtg * pre[g]
            a_dtg = a_dtg * f[:, g]
            atp[g] = a_tp[:, g] * f[:, g] + a_df * f_tp[:, g]
            At = At + a_df * f_t[:, g]
            Ap = Ap + a_df * f_p[:, g]
            Au[g] = a_df * f_u[:, g]
        Ap = Ap + a_dbds * b[2]
        At = At + a_dbds * b[3]
        if ig_co2 >= 0:
            Au[ig_co2] = Au[ig_co2] + a_dbds * b[5]
        if ig_h2o >= 0:
            Au[ig_h2o] = Au[ig_h2o] + a_dbds * b[6]
        q = [a_dbds * b[4] if g == ig_h2o else zero for g in range(G)]
        k = [a_dbds * b[0] * oh for oh in onehot]
        A_s = torch.stack([Ap, At, *q, *k, *Au, a_dbds * b[1]], dim=1)
        A[:, s] = torch.where(valid[:, None, None], A_s, 0.0)
        a_tp = torch.where(valid[:, None, None], torch.stack(atp, 1), a_tp)
    return RtOut(*out), A, a_surf


def rt_jvp_contract_ref(A, a_surf, valid, tan: LosTangents):
    """drad [R, D, n] = sum over valid segments s and fields f of
    A[r, s, f, d] tan.seg[r, s, f, j], plus a_surf[r, d] tan.tsurf[r, j]:
    the contraction kernel's product (its sum order differs)."""
    seg = torch.where(valid[:, :, None, None], tan.seg, 0.0)
    return (torch.einsum("rsfd,rsfn->rdn", A, seg)
            + a_surf[:, :, None] * tan.tsurf[:, None, :])


def rt_jvp_adjoint_ref(tbl: EgaDeviceTables | FastDeviceTables, sr, st, nu,
                       cc, window, los: LosData, tan: LosTangents, flags,
                       ig_co2: int, ig_h2o: int, bbt: bool):
    """(RtOut, drad [R, D, n]) of ``forward.rt_integrate_jvp_ref`` on the
    same arguments by the kernels' algebra: :func:`rt_jvp_records_ref`,
    then :func:`rt_jvp_contract_ref`."""
    out, A, a_surf = rt_jvp_records_ref(tbl, sr, st, nu, cc, window, los,
                                        flags, ig_co2, ig_h2o, bbt)
    return out, rt_jvp_contract_ref(A, a_surf, los.valid, tan)


def dense_adjoint(rec, sidx, first, S: int, G: int, W: int):
    """A [R, S, F, D] (zero on invalid segments) from the record kernel's
    records [valid, rec_len, D], their segment indices and each ray's
    first record [R + 1]: the layout of :func:`rt_jvp_records_ref`."""
    F = 3 + 2 * G + W
    R = first.shape[0] - 1
    D = rec.shape[2]
    ray = torch.repeat_interleave(torch.arange(R, device=rec.device),
                                  (first[1:] - first[:-1]))
    A = torch.zeros((R, S, F, D), dtype=rec.dtype, device=rec.device)
    n = int(first[-1])
    A[ray, sidx[:n].long()] = rec[:n, :F]
    return A


# ---------------------------------------------------------------------------
# The kernels

def _library():
    from ._build import load_library
    return load_library()


def _stream(dev):
    import ctypes
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launch(name: str, fn, *args):
    """``fn(*args, stream)`` on the current stream, with CUDA events
    around it where ``ega_fused.LAUNCH_EVENTS`` records; raises on a
    failed launch."""
    events = ega_fused.LAUNCH_EVENTS
    if events is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    rc = fn(*args)
    if events is not None:
        ev[1].record()
        events.append((name, *ev))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def kernel_tables(tbl: EgaDeviceTables | FastDeviceTables, G: int, dev):
    """(the eight table tensors, P, T, K, exact, uniform, hint, D) that
    the RT kernels take (``jt_ega_jvp_record``, ``jt_ega_rt``), checked:
    the fast tables (eps, log2_u0, p, t, nu, nt, np, valid; K the eps rows'
    length) or the exact ones (u, eps, p, t, nu, nt, np, row_monotone; K
    their rows' length U), the axes channel-innermost so that a warp's
    per-channel loads coalesce, the integers as int32."""
    exact = isinstance(tbl, EgaDeviceTables)
    if exact:
        G_t, P, T, K, D = tbl.u.shape
        payload = (("tables u", tbl.u, torch.float32, (G_t, P, T, K, D)),
                   ("tables eps", tbl.eps, torch.float32, (G_t, P, T, K, D)))
    else:
        G_t, P, T, K, D = tbl.eps.shape
        payload = (("tables eps", tbl.eps, torch.float32, (G_t, P, T, K, D)),
                   ("tables log2_u0", tbl.log2_u0, torch.float64,
                    (G_t, P, T, D)))
    if G < 1 or G_t != G:
        raise ValueError(f"{G} gases on the LOS, {G_t} in the tables")
    for name, x, dtype, shape in payload + (
            ("tables p", tbl.p, torch.float64, (G, D, P)),
            ("tables t", tbl.t, torch.float64, (G, P, D, T))):
        ega_fused._check(name, x, dtype, shape, dev)
    i32 = lambda x: x.to(dev, torch.int32).contiguous()
    u8 = lambda x: x.to(dev, torch.uint8).contiguous()
    if exact and tbl.row_monotone is None:
        raise ValueError("the exact tables carry no row decisions "
                         "(ops.ega.ega_tables_to_device makes them)")
    last = u8(tbl.row_monotone if exact else tbl.valid)
    tabs = (payload[0][1], payload[1][1], tbl.p.permute(0, 2, 1).contiguous(),
            tbl.t.permute(0, 1, 3, 2).contiguous(), i32(tbl.nu), i32(tbl.nt),
            i32(tbl.np_), last)
    hint = bool(tbl.monotone) if not exact else True
    return tabs, P, T, K, exact, bool(tbl.uniform), hint, D


def kernel_inputs(tbl, sr, st, nu, cc: ContinuaCoeffs, window,
                  los: LosData):
    """What both RT kernels take besides the outputs, checked: (device,
    dtype, R, S, G, W, the table tuple of :func:`kernel_tables`, the
    continua rows [16, D], window int32, sr, st, nu in the LOS's dtype)."""
    dev, dt = _check_los(los)
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    kt = kernel_tables(tbl, G, dev)
    chk = ega_fused._check
    for name, x, dtype, shape in (
            ("los.p", los.p, dt, (R, S)), ("los.t", los.t, dt, (R, S)),
            ("los.ds", los.ds, dt, (R, S)), ("los.q", los.q, dt, (R, S, G)),
            ("los.k", los.k, dt, (R, S, W)), ("los.u", los.u, dt, (R, S, G)),
            ("los.valid", los.valid, torch.bool, (R, S)),
            ("los.tsurf", los.tsurf, dt, (R,))):
        chk(name, x, dtype, shape, dev)
    D = kt[-1]
    ccr = torch.stack([f.to(dev, dt) for f in cc])           # [16, D]
    sr_, st_, nu_ = (x.to(dev, dt).contiguous() for x in (sr, st, nu))
    if tuple(ccr.shape) != (len(ContinuaCoeffs._fields), D) \
            or tuple(sr_.shape) != (st_.shape[0], D) or st_.shape[0] < 2:
        raise ValueError("continua, source table or its axis do not match "
                         f"the {D} channels")
    return (dev, dt, R, S, G, W, kt, ccr,
            window.to(dev, torch.int32).contiguous(), sr_, st_, nu_)


def consts():
    """The constants both RT kernels take (NA 1000 P0, P0, C1, C2,
    TAU_OPAQUE, TAU_CUTOFF, LOG2_RATIO_U, 2 ** LOG2_RATIO_U)."""
    return (NA * 1000.0 * P0, P0, C1, C2, TAU_OPAQUE, TAU_CUTOFF,
            LOG2_RATIO_U, 2.0 ** LOG2_RATIO_U)


def rt_jvp_records_cuda(tbl: EgaDeviceTables | FastDeviceTables, sr, st, nu,
                        cc: ContinuaCoeffs, window, los: LosData, flags,
                        ig_co2: int, ig_h2o: int, bbt: bool):
    """The record kernel on the card: (RtOut, records [valid, rec_len, D],
    their segment indices [valid] int32, each ray's first record [R + 1]
    int64, a_surf [R, D]), the records' first F values A (layout of
    :func:`dense_adjoint`), on the fast or the exact tables.  Checks like
    :func:`rt_jvp_fast_cuda` (one device-to-host read of the valid
    count)."""
    global LAUNCHES_RECORD
    import ctypes

    from ..forward import RtOut
    (dev, dt, R, S, G, W, kt, ccr, win, sr_, st_, nu_) = kernel_inputs(
        tbl, sr, st, nu, cc, window, los)
    tabs, P, T, K, exact, uniform, hint, D = kt
    out = RtOut(rad=torch.empty((R, D), dtype=dt, device=dev),
                tau=torch.empty((R, D), dtype=dt, device=dev))
    # a record per valid segment and channel, each ray's from its first
    counts = los.valid.sum(dim=1)
    first = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(counts, 0)
    n_rec = int(first[-1])
    rec_len, epi_len = scratch_lengths(G, W)
    rec = torch.empty((max(n_rec, 1), rec_len, D), dtype=dt, device=dev)
    sidx = torch.empty(max(n_rec, 1), dtype=torch.int32, device=dev)
    asurf = torch.empty((R, D), dtype=dt, device=dev)     # epi_len == 1
    if R == 0:
        return out, rec, sidx, first, asurf
    bits = sum(1 << i for i, f in enumerate(flags) if f)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        _launch("jt_ega_jvp_record", _library().jt_ega_jvp_record,
                *(ptr(x) for x in (*tabs, ccr, win, sr_, st_, nu_,
                                   los.p, los.t, los.ds, los.q, los.k,
                                   los.u, los.valid, los.tsurf, first, rec,
                                   sidx, asurf, out.rad, out.tau)),
                R, S, G, W, D, P, T, K, st_.shape[0], bits, int(ig_co2),
                int(ig_h2o), int(bool(bbt)), int(uniform), int(hint),
                int(exact), *consts(), int(dt == torch.float64),
                _stream(dev))
    LAUNCHES_RECORD += 1
    return out, rec, sidx, first, asurf


def rt_jvp_contract_cuda(rec, sidx, first, asurf, tan: LosTangents, G: int,
                         W: int):
    """The contraction kernel on the card: drad [R, D, n] from the record
    kernel's scratch (:func:`rt_jvp_records_cuda`) and the LOS tangents
    [R, S, 3 + 2 G + W, n >= 1] and tsurf's [R, n]."""
    global LAUNCHES_CONTRACT
    import ctypes
    dev, dt = rec.device, rec.dtype
    R = first.shape[0] - 1
    D = rec.shape[2]
    F = 3 + 2 * G + W
    if tan.seg.dim() != 4 or tan.seg.shape[0] != R \
            or tan.seg.shape[2] != F or tan.seg.shape[3] < 1:
        raise ValueError(f"LOS tangents must be [{R}, S, {F}, n >= 1], "
                         f"got {tuple(tan.seg.shape)}")
    S, n = tan.seg.shape[1], tan.seg.shape[3]
    chk = ega_fused._check
    for name, x, dtype, shape in (
            ("LOS tangents", tan.seg, dt, (R, S, F, n)),
            ("tsurf tangents", tan.tsurf, dt, (R, n)),
            ("a_surf", asurf, dt, (R, D)),
            ("record segments", sidx, torch.int32, tuple(sidx.shape)),
            ("first records", first, torch.int64, (R + 1,))):
        chk(name, x, dtype, shape, dev)
    drad = torch.empty((R, D, n), dtype=dt, device=dev)
    if R == 0:
        return drad
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        _launch("jt_ega_jvp_contract", _library().jt_ega_jvp_contract,
                *(ptr(x) for x in (rec, sidx, first, tan.seg, tan.tsurf,
                                   asurf, drad)),
                R, S, G, W, D, n, int(dt == torch.float64),
                _stream(dev))
    LAUNCHES_CONTRACT += 1
    return drad


def _check_los(los: LosData):
    dev, dt = los.p.device, los.p.dtype
    if dev.type != "cuda":
        raise ValueError(f"the RT kernels run on CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the RT kernels take float32 or float64, got "
                         f"{dt}")
    return dev, dt


def rt_jvp_fast_cuda(tbl: EgaDeviceTables | FastDeviceTables, sr, st, nu,
                     cc: ContinuaCoeffs, window, los: LosData,
                     tan: LosTangents, flags, ig_co2: int, ig_h2o: int,
                     bbt: bool):
    """(RtOut, drad [R, D, n]) of ``forward.rt_integrate_jvp_ref`` on the
    same arguments, by the record kernel and the contraction kernel on the
    card in the dtype of ``los``, on the fast tables or (the record
    kernel's exact instantiation) the exact ones; the records take ``scratch_lengths(G,
    W)`` values and one int32 per valid segment and channel of scratch
    (one device-to-host read of the valid count).  Raises on tensors off
    the card or of another dtype or shape than the LOS's, on tangents
    that are not [R, S, 3 + 2 G + W, n] and [R, n] with n >= 1, on a gas
    count of 0, and on a failed launch; nothing falls back."""
    global LAUNCHES
    _check_los(los)
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    F = 3 + 2 * G + W
    if tan.seg.dim() != 4 or tuple(tan.seg.shape[:3]) != (R, S, F) \
            or tan.seg.shape[3] < 1:
        raise ValueError(f"LOS tangents must be [{R}, {S}, {F}, n >= 1], "
                         f"got {tuple(tan.seg.shape)}")
    n = tan.seg.shape[3]
    for name, x, shape in (("LOS tangents", tan.seg, (R, S, F, n)),
                           ("tsurf tangents", tan.tsurf, (R, n))):
        ega_fused._check(name, x, los.p.dtype, shape, los.p.device)
    out, rec, sidx, first, asurf = rt_jvp_records_cuda(
        tbl, sr, st, nu, cc, window, los, flags, ig_co2, ig_h2o, bbt)
    drad = rt_jvp_contract_cuda(rec, sidx, first, asurf, tan, G, W)
    LAUNCHES += 1
    return out, drad
