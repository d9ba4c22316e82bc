"""The RT pass's tangent kernel on the fast tables
(``csrc/ega_jvp_fast.cu``): the RT half of the JAX package's compiled
forward-mode Jacobian (``jax.jit(jax.jacfwd(fwd))``,
``jurassic_tpu/retrieval.py:281``, through ``rt_integrate``,
``jurassic_tpu/forward.py:99-213``, and ``ega_eps_fast``,
``jurassic_tpu/ops/ega.py:171``).

For every (ray, channel) it runs ``forward.rt_integrate(...,
use_fast=True)`` with the surface and brightness epilogue and carries the
tangents of the result in the directions of the LOS tangents of the
tracer's tangent kernel, in the order of its plain version ``forward.
rt_integrate_jvp_ref``: one launch of the entry point runs two kernels,
the primal with its local partials, a record per valid (segment,
channel), then the tangents.  :func:`rt_jvp_fast_cuda` checks the
tensors, allocates the outputs and the records and launches on the
current stream; ``ForwardModel.integrate_jvp`` dispatches to it for CUDA
tensors.  ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import torch

from ..constants import C1, C2, NA, P0, TAU_CUTOFF, TAU_OPAQUE
from ..geometry import LosData, LosTangents
from ..tables import LOG2_RATIO_U
from . import ega_fused
from .continua import ContinuaCoeffs
from .ega import FastDeviceTables

LAUNCHES = 0        # launches of the RT tangent kernel


def scratch_lengths(G: int) -> tuple:
    """(values of one record per valid segment and channel, values of
    the epilogue per ray and channel) of the kernel's scratch at G gases:
    the library's own count (``jt_ega_jvp_scratch``), the one place the
    layout is decided."""
    import ctypes

    from ._build import load_library
    rec, epi = ctypes.c_int(), ctypes.c_int()
    if load_library().jt_ega_jvp_scratch(G, ctypes.addressof(rec),
                                         ctypes.addressof(epi)) != 0:
        raise ValueError(f"jt_ega_jvp_scratch refused G = {G}")
    return rec.value, epi.value


def rt_jvp_fast_cuda(tbl: FastDeviceTables, sr, st, nu, cc: ContinuaCoeffs,
                     window, los: LosData, tan: LosTangents, flags,
                     ig_co2: int, ig_h2o: int, bbt: bool):
    """(RtOut, drad [R, D, n]) of ``forward.rt_integrate_jvp_ref`` on the
    same arguments, by the kernel on the card in the dtype of ``los``;
    the records take ``scratch_lengths(G)`` values per valid segment and
    channel of scratch (one device-to-host read of the valid count).
    Raises on tensors off the card or of another dtype or shape than the
    LOS's, on tangents that are not [R, S, 3 + 2 G + W, n] and [R, n]
    with n >= 1, on a gas count of 0, and on a failed launch; nothing
    falls back."""
    global LAUNCHES
    import ctypes

    from ..forward import RtOut
    from ._build import load_library

    dev, dt = los.p.device, los.p.dtype
    if dev.type != "cuda":
        raise ValueError(f"the RT tangent kernel runs on CUDA tensors, got "
                         f"{dev}")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the RT tangent kernel takes float32 or float64, "
                         f"got {dt}")
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    G_t, P, T, K, D = tbl.eps.shape
    if G < 1 or G_t != G:
        raise ValueError(f"{G} gases on the LOS, {G_t} in the tables")
    F = 3 + 2 * G + W
    if tan.seg.dim() != 4 or tuple(tan.seg.shape[:3]) != (R, S, F) \
            or tan.seg.shape[3] < 1:
        raise ValueError(f"LOS tangents must be [{R}, {S}, {F}, n >= 1], "
                         f"got {tuple(tan.seg.shape)}")
    n = tan.seg.shape[3]
    chk = ega_fused._check
    for name, x, dtype, shape in (
            ("los.p", los.p, dt, (R, S)), ("los.t", los.t, dt, (R, S)),
            ("los.ds", los.ds, dt, (R, S)), ("los.q", los.q, dt, (R, S, G)),
            ("los.k", los.k, dt, (R, S, W)), ("los.u", los.u, dt, (R, S, G)),
            ("los.valid", los.valid, torch.bool, (R, S)),
            ("los.tsurf", los.tsurf, dt, (R,)),
            ("LOS tangents", tan.seg, dt, (R, S, F, n)),
            ("tsurf tangents", tan.tsurf, dt, (R, n)),
            ("tables eps", tbl.eps, torch.float32, (G, P, T, K, D)),
            ("tables log2_u0", tbl.log2_u0, torch.float64, (G, P, T, D)),
            ("tables p", tbl.p, torch.float64, (G, D, P)),
            ("tables t", tbl.t, torch.float64, (G, P, D, T))):
        chk(name, x, dtype, shape, dev)
    i32 = lambda x: x.to(dev, torch.int32).contiguous()
    tabs = (tbl.eps, tbl.log2_u0, tbl.p, tbl.t, i32(tbl.nu), i32(tbl.nt),
            i32(tbl.np_), tbl.valid.to(dev, torch.uint8).contiguous())
    ccr = torch.stack([f.to(dev, dt) for f in cc])           # [16, D]
    sr_, st_, nu_ = (x.to(dev, dt).contiguous() for x in (sr, st, nu))
    if tuple(ccr.shape) != (len(ContinuaCoeffs._fields), D) \
            or tuple(sr_.shape) != (st_.shape[0], D) or st_.shape[0] < 2:
        raise ValueError("continua, source table or its axis do not match "
                         f"the {D} channels")
    out = RtOut(rad=torch.empty((R, D), dtype=dt, device=dev),
                tau=torch.empty((R, D), dtype=dt, device=dev))
    drad = torch.empty((R, D, n), dtype=dt, device=dev)
    if R == 0:
        return out, drad
    # a record per valid segment and channel, each ray's from its first
    counts = los.valid.sum(dim=1)
    first = torch.cumsum(counts, 0) - counts
    lib = load_library()
    rec_len, epi_len = scratch_lengths(G)
    records = torch.empty((max(int(counts.sum()), 1), rec_len, D),
                          dtype=dt, device=dev)
    epi = torch.empty((R, epi_len, D), dtype=dt, device=dev)
    bits = sum(1 << i for i, f in enumerate(flags) if f)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    events = ega_fused.LAUNCH_EVENTS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        args = (*(ptr(x) for x in (*tabs, ccr, i32(window), sr_, st_, nu_,
                                   los.p, los.t, los.ds, los.q, los.k, los.u,
                                   los.valid, los.tsurf, tan.seg, tan.tsurf,
                                   out.rad, out.tau, drad, first, records,
                                   epi)),
                R, S, G, W, D, P, T, K, st_.shape[0], n, bits, int(ig_co2),
                int(ig_h2o), int(bool(bbt)), NA * 1000.0 * P0, P0, C1, C2,
                TAU_OPAQUE, TAU_CUTOFF, LOG2_RATIO_U, 2.0 ** LOG2_RATIO_U,
                int(dt == torch.float64),
                ctypes.c_void_p(stream.cuda_stream))
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        rc = lib.jt_ega_jvp_fast(*args)
        if events is not None:
            ev[1].record(stream)
            events.append(("jt_ega_jvp_fast", *ev))
    if rc != 0:
        raise RuntimeError(f"jt_ega_jvp_fast: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    return out, drad
