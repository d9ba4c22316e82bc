"""The tracer's half of the forward-mode Jacobian on the card
(``csrc/trace_rays_jvp.cu``): the counterpart of the tracer's half of the
JAX package's compiled ``jax.jit(jax.jacfwd(fwd))``
(``jurassic_tpu/retrieval.py:281``, through ``_trace_single``,
``jurassic_tpu/geometry.py:283``).

Two kernels.  The record kernel traces the rays bit for bit as
``csrc/trace_rays.cu`` does (the two share ``csrc/trace_common.cuh``),
once a ray, and writes each step's record of the primal values the
tangent rules read (:func:`trace_jvp_records_cuda`; plain statement
``geometry.trace_step_records_ref``).  The tangent kernel applies the
rules to the records, a thread per (ray, tangent), and writes the
tangents of the fields the RT pass reads (:func:`trace_jvp_tangents_cuda`;
plain statement ``geometry.trace_tangents_from_records_ref``).
:func:`trace_rays_jvp_cuda` runs both, in the order of the plain version
``geometry.trace_rays_jvp_ref``; ``geometry.trace_rays_jvp`` dispatches to
it for CUDA tensors.  ``LAUNCHES`` counts its calls, ``LAUNCHES_RECORD``
and ``LAUNCHES_TANGENT`` each kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import KB, RE
from ..geometry import (DEG2RAD, ENTRY_MAX_ITERS, RAD2DEG, TRACE_RAY_FIELDS,
                        TRACE_RECORD_FIELDS, Z_REFRAC, LosData, LosTangents,
                        ProfileTangents, RayProfiles, TraceRecords)
from . import ega_fused
from .trace import GEO_KEYS, check_inputs, shared_memory_bytes

LAUNCHES = 0          # calls of the tracer tangent entry (both kernels)
LAUNCHES_RECORD = 0   # launches of the record kernel
LAUNCHES_TANGENT = 0  # launches of the tangent kernel


def record_lengths() -> tuple:
    """(values of a step's record, values of a ray's record): the
    library's own count (``jt_trace_jvp_record_len``), the one place the
    layout is decided; raises unless ``geometry.TRACE_RECORD_FIELDS`` and
    ``TRACE_RAY_FIELDS``, which name it, span as many."""
    import ctypes

    from ._build import load_library
    step, ray = ctypes.c_int(), ctypes.c_int()
    load_library().jt_trace_jvp_record_len(ctypes.addressof(step),
                                           ctypes.addressof(ray))
    named = (sum(w for _, w in TRACE_RECORD_FIELDS), len(TRACE_RAY_FIELDS))
    if (step.value, ray.value) != named:
        raise RuntimeError(f"the library's records ({step.value}, "
                           f"{ray.value} values) are not those "
                           f"geometry.TRACE_RECORD_FIELDS names {named}")
    return step.value, ray.value


def registers(dtype, refrac: bool) -> dict:
    """{"record", "tangent"}: (registers, local bytes) of the kernels'
    instantiations a launch in ``dtype`` and ``refrac`` takes, from the
    library (``jt_trace_jvp_registers``)."""
    import ctypes

    from ._build import load_library
    out = (ctypes.c_int * 4)()
    rc = load_library().jt_trace_jvp_registers(
        int(dtype == torch.float64), int(bool(refrac)), out)
    if rc != 0:
        raise RuntimeError(f"jt_trace_jvp_registers failed (cudaError {rc})")
    return {"record": (out[0], out[1]), "tangent": (out[2], out[3])}


def _check_tangents(d, G: int, W: int) -> None:
    if d.dim() != 3 or d.shape[1] != 2 + G + W or d.shape[2] < 1:
        raise ValueError(f"profile tangents must be [N, {2 + G + W}, n], "
                         f"got {tuple(d.shape)}")


def _launch(name: str, fn, args, dev):
    """Call the C launch ``fn`` on the current stream (CUDA events around
    it into ``ega_fused.LAUNCH_EVENTS`` when that is a list); raise on a
    failed launch."""
    import ctypes
    events = ega_fused.LAUNCH_EVENTS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        rc = fn(*args, ctypes.c_void_p(stream.cuda_stream))
        if events is not None:
            ev[1].record(stream)
            events.append((name, *ev))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def trace_jvp_records_cuda(prof: RayProfiles, obs_geo: dict, rayds: float,
                           raydz: float, refrac: bool, nlos: int):
    """(LosData, TraceRecords, flag) of the rays of ``prof`` by the record
    kernel on the card, in the dtype of ``prof``: the LOS bit for bit the
    tracer kernel's, each step's record and each ray's, and ``flag`` [R]
    int32, 1 where the entry-point bisection did not converge.  Raises on
    anything the tracer kernel's checks refuse and on a failed launch;
    nothing falls back."""
    global LAUNCHES_RECORD
    import ctypes

    from ._build import load_library

    dev, dt = prof.z.device, prof.z.dtype
    if dev.type != "cuda":
        raise ValueError(f"the tracer's record kernel runs on CUDA tensors, "
                         f"got {dev}")
    geo = torch.as_tensor(np.stack([np.asarray(obs_geo[k], np.float64)
                                    for k in GEO_KEYS])).to(dev, dt)
    prof = prof._replace(nlev=prof.nlev.to(dev, torch.int32))
    check_inputs(prof, geo, nlos)
    R, L = prof.z.shape
    G, W = prof.q.shape[1], prof.k.shape[1]
    shared_memory_bytes(L, G, W, nlos, dt, "jt_trace_jvp_smem_bytes")
    step_len, ray_len = record_lengths()

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)
    los = LosData(
        z=empty(R, nlos), lon=empty(R, nlos), lat=empty(R, nlos),
        p=empty(R, nlos), t=empty(R, nlos), q=empty(R, nlos, G),
        k=empty(R, nlos, W), ds=empty(R, nlos), u=empty(R, nlos, G),
        valid=empty(R, nlos, dtype=torch.bool),
        np_=empty(R, dtype=torch.int32), tsurf=empty(R), tpz=empty(R),
        tplon=empty(R), tplat=empty(R))
    rec = TraceRecords(step=empty(R, nlos, step_len), ray=empty(R, ray_len))
    flag = empty(R, dtype=torch.int32)
    if R == 0:
        return los, rec, flag
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    args = (*(ptr(x) for x in (prof.z, prof.p, prof.t, prof.q, prof.k,
                               prof.nlev, prof.zmin, prof.zmax, geo)),
            *(ptr(x) for x in los), ptr(flag), ptr(rec.step), ptr(rec.ray),
            R, L, G, W, nlos, float(rayds), float(raydz), int(bool(refrac)),
            ENTRY_MAX_ITERS, RE, DEG2RAD, RAD2DEG, KB, Z_REFRAC,
            int(dt == torch.float64))
    _launch("jt_trace_jvp_records", load_library().jt_trace_jvp_records,
            args, dev)
    LAUNCHES_RECORD += 1
    return los, rec, flag


def trace_jvp_tangents_cuda(prof: RayProfiles, ptan: ProfileTangents,
                            los: LosData, rec: TraceRecords,
                            refrac: bool) -> LosTangents:
    """The LOS tangents of the rays of ``prof`` in the directions of
    ``ptan`` by the tangent kernel on the card, from the record kernel's
    ``los`` and ``rec`` (:func:`trace_jvp_records_cuda`).  Raises on
    tangents of another dtype, device or shape than [N, 2 + G + W, n],
    window indices that are not [R, L] or point past N, records or LOS
    fields of another shape, and on a failed launch; nothing falls
    back."""
    global LAUNCHES_TANGENT
    import ctypes

    from ._build import load_library

    dev, dt = prof.z.device, prof.z.dtype
    if dev.type != "cuda":
        raise ValueError(f"the tracer's tangent kernel runs on CUDA tensors, "
                         f"got {dev}")
    R, L = prof.z.shape
    G, W = prof.q.shape[1], prof.k.shape[1]
    nlos = los.p.shape[1] if los.p.dim() == 2 else -1
    d = ptan.d.contiguous()
    _check_tangents(d, G, W)
    N, n = d.shape[0], d.shape[2]
    step_len, ray_len = record_lengths()
    for name, x, shape in (
            ("profile tangents", d, tuple(d.shape)),
            ("prof.z", prof.z, (R, L)), ("prof.q", prof.q, (R, G, L)),
            ("prof.k", prof.k, (R, W, L)),
            ("step records", rec.step, (R, nlos, step_len)),
            ("ray records", rec.ray, (R, ray_len)),
            ("los.p", los.p, (R, nlos)), ("los.t", los.t, (R, nlos)),
            ("los.ds", los.ds, (R, nlos)), ("los.q", los.q, (R, nlos, G))):
        ega_fused._check(name, x, dt, shape, dev)
    if nlos < 3:
        raise ValueError(f"the tangent kernel needs NLOS >= 3, got {nlos}")
    gi = ptan.gi.to(dev, torch.int32).contiguous()
    if tuple(gi.shape) != (R, L):
        raise ValueError(f"window indices must be [{R}, {L}], got "
                         f"{tuple(gi.shape)}")
    if R and bool(((gi < 0) | (gi >= N)).any()):
        raise ValueError(f"window indices outside the {N} atm points")
    shared_memory_bytes(L, G, W, nlos, dt, "jt_trace_jvp_smem_bytes")
    tan = LosTangents(
        seg=torch.empty((R, nlos, 3 + 2 * G + W, n), dtype=dt, device=dev),
        tsurf=torch.empty((R, n), dtype=dt, device=dev))
    if R == 0:
        return tan
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    args = (*(ptr(x) for x in (prof.z, prof.q, prof.k, d, gi, rec.step,
                               rec.ray, los.p, los.t, los.ds, los.q,
                               tan.seg, tan.tsurf)),
            R, L, G, W, nlos, n, int(bool(refrac)), KB,
            int(dt == torch.float64))
    _launch("jt_trace_jvp_tangents", load_library().jt_trace_jvp_tangents,
            args, dev)
    LAUNCHES_TANGENT += 1
    return tan


def trace_rays_jvp_cuda(prof: RayProfiles, ptan: ProfileTangents,
                        obs_geo: dict, rayds: float, raydz: float,
                        refrac: bool, nlos: int):
    """(LosData, LosTangents, flag) of the rays of ``prof`` and their
    tangents in the directions of ``ptan``, by the two kernels on the card
    in the dtype of ``prof``; ``flag`` [R] int32 is 1 where the
    entry-point bisection did not converge.  Raises on what either
    wrapper refuses, before any launch where the profile tangents are
    refused; nothing falls back."""
    global LAUNCHES
    _check_tangents(ptan.d, prof.q.shape[1], prof.k.shape[1])
    los, rec, flag = trace_jvp_records_cuda(prof, obs_geo, rayds, raydz,
                                            refrac, nlos)
    tan = trace_jvp_tangents_cuda(prof, ptan, los, rec, refrac)
    LAUNCHES += 1
    return los, tan, flag



QUO_FIELDS = ("float_fast", "float_differ", "double_fast", "double_differ")


def quo_check(n: int = 1 << 28, seed: int = 0, device="cuda") -> dict:
    """The tangent kernel's division by a block-wide reciprocal
    (``quo_fast`` in ``csrc/trace_rays_jvp.cu``) against the division on
    the card, on ``n`` random pairs in float32 and in float64: the counts
    of pairs it takes and of those whose quotient differs in any bit
    (``QUO_FIELDS``); the kernel is its plain version's bit for bit only
    where both ``*_differ`` are 0."""
    import ctypes

    from ._build import load_library

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the check runs on a CUDA device, got {dev}")
    counts = torch.zeros(len(QUO_FIELDS), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().jt_trace_quo_check(
            ctypes.c_void_p(counts.data_ptr()), n, seed,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"jt_trace_quo_check: launch failed "
                           f"(cudaError {rc})")
    return dict(zip(QUO_FIELDS, counts.tolist()))
