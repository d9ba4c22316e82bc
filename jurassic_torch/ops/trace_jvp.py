"""The tracer's tangent kernel (``csrc/trace_rays_jvp.cu``): the tracer's
half of the JAX package's compiled forward-mode Jacobian
(``jax.jit(jax.jacfwd(fwd))``, ``jurassic_tpu/retrieval.py:281``, through
``_trace_single``, ``jurassic_tpu/geometry.py:283``).

It traces the rays bit for bit as ``csrc/trace_rays.cu`` does (the two
share ``csrc/trace_common.cuh``) and carries the tangents of the fields
the RT pass reads in the n directions of the profile tangents, a lane a
tangent, in the order of the plain version ``geometry.
trace_rays_jvp_ref``.  :func:`trace_rays_jvp_cuda` checks the tensors,
allocates the outputs and launches the kernel on the current stream;
``geometry.trace_rays_jvp`` dispatches to it for CUDA tensors.
``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import KB, RE
from ..geometry import (DEG2RAD, ENTRY_MAX_ITERS, RAD2DEG, Z_REFRAC, LosData,
                        LosTangents, ProfileTangents, RayProfiles)
from . import ega_fused
from .trace import GEO_KEYS, check_inputs, shared_memory_bytes

LAUNCHES = 0        # launches of the tracer's tangent kernel


def trace_rays_jvp_cuda(prof: RayProfiles, ptan: ProfileTangents,
                        obs_geo: dict, rayds: float, raydz: float,
                        refrac: bool, nlos: int):
    """(LosData, LosTangents, flag) of the rays of ``prof`` and their
    tangents in the directions of ``ptan``, by the kernel on the card in
    the dtype of ``prof``; ``flag`` [R] int32 is 1 where the entry-point
    bisection did not converge.  Raises on anything the tracer kernel's
    checks refuse, on tangents of another dtype, device or shape than
    [N, 2 + G + W, n], window indices that are not [R, L] or point past
    N, and on a failed launch; nothing falls back."""
    global LAUNCHES
    import ctypes

    from ._build import load_library

    dev, dt = prof.z.device, prof.z.dtype
    if dev.type != "cuda":
        raise ValueError(f"the tracer's tangent kernel runs on CUDA tensors, "
                         f"got {dev}")
    geo = torch.as_tensor(np.stack([np.asarray(obs_geo[k], np.float64)
                                    for k in GEO_KEYS])).to(dev, dt)
    prof = prof._replace(nlev=prof.nlev.to(dev, torch.int32))
    check_inputs(prof, geo, nlos)
    R, L = prof.z.shape
    G, W = prof.q.shape[1], prof.k.shape[1]
    d = ptan.d.contiguous()
    if d.dim() != 3 or d.shape[1] != 2 + G + W or d.shape[2] < 1:
        raise ValueError(f"profile tangents must be [N, {2 + G + W}, n], "
                         f"got {tuple(d.shape)}")
    N, n = d.shape[0], d.shape[2]
    ega_fused._check("profile tangents", d, dt, tuple(d.shape), dev)
    gi = ptan.gi.to(dev, torch.int32).contiguous()
    if tuple(gi.shape) != (R, L):
        raise ValueError(f"window indices must be [{R}, {L}], got "
                         f"{tuple(gi.shape)}")
    if R and bool(((gi < 0) | (gi >= N)).any()):
        raise ValueError(f"window indices outside the {N} atm points")
    shared_memory_bytes(L, G, W, nlos, dt, "jt_trace_jvp_smem_bytes")

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)
    los = LosData(
        z=empty(R, nlos), lon=empty(R, nlos), lat=empty(R, nlos),
        p=empty(R, nlos), t=empty(R, nlos), q=empty(R, nlos, G),
        k=empty(R, nlos, W), ds=empty(R, nlos), u=empty(R, nlos, G),
        valid=empty(R, nlos, dtype=torch.bool),
        np_=empty(R, dtype=torch.int32), tsurf=empty(R), tpz=empty(R),
        tplon=empty(R), tplat=empty(R))
    tan = LosTangents(seg=empty(R, nlos, 3 + 2 * G + W, n),
                      tsurf=empty(R, n))
    flag = empty(R, dtype=torch.int32)
    if R == 0:
        return los, tan, flag
    lib = load_library()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    events = ega_fused.LAUNCH_EVENTS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        args = (*(ptr(x) for x in (prof.z, prof.p, prof.t, prof.q, prof.k,
                                   prof.nlev, prof.zmin, prof.zmax, geo, d,
                                   gi)),
                *(ptr(x) for x in los), ptr(flag), ptr(tan.seg),
                ptr(tan.tsurf), R, L, G, W, nlos, n, float(rayds),
                float(raydz), int(bool(refrac)), ENTRY_MAX_ITERS, RE,
                DEG2RAD, RAD2DEG, KB, Z_REFRAC, int(dt == torch.float64),
                ctypes.c_void_p(stream.cuda_stream))
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        rc = lib.jt_trace_rays_jvp(*args)
        if events is not None:
            ev[1].record(stream)
            events.append(("jt_trace_rays_jvp", *ev))
    if rc != 0:
        raise RuntimeError(f"jt_trace_rays_jvp: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    return los, tan, flag
