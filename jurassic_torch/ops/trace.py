"""The ray tracer's CUDA kernel (``csrc/trace_rays.cu``): the counterpart
of the JAX package's jitted ``_trace_rays_jit`` (``jurassic_tpu/
geometry.py:486-498``, ``jax.jit`` of ``vmap(_trace_single)``).

One thread traces one ray, entry-point bisection, NLOS steps, tangent
point, trapezoid rule and column densities, in the order of operations
of the plain version ``geometry.trace_rays_ref``.  :func:`trace_rays_cuda`
checks the tensors, allocates the outputs and launches the kernel on the
current stream; ``geometry.trace_rays`` dispatches to it for CUDA
tensors.  ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import KB, RE
from ..geometry import (DEG2RAD, ENTRY_MAX_ITERS, RAD2DEG, Z_REFRAC, LosData,
                        RayProfiles)
from . import ega_fused

LAUNCHES = 0        # launches of the tracer kernel
GEO_KEYS = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")


def check_inputs(prof: RayProfiles, geo: torch.Tensor, nlos: int) -> None:
    """Refuse what the kernel cannot read: a dtype other than float32 or
    float64, tensors on another device, shapes that disagree with z
    [R, L], a non-contiguous tensor, or NLOS < 3 (the tangent point reads
    three neighbouring points).  ``geo`` is the observation geometry
    [6, R] and ``prof.nlev`` int32, as :func:`trace_rays_cuda` passes
    them."""
    z = prof.z
    if not isinstance(z, torch.Tensor) or z.dim() != 2:
        raise ValueError("prof.z must be a [R, L] tensor")
    dt, dev = z.dtype, z.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the tracer kernel takes float32 or float64, "
                         f"got {dt}")
    R, L = z.shape
    G, W = prof.q.shape[1], prof.k.shape[1]
    if nlos < 3:
        raise ValueError(f"the tracer kernel needs NLOS >= 3, got {nlos}")
    for name, x, dtype, shape in (
            ("prof.z", z, dt, (R, L)), ("prof.p", prof.p, dt, (R, L)),
            ("prof.t", prof.t, dt, (R, L)), ("prof.q", prof.q, dt, (R, G, L)),
            ("prof.k", prof.k, dt, (R, W, L)),
            ("prof.nlev", prof.nlev, torch.int32, (R,)),
            ("prof.zmin", prof.zmin, dt, (R,)),
            ("prof.zmax", prof.zmax, dt, (R,)),
            ("obs geometry", geo, dt, (6, R))):
        ega_fused._check(name, x, dtype, shape, dev)


def trace_rays_cuda(prof: RayProfiles, obs_geo: dict, rayds: float,
                    raydz: float, refrac: bool, nlos: int):
    """(LosData, flag) of the rays of ``prof``, traced by the kernel on
    the card in the dtype of ``prof``: ``flag`` [R] int32 is 1 where the
    entry-point bisection did not converge (the plain version raises
    there; the caller reads the flag with its own device-to-host pull).
    Raises on anything :func:`check_inputs` refuses and on a failed
    launch; nothing falls back."""
    global LAUNCHES
    import ctypes

    from ._build import load_library

    dev, dt = prof.z.device, prof.z.dtype
    if dev.type != "cuda":
        raise ValueError(f"the tracer kernel runs on CUDA tensors, got {dev}")
    geo = torch.as_tensor(np.stack([np.asarray(obs_geo[k], np.float64)
                                    for k in GEO_KEYS])).to(dev, dt)
    prof = prof._replace(nlev=prof.nlev.to(dev, torch.int32))
    check_inputs(prof, geo, nlos)
    R, L = prof.z.shape
    G, W = prof.q.shape[1], prof.k.shape[1]

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)
    los = LosData(
        z=empty(R, nlos), lon=empty(R, nlos), lat=empty(R, nlos),
        p=empty(R, nlos), t=empty(R, nlos), q=empty(R, nlos, G),
        k=empty(R, nlos, W), ds=empty(R, nlos), u=empty(R, nlos, G),
        valid=empty(R, nlos, dtype=torch.bool),
        np_=empty(R, dtype=torch.int32), tsurf=empty(R), tpz=empty(R),
        tplon=empty(R), tplat=empty(R))
    flag = empty(R, dtype=torch.int32)
    if R == 0:
        return los, flag
    lib = load_library()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    events = ega_fused.LAUNCH_EVENTS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        rc = lib.jt_trace_rays(
            *(ptr(x) for x in (prof.z, prof.p, prof.t, prof.q, prof.k,
                               prof.nlev, prof.zmin, prof.zmax, geo)),
            *(ptr(x) for x in los), ptr(flag),
            R, L, G, W, nlos, float(rayds), float(raydz), int(bool(refrac)),
            ENTRY_MAX_ITERS, RE, DEG2RAD, RAD2DEG, KB, Z_REFRAC,
            int(dt == torch.float64), ctypes.c_void_p(stream.cuda_stream))
        if events is not None:
            ev[1].record(stream)
            events.append(("jt_trace_rays", *ev))
    if rc != 0:
        raise RuntimeError(f"jt_trace_rays: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    return los, flag
