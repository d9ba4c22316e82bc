"""The ray tracer's CUDA kernel (``csrc/trace_rays.cu``): the counterpart
of the JAX package's jitted ``_trace_rays_jit`` (``jurassic_tpu/
geometry.py:486-498``, ``jax.jit`` of ``vmap(_trace_single)``).

One warp traces one ray, entry-point bisection, NLOS steps, tangent
point, trapezoid rule and column densities, in the order of operations
of the plain version ``geometry.trace_rays_ref``, with the ray's profiles
and the step chain's records in its block's shared memory
(:func:`shared_memory_bytes`).  :func:`trace_rays_cuda` checks the
tensors, allocates the outputs and launches the kernel on the current
stream; ``geometry.trace_rays`` dispatches to it for CUDA tensors.
``LAUNCHES`` counts its launches.
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
SMEM_LIMIT = 232448  # shared memory one block may use on the H100 (227 KB)


def shared_memory_bytes(L: int, G: int, W: int, nlos: int,
                        dtype: torch.dtype,
                        entry: str = "jt_trace_smem_bytes") -> int:
    """Bytes of shared memory the kernel gives a ray's block at these sizes
    (its profiles z, p, t, q, k and the step chain's records; the
    kernel's own count, ``entry``: ``jt_trace_smem_bytes`` of the tracer
    kernel, ``jt_trace_jvp_smem_bytes`` the larger block of the Jacobian's
    record and tangent kernels).  Raises ValueError where they exceed
    ``SMEM_LIMIT``: the kernels read nothing of a ray's profiles and
    records from global memory."""
    import ctypes

    from ._build import load_library

    n = ctypes.c_longlong()
    rc = getattr(load_library(), entry)(
        L, G, W, nlos, int(dtype == torch.float64), ctypes.addressof(n))
    if rc != 0:
        raise ValueError(f"{entry} refused L = {L}, G = {G}, W = {W}, "
                         f"NLOS = {nlos}")
    if n.value > SMEM_LIMIT:
        raise ValueError(
            f"the tracer kernels keep a ray's profiles and step records in "
            f"shared memory: {n.value} bytes at L = {L}, G = {G}, W = {W}, "
            f"NLOS = {nlos} in {dtype} exceed one block's {SMEM_LIMIT} "
            f"bytes (227 KB)")
    return n.value


def check_inputs(prof: RayProfiles, geo: torch.Tensor, nlos: int) -> None:
    """Refuse what the kernel cannot read: a dtype other than float32 or
    float64, tensors on another device, shapes that disagree with z
    [R, L], a non-contiguous tensor, or NLOS < 3 (the tangent point reads
    three neighbouring points).  ``geo`` is the observation geometry
    [6, R] and ``prof.nlev`` int32, as :func:`trace_rays_cuda` passes
    them.  A ray's shared memory is :func:`shared_memory_bytes`'s to
    refuse."""
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
    Raises on anything :func:`check_inputs` or
    :func:`shared_memory_bytes` refuses and on a failed launch; nothing
    falls back."""
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
    shared_memory_bytes(L, G, W, nlos, dt)

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
        args = (*(ptr(x) for x in (prof.z, prof.p, prof.t, prof.q, prof.k,
                                   prof.nlev, prof.zmin, prof.zmax, geo)),
                *(ptr(x) for x in los), ptr(flag),
                R, L, G, W, nlos, float(rayds), float(raydz),
                int(bool(refrac)), ENTRY_MAX_ITERS, RE, DEG2RAD, RAD2DEG,
                KB, Z_REFRAC, int(dt == torch.float64),
                ctypes.c_void_p(stream.cuda_stream))
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        rc = lib.jt_trace_rays(*args)
        if events is not None:
            ev[1].record(stream)
            events.append(("jt_trace_rays", *ev))
    if rc != 0:
        raise RuntimeError(f"jt_trace_rays: kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    return los, flag


def registers(dtype, refrac: bool) -> tuple:
    """(registers, local bytes) of the tracer kernel's instantiation a
    launch in ``dtype`` and ``refrac`` takes, from the library
    (``jt_trace_registers``)."""
    import ctypes

    from ._build import load_library
    out = (ctypes.c_int * 2)()
    rc = load_library().jt_trace_registers(int(dtype == torch.float64),
                                           int(bool(refrac)), out)
    if rc != 0:
        raise RuntimeError(f"jt_trace_registers failed (cudaError {rc})")
    return out[0], out[1]


FAST_OPS_FIELDS = ("sqrt_in_range", "sqrt_differ", "rcp_in_range",
                   "rcp_differ", "div_in_range", "div_differ")


def fast_ops_check(n_div: int = 1 << 30, seed: int = 0,
                   device="cuda") -> dict:
    """The tracer kernel's branch-free float sqrt, reciprocal and division
    (``Ops<float, false>`` in ``csrc/trace_rays.cu``) against the
    operations themselves on the card: over every float for sqrt and the
    reciprocal, over ``n_div`` random pairs for division.  Returns the
    counts of inputs in each fast path's range and of those where its
    result differs in any bit (``FAST_OPS_FIELDS``); the kernel is bit for
    bit its plain version only where every ``*_differ`` is 0."""
    import ctypes

    from ._build import load_library

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the check runs on a CUDA device, got {dev}")
    counts = torch.zeros(len(FAST_OPS_FIELDS), dtype=torch.int64,
                         device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.jt_trace_fast_ops_check(
            ctypes.c_void_p(counts.data_ptr()), n_div, seed,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"jt_trace_fast_ops_check: launch failed "
                           f"(cudaError {rc})")
    return dict(zip(FAST_OPS_FIELDS, counts.tolist()))
