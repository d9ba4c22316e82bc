"""The RT pass on the card (``csrc/ega_rt.cu``): the counterpart of the
JAX package's jitted ``rt_integrate`` scan (``jurassic_tpu/forward.py:
99-176``) on the exact tables (``ega_eps_exact``, ``jurassic_tpu/ops/
ega.py:82``) or the fast ones (``ega_eps_fast``, ``:171``).

:func:`rt_integrate_cuda` gives ``forward.rt_integrate``'s (rad, tau),
surface and brightness epilogue included, from one kernel launch on the
current stream: what ``ForwardModel.integrate`` runs on a CUDA model
under ``KERNEL = exact|jax|fast`` and under ``auto`` where the tables'
axes are not channel-uniform.  Its plain version is the eager loop
``forward.rt_integrate``, which ``ForwardModel.integrate_eager`` keeps
running (the card's float64 oracle stays independent of the kernel).
``LAUNCHES`` counts its launches; ``ega_fused.LAUNCH_EVENTS`` records
CUDA events around each (``jt_ega_rt``).
"""
from __future__ import annotations

import torch

from ..geometry import LosData
from .continua import ContinuaCoeffs
from .ega import EgaDeviceTables, FastDeviceTables
from .ega_jvp import _launch, _library, _stream, consts, kernel_inputs

LAUNCHES = 0    # launches of the RT kernel


def registers(uniform: bool, exact: bool, dtype) -> int:
    """Registers of the instantiation a call launches on tables with
    (``uniform``) or without channel-uniform axes, exact or fast, in
    ``dtype`` (``jt_ega_rt_registers``)."""
    import ctypes
    out = ctypes.c_int()
    rc = _library().jt_ega_rt_registers(
        int(bool(uniform)), int(bool(exact)), int(dtype == torch.float64),
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"jt_ega_rt_registers failed (cudaError {rc})")
    return out.value


def launch_shape(R: int, D: int, G: int, uniform: bool, exact: bool,
                 dtype, record: bool = False) -> dict:
    """The launch shape the library takes for a call of the RT kernel (or,
    with ``record``, the record kernel of ``ops.ega_jvp``) at R rays, D
    channels and G gases (``jt_ega_rt_shape``): resident blocks a
    multiprocessor, threads a block, rays a group, multiprocessors, the
    groups (one block each), the threads a (ray, channel) lane
    (``gas_threads``: G for the fast RT kernel, a thread a gas; 1 where a
    thread carries all its gases), the lanes a pass and the passes a block
    takes over its group's lanes, the resident slots, the rounds of
    resident blocks the groups take (ceil(groups / slots)) and the groups
    a slot."""
    import ctypes
    out = (ctypes.c_int * 8)()
    rc = _library().jt_ega_rt_shape(
        int(bool(record)), R, D, G, int(bool(uniform)), int(bool(exact)),
        int(dtype == torch.float64), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"jt_ega_rt_shape failed (cudaError {rc})")
    per_sm, bd, nr, n_sm, groups, gas_threads, lanes, passes = out
    slots = per_sm * n_sm
    return {"blocks_per_sm": per_sm, "threads": bd, "rays_per_block": nr,
            "sms": n_sm, "blocks": groups, "groups": groups,
            "gas_threads": gas_threads, "lanes_per_pass": lanes,
            "passes": passes, "slots": slots,
            "rounds": -(-groups // slots) if slots else None,
            "groups_per_slot": groups / slots if slots else None}


def rt_integrate_cuda(tbl: EgaDeviceTables | FastDeviceTables, sr, st, nu,
                      cc: ContinuaCoeffs, window, los: LosData, flags,
                      ig_co2: int, ig_h2o: int, bbt: bool):
    """``forward.rt_integrate(tbl, sr, st, nu, cc, window, los, los.tsurf,
    flags, ig_co2, ig_h2o, use_fast, bbt)`` (``use_fast`` by the tables'
    kind) as ``RtOut`` [R, D] in the dtype of ``los``, from one launch of
    the RT kernel.  Raises on tensors off the card or of another dtype or
    shape than the LOS's and the tables', on a gas count of 0, and on a
    failed launch; nothing falls back."""
    global LAUNCHES
    import ctypes

    from ..forward import RtOut
    (dev, dt, R, S, G, W, kt, ccr, win, sr_, st_, nu_) = kernel_inputs(
        tbl, sr, st, nu, cc, window, los)
    tabs, P, T, K, exact, uniform, hint, D = kt
    # bit 0: monotone eps rows; bit 1: axes a hint may search (fast)
    hints = int(hint) | (2 if not exact and tbl.axes_monotone else 0)
    out = RtOut(rad=torch.empty((R, D), dtype=dt, device=dev),
                tau=torch.empty((R, D), dtype=dt, device=dev))
    if R == 0:
        return out
    bits = sum(1 << i for i, f in enumerate(flags) if f)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        _launch("jt_ega_rt", _library().jt_ega_rt,
                *(ptr(x) for x in (*tabs, ccr, win, sr_, st_, nu_, los.p,
                                   los.t, los.ds, los.q, los.k, los.u,
                                   los.valid, los.tsurf, out.rad, out.tau)),
                R, S, G, W, D, P, T, K, st_.shape[0], bits, int(ig_co2),
                int(ig_h2o), int(bool(bbt)), int(uniform), hints,
                int(exact), *consts(), int(dt == torch.float64),
                _stream(dev))
    LAUNCHES += 1
    return out
