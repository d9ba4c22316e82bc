"""Device and dtype policy.

* ``USETPU``/``USEGPU`` follow the reference's useGPU semantics
  (CPUdrivers.c:179-193, the JAX driver's forward.py:335-358):
  ``1`` requires a CUDA device and raises without one, ``0`` pins the
  CPU, ``-1`` (the default) takes CUDA when present, else the CPU.
* The ray tracer runs in float64 on the CPU (the reference's double
  precision, as the JAX tests run it under x64) and in float32 on CUDA
  (as the accelerator path of the JAX package runs it).
* The radiative-transfer pass is float32 on every device, as the fused
  kernel computes it.
"""
from __future__ import annotations

import torch

RT_DTYPE = torch.float32


def resolve_device(usegpu: int = -1, device=None) -> torch.device:
    """The execution device for a USETPU/USEGPU value.

    An explicit ``device`` wins, but must agree with a pinned policy:
    ``usegpu = 1`` refuses a non-CUDA device and ``usegpu = 0`` a CUDA
    one."""
    if device is not None:
        dev = torch.device(device)
        if usegpu >= 1 and dev.type != "cuda":
            raise ValueError(f"USEGPU = 1 (required) but device is '{dev}'")
        if usegpu == 0 and dev.type != "cpu":
            raise ValueError(f"USEGPU = 0 (never) but device is '{dev}'")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise ValueError(f"device '{dev}' requested but CUDA is not "
                             "available")
        return dev
    if usegpu == 0:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    if usegpu >= 1:
        raise ValueError(
            "USEGPU = 1 (required) but no CUDA device is available (the "
            "reference aborts the same way, CPUdrivers.c:185-188)")
    return torch.device("cpu")


def tracer_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on CUDA."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
