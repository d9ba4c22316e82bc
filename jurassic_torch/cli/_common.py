"""Shared helpers for the port's CLI tools (reference-compatible argv
handling, ``jurassic_tpu/cli/_common.py`` without the JAX platform
configuration).

The execution device follows the ctl's ``USEGPU``/``USETPU`` value
(``device.resolve_device``): ``1`` requires CUDA, ``0`` pins the CPU,
``-1`` takes CUDA when present.  Append ``USEGPU 1`` to any invocation to
require the GPU.
"""
from __future__ import annotations

import sys
from typing import Sequence

from jurassic_tpu.config import Ctl, CtlError, CtlScanner, read_ctl


def die(msg: str) -> None:
    print(f"\nError: {msg}\n")
    sys.exit(1)


def cli_main(fn):
    """Wrap a CLI entry point: user-input errors and modes the port does
    not have yet exit(1) with a clean message instead of a traceback."""
    def wrapper(argv=None):
        try:
            return fn(argv)
        except (CtlError, ValueError, OSError, NotImplementedError) as e:
            die(str(e))
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def load_ctl(argv: Sequence[str], min_args: int,
             usage: str) -> tuple[Ctl, CtlScanner]:
    if len(argv) < min_args:
        die(f"Give parameters: {usage}")
    ctl = read_ctl(argv)
    scanner = CtlScanner(argv)
    scanner.verbose = False
    return ctl, scanner
