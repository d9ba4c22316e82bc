"""Prepare an atmospheric data file from climatological data.

CLI mirror of climatology.c:
``python -m jurassic_torch.cli.climatology <ctl> <atm> [NAME value ...]``.

The port's own copy of ``jurassic_tpu/cli/climatology.py``.
"""
from __future__ import annotations

import sys

import numpy as np

from .._compat_random import ref_uniform_sequence
from ..climatology import climatology
from ..config import NP_MAX
from ..io_tab import Atm, write_atm
from ._common import cli_main, die, load_ctl


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, s = load_ctl(argv, 3, "<ctl> <atm>")
    t0 = s.scan_float("T0", -1, "0")
    t1 = s.scan_float("T1", -1, "0")
    dt = s.scan_float("DT", -1, "1")
    z0 = s.scan_float("Z0", -1, "0")
    z1 = s.scan_float("Z1", -1, "90")
    dz = s.scan_float("DZ", -1, "1")
    rand = s.scan_int("RAND", -1, "0")

    times, zs = [], []
    t = t0
    while t <= t1:
        z = z0
        while z <= z1:
            times.append(t)
            zs.append(z)
            if len(times) >= NP_MAX:
                die("Too many atmospheric grid points!")
            z += dz
        t += dt

    atm = Atm.zeros(len(times), ctl.ng, ctl.nw)
    atm.time[:] = times
    atm.z[:] = zs
    climatology(ctl, atm)

    if rand:
        # Random perturbations per time block (climatology.c:66-78)
        rng = ref_uniform_sequence()
        dpress = dtemp = 0.0
        for ip in range(atm.npts):
            if ip == 0 or atm.time[ip - 1] != atm.time[ip]:
                dpress = 0.05 - 0.1 * next(rng)
                dtemp = 30.0 - 60.0 * next(rng)
            atm.p[ip] *= 1.0 + dpress
            atm.t[ip] += dtemp
    write_atm(argv[2], ctl, atm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
