"""Observation-geometry generators for limb and nadir sounders.

Mirrors limb.c:48-64 and nadir.c:50-58, including the C float-accumulation
loops (``for (t = t0; t <= t1; t += dt)``) so the generated ray counts and
grids are bit-identical to the reference tools.  Copy of
``jurassic_tpu/models/geometry_gen.py``.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import Ctl, NR_MAX
from ..constants import RE
from ..io_tab import Obs


def _frange(x0: float, x1: float, dx: float):
    """C-style inclusive float loop: for (x = x0; x <= x1; x += dx)."""
    x = x0
    while x <= x1:
        yield x
        x += dx


def limb_geometry(t0=0.0, t1=0.0, dt=1.0, obsz=780.0,
                  z0=3.0, z1=68.0, dz=1.0, nd: int = 0) -> Obs:
    """Limb scan: observer at ``obsz`` km, tangent altitudes z0..z1 step dz.

    View-point latitude from the limb-viewing geometry
    vplat = acos((RE+z)/(RE+obsz)) (limb.c:56)."""
    rows = []
    for t in _frange(t0, t1, dt):
        for z in _frange(z0, z1, dz):
            rows.append((t, obsz, z, 180.0 / math.pi
                         * math.acos((RE + z) / (RE + obsz))))
    if len(rows) > NR_MAX:
        raise ValueError(f"Too many rays! max is {NR_MAX}")
    obs = Obs.zeros(len(rows), nd)
    for ir, (t, oz, z, vplat) in enumerate(rows):
        obs.time[ir] = t
        obs.obsz[ir] = oz
        obs.vpz[ir] = z
        obs.vplat[ir] = vplat
    return obs


def nadir_geometry(t0=0.0, t1=0.0, dt=1.0, obsz=700.0,
                   lat0=-8.01, lat1=8.01, dlat=0.18, nd: int = 0) -> Obs:
    """Nadir scan over latitudes; view point at the surface (nadir.c:51-58)."""
    rows = []
    for t in _frange(t0, t1, dt):
        for lat in _frange(lat0, lat1, dlat):
            rows.append((t, obsz, lat))
    if len(rows) >= NR_MAX:
        raise ValueError("Too many rays!")
    obs = Obs.zeros(len(rows), nd)
    for ir, (t, oz, lat) in enumerate(rows):
        obs.time[ir] = t
        obs.obsz[ir] = oz
        obs.vplat[ir] = lat
    return obs
