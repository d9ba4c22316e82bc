"""Synthetic limb workloads of the port, built from its own copies of the
NumPy generators (``models.synthetic``, ``models.geometry_gen``).

``flagship`` is the configuration ``bench.py:45-64`` times: synthetic
40 x 30 x 224 tables, 4 gases (CO2, H2O, O3, F11) with all four
continua switched on, 100 channels over 700-1200 cm^-1, the 1084-ray
limb scan from 3 to 68 km at 0.06 km, reference ray-tracing defaults
RAYDS = 10, RAYDZ = 0.5 and the NLOS = 400 step budget.
``tests/test_torch_workloads.py`` holds it equal to ``bench.build_workload()``.
"""
from __future__ import annotations

from .models.geometry_gen import limb_geometry
from .models.synthetic import (limb_workload, synthetic_atm, synthetic_ctl,
                               synthetic_fast_tables)


def flagship():
    """(ctl, fast tables, atm, obs) of the flagship workload."""
    ctl = synthetic_ctl(ng=4, nd=100)
    ctl.nlos = 400
    ctl.rayds, ctl.raydz = 10.0, 0.5
    ft = synthetic_fast_tables(ctl)
    atm = synthetic_atm(ctl)
    obs = limb_geometry(z0=3.0, z1=68.0, dz=0.06, nd=ctl.nd)
    return ctl, ft, atm, obs


def small_limb(ng: int, nd: int, nr: int, nlos: int = 48,
               rayds: float = 50.0, raydz: float = 5.0):
    """(ctl, fast tables, atm, obs) of a small synthetic limb scan on
    8 p x 5 T x 48 u tables with all four continua switched on (the
    shape of ``tests/test_pallas_kernel.py:111-140``)."""
    ctl = synthetic_ctl(ng=ng, nd=nd)
    ctl.nlos = nlos
    ctl.rayds, ctl.raydz = rayds, raydz
    ctl.ctm_co2 = ctl.ctm_h2o = ctl.ctm_n2 = ctl.ctm_o2 = 1
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=48)
    return ctl, ft, synthetic_atm(ctl), limb_workload(ctl, nr)
