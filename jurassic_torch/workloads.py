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

import numpy as np
import torch

from .geometry import LosData
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


def scrambled_los(los: LosData, seed: int = 0) -> LosData:
    """``los`` with its rays in a random order (from ``seed``), every
    seventh ray emptied (``np_`` = 0, no valid segment) and every seventh
    given the full segment budget (``np_`` = NLOS, the tail invalid).
    Neighbouring rays then bracket different table cells and end at
    different segments: the batch on which what the fused kernels share
    between the rays of a block, or remember from the last segment, does
    not hold."""
    R, S = los.ds.shape
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(R))
    perm = perm.to(los.ds.device)
    los = LosData(*(f[perm] for f in los))
    np_, valid = los.np_.clone(), los.valid.clone()
    np_[1::7] = 0
    valid[1::7] = False
    np_[2::7] = S
    return los._replace(np_=np_, valid=valid)


# branches of the tracer that the limb scans of the goldens do not all reach
TRACE_BRANCHES = ("refrac0", "raydz0", "observer_inside", "never_traced",
                  "one_level")


def trace_branch(name: str, ctl, atm, obs) -> None:
    """Set branch ``name`` of the tracer up in place on a limb scan's
    ``ctl``, ``atm`` and ``obs`` (of either package: only field names are
    read and written):

    * ``refrac0``: REFRAC 0, straight rays;
    * ``raydz0``: RAYDZ 0, every step RAYDS long;
    * ``observer_inside``: the observer at 70 km, inside the atmosphere,
      so no ray bisects its entry point;
    * ``never_traced``: every other view point 5 km above the top of the
      atmosphere, so those rays are never traced and keep it as their
      tangent point;
    * ``one_level``: every other ray's time past the atmosphere's last,
      so its window holds one level (``geometry._take_lo``)."""
    if name == "refrac0":
        ctl.refrac = 0
    elif name == "raydz0":
        ctl.raydz = 0.0
    elif name == "observer_inside":
        obs.obsz[:] = 70.0
    elif name == "never_traced":
        obs.vpz[1::2] = float(np.max(atm.z)) + 5.0
    elif name == "one_level":
        obs.time[1::2] = float(np.max(atm.time)) + 1.0
    else:
        raise ValueError(f"unknown tracer branch {name!r}")


# the goldens whose geometries the tracer's card checks trace, and the
# branches of a small limb scan beside them
TRACE_GOLDENS = ("limb", "nadir", "ega", "fov", "gas30")
# REFRAC 0 is the flagship pencil case's
TRACE_SMALL_BRANCHES = TRACE_BRANCHES[1:]


def trace_cases(goldens) -> dict:
    """{name: (ctl, atm, obs)} on which the tracer kernel is held to its
    plain version: the flagship (REFRAC 1) and its pencil geometry
    (REFRAC 0 on the flat dummy profiles of ``ForwardModel.
    pencil_trace``), the geometries of ``TRACE_GOLDENS`` under the
    directory ``goldens`` (tests/goldens of the repository), and a small
    limb scan (37 rays, NLOS 120) in each of ``TRACE_SMALL_BRANCHES``;
    hydrostatics applied as ``formod`` applies it."""
    from pathlib import Path

    from .config import read_ctl
    from .forward import pencil_geometry
    from .geometry import hydrostatic_atm
    from .io_tab import read_atm, read_obs
    cases = {}
    ctl, _ft, atm, obs = flagship()
    hydrostatic_atm(ctl, atm)
    cases["flagship"] = (ctl, atm, obs)
    ctl0, _ft, atm0, obs0 = flagship()
    ctl0.refrac = 0
    hydrostatic_atm(ctl0, atm0)
    cases["flagship pencil"] = (*pencil_geometry(ctl0, atm0), obs0)
    for case in TRACE_GOLDENS:
        d = Path(goldens) / case
        c = read_ctl(["formod", str(next(d.glob("*.ctl"))), "o", "a", "r"],
                     verbose=False)
        a = read_atm(d / "atm.tab", c)
        hydrostatic_atm(c, a)
        cases[case] = (c, a, read_obs(d / "obs.tab", c))
    for branch in TRACE_SMALL_BRANCHES:
        c, _ft, a, o = small_limb(ng=4, nd=9, nr=37, nlos=120)
        trace_branch(branch, c, a, o)
        hydrostatic_atm(c, a)
        cases[branch] = (c, a, o)
    return cases
