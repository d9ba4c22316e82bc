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


def perturbed_axes(ft, seed: int = 0):
    """FastTables ``ft`` with each channel's own p and T axes: every p
    node moved by up to 1e-3 of itself, every T node by up to 0.3 K
    (seeded; the rows stay ascending on the synthetic grids), so that no
    two channels share a bracket search (``ops.ega.axes_uniform`` is
    False) -- the RT tangent kernel's per-channel instantiation."""
    rng = np.random.default_rng(seed)
    p = ft.p * (1.0 + 1e-3 * rng.uniform(-1.0, 1.0, ft.p.shape))
    t = ft.t + 0.3 * rng.uniform(-1.0, 1.0, ft.t.shape)
    return ft._replace(p=p, t=t)


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


# (L, G, W, R, NLOS, grid) of the tracer kernel's edge shapes: level
# counts at and around the warp's 32 (a vote chunk more or less), one
# level (a one-level window) and two, gas and window counts 0, 1 and 30,
# one ray, one warp's count and one more, the flagship's count; altitude
# grids with tied levels and non-monotone ones; and a ray whose shared
# memory exceeds the 48 KB a block has without opting in (NLOS 2000)
TRACE_EDGE_SHAPES = (
    (1, 1, 1, 33, 120, "ascending"),
    (2, 0, 1, 33, 120, "ties"),
    (2, 1, 0, 1, 33, "nonmonotone"),
    (31, 30, 0, 1, 128, "ascending"),
    (31, 1, 1, 33, 120, "nonmonotone"),
    (32, 1, 1, 33, 120, "nonmonotone"),
    (32, 30, 1, 1084, 120, "ties"),
    (33, 0, 0, 1084, 120, "ascending"),
    (33, 1, 1, 33, 33, "ties"),
    (64, 30, 1, 33, 128, "ties"),
    (64, 4, 1, 1, 120, "nonmonotone"),
    (65, 1, 0, 33, 120, "nonmonotone"),
    (65, 0, 1, 33, 128, "ascending"),
    (92, 30, 1, 1084, 120, "ascending"),
    (92, 0, 1, 1, 120, "nonmonotone"),
    (92, 1, 0, 33, 120, "ties"),
    (92, 30, 1, 33, 2000, "ties"),
)


def trace_edge_case(L: int, G: int, W: int, R: int, nlos: int, grid: str,
                    seed: int = 0):
    """(ctl, profiles, obs geometry) of an edge shape of the tracer kernel
    (``TRACE_EDGE_SHAPES``), made from ``seed``: R rays of the flagship's
    limb scan (evenly spaced), RAYDS 50 / RAYDZ 5 / REFRAC 1, and per-ray
    profiles of L levels over 0-80 km (float64 CPU tensors, padded as
    ``geometry.build_ray_profiles`` pads: every third ray's window holds
    up to three levels fewer).  ``grid`` "ties" repeats a level of every
    other ray's window at a few places, "nonmonotone" swaps a few
    neighbouring levels of every other ray's; "ascending" does neither.
    A zero pressure at one level of every fifth ray takes the
    interpolation's linear fallback."""
    from .geometry import RayProfiles
    if grid not in ("ascending", "ties", "nonmonotone"):
        raise ValueError(f"unknown grid {grid!r}")
    rng = np.random.default_rng(seed)
    ctl = synthetic_ctl(ng=4, nd=9)
    ctl.nlos, ctl.rayds, ctl.raydz, ctl.refrac = nlos, 50.0, 5.0, 1
    scan = limb_geometry(z0=3.0, z1=68.0, dz=0.06)
    rows = np.linspace(0, scan.nr - 1, R).astype(int)
    geo = {k: np.asarray(getattr(scan, k), np.float64)[rows]
           for k in ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")}
    nlev = np.full(R, L)
    nlev[::3] = np.maximum(1, L - rng.integers(0, 4, R))[::3]
    z = np.zeros((R, L))
    for r in range(R):
        n = nlev[r]
        zr = np.sort(rng.uniform(0.0, 80.0, n))
        if n > 1:
            zr[0], zr[-1] = 0.0, 80.0
        if r % 2 == 0 and n > 1 and grid == "ties":
            for j in rng.integers(0, n - 1, 1 + n // 10):
                zr[j + 1] = zr[j]
        if r % 2 == 0 and n > 1 and grid == "nonmonotone":
            for j in rng.integers(0, n - 1, 1 + n // 10):
                zr[[j, j + 1]] = zr[[j + 1, j]]
        z[r, :n] = zr
        z[r, n:] = zr[-1] + np.arange(1, L - n + 1) * 1e6
    last = np.minimum(np.arange(L)[None, :], nlev[:, None] - 1)
    live = np.take_along_axis(z, last, axis=1)
    p = 1013.25 * np.exp(-live / 7.0) * rng.uniform(0.9, 1.1, (R, L))
    p[::5, rng.integers(0, L)] = 0.0
    t = rng.uniform(180.0, 300.0, (R, L))
    q = rng.uniform(0.0, 1e-3, (R, G, L))
    k = rng.uniform(0.0, 1e-3, (R, W, L))
    # the padding repeats the last level's values
    p, t = (np.take_along_axis(a, last, axis=1) for a in (p, t))
    q = np.take_along_axis(q, last[:, None, :].repeat(G, 1), axis=2)
    k = np.take_along_axis(k, last[:, None, :].repeat(W, 1), axis=2)
    win = np.arange(L)[None, :] < nlev[:, None]
    zmin = np.where(win, z, np.inf).min(axis=1)
    zmax = np.where(win, z, -np.inf).max(axis=1)
    ten = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64))
    prof = RayProfiles(z=ten(z), p=ten(p), t=ten(t), q=ten(q), k=ten(k),
                       nlev=torch.as_tensor(nlev, dtype=torch.int64),
                       zmin=ten(zmin), zmax=ten(zmax),
                       short=bool((nlev < 2).any()))
    return ctl, prof, geo


def profiles_to(prof, dtype, device):
    """``prof`` with its float tensors in ``dtype`` on ``device``."""
    return prof._replace(**{
        f: getattr(prof, f).to(device, dtype)
        for f in ("z", "p", "t", "q", "k", "zmin", "zmax")},
        nlev=prof.nlev.to(device))
