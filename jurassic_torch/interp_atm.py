"""Atmosphere interpolation methods: 1D profile, 2D satellite track,
3D Lagrangian grid (intpol_atm_geo/_1d/_2d/_3d, jurassic.c:685-804).

The port's own copy of ``jurassic_tpu/interp_atm.py`` (host NumPy,
held equal to the original by ``tests/test_torch_host_copies.py``).  The
reference's execution drivers support only IP=1 (the device
interpolator asserts ip == 1, jr_common.h:573,581); IP=2/3 are library
interpolators used by the upstream retrieval tooling.  Here they back
the library API and the host "pencil" forward path
(:meth:`jurassic_torch.forward.ForwardModel.pencil_trace`).

All functions are vectorized over the query points (z0/lon0/lat0 may be
arrays), unlike the reference's per-point C calls, but reproduce its
formulas exactly: nearest-2-profiles chord blending for 2D
(jurassic.c:747-760) and the (1 - dz/cz)(rm2 - dx2)/(rm2 + dx2)
distance weighting for 3D (jurassic.c:786-795).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .config import Ctl
from .constants import RE
from .io_tab import Atm

DEG2RAD = np.pi / 180.0


def _geo2cart0(lon, lat):
    """Cartesian coordinates on the sphere surface (geo2cart with alt=0,
    jurassic.c uses it for horizontal distances only)."""
    clat = np.cos(np.asarray(lat) * DEG2RAD)
    return np.stack([RE * clat * np.cos(np.asarray(lon) * DEG2RAD),
                     RE * clat * np.sin(np.asarray(lon) * DEG2RAD),
                     RE * np.sin(np.asarray(lat) * DEG2RAD)], axis=-1)


def _locate(zgrid: np.ndarray, z0):
    """locate() for ascending grids (jurassic.c:779-style bisection):
    index i in [0, n-2] with z[i] <= z0 < z[i+1], clamped."""
    i = np.searchsorted(zgrid, z0, side="right") - 1
    return np.clip(i, 0, zgrid.size - 2)


def _lin(x0, y0, x1, y1, x):
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _exp_interp(x0, y0, x1, y1, x):
    """EXP(): exponential in y with linear fallback (jurassic.h:99-104)."""
    ok = (y0 > 0) & (y1 > 0)
    y0s = np.where(ok, y0, 1.0)
    y1s = np.where(ok, y1, 1.0)
    e = y0s * np.exp(np.log(y1s / y0s) / (x1 - x0) * (x - x0))
    return np.where(ok, e, _lin(x0, y0, x1, y1, x))


def intpol_atm_1d(ctl: Ctl, atm: Atm, idx0: int, n: int, z0):
    """Vertical interpolation within atm[idx0:idx0+n]
    (intpol_atm_1d, jurassic.c:694-701).  Returns (p, t, q[G,...],
    k[W,...]) at z0 (scalar or array)."""
    z = atm.z[idx0:idx0 + n]
    i = _locate(z, z0) + idx0
    p = _exp_interp(atm.z[i], atm.p[i], atm.z[i + 1], atm.p[i + 1], z0)
    t = _lin(atm.z[i], atm.t[i], atm.z[i + 1], atm.t[i + 1], z0)
    q = _lin(atm.z[i], atm.q[:, i], atm.z[i + 1], atm.q[:, i + 1], z0)
    k = _lin(atm.z[i], atm.k[:, i], atm.z[i + 1], atm.k[:, i + 1], z0)
    return p, t, q, k


class TrackProfiles(NamedTuple):
    """2D-mode profile decomposition (the atm->init static block,
    jurassic.c:710-728): profile start indices, lengths, and surface
    Cartesian anchors."""

    idx: np.ndarray   # [NX] int
    nz: np.ndarray    # [NX] int
    x1: np.ndarray    # [NX, 3]


def split_profiles(atm: Atm, dlat: float = 10.0) -> TrackProfiles:
    """Split atm into constant-(lon,lat) profiles with the reference's
    validation (jurassic.c:726-728)."""
    change = np.nonzero(
        (np.diff(atm.lon) != 0) | (np.diff(atm.lat) != 0))[0] + 1
    idx = np.concatenate([[0], change])
    nz = np.diff(np.concatenate([idx, [atm.npts]]))
    if np.any(nz <= 1):
        raise ValueError(
            "Cannot identify profiles. Check ordering of data points!")
    lats = atm.lat[idx]
    if np.any(np.abs(np.diff(lats)) > dlat):
        raise ValueError("Distance of profiles is too large!")
    return TrackProfiles(idx=idx, nz=nz,
                         x1=_geo2cart0(atm.lon[idx], atm.lat[idx]))


def intpol_atm_2d(ctl: Ctl, atm: Atm, z0, lon0, lat0,
                  tp: TrackProfiles | None = None):
    """Satellite-track interpolation (intpol_atm_2d, jurassic.c:703-760):
    nearest two profiles within 10 deg latitude, vertical 1D in each,
    then chord-parameter blending r = r0/(r0+r1)."""
    if tp is None:
        tp = split_profiles(atm)
    z0 = np.atleast_1d(np.asarray(z0, float))
    lon0 = np.broadcast_to(np.asarray(lon0, float), z0.shape)
    lat0 = np.broadcast_to(np.asarray(lat0, float), z0.shape)
    x0 = _geo2cart0(lon0, lat0)                          # [N, 3]
    dh_all = np.sum((x0[:, None, :] - tp.x1[None, :, :]) ** 2, axis=-1)
    # latitude gate (jurassic.c:738): excluded profiles can't be chosen.
    # The reference leaves ix0 = ix1 = 0 (an undefined 0/0 blend) when the
    # gate excludes every profile; here the query falls back to the
    # ungated nearest profile instead, the well-defined limit.
    gate = np.abs(lat0[:, None] - atm.lat[tp.idx][None, :]) <= 10.0
    dh = np.where(gate, dh_all, np.inf)
    allout = ~gate.any(axis=1)
    dh[allout] = dh_all[allout]
    order = np.argsort(dh, axis=1, kind="stable")
    ix0, ix1 = order[:, 0], order[:, 1 % order.shape[1]]
    dh0 = np.take_along_axis(dh, ix0[:, None], 1)[:, 0]
    dh1 = np.take_along_axis(dh, ix1[:, None], 1)[:, 0]
    # a lone in-gate candidate pairs with itself -> degenerate blend
    # (x2 = 0) resolved to r = 0 below
    lone = ~np.isfinite(dh1)
    ix1 = np.where(lone, ix0, ix1)
    dh1 = np.where(lone, dh0, dh1)

    out0 = [np.empty_like(z0) for _ in range(2)]
    q0 = np.empty((ctl.ng,) + z0.shape)
    k0 = np.empty((ctl.nw,) + z0.shape)
    out1 = [np.empty_like(z0) for _ in range(2)]
    q1 = np.empty((ctl.ng,) + z0.shape)
    k1 = np.empty((ctl.nw,) + z0.shape)
    for ix in np.unique(np.concatenate([ix0, ix1])):
        i0, n = int(tp.idx[ix]), int(tp.nz[ix])
        m0, m1 = ix0 == ix, ix1 == ix
        if m0.any():
            p, t, q, k = intpol_atm_1d(ctl, atm, i0, n, z0[m0])
            out0[0][m0], out0[1][m0], q0[:, m0], k0[:, m0] = p, t, q, k
        if m1.any():
            p, t, q, k = intpol_atm_1d(ctl, atm, i0, n, z0[m1])
            out1[0][m1], out1[1][m1], q1[:, m1], k1[:, m1] = p, t, q, k

    # horizontal blend (jurassic.c:749-760)
    x1a = tp.x1[ix0]
    x1b = tp.x1[ix1]
    x2 = np.sum((x1a - x1b) ** 2, axis=-1)
    x = np.sqrt(np.maximum(x2, 1e-300))
    r0 = (dh0 - dh1 + x2) / (2 * x)
    r1 = x - r0
    r = np.where(r0 <= 0, 0.0, np.where(r1 <= 0, 1.0, r0 / (r0 + r1)))
    r = np.where(x2 <= 0, 0.0, r)          # coincident anchors
    p = (1 - r) * out0[0] + r * out1[0]
    t = (1 - r) * out0[1] + r * out1[1]
    q = (1 - r) * q0 + r * q1
    k = (1 - r) * k0 + r * k1
    return p, t, q, k


def intpol_atm_3d(ctl: Ctl, atm: Atm, z0, lon0, lat0):
    """Lagrangian-grid interpolation (intpol_atm_3d, jurassic.c:763-804):
    distance-based weighted average over grid points within the vertical
    (cz) and horizontal (cx) influence radii; NaN when no points."""
    z0 = np.atleast_1d(np.asarray(z0, float))
    lon0 = np.broadcast_to(np.asarray(lon0, float), z0.shape)
    lat0 = np.broadcast_to(np.asarray(lat0, float), z0.shape)
    x1 = _geo2cart0(atm.lon, atm.lat)                    # [NP, 3]
    rm2 = ctl.cx ** 2
    x0 = _geo2cart0(lon0, lat0)                          # [N, 3]
    dz = np.abs(atm.z[None, :] - z0[:, None])
    dlat = np.abs(atm.lat[None, :] - lat0[:, None]) * 111.13
    dx2 = np.sum((x0[:, None, :] - x1[None, :, :]) ** 2, axis=-1)
    w = (1 - dz / ctl.cz) * (rm2 - dx2) / (rm2 + dx2)
    w = np.where((dz < ctl.cz) & (dlat < ctl.cx) & (dx2 < rm2), w, 0.0)
    wsum = np.sum(w, axis=1)
    bad = wsum < 1e-6
    ws = np.where(bad, 1.0, wsum)
    p = np.where(bad, np.nan, w @ atm.p / ws)
    t = np.where(bad, np.nan, w @ atm.t / ws)
    q = np.where(bad, np.nan, (atm.q @ w.T) / ws)
    k = np.where(bad, np.nan, (atm.k @ w.T) / ws)
    return p, t, q, k


def intpol_atm_geo(ctl: Ctl, atm: Atm, z0, lon0, lat0,
                   tp: TrackProfiles | None = None):
    """Dispatch on ctl.ip (intpol_atm_geo, jurassic.c:685-691)."""
    if ctl.ip == 1:
        return intpol_atm_1d(ctl, atm, 0, atm.npts, np.asarray(z0, float))
    if ctl.ip == 2:
        return intpol_atm_2d(ctl, atm, z0, lon0, lat0, tp)
    if ctl.ip == 3:
        return intpol_atm_3d(ctl, atm, z0, lon0, lat0)
    raise ValueError("Unknown interpolation method, check IP!")
