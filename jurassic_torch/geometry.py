"""Ray tracing through the spherical-shell atmosphere (port of
``jurassic_tpu/geometry.py``).

The reference raytracer (``traceray``, jr_common.h:586-711) traces one
ray per C loop with early exit.  Here all rays trace together: plain
tensor code batched over the ray axis, with a Python loop over the
NLOS step budget; data-dependent termination (ground/space escape) is a
carried ``stopped`` mask, exactly as the JAX ``lax.scan`` form has it.
The entry-point bisection (a ``lax.while_loop`` in JAX) is a bounded
loop with a per-ray "done" mask that freezes each ray's state where the
while loop would have stopped it.

The tracer is dtype-parametric: float64 on the CPU (parity with the
double-precision reference), float32 on CUDA.  The hydrostatic
equilibrium at the end is host-side float64 NumPy, copied from the JAX
package (which keeps it in NumPy too).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import Ctl
from .constants import KB, MM_AIR, MM_H2O, RE, RGAS
from .io_tab import Atm, Obs

DEG2RAD = np.pi / 180.0
RAD2DEG = 180.0 / np.pi
Z_REFRAC = 60.0     # refraction considered below this altitude [km]
ENTRY_MAX_ITERS = 64   # bisection halvings: enough for any |obs - vp|
#                        below 1e16 km at the 1 m stopping width


# ---------------------------------------------------------------------------
# Elementary geometry (geo2cart/cart2geo, jr_common.h:483-500)

def _dot3(a, b):
    """Sum over the last (x, y, z) axis in a fixed order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def geo2cart(alt, lon, lat):
    radius = alt + RE
    clat = torch.cos(lat * DEG2RAD)
    return torch.stack([
        radius * clat * torch.cos(lon * DEG2RAD),
        radius * clat * torch.sin(lon * DEG2RAD),
        radius * torch.sin(lat * DEG2RAD),
    ], dim=-1)


def cart2geo(x):
    radius = torch.sqrt(_dot3(x, x))
    lat = torch.asin(x[..., 2] / radius) * RAD2DEG
    lon = torch.atan2(x[..., 1], x[..., 0]) * RAD2DEG
    return radius - RE, lon, lat


def refractivity(p, t):
    """n - 1 of air at 4-15 um (jr_common.h:476-477)."""
    return 7.753e-05 * p / t


# ---------------------------------------------------------------------------
# Per-ray atmospheric profiles (host-side preparation)

class RayProfiles(NamedTuple):
    """Per-ray vertical profiles, padded to a common level count.

    The per-ray atm time window (``locate_atm``, jr_common.h:128-154)
    and its altitude range (``altitude_range_nn``, jr_common.h:412-420)
    are selected once on the host."""

    z: torch.Tensor      # [R, L]  (padded ascending)
    p: torch.Tensor      # [R, L]
    t: torch.Tensor      # [R, L]
    q: torch.Tensor      # [R, G, L]
    k: torch.Tensor      # [R, W, L]
    nlev: torch.Tensor   # [R] int64
    zmin: torch.Tensor   # [R]
    zmax: torch.Tensor   # [R]
    short: bool = False  # some window has < 2 levels (see _take_lo)


def locate_atm(time_arr: np.ndarray, time: float) -> tuple[int, int]:
    """Time-block bisection (locate_atm, jr_common.h:128-154)."""
    n = time_arr.size
    lo, hi = 0, n - 1
    while hi > lo + 1:
        i = (lo + hi) // 2
        if time_arr[i] < time:
            lo = i
        else:
            hi = i
    lower = lo if lo == 0 else hi
    lo, hi = lower, n - 1
    while hi > lo + 1:
        i = (lo + hi) // 2
        if time_arr[i] > time:
            hi = i
        else:
            lo = i
    upper = n if hi == n - 1 else hi
    return lower, upper - lower


def ray_window_indices(atm: Atm, obs: Obs):
    """Per-ray atm window: (idx, cnt, gi) with gi the [R, L] clamped
    gather index matrix from the flat atm point axis to per-ray
    profiles."""
    nr = obs.nr
    idx = np.zeros(nr, dtype=np.int64)
    cnt = np.zeros(nr, dtype=np.int64)
    win_cache: dict = {}
    for ir in range(nr):
        key = float(obs.time[ir])
        if key not in win_cache:
            win_cache[key] = locate_atm(atm.time, key)
        idx[ir], cnt[ir] = win_cache[key]
    L = int(cnt.max())
    ar = np.arange(L)
    gi = np.minimum(idx[:, None] + ar, idx[:, None] + cnt[:, None] - 1)
    return idx, cnt, gi


def build_ray_profiles(ctl: Ctl, atm: Atm, obs: Obs,
                       dtype=torch.float64, device="cpu") -> RayProfiles:
    if ctl.ip != 1:
        raise NotImplementedError(
            "Only IP = 1 (vertical profile) is ported; the IP = 2/3 pencil "
            "path is a later item (ROADMAP.md, section 1, 'What waits')")
    nr = obs.nr
    idx, cnt, gi = ray_window_indices(atm, obs)
    L = gi.shape[1]

    # window gather with clamped indices; padding beyond each window keeps
    # the last level and an ascending z so the interval search clamps
    ar = np.arange(L)
    pad = ar[None, :] >= cnt[:, None]
    z = atm.z[gi] + np.where(pad, (ar[None, :] - cnt[:, None] + 1) * 1e6,
                             0.0)
    p = atm.p[gi]
    t = atm.t[gi]
    q = np.swapaxes(atm.q[:, gi], 0, 1)          # [R, G, L]
    k = np.swapaxes(atm.k[:, gi], 0, 1)          # [R, W, L]

    # altitude_range_nn: constant-(lon,lat) leading run of each window
    zmin = np.zeros(nr)
    zmax = np.zeros(nr)
    run_cache: dict = {}
    for ir in range(nr):
        i0, n = int(idx[ir]), int(cnt[ir])
        if (i0, n) not in run_cache:
            diff = np.nonzero((atm.lon[i0:i0 + n] != atm.lon[i0])
                              | (atm.lat[i0:i0 + n] != atm.lat[i0]))[0]
            run = int(diff[0]) if diff.size else n
            zz = atm.z[i0:i0 + run]
            run_cache[(i0, n)] = (zz.min(), zz.max())
        zmin[ir], zmax[ir] = run_cache[(i0, n)]

    def ten(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)

    return RayProfiles(
        z=ten(z), p=ten(p), t=ten(t), q=ten(q), k=ten(k),
        nlev=torch.as_tensor(cnt).to(device),
        zmin=ten(zmin), zmax=ten(zmax), short=bool((cnt < 2).any()))


# ---------------------------------------------------------------------------
# Profile interpolation (intpol_atm_1d, jr_common.h:550-567)

def _interval_index(prof: RayProfiles, z0):
    """Index ilo in [0, nlev-2] with z[ilo] <= z0 < z[ilo+1] (clamped),
    identical to locate() for ascending grids (jr_common.h:88-104).
    z0: [R, k] -> [R, k] int64 (-1 for a one-level window)."""
    below = (prof.z.unsqueeze(1) <= z0.unsqueeze(2)).sum(-1)
    return torch.minimum((below - 1).clamp_min(0),
                         (prof.nlev - 2).unsqueeze(1))


def _take(arr, i):
    """arr[..., i] per ray: arr [R, L] or [R, C, L], i [R, k]."""
    if arr.dim() == 2:
        return torch.gather(arr, 1, i)
    return torch.gather(arr, 2, i.unsqueeze(1).expand(-1, arr.shape[1], -1))


def _take_lo(prof: RayProfiles, arr, i):
    """The lower bracketing level.  A one-level window (nlev = 1, which
    locate_atm yields for times past the last atm block) clips the index
    to -1; the JAX one-hot pick then selects nothing and reads 0, which
    this reproduces."""
    if not prof.short:
        return _take(arr, i)
    v = _take(arr, i.clamp_min(0))
    keep = i >= 0
    return torch.where(keep if v.dim() == 2 else keep.unsqueeze(1), v, 0.0)


def _lin(x0, y0, x1, y1, x):
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _eip(x0, y0, x1, y1, x):
    """Exponential interpolation with linear fallback (jr_common.h:52-57)."""
    ok = (y0 > 0) & (y1 > 0)
    y0s = torch.where(ok, y0, 1.0)
    y1s = torch.where(ok, y1, 1.0)
    e = y0s * torch.exp(torch.log(y1s / y0s) / (x1 - x0) * (x - x0))
    return torch.where(ok, e, _lin(x0, y0, x1, y1, x))


def interp_pt(prof: RayProfiles, z0):
    """(p, t) at altitudes z0 [R, k]."""
    i = _interval_index(prof, z0)
    za, zb = _take_lo(prof, prof.z, i), _take(prof.z, i + 1)
    p = _eip(za, _take_lo(prof, prof.p, i), zb, _take(prof.p, i + 1), z0)
    t = _lin(za, _take_lo(prof, prof.t, i), zb, _take(prof.t, i + 1), z0)
    return p, t


def interp_all(prof: RayProfiles, z0):
    """(p [R], t [R], q [R, G], k [R, W]) at altitudes z0 [R] with ONE
    shared interval search."""
    zc = z0.unsqueeze(1)
    i = _interval_index(prof, zc)
    za, zb = _take_lo(prof, prof.z, i), _take(prof.z, i + 1)
    p = _eip(za, _take_lo(prof, prof.p, i), zb, _take(prof.p, i + 1), zc)
    t = _lin(za, _take_lo(prof, prof.t, i), zb, _take(prof.t, i + 1), zc)
    za3, zb3, zc3 = za.unsqueeze(1), zb.unsqueeze(1), zc.unsqueeze(1)
    q = _lin(za3, _take_lo(prof, prof.q, i), zb3, _take(prof.q, i + 1),
             zc3)
    k = _lin(za3, _take_lo(prof, prof.k, i), zb3, _take(prof.k, i + 1),
             zc3)
    return p[:, 0], t[:, 0], q[..., 0], k[..., 0]


# ---------------------------------------------------------------------------
# Line-of-sight result container

class LosData(NamedTuple):
    """Traced lines of sight, fixed shape [R, NLOS(, ...)]."""

    z: torch.Tensor       # [R, NLOS]
    lon: torch.Tensor
    lat: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    q: torch.Tensor       # [R, NLOS, G]
    k: torch.Tensor       # [R, NLOS, W]
    ds: torch.Tensor      # [R, NLOS] trapezoid-rule segment lengths
    u: torch.Tensor       # [R, NLOS, G] column densities [molec/cm^2]
    valid: torch.Tensor   # [R, NLOS] bool
    np_: torch.Tensor     # [R] int32 number of LOS points
    tsurf: torch.Tensor   # [R] surface temperature, -999 if no ground hit
    tpz: torch.Tensor     # [R] tangent point
    tplon: torch.Tensor
    tplat: torch.Tensor


def los_from_numpy(los, device="cpu", dtype=torch.float64) -> LosData:
    """A :class:`LosData` on ``device`` from any object with the same
    field names holding array-likes -- e.g. a LOS traced by the JAX
    package, passed through ``np.asarray``.  Float fields take
    ``dtype``; ``valid`` stays bool and ``np_`` int32."""
    def conv(name):
        a = torch.from_numpy(np.array(getattr(los, name)))   # a copy
        if name == "valid":
            return a.to(device, torch.bool)
        if name == "np_":
            return a.to(device, torch.int32)
        return a.to(device, dtype)
    return LosData(*(conv(f) for f in LosData._fields))


def _entry_point(xobs, ex0, norm, zmax):
    """Observer above the atmosphere: bisect the entry point
    (jr_common.h:610-621).  The JAX form is a per-ray while loop; here a
    bounded loop updates only rays whose loop condition still holds, so
    each ray stops in the state its while loop would have stopped in."""
    dmin = torch.zeros_like(norm)
    dmax = norm.clone()
    x = xobs.clone()
    found = torch.zeros_like(norm, dtype=torch.bool)
    for _ in range(ENTRY_MAX_ITERS):
        act = ((dmin - dmax).abs() > 0.001) & ~found
        if not bool(act.any()):
            break
        d = 0.5 * (dmax + dmin)
        xn = xobs + d.unsqueeze(1) * ex0
        z = torch.sqrt(_dot3(xn, xn)) - RE
        f = (z <= zmax) & (z > zmax - 0.001)
        low = z < zmax - 0.0005
        dmax = torch.where(act & ~f & low, d, dmax)
        dmin = torch.where(act & ~f & ~low, d, dmin)
        x = torch.where(act.unsqueeze(1), xn, x)
        found = torch.where(act, f, found)
    else:
        if bool((((dmin - dmax).abs() > 0.001) & ~found).any()):
            raise RuntimeError("entry-point bisection did not converge")
    return x


def trace_rays(ctl: Ctl, prof: RayProfiles, obs_geo: dict) -> LosData:
    """Trace all rays in the dtype and on the device of ``prof``
    (raytrace_rays_CPU, CPUdrivers.c:89-95): the step loop is batched
    over rays, the per-ray arithmetic is that of the JAX
    ``_trace_single`` (geometry.py:283-480)."""
    dev, dt = prof.z.device, prof.z.dtype
    R = prof.z.shape[0]
    nlos = int(ctl.nlos)
    rayds, raydz = float(ctl.rayds), float(ctl.raydz)
    refrac = bool(ctl.refrac)
    og = {k: torch.as_tensor(v).to(dev, dt) for k, v in obs_geo.items()}
    zmin, zmax = prof.zmin, prof.zmax

    xobs = geo2cart(og["obsz"], og["obslon"], og["obslat"])
    xvp = geo2cart(og["vpz"], og["vplon"], og["vplat"])
    ex0 = xvp - xobs
    norm = torch.sqrt(_dot3(ex0, ex0))
    ex0 = ex0 / norm.unsqueeze(1)

    # traced only when the observer is above zmin and the view point
    # below zmax - 0.001 (jr_common.h:598-599)
    ok = (og["obsz"] >= zmin) & (og["vpz"] <= zmax - 0.001)
    x = torch.where((og["obsz"] > zmax).unsqueeze(1),
                    _entry_point(xobs, ex0, norm, zmax), xobs)
    ex = ex0
    stopped = ~ok
    tsurf = torch.full((R,), -999.0, dtype=dt, device=dev)
    z_low = torch.full((R,), float("inf"), dtype=dt, device=dev)
    z_low_idx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    pz = torch.zeros(R, dtype=dt, device=dev)
    plon = torch.zeros_like(pz)
    plat = torch.zeros_like(pz)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    outs = {k: [] for k in ("z", "lon", "lat", "p", "t", "q", "k", "ds",
                            "ds_corr", "valid")}

    for ip in range(nlos):
        # step length (jr_common.h:625-635)
        ds = torch.full((R,), rayds, dtype=dt, device=dev)
        if raydz > 0.0:
            norm_x = 1.0 / torch.sqrt(_dot3(x, x))
            cosa = torch.abs(_dot3(ex, x) * norm_x)
            ds = torch.where(cosa != 0.0,
                             torch.clamp(raydz / cosa, max=rayds), ds)

        z, lon, lat = cart2geo(x)

        # escape clipping (jr_common.h:637-648)
        below = z < zmin
        escaped = below | (z > zmax)
        xh = geo2cart(pz, plon, plat)
        zfrac = torch.where(below, zmin, zmax)
        frac = (zfrac - pz) / torch.where(z == pz, 1.0, z - pz)
        xe = xh + frac.unsqueeze(1) * (x - xh)
        ze, lone, late = cart2geo(xe)
        ds_corr = torch.where(escaped, ds * frac, nan)

        x = torch.where(escaped.unsqueeze(1), xe, x)
        z = torch.where(escaped, ze, z)
        lon = torch.where(escaped, lone, lon)
        lat = torch.where(escaped, late, lat)
        ds = torch.where(escaped, 0.0, ds)

        p, t, q, k = interp_all(prof, z)

        active = ok & ~stopped
        is_low = active & (z < z_low)
        z_low = torch.where(is_low, z, z_low)
        z_low_idx = torch.where(is_low, ip, z_low_idx)

        stopping = active & escaped
        tsurf = torch.where(stopping & below, t, tsurf)

        for key, val in (("z", z), ("lon", lon), ("lat", lat), ("p", p),
                         ("t", t), ("q", q), ("k", k), ("ds", ds),
                         ("ds_corr", torch.where(stopping, ds_corr, nan)),
                         ("valid", active)):
            outs[key].append(val)

        # direction update with optional refraction (jr_common.h:664-690)
        if refrac:
            nn = 1.0 + refractivity(p, t)
            xh2 = x + (0.5 * ds).unsqueeze(1) * ex
            h = 0.02
            xps = [xh2]
            for i in range(3):
                xp = xh2.clone()
                xp[:, i] = xh2[:, i] + h
                xps.append(xp)
            # the midpoint and its three offset points share one
            # interval search (columns 0 and 1..3 of one [R, 4] batch)
            zq = torch.stack([torch.sqrt(_dot3(v, v)) - RE for v in xps],
                             dim=1)
            pq, tq = interp_pt(prof, zq)
            nq = refractivity(pq, tq)
            g = (nq[:, 1:] - nq[:, :1]) / h
            use = (z <= Z_REFRAC)
            n = torch.where(use, nn, 1.0)
            ng = torch.where(use.unsqueeze(1), g, 0.0)
            ex1 = ex * n.unsqueeze(1) + ds.unsqueeze(1) * ng
        else:
            ex1 = ex
        ex1 = ex1 / torch.sqrt(_dot3(ex1, ex1)).unsqueeze(1)
        x_new = x + (0.5 * ds).unsqueeze(1) * (ex + ex1)

        advance = (active & ~stopping).unsqueeze(1)
        x = torch.where(advance, x_new, x)
        ex = torch.where(advance, ex1, ex)
        stopped = stopped | stopping | ~ok
        pz, plon, plat = z, lon, lat

    st = {k: torch.stack(v, dim=1) for k, v in outs.items()}
    valid = st["valid"]
    np_ = valid.sum(dim=1, dtype=torch.int32)
    iota = torch.arange(nlos, device=dev)

    # escape segment-length correction of the point before the boundary
    # point (los[np-1].ds = ds*frac, jr_common.h:646); at most one per ray
    ds = st["ds"]
    corr = st["ds_corr"]
    has_corr = ~torch.isnan(corr)
    corr_idx = torch.where(has_corr, iota, nlos).min(dim=1).values
    any_corr = has_corr.any(dim=1)
    corr_val = torch.gather(corr, 1, corr_idx.clamp(max=nlos - 1)
                            .unsqueeze(1))[:, 0]
    ds = torch.where(any_corr.unsqueeze(1)
                     & (iota.unsqueeze(0) == (corr_idx - 1).unsqueeze(1)),
                     torch.where(any_corr, corr_val, 0.0).unsqueeze(1), ds)

    # tangent point from the pre-trapezoid segment lengths
    # (tangent_point, jr_common.h:503-539)
    zarr, lonarr, latarr = st["z"], st["lon"], st["lat"]

    def at(arr, i):
        return torch.gather(arr, 1, i.unsqueeze(1))[:, 0]

    ipl = z_low_idx
    limb_case = (ipl > 0) & (ipl < np_ - 1)
    ips = ipl.clamp(1, nlos - 2)
    yy0, yy1, yy2 = at(zarr, ips - 1), at(zarr, ips), at(zarr, ips + 1)
    ds0, ds1 = at(ds, ips), at(ds, ips + 1)
    dyy10, dyy21 = yy1 - yy0, yy2 - yy1
    x1 = torch.sqrt(torch.clamp(ds0 * ds0 - dyy10 * dyy10, min=0.0))
    x2 = x1 + torch.sqrt(torch.clamp(ds1 * ds1 - dyy21 * dyy21, min=0.0))
    dx12 = x1 - x2
    denom = torch.where(limb_case, x1 * x2 * dx12, 1.0)
    a = (dyy10 * x2 + (yy0 - yy2) * x1) / denom
    b = dyy10 / torch.where(limb_case, x1, 1.0) - a * x1
    c = yy0
    xt = -b / (2 * torch.where(a == 0, 1.0, a))
    tpz_limb = (a * xt + b) * xt + c
    v0 = geo2cart(yy0, at(lonarr, ips - 1), at(latarr, ips - 1))
    v2 = geo2cart(yy2, at(lonarr, ips + 1), at(latarr, ips + 1))
    v = v0 + (v2 - v0) * (xt / torch.where(x2 == 0, 1.0, x2)).unsqueeze(1)
    _, tplon_limb, tplat_limb = cart2geo(v)

    last = (np_.long() - 1).clamp(0, nlos - 1)
    tpz = torch.where(limb_case, tpz_limb, at(zarr, last))
    tplon = torch.where(limb_case, tplon_limb, at(lonarr, last))
    tplat = torch.where(limb_case, tplat_limb, at(latarr, last))
    # rays that never traced keep the view point (jr_common.h:592-594)
    tpz = torch.where(ok, tpz, og["vpz"])
    tplon = torch.where(ok, tplon, og["vplon"])
    tplat = torch.where(ok, tplat, og["vplat"])

    # trapezoid rule (jr_common.h:438-443): ds'[i] = (ds[i-1]+ds[i])/2
    ds_prev = torch.cat([torch.zeros_like(ds[:, :1]), ds[:, :-1]], dim=1)
    ds_trap = 0.5 * (ds_prev + ds)

    # column densities (jr_common.h:446-453)
    p, t = st["p"], st["t"]
    u = (10.0 * st["q"] * p.unsqueeze(2) / (KB * t.unsqueeze(2))
         * ds_trap.unsqueeze(2))

    return LosData(
        z=zarr, lon=lonarr, lat=latarr, p=p, t=t, q=st["q"], k=st["k"],
        ds=ds_trap, u=u, valid=valid, np_=np_,
        tsurf=torch.where(ok, tsurf, -999.0),
        tpz=tpz, tplon=tplon, tplat=tplat)


# ---------------------------------------------------------------------------
# Hydrostatic equilibrium (hydrostatic_1d_h2o, jr_common.h:728-761)

def hydrostatic_profile(ctl_hydz: float, z: np.ndarray, p: np.ndarray,
                        t: np.ndarray, q_h2o, lat: np.ndarray) -> np.ndarray:
    """Rebuild p(z) from temperature and humidity around the reference
    height; NumPy float64 host implementation (profiles are small)."""
    n = z.size
    ipref = int(np.argmin(np.abs(z - ctl_hydz)))
    lat0 = lat[ipref]
    npts = 20
    i = np.arange(npts)
    p = p.copy()

    def layer_mean(za, zb, ta, tb, ea, eb):
        zz = za + (zb - za) * i / (npts - 1.0)
        ee = ea + (eb - ea) * i / (npts - 1.0)
        tt = ta + (tb - ta) * i / (npts - 1.0)
        grav = (9.780318 * (1.0 + 0.0053024 * np.sin(lat0 * DEG2RAD) ** 2
                            - 5.8e-6 * np.sin(2 * lat0 * DEG2RAD) ** 2)
                - 3.086e-3 * zz)
        return np.sum((ee * MM_H2O + (1 - ee) * MM_AIR) * grav
                      / (RGAS * tt * npts))

    e = np.zeros(n) if q_h2o is None else q_h2o
    for ip in range(ipref + 1, n):
        mean = layer_mean(z[ip - 1], z[ip], t[ip - 1], t[ip],
                          e[ip - 1], e[ip])
        p[ip] = p[ip - 1] * np.exp(-1000.0 * mean * (z[ip] - z[ip - 1]))
    for ip in range(ipref - 1, -1, -1):
        mean = layer_mean(z[ip + 1], z[ip], t[ip + 1], t[ip],
                          e[ip + 1], e[ip])
        p[ip] = p[ip + 1] * np.exp(-1000.0 * mean * (z[ip] - z[ip + 1]))
    return p


def hydrostatic_atm(ctl: Ctl, atm: Atm) -> Atm:
    """Apply hydrostatic equilibrium to each (lon,lat,time) profile in atm
    (hydrostatic, jurassic.c:263-276)."""
    if ctl.hydz < 0:
        return atm
    if ctl.checkmode:
        print("# apply hydrostatic equation to individual profiles")
        return atm
    ig_h2o = ctl.emitter_index("H2O")
    lon0 = lat0 = -999.0
    ip0 = 0
    bounds = []
    for ip in range(atm.npts):
        if atm.lon[ip] != lon0 or atm.lat[ip] != lat0:
            if ip > 0:
                bounds.append((ip0, ip))
            lon0, lat0, ip0 = atm.lon[ip], atm.lat[ip], ip
    bounds.append((ip0, atm.npts))
    for (a, b) in bounds:
        qh = atm.q[ig_h2o, a:b] if ig_h2o >= 0 else None
        atm.p[a:b] = hydrostatic_profile(
            ctl.hydz, atm.z[a:b], atm.p[a:b], atm.t[a:b], qh, atm.lat[a:b])
    return atm
