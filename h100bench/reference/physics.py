"""The plain reference of the limb forward model, in plain PyTorch.

A statement of the model the benchmark's cells run, independent of the
program: it imports nothing of ``jurassic_torch`` (nor JAX) and reads
only what the benchmark hands it -- the tables and atmospheres of
``h100bench.gen`` as plain arrays, and the continuum coefficients in
``continua.npz`` (the reference's CTM data).  It follows the upstream C
code (``jr_common.h``): hydrostatic equilibrium, the ray tracer with
refraction, the EGA pass on exact (``tbl_t``) or log-uniform tables with
the four continua, the source term and the surface term.  The
operations and their order are those of the upstream code as the
program's plain versions state them, so that in float64 the two agree
to rounding; ``tests/test_h100bench_upstream.py`` holds it to
upstream's own printed output as well.

Every function is batched over rays (the leading axis); the dtype and
device are those of the inputs.  ``torch.func.jacfwd`` runs through the
whole chain (the Jacobian's reference, ``reference.jacobian``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

C1 = 1.19104259e-8
C2 = 1.43877506
P0 = 1013.25
RE = 6367.421
KB = 1.3806504e-23
RGAS = 8.314472
NA = 6.02214199e23
MM_AIR = 28.96456e-3
MM_H2O = 18.0153e-3
TAU_OPAQUE = 1e-9
TAU_CUTOFF = 1e-50
LOG2_RATIO_U = 1.0 / 6.0
DEG2RAD = np.pi / 180.0
RAD2DEG = 180.0 / np.pi
Z_REFRAC = 60.0
ENTRY_MAX_ITERS = 64

_CTM = Path(__file__).resolve().parent / "continua.npz"


# ---------------------------------------------------------------------------
# Hydrostatic equilibrium (hydrostatic_1d_h2o, jr_common.h:728-761)

def _grav(lat0: float, zz):
    return (9.780318 * (1.0 + 0.0053024 * np.sin(lat0 * DEG2RAD) ** 2
                        - 5.8e-6 * np.sin(2 * lat0 * DEG2RAD) ** 2)
            - 3.086e-3 * zz)


def profile_blocks(lon: np.ndarray, lat: np.ndarray):
    """(start, end) of each run of equal (lon, lat) on the point axis."""
    blocks, ip0 = [], 0
    for ip in range(1, lon.size):
        if lon[ip] != lon[ip - 1] or lat[ip] != lat[ip - 1]:
            blocks.append((ip0, ip))
            ip0 = ip
    blocks.append((ip0, lon.size))
    return blocks


def hydrostatic(hydz: float, atm: dict, ig_h2o: int) -> np.ndarray:
    """p rebuilt from T and humidity around the level nearest ``hydz``,
    profile by profile, as two sequential recursions (float64)."""
    p = np.array(atm["p"], np.float64)
    if hydz < 0:
        return p
    npts = 20
    i = np.arange(npts)
    for a, b in profile_blocks(atm["lon"], atm["lat"]):
        z, t = atm["z"][a:b], atm["t"][a:b]
        e = atm["q"][ig_h2o, a:b] if ig_h2o >= 0 else np.zeros(b - a)
        ipref = int(np.argmin(np.abs(z - hydz)))
        lat0 = atm["lat"][a:b][ipref]
        pb = p[a:b]

        def mean(j0, j1):
            zz = z[j0] + (z[j1] - z[j0]) * i / (npts - 1.0)
            ee = e[j0] + (e[j1] - e[j0]) * i / (npts - 1.0)
            tt = t[j0] + (t[j1] - t[j0]) * i / (npts - 1.0)
            return np.sum((ee * MM_H2O + (1 - ee) * MM_AIR) * _grav(lat0, zz)
                          / (RGAS * tt * npts))
        for ip in range(ipref + 1, b - a):
            pb[ip] = pb[ip - 1] * np.exp(-1000.0 * mean(ip - 1, ip)
                                         * (z[ip] - z[ip - 1]))
        for ip in range(ipref - 1, -1, -1):
            pb[ip] = pb[ip + 1] * np.exp(-1000.0 * mean(ip + 1, ip)
                                         * (z[ip] - z[ip + 1]))
    return p


def hydrostatic_torch(hydz: float, z: np.ndarray, lat0: float, p, t, q_h2o):
    """The same rebuild of one profile as one cumulative sum in log p, on
    tensors that may carry tangents (the Jacobian's state map)."""
    z = np.asarray(z, np.float64)
    ipref = int(np.argmin(np.abs(z - hydz)))
    npts = 20
    w = np.arange(npts) / (npts - 1.0)
    zz = z[:-1, None] + (z[1:] - z[:-1])[:, None] * w
    ten = lambda a: torch.as_tensor(a, dtype=t.dtype, device=t.device)
    wt = ten(w)
    e = torch.zeros_like(t) if q_h2o is None else q_h2o
    tt = t[:-1, None] + (t[1:] - t[:-1])[:, None] * wt
    ee = e[:-1, None] + (e[1:] - e[:-1])[:, None] * wt
    mean = torch.sum((ee * MM_H2O + (1 - ee) * MM_AIR) * ten(_grav(lat0, zz))
                     / (RGAS * tt * npts), dim=1)
    inc = 1000.0 * mean * ten(z[1:] - z[:-1])
    c = torch.cat([torch.zeros_like(inc[:1]), torch.cumsum(inc, 0)])
    return torch.exp(torch.log(p[ipref]) - (c - c[ipref]))


# ---------------------------------------------------------------------------
# Per-ray profiles (locate_atm, altitude_range_nn)

def _locate_atm(time_arr: np.ndarray, time: float):
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


def ray_windows(atm: dict, obs_time: np.ndarray):
    """(window start [R], count [R], gather index [R, L]) of each ray's
    atmosphere window in time."""
    idx = np.zeros(obs_time.size, np.int64)
    cnt = np.zeros(obs_time.size, np.int64)
    for ir, tm in enumerate(obs_time):
        idx[ir], cnt[ir] = _locate_atm(atm["time"], float(tm))
    L = int(cnt.max())
    gi = np.minimum(idx[:, None] + np.arange(L), idx[:, None] + cnt[:, None] - 1)
    return idx, cnt, gi


def profiles(atm: dict, obs_time: np.ndarray, fields: dict, dtype, device):
    """Per-ray profiles: z (padding above the window ascends by 1e6 km),
    nlev, zmin, zmax as tensors; p [R, L], t, q [R, G, L], k [R, W, L]
    gathered from ``fields`` (atm-point tensors, which may carry
    tangents)."""
    idx, cnt, gi = ray_windows(atm, obs_time)
    L = gi.shape[1]
    ar = np.arange(L)
    pad = ar[None, :] >= cnt[:, None]
    z = atm["z"][gi] + np.where(pad, (ar[None, :] - cnt[:, None] + 1) * 1e6,
                                0.0)
    zmin, zmax = np.zeros(idx.size), np.zeros(idx.size)
    for ir in range(idx.size):
        i0, n = int(idx[ir]), int(cnt[ir])
        lon, lat = atm["lon"][i0:i0 + n], atm["lat"][i0:i0 + n]
        diff = np.nonzero((lon != lon[0]) | (lat != lat[0]))[0]
        zz = atm["z"][i0:i0 + (int(diff[0]) if diff.size else n)]
        zmin[ir], zmax[ir] = zz.min(), zz.max()
    ten = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)
    g = torch.from_numpy(gi).to(device)
    return dict(z=ten(z), p=fields["p"][g], t=fields["t"][g],
                q=fields["q"][:, g].movedim(0, 1),
                k=fields["k"][:, g].movedim(0, 1),
                nlev=torch.as_tensor(cnt).to(device), zmin=ten(zmin),
                zmax=ten(zmax), short=bool((cnt < 2).any()))


# ---------------------------------------------------------------------------
# Ray tracing (traceray, jr_common.h:586-711)

def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def geo2cart(alt, lon, lat):
    radius = alt + RE
    clat = torch.cos(lat * DEG2RAD)
    return torch.stack([radius * clat * torch.cos(lon * DEG2RAD),
                        radius * clat * torch.sin(lon * DEG2RAD),
                        radius * torch.sin(lat * DEG2RAD)], dim=-1)


def cart2geo(x):
    radius = torch.sqrt(_dot3(x, x))
    return (radius - RE, torch.atan2(x[..., 1], x[..., 0]) * RAD2DEG,
            torch.asin(x[..., 2] / radius) * RAD2DEG)


def refractivity(p, t):
    return 7.753e-05 * p / t


def _interval(prof, z0):
    below = (prof["z"].unsqueeze(1) <= z0.unsqueeze(2)).sum(-1)
    return torch.minimum((below - 1).clamp_min(0),
                         (prof["nlev"] - 2).unsqueeze(1))


def _take(arr, i):
    if arr.dim() == 2:
        return torch.gather(arr, 1, i)
    return torch.gather(arr, 2, i.unsqueeze(1).expand(-1, arr.shape[1], -1))


def _take_lo(prof, arr, i):
    if not prof["short"]:
        return _take(arr, i)
    v = _take(arr, i.clamp_min(0))
    keep = i >= 0
    return torch.where(keep if v.dim() == 2 else keep.unsqueeze(1), v, 0.0)


def _lin(x0, y0, x1, y1, x):
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _eip(x0, y0, x1, y1, x):
    ok = (y0 > 0) & (y1 > 0)
    y0s, y1s = torch.where(ok, y0, 1.0), torch.where(ok, y1, 1.0)
    e = y0s * torch.exp(torch.log(y1s / y0s) / (x1 - x0) * (x - x0))
    return torch.where(ok, e, _lin(x0, y0, x1, y1, x))


def _interp_pt(prof, z0):
    i = _interval(prof, z0)
    za, zb = _take_lo(prof, prof["z"], i), _take(prof["z"], i + 1)
    return (_eip(za, _take_lo(prof, prof["p"], i), zb,
                 _take(prof["p"], i + 1), z0),
            _lin(za, _take_lo(prof, prof["t"], i), zb,
                 _take(prof["t"], i + 1), z0))


def _interp_all(prof, z0):
    zc = z0.unsqueeze(1)
    i = _interval(prof, zc)
    za, zb = _take_lo(prof, prof["z"], i), _take(prof["z"], i + 1)
    p = _eip(za, _take_lo(prof, prof["p"], i), zb, _take(prof["p"], i + 1), zc)
    t = _lin(za, _take_lo(prof, prof["t"], i), zb, _take(prof["t"], i + 1), zc)
    za3, zb3, zc3 = za.unsqueeze(1), zb.unsqueeze(1), zc.unsqueeze(1)
    q = _lin(za3, _take_lo(prof, prof["q"], i), zb3, _take(prof["q"], i + 1),
             zc3)
    k = _lin(za3, _take_lo(prof, prof["k"], i), zb3, _take(prof["k"], i + 1),
             zc3)
    return p[:, 0], t[:, 0], q[..., 0], k[..., 0]


def _entry_point(xobs, ex0, norm, zmax):
    """Bisect the entry point of an observer above the atmosphere; a ray
    stops where its while loop would."""
    dmin, dmax = torch.zeros_like(norm), norm.clone()
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
        raise RuntimeError("entry-point bisection did not converge")
    return x


def _tangent_point(zarr, lonarr, latarr, ds, ipl, np_):
    nlos = zarr.shape[1]
    at = lambda arr, i: torch.gather(arr, 1, i.unsqueeze(1))[:, 0]
    ips = ipl.clamp(1, nlos - 2)
    yy0, yy1, yy2 = at(zarr, ips - 1), at(zarr, ips), at(zarr, ips + 1)
    ds0, ds1 = at(ds, ips), at(ds, ips + 1)
    dyy10, dyy21 = yy1 - yy0, yy2 - yy1
    x1 = torch.sqrt(torch.clamp(ds0 * ds0 - dyy10 * dyy10, min=0.0))
    x2 = x1 + torch.sqrt(torch.clamp(ds1 * ds1 - dyy21 * dyy21, min=0.0))
    dx12 = x1 - x2
    limb = (ipl > 0) & (ipl < np_ - 1) & (dx12 != 0)
    a = (dyy10 * x2 + (yy0 - yy2) * x1) / torch.where(limb, x1 * x2 * dx12,
                                                      1.0)
    b = dyy10 / torch.where(limb, x1, 1.0) - a * x1
    xt = -b / (2 * torch.where(a == 0, 1.0, a))
    tpz = (a * xt + b) * xt + yy0
    v0 = geo2cart(yy0, at(lonarr, ips - 1), at(latarr, ips - 1))
    v2 = geo2cart(yy2, at(lonarr, ips + 1), at(latarr, ips + 1))
    v = v0 + (v2 - v0) * (xt / torch.where(x2 == 0, 1.0, x2)).unsqueeze(1)
    _, tplon, tplat = cart2geo(v)
    last = (np_.long() - 1).clamp(0, nlos - 1)
    return (torch.where(limb, tpz, at(zarr, last)),
            torch.where(limb, tplon, at(lonarr, last)),
            torch.where(limb, tplat, at(latarr, last)))


def trace(ray: dict, prof: dict, geo: dict) -> dict:
    """Trace every ray: the LOS points (z, lon, lat, p, t, q [R, S, G],
    k [R, S, W]), trapezoid segment lengths ds, column densities u
    [R, S, G], valid [R, S], np_ [R], tsurf [R] and the tangent point.
    ``ray`` holds nlos, rayds, raydz, refrac; ``geo`` the observer and
    view-point geometry as tensors."""
    dev, dt = prof["z"].device, prof["z"].dtype
    R = prof["z"].shape[0]
    nlos, rayds, raydz = int(ray["nlos"]), float(ray["rayds"]), \
        float(ray["raydz"])
    zmin, zmax = prof["zmin"], prof["zmax"]
    xobs = geo2cart(geo["obsz"], geo["obslon"], geo["obslat"])
    xvp = geo2cart(geo["vpz"], geo["vplon"], geo["vplat"])
    ex0 = xvp - xobs
    norm = torch.sqrt(_dot3(ex0, ex0))
    ex0 = ex0 / norm.unsqueeze(1)
    ok = (geo["obsz"] >= zmin) & (geo["vpz"] <= zmax - 0.001)
    x = torch.where((geo["obsz"] > zmax).unsqueeze(1),
                    _entry_point(xobs, ex0, norm, zmax), xobs)
    ex = ex0
    stopped = ~ok
    tsurf = torch.full((R,), -999.0, dtype=dt, device=dev)
    z_low = torch.full((R,), float("inf"), dtype=dt, device=dev)
    z_low_idx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    pz = torch.zeros(R, dtype=dt, device=dev)
    plon, plat = torch.zeros_like(pz), torch.zeros_like(pz)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    outs = {k: [] for k in ("z", "lon", "lat", "p", "t", "q", "k", "ds",
                            "ds_corr", "valid")}
    for ip in range(nlos):
        ds = torch.full((R,), rayds, dtype=dt, device=dev)
        if raydz > 0.0:
            cosa = torch.abs(_dot3(ex, x) * (1.0 / torch.sqrt(_dot3(x, x))))
            ds = torch.where(cosa != 0.0, torch.clamp(raydz / cosa, max=rayds),
                             ds)
        z, lon, lat = cart2geo(x)
        below = z < zmin
        escaped = below | (z > zmax)
        xh = geo2cart(pz, plon, plat)
        frac = (torch.where(below, zmin, zmax) - pz) \
            / torch.where(z == pz, 1.0, z - pz)
        xe = xh + frac.unsqueeze(1) * (x - xh)
        ze, lone, late = cart2geo(xe)
        ds_corr = torch.where(escaped, ds * frac, nan)
        x = torch.where(escaped.unsqueeze(1), xe, x)
        z = torch.where(escaped, ze, z)
        lon = torch.where(escaped, lone, lon)
        lat = torch.where(escaped, late, lat)
        ds = torch.where(escaped, 0.0, ds)
        p, t, q, k = _interp_all(prof, z)
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
        if ray["refrac"]:
            nn = 1.0 + refractivity(p, t)
            xh2 = x + (0.5 * ds).unsqueeze(1) * ex
            h = 0.02
            xps = [xh2] + [torch.stack([xh2[:, j] + h if j == i else xh2[:, j]
                                        for j in range(3)], dim=1)
                           for i in range(3)]
            zq = torch.stack([torch.sqrt(_dot3(v, v)) - RE for v in xps],
                             dim=1)
            pq, tq = _interp_pt(prof, zq)
            nq = refractivity(pq, tq)
            g = (nq[:, 1:] - nq[:, :1]) / h
            use = z <= Z_REFRAC
            ex1 = (ex * torch.where(use, nn, 1.0).unsqueeze(1)
                   + ds.unsqueeze(1) * torch.where(use.unsqueeze(1), g, 0.0))
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
    ds, corr = st["ds"], st["ds_corr"]
    has = ~torch.isnan(corr)
    corr_idx = torch.where(has, iota, nlos).min(dim=1).values
    anyc = has.any(dim=1)
    cval = torch.gather(corr, 1, corr_idx.clamp(max=nlos - 1)
                        .unsqueeze(1))[:, 0]
    at_c = anyc.unsqueeze(1) & (iota.unsqueeze(0) == (corr_idx - 1)
                                .unsqueeze(1))
    ds = torch.where(at_c, torch.where(anyc, cval, 0.0).unsqueeze(1), ds)
    tpz, tplon, tplat = _tangent_point(st["z"], st["lon"], st["lat"], ds,
                                       z_low_idx, np_)
    ds_prev = torch.cat([torch.zeros_like(ds[:, :1]), ds[:, :-1]], dim=1)
    ds_trap = 0.5 * (ds_prev + ds)
    p, t = st["p"], st["t"]
    u = (10.0 * st["q"] * p.unsqueeze(2) / (KB * t.unsqueeze(2))
         * ds_trap.unsqueeze(2))
    return dict(p=p, t=t, q=st["q"], k=st["k"], ds=ds_trap, u=u, valid=valid,
                np_=np_, tsurf=torch.where(ok, tsurf, -999.0),
                tpz=torch.where(ok, tpz, geo["vpz"]),
                tplon=torch.where(ok, tplon, geo["vplon"]),
                tplat=torch.where(ok, tplat, geo["vplat"]))


# ---------------------------------------------------------------------------
# Continua (continua_ctm{co2,h2o,n2,o2}, jr_common.h:316-409)

def continua_coeffs(nu: np.ndarray) -> dict:
    """Per-channel continuum coefficients [D] (float64 NumPy)."""
    with np.load(_CTM) as f:
        data = {k: f[k] for k in f.files}
    nu = np.asarray(nu, np.float64)

    def edge(arr, xw):
        iw = xw.astype(np.int64)
        dw = xw - iw
        return ((1 - dw) * arr[np.clip(iw - 1, 0, arr.size - 1)]
                + dw * arr[np.clip(iw, 0, arr.size - 1)])

    def idx(arr, x):
        i = np.clip(x.astype(np.int64), 0, arr.size - 2)
        a1 = x - i
        return (1 - a1) * arr[i] + a1 * arr[i + 1]
    c = {}
    c["co2_mask"] = (nu >= 0) & (nu < 4000)
    xw = nu * 0.5 + 1
    for k in ("296", "260", "230"):
        c["co2_cw" + k] = np.where(c["co2_mask"], edge(data["co2" + k], xw),
                                   0.0)
    c["h2o_mask"] = (nu >= 0) & (nu < 20000)
    xw = nu / 10 + 1
    for k in ("296", "260"):
        c["h2o_cw" + k] = np.where(c["h2o_mask"], edge(data["h2o" + k], xw),
                                   0.0)
    cwfrn = np.where(c["h2o_mask"], edge(data["h2ofrn"], xw), 0.0)
    xfcrev = np.array([3, 9, 15, 23, 29, 33, 37, 39, 40, 46, 36, 27, 10, 2, 0,
                       0], np.float64)
    xx = (nu * 0.1 - 82).astype(np.float32)
    ix = np.clip(xx.astype(np.int64), 0, 14)
    dx = xx - ix
    corr = 1.0 + 0.001 * ((1 - dx) * xfcrev[ix] + dx * xfcrev[ix + 1])
    c["h2o_sfac"] = np.where((nu > 820.0) & (nu < 960.0), corr,
                             np.ones_like(nu))
    vf2 = (nu - 370.0) ** 2
    fscal = 36100.0 / (vf2 + vf2 ** 3 * 1e-8 + 36100.0) * -0.25 + 1.0
    c["h2o_ctwfrn"] = cwfrn * fscal
    c["h2o_nu"] = nu
    c["n2_mask"] = (nu >= 2120) & (nu <= 2605)
    xn = np.where(c["n2_mask"], nu * 0.2 - 424, 0.0)
    c["n2_b"] = np.where(c["n2_mask"], idx(data["n2_b"], xn), 0.0)
    c["n2_beta"] = np.where(c["n2_mask"], idx(data["n2_beta"], xn), 0.0)
    c["o2_mask"] = (nu >= 1360) & (nu <= 1805)
    xo = np.where(c["o2_mask"], nu * 0.2 - 272, 0.0)
    c["o2_b"] = np.where(c["o2_mask"], idx(data["o2_b"], xo), 0.0)
    c["o2_beta"] = np.where(c["o2_mask"], idx(data["o2_beta"], xo), 0.0)
    return c


def _n2o2(b, beta, p, t, qgas, mix):
    return (0.1 * (p / P0) ** 2 * (273.0 / t) ** 2
            * torch.exp(beta * (1 / 296.0 - 1 / t)) * qgas * b * mix)


def beta_ds(flags, cc: dict, kw, ds, p, t, q_h2o, u_co2, u_h2o):
    """Extinction optical depth of a segment [..., D]: gray extinction and
    the switched-on continua (continua_core, jr_common.h:397-409)."""
    co2, h2o, n2, o2 = flags
    total = kw * ds
    if co2:
        dt230, dt260, dt296 = t - 230.0, t - 260.0, t - 296.0
        ctw = (dt260 * 5.050505e-4 * dt296 * cc["co2_cw230"]
               - dt230 * 9.259259e-4 * dt296 * cc["co2_cw260"]
               + dt230 * 4.208754e-4 * dt260 * cc["co2_cw296"])
        total = total + u_co2 * p * ctw / (NA * 1000.0 * P0)
    if h2o:
        cw296 = cc["h2o_cw296"]
        ctwslf = cc["h2o_sfac"] * cw296 * torch.pow(
            torch.where(cw296 > 0, cc["h2o_cw260"] / torch.where(
                cw296 > 0, cw296, 1.0), 1.0), (296.0 - t) / (296.0 - 260.0))
        a1 = cc["h2o_nu"] * u_h2o * torch.tanh(0.7193876 / t * cc["h2o_nu"])
        a3 = p / P0 * (q_h2o * ctwslf + (1 - q_h2o) * cc["h2o_ctwfrn"]) * 1e-20
        total = total + torch.where(cc["h2o_mask"], a1 * (296.0 / t) * a3, 0.0)
    if n2:
        mix = 0.79 + (1 - 0.79) * (1.294 - 0.4545 * t / 296.0)
        total = total + torch.where(
            cc["n2_mask"], _n2o2(cc["n2_b"], cc["n2_beta"], p, t, 0.79, mix),
            0.0) * ds
    if o2:
        total = total + torch.where(
            cc["o2_mask"], _n2o2(cc["o2_b"], cc["o2_beta"], p, t, 0.21, 1.0),
            0.0) * ds
    return total


# ---------------------------------------------------------------------------
# EGA (ega_eps / apply_ega_core, jr_common.h:157-280)

def _c01(x):
    return torch.clamp(x, 0.0, 1.0)


def _lip(x0, y0, x1, y1, x):
    d = x1 - x0
    return y0 + (x - x0) * (y1 - y0) / torch.where(d == 0, 1.0, d)


def _count_index(values, counts, x):
    """Index of the ascending search locate_id / locate_tbl_id within the
    first ``counts`` entries of each row of ``values``."""
    iota = torch.arange(values.shape[-1], device=values.device)
    below = (values <= x.unsqueeze(-1)) & (iota < counts.unsqueeze(-1))
    idx = below.sum(-1) - 1
    return torch.minimum(idx.clamp_min(0), (counts - 2).clamp_min(0))


def _last(arr, idx):
    idx = idx.clamp(0, arr.shape[-1] - 1)
    return torch.gather(arr, -1, idx.unsqueeze(-1)).squeeze(-1)


def _cell(arr, gi, i, di):
    return arr[gi, i.clamp(0, arr.shape[1] - 1), di]


def _brackets(tb, p, t, G, D):
    R = p.shape[0]
    dev = p.device
    gi = torch.arange(G, device=dev).view(1, G, 1)
    di = torch.arange(D, device=dev).view(1, 1, D)
    pb = p.view(R, 1, 1).expand(R, G, D)
    tt = t.view(R, 1, 1).expand(R, G, D)
    ipr = _count_index(tb["p"].unsqueeze(0), tb["np_"], pb)
    t_lo, t_hi = _cell(tb["t"], gi, ipr, di), _cell(tb["t"], gi, ipr + 1, di)
    nt_lo = _cell(tb["nt"], gi, ipr, di)
    nt_hi = _cell(tb["nt"], gi, ipr + 1, di)
    return (gi, di, ipr, t_lo, t_hi, nt_lo, nt_hi,
            _count_index(t_lo, nt_lo, tt), _count_index(t_hi, nt_hi, tt),
            pb, tt)


def _factor(tau_path, eps_t, no_table):
    opaque = tau_path < TAU_OPAQUE
    factor = (1.0 - eps_t) / torch.where(opaque, 1.0, tau_path)
    factor = torch.where(no_table, 1.0, factor)
    return torch.where(opaque, 0.0, factor).to(tau_path.dtype)


def ega_exact(tb: dict, tau_path, t, u_seg, p):
    """Factor of every gas's path transmittance over one segment on the
    exact tables: invert eps -> u at the path's emissivity, add the
    segment's u, look eps up again, at the four (p, T) corners, then
    bilinear in T and p."""
    G, P, T, U, D = tb["u"].shape
    dtype = tau_path.dtype
    (gi, di, ipr, t_lo, t_hi, nt_lo, nt_hi, it0, it1, pb, tt) = _brackets(
        tb, p, t, G, D)
    target = 1.0 - tau_path
    u_add = u_seg.to(dtype).unsqueeze(-1)

    def corner(dp, it):
        pc, ic = (ipr + dp).clamp(0, P - 1), it.clamp(0, T - 1)
        u_row = tb["u"][gi, pc, ic, :, di].to(dtype)
        e_row = tb["eps"][gi, pc, ic, :, di].to(dtype)
        n_u = tb["nu"][gi, pc, ic, di]
        i = _count_index(e_row, n_u, target)
        u_c = _lip(_last(e_row, i), _last(u_row, i), _last(e_row, i + 1),
                   _last(u_row, i + 1), target)
        u_new = u_c + u_add
        j = _count_index(u_row, n_u, u_new)
        return (_c01(_lip(_last(u_row, j), _last(e_row, j),
                          _last(u_row, j + 1), _last(e_row, j + 1), u_new)),
                n_u >= 2)

    e00, k00 = corner(0, it0)
    e01, k01 = corner(0, it0 + 1)
    e10, k10 = corner(1, it1)
    e11, k11 = corner(1, it1 + 1)
    ep0 = _c01(_lip(_last(t_lo, it0), e00, _last(t_lo, it0 + 1), e01, tt))
    ep1 = _c01(_lip(_last(t_hi, it1), e10, _last(t_hi, it1 + 1), e11, tt))
    pr = tb["p"].unsqueeze(0).expand(p.shape[0], G, D, -1)
    eps_t = _c01(_lip(_last(pr, ipr), ep0, _last(pr, ipr + 1), ep1, pb))
    no_table = ((tb["np_"] < 2) | (nt_lo < 2) | (nt_hi < 2)
                | ~k00 | ~k01 | ~k10 | ~k11)
    return _factor(tau_path, eps_t, no_table)


def ega_fast(tb: dict, tau_path, t, u_seg, p):
    """The same on log-uniform tables: the eps -> u inversion a halving of
    ceil(log2 K) steps with u from the grid, the forward lookup by log2
    arithmetic, never below the inverted interval."""
    G, P, T, K, D = tb["eps"].shape
    dtype = tau_path.dtype
    eps_flat = tb["eps"].reshape(G, P * T * K, D)
    l2_flat = tb["log2_u0"].reshape(G, P * T, D)
    nu_flat = tb["nu"].reshape(G, P * T, D)
    ok_flat = tb["valid"].reshape(G, P * T, D)
    (gi, di, ipr, t_lo, t_hi, nt_lo, nt_hi, it0, it1, pb, tt) = _brackets(
        tb, p, t, G, D)
    target = 1.0 - tau_path
    ratio = 2.0 ** LOG2_RATIO_U
    ipt = torch.stack([ipr * T + it0, ipr * T + it0 + 1,
                       (ipr + 1) * T + it1, (ipr + 1) * T + it1 + 1], dim=2)
    g4, d4 = gi.unsqueeze(-1), di.unsqueeze(-2)
    cell = ipt.clamp(0, P * T - 1)
    l2u0 = l2_flat[g4, cell, d4].to(dtype)
    nk = nu_flat[g4, cell, d4]
    ok = ok_flat[g4, cell, d4]
    base = ipt * K

    def gather(i):
        return eps_flat[g4, (base + i).clamp(0, P * T * K - 1), d4].to(dtype)
    target4 = target.unsqueeze(2).expand(ipt.shape)
    lo = torch.zeros_like(nk)
    hi = (nk - 1).clamp_min(1)
    for _ in range(max(1, int(np.ceil(np.log2(max(K, 2)))))):
        active = hi > lo + 1
        mid = (hi + lo) >> 1
        pred = gather(mid) > target4
        hi = torch.where(active & pred, mid, hi)
        lo = torch.where(active & ~pred, mid, lo)
    u0 = torch.exp2(l2u0 + lo.to(dtype) * LOG2_RATIO_U)
    u_c = _lip(gather(lo), u0, gather(lo + 1), u0 * ratio, target4)
    u_new = u_c + u_seg.to(dtype).view(*u_seg.shape, 1, 1)
    kf = (torch.log2(torch.clamp(u_new, min=1e-300)) - l2u0) / LOG2_RATIO_U
    ki = torch.minimum(kf.to(torch.int32).long().clamp_min(0),
                       (nk - 2).clamp_min(0))
    ki = torch.maximum(ki, lo)
    u_lo = torch.exp2(l2u0 + ki.to(dtype) * LOG2_RATIO_U)
    eps_c = _c01(_lip(u_lo, gather(ki), u_lo * ratio, gather(ki + 1), u_new))
    t00, t01 = _last(t_lo, it0).to(dtype), _last(t_lo, it0 + 1).to(dtype)
    t10, t11 = _last(t_hi, it1).to(dtype), _last(t_hi, it1 + 1).to(dtype)
    ep0 = _c01(_lip(t00, eps_c[:, :, 0], t01, eps_c[:, :, 1], tt))
    ep1 = _c01(_lip(t10, eps_c[:, :, 2], t11, eps_c[:, :, 3], tt))
    pr = tb["p"].unsqueeze(0).expand(p.shape[0], G, D, -1)
    eps_t = _c01(_lip(_last(pr, ipr).to(dtype), ep0,
                      _last(pr, ipr + 1).to(dtype), ep1, pb))
    no_table = ((tb["np_"] < 2) | (nt_lo < 2) | (nt_hi < 2) | ~ok.all(dim=2))
    return _factor(tau_path, eps_t, no_table)


def tables_on(ft: dict, u, device) -> dict:
    """The tables as tensors on ``device``, each searched axis last: p
    [G, D, P], t [G, P, D, T]; u and eps (the exact form when ``u`` is
    given) [G, P, T, K, D].  Payloads in float32 and axes in float64 as
    upstream keeps them."""
    def ten(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tb = dict(np_=ten(ft["np_"]).long(), nt=ten(ft["nt"]).long(),
              nu=ten(ft["nu"]).long(),
              p=ten(ft["p"]).permute(0, 2, 1).contiguous(),
              t=ten(ft["t"]).permute(0, 1, 3, 2).contiguous(),
              eps=ten(ft["eps"]), valid=ten(ft["valid"]),
              log2_u0=ten(ft["log2_u0"]))
    if u is not None:
        tb["u"] = ten(u)
    return tb


# ---------------------------------------------------------------------------
# Source and integration (new_obs_core, add_surface_core)

def src_planck(sr, st, t):
    n = st.shape[0]
    it = ((4.0 * t).to(torch.int32) - 400).clamp(0, n - 2).long()
    t0, t1 = st[it].unsqueeze(1), st[it + 1].unsqueeze(1)
    return sr[it] + (t.unsqueeze(1) - t0) * (sr[it + 1] - sr[it]) / (t1 - t0)


def integrate(tb: dict, exact: bool, sr, st, cc: dict, flags, ig_co2: int,
              ig_h2o: int, los: dict):
    """(rad [R, D], tau [R, D]) of the traced rays, the surface term
    included, in the dtype of ``los``."""
    dtype = los["p"].dtype
    R, S = los["ds"].shape
    G = los["u"].shape[2]
    D = sr.shape[1]
    dev = los["p"].device
    ega = ega_exact if exact else ega_fast
    sr_, st_ = sr.to(dtype), st.to(dtype)
    rad = torch.zeros((R, D), dtype=dtype, device=dev)
    tau = torch.ones((R, D), dtype=dtype, device=dev)
    tau_path = torch.ones((R, G, D), dtype=dtype, device=dev)
    zq = torch.zeros((R,), dtype=dtype, device=dev)
    for s in range(S):
        p, t, ds = los["p"][:, s], los["t"][:, s], los["ds"][:, s]
        q, u, valid = los["q"][:, s], los["u"][:, s], los["valid"][:, s]
        kw = los["k"][:, s][:, torch.zeros(D, dtype=torch.long, device=dev)]
        bds = beta_ds(flags, cc, kw, ds[:, None], p[:, None], t[:, None],
                      (q[:, ig_h2o] if ig_h2o >= 0 else zq)[:, None],
                      (u[:, ig_co2] if ig_co2 >= 0 else zq)[:, None],
                      (u[:, ig_h2o] if ig_h2o >= 0 else zq)[:, None])
        factor = ega(tb, tau_path, t, u, p)
        tau_gas = factor[:, 0]
        for g in range(1, G):
            tau_gas = tau_gas * factor[:, g]
        tau_path = torch.where(valid[:, None, None], tau_path * factor,
                               tau_path)
        src = src_planck(sr_, st_, t)
        eps = 1.0 - tau_gas * torch.exp(-bds)
        upd = valid[:, None] & (tau_gas > TAU_CUTOFF)
        rad = torch.where(upd, rad + src * eps * tau, rad)
        tau = torch.where(upd, tau * (1.0 - eps), tau)
    ts = los["tsurf"].to(dtype)
    rad = torch.where((ts > 0.0).unsqueeze(1), rad + src_planck(sr_, st_, ts)
                      * tau, rad)
    return rad, tau
