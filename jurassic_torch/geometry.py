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
double-precision reference), float32 on CUDA.  :func:`trace_rays` runs
this plain version (:func:`trace_rays_ref`) on CPU tensors and the
hand-written CUDA kernel ``csrc/trace_rays.cu`` (one warp per ray, the
same order of operations; ``ops/trace.py``) on CUDA tensors.  The hydrostatic
equilibrium at the end is host-side float64 NumPy, copied from the JAX
package (which keeps it in NumPy too), with its differentiable tensor
twin for ``retrieval.kernel_autodiff``.
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
ENTRY_ERROR = "entry-point bisection did not converge"


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
        raise ValueError(
            "the tracer's profiles are vertical (IP = 1, as on the "
            "reference's device path, jr_common.h:573,581); ForwardModel "
            "runs IP = 2/3 through its host pencil path (pencil_trace)")
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
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
            device, dtype)

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
    each ray stops in the state its while loop would have stopped in.

    The ``any()`` syncs see observer geometry only (``xobs``, ``ex0``,
    ``norm`` and the profile tops ``zmax`` come from the observation and
    the atmosphere's altitude grid), never a tensor that carries a
    tangent: ``retrieval.kernel_autodiff`` runs the tracer under
    ``torch.func.jacfwd``, where a Python branch on the state would fail.
    """
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
            raise RuntimeError(ENTRY_ERROR)
    return x


def trace_rays(ctl: Ctl, prof: RayProfiles, obs_geo: dict) -> LosData:
    """Trace all rays in the dtype and on the device of ``prof``
    (raytrace_rays_CPU / raytrace_rays_GPU, CPUdrivers.c:89-95,
    GPUdrivers.cu:151-157).

    CPU tensors run the plain version :func:`trace_rays_ref`; CUDA tensors
    launch the tracer kernel (``csrc/trace_rays.cu``, one warp per ray)
    or raise, and a bisection that did not converge raises here after one
    device-to-host read of its flag (:func:`trace_rays_deferred` leaves
    that read to the caller)."""
    los, flag = trace_rays_deferred(ctl, prof, obs_geo)
    check_entry_flag(flag.cpu().numpy())
    return los


def trace_rays_deferred(ctl: Ctl, prof: RayProfiles, obs_geo: dict):
    """(LosData, flag) as :func:`trace_rays` traces them, with no host
    sync: ``flag`` [R] int32 marks the rays whose entry-point bisection
    did not converge, for the caller's own pull to pass to
    :func:`check_entry_flag` (zeros on the CPU, where the plain version
    raises itself)."""
    dev = prof.z.device
    if dev.type == "cpu":
        return (trace_rays_ref(ctl, prof, obs_geo),
                torch.zeros(prof.z.shape[0], dtype=torch.int32))
    if dev.type != "cuda":
        raise ValueError(f"trace_rays: unsupported device {dev}")
    from .ops.trace import trace_rays_cuda
    return trace_rays_cuda(prof, obs_geo, float(ctl.rayds),
                           float(ctl.raydz), bool(ctl.refrac), int(ctl.nlos))


def check_entry_flag(flag) -> None:
    """Raise as the plain version does where any ray's entry-point
    bisection did not converge (``flag`` pulled to the host)."""
    if np.any(np.asarray(flag) > 0.5):
        raise RuntimeError(ENTRY_ERROR)


def trace_rays_ref(ctl: Ctl, prof: RayProfiles, obs_geo: dict) -> LosData:
    """Trace all rays in plain PyTorch, in the dtype and on the device of
    ``prof`` (raytrace_rays_CPU, CPUdrivers.c:89-95): the step loop is
    batched over rays, the per-ray arithmetic is that of the JAX
    ``_trace_single`` (geometry.py:283-480).  The tracer kernel's plain
    version, and the tracer ``retrieval.kernel_autodiff`` differentiates
    on any device."""
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
            # the offset points are stacked, not written into a clone:
            # xh2 carries tangents under torch.func once REFRAC = 1
            xps = [xh2]
            for i in range(3):
                xps.append(torch.stack([xh2[:, j] + h if j == i
                                        else xh2[:, j] for j in range(3)],
                                       dim=1))
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
    return _finish_los(st, ok, tsurf, z_low_idx, og)[0]


def _finish_los(st: dict, ok, tsurf, z_low_idx, og: dict):
    """(LosData, corr_at, corr_idx) from the stacked per-step records
    ``st`` of the step loop: the ds correction, the tangent point, the
    trapezoid rule and the column densities.  ``corr_at`` [R, NLOS] marks
    the point whose ds took the escape correction, ``corr_idx`` [R] the
    step that recorded it (for the tangents of
    :func:`trace_rays_jvp_ref`)."""
    valid = st["valid"]
    R, nlos = valid.shape
    np_ = valid.sum(dim=1, dtype=torch.int32)
    iota = torch.arange(nlos, device=valid.device)

    # escape segment-length correction of the point before the boundary
    # point (los[np-1].ds = ds*frac, jr_common.h:646); at most one per ray
    ds = st["ds"]
    corr = st["ds_corr"]
    has_corr = ~torch.isnan(corr)
    corr_idx = torch.where(has_corr, iota, nlos).min(dim=1).values
    any_corr = has_corr.any(dim=1)
    corr_val = torch.gather(corr, 1, corr_idx.clamp(max=nlos - 1)
                            .unsqueeze(1))[:, 0]
    corr_at = any_corr.unsqueeze(1) \
        & (iota.unsqueeze(0) == (corr_idx - 1).unsqueeze(1))
    ds = torch.where(corr_at,
                     torch.where(any_corr, corr_val, 0.0).unsqueeze(1), ds)

    # tangent point from the pre-trapezoid segment lengths
    # (tangent_point, jr_common.h:503-539)
    tpz, tplon, tplat = tangent_point(st["z"], st["lon"], st["lat"], ds,
                                      z_low_idx, np_)
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

    los = LosData(
        z=st["z"], lon=st["lon"], lat=st["lat"], p=p, t=t, q=st["q"],
        k=st["k"], ds=ds_trap, u=u, valid=valid, np_=np_,
        tsurf=torch.where(ok, tsurf, -999.0),
        tpz=tpz, tplon=tplon, tplat=tplat)
    return los, corr_at, corr_idx.clamp(max=nlos - 1)


# ---------------------------------------------------------------------------
# Forward-mode tangents of the tracer (retrieval.kernel_autodiff)

class ProfileTangents(NamedTuple):
    """Tangents of the rays' profiles in n directions of the state, kept
    at the atm points: ray r's level l is atm point ``gi[r, l]``
    (``ray_window_indices``), so rays that share a profile share its
    tangents."""

    d: torch.Tensor    # [N, 2 + G + W, n]: p, t, q[G], k[W] per atm point
    gi: torch.Tensor   # [R, L] int64


class LosTangents(NamedTuple):
    """Tangents of the LOS fields the RT pass reads, n innermost
    (:func:`los_tangent_fields` names the rows of ``seg``)."""

    seg: torch.Tensor    # [R, NLOS, 3 + 2 G + W, n]: p, t, q, k, u, ds
    tsurf: torch.Tensor  # [R, n]


def los_tangent_fields(tan: LosTangents, G: int, W: int) -> dict:
    """Views of ``tan`` by LOS field: p, t, ds [R, NLOS, n], q, u
    [R, NLOS, G, n], k [R, NLOS, W, n] and tsurf [R, n]."""
    s = tan.seg
    return {"p": s[:, :, 0], "t": s[:, :, 1], "q": s[:, :, 2:2 + G],
            "k": s[:, :, 2 + G:2 + G + W],
            "u": s[:, :, 2 + G + W:2 + 2 * G + W],
            "ds": s[:, :, 2 + 2 * G + W], "tsurf": tan.tsurf}


def _dot3t(a, da):
    """_dot3 of a [R, 3] with a tangent da [R, 3, n]: [R, n]."""
    return a[:, 0, None] * da[:, 0] + a[:, 1, None] * da[:, 1] \
        + a[:, 2, None] * da[:, 2]


def _lin_partials(x0, y0, x1, y1, x):
    """:func:`_lin` and its partials in y0, y1 and x."""
    w = (x - x0) / (x1 - x0)
    return _lin(x0, y0, x1, y1, x), 1.0 - w, w, (y1 - y0) / (x1 - x0)


def _eip_partials(x0, y0, x1, y1, x):
    """:func:`_eip` (the same operations) and its partials in y0, y1 and
    x: with e = y0 exp(s (x - x0)), s = log(y1 / y0) / (x1 - x0) and
    w = (x - x0) / (x1 - x0), they are exp(.) (1 - w), e w / y1 and e s;
    the linear fallback's where it takes that."""
    ok = (y0 > 0) & (y1 > 0)
    y0s = torch.where(ok, y0, 1.0)
    y1s = torch.where(ok, y1, 1.0)
    s = torch.log(y1s / y0s) / (x1 - x0)
    ee = torch.exp(s * (x - x0))
    e = y0s * ee
    v, a, b, c = _lin_partials(x0, y0, x1, y1, x)
    return (torch.where(ok, e, v), torch.where(ok, ee * (1.0 - b), a),
            torch.where(ok, e * b / y1s, b), torch.where(ok, e * s, c))


def _take_tan(dP, i, short: bool):
    """Per-ray profile tangents dP [R, L, F, n] at levels i [R, k]:
    [R, k, F, n], zero below a one-level window's only level (as
    :func:`_take_lo` reads 0 there)."""
    R, k = i.shape
    idx = i.clamp_min(0).view(R, k, 1, 1).expand(R, k, *dP.shape[2:])
    v = torch.gather(dP, 1, idx)
    return torch.where((i >= 0).view(R, k, 1, 1), v, 0.0) if short else v


def _interp_partials(prof: RayProfiles, z0):
    """The interval index i [R, k] of altitudes z0 [R, k], p (eip) and t
    (lin) there with their partials in the lower and upper level's value
    and in z0 (``interp_pt``'s operations): (i, (p, pa, pb, pz),
    (t, ta, tb, tz), w, zb - za)."""
    i = _interval_index(prof, z0)
    za, zb = _take_lo(prof, prof.z, i), _take(prof.z, i + 1)
    pp = _eip_partials(za, _take_lo(prof, prof.p, i), zb,
                       _take(prof.p, i + 1), z0)
    tt = _lin_partials(za, _take_lo(prof, prof.t, i), zb,
                       _take(prof.t, i + 1), z0)
    return i, pp, tt, za, zb


def trace_rays_jvp(ctl: Ctl, prof: RayProfiles, ptan: ProfileTangents,
                   obs_geo: dict):
    """(LosData, LosTangents, flag): the rays of :func:`trace_rays` and
    the tangents of the fields the RT pass reads, in the dtype and on the
    device of ``prof``.  CPU tensors run the plain version
    :func:`trace_rays_jvp_ref` (which raises where a bisection does not
    converge; ``flag`` zeros); CUDA tensors launch the tracer's record
    and tangent kernels (``csrc/trace_rays_jvp.cu``, ``ops/trace_jvp.py``)
    or raise, and ``flag`` [R] int32 marks a bisection that did not
    converge, for the caller's pull (:func:`check_entry_flag`)."""
    dev = prof.z.device
    if dev.type == "cpu":
        los, tan = trace_rays_jvp_ref(ctl, prof, ptan, obs_geo)
        return los, tan, torch.zeros(prof.z.shape[0], dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"trace_rays_jvp: unsupported device {dev}")
    from .ops.trace_jvp import trace_rays_jvp_cuda
    return trace_rays_jvp_cuda(prof, ptan, obs_geo, float(ctl.rayds),
                               float(ctl.raydz), bool(ctl.refrac),
                               int(ctl.nlos))


def trace_rays_jvp_ref(ctl: Ctl, prof: RayProfiles, ptan: ProfileTangents,
                       obs_geo: dict):
    """(LosData, LosTangents): the rays of :func:`trace_rays_ref`, bit for
    bit, and the forward-mode tangents of the fields the RT pass reads in
    the n directions of ``ptan``, in plain PyTorch batched over rays x
    tangents -- the plain version of ``csrc/trace_rays_jvp.cu``'s two
    kernels (each stated on its own by :func:`trace_step_records_ref` and
    :func:`trace_tangents_from_records_ref`), with explicit tangent
    rules.

    z carries no tangent (it is never a state element), so neither do
    zmin, zmax and the entry point.  With REFRAC 1 the refractivity
    bends the ray and the step positions, altitudes and lengths carry
    tangents; the interval indices are piecewise constant, so tangents
    flow through the interpolation weights and through d(value)/dz dz.
    The escape clip's xh = geo2cart(cart2geo(px)) is px, so its tangent
    is px's.  Every step runs for every ray, stopped or not."""
    dev, dt = prof.z.device, prof.z.dtype
    R = prof.z.shape[0]
    G = prof.q.shape[1]
    nlos = int(ctl.nlos)
    rayds, raydz = float(ctl.rayds), float(ctl.raydz)
    refrac = bool(ctl.refrac)
    og = {k: torch.as_tensor(v).to(dev, dt) for k, v in obs_geo.items()}
    zmin, zmax = prof.zmin, prof.zmax
    dP = ptan.d.to(dev, dt)[ptan.gi.to(dev)]            # [R, L, F, n]
    nt = dP.shape[-1]

    xobs = geo2cart(og["obsz"], og["obslon"], og["obslat"])
    xvp = geo2cart(og["vpz"], og["vplon"], og["vplat"])
    ex0 = xvp - xobs
    norm = torch.sqrt(_dot3(ex0, ex0))
    ex0 = ex0 / norm.unsqueeze(1)
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
    # tangents of the position, direction, last point and its altitude,
    # and of tsurf, [R, 3, n] / [R, n]
    dx = torch.zeros((R, 3, nt), dtype=dt, device=dev)
    dex, dpx = dx, dx
    dpz = torch.zeros((R, nt), dtype=dt, device=dev)
    dtsurf = dpz
    touts = {k: [] for k in ("p", "t", "q", "k", "ds", "ds_corr")}
    col = lambda a: a.unsqueeze(1)                       # [R] -> [R, 1]

    for ip in range(nlos):
        # step length (jr_common.h:625-635)
        ds = torch.full((R,), rayds, dtype=dt, device=dev)
        dds = torch.zeros((R, nt), dtype=dt, device=dev)
        radius = torch.sqrt(_dot3(x, x))
        if raydz > 0.0:
            norm_x = 1.0 / torch.sqrt(_dot3(x, x))
            exx = _dot3(ex, x)
            c = exx * norm_x
            cosa = torch.abs(c)
            inv = raydz / cosa
            ds = torch.where(cosa != 0.0, torch.clamp(inv, max=rayds), ds)
            dnorm = -col(norm_x * norm_x) * _dot3t(x, dx) / col(radius)
            dc = (_dot3t(x, dex) + _dot3t(ex, dx)) * col(norm_x) \
                + col(exx) * dnorm
            rc = 1.0 / cosa
            dds = torch.where(col((cosa != 0.0) & (inv <= rayds)),
                              col(-raydz * rc * rc * torch.sign(c)) * dc, 0.0)
        dz = _dot3t(x, dx) / col(radius)

        z, lon, lat = cart2geo(x)

        # escape clipping (jr_common.h:637-648)
        below = z < zmin
        escaped = below | (z > zmax)
        xh = geo2cart(pz, plon, plat)
        zfrac = torch.where(below, zmin, zmax)
        same = z == pz
        den = torch.where(same, 1.0, z - pz)
        frac = (zfrac - pz) / den
        xe = xh + frac.unsqueeze(1) * (x - xh)
        ze, lone, late = cart2geo(xe)
        ds_corr = torch.where(escaped, ds * frac, nan)
        dden = torch.where(col(same), 0.0, dz - dpz)
        dfrac = (-dpz - col(frac) * dden) / col(den)
        dxe = dpx + dfrac.unsqueeze(1) * (x - xh).unsqueeze(2) \
            + frac.view(R, 1, 1) * (dx - dpx)
        dze = _dot3t(xe, dxe) / col(torch.sqrt(_dot3(xe, xe)))
        dds_corr = dds * col(frac) + col(ds) * dfrac

        x = torch.where(escaped.unsqueeze(1), xe, x)
        z = torch.where(escaped, ze, z)
        lon = torch.where(escaped, lone, lon)
        lat = torch.where(escaped, late, lat)
        ds = torch.where(escaped, 0.0, ds)
        e2, e3 = col(escaped), escaped.view(R, 1, 1)
        dx = torch.where(e3, dxe, dx)
        dz = torch.where(e2, dze, dz)
        dds = torch.where(e2, 0.0, dds)

        # interp_all at z, with its tangents
        zc = z.unsqueeze(1)
        i, (p, pa, pb, pzp), (t, ta, tb, tzp), za, zb = \
            _interp_partials(prof, zc)
        za3, zb3, zc3 = za.unsqueeze(1), zb.unsqueeze(1), zc.unsqueeze(1)
        q = _lin(za3, _take_lo(prof, prof.q, i), zb3, _take(prof.q, i + 1),
                 zc3)
        k = _lin(za3, _take_lo(prof, prof.k, i), zb3, _take(prof.k, i + 1),
                 zc3)
        p, t, q, k = p[:, 0], t[:, 0], q[..., 0], k[..., 0]
        lo = _take_tan(dP, i, prof.short)[:, 0]             # [R, F, n]
        hi = _take_tan(dP, i + 1, False)[:, 0]
        d_p = pa * lo[:, 0] + pb * hi[:, 0] + pzp * dz
        d_t = ta * lo[:, 1] + tb * hi[:, 1] + tzp * dz
        w = tb.unsqueeze(1)                                  # [R, 1, 1]

        def lin_t(rows, lo_v, hi_v):
            slope = ((_take(rows, i + 1) - _take_lo(prof, rows, i))
                     / (zb3 - za3))                          # [R, C, 1]
            return (1.0 - w) * lo_v + w * hi_v + slope * dz.unsqueeze(1)
        d_q = lin_t(prof.q, lo[:, 2:2 + G], hi[:, 2:2 + G])
        d_k = lin_t(prof.k, lo[:, 2 + G:], hi[:, 2 + G:])

        active = ok & ~stopped
        is_low = active & (z < z_low)
        z_low = torch.where(is_low, z, z_low)
        z_low_idx = torch.where(is_low, ip, z_low_idx)

        stopping = active & escaped
        tsurf = torch.where(stopping & below, t, tsurf)
        dtsurf = torch.where(col(stopping & below), d_t, dtsurf)

        for key, val in (("z", z), ("lon", lon), ("lat", lat), ("p", p),
                         ("t", t), ("q", q), ("k", k), ("ds", ds),
                         ("ds_corr", torch.where(stopping, ds_corr, nan)),
                         ("valid", active)):
            outs[key].append(val)
        for key, val in (("p", d_p), ("t", d_t), ("q", d_q), ("k", d_k),
                         ("ds", dds),
                         ("ds_corr", torch.where(col(stopping), dds_corr,
                                                 0.0))):
            touts[key].append(val)

        # direction update with optional refraction (jr_common.h:664-690)
        if refrac:
            r0 = refractivity(p, t)
            nn = 1.0 + r0
            xh2 = x + (0.5 * ds).unsqueeze(1) * ex
            h = 0.02
            xps = [xh2]
            for j in range(3):
                xps.append(torch.stack([xh2[:, m] + h if m == j
                                        else xh2[:, m] for m in range(3)],
                                       dim=1))
            zq = torch.stack([torch.sqrt(_dot3(v, v)) - RE for v in xps],
                             dim=1)
            i4, (pq, pa4, pb4, pz4), (tq, ta4, tb4, tz4), _, _ = \
                _interp_partials(prof, zq)
            nq = refractivity(pq, tq)
            g = (nq[:, 1:] - nq[:, :1]) / h
            use = (z <= Z_REFRAC)
            nfac = torch.where(use, nn, 1.0)
            ng = torch.where(use.unsqueeze(1), g, 0.0)
            ex1 = ex * nfac.unsqueeze(1) + ds.unsqueeze(1) * ng
            # every offset point moves with the midpoint
            dxh2 = dx + (0.5 * dds).unsqueeze(1) * ex.unsqueeze(2) \
                + (0.5 * ds).view(R, 1, 1) * dex
            dzq = torch.stack([_dot3t(v, dxh2)
                               / col(torch.sqrt(_dot3(v, v)))
                               for v in xps], dim=1)         # [R, 4, n]
            lo4 = _take_tan(dP, i4, prof.short)
            hi4 = _take_tan(dP, i4 + 1, False)
            e4 = lambda a: a.unsqueeze(2)
            dpq = e4(pa4) * lo4[:, :, 0] + e4(pb4) * hi4[:, :, 0] \
                + e4(pz4) * dzq
            dtq = e4(ta4) * lo4[:, :, 1] + e4(tb4) * hi4[:, :, 1] \
                + e4(tz4) * dzq
            dnq = (7.753e-05 * dpq - e4(nq) * dtq) / e4(tq)
            dnn = (7.753e-05 * d_p - col(r0) * d_t) / col(t)
            dg = (dnq[:, 1:] - dnq[:, :1]) / h               # [R, 3, n]
            dnf = torch.where(col(use), dnn, 0.0)
            dng = torch.where(use.view(R, 1, 1), dg, 0.0)
            dex1 = dex * nfac.view(R, 1, 1) + ex.unsqueeze(2) \
                * dnf.unsqueeze(1) + dds.unsqueeze(1) * ng.unsqueeze(2) \
                + ds.view(R, 1, 1) * dng
        else:
            ex1, dex1 = ex, dex
        en = torch.sqrt(_dot3(ex1, ex1))
        ex1 = ex1 / en.unsqueeze(1)
        dex1 = (dex1 - ex1.unsqueeze(2) * _dot3t(ex1, dex1).unsqueeze(1)) \
            / en.view(R, 1, 1)
        x_new = x + (0.5 * ds).unsqueeze(1) * (ex + ex1)
        dx_new = dx + (0.5 * dds).unsqueeze(1) * (ex + ex1).unsqueeze(2) \
            + (0.5 * ds).view(R, 1, 1) * (dex + dex1)

        advance = (active & ~stopping).unsqueeze(1)
        dpx, dpz = dx, dz
        x = torch.where(advance, x_new, x)
        ex = torch.where(advance, ex1, ex)
        dx = torch.where(advance.unsqueeze(2), dx_new, dx)
        dex = torch.where(advance.unsqueeze(2), dex1, dex)
        stopped = stopped | stopping | ~ok
        pz, plon, plat = z, lon, lat

    st = {k: torch.stack(v, dim=1) for k, v in outs.items()}
    los, corr_at, corr_idx = _finish_los(st, ok, tsurf, z_low_idx, og)
    T = {k: torch.stack(v, dim=1) for k, v in touts.items()}

    # the ds correction, the trapezoid rule and the column densities
    dcorr = torch.gather(T["ds_corr"], 1,
                         corr_idx.view(R, 1, 1).expand(R, 1, nt))
    dds = torch.where(corr_at.unsqueeze(2), dcorr, T["ds"])   # [R, S, n]
    dds_prev = torch.cat([torch.zeros_like(dds[:, :1]), dds[:, :-1]], dim=1)
    dds_trap = 0.5 * (dds_prev + dds)
    p, t, q = st["p"].unsqueeze(2), st["t"].unsqueeze(2), st["q"]
    d_p, d_t, d_q = T["p"].unsqueeze(2), T["t"].unsqueeze(2), T["q"]
    a = 10.0 * q * p                                     # [R, S, G]
    da = 10.0 * (d_q * p.unsqueeze(3) + q.unsqueeze(3) * d_p)
    b = KB * t
    cq = a / b
    dcq = (da - cq.unsqueeze(3) * (KB * d_t)) / b.unsqueeze(3)
    ds_trap = los.ds.view(R, nlos, 1, 1)
    du = dcq * ds_trap + cq.unsqueeze(3) * dds_trap.unsqueeze(2)
    seg = torch.cat([d_p, d_t, d_q, T["k"], du, dds_trap.unsqueeze(2)],
                    dim=2)
    return los, LosTangents(seg=seg,
                            tsurf=torch.where(col(ok), dtsurf, 0.0))


# ---------------------------------------------------------------------------
# The Jacobian's two tracer kernels, stated plainly: the record kernel's
# step records, and the tangent kernel's rules applied to them

# A step's record (``jrec`` in csrc/trace_common.cuh): (name, values) in
# its order, values of the profiles' dtype, integers and flags exact.
# "own" holds, per altitude m < 5 (z, then refraction's midpoint and its
# three offset points; with REFRAC 0 z five times), TRACE_OWN_FIELDS.
TRACE_RECORD_FIELDS = (
    ("x0", 3), ("ex0", 3), ("radius", 1), ("norm_x", 1), ("exx", 1),
    ("dds_dc", 1), ("den", 1), ("frac", 1), ("ds_pre", 1), ("rxe", 1),
    ("xh", 3), ("xe", 3), ("rv", 4), ("xh2", 3), ("ng", 3), ("ex1", 3),
    ("nfac", 1), ("z", 1), ("ds", 1), ("en", 1), ("iq", 5), ("flags", 1),
    ("own", 40), ("pad", 1))
TRACE_OWN_FIELDS = ("t", "r", "pa", "pb", "pz", "ta", "tb", "tz")
TRACE_RECORD_FLAGS = ("ds_var", "escaped", "below", "same", "stopping",
                      "advance", "corr", "use")     # bit i of "flags"
# the fields that are partials, computed in another order than the plain
# version's tangent rules; every other field is the primal chain's
TRACE_RECORD_PARTIALS = ("dds_dc", "own")
# a ray's record: the step of its ds correction (-1: none), the
# correction, whether the ray is traced (1 / 0)
TRACE_RAY_FIELDS = ("corr_idx", "corr_val", "ok", "pad")


class TraceRecords(NamedTuple):
    """What the Jacobian's record kernel writes for its tangent kernel."""

    step: torch.Tensor   # [R, NLOS, 84]: TRACE_RECORD_FIELDS
    ray: torch.Tensor    # [R, 4]: TRACE_RAY_FIELDS


def trace_record_fields(step: torch.Tensor) -> dict:
    """Views of step records [..., 84] by TRACE_RECORD_FIELDS name, the
    last axis kept ("own" as [..., 5, 8])."""
    out, at = {}, 0
    for name, width in TRACE_RECORD_FIELDS:
        out[name] = step[..., at:at + width]
        at += width
    out["own"] = out["own"].unflatten(-1, (5, len(TRACE_OWN_FIELDS)))
    return out


def trace_step_records_ref(ctl: Ctl, prof: RayProfiles,
                           obs_geo: dict) -> TraceRecords:
    """The step and ray records of the Jacobian's record kernel
    (``csrc/trace_rays_jvp.cu``) in plain PyTorch, batched over rays, in
    the dtype and on the device of ``prof``: the plain primal of
    :func:`trace_rays_ref`, and at each step its input position and
    direction and the values the tangent rules read, computed as the
    kernel's step computes them (the partials of p and t in the order of
    its ``RecLin::own_partials``), 0 where the step does not reach them.
    Every step runs, stopped or not; a stopped ray at its fixed point
    repeats its record bit for bit, which the kernel relies on."""
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
    ok = (og["obsz"] >= zmin) & (og["vpz"] <= zmax - 0.001)
    x = torch.where((og["obsz"] > zmax).unsqueeze(1),
                    _entry_point(xobs, ex0, norm, zmax), xobs)
    ex = ex0
    stopped = ~ok
    zero = torch.zeros(R, 1, dtype=dt, device=dev)
    pz, plon, plat = zero[:, 0], zero[:, 0], zero[:, 0]
    corr_idx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    corr_val = zero[:, 0]
    col = lambda a: a.unsqueeze(1)
    keep = lambda m, v: torch.where(col(m), v if v.dim() == 2 else col(v),
                                    0.0)
    steps = []
    for ip in range(nlos):
        f = dict.fromkeys(("norm_x", "exx", "dds_dc", "nfac", "pad"), zero)
        f.update(x0=x, ex0=ex, xh2=zero.expand(R, 3), ng=zero.expand(R, 3),
                 rv=zero.expand(R, 4))
        # step length (jr_common.h:625-635)
        radius = torch.sqrt(_dot3(x, x))
        ds = torch.full((R,), rayds, dtype=dt, device=dev)
        ds_var = torch.zeros(R, dtype=torch.bool, device=dev)
        if raydz > 0.0:
            norm_x = 1.0 / radius
            exx = _dot3(ex, x)
            cc = exx * norm_x
            cosa = torch.abs(cc)
            nz = cosa != 0.0
            rc = 1.0 / cosa
            ds = torch.where(nz, torch.clamp(rc * raydz, max=rayds), ds)
            ds_var = nz & (rc * raydz <= rayds)
            sign = torch.where(cc > 0.0, 1.0, -1.0).to(dt)
            f.update(norm_x=keep(nz, norm_x), exx=keep(nz, exx),
                     dds_dc=keep(nz, -raydz * rc * rc * sign))
        z = radius - RE

        # escape clipping (jr_common.h:637-648)
        below = z < zmin
        escaped = below | (z > zmax)
        xh = geo2cart(pz, plon, plat)
        zfrac = torch.where(below, zmin, zmax)
        same = z == pz
        den = torch.where(same, 1.0, z - pz)
        frac = (zfrac - pz) / den
        xe = xh + col(frac) * (x - xh)
        rxe = torch.sqrt(_dot3(xe, xe))
        ds_corr = torch.where(escaped, ds * frac, float("nan"))
        f.update(den=keep(escaped, den), frac=keep(escaped, frac),
                 ds_pre=keep(escaped, ds), rxe=keep(escaped, rxe),
                 xh=keep(escaped, xh), xe=keep(escaped, xe), radius=col(radius))
        x = torch.where(col(escaped), xe, x)
        z = torch.where(escaped, rxe - RE, z)
        ds = torch.where(escaped, 0.0, ds)

        # p and t at z and, with refraction, at the step's midpoint and
        # its three offset points: interval indices and partials
        hds = 0.5 * ds
        zq = col(z)
        if refrac:
            h = 0.02
            xh2 = x + col(hds) * ex
            vs = [xh2] + [torch.stack([xh2[:, j] + h if j == m else xh2[:, j]
                                       for j in range(3)], dim=1)
                          for m in range(3)]
            rv = torch.stack([torch.sqrt(_dot3(v, v)) for v in vs], dim=1)
            zq = torch.cat([zq, rv - RE], dim=1)
            f.update(xh2=xh2, rv=rv)
        i = _interval_index(prof, zq)
        za, zb = _take_lo(prof, prof.z, i), _take(prof.z, i + 1)
        pa, pb = _take_lo(prof, prof.p, i), _take(prof.p, i + 1)
        ta, tb = _take_lo(prof, prof.t, i), _take(prof.t, i + 1)
        p = _eip(za, pa, zb, pb, zq)
        t = _lin(za, ta, zb, tb, zq)
        inv = 1.0 / (zb - za)
        w = (zq - za) * inv
        eok = (pa > 0) & (pb > 0)
        own = {"t": t, "r": torch.zeros_like(t),
               "pa": torch.where(eok, p * (1.0 - w) / pa, 1.0 - w),
               "pb": torch.where(eok, p * w / pb, w),
               "pz": torch.where(eok, p * (torch.log(pb / pa) * inv),
                                 (pb - pa) * inv),
               "ta": 1.0 - w, "tb": w, "tz": (tb - ta) * inv}
        iq = torch.cat([i.to(dt), zero.expand(R, 4)], dim=1) \
            if not refrac else i.to(dt)
        use = torch.zeros(R, dtype=torch.bool, device=dev)
        ex1 = ex
        if refrac:
            # direction update (jr_common.h:664-690)
            own["r"] = refractivity(p, t)
            use = z <= Z_REFRAC
            nfac = torch.where(use, 1.0 + own["r"][:, 0], 1.0)
            ng = torch.where(col(use), (own["r"][:, 2:] - own["r"][:, 1:2])
                             / h, 0.0)
            ex1 = ex * col(nfac) + col(ds) * ng
            f.update(nfac=col(nfac), ng=ng)
        else:   # every lane interpolates z
            own = {k: v.expand(R, 5) for k, v in own.items()}
        en = torch.sqrt(_dot3(ex1, ex1))
        ex1 = ex1 / col(en)

        active = ok & ~stopped
        stopping = active & escaped
        advance = active & ~escaped
        corr = stopping & (corr_idx < 0) & ~torch.isnan(ds_corr)
        bits = (ds_var, escaped, below, escaped & same, stopping, advance,
                corr, use)
        flags = sum(b.to(torch.int64) << k for k, b in enumerate(bits))
        f.update(ex1=ex1, z=col(z), ds=col(ds), en=col(en), iq=iq,
                 flags=col(flags.to(dt)),
                 own=torch.stack([own[k] for k in TRACE_OWN_FIELDS],
                                 dim=2).flatten(1))
        steps.append(torch.cat([f[k] for k, _ in TRACE_RECORD_FIELDS],
                               dim=1))
        corr_idx = torch.where(corr, ip, corr_idx)
        corr_val = torch.where(corr, ds_corr, corr_val)

        _, plon, plat = cart2geo(x)
        pz = z
        x = torch.where(col(advance), x + col(hds) * (ex + ex1), x)
        ex = torch.where(col(advance), ex1, ex)
        stopped = stopped | stopping | ~ok
    ray = torch.stack([corr_idx.to(dt), corr_val, ok.to(dt), zero[:, 0]],
                      dim=1)
    return TraceRecords(step=torch.stack(steps, dim=1), ray=ray)


def trace_tangents_from_records_ref(ctl: Ctl, prof: RayProfiles,
                                    ptan: ProfileTangents, los: LosData,
                                    rec: TraceRecords) -> LosTangents:
    """The Jacobian's tangent kernel (``csrc/trace_rays_jvp.cu``) in plain
    PyTorch, batched over rays x tangents: its rules applied to the
    records ``rec`` (:func:`trace_step_records_ref`'s, or the record
    kernel's) in step order, in its order of operations, with the LOS
    ``los`` (p, t, ds, q) for the column densities; the trapezoid rule in
    the step loop, and the step before a ray's ds correction finished by
    the step that records the correction.  With the records of
    :func:`trace_step_records_ref` it gives :func:`trace_rays_jvp_ref`'s
    tangents."""
    dev, dt = prof.z.device, prof.z.dtype
    R, S = rec.step.shape[:2]
    G = prof.q.shape[1]
    W = prof.k.shape[1]
    F, fds, fu = 3 + 2 * G + W, 2 + 2 * G + W, 2 + G + W
    dP = ptan.d.to(dev, dt)[ptan.gi.to(dev)]            # [R, L, F', n]
    nt = dP.shape[-1]
    fields = trace_record_fields(rec.step)
    flags = fields["flags"][..., 0].to(torch.int64)     # [R, S]
    corr_idx = rec.ray[:, 0].to(torch.int64)
    col = lambda a: a.unsqueeze(-1)                     # [R] -> [R, 1]
    v3 = lambda a: a.view(R, 1, 1)
    seg = torch.zeros((R, S, F, nt), dtype=dt, device=dev)
    dx = torch.zeros((R, 3, nt), dtype=dt, device=dev)
    dex, dpx = dx, dx
    dpz = torch.zeros((R, nt), dtype=dt, device=dev)
    dtsurf = dcorr = dds_prev = dds_pc = dp_c = dt_c = dpz
    rows = torch.cat([prof.q, prof.k], dim=1)           # [R, G + W, L]

    def column(dq, qv, p, t, dp, dtt, ds, trap):
        """u's tangent [R, G, n] of a step from its q tangents dq."""
        b = KB * t
        cq = 10.0 * qv * col(p) / col(b)                # [R, G]
        return (10.0 * (dq * v3(p) + col(qv) * dp.unsqueeze(1))
                - col(cq) * (KB * dtt).unsqueeze(1)) / v3(b) * v3(ds) \
            + col(cq) * trap.unsqueeze(1)

    for ip in range(S):
        rc = {k: v[:, ip] for k, v in fields.items()}
        one = lambda k: rc[k][:, 0]
        fl = flags[:, ip]
        bit = lambda name: (fl >> TRACE_RECORD_FLAGS.index(name)) & 1 == 1
        own = rc["own"]                                 # [R, 5, 8]
        o = lambda m, k: col(own[:, m, TRACE_OWN_FIELDS.index(k)])
        x0, ex0 = rc["x0"], rc["ex0"]
        # step length
        dr = _dot3t(x0, dx) / col(one("radius"))
        norm_x = col(one("norm_x"))
        dnorm = -(norm_x * norm_x) * dr
        dc = (_dot3t(x0, dex) + _dot3t(ex0, dx)) * norm_x \
            + col(one("exx")) * dnorm
        dds = torch.where(col(bit("ds_var")), col(one("dds_dc")) * dc, 0.0)
        # the escape clip
        esc, frac = bit("escaped"), one("frac")
        dden = torch.where(col(bit("same")), 0.0, dr - dpz)
        dfrac = (-dpz - col(frac) * dden) / col(one("den"))
        dx_e = dpx + dfrac.unsqueeze(1) * (x0 - rc["xh"]).unsqueeze(2) \
            + v3(frac) * (dx - dpx)
        dds_corr = dds * col(frac) + col(one("ds_pre")) * dfrac
        dz = torch.where(col(esc), _dot3t(rc["xe"], dx_e) / col(one("rxe")),
                         dr)
        dx = torch.where(v3(esc), dx_e, dx)
        dds = torch.where(col(esc), 0.0, dds)

        # p and t at z, then q and k; the trapezoid rule and u
        iq = rc["iq"].to(torch.int64)

        def at(m, fs):
            """The profile tangents of fields fs at altitude m's lower and
            upper level: [R, len(fs), n] each."""
            i = iq[:, m:m + 1]
            return (_take_tan(dP, i, prof.short)[:, 0, fs],
                    _take_tan(dP, i + 1, False)[:, 0, fs])
        lo, hi = at(0, slice(None))
        dp = o(0, "pa") * lo[:, 0] + o(0, "pb") * hi[:, 0] + o(0, "pz") * dz
        dtt = o(0, "ta") * lo[:, 1] + o(0, "tb") * hi[:, 1] + o(0, "tz") * dz
        i0 = iq[:, :1]
        za = _take_lo(prof, prof.z, i0)
        inv = 1.0 / (_take(prof.z, i0 + 1) - za)        # [R, 1]
        w = ((rc["z"] - za) * inv).unsqueeze(1)         # [R, 1, 1]
        slope = (_take(rows, i0 + 1) - _take_lo(prof, rows, i0)) \
            * inv.unsqueeze(1)                          # [R, G + W, 1]
        dv = (1.0 - w) * lo[:, 2:] + w * hi[:, 2:] + slope * dz.unsqueeze(1)
        fix = (corr_idx == ip) & (corr_idx >= 1)
        defer = corr_idx - 1 == ip
        trap = 0.5 * (torch.where(col(fix), dds_corr, dds_prev) + dds)
        seg[:, ip, 0], seg[:, ip, 1], seg[:, ip, 2:fu] = dp, dtt, dv
        seg[:, ip, fu:fds] = column(dv[:, :G], los.q[:, ip], los.p[:, ip],
                                    los.t[:, ip], dp, dtt, los.ds[:, ip],
                                    trap)
        seg[:, ip, fds] = trap
        dtsurf = torch.where(col(bit("stopping") & bit("below")), dtt,
                             dtsurf)
        dcorr = torch.where(col(bit("corr")), dds_corr, dcorr)
        if ip >= 1 and bool(fix.any()):
            # the step before, its raw ds the correction (jr_common.h:646)
            tr = 0.5 * (dds_pc + dcorr)
            u1 = column(seg[:, ip - 1, 2:2 + G], los.q[:, ip - 1],
                        los.p[:, ip - 1], los.t[:, ip - 1], dp_c, dt_c,
                        los.ds[:, ip - 1], tr)
            seg[:, ip - 1, fu:fds] = torch.where(v3(fix), u1,
                                                 seg[:, ip - 1, fu:fds])
            seg[:, ip - 1, fds] = torch.where(col(fix), tr,
                                              seg[:, ip - 1, fds])
        dds_pc = torch.where(col(defer), dds_prev, dds_pc)
        dp_c = torch.where(col(defer), dp, dp_c)
        dt_c = torch.where(col(defer), dtt, dt_c)
        dds_prev = dds

        # the direction: refraction at z and at the midpoint and its
        # three offset points, normalised
        ds, dhds = one("ds"), 0.5 * dds
        hds = 0.5 * ds
        dex1 = dex
        if ctl.refrac:
            h = 0.02
            dxh2 = dx + dhds.unsqueeze(1) * ex0.unsqueeze(2) + v3(hds) * dex
            xd = _dot3t(rc["xh2"], dxh2)
            dn = []
            for m in range(5):
                dzm = dz
                if m > 0:
                    off = dxh2[:, m - 2] if m > 1 else torch.zeros_like(xd)
                    dzm = (xd + h * off) / col(rc["rv"][:, m - 1])
                lo, hi = at(m, slice(0, 2))
                dpm = o(m, "pa") * lo[:, 0] + o(m, "pb") * hi[:, 0] \
                    + o(m, "pz") * dzm
                dtm = o(m, "ta") * lo[:, 1] + o(m, "tb") * hi[:, 1] \
                    + o(m, "tz") * dzm
                dn.append((7.753e-05 * dpm - o(m, "r") * dtm) / o(m, "t"))
            use = bit("use")
            dnf = torch.where(col(use), dn[0], 0.0)
            dg = torch.where(v3(use), torch.stack(
                [(dn[j] - dn[1]) / h for j in (2, 3, 4)], dim=1), 0.0)
            dex1 = dex * v3(one("nfac")) + ex0.unsqueeze(2) \
                * dnf.unsqueeze(1) + dds.unsqueeze(1) * rc["ng"].unsqueeze(2) \
                + v3(ds) * dg
        ex1 = rc["ex1"]
        proj = _dot3t(ex1, dex1)
        dex1n = (dex1 - ex1.unsqueeze(2) * proj.unsqueeze(1)) \
            / v3(one("en"))
        dpx, dpz = dx, dz
        adv = v3(bit("advance"))
        dx = torch.where(adv, dx + dhds.unsqueeze(1) * (ex0 + ex1)
                         .unsqueeze(2) + v3(hds) * (dex + dex1n), dx)
        dex = torch.where(adv, dex1n, dex)
    ok = rec.ray[:, 2] != 0.0
    return LosTangents(seg=seg, tsurf=torch.where(col(ok), dtsurf, 0.0))


# ---------------------------------------------------------------------------
# Hydrostatic equilibrium (hydrostatic_1d_h2o, jr_common.h:728-761)


def tangent_point(zarr, lonarr, latarr, ds, ipl, np_):
    """Tangent points (tpz, tplon, tplat) [R] of traced rays
    (tangent_point, jr_common.h:503-539): a parabola through the lowest
    LOS point ``ipl`` and its neighbours where that point lies inside the
    path (the limb case), else the last point.

    A deviation from the JAX package (``geometry.py:439-451``), which keeps
    the NaN: where the segment after the lowest point has no horizontal
    extent (dx12 = 0) the fit would divide by zero, so the ray takes the
    last point.  In float32 this is the ground clip's zero-length
    duplicate: a step lands exactly on z = 0 and the clip adds a second
    point there with ds = 0, after the lowest one.  The C oracle, in
    double, gets the clipped point as the lowest and takes it too."""
    nlos = zarr.shape[1]

    def at(arr, i):
        return torch.gather(arr, 1, i.unsqueeze(1))[:, 0]

    ips = ipl.clamp(1, nlos - 2)
    yy0, yy1, yy2 = at(zarr, ips - 1), at(zarr, ips), at(zarr, ips + 1)
    ds0, ds1 = at(ds, ips), at(ds, ips + 1)
    dyy10, dyy21 = yy1 - yy0, yy2 - yy1
    x1 = torch.sqrt(torch.clamp(ds0 * ds0 - dyy10 * dyy10, min=0.0))
    x2 = x1 + torch.sqrt(torch.clamp(ds1 * ds1 - dyy21 * dyy21, min=0.0))
    dx12 = x1 - x2
    limb_case = (ipl > 0) & (ipl < np_ - 1) & (dx12 != 0)
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
    return (torch.where(limb_case, tpz_limb, at(zarr, last)),
            torch.where(limb_case, tplon_limb, at(lonarr, last)),
            torch.where(limb_case, tplat_limb, at(latarr, last)))

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


def hydrostatic_profile_torch(ctl_hydz: float, z: np.ndarray, p, t, q_h2o,
                              lat0: float):
    """Differentiable hydrostatic rebuild (hydrostatic_1d_h2o,
    jr_common.h:728-761) for ``retrieval.kernel_autodiff``: the twin of
    the JAX package's ``hydrostatic_profile_jnp`` (geometry.py:548-578).

    The reference's two sequential recursions
    ``p[ip] = p[ip-+1] * exp(-1000 * mean * (z[ip] - z[ip-+1]))`` are one
    cumulative sum in log-pressure around the reference level, which is
    chosen on the host.  ``z`` and ``lat0`` are host values (the z-only
    terms are float64 NumPy, as in JAX); ``p``, ``t`` and ``q_h2o`` are
    tensors that may carry tangents, and the result takes their dtype
    and device."""
    z = np.asarray(z, np.float64)
    ipref = int(np.argmin(np.abs(z - ctl_hydz)))
    npts = 20
    w = np.arange(npts) / (npts - 1.0)                       # [S]
    zz = z[:-1, None] + (z[1:] - z[:-1])[:, None] * w        # [L, S]
    grav = (9.780318 * (1.0 + 0.0053024 * np.sin(lat0 * DEG2RAD) ** 2
                        - 5.8e-6 * np.sin(2 * lat0 * DEG2RAD) ** 2)
            - 3.086e-3 * zz)

    def ten(a):
        return torch.as_tensor(a, dtype=t.dtype, device=t.device)
    wt, dz = ten(w), ten(z[1:] - z[:-1])
    e = torch.zeros_like(t) if q_h2o is None else q_h2o
    tt = t[:-1, None] + (t[1:] - t[:-1])[:, None] * wt
    ee = e[:-1, None] + (e[1:] - e[:-1])[:, None] * wt
    mean = torch.sum((ee * MM_H2O + (1 - ee) * MM_AIR) * ten(grav)
                     / (RGAS * tt * npts), dim=1)            # [L]
    inc = 1000.0 * mean * dz
    c = torch.cat([torch.zeros_like(inc[:1]), torch.cumsum(inc, 0)])
    return torch.exp(torch.log(p[ipref]) - (c - c[ipref]))


def profile_blocks(atm: Atm) -> list[tuple[int, int]]:
    """(start, end) of each run of equal (lon, lat) on the atm point axis:
    the profiles the hydrostatic rebuild takes one by one (hydrostatic,
    jurassic.c:263-276)."""
    lon0 = lat0 = -999.0
    ip0 = 0
    blocks = []
    for ip in range(atm.npts):
        if atm.lon[ip] != lon0 or atm.lat[ip] != lat0:
            if ip > 0:
                blocks.append((ip0, ip))
            lon0, lat0, ip0 = atm.lon[ip], atm.lat[ip], ip
    blocks.append((ip0, atm.npts))
    return blocks


def hydrostatic_atm(ctl: Ctl, atm: Atm) -> Atm:
    """Apply hydrostatic equilibrium to each (lon,lat,time) profile in atm
    (hydrostatic, jurassic.c:263-276)."""
    if ctl.hydz < 0:
        return atm
    if ctl.checkmode:
        print("# apply hydrostatic equation to individual profiles")
        return atm
    ig_h2o = ctl.emitter_index("H2O")
    for (a, b) in profile_blocks(atm):
        qh = atm.q[ig_h2o, a:b] if ig_h2o >= 0 else None
        atm.p[a:b] = hydrostatic_profile(
            ctl.hydz, atm.z[a:b], atm.p[a:b], atm.t[a:b], qh, atm.lat[a:b])
    return atm
