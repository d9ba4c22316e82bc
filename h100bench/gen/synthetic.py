"""A frozen copy of the program's synthetic generators (the analytic EGA
tables, the midlatitude atmosphere and the limb scan), in plain NumPy, so
that a later change to the program cannot move the inputs.  The
generators of ``gen/tables``, ``gen/geometry`` and ``gen/atmosphere``
that the configurations name are made from these.

Tables: eps(p, T, u) = 1 - exp(-(sigma(p, T) u)^0.9) on the geometric
u grid u_k = u0 2^(k/6), per (gas, channel), fixed by the configuration
(no seed: they stand for an instrument's tables).  Every (gas, p, T,
channel) cell holds all ``tblnu`` points and the same eps row.
"""
from __future__ import annotations

import math

import numpy as np

# u_k = u0 * 2^(k * LOG2_RATIO_U), the reference tables' documented grid
LOG2_RATIO_U = 1.0 / 6.0
# source-function temperature axis: 1201 levels over 100-400 K
TBLNS = 1201
C1 = 1.19104259e-8
C2 = 1.43877506
RE = 6367.421

GAS_S0 = {"CO2": 3e-22, "H2O": 8e-22, "O3": 5e-21, "F11": 2e-20,
          "CCl4": 1e-20, "HNO3": 8e-21, "CH4": 1e-21, "N2O": 2e-21}
GAS_VMR = {"CO2": 3.7e-4, "H2O": 5e-6, "O3": 3e-6, "F11": 2.5e-10,
           "CCl4": 1e-10, "HNO3": 1e-9, "CH4": 1.7e-6, "N2O": 3e-7}


def channels(cfg: dict) -> np.ndarray:
    """The channel wavenumbers [D], evenly over ``nu0``..``nu1``."""
    return np.linspace(float(cfg["nu0"]), float(cfg["nu1"]), int(cfg["nd"]))


def planck(t, nu):
    """Planck radiance [W/(m^2 sr cm^-1)]."""
    return C1 * nu ** 3 / np.expm1(C2 * nu / np.asarray(t, np.float64))


def source_table(nu: np.ndarray):
    """(sr [S, D], st [S]): Planck radiance on the 100-400 K axis."""
    st = 100.0 + 300.0 * np.arange(TBLNS) / (TBLNS - 1.0)
    return planck(st[:, None], nu[None, :]), st


def fast_tables(cfg: dict) -> dict:
    """The configuration's tables in the fast form: axes p [G, P, D]
    (ascending), t [G, P, T, D], the counts, log2_u0 [G, P, T, D]
    (float64), eps [G, P, T, K, D] (float32; every (p, T, channel) cell
    holds the same row, as in the program's generator) and the source
    table."""
    emitters = cfg["emitters"]
    G, D = len(emitters), int(cfg["nd"])
    n_p, n_t, n_k = int(cfg["tblnp"]), int(cfg["tblnt"]), int(cfg["tblnu"])
    nu = channels(cfg)
    p = np.logspace(np.log10(3e-3), np.log10(1013.25), n_p)
    t = np.linspace(160.0, 330.0, n_t)
    s0 = np.array([GAS_S0.get(g, 1e-21) for g in emitters])
    spec = 0.25 + 1.5 * np.abs(np.sin(nu / 97.0 + np.arange(1, G + 1)
                                      [:, None]))              # [G, D]
    sig = ((p[None, :, None, None] / 1013.25) ** 0.3
           * (250.0 / t[None, None, :, None]) ** 0.7
           * (s0[:, None] * spec)[:, None, None, :])            # [G,P,T,D]
    log2_u0 = np.log2(3e-4 / sig)
    k = np.arange(n_k)
    row = 1.0 - np.exp(-np.power(3e-4 * np.exp2(k * LOG2_RATIO_U), 0.9))
    eps = np.ascontiguousarray(np.broadcast_to(
        row.astype(np.float32)[None, None, None, :, None],
        (G, n_p, n_t, n_k, D)))
    sr, st = source_table(nu)
    return dict(
        np_=np.full((G, D), n_p, np.int32),
        nt=np.full((G, n_p, D), n_t, np.int32),
        p=np.ascontiguousarray(np.broadcast_to(p[None, :, None],
                                               (G, n_p, D))),
        t=np.ascontiguousarray(np.broadcast_to(t[None, None, :, None],
                                               (G, n_p, n_t, D))),
        nu=np.full((G, n_p, n_t, D), n_k, np.int32),
        log2_u0=log2_u0, eps=eps,
        valid=np.ones((G, n_p, n_t, D), bool), sr=sr, st=st)


def exact_u(ft: dict) -> np.ndarray:
    """The u rows [G, P, T, K, D] of the exact (``tbl_t``) form of
    ``ft``, u_k = u0 2^(k/6) in float64 rounded to float32, one (gas, p)
    slab at a time so that no float64 temporary of the whole table is
    made."""
    G, P, T, K, D = ft["eps"].shape
    u = np.empty((G, P, T, K, D), np.float32)
    k = np.arange(K)[None, :, None] * LOG2_RATIO_U
    for g in range(G):
        for ip in range(P):
            u[g, ip] = np.exp2(ft["log2_u0"][g, ip][:, None, :] + k)
    return u


def atmosphere(cfg: dict) -> dict:
    """The base atmosphere: z 0..``atm_ztop`` every ``atm_dz`` km, p, T
    and the emitters' vmr q [G, N]; one profile (time, lon, lat 0), no
    extinction (k [1, N] = 0)."""
    z = np.arange(0.0, float(cfg["atm_ztop"]) + 1e-9, float(cfg["atm_dz"]))
    n = z.size
    q = np.zeros((len(cfg["emitters"]), n))
    for ig, gas in enumerate(cfg["emitters"]):
        if gas == "H2O":
            q[ig] = np.maximum(4e-6 * np.exp(-z / 3.0),
                               3e-6 * np.exp(-z / 60.0))
        else:
            shape = np.exp(-z / 40.0)
            q[ig] = GAS_VMR.get(gas, 1e-9) * shape / shape[0]
    return dict(time=np.zeros(n), z=z, lon=np.zeros(n), lat=np.zeros(n),
                p=1013.25 * np.exp(-z / 7.4),
                t=(216.0 + 72.0 * np.exp(-(z / 18.0) ** 2)
                   + 30.0 * np.exp(-((z - 50.0) / 14.0) ** 2)),
                q=q, k=np.zeros((1, n)))


def _frange(x0: float, x1: float, dx: float):
    """for (x = x0; x <= x1; x += dx), as the reference's limb tool."""
    x = x0
    while x <= x1:
        yield x
        x += dx


def limb_scan(cfg: dict) -> dict:
    """The limb scan: observer at ``obsz`` km, tangent altitudes
    ``scan_z0``..``scan_z1`` every ``scan_dz`` km (float accumulation as
    limb.c:48-64), view-point latitude acos((RE + z) / (RE + obsz))."""
    obsz = float(cfg["obsz"])
    vpz = np.array(list(_frange(float(cfg["scan_z0"]), float(cfg["scan_z1"]),
                                float(cfg["scan_dz"]))))
    vplat = np.array([180.0 / math.pi * math.acos((RE + z) / (RE + obsz))
                      for z in vpz])
    nr = vpz.size
    zero = np.zeros(nr)
    return dict(time=zero.copy(), obsz=np.full(nr, obsz), obslon=zero.copy(),
                obslat=zero.copy(), vpz=vpz, vplon=zero.copy(), vplat=vplat)
