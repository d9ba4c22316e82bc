"""Synthetic analytic EGA workloads (benchmark + property-test fixtures).

Analytic emissivity model eps(p, T, u) = 1 - exp(-(sigma(p,T) u)^0.9) on
the reference tables' documented geometric u-grid u_k = u0 * 2^(k/6)
(FAST_INVERSE_OF_U, jurassic.c:518-530), built fully vectorised so a
benchmark-scale table (hundreds of MB) materialises in well under a
second.  The same model backs tools/make_synthetic_tables.py, which
writes the ASCII form consumed by the locally compiled reference binary
-- so the reference and this package can be benchmarked on identical
physics.  Copy of ``jurassic_tpu/models/synthetic.py``.
"""
from __future__ import annotations

import numpy as np

from ..config import Ctl, ctl_from_dict
from ..io_tab import Atm, Obs
from ..ops.planck import planck, source_temperature_axis
from ..tables import LOG2_RATIO_U, EgaTables, FastTables

# ordered so a prefix of any length is a sensible workload; the full
# list is the reference refspec emitter set minus the table-less N2/O2
# (example/refspec/template.ctl:10-39), so ng up to 28 matches the
# reference's NG = 30 capacity class (jurassic.h:138)
GASES = ["CO2", "H2O", "O3", "F11", "CCl4", "HNO3", "CH4", "N2O",
         "C2H2", "C2H6", "ClO", "ClONO2", "CO", "COF2", "F12", "F14",
         "F22", "H2O2", "HCN", "HNO4", "HOCl", "N2O5", "NH3", "NO",
         "NO2", "OCS", "SF6", "SO2"]
GAS_S0 = {"CO2": 3e-22, "H2O": 8e-22, "O3": 5e-21, "F11": 2e-20,
          "CCl4": 1e-20, "HNO3": 8e-21, "CH4": 1e-21, "N2O": 2e-21}
GAS_VMR = {"CO2": 3.7e-4, "H2O": 5e-6, "O3": 3e-6, "F11": 2.5e-10,
           "CCl4": 1e-10, "HNO3": 1e-9, "CH4": 1.7e-6, "N2O": 3e-7}


def synthetic_ctl(ng: int = 4, nd: int = 64, nu0: float = 700.0,
                  nu1: float = 1200.0, **over) -> Ctl:
    nu = np.linspace(nu0, nu1, nd)
    d = dict(emitter=list(GASES[:ng]), nu=[float(x) for x in nu],
             tblbase="-", write_binary=0, read_binary=0)
    d.update(over)
    return ctl_from_dict(d)


def _sigma(s0, p, t):
    """Effective cross-section [cm^2]: smooth in (p, T), matching
    tools/make_synthetic_tables.py."""
    return s0 * (p / 1013.25) ** 0.3 * (250.0 / t) ** 0.7


def synthetic_fast_tables(ctl: Ctl, n_p: int = 40, n_t: int = 30,
                          n_k: int = 224) -> FastTables:
    """Benchmark-scale FastTables, fully vectorised (no ASCII round trip)."""
    G, D = ctl.ng, ctl.nd
    p = np.logspace(np.log10(3e-3), np.log10(1013.25), n_p)     # ascending
    t = np.linspace(160.0, 330.0, n_t)
    nu = np.asarray(ctl.nu)

    # per-(gas, channel) cross-section scale: gas base x smooth spectral
    # variation so channels genuinely differ
    s0 = np.array([GAS_S0.get(g, 1e-21) for g in ctl.emitter[:G]])
    spec = 0.25 + 1.5 * np.abs(np.sin(nu / 97.0 + np.arange(1, G + 1)
                                      [:, None]))                # [G, D]
    sgd = s0[:, None] * spec

    # u0 chosen so the eps transition sits inside the grid: sigma*u0 ~ 3e-4
    sig = (_sigma(1.0, p[None, :, None, None], t[None, None, :, None])
           * sgd[:, None, None, :])                              # [G,P,T,D]
    u0 = 3e-4 / sig
    log2_u0 = np.log2(u0)

    k = np.arange(n_k)
    su = 3e-4 * np.exp2(k * LOG2_RATIO_U)                        # sigma*u_k
    eps = 1.0 - np.exp(-np.power(su, 0.9))                       # [K]
    eps = np.broadcast_to(eps[None, None, None, :, None],
                          (G, n_p, n_t, n_k, D)).astype(np.float32)

    st = source_temperature_axis()
    sr = planck(st[:, None], nu[None, :])

    return FastTables(
        np_=np.full((G, D), n_p, np.int32),
        nt=np.full((G, n_p, D), n_t, np.int32),
        p=np.broadcast_to(p[None, :, None], (G, n_p, D)).copy(),
        t=np.broadcast_to(t[None, None, :, None], (G, n_p, n_t, D)).copy(),
        nu=np.full((G, n_p, n_t, D), n_k, np.int32),
        log2_u0=log2_u0,
        eps=np.ascontiguousarray(eps),
        valid=np.ones((G, n_p, n_t, D), bool),
        sr=sr, st=st)


def fast_to_ega_tables(ft: FastTables) -> EgaTables:
    """Materialise the u payload (u_k = u0 2^(k/6)) for the exact kernel."""
    G, P, T, K, D = ft.eps.shape
    k = np.arange(K)
    u = np.exp2(ft.log2_u0[:, :, :, None, :]
                + k[None, None, None, :, None] * LOG2_RATIO_U)
    return EgaTables(np_=ft.np_, nt=ft.nt, nu=ft.nu, p=ft.p, t=ft.t,
                     u=u.astype(np.float32), eps=ft.eps, sr=ft.sr, st=ft.st)


def synthetic_atm(ctl: Ctl, dz: float = 2.0, ztop: float = 90.0) -> Atm:
    """Smooth analytic midlatitude-ish atmosphere on a 0..ztop grid."""
    z = np.arange(0.0, ztop + 1e-9, dz)
    n = z.size
    atm = Atm.zeros(n, ctl.ng, ctl.nw)
    atm.z[:] = z
    atm.p[:] = 1013.25 * np.exp(-z / 7.4)
    atm.t[:] = (216.0 + 72.0 * np.exp(-((z - 0.0) / 18.0) ** 2)
                + 30.0 * np.exp(-((z - 50.0) / 14.0) ** 2))
    for ig, gas in enumerate(ctl.emitter[: ctl.ng]):
        vmr = GAS_VMR.get(gas, 1e-9)
        shape = np.exp(-z / 40.0) if gas != "H2O" else \
            np.maximum(4e-6 * np.exp(-z / 3.0), 3e-6 * np.exp(-z / 60.0))
        atm.q[ig] = vmr * shape / shape[0] if gas != "H2O" else shape
    return atm


def limb_workload(ctl: Ctl, nr: int) -> Obs:
    """nr-ray limb scan: tangent altitudes cycling 4..64 km (the
    BASELINE.json "large ray batch" config)."""
    from .geometry_gen import limb_geometry
    base = limb_geometry(z0=4.0, z1=64.0, dz=1.0, nd=ctl.nd)
    reps = -(-nr // base.nr)
    import dataclasses
    return Obs(**{
        f.name: np.tile(np.asarray(getattr(base, f.name)),
                        (reps,) + (1,) * (getattr(base, f.name).ndim - 1)
                        )[:nr]
        for f in dataclasses.fields(Obs)})
