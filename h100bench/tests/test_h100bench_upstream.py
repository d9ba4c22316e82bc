"""The benchmark's plain reference against upstream's own output: the
``rad.tab`` that the upstream C code (JURASSIC's CPU build) wrote for the
cases under ``tests/goldens/`` -- ``ega``, three emitters on synthetic
exact tables, and ``limb``, refraction, continua and the source term
with no table -- read here as plain text, with upstream's inputs
(``atm.tab``, ``obs.tab``, the ``.tab`` tables and the ``.filt`` filter
functions) parsed as upstream reads them.  A witness that owes nothing
to the program: nothing of ``jurassic_torch`` or of the JAX package is
imported."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench.reference.forward import Reference

GOLD = Path(__file__).resolve().parents[2] / "tests" / "goldens"
# upstream's defaults for what the cases' control files leave unset
# (read_ctl, jurassic.c): RAYDS 10 km, RAYDZ 0.5 km, REFRAC 1, no
# hydrostatic rebuild, every continuum that a channel can see, the
# 400-point LOS budget of the GPU build
RAY = dict(nlos=400, rayds=10.0, raydz=0.5, refrac=1, hydz=-999.0)
TBLNS, TMIN, TMAX = 1201, 100.0, 400.0
C1, C2 = 1.19104259e-8, 1.43877506


def _ctl(path: Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        line = line.split("#")[0]
        if "=" in line:
            k, v = (x.strip() for x in line.split("=", 1))
            out[k] = v
    return out


def _table(path: Path):
    """[(p, [(T, [(u, eps), ...]), ...]), ...] of one table file, by
    upstream's rules (init_tbl): a new p or T opens a block; a (u, eps)
    pair that does not grow both replaces the block's last."""
    blocks = []
    p_old = t_old = u_old = e_old = -999.0
    if not path.exists():
        return blocks
    for line in path.read_text().splitlines():
        try:
            p, t, u, e = (float(x) for x in line.split()[:4])
        except ValueError:
            continue
        if p != p_old:
            p_old, t_old = p, -999.0
            blocks.append((p, []))
        if t != t_old:
            t_old = t
            blocks[-1][1].append((t, []))
        rows = blocks[-1][1][-1][1]
        if (e > e_old and u > u_old) or not rows:
            u_old, e_old = u, e
            rows.append((u, e))
        else:
            rows[-1] = (u, e)
    return blocks


def _source(filt: Path):
    """(sr [TBLNS], st [TBLNS]): the filter-weighted mean Planck radiance
    on upstream's source temperatures (init_srcfunc)."""
    nu, f = np.loadtxt(filt, comments="#", unpack=True)
    st = TMIN + (TMAX - TMIN) * np.arange(TBLNS) / (TBLNS - 1.0)
    pl = C1 * nu[None, :] ** 3 / np.expm1(C2 * nu[None, :] / st[:, None])
    return (pl * f[None, :]).sum(axis=1) / f.sum(), st


def _case(name: str):
    d = GOLD / name
    ctl = _ctl(next(d.glob("*.ctl")))
    base = Path(ctl["TBLBASE"]).name
    em = [ctl[f"EMITTER[{i}]"] for i in range(int(ctl["NG"]))]
    nus = [float(ctl[f"NU[{i}]"]) for i in range(int(ctl["ND"]))]
    G, D = len(em), len(nus)
    blocks = [[_table(d / f"{base}_{nu:.4f}_{g}.tab") for nu in nus]
              for g in em]
    P = max([2] + [len(b) for gb in blocks for b in gb])
    T = max([2] + [len(tb) for gb in blocks for b in gb for _, tb in b])
    K = max([2] + [len(r) for gb in blocks for b in gb for _, tb in b
                   for _, r in tb])
    ft = dict(np_=np.zeros((G, D), np.int32), nt=np.zeros((G, P, D), np.int32),
              nu=np.zeros((G, P, T, D), np.int32), p=np.zeros((G, P, D)),
              t=np.zeros((G, P, T, D)), eps=np.zeros((G, P, T, K, D),
                                                     np.float32),
              valid=np.zeros((G, P, T, D), bool),
              log2_u0=np.zeros((G, P, T, D)))
    u = np.zeros((G, P, T, K, D), np.float32)
    for g in range(G):
        for c in range(D):
            ft["np_"][g, c] = len(blocks[g][c])
            for ip, (p, tb) in enumerate(blocks[g][c]):
                ft["p"][g, ip, c] = p
                ft["nt"][g, ip, c] = len(tb)
                for it, (t, rows) in enumerate(tb):
                    ft["t"][g, ip, it, c] = t
                    ft["nu"][g, ip, it, c] = len(rows)
                    ue = np.array(rows)
                    u[g, ip, it, :len(rows), c] = ue[:, 0]
                    ft["eps"][g, ip, it, :len(rows), c] = ue[:, 1]
    src = [_source(d / f"{base}_{nu:.4f}.filt") for nu in nus]
    ft["sr"] = np.stack([s for s, _ in src], axis=1)
    ft["st"] = src[0][1]
    a = np.loadtxt(d / "atm.tab", comments="#", ndmin=2)
    atm = dict(time=a[:, 0], z=a[:, 1], lon=a[:, 2], lat=a[:, 3], p=a[:, 4],
               t=a[:, 5], q=a[:, 6:6 + G].T.copy(),
               k=a[:, 6 + G:].T.copy())
    o = np.loadtxt(d / "obs.tab", comments="#", ndmin=2)
    geo = dict(time=o[:, 0], obsz=o[:, 1], obslon=o[:, 2], obslat=o[:, 3],
               vpz=o[:, 4], vplon=o[:, 5], vplat=o[:, 6])
    cfg = dict(RAY, emitters=em, nd=D, nu0=nus[0], nu1=nus[-1],
               continua=dict(co2=int(any(n < 4000 for n in nus)),
                             h2o=int(any(n < 20000 for n in nus)),
                             n2=int(any(2120 <= n <= 2605 for n in nus)),
                             o2=int(any(1360 <= n <= 1805 for n in nus))))
    assert np.array_equal(np.linspace(cfg["nu0"], cfg["nu1"], D), nus)
    rad = np.loadtxt(d / "rad.tab", comments="#", ndmin=2)
    return cfg, ft, u, atm, geo, rad[:, 10:10 + D], rad[:, 10 + D:10 + 2 * D]


@pytest.mark.parametrize("case", ["ega", "limb"])
def test_reference_matches_upstream(case):
    torch.set_num_threads(1)
    cfg, ft, u, atm, geo, rad_up, tau_up = _case(case)
    if case == "ega":
        assert ft["np_"].min() >= 2 and ft["nu"].max() > 2
    else:
        assert ft["np_"].max() < 2
    ref = Reference(cfg, ft, u, torch.device("cpu"))
    (rad, tau), = ref.formod([atm], geo, np.arange(geo["vpz"].size))
    # upstream prints %g: six significant digits
    assert np.abs(rad - rad_up).max() <= 5e-6 * np.abs(rad_up).max()
    assert np.abs(tau - tau_up).max() <= 2e-6
