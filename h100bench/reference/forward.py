"""The reference's two entries: radiance and transmittance of rays
(``formod``), and the Jacobian of radiance in a retrieval's state
vector (``jacobian``, forward mode through ``torch.func.jacfwd``).

Both take the benchmark's plain inputs (``h100bench.gen``): the
configuration dict, the fast tables and, for exact tables, their u rows,
one atmosphere and the rays' geometry.  Rays are independent, so the
check runs any subset of a call's rays, in blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from . import physics as ph

GEO_KEYS = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")


class Reference:
    """Tables, continua and source on ``device``; the pass in ``dtype``
    (the table payloads stay float32 and the axes float64, as upstream
    keeps them).  ``storage``, for the precision control only: the table
    payloads and every LOS field rounded to that narrower type (the
    arithmetic stays in ``dtype``)."""

    def __init__(self, cfg: dict, ft: dict, u, device, dtype=torch.float64,
                 storage=None):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.exact, self.storage = u is not None, storage
        self.tb = ph.tables_on(ft, u, device)
        if storage is not None:
            for k in ("eps", "u"):
                if k in self.tb:
                    self.tb[k] = self.tb[k].to(storage).to(torch.float32)
        ten = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            device, torch.float64)
        self.sr, self.st = ten(ft["sr"]), ten(ft["st"])
        nu = np.linspace(float(cfg["nu0"]), float(cfg["nu1"]), int(cfg["nd"]))
        self.cc = {k: (torch.from_numpy(v).to(device) if v.dtype == bool
                       else torch.from_numpy(v).to(device, dtype))
                   for k, v in ph.continua_coeffs(nu).items()}
        em = list(cfg["emitters"])
        self.ig_co2 = em.index("CO2") if "CO2" in em else -1
        self.ig_h2o = em.index("H2O") if "H2O" in em else -1
        ctm = cfg["continua"]
        self.flags = (bool(ctm["co2"]) and self.ig_co2 >= 0,
                      bool(ctm["h2o"]) and self.ig_h2o >= 0,
                      bool(ctm["n2"]), bool(ctm["o2"]))
        self.ray = {k: cfg[k] for k in ("nlos", "rayds", "raydz", "refrac")}

    def _fields(self, atm: dict, p: np.ndarray) -> dict:
        ten = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            self.device, torch.float64)
        return dict(p=ten(p), t=ten(atm["t"]), q=ten(atm["q"]),
                    k=ten(atm["k"]))

    def _geo(self, geo: dict, rows) -> dict:
        return {k: torch.as_tensor(np.asarray(geo[k], np.float64)[rows]).to(
            self.device, torch.float64) for k in GEO_KEYS}

    def _profiles(self, atms: list, fields: list, geo: dict, rows):
        """The profiles and geometry of the rays ``rows`` of every
        atmosphere of ``atms`` (with its ``fields``), stacked on the ray
        axis: atmosphere j's rays are rows j r .. (j + 1) r - 1."""
        t = np.asarray(geo["time"])[rows]
        profs = [ph.profiles(a, t, f, torch.float64, self.device)
                 for a, f in zip(atms, fields)]
        prof = {k: torch.cat([p[k] for p in profs]) for k in profs[0]
                if k != "short"}
        prof["short"] = any(p["short"] for p in profs)
        g = self._geo(geo, rows)
        return prof, {k: v.repeat(len(atms)) for k, v in g.items()}

    def _pass(self, prof: dict, geo: dict):
        """Trace in float64, integrate in the reference's dtype."""
        los = ph.trace(self.ray, prof, geo)
        if self.storage is not None:
            los = {k: (v.to(self.storage) if v.is_floating_point() else v)
                   for k, v in los.items()}
        if self.dtype != torch.float64:
            los = {k: (v.to(self.dtype) if v.is_floating_point() else v)
                   for k, v in los.items()}
        return ph.integrate(self.tb, self.exact, self.sr, self.st, self.cc,
                            self.flags, self.ig_co2, self.ig_h2o, los)

    def _hydro_fields(self, atm: dict) -> dict:
        return self._fields(atm, ph.hydrostatic(float(self.cfg["hydz"]),
                                                atm, self.ig_h2o))

    @staticmethod
    def _groups(n: int, per: int, most: int):
        k = max(1, most // max(per, 1))
        return [range(i, min(i + k, n)) for i in range(0, n, k)]

    def formod(self, atms: list, geo: dict, rows,
               most: int = 512) -> list:
        """[(rad [r, D], tau [r, D])] (float64 NumPy) of the rays ``rows``
        in each atmosphere of ``atms``, hydrostatics applied to a copy of
        each first; as many atmospheres in one pass as ``most`` rays
        allow."""
        out = []
        r = len(rows)
        for grp in self._groups(len(atms), r, most):
            sel = [atms[j] for j in grp]
            prof, g = self._profiles(sel, [self._hydro_fields(a)
                                           for a in sel], geo, rows)
            rad, tau = (x.to(torch.float64).cpu().numpy()
                        for x in self._pass(prof, g))
            out += [(rad[i * r:(i + 1) * r], tau[i * r:(i + 1) * r])
                    for i in range(len(sel))]
        return out

    def segments(self, atms: list, geo: dict, rows,
                 most: int = 16384) -> list:
        """The valid LOS segments of the rays ``rows`` in each atmosphere
        of ``atms`` (the reference tracer's count, float64): the work a
        pass on them needs."""
        out = []
        r = len(rows)
        for grp in self._groups(len(atms), r, most):
            sel = [atms[j] for j in grp]
            prof, g = self._profiles(sel, [self._hydro_fields(a)
                                           for a in sel], geo, rows)
            v = ph.trace(self.ray, prof, g)["valid"].sum(dim=1)
            out += [int(v[i * r:(i + 1) * r].sum()) for i in range(len(sel))]
        return out

    def state(self, atm: dict):
        """The retrieval's state vector at ``atm`` after hydrostatics
        (x0), and per element its field ("t" or a gas index) and level:
        T, then each gas's vmr, at the levels within the configured
        altitude ranges (atm2x, jurassic.c:1491-1513)."""
        ret = self.cfg["retrieval"]
        z = atm["z"]
        xs, where = [], []
        sel = np.nonzero((z >= ret["t_zmin"]) & (z <= ret["t_zmax"]))[0]
        xs.append(atm["t"][sel])
        where += [("t", int(i)) for i in sel]
        for ig in range(atm["q"].shape[0]):
            sel = np.nonzero((z >= ret["q_zmin"]) & (z <= ret["q_zmax"]))[0]
            xs.append(atm["q"][ig, sel])
            where += [(ig, int(i)) for i in sel]
        return np.concatenate(xs), where

    def _state_map(self, atm: dict):
        """(x0, fields(x)) of ``atm``: the state vector after the host's
        hydrostatics, and the atmosphere's fields with x in place and p
        rebuilt from it (differentiable in x)."""
        hydz = float(self.cfg["hydz"])
        a = {k: np.array(v) for k, v in atm.items()}
        a["p"] = ph.hydrostatic(hydz, a, self.ig_h2o)
        x0, where = self.state(a)
        base = self._fields(a, a["p"])
        N, G = a["z"].size, a["q"].shape[0]
        hit_t, jx_t = np.zeros(N, bool), np.zeros(N, np.int64)
        hit_q, jx_q = np.zeros((G, N), bool), np.zeros((G, N), np.int64)
        for j, (f, i) in enumerate(where):
            if f == "t":
                hit_t[i], jx_t[i] = True, j
            else:
                hit_q[f, i], jx_q[f, i] = True, j
        dev = self.device
        hit_t, jx_t, hit_q, jx_q = (torch.from_numpy(v).to(dev) for v in
                                    (hit_t, jx_t, hit_q, jx_q))
        blocks = ph.profile_blocks(a["lon"], a["lat"]) if hydz >= 0 else []
        lats = [float(a["lat"][b0:b1][int(np.argmin(np.abs(a["z"][b0:b1]
                                                           - hydz)))])
                for b0, b1 in blocks]

        def fields(x):
            t = torch.where(hit_t, x[jx_t], base["t"])
            q = torch.where(hit_q, x[jx_q], base["q"])
            p = base["p"]
            if blocks:
                qh = q[self.ig_h2o] if self.ig_h2o >= 0 else None
                p = torch.cat([ph.hydrostatic_torch(
                    hydz, a["z"][b0:b1], lat, p[b0:b1], t[b0:b1],
                    None if qh is None else qh[b0:b1])
                    for (b0, b1), lat in zip(blocks, lats)])
            return dict(p=p, t=t, q=q, k=base["k"])
        return a, x0, fields

    def jacobian(self, atms: list, geo: dict, rows) -> list:
        """[K [r, D, n]] = d rad / d x of the rays ``rows`` at each
        atmosphere of ``atms``, in the state of :meth:`state` (float64
        NumPy): ``torch.func.jacfwd`` through the state's scatter, the
        hydrostatic rebuild (as one cumulative sum), the tracer and the
        pass, the atmospheres' states stacked into one vector so that one
        pass serves them all."""
        maps = [self._state_map(a) for a in atms]
        sizes = [m[1].size for m in maps]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        x = torch.as_tensor(np.concatenate([m[1] for m in maps])).to(
            self.device, torch.float64)

        def fwd(xx):
            fl = [m[2](xx[offs[j]:offs[j + 1]]) for j, m in enumerate(maps)]
            prof, g = self._profiles([m[0] for m in maps], fl, geo, rows)
            return self._pass(prof, g)[0]
        jac = torch.func.jacfwd(fwd)(x).to(torch.float64).cpu().numpy()
        r = len(rows)
        return [jac[j * r:(j + 1) * r, :, offs[j]:offs[j + 1]]
                for j in range(len(atms))]
