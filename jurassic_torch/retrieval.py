"""Retrieval interface, first half: state and measurement vectors.

Copy of the NumPy pack/unpack half of ``jurassic_tpu/retrieval.py``
(``:30-120``), which ``io_tab.write_matrix`` needs:

* state-vector pack/unpack ``atm2x``/``x2atm`` (jurassic.c:1491-1513,
  1473-1488) selecting pressure/temperature/vmr/extinction grid points
  inside the configured retrieval altitude ranges;
* measurement-vector pack/unpack ``obs2y``/``y2obs``
  (jurassic.c:1528-1541, 1516-1526) over finite radiance cells.

The Jacobians (``kernel``, ``kernel_autodiff``) are not ported yet
(ROADMAP.md).  GSL vectors/matrices become plain NumPy arrays.
"""
from __future__ import annotations

import numpy as np

from .config import Ctl
from .io_tab import Atm, Obs

# Quantity indices (IDXP/IDXT/IDXQ/IDXK, jurassic.h:200-209)
IDXP = 0
IDXT = 1


def idxq(ig: int) -> int:
    return 2 + ig


def idxk(ctl: Ctl, iw: int) -> int:
    return 2 + ctl.ng + iw


def idx2name(ctl: Ctl, idx: int) -> str:
    """Quantity index -> name (idx2name, jurassic.c:1300-1307)."""
    if idx == IDXP:
        return "PRESSURE"
    if idx == IDXT:
        return "TEMPERATURE"
    if 2 <= idx < 2 + ctl.ng:
        return ctl.emitter[idx - 2]
    if 2 + ctl.ng <= idx < 2 + ctl.ng + ctl.nw:
        return f"EXTINCT_WINDOW{idx - 2 - ctl.ng}"
    raise ValueError(f"Unknown quantity index {idx}")


def _ranges(ctl: Ctl):
    """(zmin, zmax, quantity-index) triplets in reference pack order."""
    out = [(ctl.retp_zmin, ctl.retp_zmax, IDXP),
           (ctl.rett_zmin, ctl.rett_zmax, IDXT)]
    out += [(ctl.retq_zmin[ig], ctl.retq_zmax[ig], idxq(ig))
            for ig in range(ctl.ng)]
    out += [(ctl.retk_zmin[iw], ctl.retk_zmax[iw], idxk(ctl, iw))
            for iw in range(ctl.nw)]
    return out


def _field(atm: Atm, iqa: int, ctl: Ctl) -> np.ndarray:
    if iqa == IDXP:
        return atm.p
    if iqa == IDXT:
        return atm.t
    if iqa < 2 + ctl.ng:
        return atm.q[iqa - 2]
    return atm.k[iqa - 2 - ctl.ng]


def atm2x(ctl: Ctl, atm: Atm):
    """Pack the state vector (atm2x, jurassic.c:1491-1513).

    Returns (x, iqa, ipa): values, quantity indices, grid-point indices."""
    xs, iqas, ipas = [], [], []
    for zmin, zmax, iqa in _ranges(ctl):
        sel = np.nonzero((atm.z >= zmin) & (atm.z <= zmax))[0]
        xs.append(_field(atm, iqa, ctl)[sel])
        iqas.append(np.full(sel.size, iqa, np.int32))
        ipas.append(sel.astype(np.int32))
    return (np.concatenate(xs) if xs else np.zeros(0),
            np.concatenate(iqas) if iqas else np.zeros(0, np.int32),
            np.concatenate(ipas) if ipas else np.zeros(0, np.int32))


def x2atm(ctl: Ctl, x: np.ndarray, atm: Atm) -> Atm:
    """Unpack a state vector into atm in place (x2atm,
    jurassic.c:1473-1488)."""
    n = 0
    for zmin, zmax, iqa in _ranges(ctl):
        sel = np.nonzero((atm.z >= zmin) & (atm.z <= zmax))[0]
        _field(atm, iqa, ctl)[sel] = x[n:n + sel.size]
        n += sel.size
    if n != x.size:
        raise ValueError(f"State vector size mismatch: {x.size} != {n}")
    return atm


def obs2y(ctl: Ctl, obs: Obs):
    """Pack the measurement vector over finite radiances (obs2y,
    jurassic.c:1528-1541).  Returns (y, ida, ira)."""
    finite = np.isfinite(obs.rad)                  # [R, D]
    ira, ida = np.nonzero(finite)
    return obs.rad[ira, ida], ida.astype(np.int32), ira.astype(np.int32)


def y2obs(ctl: Ctl, y: np.ndarray, obs: Obs) -> Obs:
    """Unpack a measurement vector into obs.rad in place (y2obs,
    jurassic.c:1516-1526)."""
    finite = np.isfinite(obs.rad)
    if y.size != int(finite.sum()):
        raise ValueError("Measurement vector size mismatch")
    obs.rad[finite] = y
    return obs
