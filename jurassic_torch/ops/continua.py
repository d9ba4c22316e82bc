"""Per-channel continuum coefficients (port of
``jurassic_tpu/ops/continua.py:33-126``).

Every wavenumber-dependent coefficient of continua_ctm{co2,h2o,n2,o2}
(jr_common.h:316-390) depends only on the static channel grid, so it is
precomputed on the host in float64 NumPy.  The runtime arithmetic lives
in the fused EGA pass (``ops/ega_fused.py``), which reads these
coefficients packed as rows (``pack_continua``).  The coefficient data is
the package's own ``data/continua.npz`` (a byte copy of the JAX
package's).
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..config import Ctl

_DATA = Path(__file__).resolve().parent.parent / "data" / "continua.npz"


@lru_cache(maxsize=1)
def _load():
    with np.load(_DATA) as f:
        return {k: f[k] for k in f.files}


class ContinuaCoeffs(NamedTuple):
    """Per-channel precomputed continuum coefficients (all [D] float64)."""

    # CO2 (jr_common.h:316-331)
    co2_mask: np.ndarray
    co2_cw296: np.ndarray
    co2_cw260: np.ndarray
    co2_cw230: np.ndarray
    # H2O (jr_common.h:334-362)
    h2o_mask: np.ndarray
    h2o_cw296: np.ndarray
    h2o_cw260: np.ndarray
    h2o_ctwfrn: np.ndarray   # cwfrn * fscal (both channel-only)
    h2o_sfac: np.ndarray
    h2o_nu: np.ndarray
    # N2 / O2 (jr_common.h:365-390)
    n2_mask: np.ndarray
    n2_b: np.ndarray
    n2_beta: np.ndarray
    o2_mask: np.ndarray
    o2_b: np.ndarray
    o2_beta: np.ndarray


def _edge_interp(arr: np.ndarray, xw: np.ndarray):
    """cw = (1-dw)*arr[iw-1] + dw*arr[iw] with iw = int(xw)
    (jr_common.h:320-325)."""
    iw = xw.astype(np.int64)
    dw = xw - iw
    lo = np.clip(iw - 1, 0, arr.size - 1)
    hi = np.clip(iw, 0, arr.size - 1)
    return (1 - dw) * arr[lo] + dw * arr[hi]


def _idx_interp(arr: np.ndarray, x: np.ndarray):
    """val = (1-a1)*arr[idx] + a1*arr[idx+1], idx = int(x)
    (jr_common.h:368-372)."""
    idx = np.clip(x.astype(np.int64), 0, arr.size - 2)
    a1 = x - idx
    return (1 - a1) * arr[idx] + a1 * arr[idx + 1]


def precompute_continua(ctl: Ctl) -> ContinuaCoeffs:
    data = _load()
    nu = np.asarray(ctl.nu, dtype=np.float64)

    # CO2: xw = nu/2 + 1 over the 0..4000 cm^-1 grid
    co2_mask = (nu >= 0) & (nu < 4000)
    xw = nu * 0.5 + 1
    co2_cw296 = np.where(co2_mask, _edge_interp(data["co2296"], xw), 0.0)
    co2_cw260 = np.where(co2_mask, _edge_interp(data["co2260"], xw), 0.0)
    co2_cw230 = np.where(co2_mask, _edge_interp(data["co2230"], xw), 0.0)

    # H2O: xw = nu/10 + 1 over 0..20000 cm^-1
    h2o_mask = (nu >= 0) & (nu < 20000)
    xw = nu / 10 + 1
    h2o_cw296 = np.where(h2o_mask, _edge_interp(data["h2o296"], xw), 0.0)
    h2o_cw260 = np.where(h2o_mask, _edge_interp(data["h2o260"], xw), 0.0)
    cwfrn = np.where(h2o_mask, _edge_interp(data["h2ofrn"], xw), 0.0)
    # 820-960 cm^-1 self-continuum correction (jr_common.h:345-351)
    xfcrev = np.array([3, 9, 15, 23, 29, 33, 37, 39, 40, 46, 36, 27,
                       10, 2, 0, 0], dtype=np.float64)
    sfac = np.ones_like(nu)
    in_band = (nu > 820.0) & (nu < 960.0)
    xx = (nu * 0.1 - 82).astype(np.float32)  # float in the reference
    ix = np.clip(xx.astype(np.int64), 0, 14)
    dx = xx - ix
    corr = 1.0 + 0.001 * ((1 - dx) * xfcrev[ix] + dx * xfcrev[ix + 1])
    sfac = np.where(in_band, corr, sfac)
    # foreign-continuum scale factor (channel-only, jr_common.h:353-357)
    vf2 = (nu - 370.0) ** 2
    vf6 = vf2 ** 3
    fscal = 36100.0 / (vf2 + vf6 * 1e-8 + 36100.0) * -0.25 + 1.0
    h2o_ctwfrn = cwfrn * fscal

    # N2: 5 cm^-1 grid over 2120..2605
    n2_mask = (nu >= 2120) & (nu <= 2605)
    xn = np.where(n2_mask, nu * 0.2 - 424, 0.0)
    n2_b = np.where(n2_mask, _idx_interp(data["n2_b"], xn), 0.0)
    n2_beta = np.where(n2_mask, _idx_interp(data["n2_beta"], xn), 0.0)

    # O2: 5 cm^-1 grid over 1360..1805
    o2_mask = (nu >= 1360) & (nu <= 1805)
    xo = np.where(o2_mask, nu * 0.2 - 272, 0.0)
    o2_b = np.where(o2_mask, _idx_interp(data["o2_b"], xo), 0.0)
    o2_beta = np.where(o2_mask, _idx_interp(data["o2_beta"], xo), 0.0)

    return ContinuaCoeffs(
        co2_mask=co2_mask, co2_cw296=co2_cw296, co2_cw260=co2_cw260,
        co2_cw230=co2_cw230,
        h2o_mask=h2o_mask, h2o_cw296=h2o_cw296, h2o_cw260=h2o_cw260,
        h2o_ctwfrn=h2o_ctwfrn, h2o_sfac=sfac, h2o_nu=nu,
        n2_mask=n2_mask, n2_b=n2_b, n2_beta=n2_beta,
        o2_mask=o2_mask, o2_b=o2_b, o2_beta=o2_beta)
