"""Embedded midlatitude climatology (0-120 km, 27 gases).

The port's own copy of ``jurassic_tpu/climatology.py`` with its own
``data/climatology.npz`` (a byte copy).  Re-expresses the reference
``climatology()`` (jurassic.c:79-140) with the same embedded data
(src/climatology.tbl, extracted by tools/extract_ref_data.py): pressure
is interpolated exponentially, temperature and trace-gas vmr linearly,
CO2 follows a linear-in-time trend, extinction is zeroed.
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from .config import Ctl
from .io_tab import Atm

_DATA = Path(__file__).parent / "data" / "climatology.npz"

# Gas name (as used in ctl EMITTER entries) -> array key in climatology.npz
GAS_KEYS = {
    "C2H2": "c2h2", "C2H6": "c2h6", "CCL4": "ccl4", "CH4": "ch4",
    "CLO": "clo", "CLONO2": "clono2", "CO": "co", "COF2": "cof2",
    "F11": "f11", "F12": "f12", "F14": "f14", "F22": "f22",
    "H2O": "h2o", "H2O2": "h2o2", "HCN": "hcn", "HNO3": "hno3",
    "HNO4": "hno4", "HOCL": "hocl", "N2O": "n2o", "N2O5": "n2o5",
    "NH3": "nh3", "NO": "no", "NO2": "no2", "O3": "o3", "OCS": "ocs",
    "SF6": "sf6", "SO2": "so2",
}


@lru_cache(maxsize=1)
def load_climatology() -> dict[str, np.ndarray]:
    with np.load(_DATA) as f:
        return {k: f[k] for k in f.files}


def _locate(xx: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vectorized interval index identical to locate() (jr_common.h:88-104)
    for ascending grids: result in [0, n-2], ties go to the left interval's
    right edge (xx[i] > x moves the upper bound)."""
    return np.clip(np.searchsorted(xx, x, side="right") - 1, 0, xx.size - 2)


def _lin(x0, y0, x1, y1, x):
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _exp(x0, y0, x1, y1, x):
    ok = (y0 > 0) & (y1 > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.where(ok, y0 * np.exp(np.log(np.where(ok, y1 / y0, 1.0))
                                     / (x1 - x0) * (x - x0)), 0.0)
    return np.where(ok, e, _lin(x0, y0, x1, y1, x))


def climatology(ctl: Ctl, atm: Atm) -> Atm:
    """Fill p, t, q, k of ``atm`` from the embedded climatology at the
    grid-point altitudes/times already present in ``atm``."""
    data = load_climatology()
    z, pre, tem = data["z"], data["pre"], data["tem"]
    ig_co2 = ctl.emitter_index("CO2")

    iz = _locate(z, atm.z)
    atm.p[:] = _exp(z[iz], pre[iz], z[iz + 1], pre[iz + 1], atm.z)
    atm.t[:] = _lin(z[iz], tem[iz], z[iz + 1], tem[iz + 1], atm.z)
    for ig in range(ctl.ng):
        key = GAS_KEYS.get(ctl.emitter[ig].upper())
        if key is None:
            if ctl.emitter[ig].upper() != "CO2":
                print(f"# Warning! no climatology table for emitter "
                      f"{ctl.emitter[ig]}")
            atm.q[ig, :] = 0.0
        else:
            qt = data[key]
            atm.q[ig, :] = _lin(z[iz], qt[iz], z[iz + 1], qt[iz + 1], atm.z)
    if ig_co2 >= 0:
        # Linear-in-time CO2 trend (jurassic.c:135)
        atm.q[ig_co2, :] = (371.789948e-6
                            + 2.026214e-6 * (atm.time - 63158400.0) / 31557600.0)
    atm.k[:, :] = 0.0
    return atm
