"""Planck function, brightness temperature and the source-function table.

Scalar physics mirrors of planck (jurassic.c:860), brightness
(jurassic.c:210 / brightness_core jr_common.h:189-190) and the source
table construction (init_tbl, jurassic.c:612-667): a uniform temperature
axis 100..400 K and, per channel, the filter-weighted Planck radiance.
"""
from __future__ import annotations

import numpy as np

from ..constants import C1, C2
from ..config import TBLNS


def planck(t, nu):
    """Planck radiance [W/(m^2 sr cm^-1)] at temperature t [K], wavenumber
    nu [cm^-1]."""
    t = np.asarray(t, dtype=np.float64)
    return C1 * nu ** 3 / np.expm1(C2 * nu / t)


def brightness(rad, nu):
    """Brightness temperature [K] from radiance (inverse Planck)."""
    rad = np.asarray(rad, dtype=np.float64)
    return C2 * nu / np.log1p(C1 * nu ** 3 / rad)


def source_temperature_axis(n: int = TBLNS) -> np.ndarray:
    """Uniform 100..400 K axis, 0.25 K steps at the default n=1201
    (jurassic.c:613-615); src lookups index it as (int)(4*t)-400
    (locate_st, jr_common.h:83-84)."""
    return 100.0 + (400.0 - 100.0) * np.arange(n) / (n - 1.0)


def source_table_from_filter(nu_filter: np.ndarray, f_filter: np.ndarray,
                             n: int = TBLNS) -> np.ndarray:
    """Per-channel source radiance: filter-weighted mean Planck radiance
    over the filter grid, for each source temperature
    (jurassic.c:657-665)."""
    st = source_temperature_axis(n)
    fsum = np.sum(f_filter)
    # [n, npts] Planck matrix contracted with the filter weights
    fp = planck(st[:, None], nu_filter[None, :]) * f_filter[None, :]
    return np.sum(fp, axis=1) / fsum
