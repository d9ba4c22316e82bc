"""Continuum absorption for CO2, H2O, N2 and O2 (port of
``jurassic_tpu/ops/continua.py``).

Every wavenumber-dependent coefficient of continua_ctm{co2,h2o,n2,o2}
(jr_common.h:316-390) depends only on the static channel grid, so it is
precomputed on the host in float64 NumPy (:func:`precompute_continua`).
The runtime arithmetic exists twice: in the fused EGA pass
(``ops/ega_fused.py``, float32, coefficients packed as rows by
``pack_continua``) and here (:func:`beta_ds`, elementwise tensor code in
the dtype of its inputs), which the eager pipeline
(``forward.rt_integrate``) runs.  The coefficient data is the package's
own ``data/continua.npz`` (a byte copy of the JAX package's).
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np

import torch

from ..config import Ctl
from ..constants import NA, P0

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


def continua_to_device(cc: ContinuaCoeffs, dtype, device) -> ContinuaCoeffs:
    """The coefficients as tensors of ``dtype`` on ``device`` (the masks
    as bool), for :func:`beta_ds`."""
    def ten(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a))
        return t.to(device) if a.dtype == bool else t.to(device, dtype)
    return ContinuaCoeffs(*(ten(f) for f in cc))


def continua_co2(cc, p, t, u_co2):
    """CO2 continuum optical depth (jr_common.h:316-331).
    p, t, u_co2 broadcast against the [D] coefficients."""
    dt230 = t - 230.0
    dt260 = t - 260.0
    dt296 = t - 296.0
    ctw = (dt260 * 5.050505e-4 * dt296 * cc.co2_cw230
           - dt230 * 9.259259e-4 * dt296 * cc.co2_cw260
           + dt230 * 4.208754e-4 * dt260 * cc.co2_cw296)
    return u_co2 * p * ctw / (NA * 1000.0 * P0)


def continua_h2o(cc, p, t, q_h2o, u_h2o):
    """H2O self+foreign continuum optical depth (jr_common.h:334-362)."""
    ctwslf = cc.h2o_sfac * cc.h2o_cw296 * torch.pow(
        torch.where(cc.h2o_cw296 > 0, cc.h2o_cw260 / torch.where(
            cc.h2o_cw296 > 0, cc.h2o_cw296, 1.0), 1.0),
        (296.0 - t) / (296.0 - 260.0))
    a1 = cc.h2o_nu * u_h2o * torch.tanh(0.7193876 / t * cc.h2o_nu)
    a2 = 296.0 / t
    a3 = p / P0 * (q_h2o * ctwslf + (1 - q_h2o) * cc.h2o_ctwfrn) * 1e-20
    return torch.where(cc.h2o_mask, a1 * a2 * a3, 0.0)


def _n2o2_core(b, beta, p, t, qgas, mix):
    t0, tr = 273.0, 296.0
    return (0.1 * (p / P0) ** 2 * (t0 / t) ** 2
            * torch.exp(beta * (1 / tr - 1 / t)) * qgas * b * mix)


def continua_n2(cc, p, t):
    """N2 absorption coefficient [1/km] (jr_common.h:365-376)."""
    q_n2 = 0.79
    mix = q_n2 + (1 - q_n2) * (1.294 - 0.4545 * t / 296.0)
    val = _n2o2_core(cc.n2_b, cc.n2_beta, p, t, q_n2, mix)
    return torch.where(cc.n2_mask, val, 0.0)


def continua_o2(cc, p, t):
    """O2 absorption coefficient [1/km] (jr_common.h:379-390)."""
    val = _n2o2_core(cc.o2_b, cc.o2_beta, p, t, 0.21, 1.0)
    return torch.where(cc.o2_mask, val, 0.0)


def beta_ds(ctl_flags, cc, window_k, ds, p, t, q_h2o, u_co2, u_h2o):
    """Total extinction optical depth per segment and channel
    (continua_core, jr_common.h:397-409): gray extinction + enabled
    continua.  ctl_flags = (co2, h2o, n2, o2) booleans; ``cc`` holds
    tensors (:func:`continua_to_device`).

    Inputs are broadcastable to [..., 1] against per-channel coefficients
    [D]; returns [..., D].
    """
    co2, h2o, n2, o2 = ctl_flags
    total = window_k * ds
    if co2:
        total = total + continua_co2(cc, p, t, u_co2)
    if h2o:
        total = total + continua_h2o(cc, p, t, q_h2o, u_h2o)
    if n2:
        total = total + continua_n2(cc, p, t) * ds
    if o2:
        total = total + continua_o2(cc, p, t) * ds
    return total


def beta_ds_partials(ctl_flags, cc, window_k, ds, p, t, q_h2o, u_co2,
                     u_h2o):
    """(bds, partials): :func:`beta_ds`, bit for bit, and its local
    partials [..., D] in the order of ``BDS_INPUTS`` (window_k, ds, p, t,
    q_h2o, u_co2, u_h2o), every one broadcast to bds's shape -- of
    ``forward.rt_integrate_jvp_ref`` and the plain arithmetic of the RT
    JVP kernel (``csrc/ega_jvp_fast.cu``).  ``torch.pow``'s exponent rule
    gives 0 where the H2O self-continuum's base is 0."""
    co2, h2o, n2, o2 = ctl_flags
    bds = beta_ds(ctl_flags, cc, window_k, ds, p, t, q_h2o, u_co2, u_h2o)
    z = torch.zeros_like(bds)
    d_kw, d_ds, d_p, d_t, d_q, d_uc, d_uh = (z + ds, z + window_k, z, z, z,
                                             z, z)
    if co2:
        dt230, dt260, dt296 = t - 230.0, t - 260.0, t - 296.0
        ctw = (dt260 * 5.050505e-4 * dt296 * cc.co2_cw230
               - dt230 * 9.259259e-4 * dt296 * cc.co2_cw260
               + dt230 * 4.208754e-4 * dt260 * cc.co2_cw296)
        dctw = (5.050505e-4 * cc.co2_cw230 * (dt296 + dt260)
                - 9.259259e-4 * cc.co2_cw260 * (dt296 + dt230)
                + 4.208754e-4 * cc.co2_cw296 * (dt260 + dt230))
        k0 = NA * 1000.0 * P0
        d_uc = d_uc + p * ctw / k0
        d_p = d_p + u_co2 * ctw / k0
        d_t = d_t + u_co2 * p * dctw / k0
    if h2o:
        base = torch.where(cc.h2o_cw296 > 0, cc.h2o_cw260 / torch.where(
            cc.h2o_cw296 > 0, cc.h2o_cw296, 1.0), 1.0)
        pw = torch.pow(base, (296.0 - t) / (296.0 - 260.0))
        ctwslf = cc.h2o_sfac * cc.h2o_cw296 * pw
        dslf = cc.h2o_sfac * cc.h2o_cw296 * torch.where(
            base == 0, 0.0, pw * torch.log(torch.where(base == 0, 1.0, base))
        ) * (-1.0 / (296.0 - 260.0))
        x = 0.7193876 / t * cc.h2o_nu
        th = torch.tanh(x)
        a1 = cc.h2o_nu * u_h2o * th
        a1_t = cc.h2o_nu * u_h2o * (1.0 - th * th) * (-0.7193876 / (t * t)
                                                       * cc.h2o_nu)
        a2 = 296.0 / t
        a2_t = -296.0 / (t * t)
        mixv = q_h2o * ctwslf + (1 - q_h2o) * cc.h2o_ctwfrn
        a3 = p / P0 * mixv * 1e-20
        msk = lambda a: torch.where(cc.h2o_mask, a, 0.0)
        d_uh = d_uh + msk(cc.h2o_nu * th * a2 * a3)
        d_p = d_p + msk(a1 * a2 * (mixv * 1e-20 / P0))
        d_q = d_q + msk(a1 * a2 * (p / P0 * (ctwslf - cc.h2o_ctwfrn)
                                   * 1e-20))
        d_t = d_t + msk(a1_t * a2 * a3 + a1 * a2_t * a3
                        + a1 * a2 * (p / P0 * q_h2o * dslf * 1e-20))
    for on, b, beta, qgas, mix_t, mask in (
            (n2, cc.n2_b, cc.n2_beta, 0.79, -(1 - 0.79) * 0.4545 / 296.0,
             cc.n2_mask),
            (o2, cc.o2_b, cc.o2_beta, 0.21, 0.0, cc.o2_mask)):
        if not on:
            continue
        mix = (0.79 + (1 - 0.79) * (1.294 - 0.4545 * t / 296.0)
               if qgas == 0.79 else 1.0)
        pr, tr = p / P0, 273.0 / t
        e = torch.exp(beta * (1 / 296.0 - 1 / t))
        c = 0.1 * qgas * b
        val = c * pr ** 2 * tr ** 2 * e * mix
        v_p = c * 2.0 * pr / P0 * tr ** 2 * e * mix
        v_t = c * pr ** 2 * (2.0 * tr * (-273.0 / (t * t)) * e * mix
                             + tr ** 2 * e * beta / (t * t) * mix
                             + tr ** 2 * e * mix_t)
        msk = lambda a: torch.where(mask, a, 0.0)
        d_ds = d_ds + msk(val)
        d_p = d_p + msk(v_p) * ds
        d_t = d_t + msk(v_t) * ds
    return bds, (d_kw, d_ds, d_p, d_t, d_q, d_uc, d_uh)


BDS_INPUTS = ("window_k", "ds", "p", "t", "q_h2o", "u_co2", "u_h2o")
