"""The forward model: formod pipeline (port of ``jurassic_tpu/forward.py``).

One call of :meth:`ForwardModel.formod` runs hydrostatics (host NumPy),
ray tracing (``geometry.trace_rays``, plain tensor code on the execution
device), the fused EGA radiative-transfer pass on Chebyshev turbo tables
(``ops.ega_fused.rt_fused_turbo``: the CUDA kernel on a GPU, its plain
PyTorch version on the CPU), the surface and brightness epilogue, one
device-to-host pull, and the host-side FOV convolution and observation
mask.

Ported in this slice: ``KERNEL = auto|turbo`` on turbo tables that pass
the fit gate with no bad rows, ``IP = 1``, one ray batch.  The other
modes raise ``NotImplementedError`` naming the ROADMAP item that ports
them.  ``KERNEL = auto`` resolves to turbo on every device (the port has
one radiative-transfer path; JAX resolves it to its jnp pipeline on the
CPU).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jurassic_tpu.config import NFOV, Ctl
from jurassic_tpu.constants import C1, C2
from jurassic_tpu.io_tab import Atm, Obs, read_shape
from jurassic_tpu.tables import (EgaTables, FastTables, build_fast_tables,
                                 load_tables_cached)

from .device import RT_DTYPE, resolve_device, tracer_dtype
from .geometry import (LosData, build_ray_profiles, hydrostatic_atm,
                       trace_rays)
from .ops.continua import precompute_continua
from .ops.ega_fused import pack_continua, rt_fused_turbo
from .ops.turbo_fit import (CHORD_TOL, FIT_TOL, TurboStats, TurboTables,
                            build_turbo_tables)

ROADMAP_WAITS = "ROADMAP.md, section 1, 'What waits'"

# the turbo fit gate of the JAX driver (forward.py:398-410)
HYBRID_MAX = 0.05   # largest bad-row fraction the hybrid would take


# ---------------------------------------------------------------------------
# Source function and brightness temperature

def src_planck(sr, st, t):
    """Table-interpolated source radiance [R, D] at temperatures t [R]
    (src_planck_core, jr_common.h:221-224; locate_st index
    (int)(4 t) - 400, jr_common.h:83-84, clamped)."""
    n = st.shape[0]
    it = ((4.0 * t).to(torch.int32) - 400).clamp(0, n - 2).long()
    t0, t1 = st[it].unsqueeze(1), st[it + 1].unsqueeze(1)
    return sr[it] + (t.unsqueeze(1) - t0) * (sr[it + 1] - sr[it]) / (t1 - t0)


def brightness(rad, nu):
    """Radiance -> brightness temperature (brightness_core,
    jr_common.h:189-190)."""
    return C2 * nu / torch.log1p(C1 * nu ** 3 / rad)


class RtOut(NamedTuple):
    rad: torch.Tensor  # [R, D]
    tau: torch.Tensor  # [R, D]


def rt_epilogue(rad, tau, sr, st, nu, tsurf, bbt: bool) -> RtOut:
    """Surface emission (add_surface_core, jr_common.h:228-234) and the
    optional brightness conversion, in f32 after the fused pass
    (``rt_pallas_core``, forward.py:194-200)."""
    sr_ = sr.to(RT_DTYPE)
    st_ = st.to(RT_DTYPE)
    ts = tsurf.to(RT_DTYPE)
    src_surf = src_planck(sr_, st_, ts)
    rad = torch.where((ts > 0.0).unsqueeze(1), rad + src_surf * tau, rad)
    if bbt:
        rad = brightness(rad, nu.to(RT_DTYPE))
    return RtOut(rad=rad, tau=tau)


# ---------------------------------------------------------------------------
# FOV convolution (formod_fov, jurassic.c:214-258) -- host NumPy

def formod_fov(ctl: Ctl, obs: Obs) -> None:
    """Convolve rad/tau profiles with the instrument field of view
    (formod_fov, jurassic.c:214-258), vectorised host NumPy copied from
    the JAX package: each ray's same-time neighbour window (at most
    2 NFOV + 1 candidates) is compacted with a stable sort, the
    shape-grid interpolation indices come from a counted comparison,
    and the weight sum is one einsum, ray-chunked."""
    if ctl.fov == "-":
        return
    dz, w = read_shape(ctl.fov)
    R = obs.nr
    rad0, tau0 = obs.rad.copy(), obs.tau.copy()
    WW = 2 * NFOV + 1
    ir = np.arange(R)
    col = np.clip(ir[:, None] + np.arange(-NFOV, NFOV + 1), 0, R - 1)
    mask = (obs.time[col] == obs.time[:, None]) \
        & (ir[:, None] + np.arange(-NFOV, NFOV + 1) >= 0) \
        & (ir[:, None] + np.arange(-NFOV, NFOV + 1) < R)
    n = mask.sum(axis=1)
    if (n < 2).any():
        raise ValueError("Cannot apply FOV convolution!")
    ordr = np.argsort(~mask, axis=1, kind="stable")
    colc = np.take_along_axis(col, ordr, axis=1)          # [R, WW]
    inb = np.arange(WW)[None, :] < n[:, None]
    zwin = np.where(inb, obs.vpz[colc], np.inf)
    wsum = np.sum(w)
    chunk = max(1, (64 << 20) // max(dz.size * obs.rad.shape[1] * 8, 1))
    for c0 in range(0, R, chunk):
        sl = slice(c0, min(c0 + chunk, R))
        zfov = obs.vpz[sl, None] + dz[None, :]            # [r, NS]
        cnt = np.sum(zwin[sl][:, None, :] <= zfov[:, :, None], axis=2)
        idx = np.clip(cnt - 1, 0, (n[sl] - 2)[:, None])
        g0 = np.take_along_axis(colc[sl], idx, axis=1)    # [r, NS]
        g1 = np.take_along_axis(colc[sl], idx + 1, axis=1)
        z0, z1 = obs.vpz[g0], obs.vpz[g1]
        f = ((zfov - z0) / (z1 - z0))[:, :, None]
        for src, dst in ((rad0, obs.rad), (tau0, obs.tau)):
            v0, v1 = src[g0], src[g1]                     # [r, NS, D]
            dst[sl] = np.einsum("s,rsd->rd", w,
                                v0 + f * (v1 - v0)) / wsum


# ---------------------------------------------------------------------------
# Host orchestration

class ForwardModel:
    """Loaded, device-resident forward model for one ctl configuration
    (the reference's cached table upload and continuum setup).
    Construct once, call :meth:`formod` per observation batch.

    ``device`` overrides the USETPU/USEGPU policy (it must agree with a
    pinned value); the tracer runs in float64 on the CPU and float32 on
    CUDA (``device.tracer_dtype``).  ``turbo_tables`` (with ``turbo_stats``)
    injects tables fitted elsewhere from the given tables, e.g. a cached
    fit."""

    def __init__(self, ctl: Ctl, tables: EgaTables | None = None,
                 directory: str = ".",
                 fast_tables: FastTables | None = None,
                 turbo_tables: TurboTables | None = None,
                 turbo_stats: TurboStats | None = None,
                 device=None):
        self.ctl = ctl
        if ctl.formod != 2:
            raise ValueError(
                f"FORMOD = {ctl.formod} is not supported (1 = CGA and "
                "3 = RFM are not implemented; use FORMOD = 2 for EGA)")
        if ctl.kernel not in ("auto", "turbo"):
            raise NotImplementedError(
                f"KERNEL = {ctl.kernel} is not ported yet: the port runs "
                "the turbo kernel (KERNEL = auto|turbo); the table-mode "
                "kernel (KERNEL = pallas) and the eager oracles "
                f"(KERNEL = exact|jax|fast) are later items ({ROADMAP_WAITS})")
        self.device = resolve_device(ctl.usetpu, device)
        self.dtype = tracer_dtype(self.device)

        if fast_tables is None:
            if tables is None:
                if turbo_tables is not None:
                    raise ValueError("turbo_tables need the FastTables or "
                                     "EgaTables they were fitted from")
                tables = load_tables_cached(ctl, directory)
            fast_tables = build_fast_tables(tables)
        if turbo_tables is None:
            turbo_tables, turbo_stats = build_turbo_tables(fast_tables,
                                                           self.device)
            if turbo_tables is None:
                msg = ("requires channel-uniform table axes per gas "
                       "(the turbo table build returned None)")
                if ctl.kernel == "turbo":
                    raise ValueError(f"KERNEL = turbo {msg}")
                raise NotImplementedError(
                    f"KERNEL = auto on these tables needs the jnp "
                    f"pipeline, a later item ({ROADMAP_WAITS}): {msg}")
        self.turbo_tbl = turbo_tables.to(self.device)
        self.turbo_stats = turbo_stats
        self._gate()

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(self.device)
        self.sr, self.st, self.nu = (f64(fast_tables.sr), f64(fast_tables.st),
                                     f64(ctl.nu))
        self.cc_rows = pack_continua(precompute_continua(ctl),
                                     np.asarray(ctl.window), ctl.nd, ctl.nw,
                                     self.device)
        # continuum configuration (fourbit, CPUdrivers.c:126-134)
        self.ig_co2 = ctl.emitter_index("CO2")
        self.ig_h2o = ctl.emitter_index("H2O")
        self.flags = (
            ctl.ctm_co2 == 1 and self.ig_co2 >= 0,
            ctl.ctm_h2o == 1 and self.ig_h2o >= 0,
            ctl.ctm_n2 == 1,
            ctl.ctm_o2 == 1,
        )

    def _gate(self) -> None:
        """The JAX driver's turbo acceptance gate (forward.py:383-433):
        fit error and chord deviation of the good rows bound turbo
        against the emissivity curve and the table kernels' chords, and
        at most HYBRID_MAX of the rows may fail the per-row gate.  A
        rejected fit is an error under KERNEL = turbo and needs the table
        kernel under auto; accepted tables with bad rows need the hybrid
        re-run.  Neither is ported yet."""
        st = self.turbo_stats
        n_bad = self.turbo_tbl.n_bad
        rejected = st is not None and (
            max(st.max_fwd_err, st.max_inv_err) > FIT_TOL
            or st.max_chord_dev > CHORD_TOL
            or n_bad / max(st.rows, 1) > HYBRID_MAX)
        if rejected and self.ctl.kernel == "turbo":
            raise ValueError(
                "KERNEL = turbo: Chebyshev fit validation failed "
                f"({st}, bad rows {n_bad}); these tables need KERNEL = "
                "pallas")
        if rejected:
            raise NotImplementedError(
                "KERNEL = auto: the turbo fit was rejected and the "
                f"table-mode kernel it falls back to is a later item "
                f"({ROADMAP_WAITS}; {st})")
        if n_bad > 0:
            raise NotImplementedError(
                f"turbo tables with {n_bad} bad-fit rows need the hybrid "
                f"re-run through the table-mode kernel, a later item "
                f"({ROADMAP_WAITS})")

    def trace(self, atm: Atm, obs: Obs) -> LosData:
        """Hydrostatic adjustment + ray tracing (hydrostatic1d_CPU +
        raytrace_rays_CPU, CPUdrivers.c:89-103).  Mutates atm.p like the
        reference."""
        hydrostatic_atm(self.ctl, atm)
        prof = build_ray_profiles(self.ctl, atm, obs, self.dtype,
                                  self.device)
        obs_geo = {k: getattr(obs, k) for k in
                   ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")}
        return trace_rays(self.ctl, prof, obs_geo)

    def integrate(self, los: LosData) -> RtOut:
        """The fused EGA pass plus the surface/brightness epilogue."""
        rad, tau = rt_fused_turbo(self.turbo_tbl, self.cc_rows, los,
                                  self.flags, self.ig_co2, self.ig_h2o)
        return rt_epilogue(rad, tau, self.sr, self.st, self.nu, los.tsurf,
                           bool(self.ctl.write_bbt))

    def formod(self, atm: Atm, obs: Obs) -> Obs:
        """Full forward model (formod, CPUdrivers.c:179-193): fills
        obs.rad/obs.tau/tangent points in place and returns obs.

        ``RAYPACK <= 0`` runs the batch in one package; ``EARLY_EXIT``
        is accepted and changes nothing (the exit is bitwise exact)."""
        ctl = self.ctl
        if ctl.checkmode:
            print(f"# formod: checkmode = {ctl.checkmode}, "
                  "no actual computation is performed!")
            return obs
        if ctl.ip != 1:
            raise NotImplementedError(
                f"IP = {ctl.ip}: the pencil path is a later item "
                f"({ROADMAP_WAITS})")
        if ctl.raypack > 0:
            raise NotImplementedError(
                f"RAYPACK = {ctl.raypack}: ray packages on streams are a "
                f"later item ({ROADMAP_WAITS}); RAYPACK = 0 runs one batch")
        mask = ~np.isfinite(obs.rad)                  # save_mask
        los = self.trace(atm, obs)
        out = self.integrate(los)
        (obs.rad, obs.tau, obs.tpz, obs.tplon,
         obs.tplat) = self.outputs_to_host(
             (out.rad, out.tau, los.tpz, los.tplon, los.tplat))
        formod_fov(ctl, obs)
        obs.rad[mask] = np.nan                        # apply_mask
        return obs

    @staticmethod
    def outputs_to_host(arrays) -> tuple[np.ndarray, ...]:
        """All outputs in ONE device-to-host copy (the reference's one
        D2H obs copy per package, GPUdrivers.cu:244), as float64."""
        flat = [a.reshape(a.shape[0], -1).to(torch.float64) for a in arrays]
        host = torch.cat(flat, dim=1).cpu().numpy()
        out, c = [], 0
        for a, f in zip(arrays, flat):
            w = f.shape[1]
            out.append(np.array(host[:, c:c + w].reshape(a.shape)))
            c += w
        return tuple(out)


def formod(ctl: Ctl, atm: Atm, obs: Obs, tables: EgaTables | None = None,
           directory: str = ".", device=None) -> Obs:
    """One-shot forward model (formod, CPUdrivers.c:179)."""
    if ctl.checkmode:
        print(f"# formod: checkmode = {ctl.checkmode}, "
              "no actual computation is performed!")
        return obs
    return ForwardModel(ctl, tables, directory,
                        device=device).formod(atm, obs)
