"""The forward model: formod pipeline (port of ``jurassic_tpu/forward.py``).

One call of :meth:`ForwardModel.formod` runs hydrostatics (host NumPy),
ray tracing (``geometry.trace_rays``, plain tensor code on the execution
device), the fused EGA radiative-transfer pass (``ops.ega_fused``: a CUDA
kernel on a GPU, its plain PyTorch version on the CPU), the surface and
brightness epilogue, one device-to-host pull, and the host-side FOV
convolution and observation mask.

Kernel modes (``KERNEL``), with ``IP = 1`` and one ray batch:

* ``turbo``: Chebyshev turbo tables; the fit must pass the gate.
  Tables with a few bad-fit rows (at most ``JURASSIC_TURBO_HYBRID_MAX``
  of all rows) run the per-row hybrid: the turbo pass marks the lanes
  that consumed a bad row and those lanes are re-evaluated through the
  table-mode pass.
* ``pallas``: the table-mode pass on the exact log-uniform tables (the
  name is the JAX package's; here it selects the hand-written table
  kernel).
* ``auto``: turbo, demoted to the table-mode pass when the gate rejects
  the fit.  It resolves to the fused pass on every device (JAX resolves
  it to its jnp pipeline on the CPU).

The other modes raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .config import NFOV, Ctl
from .constants import C1, C2
from .device import RT_DTYPE, resolve_device, tracer_dtype
from .geometry import (LosData, build_ray_profiles, hydrostatic_atm,
                       trace_rays)
from .io_tab import Atm, Obs, read_shape
from .ops.continua import precompute_continua
from .ops.ega_fused import pack_continua, rt_fused_table, rt_fused_turbo
from .ops.table_pack import TableTables, build_table_tables
from .ops.turbo_fit import (CHORD_TOL, FIT_TOL, TurboStats, TurboTables,
                            build_turbo_tables)
from .tables import (EgaTables, FastTables, build_fast_tables,
                     load_tables_cached)

ROADMAP_WAITS = "ROADMAP.md, section 1, 'What waits'"


def hybrid_max() -> float:
    """Largest bad-row fraction the per-row hybrid takes before the whole
    configuration demotes to the table kernel: the JAX package's
    ``JURASSIC_TURBO_HYBRID_MAX`` knob (forward.py:404-405), default 5 %."""
    return float(os.environ.get("JURASSIC_TURBO_HYBRID_MAX", "0.05"))


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
    fit.

    After construction ``turbo_tbl`` holds the turbo tables (None in
    table mode) and ``table_tbl`` the exact tables (None in pure turbo
    mode); both are set for the hybrid.  ``last_variant`` names what the
    last :meth:`integrate` ran: ``"turbo"``, ``"table"`` or
    ``"turbo+hybrid"``."""

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
        if ctl.kernel not in ("auto", "turbo", "pallas"):
            raise NotImplementedError(
                f"KERNEL = {ctl.kernel} is not ported yet: the port runs "
                "the fused kernels (KERNEL = auto|turbo|pallas); the eager "
                f"oracles (KERNEL = exact|jax|fast) are later items "
                f"({ROADMAP_WAITS})")
        self.device = resolve_device(ctl.usetpu, device)
        self.dtype = tracer_dtype(self.device)

        if fast_tables is None:
            if tables is None:
                if turbo_tables is not None:
                    raise ValueError("turbo_tables need the FastTables or "
                                     "EgaTables they were fitted from")
                tables = load_tables_cached(ctl, directory)
            fast_tables = build_fast_tables(tables)
        self.turbo_tbl: TurboTables | None = None
        self.turbo_stats: TurboStats | None = None
        self.table_tbl: TableTables | None = None
        self.last_variant: str | None = None
        if ctl.kernel != "pallas":
            self._init_turbo(fast_tables, turbo_tables, turbo_stats)
        if self.turbo_tbl is None:
            self.table_tbl = build_table_tables(fast_tables, self.device)
        if self.turbo_tbl is None and self.table_tbl is None:
            msg = ("requires channel-uniform table axes per gas (table "
                   "build returned None)")
            if ctl.kernel == "auto":
                raise NotImplementedError(
                    f"KERNEL = auto on these tables needs the jnp "
                    f"pipeline, a later item ({ROADMAP_WAITS}): {msg}")
            raise ValueError(f"KERNEL = {ctl.kernel} {msg}")

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

    def _init_turbo(self, fast_tables: FastTables,
                    turbo_tables: TurboTables | None,
                    turbo_stats: TurboStats | None) -> None:
        """KERNEL = turbo|auto: fit (or take) the turbo tables and apply
        the JAX package's acceptance gate (forward.py:383-437).  The fit
        error and chord deviation of the good rows bound turbo against
        the emissivity curve and the table kernel's chords, and at most
        ``hybrid_max()`` of the rows may fail the per-row gate.  Accepted
        tables with bad rows also get their exact backing for the hybrid.
        A rejected fit (or bad rows without a backing) is an error under
        KERNEL = turbo and leaves ``turbo_tbl`` None under auto, which
        the caller demotes to the table kernel."""
        if turbo_tables is None:
            turbo_tables, turbo_stats = build_turbo_tables(fast_tables,
                                                           self.device)
            if turbo_tables is None:
                return          # ragged axes: the caller raises
        elif turbo_stats is None:
            raise ValueError("turbo_tables need the turbo_stats of their fit")
        st, n_bad = turbo_stats, turbo_tables.n_bad
        frac_bad = n_bad / max(st.rows, 1)
        bad = (max(st.max_fwd_err, st.max_inv_err) > FIT_TOL
               or st.max_chord_dev > CHORD_TOL
               or frac_bad > hybrid_max())
        table_tbl = None
        if not bad and n_bad > 0:
            table_tbl = build_table_tables(fast_tables, self.device)
            if table_tbl is None:
                bad = True                    # no exact backing: demote
            else:
                print(f"# turbo hybrid: {n_bad} of {st.rows} rows failed "
                      f"the per-row fit gate (pass rate "
                      f"{1 - frac_bad:.2%}); tainted lanes re-evaluate "
                      "through the table kernel")
        if bad and self.ctl.kernel == "turbo":
            raise ValueError(
                "KERNEL = turbo: Chebyshev fit validation failed "
                f"({st}, bad rows {n_bad}); these tables need KERNEL = "
                "pallas")
        if bad:
            return
        self.turbo_tbl = turbo_tables.to(self.device)
        self.turbo_stats = turbo_stats
        self.table_tbl = table_tbl

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
        """The fused EGA pass plus the surface/brightness epilogue.

        Hybrid (turbo tables with bad-fit rows): the turbo pass also
        returns the taint map; where any lane is tainted the table-mode
        pass runs on the same batch and whole lanes are spliced in on the
        device, as the JAX package splices them (forward.py:972-978).  The
        "any lane tainted" test is one scalar device-to-host sync."""
        args = (self.cc_rows, los, self.flags, self.ig_co2, self.ig_h2o)
        if self.turbo_tbl is None:
            rad, tau = rt_fused_table(self.table_tbl, *args)
            self.last_variant = "table"
        else:
            rad, tau, taint = rt_fused_turbo(self.turbo_tbl, *args)
            self.last_variant = "turbo"
            n_taint = 0 if taint is None else int(taint.sum())
            if n_taint:
                rad2, tau2 = rt_fused_table(self.table_tbl, *args)
                rad = torch.where(taint, rad2, rad)
                tau = torch.where(taint, tau2, tau)
                self.last_variant = "turbo+hybrid"
                print(f"# turbo hybrid: {n_taint} of {taint.numel()} lanes "
                      "re-evaluated through the table kernel")
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
