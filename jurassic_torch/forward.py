"""The forward model: formod pipeline (port of ``jurassic_tpu/forward.py``).

One call of :meth:`ForwardModel.formod` runs hydrostatics (host NumPy),
then, per ray package, ray tracing (``geometry.trace_rays``: the tracer
kernel on a card, its plain PyTorch version on the CPU) and the
radiative-transfer pass
with the surface and brightness epilogue; then one device-to-host pull
for every package, and the host-side FOV convolution and observation
mask.

Kernel modes (``KERNEL``):

* ``turbo``: the fused pass on Chebyshev turbo tables (``ops.ega_fused``:
  a CUDA kernel on a GPU, its plain PyTorch version on the CPU); the fit
  must pass the gate.  Tables with a few bad-fit rows (at most
  ``JURASSIC_TURBO_HYBRID_MAX`` of all rows) run the per-row hybrid: the
  turbo pass marks the lanes that consumed a bad row and those lanes are
  re-evaluated through the table-mode pass.
* ``pallas``: the fused table-mode pass on the exact log-uniform tables
  (the name is the JAX package's; here it selects the table kernel).
* ``auto``: turbo, demoted to the table-mode pass when the gate rejects
  the fit, and to the eager ``fast`` pipeline on tables whose axes are
  not channel-uniform (as JAX sends those to its jnp pipeline).  On the
  CPU it runs the plain fused version, where JAX runs its jnp pipeline.
* ``exact``, ``jax`` / ``fast``: :func:`rt_integrate` on the exact or
  the fast tables in the model's dtype: on a card one launch of the RT
  kernel (``ops.ega_rt``, the counterpart of JAX's jitted scan), on the
  CPU the eager loop (``ops.ega``, plain tensor code), which
  :meth:`ForwardModel.integrate_eager` runs on either device -- the
  oracle, in float64.

``IP = 2/3`` traces the geometry on 1-D dummy profiles and re-samples
the atmosphere along each LOS on the host (:meth:`ForwardModel.
pencil_trace`).  ``RAYPACK`` splits the batch into packages, launched on
two CUDA streams in turns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from .config import NFOV, Ctl
from .constants import C1, C2, KB, TAU_CUTOFF
from .device import RT_DTYPE, resolve_device, tracer_dtype
from .geometry import (LosData, LosTangents, build_ray_profiles,
                       check_entry_flag, hydrostatic_atm, los_tangent_fields,
                       trace_rays_deferred)
from .interp_atm import intpol_atm_geo, split_profiles
from .io_tab import Atm, Obs, read_shape
from .ops.continua import (ContinuaCoeffs, beta_ds, beta_ds_partials,
                           continua_to_device, precompute_continua)
from .ops.ega import (EgaDeviceTables, FastDeviceTables, ega_eps_exact,
                      ega_eps_fast, ega_eps_partials, ega_tables_to_device,
                      fast_tables_to_device)
from .ops.ega_fused import (N_SEG, pack_continua, rt_fused_table,
                            rt_fused_turbo)
from .ops.table_pack import TableTables, build_table_tables
from .ops.turbo_fit import (CHORD_TOL, FIT_TOL, TurboStats, TurboTables,
                            build_turbo_tables, load_turbo_tables,
                            pad_small_axes, save_turbo_tables,
                            slice_turbo_tables, uniform_axes)
from .tables import (EgaTables, FastTables, build_fast_tables,
                     cache_filename, load_tables_cached)
from .utils.phases import PhaseClock, begin

FAST_KERNELS = ("auto", "jax", "pallas", "turbo", "fast")
FUSED_KERNELS = ("auto", "turbo", "pallas")


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


def src_planck_slope(sr, st, t):
    """d src_planck / dt [R, D]: the slope of the table row the
    interpolation reads (its index is piecewise constant in t)."""
    n = st.shape[0]
    it = ((4.0 * t).to(torch.int32) - 400).clamp(0, n - 2).long()
    return (sr[it + 1] - sr[it]) / (st[it + 1] - st[it]).unsqueeze(1)


def brightness(rad, nu):
    """Radiance -> brightness temperature (brightness_core,
    jr_common.h:189-190)."""
    return C2 * nu / torch.log1p(C1 * nu ** 3 / rad)


class RtOut(NamedTuple):
    rad: torch.Tensor  # [R, D]
    tau: torch.Tensor  # [R, D]


def _surface_and_bbt(rad, tau, sr, st, nu, tsurf, bbt: bool) -> RtOut:
    """Surface emission (add_surface_core, jr_common.h:228-234) and the
    optional brightness conversion, in the dtype of ``rad``."""
    dt = rad.dtype
    sr_, st_, ts = sr.to(dt), st.to(dt), tsurf.to(dt)
    src_surf = src_planck(sr_, st_, ts)
    rad = torch.where((ts > 0.0).unsqueeze(1), rad + src_surf * tau, rad)
    if bbt:
        rad = brightness(rad, nu.to(dt))
    return RtOut(rad=rad, tau=tau)


def rt_epilogue(rad, tau, sr, st, nu, tsurf, bbt: bool) -> RtOut:
    """The epilogue of the fused pass, in f32 (``rt_pallas_core``,
    forward.py:194-200)."""
    return _surface_and_bbt(rad.to(RT_DTYPE), tau, sr, st, nu, tsurf, bbt)


# ---------------------------------------------------------------------------
# The eager pipeline (rt_integrate, forward.py:99-176)

def rt_integrate(tbl, sr, st, nu, cc, window, los: LosData, tsurf, flags,
                 ig_co2: int, ig_h2o: int, use_fast: bool,
                 bbt: bool) -> RtOut:
    """Radiative-transfer integration over traced lines of sight, in the
    dtype of ``los``: a loop over the LOS steps, each step vectorised
    over [rays, gases, channels] and carrying (rad [R, D], tau [R, D],
    tau_path [R, G, D]) -- the ``lax.scan`` of the JAX package.

    Args:
      tbl: ``ops.ega.EgaDeviceTables`` or ``FastDeviceTables`` (selected
        by ``use_fast``).
      sr, st: source-function table [S, D] / axis [S].
      nu: channel wavenumbers [D] (for the BBT conversion).
      cc: per-channel continuum coefficients as tensors
        (``continua_to_device``).
      window: [D] int64 channel -> window map.
      los: traced rays ([R, NLOS, ...]).
      tsurf: [R] surface temperature (-999 => no surface hit).
      flags: (co2, h2o, n2, o2) continuum switches incl. emitter presence
        (fourbit, CPUdrivers.c:130-134).
      ig_co2, ig_h2o: emitter indices (>= 0 when the matching flag is set).
      use_fast: ``ega_eps_fast`` on FastTables, else ``ega_eps_exact``.
      bbt: WRITE_BBT (radiance_to_brightness_CPU, CPUdrivers.c:6-14).
    """
    dtype = los.p.dtype
    R, S = los.ds.shape
    G = los.u.shape[2]
    D = sr.shape[1]
    dev = los.p.device
    ega = ega_eps_fast if use_fast else ega_eps_exact
    sr_, st_ = sr.to(dtype), st.to(dtype)
    rad = torch.zeros((R, D), dtype=dtype, device=dev)
    tau = torch.ones((R, D), dtype=dtype, device=dev)
    tau_path = torch.ones((R, G, D), dtype=dtype, device=dev)
    zq = torch.zeros((R,), dtype=dtype, device=dev)
    for s in range(S):
        p, t, ds = los.p[:, s], los.t[:, s], los.ds[:, s]
        q, u, valid = los.q[:, s], los.u[:, s], los.valid[:, s]
        # extinction + continua (continua_core, jr_common.h:397-409)
        kw = los.k[:, s][:, window]                            # [R, D]
        q_h2o = q[:, ig_h2o] if ig_h2o >= 0 else zq
        u_h2o = u[:, ig_h2o] if ig_h2o >= 0 else zq
        u_co2 = u[:, ig_co2] if ig_co2 >= 0 else zq
        bds = beta_ds(flags, cc, kw, ds[:, None], p[:, None], t[:, None],
                      q_h2o[:, None], u_co2[:, None], u_h2o[:, None])
        # EGA transmittance update (apply_ega_core, jr_common.h:271-280)
        factor = ega(tbl, tau_path, t, u, p)                   # [R, G, D]
        # gas by gas, not torch.prod: on CUDA the reduction's order
        # depends on D, so a channel range would not give the bits of
        # the full model
        tau_gas = factor[:, 0]                                 # [R, D]
        for g in range(1, G):
            tau_gas = tau_gas * factor[:, g]
        tau_path = torch.where(valid[:, None, None], tau_path * factor,
                               tau_path)
        # source term (src_planck_core) + integration (new_obs_core,
        # jr_common.h:294-300)
        src = src_planck(sr_, st_, t)
        eps = 1.0 - tau_gas * torch.exp(-bds)
        upd = valid[:, None] & (tau_gas > TAU_CUTOFF)
        rad = torch.where(upd, rad + src * eps * tau, rad)
        tau = torch.where(upd, tau * (1.0 - eps), tau)
    return _surface_and_bbt(rad, tau, sr, st, nu, tsurf, bbt)


def rt_integrate_jvp_ref(tbl: EgaDeviceTables | FastDeviceTables, sr, st,
                         nu, cc, window, los: LosData, tan: LosTangents,
                         flags, ig_co2: int, ig_h2o: int, bbt: bool):
    """(RtOut, drad [R, D, n]): :func:`rt_integrate` on ``los`` with the
    tables' own lookups (the exact tables' or the fast ones'; its result
    bit for bit) and its forward-mode tangent in the n directions of
    ``tan`` (``geometry.trace_rays_jvp``), surface and brightness epilogue
    included -- the plain version of the RT JVP kernels
    (``csrc/ega_jvp_fast.cu``).

    Each (segment, channel) takes its local partials once
    (``ops.ega.ega_eps_partials``, ``ops.continua.
    beta_ds_partials``, :func:`src_planck_slope`); the tangents then
    follow small linear updates of (rad, tau, tau_path[G]).  An invalid
    segment changes nothing, and its tangents do not reach the result
    (``torch.where`` takes the selected side's tangent)."""
    dtype = los.p.dtype
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    D = sr.shape[1]
    dev = los.p.device
    nt = tan.seg.shape[-1]
    F = los_tangent_fields(tan, G, W)
    sr_, st_ = sr.to(dtype), st.to(dtype)
    rad = torch.zeros((R, D), dtype=dtype, device=dev)
    tau = torch.ones((R, D), dtype=dtype, device=dev)
    tau_path = torch.ones((R, G, D), dtype=dtype, device=dev)
    drad = torch.zeros((R, D, nt), dtype=dtype, device=dev)
    dtau = torch.zeros_like(drad)
    dtp = torch.zeros((R, G, D, nt), dtype=dtype, device=dev)
    zq = torch.zeros((R,), dtype=dtype, device=dev)
    zt = torch.zeros((R, nt), dtype=dtype, device=dev)
    e = lambda a: a.unsqueeze(-1)                  # a tangent axis
    for s in range(S):
        p, t, ds = los.p[:, s], los.t[:, s], los.ds[:, s]
        q, u, valid = los.q[:, s], los.u[:, s], los.valid[:, s]
        kw = los.k[:, s][:, window]
        q_h2o = q[:, ig_h2o] if ig_h2o >= 0 else zq
        u_h2o = u[:, ig_h2o] if ig_h2o >= 0 else zq
        u_co2 = u[:, ig_co2] if ig_co2 >= 0 else zq
        bds, b = beta_ds_partials(flags, cc, kw, ds[:, None], p[:, None],
                                  t[:, None], q_h2o[:, None],
                                  u_co2[:, None], u_h2o[:, None])
        factor, f_tp, f_t, f_p, f_u = ega_eps_partials(tbl, tau_path, t, u,
                                                       p)
        # the segment's tangents [R, n] ([R, G, n] per gas, [R, D, n] k)
        dp, dt, dds = F["p"][:, s], F["t"][:, s], F["ds"][:, s]
        dq, du = F["q"][:, s], F["u"][:, s]
        dk = F["k"][:, s][:, window]
        dq_h2o = dq[:, ig_h2o] if ig_h2o >= 0 else zt
        du_h2o = du[:, ig_h2o] if ig_h2o >= 0 else zt
        du_co2 = du[:, ig_co2] if ig_co2 >= 0 else zt
        dbds = e(b[0]) * dk
        for bi, d in zip(b[1:], (dds, dp, dt, dq_h2o, du_co2, du_h2o)):
            dbds = dbds + e(bi) * d.unsqueeze(1)
        df = (e(f_tp) * dtp + e(f_t) * dt[:, None, None]
              + e(f_p) * dp[:, None, None] + e(f_u) * du.unsqueeze(2))
        tau_gas, dtg = factor[:, 0], df[:, 0]
        for g in range(1, G):
            dtg = dtg * e(factor[:, g]) + e(tau_gas) * df[:, g]
            tau_gas = tau_gas * factor[:, g]
        v = valid.view(R, 1, 1)
        dtp = torch.where(e(v), dtp * e(factor) + e(tau_path) * df, dtp)
        tau_path = torch.where(v, tau_path * factor, tau_path)
        src = src_planck(sr_, st_, t)
        dsrc = e(src_planck_slope(sr_, st_, t)) * dt.unsqueeze(1)
        ex = torch.exp(-bds)
        eps = 1.0 - tau_gas * ex
        deps = e(tau_gas * ex) * dbds - dtg * e(ex)
        upd = valid[:, None] & (tau_gas > TAU_CUTOFF)
        drad = torch.where(e(upd), drad + (dsrc * e(eps) + e(src) * deps)
                           * e(tau) + e(src * eps) * dtau, drad)
        dtau = torch.where(e(upd), dtau * e(1.0 - eps) - e(tau) * deps,
                           dtau)
        rad = torch.where(upd, rad + src * eps * tau, rad)
        tau = torch.where(upd, tau * (1.0 - eps), tau)
    # surface emission and the brightness conversion (_surface_and_bbt)
    ts = los.tsurf
    src_s = src_planck(sr_, st_, ts)
    dsrc_s = e(src_planck_slope(sr_, st_, ts)) * F["tsurf"].unsqueeze(1)
    hit = e((ts > 0.0).unsqueeze(1))
    drad = torch.where(hit, drad + dsrc_s * e(tau) + e(src_s) * dtau, drad)
    out = _surface_and_bbt(rad, tau, sr, st, nu, ts, bbt)
    if bbt:
        r = torch.where(hit[..., 0], rad + src_s * tau, rad)
        nu_ = nu.to(dtype)
        a = C1 * nu_ ** 3 / r
        lg = torch.log1p(a)
        drad = drad * e(C2 * nu_ * a / (r * (1.0 + a) * lg * lg))
    return out, drad


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

def _obs_rows(obs: Obs, sl: slice) -> Obs:
    return Obs(**{f.name: np.ascontiguousarray(getattr(obs, f.name)[sl])
                  for f in dataclasses.fields(Obs)})


def channel_slice(tbl, nd: int, d0: int = 0):
    """EgaTables or FastTables of the ``nd`` channels from ``d0`` on
    (every field but the source axis ``st`` has the channel axis last)."""
    return tbl._replace(**{
        f: np.ascontiguousarray(getattr(tbl, f)[..., d0:d0 + nd])
        for f in tbl._fields if f != "st"})


def channel_ctl(ctl: Ctl, nd: int, d0: int = 0) -> Ctl:
    """A copy of ``ctl`` cut to the ``nd`` channels from ``d0`` on: ND,
    NU and the channel -> window map (the continua follow NU)."""
    return dataclasses.replace(ctl, nd=nd, nu=list(ctl.nu[d0:d0 + nd]),
                               window=list(ctl.window[d0:d0 + nd]))


def turbo_fit_rejected(stats: TurboStats, n_bad: int) -> bool:
    """The JAX package's acceptance gate of a turbo fit
    (forward.py:383-437): the fit error and chord deviation of the good
    rows bound turbo against the emissivity curve and the table kernel's
    chords, and at most ``hybrid_max()`` of the rows may fail the
    per-row gate."""
    return (max(stats.max_fwd_err, stats.max_inv_err) > FIT_TOL
            or stats.max_chord_dev > CHORD_TOL
            or n_bad / max(stats.rows, 1) > hybrid_max())


def fused_kernel(kernel: str, fast_tables: FastTables,
                 rejected: str | None = None) -> str:
    """What a KERNEL = auto|turbo|pallas model runs on ``fast_tables``
    (forward.py:363-445): the one policy of the single-card and the
    sharded model.  Tables whose axes are not channel-uniform have no
    fused form: an error under turbo and pallas, the eager fast pipeline
    ``"jax"`` under auto (one printed line).  A turbo fit that failed
    :func:`turbo_fit_rejected` (``rejected`` says why) is an error under
    turbo and the table kernel ``"pallas"`` under auto.  Else
    ``kernel``."""
    if uniform_axes(pad_small_axes(fast_tables)) is None:
        if kernel != "auto":
            raise ValueError(
                f"KERNEL = {kernel} requires channel-uniform table axes "
                "per gas (table build returned None); use KERNEL = jax for "
                "ragged-across-channel tables")
        print("# KERNEL = auto: the table axes are not channel-uniform; "
              "running the eager fast pipeline (KERNEL = jax)")
        return "jax"
    if rejected is not None and kernel != "pallas":
        if kernel == "turbo":
            raise ValueError("KERNEL = turbo: Chebyshev fit validation "
                             f"failed ({rejected}); these tables need "
                             "KERNEL = pallas")
        return "pallas"
    return kernel


def turbo_tables_cached(ctl: Ctl, tables: EgaTables | None,
                        fast_tables: FastTables, directory):
    """build_turbo_tables behind a file beside the table cache for
    file-backed tables (forward.py:469-515), under READ_BINARY /
    WRITE_BINARY, keyed like the table cache (configuration and table
    file freshness).  The file is the port's own
    (``jurassic_torch_tables_<hash>_turbo.npz``) and holds the logical
    coefficient rows."""
    cf = None
    if tables is not None and ctl.tblbase != "-":
        base = cache_filename(ctl, directory)
        cf = base.with_name(f"{base.stem}_turbo.npz")
    if cf is not None and ctl.read_binary and cf.exists():
        return load_turbo_tables(cf)
    tt, stats = build_turbo_tables(fast_tables)
    if tt is None:
        return None, None
    print(f"# turbo tables: {stats.rows} rows fitted, max fwd err "
          f"{stats.max_fwd_err:.2e}, inv roundtrip "
          f"{stats.max_inv_err:.2e}, chord dev "
          f"{stats.max_chord_dev:.2e}, "
          f"{tt.coef.numel() * 4 / 1e6:.1f} MByte on the device")
    if cf is not None and ctl.write_binary:
        save_turbo_tables(cf, tt, stats)
    return tt, stats


def pencil_geometry(ctl: Ctl, atm: Atm) -> tuple[Ctl, Atm]:
    """What the pencil path traces (IP = 2/3, forward.py:796-875 of the
    JAX package): ``ctl`` with IP = 1 and a 1-D dummy atmosphere over the
    global altitude range -- the sorted distinct altitudes of ``atm``, its
    pressures interpolated there, T = 250 K, no gas, no extinction."""
    first = dataclasses.replace(atm)
    zs = np.sort(np.unique(atm.z))
    n0 = zs.size
    first.time = np.full(n0, atm.time[0])
    first.z = zs
    first.lon = np.zeros(n0)
    first.lat = np.zeros(n0)
    first.p = np.interp(zs, atm.z[np.argsort(atm.z)],
                        atm.p[np.argsort(atm.z)])
    first.t = np.full(n0, 250.0)
    first.q = np.zeros((ctl.ng, n0))
    first.k = np.zeros((ctl.nw, n0))
    return dataclasses.replace(ctl, ip=1), first


class EagerTables(NamedTuple):
    """What :func:`rt_integrate` takes of a model besides its source
    table and flags (:meth:`ForwardModel.eager_tables`)."""
    tbl: EgaDeviceTables | FastDeviceTables
    cc: ContinuaCoeffs
    window: torch.Tensor    # [D] int64 channel -> window
    use_fast: bool


class _Package(NamedTuple):
    rows: slice
    pull: tuple             # rad, tau, tpz, tplon, tplat, flag (, taint)
    los: LosData | None     # kept only where a hybrid re-run may need it


class ForwardModel:
    """Loaded, device-resident forward model for one ctl configuration
    (the reference's cached table upload and continuum setup).
    Construct once, call :meth:`formod` per observation batch.

    ``device`` overrides the USETPU/USEGPU policy (it must agree with a
    pinned value).  ``dtype`` is the tracer's and the eager pipeline's
    (default ``device.tracer_dtype``: float64 on the CPU, float32 on
    CUDA; pass ``torch.float64`` to run the eager oracle in double
    precision on the card -- the fused CUDA kernels take float32 LOS
    only).  ``turbo_tables`` (with ``turbo_stats``) injects tables
    fitted elsewhere from the given tables, e.g. a cached fit (the
    acceptance gate reads ``turbo_stats``: for a channel range, those of
    the fit of all channels decide as the full model does).

    ``phase_log``: when set to a list, every :meth:`formod` (and every
    ``retrieval.kernel_autodiff`` given this model) appends the record of
    its spans and counts (``utils.phases.PhaseRecord``; as a mapping, the
    split of the call's time by leaf).

    After construction ``kernel_mode`` is ``"fused"``, ``"exact"`` or
    ``"fast"``; in fused mode ``turbo_tbl`` holds the turbo tables (None
    in table mode) and ``table_tbl`` the exact tables (None in pure turbo
    mode); both are set for the hybrid.  ``last_variant`` names what the
    last :meth:`formod` or :meth:`integrate` ran: ``"turbo"``,
    ``"table"``, ``"turbo+hybrid"``, ``"exact kernel"`` or ``"fast
    kernel"`` (the RT kernel, on a card), ``"exact"`` or ``"fast"`` (the
    eager loop, on the CPU)."""

    def __init__(self, ctl: Ctl, tables: EgaTables | None = None,
                 directory: str = ".",
                 fast_tables: FastTables | None = None,
                 turbo_tables: TurboTables | None = None,
                 turbo_stats: TurboStats | None = None,
                 device=None, dtype=None):
        self.ctl = ctl
        if ctl.formod != 2:
            raise ValueError(
                f"FORMOD = {ctl.formod} is not supported (1 = CGA and "
                "3 = RFM are not implemented; use FORMOD = 2 for EGA)")
        self.device = resolve_device(ctl.usetpu, device)
        self.dtype = tracer_dtype(self.device) if dtype is None else dtype
        if tables is None and fast_tables is None:
            if turbo_tables is not None:
                raise ValueError("turbo_tables need the FastTables or "
                                 "EgaTables they were fitted from")
            tables = load_tables_cached(ctl, directory)
        self.tables = tables
        use_fast = ctl.kernel in FAST_KERNELS
        self.kernel_mode = "fast" if use_fast else "exact"
        self.turbo_tbl: TurboTables | None = None
        self.turbo_stats: TurboStats | None = None
        self.table_tbl: TableTables | None = None
        self.last_variant: str | None = None
        self._raypack_printed = None
        self.free_bytes_read: int | None = None
        self._streams = None
        self.phase_log: list | None = None
        self._clock: PhaseClock | None = None   # the running formod's
        if use_fast:
            if fast_tables is None:
                fast_tables = build_fast_tables(tables)
            if ctl.kernel in FUSED_KERNELS:
                self._init_fused(fast_tables, turbo_tables, turbo_stats,
                                 directory)
        elif tables is None:
            raise ValueError(f"KERNEL = {ctl.kernel} runs on the exact "
                             "EgaTables; none were given")
        self.fast_tables = fast_tables

        src = tables if tables is not None else fast_tables

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(self.device)
        self.sr, self.st, self.nu = (f64(src.sr), f64(src.st), f64(ctl.nu))
        self._eager: EagerTables | None = None
        if self.kernel_mode == "fused":
            self.cc_rows = pack_continua(precompute_continua(ctl),
                                         np.asarray(ctl.window), ctl.nd,
                                         ctl.nw, self.device)
        else:
            self.eager_tables()
        # continuum configuration (fourbit, CPUdrivers.c:126-134)
        self.ig_co2 = ctl.emitter_index("CO2")
        self.ig_h2o = ctl.emitter_index("H2O")
        self.flags = (
            ctl.ctm_co2 == 1 and self.ig_co2 >= 0,
            ctl.ctm_h2o == 1 and self.ig_h2o >= 0,
            ctl.ctm_n2 == 1,
            ctl.ctm_o2 == 1,
        )

    def _init_fused(self, fast_tables, turbo_tables, turbo_stats,
                    directory) -> None:
        """KERNEL = auto|turbo|pallas: the fused pass's tables, or the
        eager fast pipeline where :func:`fused_kernel` demotes auto."""
        kernel = fused_kernel(self.ctl.kernel, fast_tables)
        if kernel == "jax":
            return
        if kernel != "pallas":
            self._init_turbo(fast_tables, turbo_tables, turbo_stats,
                             directory)
        if self.turbo_tbl is None:
            self.table_tbl = build_table_tables(fast_tables, self.device)
        self.kernel_mode = "fused"

    def _init_turbo(self, fast_tables: FastTables,
                    turbo_tables: TurboTables | None,
                    turbo_stats: TurboStats | None, directory) -> None:
        """KERNEL = turbo|auto on channel-uniform tables: fit (or take, or
        read from the file cache) the turbo tables and apply the JAX
        package's acceptance gate (:func:`turbo_fit_rejected`).  Accepted
        tables with bad rows also get their exact backing for the hybrid.
        A rejected fit is an error under KERNEL = turbo and leaves
        ``turbo_tbl`` None under auto: the table kernel
        (:func:`fused_kernel`)."""
        if turbo_tables is None:
            turbo_tables, turbo_stats = turbo_tables_cached(
                self.ctl, self.tables, fast_tables, directory)
        elif turbo_stats is None:
            raise ValueError("turbo_tables need the turbo_stats of their fit")
        st, n_bad = turbo_stats, turbo_tables.n_bad
        if turbo_fit_rejected(st, n_bad):
            fused_kernel(self.ctl.kernel, fast_tables,
                         f"{st}, bad rows {n_bad}")
            return
        table_tbl = None
        if n_bad > 0:
            table_tbl = build_table_tables(fast_tables, self.device)
            print(f"# turbo hybrid: {n_bad} of {st.rows} rows failed "
                  f"the per-row fit gate (pass rate "
                  f"{1 - n_bad / max(st.rows, 1):.2%}); tainted lanes "
                  "re-evaluate through the table kernel")
        self.turbo_tbl = turbo_tables.to(self.device)
        self.turbo_stats = turbo_stats
        self.table_tbl = table_tbl

    def channel_model(self, ctl_b: Ctl, d0: int = 0) -> "ForwardModel":
        """The model of ``ctl_b``, a copy of this model's ctl cut to the
        ``ctl_b.nd`` channels from ``d0`` on (:func:`channel_ctl`), on this
        model's tables cut the same way: no table is read and no turbo fit
        runs (rows are fitted per channel, ``turbo_fit.
        slice_turbo_tables``).  A demoted ``auto`` stays demoted."""
        nd = ctl_b.nd
        tables = None if self.tables is None else channel_slice(
            self.tables, nd, d0)
        ft = channel_slice(self.fast_tables, nd, d0) \
            if self.fast_tables is not None else None
        tt = st = None
        if self.turbo_tbl is not None:
            tt, st = slice_turbo_tables(self.turbo_tbl, self.turbo_stats, nd,
                                        d0)
        elif ctl_b.kernel == "auto":
            ctl_b = dataclasses.replace(ctl_b, kernel=(
                "pallas" if self.kernel_mode == "fused" else "jax"))
        return ForwardModel(ctl_b, tables, fast_tables=ft, turbo_tables=tt,
                            turbo_stats=st, device=self.device,
                            dtype=self.dtype)

    def eager_tables(self) -> EagerTables:
        """The eager pipeline's tables, continua and channel -> window map
        on the model's device and in its dtype (the arguments of
        :func:`rt_integrate`).  An eager model builds them with itself; a
        fused model, which needs none to run, builds them on first use
        from the fast tables its kernels' tables were made from (the JAX
        model always holds them: ``kernel_autodiff`` differentiates the
        eager pipeline whatever the kernel, retrieval.py:276-279).  Only
        a ``KERNEL = exact`` model holds the exact tables
        (``use_fast`` False)."""
        if self._eager is None:
            exact = self.kernel_mode == "exact"
            tbl = (ega_tables_to_device(self.tables, self.device) if exact
                   else fast_tables_to_device(self.fast_tables, self.device))
            self._eager = EagerTables(
                tbl=tbl,
                cc=continua_to_device(precompute_continua(self.ctl),
                                      self.dtype, self.device),
                window=torch.as_tensor(np.asarray(self.ctl.window, np.int64),
                                       device=self.device),
                use_fast=not exact)
        return self._eager

    # -- sizing of ray packages (forward.py:517-626) ------------------------

    def pass_mode(self) -> str:
        """What a package's RT pass runs: ``"fused"``, ``"kernel"`` (the
        RT kernel of an eager mode on a card) or the eager loop of
        ``kernel_mode`` (``"fast"`` or ``"exact"``, on the CPU)."""
        if self.kernel_mode != "fused" and self.device.type == "cuda":
            return "kernel"
        return self.kernel_mode

    def ray_terms(self, mode: str | None = None) -> dict:
        """Device bytes per ray of one package, term by term, for the
        ``mode`` ("fused", "kernel", "fast" or "exact"; default
        :meth:`pass_mode`).  Each term is a pair (float bytes that a
        tangent accompanies under ``jacfwd``, bytes no tangent reaches:
        integer indices, masks and table rows):

        * ``los``: the LOS (``LosData``);
        * ``trace``: the tracer's per-step outputs and their stacked copy;
        * ``step``: the segment stream [S, F] f32 and the kernels'
          outputs ("fused"), the RT kernel's outputs ("kernel": an eager
          mode on a card, whose tables are resident), or the eager loop's
          per-step temporaries -- the bracketing rows and masks, the
          corner-batched values (12 in the model's dtype) and table
          values, indices and masks (12 of at most 8 bytes) of the fast
          search [G, 4, D], and in exact mode the u and eps rows of one
          corner, [G, D, U] in f32 and in the model's dtype, with the
          searches' masks;
        * ``out``: the outputs and their float64 host copies;
        * ``kept``: what a package keeps to the pull, the outputs and the
          LOS where a hybrid re-run may need it.

        Tables are resident and not counted."""
        ctl = self.ctl
        mode = self.pass_mode() if mode is None else mode
        S, G, W, D = ctl.nlos, ctl.ng, ctl.nw, ctl.nd
        b = torch.empty((), dtype=self.dtype).element_size()
        los = (S * (6 + 2 * G + W) * b, S)
        trace = (S * (2 * (8 + G + W) + 2 * G + 3) * b, 2 * S)
        if mode == "fused":
            step = (2 * S * (N_SEG + W + G) * 4 + 12 * D * 4, 0)
        elif mode == "kernel":
            step = (2 * D * b, 0)
        else:
            tbl = self.eager_tables().tbl
            P, T = tbl.p.shape[-1], tbl.t.shape[-1]
            step = (G * D * (12 * 4 * b + 10 * b),
                    G * D * (2 * T * b + 3 * max(P, T) + 12 * 4 * 8))
            if mode == "exact":
                step = (step[0], step[1]
                        + G * D * tbl.u.shape[3] * (2 * (4 + b) + 3))
        out = (2 * (3 * D + 3) * 8 + 4 * D * 8, 0)
        kept = (4 * D * 4 + (los[0] if self._hybrid() else 0),
                los[1] if self._hybrid() else 0)
        return {"los": los, "trace": trace, "step": step, "out": out,
                "kept": kept}

    def _ray_bytes(self, mode: str | None = None) -> tuple[int, int]:
        """(in flight, kept) device bytes per ray of one package: the
        peak while a package is traced and integrated, and what it keeps
        until the one pull at the end of the package loop
        (:meth:`ray_terms`)."""
        t = {k: sum(v) for k, v in self.ray_terms(mode).items()}
        return max(t["trace"], t["los"] + t["step"]) + t["out"], t["kept"]

    def per_ray_device_bytes(self) -> int:
        """Device bytes per ray of a one-package formod, tables
        excluded: the peak in flight plus what is kept to the pull."""
        return sum(self._ray_bytes())

    def _hybrid(self) -> bool:
        return self.turbo_tbl is not None and self.table_tbl is not None

    def package_size(self, nr: int, pack: int | None = None) -> int:
        """The per-package ray count formod runs for an nr-ray batch:
        the batch split into equal packages, as many as the resolved
        RAYPACK size implies (forward.py:555-569); 0 = one package."""
        if pack is None:
            pack = self._resolve_raypack(nr)
        if not 0 < pack < nr:
            return 0
        npk = -(-nr // pack)
        return -(-nr // npk)

    def free_device_bytes(self) -> int:
        """The card's free memory now: ``torch.cuda.mem_get_info`` plus
        what PyTorch's allocator holds unused."""
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + (torch.cuda.memory_reserved(self.device)
                       - torch.cuda.memory_allocated(self.device))

    def _resolve_raypack(self, nr: int) -> int:
        """RAYPACK > 0: the explicit size; < 0: one package; 0: sized so
        that two packages in flight, with what every package keeps, fit
        90 % of the card's free memory (the reference sizes its lanes to
        90 % of free, GPUdrivers.cu:296-321).  Free memory is read on
        every call (``torch.cuda.mem_get_info`` plus what PyTorch's
        allocator holds unused; kept as ``free_bytes_read``, None where
        none was read).  On the CPU the batch is one package."""
        self.free_bytes_read = None
        pack = int(self.ctl.raypack)
        if pack > 0:
            return pack
        if pack < 0 or self.device.type != "cuda":
            return 0
        free = self.free_bytes_read = self.free_device_bytes()
        flight, kept = self._ray_bytes()
        fit = max((int(0.9 * free) - nr * kept) // (2 * flight), 1)
        fit = 0 if fit >= nr else fit
        if self._raypack_printed != fit:
            self._raypack_printed = fit
            print(f"# RAYPACK auto: {fit or nr} rays/package "
                  f"({flight + kept} B/ray, {free / 1e9:.2f} GB free)")
        return fit

    # -- tracing -------------------------------------------------------------

    def trace(self, atm: Atm, obs: Obs, hydro: bool = True) -> LosData:
        """Hydrostatic adjustment + ray tracing (hydrostatic1d_CPU +
        raytrace_rays_CPU, CPUdrivers.c:89-103).  Mutates atm.p like the
        reference.  On a card a bisection that did not converge raises
        after one read of its flag."""
        los, flag = self._trace_deferred(atm, obs, hydro)
        check_entry_flag(flag.cpu().numpy())
        return los

    def _trace_deferred(self, atm: Atm, obs: Obs, hydro: bool = True):
        """(LosData, entry flag) of :meth:`trace`, with no host
        sync (``geometry.trace_rays_deferred``): the package loop reads the
        flag with its one pull.  The host's profile preparation is the
        ``profiles`` span."""
        if hydro:
            hydrostatic_atm(self.ctl, atm)
        prof = build_ray_profiles(self.ctl, atm, obs, self.dtype,
                                  self.device)
        begin(self._clock, "trace")
        return trace_rays_deferred(self.ctl, prof, self._obs_geo(obs))

    @staticmethod
    def _obs_geo(obs: Obs) -> dict:
        return {k: getattr(obs, k) for k in
                ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")}

    def pencil_trace(self, atm: Atm, obs: Obs) -> LosData:
        """Host "pencil" tracing for IP = 2/3 (intpol_atm_2d/3d,
        jurassic.c:704-804; forward.py:796-875): straight-ray geometry
        traced on 1-D dummy profiles over the global altitude range, then
        the atmosphere re-sampled on the host at every LOS point with the
        2-D/3-D interpolator.  REFRAC must be 0: ray bending would need
        the in-path (p, T) while tracing.  IP = 3 gives no data outside
        every influence radius; those segments are vacuum."""
        ctl = self.ctl
        if ctl.refrac:
            raise ValueError(
                "IP = 2/3 requires REFRAC = 0 (straight rays); the reference "
                "formod does not support IP != 1 at all (jr_common.h:573)")
        hydrostatic_atm(ctl, atm)
        geo_ctl, first = pencil_geometry(ctl, atm)
        prof = build_ray_profiles(geo_ctl, first, obs, self.dtype,
                                  self.device)
        begin(self._clock, "trace")
        los, flag = trace_rays_deferred(geo_ctl, prof, self._obs_geo(obs))
        # re-sample along the traced paths; padded LOS points (beyond
        # np_) carry stale coordinates: clamp them to the first
        # atmosphere point before interpolating, zero them afterwards
        (z, lon, lat, ds, valid, np_, tsurf, flag) = self.outputs_to_host(
            (los.z, los.lon, los.lat, los.ds, los.valid, los.np_,
             los.tsurf, flag))
        check_entry_flag(flag)
        valid = valid > 0.5
        z = np.where(valid, z, atm.z[0])
        lon = np.where(valid, lon, atm.lon[0])
        lat = np.where(valid, lat, atm.lat[0])
        tp = split_profiles(atm) if ctl.ip == 2 else None
        p, t, q, k = intpol_atm_geo(ctl, atm, z.ravel(), lon.ravel(),
                                    lat.ravel(), tp)
        R, S = z.shape
        nodata = ~np.isfinite(t.reshape(R, S))
        keep = valid & ~nodata
        p = np.where(keep, p.reshape(R, S), 1e-3)
        t = np.where(keep, t.reshape(R, S), 250.0)
        v3 = keep[:, :, None]
        q = np.where(v3, np.moveaxis(q.reshape(ctl.ng, R, S), 0, -1), 0.0)
        k = np.where(v3, np.moveaxis(k.reshape(ctl.nw, R, S), 0, -1), 0.0)
        ds = np.where(valid, ds, 0.0)
        u = 10.0 * q * p[:, :, None] / (KB * t[:, :, None]) * ds[:, :, None]
        hit = tsurf > -998.0
        last = np.clip(np_.astype(np.int64) - 1, 0, S - 1)
        tsurf = np.where(hit, t[np.arange(R), last], tsurf)

        def ten(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, self.dtype)
        return los._replace(p=ten(p), t=ten(t), q=ten(q), k=ten(k),
                            u=ten(u), tsurf=ten(tsurf))

    # -- integration ---------------------------------------------------------

    def _integrate_deferred(self, los: LosData):
        """(RtOut, taint | None) of one package, with no host sync: the RT
        kernel (an eager mode on a card) or the eager loop (on the CPU),
        or the fused pass and its epilogue.  ``taint`` marks the lanes of
        a hybrid turbo pass that consumed a bad-fit row (None when the
        tables have none)."""
        if self.kernel_mode != "fused":
            if self.pass_mode() == "kernel":
                begin(self._clock, "kernel")
                out = self.integrate_kernel(los)
                self.last_variant = f"{self.kernel_mode} kernel"
            else:
                begin(self._clock, "eager pass")
                self.last_variant = self.kernel_mode
                out = self.integrate_eager(los)
            return out, None
        begin(self._clock, "kernel")
        args = (self.cc_rows, los, self.flags, self.ig_co2, self.ig_h2o)
        if self.turbo_tbl is None:
            rad, tau = rt_fused_table(self.table_tbl, *args)
            self.last_variant, taint = "table", None
        else:
            rad, tau, taint = rt_fused_turbo(self.turbo_tbl, *args)
            self.last_variant = "turbo"
        begin(self._clock, "epilogue")
        out = self._epilogue(rad, tau, los)
        return out, taint

    def integrate_eager(self, los: LosData) -> RtOut:
        """The eager loop :func:`rt_integrate` on ``los`` with
        :meth:`eager_tables`, whatever the model's kernel and device: the
        pass ``kernel_autodiff_jacfwd`` differentiates, and the RT
        kernel's plain version (on a card, an oracle independent of the
        kernel)."""
        e = self.eager_tables()
        return rt_integrate(e.tbl, self.sr, self.st, self.nu, e.cc, e.window,
                            los, los.tsurf, self.flags, self.ig_co2,
                            self.ig_h2o, e.use_fast, bool(self.ctl.write_bbt))

    def integrate_kernel(self, los: LosData) -> RtOut:
        """:meth:`integrate_eager`'s (rad, tau) from one launch of the RT
        kernel (``ops.ega_rt.rt_integrate_cuda``) on CUDA tensors, which
        raises on any other; nothing falls back to the eager loop."""
        from .ops.ega_rt import rt_integrate_cuda
        e = self.eager_tables()
        return rt_integrate_cuda(e.tbl, self.sr, self.st, self.nu, e.cc,
                                 e.window, los, self.flags, self.ig_co2,
                                 self.ig_h2o, bool(self.ctl.write_bbt))

    def integrate_jvp(self, los: LosData, tan: LosTangents):
        """(RtOut, drad [R, D, n]): the pass of :meth:`integrate_eager` on
        ``los`` (its exact or fast tables) and its tangent in the
        directions of ``tan`` (``geometry.trace_rays_jvp``).  CPU tensors
        run the plain version :func:`rt_integrate_jvp_ref`; CUDA tensors
        launch the RT JVP kernels (``ops.ega_jvp``) or raise."""
        e = self.eager_tables()
        args = (e.tbl, self.sr, self.st, self.nu, e.cc, e.window, los, tan,
                self.flags, self.ig_co2, self.ig_h2o,
                bool(self.ctl.write_bbt))
        dev = los.p.device
        if dev.type == "cpu":
            return rt_integrate_jvp_ref(*args)
        if dev.type != "cuda":
            raise ValueError(f"integrate_jvp: unsupported device {dev}")
        from .ops.ega_jvp import rt_jvp_fast_cuda
        return rt_jvp_fast_cuda(*args)

    def _epilogue(self, rad, tau, los) -> RtOut:
        return rt_epilogue(rad, tau, self.sr, self.st, self.nu, los.tsurf,
                           bool(self.ctl.write_bbt))

    def _table_redo(self, los: LosData) -> RtOut:
        """The table kernel and the epilogue on a hybrid package: the
        exact values of its tainted lanes."""
        rad, tau = rt_fused_table(self.table_tbl, self.cc_rows, los,
                                  self.flags, self.ig_co2, self.ig_h2o)
        return self._epilogue(rad, tau, los)

    def integrate(self, los: LosData) -> RtOut:
        """The radiative-transfer pass of the resolved mode on one traced
        batch, the hybrid splice included: where any lane is tainted
        (one scalar device-to-host sync), the table kernel runs on the
        batch and its lanes replace the tainted ones, as the JAX package
        splices them (forward.py:972-978).  :meth:`formod` defers the
        taint to its one pull instead."""
        out, taint = self._integrate_deferred(los)
        n_taint = 0 if taint is None else int(taint.sum())
        if n_taint:
            out2 = self._table_redo(los)
            out = RtOut(rad=torch.where(taint, out2.rad, out.rad),
                        tau=torch.where(taint, out2.tau, out.tau))
            self.last_variant = "turbo+hybrid"
            print(f"# turbo hybrid: {n_taint} of {taint.numel()} lanes "
                  "re-evaluated through the table kernel")
        return out

    # -- the forward model ---------------------------------------------------

    def formod(self, atm: Atm, obs: Obs) -> Obs:
        """Full forward model (formod, CPUdrivers.c:179-193): fills
        obs.rad/obs.tau/tangent points in place and returns obs.

        ``IP = 1`` runs hydrostatics once, then the ray packages of
        ``RAYPACK`` (:meth:`package_size`); ``IP = 2/3`` runs the pencil
        path on the whole batch, as the JAX package does.
        ``EARLY_EXIT`` is accepted and changes nothing (the exit is
        bitwise exact).

        With ``phase_log`` a list, the call's spans (root ``formod``):
        ``hydrostatics`` (with the mask's read), ``raypack sizing``
        (:meth:`package_size` and the package loop's stream set-up); per
        package ``profiles``, ``trace``, ``kernel`` or ``eager pass``,
        ``epilogue`` (fused); then ``D2H``, ``host``, ``hybrid re-run +
        D2H`` (tainted packages), ``FOV + mask``.  The pencil path (``IP
        = 2/3``) begins in its package's ``profiles``.  Counts: ``rays``,
        ``packages``, ``rays_per_package``, ``free_bytes`` (where the
        sizing read it), ``segments`` (valid LOS points, carried in the
        pull) and ``lanes_rerun`` (tainted lanes spliced from the table
        kernel).  A call that raises appends no record."""
        ctl = self.ctl
        if ctl.checkmode:
            print(f"# formod: checkmode = {ctl.checkmode}, "
                  "no actual computation is performed!")
            return obs
        clock = self._clock = (PhaseClock("formod", self.device,
                                          self.phase_log)
                               if self.phase_log is not None else None)
        try:
            if ctl.ip == 1:
                begin(clock, "hydrostatics")
            else:
                begin(clock, "profiles", 0)
            mask = ~np.isfinite(obs.rad)              # save_mask
            self.formod_rays(atm, obs)
            begin(clock, "FOV + mask")
            formod_fov(ctl, obs)
            obs.rad[mask] = np.nan                    # apply_mask
            if clock is not None:
                clock.finish()
        finally:
            self._clock = None
            if clock is not None:
                clock.close()
        return obs

    def formod_rays(self, atm: Atm, obs: Obs) -> None:
        """The part of :meth:`formod` that works ray by ray: fills
        obs.rad/obs.tau [R, ND] and the tangent points in place, before
        the FOV convolution and the mask.  ``IP = 1`` runs hydrostatics
        once, then the ray packages of ``RAYPACK``; ``IP = 2/3`` the
        pencil path on the whole batch."""
        if self.ctl.ip == 1:
            hydrostatic_atm(self.ctl, atm)            # once, up front
            begin(self._clock, "raypack sizing")
            pack = self.package_size(obs.nr)
            if self._clock is not None and self.free_bytes_read is not None:
                self._clock.counts["free_bytes"] = self.free_bytes_read
            self._run_packages(
                obs, pack or obs.nr,
                lambda o: self._trace_deferred(atm, o, hydro=False))
        else:
            self._run_packages(obs, obs.nr,
                               lambda o: (self.pencil_trace(atm, o), None))

    def _stream_ctx(self, k: int):
        """Package k's CUDA stream context (two streams in turns); a
        no-op on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(2)]
        return torch.cuda.stream(self._streams[k % 2])

    def _run_packages(self, obs: Obs, pack: int, trace) -> None:
        """The package loop (forward.py:985-1016): trace and integrate
        each package on its stream (the fused kernels launch on the
        current stream) with no host sync of its own, then pull every
        package's outputs and taint maps in ONE device-to-host copy
        (GPUdrivers.cu:244).  ``trace(obs_k)`` returns (LosData, entry
        flag | None); the flags ride in the pull and raise after it (the
        pencil path has read its own).  Only
        packages that carry taint re-run through the table kernel; their
        lanes are spliced one by one."""
        R = obs.nr
        clock = self._clock
        pkgs = []
        for k, start in enumerate(range(0, R, max(pack, 1))):
            rows = slice(start, min(start + pack, R))
            obs_k = obs if pack >= R else _obs_rows(obs, rows)
            with self._stream_ctx(k):
                begin(clock, "profiles", k)
                los, flag = trace(obs_k)
                out, taint = self._integrate_deferred(los)
            if flag is None:
                flag = torch.zeros(los.tpz.shape, dtype=torch.int32,
                                   device=los.tpz.device)
            pull = (out.rad, out.tau, los.tpz, los.tplon, los.tplat, flag)
            if taint is not None:
                pull += (taint,)
            if clock is not None:
                pull += (los.np_,)
            pkgs.append(_Package(rows, pull, None if taint is None else los))
            del los, out
        begin(clock, "D2H", None)
        if self._streams is not None:
            cur = torch.cuda.current_stream(self.device)
            for s in self._streams:
                cur.wait_stream(s)
        host = self.outputs_to_host_many([p.pull for p in pkgs])
        begin(clock, "host")
        for h in host:
            check_entry_flag(h[5])
        D = self.ctl.nd
        fields = [np.empty((R, D)), np.empty((R, D)),
                  np.empty(R), np.empty(R), np.empty(R)]
        rerun = 0
        for p, h in zip(pkgs, host):
            if p.los is not None:
                taint = h[6] > 0.5
                if taint.any():
                    begin(clock, "hybrid re-run + D2H")
                    rad2, tau2 = self.outputs_to_host(self._table_redo(p.los))
                    h[0][taint] = rad2[taint]
                    h[1][taint] = tau2[taint]
                    n_taint = int(taint.sum())
                    rerun += n_taint
                    self.last_variant = "turbo+hybrid"
                    print(f"# turbo hybrid: {n_taint} of "
                          f"{taint.size} lanes re-evaluated through the "
                          "table kernel")
                    begin(clock, "host")
            for dst, a in zip(fields, h[:5]):
                dst[p.rows] = a
        obs.rad, obs.tau, obs.tpz, obs.tplon, obs.tplat = fields
        if clock is not None:
            clock.counts.update(
                rays=R, packages=len(pkgs), rays_per_package=min(pack, R),
                segments=int(sum(h[-1].sum() for h in host)),
                lanes_rerun=rerun)

    @staticmethod
    def outputs_to_host(arrays) -> tuple[np.ndarray, ...]:
        """All outputs of one batch in ONE device-to-host copy (the
        reference's one D2H obs copy per package, GPUdrivers.cu:244), as
        float64."""
        return ForwardModel.outputs_to_host_many([arrays])[0]

    @staticmethod
    def outputs_to_host_many(items) -> list[tuple[np.ndarray, ...]]:
        """The outputs of several packages (each a tuple of tensors with
        the package's rays leading) in ONE device-to-host copy, as
        float64: each package's tensors are flattened into columns, the
        packages stacked on the rows (``_outputs_to_host_many``,
        forward.py:935-955)."""
        flats = [[a.reshape(a.shape[0], -1).to(torch.float64) for a in it]
                 for it in items]
        rows = torch.cat([torch.cat(f, dim=1) for f in flats], dim=0)
        host = rows.cpu().numpy()
        res, r0 = [], 0
        for it, f in zip(items, flats):
            r = f[0].shape[0]
            out, c = [], 0
            for a, fa in zip(it, f):
                w = fa.shape[1]
                out.append(np.array(host[r0:r0 + r, c:c + w]
                                    .reshape(a.shape)))
                c += w
            res.append(tuple(out))
            r0 += r
        return res


def formod(ctl: Ctl, atm: Atm, obs: Obs, tables: EgaTables | None = None,
           directory: str = ".", device=None, dtype=None) -> Obs:
    """One-shot forward model (formod, CPUdrivers.c:179)."""
    if ctl.checkmode:
        print(f"# formod: checkmode = {ctl.checkmode}, "
              "no actual computation is performed!")
        return obs
    return ForwardModel(ctl, tables, directory, device=device,
                        dtype=dtype).formod(atm, obs)
