"""Retrieval interface: state and measurement vectors, and Jacobians
(port of ``jurassic_tpu/retrieval.py``).

* state-vector pack/unpack ``atm2x``/``x2atm`` (jurassic.c:1491-1513,
  1473-1488) selecting pressure/temperature/vmr/extinction grid points
  inside the configured retrieval altitude ranges;
* measurement-vector pack/unpack ``obs2y``/``y2obs``
  (jurassic.c:1528-1541, 1516-1526) over finite radiance cells;
* the finite-difference Jacobian :func:`kernel` (jurassic.c:812-857) with
  the reference's per-quantity perturbation sizes: n+1 ``formod`` calls
  through whatever the model runs (on a card, the fused CUDA kernels);
* :func:`kernel_autodiff`: ``torch.func.jacfwd`` through the eager
  tracer, the in-graph hydrostatic rebuild and the eager RT pass, ray
  package by ray package.

The seam: ``kernel_autodiff`` differentiates the eager pipeline
(``forward.rt_integrate``) whatever kernel the model runs, as the JAX
package does (retrieval.py:178-191): the fused kernels have no
derivative.  GSL vectors/matrices become plain NumPy arrays.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from .config import Ctl
from .io_tab import Atm, Obs

if TYPE_CHECKING:
    from .forward import ForwardModel

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


def perturbation_sizes(ctl: Ctl, x0: np.ndarray,
                       iqa: np.ndarray) -> np.ndarray:
    """Reference per-quantity FD steps (kernel, jurassic.c:833-836):
    pressure max(|1% x|, 1e-7), temperature 1 K, vmr max(|1% x|, 1e-15),
    extinction 1e-4."""
    h = np.empty_like(x0)
    h[iqa == IDXP] = np.maximum(np.abs(0.01 * x0[iqa == IDXP]), 1e-7)
    h[iqa == IDXT] = 1.0
    isq = (iqa >= 2) & (iqa < 2 + ctl.ng)
    h[isq] = np.maximum(np.abs(0.01 * x0[isq]), 1e-15)
    h[iqa >= 2 + ctl.ng] = 1e-4
    return h


def kernel(ctl: Ctl, atm: Atm, obs: Obs,
           model: Optional["ForwardModel"] = None) -> np.ndarray:
    """Finite-difference Jacobian K[m, n] = d rad / d x
    (kernel, jurassic.c:812-857): n+1 forward models, one per state
    element, with the reference's perturbation sizes.  Each is a full
    ``model.formod`` (hydrostatics, packages, FOV and mask included), so
    on a card every column runs the model's fused CUDA kernel."""
    from .forward import ForwardModel
    if model is None:
        model = ForwardModel(ctl)
    model.formod(atm, obs)
    x0, iqa, _ = atm2x(ctl, atm)
    y0, _, _ = obs2y(ctl, obs)
    h = perturbation_sizes(ctl, x0, iqa)
    K = np.zeros((y0.size, x0.size))
    for j in range(x0.size):
        x1 = x0.copy()
        x1[j] += h[j]
        atm1, obs1 = atm.copy(), obs.copy()
        x2atm(ctl, x1, atm1)
        model.formod(atm1, obs1)
        y1, _, _ = obs2y(ctl, obs1)
        K[:, j] = (y1 - y0) / h[j]
    return K


def autodiff_ray_bytes(model: "ForwardModel", n: int) -> int:
    """Device bytes per ray of one ``kernel_autodiff`` package for an
    n-element state: the eager pass's in-flight bytes per ray
    (``ForwardModel.ray_terms`` in the eager mode the autodiff runs),
    where the float tensors that carry tangents count 1 + n times, a
    primal and n tangents, and the integer indices, masks and table rows,
    which no tangent reaches, once."""
    mode = "fast" if model.eager_tables().use_fast else "exact"
    t = model.ray_terms(mode)

    def bytes_(*terms):
        return sum(t[k][0] * (1 + n) + t[k][1] for k in terms)
    return max(bytes_("trace"), bytes_("los", "step")) + bytes_("out")


def autodiff_package_size(model: "ForwardModel", nr: int, n: int) -> int:
    """Rays per package of ``kernel_autodiff`` on an nr-ray batch (0: one
    package).  ``RAYPACK`` n > 0 decides as it does for ``formod``, < 0
    is one package; 0 on a card fits one package in flight
    (:func:`autodiff_ray_bytes` per ray) into 90 % of the free memory,
    read on every call; the CPU runs one package."""
    pack = int(model.ctl.raypack)
    if pack == 0 and model.device.type == "cuda":
        fit = int(0.9 * model.free_device_bytes()) \
            // autodiff_ray_bytes(model, n)
        pack = max(fit, 1)
    return model.package_size(nr, pack)


def _state_scatter(ctl: Ctl, atm: Atm, iqa: np.ndarray, ipa: np.ndarray):
    """Per atm field (p [N], t [N], q [G, N], k [W, N]): (selected, state
    index), two host arrays of the field's shape, or None where no
    state element lands in the field.  Built once per Jacobian, so the
    traced scatter is one gather and one select per field whatever the
    state size."""
    groups = ((atm.p, iqa == IDXP, None), (atm.t, iqa == IDXT, None),
              (atm.q, (iqa >= 2) & (iqa < 2 + ctl.ng), 2),
              (atm.k, iqa >= 2 + ctl.ng, 2 + ctl.ng))
    out = []
    for field, sel, row0 in groups:
        if not sel.any():
            out.append(None)
            continue
        at = (ipa[sel],) if row0 is None else (iqa[sel] - row0, ipa[sel])
        hit = np.zeros(field.shape, bool)
        jx = np.zeros(field.shape, np.int64)
        hit[at] = True
        jx[at] = np.nonzero(sel)[0]
        out.append((hit, jx))
    return out


def kernel_autodiff(ctl: Ctl, atm: Atm, obs: Obs,
                    model: Optional["ForwardModel"] = None) -> np.ndarray:
    """Jacobian K[m, n] = d rad / d x by ``torch.func.jacfwd`` (forward
    mode: n, the state size, is far below m) through the eager pipeline,
    in the model's dtype and on its device (``retrieval.py:161-284`` of
    the JAX package).

    This is the one caller of the plain tracer on a card: a kernel has no
    tangent, so ``torch.func.jacfwd`` runs through ``trace_rays_ref``
    (the JAX package differentiates its jitted tracer).

    The state vector scatters into the flat atm point axis (one gather
    and one select per field); HYDZ >= 0 rebuilds pressure per (lon,
    lat) profile inside the differentiated graph
    (``geometry.hydrostatic_profile_torch``), so pressure derivatives
    flow through the rebuild as the FD kernel sees them; per-ray
    profiles are gathers through the window indices of
    ``geometry.ray_window_indices``, so a multi-profile atmosphere gives
    each scan its own profile by time.  Then the plain tracer
    ``geometry.trace_rays_ref`` and the model's eager pass
    (:meth:`~jurassic_torch.forward.ForwardModel.integrate_eager`, its
    fast or exact tables).  Masked radiances are
    zeroed; the finite rows are returned as float64.

    A ray's rows depend only on its own profile and geometry, so the
    Jacobian runs ray package by ray package (:func:`autodiff_package_
    size`; one line names the packages) and stacks their rows: the same
    bits as one package.  The tangents multiply the eager pass's float
    memory by up to 1 + n."""
    import torch

    from .forward import ForwardModel, _obs_rows
    from .geometry import (build_ray_profiles, hydrostatic_atm,
                           hydrostatic_profile_torch, profile_blocks,
                           ray_window_indices, trace_rays_ref)

    if model is None:
        model = ForwardModel(ctl)
    dev, dtype = model.device, model.dtype
    mask = ~np.isfinite(obs.rad)
    hydrostatic_atm(ctl, atm)       # the FD kernel packs x0 post-rebuild
    x0, iqa, ipa = atm2x(ctl, atm)
    n = x0.size
    ig_h2o = ctl.emitter_index("H2O")
    blocks = profile_blocks(atm) if ctl.hydz >= 0 else []
    lat_ref = [float(atm.lat[a:b][int(np.argmin(np.abs(atm.z[a:b]
                                                       - ctl.hydz)))])
               for (a, b) in blocks]

    def ten(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)
    base = [ten(f) for f in (atm.p, atm.t, atm.q, atm.k)]
    scatter = [None if s is None else
               (torch.from_numpy(s[0]).to(dev), torch.from_numpy(s[1]).to(dev))
               for s in _state_scatter(ctl, atm, iqa, ipa)]

    def state_fields(x):
        """(p [N], t [N], q [G, N], k [W, N]) with x in place, pressure
        rebuilt where HYDZ >= 0."""
        p, t, q, k = (f if s is None else torch.where(s[0], x[s[1]], f)
                      for f, s in zip(base, scatter))
        if blocks:
            p = torch.cat([hydrostatic_profile_torch(
                ctl.hydz, atm.z[a:b], p[a:b], t[a:b],
                q[ig_h2o, a:b] if ig_h2o >= 0 else None, lat)
                for (a, b), lat in zip(blocks, lat_ref)])
        return p, t, q, k

    def package_jacobian(obs_k: Obs, mask_k: np.ndarray) -> np.ndarray:
        _, _, gi = ray_window_indices(atm, obs_k)
        gi = torch.from_numpy(gi).to(dev)
        prof0 = build_ray_profiles(ctl, atm, obs_k, dtype, dev)
        geo = model._obs_geo(obs_k)
        masked = torch.from_numpy(mask_k).to(dev)

        def fwd(x):
            p, t, q, k = state_fields(x)
            prof = prof0._replace(p=p[gi], t=t[gi],
                                  q=q[:, gi].movedim(0, 1),
                                  k=k[:, gi].movedim(0, 1))
            out = model.integrate_eager(trace_rays_ref(ctl, prof, geo))
            return torch.where(masked, 0.0, out.rad)

        jac = torch.func.jacfwd(fwd)(ten(x0))              # [r, D, n]
        return jac[~masked].to(torch.float64).cpu().numpy()

    pack = autodiff_package_size(model, obs.nr, n) or obs.nr
    starts = range(0, obs.nr, pack)
    print(f"# kernel_autodiff: {len(starts)} package(s) of up to {pack} "
          f"rays, n = {n}, {dtype} on {dev}")
    rows = [slice(a, min(a + pack, obs.nr)) for a in starts]
    return np.concatenate([package_jacobian(_obs_rows(obs, r), mask[r])
                           for r in rows])
