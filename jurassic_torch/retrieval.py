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
* :func:`kernel_autodiff`: the forward-mode Jacobian, chained by hand --
  ``torch.func.jacfwd`` of the state map (scatter and in-graph
  hydrostatic rebuild) on the atm axis, then the tracer's and the eager
  RT pass's tangents on the model's exact or fast tables (CUDA kernels
  on a card, their plain versions on the CPU), ray package by ray
  package; :func:`kernel_autodiff_jacfwd`: ``torch.func.jacfwd``
  through the whole eager pipeline (the oracle).

The seam: ``kernel_autodiff`` differentiates the eager pipeline
(``forward.rt_integrate``) whatever kernel the model's forward runs, as
the JAX package does (retrieval.py:178-191): the fused kernels have no
derivative.  GSL vectors/matrices become plain NumPy arrays.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Optional

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


def autodiff_ray_bytes(model: "ForwardModel", n: int,
                       jacfwd: bool = False) -> int:
    """Device bytes per ray of one ``kernel_autodiff`` package for an
    n-element state.

    On the tangent route (the tangent kernels, or their plain versions;
    the exact and the fast tables alike):
    the LOS (``ForwardModel.ray_terms``' ``los``), its tangents
    [NLOS, 3 + 2 G + W, n] and tsurf's [n] in the model's dtype, the
    tracer tangent kernels' records (``ops.trace_jvp.record_lengths``, the
    library's count: a record per step and one per ray), the RT tangent
    kernel's scratch (``ops.ega_jvp.scratch_lengths``, the library's
    count: a record per segment and channel and its segment index,
    counted for every one of the NLOS segments, at most that many are
    valid, and the epilogue's values per channel), and the K rows:
    drad [D, n] and its masked selection in the model's dtype, their
    float64 copy, the RT
    pass's rad and tau, and the mask.  The profile tangents
    are per atm point [N, 2 + G + W, n], made once per Jacobian before
    the free memory is read, and not counted here.

    With ``jacfwd`` (:func:`kernel_autodiff_jacfwd`): the eager pass's
    in-flight bytes per ray (``ray_terms`` in its eager mode),
    where the float tensors that carry tangents count 1 + n times, a
    primal and n tangents, and the integer indices, masks and table rows,
    which no tangent reaches, once."""
    if jacfwd:
        t = model.ray_terms("fast" if model.eager_tables().use_fast
                            else "exact")

        def bytes_(*terms):
            return sum(t[k][0] * (1 + n) + t[k][1] for k in terms)
        return max(bytes_("trace"), bytes_("los", "step")) + bytes_("out")
    import torch

    from .ops.ega_jvp import scratch_lengths
    from .ops.trace_jvp import record_lengths
    ctl = model.ctl
    S, G, W, D = ctl.nlos, ctl.ng, ctl.nw, ctl.nd
    b = torch.empty((), dtype=model.dtype).element_size()
    los = sum(model.ray_terms("fast")["los"])
    tangents = (S * (3 + 2 * G + W) + 1) * n * b
    step_len, ray_len = record_lengths()
    rec_len, epi_len = scratch_lengths(G, W)
    records = ((S * step_len + ray_len) * b
               + (S * rec_len + epi_len) * D * b + S * 4 + 8)
    rows = D * n * (2 * b + 8) + 2 * D * b + D
    return los + tangents + records + rows


def autodiff_package_size(model: "ForwardModel", nr: int, n: int,
                          jacfwd: bool = False) -> int:
    """Rays per package of ``kernel_autodiff`` (``jacfwd``:
    :func:`kernel_autodiff_jacfwd`) on an nr-ray batch (0: one package).
    ``RAYPACK`` n > 0 decides as it does for ``formod``, < 0 is one
    package; 0 on a card fits one package in flight
    (:func:`autodiff_ray_bytes` per ray) into 90 % of the free memory,
    read on every call; the CPU runs one package."""
    pack = int(model.ctl.raypack)
    if pack == 0 and model.device.type == "cuda":
        fit = int(0.9 * model.free_device_bytes()) \
            // autodiff_ray_bytes(model, n, jacfwd)
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


class _StateMap:
    """The state vector of a Jacobian and its map to the atm fields:
    ``x0`` (packed after the host's hydrostatic rebuild, as the FD kernel
    packs it) and :meth:`fields`, the scatter of x into the flat atm
    point axis (one gather and one select per field) with pressure
    rebuilt per (lon, lat) profile where HYDZ >= 0
    (``geometry.hydrostatic_profile_torch``), differentiable in x."""

    def __init__(self, ctl: Ctl, atm: Atm, dev, dtype):
        import torch

        from .geometry import hydrostatic_atm, profile_blocks
        hydrostatic_atm(ctl, atm)
        self.ctl, self.atm = ctl, atm
        self.x0, self.iqa, self.ipa = atm2x(ctl, atm)
        self.ig_h2o = ctl.emitter_index("H2O")
        self.blocks = profile_blocks(atm) if ctl.hydz >= 0 else []
        self.lat_ref = [float(atm.lat[a:b][int(np.argmin(np.abs(
            atm.z[a:b] - ctl.hydz)))]) for (a, b) in self.blocks]
        self.ten = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            dev, dtype)
        self.base = [self.ten(f) for f in (atm.p, atm.t, atm.q, atm.k)]
        self.scatter = [
            None if sc is None else (torch.from_numpy(sc[0]).to(dev),
                                     torch.from_numpy(sc[1]).to(dev))
            for sc in _state_scatter(ctl, atm, self.iqa, self.ipa)]

    def fields(self, x):
        """(p [N], t [N], q [G, N], k [W, N]) with x in place."""
        import torch

        from .geometry import hydrostatic_profile_torch
        p, t, q, k = (f if s is None else torch.where(s[0], x[s[1]], f)
                      for f, s in zip(self.base, self.scatter))
        if self.blocks:
            ig, atm = self.ig_h2o, self.atm
            p = torch.cat([hydrostatic_profile_torch(
                self.ctl.hydz, atm.z[a:b], p[a:b], t[a:b],
                q[ig, a:b] if ig >= 0 else None, lat)
                for (a, b), lat in zip(self.blocks, self.lat_ref)])
        return p, t, q, k


def _packages(model: "ForwardModel", obs: Obs, n: int, route: str):
    """The row slices of ``kernel_autodiff``'s ray packages; prints the
    one line that names them and the route."""
    pack = autodiff_package_size(model, obs.nr, n,
                                 route == "torch.func.jacfwd") or obs.nr
    starts = range(0, obs.nr, pack)
    print(f"# kernel_autodiff: {len(starts)} package(s) of up to {pack} "
          f"rays, n = {n}, {model.dtype} on {model.device}; {route}")
    return [slice(a, min(a + pack, obs.nr)) for a in starts]


def _pinned_blocks_made(cuda: bool) -> int:
    """The page-locked blocks PyTorch's caching host allocator has made
    in this process (0 off a card; its statistics are empty before its
    first block)."""
    import torch
    return (torch.cuda.host_memory_stats().get("num_host_alloc", 0)
            if cuda else 0)


def kernel_autodiff(ctl: Ctl, atm: Atm, obs: Obs,
                    model: Optional["ForwardModel"] = None) -> np.ndarray:
    """Jacobian K[m, n] = d rad / d x in forward mode (n, the state size,
    is far below m), in the model's dtype and on its device: the
    counterpart of the JAX package's compiled ``jax.jit(jax.jacfwd(fwd))``
    (``retrieval.py:161-284`` there), chained explicitly.

    1. The seed: ``torch.func.jacfwd`` of the state map (the scatter into
       the atm points and the in-graph hydrostatic rebuild,
       :class:`_StateMap`) on the small atm axis, the profile tangents
       [N, 2 + G + W, n]; rays gather them through their window indices
       (``geometry.ray_window_indices``), so a multi-profile atmosphere
       gives each scan its own profile by time.
    2. The tracer and its tangents (``geometry.trace_rays_jvp``: the
       record and tangent kernels of ``csrc/trace_rays_jvp.cu`` on a
       card, their plain version on the CPU).
    3. The eager RT pass on the model's exact or fast tables and its
       tangent (``ForwardModel.integrate_jvp``: the kernels of ``csrc/
       ega_jvp_fast.cu`` on a card, their record kernel's exact or fast
       instantiation; ``forward.rt_integrate_jvp_ref`` on the CPU).

    The seam: it differentiates the eager pipeline whatever kernel the
    model's forward runs, as the JAX package does (retrieval.py:178-191
    there): a ``KERNEL = exact`` model's exact lookups, every other
    model's fast ones.  Masked radiances give zero rows; the finite rows
    are returned as float64.

    A ray's rows depend only on its own profile and geometry, so the
    Jacobian runs ray package by ray package (:func:`autodiff_package_
    size`; one line names the packages and the route), each package's
    rows copied straight into their place in K: the same bits as one
    package.  K's host storage is taken once a call, before the first
    package, page-locked on a CUDA model (PyTorch's caching host
    allocator: a closed loop that drops its last K reuses the block),
    so that each package's rows reach it in one stream-ordered copy; K
    is the caller's own, aliased by nothing the model keeps.  A CUDA
    model launches the two kernels once per package, or raises; nothing
    falls back.

    With the model's ``phase_log`` a list, the call appends its record
    (``utils.phases``, root ``kernel_autodiff``): spans ``seed``,
    ``sizing`` (the packages and K's host storage), per package
    ``package tangents``, ``tracer tangents``, ``RT tangents``, ``K
    gather`` (the masked row select), ``K to host`` (the rows' copy
    into K and the entry flags' pull, which waits for it), then ``K
    assembly`` (what is left after the packages); counts ``k_bytes``
    (the bytes of K copied to the host), ``k_pinned_bytes`` (those that
    landed in page-locked memory) and ``k_pin_allocs`` (page-locked
    blocks the call made: the change in the host allocator's
    ``num_host_alloc``, 0 on the CPU).  A call that raises appends no
    record."""
    import torch

    from .forward import ForwardModel, _obs_rows
    from .geometry import check_entry_flag, trace_rays_jvp
    from .utils.phases import PhaseClock, begin

    if model is None:
        model = ForwardModel(ctl)
    cuda = model.device.type == "cuda"
    clock = None if model.phase_log is None else PhaseClock(
        "kernel_autodiff", model.device, model.phase_log)
    allocs0 = None if clock is None else _pinned_blocks_made(cuda)
    try:
        begin(clock, "seed")
        mask = ~np.isfinite(obs.rad)
        seed = autodiff_seed(ctl, atm, model)
        n = seed.map.x0.size
        route = "tangent kernels" if cuda else "plain tangent chain"
        begin(clock, "sizing")
        packages = _packages(model, obs, n, route)
        ends = np.cumsum([0] + [np.count_nonzero(~mask[r])
                                for r in packages]).tolist()
        K = torch.empty((ends[-1], n), dtype=torch.float64, pin_memory=cuda)
        for k, r in enumerate(packages):
            begin(clock, "package tangents", k)
            obs_k = _obs_rows(obs, r)
            prof, ptan, geo = package_tangents(ctl, atm, obs_k, model, seed)
            begin(clock, "tracer tangents")
            los, tan, flag = trace_rays_jvp(ctl, prof, ptan, geo)
            begin(clock, "RT tangents")
            _, drad = model.integrate_jvp(los, tan)       # [r, D, n]
            begin(clock, "K gather")
            rows = drad[~torch.from_numpy(mask[r]).to(model.device)]
            begin(clock, "K to host")
            K[ends[k]:ends[k + 1]].copy_(rows.to(torch.float64),
                                         non_blocking=True)
            check_entry_flag(flag.cpu().numpy())
        begin(clock, "K assembly", None)
        if clock is not None:
            clock.counts.update(
                k_bytes=K.nbytes,
                k_pinned_bytes=K.nbytes if K.is_pinned() else 0,
                k_pin_allocs=_pinned_blocks_made(cuda) - allocs0)
            clock.finish()
        return K.numpy()
    finally:
        if clock is not None:
            clock.close()


class AutodiffSeed(NamedTuple):
    """The first link of :func:`kernel_autodiff`'s chain: the state map,
    its ``torch.func.jacfwd`` at x0 -- the profile tangents ``d``
    [N, 2 + G + W, n] (p, t, q[G], k[W] at the atm points) -- and the
    fields (p, t, q, k) at x0."""
    map: "_StateMap"
    d: "torch.Tensor"
    fields: tuple


def autodiff_seed(ctl: Ctl, atm: Atm, model: "ForwardModel"
                  ) -> AutodiffSeed:
    """:class:`AutodiffSeed` of ``atm`` (hydrostatics applied to it in
    place, as the FD kernel packs x0) in the model's dtype and on its
    device."""
    import torch
    sm = _StateMap(ctl, atm, model.device, model.dtype)

    def stacked(x):
        p, t, q, k = sm.fields(x)
        return torch.cat([p[:, None], t[:, None], q.T, k.T], dim=1)
    x0 = sm.ten(sm.x0)
    return AutodiffSeed(sm, torch.func.jacfwd(stacked)(x0), sm.fields(x0))


def package_tangents(ctl: Ctl, atm: Atm, obs: Obs, model: "ForwardModel",
                     seed: AutodiffSeed):
    """(profiles, ``geometry.ProfileTangents``, observation geometry) of
    the rays of ``obs``: the profiles at x0 and the seed's tangents,
    gathered through the rays' window indices -- what the tracer's
    tangent pass takes."""
    import torch

    from .geometry import (ProfileTangents, build_ray_profiles,
                           ray_window_indices)
    dev = model.device
    _, _, gi = ray_window_indices(atm, obs)
    gi = torch.from_numpy(gi).to(dev)
    p0, t0, q0, k0 = seed.fields
    prof = build_ray_profiles(ctl, atm, obs, model.dtype, dev)._replace(
        p=p0[gi], t=t0[gi], q=q0[:, gi].movedim(0, 1).contiguous(),
        k=k0[:, gi].movedim(0, 1).contiguous())
    return prof, ProfileTangents(seed.d, gi), model._obs_geo(obs)


def kernel_autodiff_jacfwd(ctl: Ctl, atm: Atm, obs: Obs,
                           model: Optional["ForwardModel"] = None
                           ) -> np.ndarray:
    """:func:`kernel_autodiff` by ``torch.func.jacfwd`` through the whole
    eager pipeline: the plain tracer ``geometry.trace_rays_ref`` and the
    model's eager pass (:meth:`~jurassic_torch.forward.ForwardModel.
    integrate_eager`, its fast or exact tables) after the same state map,
    package by package: the oracle the tangent chain is held to (in the
    tests and on the card).
    It runs one host dispatch per operation and tangent batch: the
    tangents multiply the eager pass's float memory by up to 1 + n."""
    import torch

    from .forward import ForwardModel, _obs_rows
    from .geometry import (build_ray_profiles, ray_window_indices,
                           trace_rays_ref)

    if model is None:
        model = ForwardModel(ctl)
    dev, dtype = model.device, model.dtype
    mask = ~np.isfinite(obs.rad)
    sm = _StateMap(ctl, atm, dev, dtype)
    n = sm.x0.size

    def package_jacobian(obs_k: Obs, mask_k: np.ndarray) -> np.ndarray:
        _, _, gi = ray_window_indices(atm, obs_k)
        gi = torch.from_numpy(gi).to(dev)
        prof0 = build_ray_profiles(ctl, atm, obs_k, dtype, dev)
        geo = model._obs_geo(obs_k)
        masked = torch.from_numpy(mask_k).to(dev)

        def fwd(x):
            p, t, q, k = sm.fields(x)
            prof = prof0._replace(p=p[gi], t=t[gi],
                                  q=q[:, gi].movedim(0, 1),
                                  k=k[:, gi].movedim(0, 1))
            out = model.integrate_eager(trace_rays_ref(ctl, prof, geo))
            return torch.where(masked, 0.0, out.rad)

        jac = torch.func.jacfwd(fwd)(sm.ten(sm.x0))        # [r, D, n]
        return jac[~masked].to(torch.float64).cpu().numpy()

    return np.concatenate([package_jacobian(_obs_rows(obs, r), mask[r])
                           for r in _packages(model, obs, n,
                                              "torch.func.jacfwd")])
