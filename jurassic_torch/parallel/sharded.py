"""The multi-GPU forward model (port of
``jurassic_tpu/parallel/sharded.py``): one process per card, the
reference's per-rank dispatch (``cudaSetDevice(MPIlocalrank)`` +
``formod_one_package``, GPUdrivers.cu:262-360).

Every rank of a (ray ranks x channel ranks) :class:`~.mesh.Mesh` holds
the single-card :class:`~jurassic_torch.forward.ForwardModel` of its
channel range, its tables on its own card, and runs it on its share of
the rays: the package loop, the two CUDA streams and the hybrid's taint
splice work inside each rank unchanged.  The forward model needs no
collective of its own (the recursion carries no cross-ray and no
cross-channel state); one all-gather per ``formod`` assembles the result
on every rank, and the FOV convolution -- which reads neighbouring rays
-- and the observation mask run after it on the full batch.

Deviations from the JAX driver (ROADMAP.md section 3): ray shares are not
padded to the mesh multiple, and the turbo hybrid stays on (JAX demotes
it to the table kernel, ``sharded.py:184-193``).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import Ctl
from ..forward import (FAST_KERNELS, FUSED_KERNELS, ForwardModel, _obs_rows,
                       channel_ctl, channel_slice, formod_fov, fused_kernel,
                       turbo_fit_rejected, turbo_tables_cached)
from ..geometry import hydrostatic_atm
from ..io_tab import Atm, Obs
from ..ops.turbo_fit import TurboStats, TurboTables, slice_turbo_tables
from ..tables import EgaTables, FastTables, build_fast_tables, \
    load_tables_cached
from .mesh import Mesh, rank_channels, rank_rows, world


def _nccl() -> bool:
    return dist.is_initialized() and dist.get_backend() == "nccl"


def _buffer_device() -> torch.device:
    """Where a collective's buffer lives: the rank's card under NCCL, the
    host under gloo (and without a group)."""
    if _nccl():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_blocks(x, counts) -> list[np.ndarray]:
    """Every rank's rows of ``x`` ([counts[rank], ...], a tensor or NumPy
    array) on every rank, as float64 host arrays, in ONE all-gather.
    Gloo's all-gather takes equal shapes, so each block is padded to the
    largest inside the collective's buffer only."""
    rank, size = world()
    if len(counts) != size or counts[rank] != len(x):
        raise ValueError(f"rank {rank} holds {len(x)} rows, the counts say "
                         f"{counts}")
    x = torch.as_tensor(x).to(_buffer_device(), torch.float64)
    if not dist.is_initialized():
        return [x.numpy()]
    buf = x.new_zeros((max(counts),) + tuple(x.shape[1:]))
    buf[:len(x)] = x
    outs = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(outs, buf)
    host = torch.stack(outs).cpu().numpy()
    return [host[j, :counts[j]] for j in range(size)]


def global_put(x, mesh: Mesh, device=None) -> torch.Tensor:
    """This rank's rows (``rank_rows``) of the full host array ``x`` on
    ``device`` (default: where the collectives' buffers live): every rank
    holds the same full array, the drop-in ``formod`` contract."""
    rows = rank_rows(mesh, world()[0], len(x))
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[rows])).to(
        device or _buffer_device())


def global_put_local(x_local, global_shape, mesh: Mesh,
                     device=None) -> torch.Tensor:
    """PER-RANK data on ``device``: each rank passes only its own rows of
    a ``global_shape`` array, and no rank ever holds the full batch (the
    reference's MPI ranks split the observations the same way).  The rows
    must be the rank's share, ``rank_rows``."""
    rows = rank_rows(mesh, world()[0], global_shape[0])
    x = np.asarray(x_local)
    want = (rows.stop - rows.start,) + tuple(global_shape[1:])
    if x.shape != want:
        raise ValueError(f"rank {world()[0]} passes rows of shape {x.shape}"
                         f", its share of {tuple(global_shape)} is {want}")
    return torch.as_tensor(x).to(device or _buffer_device())


def host_gather(x, mesh: Mesh | None = None) -> np.ndarray:
    """This rank's rows (a tensor or NumPy array) -> the full host array,
    float64, on EVERY rank: the blocks of the ray ranks in order (with a
    ``mesh``, those of channel block 0; the ranks of one ray block hold
    the same rows).  Two collectives: the row counts, then the rows."""
    size = world()[1]
    if not dist.is_initialized():
        return _gather_blocks(x, [len(x)])[0]
    n = torch.tensor([len(x)], dtype=torch.int64, device=_buffer_device())
    ns = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(ns, n)
    blocks = _gather_blocks(x, [int(c) for c in ns])
    step = 1 if mesh is None else mesh.n_chan
    return np.concatenate(blocks[::step], axis=0)


class ShardedForwardModel:
    """Forward model over a (ray ranks x channel ranks) mesh, one process
    per card; a drop-in for :class:`~jurassic_torch.forward.ForwardModel`
    (``formod(atm, obs)`` on the full batch on every rank), whose
    single-card behaviour is the 1 x 1 mesh.

    Every rank of the process group is one mesh cell.  ``ND`` must divide
    by the mesh's channel extent (channels are physics configuration and
    never padded).  Each rank builds the single-card model of its channel
    range (``local``): the tables are cut before they reach its card
    (``forward.channel_slice``; the full host tables are read or taken
    once), and turbo rows are fitted per channel, so the rank fits (or
    reads from the file cache) its own channels only, or cuts the given
    ``turbo_tables``.  The kernel policy is the single-card model's
    (``forward.fused_kernel``) on the full tables, and the fit's
    acceptance gate reads the statistics of all channels (one small
    all-gather at construction): a rejected fit demotes every rank's
    kernel before its model is built, an accepted one reaches the local
    model with those statistics, so every rank runs the kernel a
    one-process model would."""

    def __init__(self, ctl: Ctl, mesh: Mesh, tables: EgaTables | None = None,
                 directory: str = ".", fast_tables: FastTables | None = None,
                 turbo_tables: TurboTables | None = None,
                 turbo_stats: TurboStats | None = None,
                 device=None, dtype=None):
        if ctl.nd % mesh.n_chan != 0:
            raise ValueError(f"ND={ctl.nd} not divisible by chan mesh axis "
                             f"{mesh.n_chan}")
        rank, size = world()
        if size != mesh.size:
            raise ValueError(f"the {mesh.n_rays}x{mesh.n_chan} mesh needs "
                             f"{mesh.size} ranks, the process group has "
                             f"{size}")
        if ctl.usetpu == 0 and _nccl():
            raise ValueError("USETPU = 0 (never) contradicts running on "
                             "NCCL; drop the mesh or set USETPU = -1/1")
        self.ctl, self.mesh, self.rank = ctl, mesh, rank
        chans = rank_channels(mesh, rank, ctl.nd)
        d0, nd = chans.start, chans.stop - chans.start
        if tables is None and fast_tables is None:
            tables = load_tables_cached(ctl, directory)
        if ctl.kernel in FAST_KERNELS and fast_tables is None:
            fast_tables = build_fast_tables(tables)
        ctl_r = channel_ctl(ctl, nd, d0)
        if ctl.kernel in FUSED_KERNELS:
            ctl_r.kernel = fused_kernel(ctl.kernel, fast_tables)
        tables_r = None if tables is None else channel_slice(tables, nd, d0)
        ft_r = (None if fast_tables is None
                else channel_slice(fast_tables, nd, d0))
        tt = st = None
        if ctl_r.kernel in ("auto", "turbo"):
            if turbo_tables is not None:
                if turbo_stats is None:
                    raise ValueError("turbo_tables need the turbo_stats of "
                                     "their fit")
                tt = slice_turbo_tables(turbo_tables, turbo_stats, nd, d0)[0]
                st, n_bad = turbo_stats, turbo_tables.n_bad
            else:
                tt, st_r = turbo_tables_cached(ctl_r, tables_r, ft_r,
                                               directory)
                st, n_bad = _all_channel_stats(st_r, tt.n_bad, mesh.n_chan)
            if turbo_fit_rejected(st, n_bad):
                ctl_r.kernel = fused_kernel(ctl_r.kernel, fast_tables,
                                            f"{st}, bad rows {n_bad}")
                tt = st = None
        self.local = ForwardModel(ctl_r, tables_r, directory,
                                  fast_tables=ft_r, turbo_tables=tt,
                                  turbo_stats=st, device=device, dtype=dtype)
        self.last_gather_s: float | None = None

    @property
    def kernel_mode(self) -> str:
        return self.local.kernel_mode

    @property
    def last_variant(self) -> str | None:
        return self.local.last_variant

    @property
    def device(self) -> torch.device:
        return self.local.device

    def formod(self, atm: Atm, obs: Obs) -> Obs:
        """Full forward model on every rank: fills obs.rad/obs.tau and the
        tangent points of all rays in place and returns obs.  Each rank
        runs hydrostatics on the full ``atm``, then its model on its rays
        (``rank_rows``), pulls its outputs to the host in one copy, and
        ONE all-gather assembles the [R, ND] result from the rays x
        channels grid (tangent points from channel block 0).  Only then
        the FOV convolution and the mask run, on the full batch: the
        convolution mixes each ray with its neighbours, which another rank
        may have computed.  ``last_gather_s`` is the collective's
        seconds."""
        ctl, mesh = self.ctl, self.mesh
        if ctl.checkmode:
            print(f"# formod: checkmode = {ctl.checkmode}, "
                  "no actual computation is performed!")
            return obs
        R, D = obs.nr, ctl.nd
        mask = ~np.isfinite(obs.rad)                  # save_mask
        rows = rank_rows(mesh, self.rank, R)
        dl = D // mesh.n_chan
        mine = _obs_rows(obs, rows)
        if mine.nr:
            self.local.formod_rays(atm, mine)
            cols = np.concatenate(
                [mine.rad, mine.tau,
                 np.stack([mine.tpz, mine.tplon, mine.tplat], axis=1)], 1)
        else:                       # more ray ranks than rays
            hydrostatic_atm(ctl, atm)
            cols = np.zeros((0, 2 * dl + 3))
        shares = [rank_rows(mesh, j, R) for j in range(world()[1])]
        counts = [sl.stop - sl.start for sl in shares]
        t0 = time.perf_counter()
        blocks = _gather_blocks(cols, counts)
        self.last_gather_s = time.perf_counter() - t0
        rad, tau, tp = np.empty((R, D)), np.empty((R, D)), np.empty((R, 3))
        for j, blk in enumerate(blocks):
            rj, cj = shares[j], rank_channels(mesh, j, D)
            rad[rj, cj], tau[rj, cj] = blk[:, :dl], blk[:, dl:2 * dl]
            if mesh.coords(j)[1] == 0:
                tp[rj] = blk[:, 2 * dl:]
        obs.rad, obs.tau = rad, tau
        obs.tpz, obs.tplon, obs.tplat = (np.ascontiguousarray(tp[:, i])
                                         for i in range(3))
        formod_fov(ctl, obs)
        obs.rad[mask] = np.nan                        # apply_mask
        return obs


def _all_channel_stats(stats: TurboStats, n_bad: int, n_chan: int):
    """(TurboStats, bad rows) of the fit of all channels from every
    rank's fit of its own channels (rows are fitted one by one): rows and
    bad rows summed over the channel blocks, the error maxima the
    largest; one all-gather of five numbers.  Ranks 0 .. n_chan - 1 are
    ray block 0's channel blocks."""
    size = world()[1]
    mine = [stats.rows, n_bad, stats.max_fwd_err, stats.max_inv_err,
            stats.max_chord_dev]
    allr = np.concatenate(_gather_blocks(np.asarray([mine], np.float64),
                                        [1] * size))
    blocks = allr[:n_chan]
    return (TurboStats(int(blocks[:, 0].sum()), float(allr[:, 2].max()),
                       float(allr[:, 3].max()), float(allr[:, 4].max())),
            int(blocks[:, 1].sum()))
