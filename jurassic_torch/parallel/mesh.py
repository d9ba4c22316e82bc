"""Process group and mesh of the multi-GPU driver (port of
``jurassic_tpu/parallel/mesh.py``).

The reference runs one MPI rank per GPU and selects the card with
``cudaSetDevice(MPIlocalrank)`` (GPUdrivers.cu:284-288).  The port does
the same with ``torch.distributed``: one process per card, observation
rays split over the mesh's ray axis and spectral channels optionally over
its channel axis (legitimate because the transmittance recursion carries
no cross-channel state, jr_common.h:271-280).  A process holds only the
tables of its own channel range, so the per-card table footprint shrinks
with the channel split.

Unlike the JAX mesh the ray shares are not padded to a mesh multiple: the
port compiles nothing per shape, so rank r simply gets ``rank_rows``.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """A ray ranks x channel ranks grid over the processes of the group:
    rank r sits at (r // n_chan, r % n_chan), row-major like the JAX
    mesh's ``np.reshape(n_rays, n_chan)``."""
    n_rays: int
    n_chan: int

    @property
    def size(self) -> int:
        return self.n_rays * self.n_chan

    def coords(self, rank: int) -> tuple[int, int]:
        """(ray block, channel block) of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside the {self.n_rays}x"
                             f"{self.n_chan} mesh")
        return divmod(rank, self.n_chan)


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, ctl=None):
    """Join the process group (the reference's MPI start-up; it consumes
    the rank ids only for device selection, jurassic.h:336-338).

    A no-op returning None without arguments when the environment has no
    ``MASTER_ADDR`` or no ``WORLD_SIZE`` (a single process, as under
    ``jax.distributed``'s absent coordinator).  Otherwise the backend
    defaults to NCCL where CUDA is present and gloo on the CPU; the
    rendezvous to ``init_method`` (default ``env://``, as ``torchrun``
    sets it up).  On a card the process selects its device from
    ``LOCAL_RANK`` (default: the global rank) before any model is built:
    under NCCL the card ``LOCAL_RANK`` (a rank per card), under gloo the
    ranks of a host share its cards round-robin.  ``ctl``, when given,
    gets ``mpi_glob_rank`` and ``mpi_local_rank``.  Returns (global rank,
    local rank)."""
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not ("MASTER_ADDR" in os.environ
                             and "WORLD_SIZE" in os.environ):
        return None
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=-1 if world_size is None
                                else world_size,
                                rank=-1 if rank is None else rank)
    g_rank = dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", g_rank))
    if cuda:
        n_dev = torch.cuda.device_count()
        if backend == "nccl" and local >= n_dev:
            raise ValueError(f"local rank {local} has no card of its own "
                             f"({n_dev} visible): NCCL takes one rank per "
                             "card")
        torch.cuda.set_device(local % n_dev)
    if ctl is not None:
        ctl.mpi_glob_rank, ctl.mpi_local_rank = g_rank, local
    return g_rank, local


def make_mesh(n_rays: int | None = None, n_chan: int = 1,
              world_size: int | None = None) -> Mesh:
    """A ray x channel mesh over the process group (default: its world
    size, 1 without a group); ``n_rays`` defaults to ``world_size //
    n_chan``.  Raises where the group has fewer ranks than the mesh
    needs."""
    if world_size is None:
        world_size = world()[1]
    if n_chan < 1:
        raise ValueError(f"n_chan = {n_chan}")
    if n_rays is None:
        n_rays = world_size // n_chan
    need = n_rays * n_chan
    if need < 1 or need > world_size:
        raise ValueError(f"mesh {n_rays}x{n_chan} needs {need} ranks, "
                         f"have {world_size}")
    return Mesh(n_rays, n_chan)


def rank_rows(mesh: Mesh, rank: int, nr: int) -> slice:
    """The rays of ``rank`` in an nr-ray batch: an even, unpadded share of
    its ray block, the first ``nr % n_rays`` blocks one ray more."""
    a = mesh.coords(rank)[0]
    base, extra = divmod(nr, mesh.n_rays)
    start = a * base + min(a, extra)
    return slice(start, start + base + (a < extra))


def rank_channels(mesh: Mesh, rank: int, nd: int) -> slice:
    """The channels of ``rank``: its channel block's ``nd / n_chan``
    channels (``nd`` must divide evenly: channels are physics
    configuration and never padded)."""
    if nd % mesh.n_chan:
        raise ValueError(f"ND={nd} not divisible by chan mesh axis "
                         f"{mesh.n_chan}")
    c = mesh.coords(rank)[1]
    ds = nd // mesh.n_chan
    return slice(c * ds, (c + 1) * ds)
