"""Multi-process runs of the sharded forward model.

``python -m jurassic_torch.parallel.dryrun N`` starts N processes and
runs the full ``formod`` over them, on the card where there is one, else
on the CPU (``USETPU = -1``).  The collectives go over NCCL when N cards
are present (one card each), else over gloo, and then the ranks share
the cards round-robin (``init_distributed``).  The shapes are those of
the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:78-137``): the ``ega`` golden
at NLOS 24 with max(2N, 6) rays, on an (N/2 x 2) mesh when N is even,
else (N x 1), in ``KERNEL = pallas``, ``jax`` and ``turbo``.  Every
result must be finite and bit for bit the one-process ``formod``.  Under
``torchrun --nproc-per-node N -m jurassic_torch.parallel.dryrun`` each
process torchrun starts is one rank.

:func:`run_cases` is the worker the tests start with
``torch.multiprocessing``: on a gloo group it runs a list of cases
(:func:`load_case`) and writes each gathered result to a file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import read_ctl
from ..forward import ForwardModel, _obs_rows
from ..io_tab import Obs, read_atm, read_obs
from ..workloads import small_limb
from .mesh import init_distributed, make_mesh
from .sharded import ShardedForwardModel, global_put, global_put_local, \
    host_gather

GOLD = Path(__file__).resolve().parents[2] / "tests" / "goldens"
# (pressure, temperature) cells of gas 0, channel 2 of the rough limb
# workload replaced by a staircase the Chebyshev fit cannot follow
ROUGH_CELLS = ((3, 2), (4, 2), (4, 3))
OUTPUTS = ("rad", "tau", "tpz", "tplon", "tplat")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rows(obs: Obs, nr: int) -> Obs:
    """The first ``nr`` rays of ``obs``, the scan repeated where it has
    fewer (``__graft_entry__._load_flagship``)."""
    reps = -(-nr // obs.nr)
    return Obs(**{f.name: np.ascontiguousarray(np.concatenate(
        [getattr(obs, f.name)] * reps)[:nr])
        for f in dataclasses.fields(Obs)})


def load_case(case: dict, usetpu: int = 0):
    """(ctl, atm, obs, model keyword arguments) of a case: ``golden``
    (a directory of ``tests/goldens``) or ``workload = "rough_limb"`` (a
    3-gas, 6-channel synthetic limb scan whose rows of gas 0, channel 2
    in three cells fail the fit gate: the hybrid), with ``kernel`` and
    optional ``nr`` (rays), ``nlos`` (with RAYDS 50 / RAYDZ 5),
    ``raypack`` and ``ip`` (with REFRAC 0)."""
    if case.get("workload") == "rough_limb":
        ctl, ft, atm, obs = small_limb(ng=3, nd=6, nr=case.get("nr", 11))
        eps = np.asarray(ft.eps, np.float64).copy()
        rng = np.random.default_rng(7)
        stair = np.cumsum(rng.uniform(0, 1, eps.shape[3]) ** 8)
        for (ip, it) in ROUGH_CELLS:
            eps[0, ip, it, :, 2] = 0.1 + 0.8 * stair / stair[-1]
        kw = {"fast_tables": ft._replace(eps=eps.astype(np.float32))}
    else:
        d = GOLD / case["golden"]
        ctl = read_ctl(["formod", str(next(d.glob("*.ctl"))), "o", "a",
                        "r"], verbose=False)
        ctl.tblbase = str(d / Path(ctl.tblbase).name)
        if ctl.fov != "-":
            ctl.fov = str(d / Path(ctl.fov).name)
        obs, atm = read_obs(d / "obs.tab", ctl), read_atm(d / "atm.tab", ctl)
        if case.get("nr"):
            obs = _rows(obs, case["nr"])
        kw = {"directory": str(d)}
    if case.get("nlos"):
        ctl.nlos, ctl.rayds, ctl.raydz = case["nlos"], 50.0, 5.0
    if case.get("ip", 1) != 1:
        ctl.ip, ctl.refrac = case["ip"], 0
    ctl.kernel = case["kernel"]
    ctl.raypack = case.get("raypack", 0)
    ctl.usetpu = usetpu
    return ctl, atm, obs, kw


def run_cases(rank: int, world_size: int, port: int, out_dir: str,
              cases: list) -> None:
    """One rank of a gloo group on the CPU: each case's sharded ``formod``
    (``mesh`` [n_rays, n_chan]), the gathered outputs written by rank 0
    to ``<out_dir>/<name>.npz`` and every rank's ``last_variant`` to
    ``<name>.<rank>.json``; a case of ``kind = "put_gather"`` places a
    [2 R, 3] array from per-rank rows (``global_put_local``), gathers it
    (``host_gather``) and writes it from every rank."""
    torch.set_num_threads(1)
    init_distributed("gloo", f"tcp://localhost:{port}", world_size, rank)
    out = Path(out_dir)
    try:
        for case in cases:
            mesh = make_mesh(*case["mesh"])
            name = case["name"]
            if case.get("kind") == "put_gather":
                R = 2 * world_size + 1
                full = np.arange(R * 3, dtype=np.float64).reshape(R, 3)
                mine = global_put(full, mesh)
                g = global_put_local(mine.numpy(), full.shape, mesh)
                np.save(out / f"{name}.{rank}.npy", host_gather(g, mesh))
                continue
            ctl, atm, obs, kw = load_case(case)
            m = ShardedForwardModel(ctl, mesh, device="cpu", **kw)
            m.formod(atm, obs)
            (out / f"{name}.{rank}.json").write_text(json.dumps(
                {"variant": m.last_variant, "channels": m.local.ctl.nd}))
            if rank == 0:
                np.savez(out / f"{name}.npz",
                         **{f: getattr(obs, f) for f in OUTPUTS})
    finally:
        dist.destroy_process_group()


def _dryrun_rank(rank: int, n: int, port: int | None) -> None:
    """One rank of the dryrun: the three kernels over the mesh, each
    against the one-process formod on this rank, on the rank's card
    whatever the backend."""
    nccl = torch.cuda.is_available() and torch.cuda.device_count() >= n
    init_distributed("nccl" if nccl else "gloo",
                     None if port is None else f"tcp://localhost:{port}",
                     n, rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    n_chan = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(n // n_chan, n_chan)
    try:
        for kernel in ("pallas", "jax", "turbo"):
            case = {"golden": "ega", "kernel": kernel, "nlos": 24,
                    "nr": max(2 * n, 6)}
            ctl, atm, obs, kw = load_case(case, -1)
            ref = _obs_rows(obs, slice(None))
            m = ShardedForwardModel(ctl, mesh, **kw)
            m.formod(atm.copy(), obs)
            ForwardModel(ctl, **kw).formod(atm.copy(), ref)
            if not np.isfinite(obs.rad).all():
                raise RuntimeError(f"dryrun {kernel}: non-finite radiances")
            for f in OUTPUTS:
                if not np.array_equal(getattr(obs, f), getattr(ref, f)):
                    raise RuntimeError(f"dryrun {kernel}: {f} differs from "
                                       "the one-process formod")
            if rank == 0:
                print(f"dryrun {kernel}: {obs.nr} rays x {ctl.nd} channels "
                      f"over a {mesh.n_rays}x{mesh.n_chan} mesh on "
                      f"{m.device} ({dist.get_backend()}), variant "
                      f"{m.last_variant}: bit for bit the one-process "
                      "formod", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:    # torchrun
        _dryrun_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     None)
        return 0
    if len(argv) != 1:
        print("usage: python -m jurassic_torch.parallel.dryrun N",
              file=sys.stderr)
        return 2
    n = int(argv[0])
    torch.multiprocessing.start_processes(
        _dryrun_rank, args=(n, free_port()), nprocs=n, join=True,
        start_method="spawn")
    print(f"dryrun ok on {n} processes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
