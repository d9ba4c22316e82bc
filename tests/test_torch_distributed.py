"""Two gloo processes on the CPU run the port's ``ShardedForwardModel``:
the twin of ``tests/test_parallel.py`` (sharded vs single device, an
uneven ray count, the kernels under the mesh, RAYPACK under the mesh) and
of ``tests/test_distributed.py`` (per-rank input loading and the result
gather across real processes).

One spawn per module: the module fixture starts two processes running
``jurassic_torch.parallel.dryrun.run_cases`` on every case, each case's
gathered result goes to a file, and the parametrised tests read them, so
every case counts without another process start.

Bars: every case equals the port's one-process ``formod`` bit for bit
(rays and channels are independent, and the plain fused pass on the CPU
computes every transcendental on PyTorch's vector path,
``ops.ega_fused._lanes``).  Against the JAX package's
``ShardedForwardModel`` on the same mesh, the port's parity bars
(``tests/test_torch_forward.py``): turbo 5e-5 of max|rad| and 5e-5 on
tau, the eager ``jax`` pipeline 1e-9 relative, and table mode on the
roughened synthetic scan 5e-6 of max|rad| and 5e-6 on tau, the bar of
``tests/test_torch_forward.py`` for staircase rows (their slope
amplifies the last-bit differences of exp2/log2 between XLA and
PyTorch).  On the ``ega`` golden the two packages' one-process table
``formod`` runs differ by 4e-5 of max|rad| (``tests/jax_table_gap.py``;
an open fault, ROADMAP.md section 3), so that case is not compared.
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jurassic_tpu.config as jcfg
import jurassic_tpu.io_tab as jio
from jurassic_tpu.parallel import ShardedForwardModel as JaxSharded
from jurassic_tpu.parallel import make_mesh as jax_make_mesh
from jurassic_torch.forward import ForwardModel
from jurassic_torch.parallel.dryrun import (OUTPUTS, ROUGH_CELLS, free_port,
                                            load_case, run_cases)

from test_torch_host_copies import golden_case, small_limb_pair
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"
SPAWN_TIMEOUT = 600      # seconds for both processes and every case

CASES = [
    {"name": "ega_2x1_pallas", "golden": "ega", "mesh": [2, 1],
     "kernel": "pallas"},
    {"name": "ega_1x2_pallas", "golden": "ega", "mesh": [1, 2],
     "kernel": "pallas"},
    {"name": "ega_2x1_turbo", "golden": "ega", "mesh": [2, 1],
     "kernel": "turbo"},
    {"name": "ega_1x2_turbo", "golden": "ega", "mesh": [1, 2],
     "kernel": "turbo"},
    {"name": "ega_2x1_jax", "golden": "ega", "mesh": [2, 1],
     "kernel": "jax"},
    {"name": "ega_1x2_jax", "golden": "ega", "mesh": [1, 2],
     "kernel": "jax"},
    {"name": "ega_1x2_exact", "golden": "ega", "mesh": [1, 2],
     "kernel": "exact"},
    {"name": "ega_2x1_fast", "golden": "ega", "mesh": [2, 1],
     "kernel": "fast"},
    # obs.nr - 3 rays (tests/test_parallel.py:53)
    {"name": "ega_2x1_nr8", "golden": "ega", "mesh": [2, 1],
     "kernel": "pallas", "nr": 8},
    # one ray: rank 1's share is empty
    {"name": "ega_2x1_nr1", "golden": "ega", "mesh": [2, 1],
     "kernel": "turbo", "nr": 1},
    # RAYPACK 3 under the mesh (tests/test_parallel.py:134)
    {"name": "ega_2x1_raypack3", "golden": "ega", "mesh": [2, 1],
     "kernel": "pallas", "raypack": 3},
    # the FOV convolution reads neighbouring rays: after the gather only
    {"name": "fov_2x1_auto", "golden": "fov", "mesh": [2, 1],
     "kernel": "auto"},
    {"name": "fov_1x2_auto", "golden": "fov", "mesh": [1, 2],
     "kernel": "auto"},
    # the hybrid stays on every rank; channel 2's bad rows on rank 0 of
    # the channel split, on both ranks of the ray split
    {"name": "rough_2x1_turbo", "workload": "rough_limb", "mesh": [2, 1],
     "kernel": "turbo"},
    {"name": "rough_1x2_turbo", "workload": "rough_limb", "mesh": [1, 2],
     "kernel": "turbo"},
    {"name": "rough_1x2_pallas", "workload": "rough_limb", "mesh": [1, 2],
     "kernel": "pallas"},
    # IP = 2 (REFRAC 0) through the same split
    {"name": "rough_2x1_ip2", "workload": "rough_limb", "mesh": [2, 1],
     "kernel": "auto", "ip": 2},
    {"name": "put_gather", "kind": "put_gather", "mesh": [2, 1]},
]
FORMOD = [c for c in CASES if c.get("kind") != "put_gather"]
# what each rank's model ran, where the split decides it
VARIANTS = {"rough_2x1_turbo": ["turbo+hybrid", "turbo+hybrid"],
            "rough_1x2_turbo": ["turbo+hybrid", "turbo"],
            "ega_2x1_nr1": ["turbo", None]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The directory of the two processes' results, every case run once."""
    out = tmp_path_factory.mktemp("two_ranks")
    ctx = torch.multiprocessing.start_processes(
        run_cases, args=(2, free_port(), str(out), CASES), nprocs=2,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                pytest.fail(f"the two ranks did not finish in "
                            f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return out


def _one_process(case):
    ctl, atm, obs, kw = load_case(case)
    m = ForwardModel(ctl, device="cpu", **kw)
    return m.formod(atm, obs), m.last_variant


@pytest.mark.parametrize("case", FORMOD, ids=[c["name"] for c in FORMOD])
def test_two_ranks_match_one_process(results, case):
    got = np.load(results / f"{case['name']}.npz")
    ref, variant = _one_process(case)
    for f in OUTPUTS:
        assert np.array_equal(got[f], getattr(ref, f)), f
    assert np.isfinite(got["rad"]).all()
    ranks = [json.loads((results / f"{case['name']}.{r}.json").read_text())
             for r in range(2)]
    n_chan = case["mesh"][1]
    assert [r["channels"] for r in ranks] == [ref.rad.shape[1] // n_chan] * 2
    assert [r["variant"] for r in ranks] == VARIANTS.get(case["name"],
                                                         [variant] * 2)


def test_put_local_and_gather(results):
    """Each rank places only its own rows (``global_put_local``) of a
    5 x 3 array (shares of 3 and 2 rows), and ``host_gather`` gives every
    rank the full array (tests/distributed_child.py:33-41)."""
    full = np.arange(15, dtype=np.float64).reshape(5, 3)
    for r in range(2):
        got = np.load(results / f"put_gather.{r}.npy")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, full)


def _jax_sharded(case, mesh):
    """The JAX package's sharded formod of a case on its virtual CPU
    devices, from its own readers and generators."""
    if case.get("workload") == "rough_limb":
        from test_torch_cli import _roughen
        (ctl, ft, atm, obs), _ = small_limb_pair(ng=3, nd=6, nr=11)
        ctl.kernel = case["kernel"]
        ft = _roughen(ft, ROUGH_CELLS)
        return JaxSharded(ctl, jax_make_mesh(*mesh),
                          fast_tables=ft).formod(atm, obs)
    ctl, obs, atm = golden_case(case["golden"], jcfg, jio,
                                kernel=case["kernel"])
    return JaxSharded(ctl, jax_make_mesh(*mesh),
                      directory=str(GOLD / case["golden"])).formod(atm, obs)


@pytest.mark.parametrize("name,bar", [("ega_1x2_turbo", 5e-5),
                                      ("ega_1x2_jax", 1e-9),
                                      ("rough_1x2_pallas", 5e-6)])
def test_two_ranks_match_jax_sharded(results, name, bar):
    """The port's 1 x 2 mesh against the JAX package's sharded model on a
    1 x 2 mesh of its virtual CPU devices: within ``bar`` of max|rad| and
    on tau (relative for the eager ``jax`` pipeline)."""
    case = next(c for c in CASES if c["name"] == name)
    out = _jax_sharded(case, (1, 2))
    got = np.load(results / f"{name}.npz")
    if case["kernel"] == "jax":
        np.testing.assert_allclose(got["rad"], out.rad, rtol=bar, atol=0)
        np.testing.assert_allclose(got["tau"], out.tau, rtol=bar, atol=0)
    else:
        scale = np.abs(out.rad).max()
        assert np.abs(got["rad"] - out.rad).max() <= bar * scale
        assert np.abs(got["tau"] - out.tau).max() <= bar
