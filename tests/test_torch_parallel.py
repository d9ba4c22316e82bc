"""The port's multi-GPU driver (``jurassic_torch.parallel``) in one
process, on the CPU: the mesh arithmetic, ``init_distributed``'s
plumbing (the twin of ``tests/test_parallel.py::
test_init_distributed_plumbing``), a world-size-1 gloo group on the
``ega`` golden bit for bit the one-process ``formod``, channel-range
models bit for bit the full model's columns, and the JAX package's
channel-sharded lane layout carried across (``n_chan = 2``).

The two-process runs are in ``tests/test_torch_distributed.py``.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jurassic_tpu.ops.pallas import build_turbo_tables as jax_build_turbo
from jurassic_tpu.ops.pallas.ega_fused import build_pallas_tables, shard_lanes
from jurassic_torch.forward import ForwardModel, channel_ctl, channel_slice
from jurassic_torch.ops.table_pack import (N_AUG, build_table_tables,
                                           table_tables_from_jax)
from jurassic_torch.ops.turbo_fit import (build_turbo_tables,
                                          slice_turbo_tables,
                                          turbo_tables_from_jax)
from jurassic_torch.parallel import (ShardedForwardModel, init_distributed,
                                     make_mesh, rank_channels, rank_rows)
from jurassic_torch.parallel import mesh as pmesh
from jurassic_torch.parallel.dryrun import OUTPUTS, free_port, load_case

from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"
TURBO_FIELDS = ("coef", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")
TABLE_FIELDS = ("eps_aug", "sr", "chan_mask", "p_ax", "t_ax", "np_u",
                "nt_u")


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("n_rays,n_chan,nr,nd",
                         [(2, 1, 11, 2), (1, 2, 11, 2), (3, 2, 10, 6),
                          (4, 1, 3, 5)])
def test_mesh_arithmetic(n_rays, n_chan, nr, nd):
    """Rank r is (r // n_chan, r % n_chan); every channel block's ray
    shares tile [0, nr) in order, unpadded, differing by at most one ray
    (the first nr % n_rays blocks take the extra ones); the channel
    blocks tile [0, nd)."""
    mesh = make_mesh(n_rays, n_chan, world_size=n_rays * n_chan)
    assert mesh.size == n_rays * n_chan
    for r in range(mesh.size):
        assert mesh.coords(r) == (r // n_chan, r % n_chan)
    for c in range(n_chan):
        shares = [rank_rows(mesh, a * n_chan + c, nr) for a in range(n_rays)]
        assert shares[0].start == 0 and shares[-1].stop == nr
        assert all(a.stop == b.start for a, b in zip(shares, shares[1:]))
        sizes = [s.stop - s.start for s in shares]
        assert sizes == [nr // n_rays + (a < nr % n_rays)
                         for a in range(n_rays)]
    if nd % n_chan:
        with pytest.raises(ValueError, match="not divisible"):
            rank_channels(mesh, 0, nd)
        return
    chans = [rank_channels(mesh, c, nd) for c in range(n_chan)]
    assert [(s.start, s.stop) for s in chans] == [
        (c * nd // n_chan, (c + 1) * nd // n_chan) for c in range(n_chan)]


def test_make_mesh_needs_the_ranks():
    """make_mesh raises where the group has fewer ranks than the mesh
    needs (mesh.py:57-61); n_rays defaults to world // n_chan; without a
    group the world is one process."""
    with pytest.raises(ValueError, match="needs 4 ranks, have 2"):
        make_mesh(2, 2, world_size=2)
    assert make_mesh(n_chan=2, world_size=8) == (4, 2)
    assert make_mesh() == (1, 1)
    with pytest.raises(ValueError, match="outside"):
        make_mesh(1, 1).coords(1)


def test_init_distributed_plumbing(monkeypatch):
    """init_distributed: a no-op without a rendezvous in the environment
    or the arguments; passes backend, init_method, world size and rank
    through to ``init_process_group`` (gloo on the CPU, ``env://`` by
    default, as torchrun sets it up) and fills the ctl's rank fields."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("MASTER_ADDR", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is None and not calls    # one process
    ctl = load_case({"golden": "ega", "kernel": "auto"})[0]
    assert init_distributed(init_method="tcp://host0:1234", world_size=2,
                            rank=1, ctl=ctl) == (1, 1)
    assert calls == [(("gloo",), {"init_method": "tcp://host0:1234",
                                  "world_size": 2, "rank": 1})]
    assert (ctl.mpi_glob_rank, ctl.mpi_local_rank) == (1, 1)
    calls.clear()
    monkeypatch.setenv("MASTER_ADDR", "host9")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert init_distributed() == (1, 0)                  # env-driven path
    assert calls == [(("gloo",), {"init_method": "env://", "world_size": -1,
                                  "rank": -1})]


@pytest.fixture
def gloo_world_of_one():
    init_distributed("gloo", f"tcp://localhost:{free_port()}", 1, 0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ["pallas", "turbo", "jax"])
def test_world_size_one_matches_formod(kernel, gloo_world_of_one):
    """A 1 x 1 mesh on a gloo group of one process: the collective runs,
    and the result is bit for bit ``ForwardModel.formod``'s."""
    ctl, atm, obs, kw = load_case({"golden": "ega", "kernel": kernel})
    ref = ForwardModel(ctl, device="cpu", **kw).formod(atm.copy(), obs.copy())
    m = ShardedForwardModel(ctl, make_mesh(), device="cpu", **kw)
    out = m.formod(atm.copy(), obs.copy())
    assert m.last_gather_s is not None and dist.get_world_size() == 1
    for f in OUTPUTS:
        assert np.array_equal(getattr(out, f), getattr(ref, f)), f


def _rough_case(kernel):
    ctl, atm, obs, kw = load_case({"workload": "rough_limb",
                                   "kernel": kernel})
    return ctl, atm, obs, kw["fast_tables"]


@pytest.mark.parametrize("kernel,variant", [("turbo", "turbo+hybrid"),
                                            ("pallas", "table"),
                                            ("jax", "fast")])
def test_channel_range_model_is_the_full_models_columns(kernel, variant):
    """The model of channels [2, 5) cut from the full model (tables and
    turbo rows sliced, nothing refitted) gives the full model's columns
    bit for bit; on the rough workload the range holds the bad-fit rows
    of channel 2, so turbo runs the hybrid in both."""
    ctl, atm, obs, ft = _rough_case(kernel)
    full = ForwardModel(ctl, fast_tables=ft, device="cpu")
    ref = full.formod(atm.copy(), obs.copy())
    part = full.channel_model(channel_ctl(ctl, 3, 2), 2)
    assert part.ctl.nu == ctl.nu[2:5] and part.ctl.nd == 3
    o = obs.copy()
    o.rad, o.tau = o.rad[:, 2:5].copy(), o.tau[:, 2:5].copy()
    got = part.formod(atm.copy(), o)
    assert full.last_variant == part.last_variant == variant
    assert np.array_equal(got.rad, ref.rad[:, 2:5])
    assert np.array_equal(got.tau, ref.tau[:, 2:5])


def test_exact_channel_range_model():
    """``KERNEL = exact`` on the ``ega`` golden: channel 1 alone, cut
    from the full model, is the full model's column 1 bit for bit."""
    ctl, atm, obs, kw = load_case({"golden": "ega", "kernel": "exact"})
    full = ForwardModel(ctl, device="cpu", **kw)
    ref = full.formod(atm.copy(), obs.copy())
    part = full.channel_model(channel_ctl(ctl, 1, 1), 1)
    o = obs.copy()
    o.rad, o.tau = o.rad[:, 1:].copy(), o.tau[:, 1:].copy()
    got = part.formod(atm.copy(), o)
    assert np.array_equal(got.rad, ref.rad[:, 1:])
    assert np.array_equal(got.tau, ref.tau[:, 1:])


def test_turbo_range_slice_is_a_refit():
    """Channels [d0, d0 + nd) of fitted turbo tables are byte-equal to the
    fit of those channels (rows are fitted one by one), with the bad rows
    counted in the range."""
    ctl, _a, _o, ft = _rough_case("turbo")
    tt, st = build_turbo_tables(ft)
    for nd, d0, n_bad in ((3, 2, 3), (3, 3, 0), (1, 2, 3)):
        got, st_g = slice_turbo_tables(tt, st, nd, d0)
        ref, st_r = build_turbo_tables(channel_slice(ft, nd, d0))
        for f in TURBO_FIELDS:
            assert _same_bytes(getattr(got, f).numpy(),
                               getattr(ref, f).numpy()), (nd, d0, f)
        assert (got.n_bad, st_g.rows) == (ref.n_bad, st_r.rows)
        assert got.n_bad == n_bad


def test_tables_from_jax_channel_shards():
    """JAX's channel-sharded lane layout (n_chan = 2: two back-to-back
    shards of 128 lanes, each with d_true = 3 true channels) carried
    across: all channels equal the port's own build byte for byte, each
    shard its channel range, and re-sharding the port's rows with JAX's
    ``shard_lanes`` gives JAX's planes back (the round trip)."""
    ctl, _a, _o, ft = _rough_case("turbo")
    pt, _st = jax_build_turbo(ft, n_chan=2)
    tb = build_pallas_tables(ft, n_chan=2)
    assert (pt.n_chan, pt.d_true, tb.d_true) == (2, 3, 3)
    tt, st = build_turbo_tables(ft)
    tab = build_table_tables(ft)

    def jax_fields(p):
        return [np.asarray(getattr(p, f)) for f in TABLE_FIELDS]

    kw = dict(d_true=pt.d_true, deg_f=pt.deg_f, deg_i=pt.deg_i,
              n_bad=pt.n_bad, n_chan=2)
    got = turbo_tables_from_jax(*jax_fields(pt), **kw)
    got_t = table_tables_from_jax(*jax_fields(tb), k_rows=tb.k_rows,
                                  d_true=tb.d_true, n_chan=2)
    for f in TURBO_FIELDS:
        assert _same_bytes(getattr(got, f).numpy(), getattr(tt, f).numpy()), f
    for f in TABLE_FIELDS:
        assert _same_bytes(getattr(got_t, f).numpy(),
                           getattr(tab, f).numpy()), f
    assert got.n_bad == tt.n_bad == 3 and got_t.monotone == tab.monotone
    for j in range(2):
        sl, _s = slice_turbo_tables(tt, st, 3, 3 * j)
        one = turbo_tables_from_jax(*jax_fields(pt), shard=j, **kw)
        for f in TURBO_FIELDS:
            assert _same_bytes(getattr(one, f).numpy(),
                               getattr(sl, f).numpy()), (j, f)
        assert one.n_bad == (3 if j == 0 else 0)
        one_t = table_tables_from_jax(*jax_fields(tb), k_rows=tb.k_rows,
                                      d_true=3, n_chan=2, shard=j)
        assert _same_bytes(one_t.rows().numpy(),
                           tab.rows().numpy()[..., 3 * j:3 * j + 3])
    Q = tt.q_rows
    lanes = np.asarray(pt.eps_aug)
    assert _same_bytes(shard_lanes(got.rows().numpy(), 2), lanes[:, :, :Q])
    K = tb.k_rows + N_AUG
    assert _same_bytes(shard_lanes(got_t.rows().numpy(), 2),
                       np.asarray(tb.eps_aug)[:, :, :K])


def test_sharded_model_refuses_what_the_mesh_cannot_take():
    """ND must divide by the channel extent (sharded.py:174-177), and
    every rank of the group must be a mesh cell."""
    ctl, _a, _o, kw = load_case({"golden": "ega", "kernel": "pallas"})
    with pytest.raises(ValueError, match="not divisible"):
        ShardedForwardModel(dataclasses.replace(ctl), pmesh.Mesh(1, 3),
                            device="cpu", **kw)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ShardedForwardModel(ctl, pmesh.Mesh(1, 2), device="cpu", **kw)


def test_usetpu_0_refuses_nccl(monkeypatch):
    """USETPU = 0 (never) contradicts an NCCL group (sharded.py:180-183)."""
    from jurassic_torch.parallel import sharded
    monkeypatch.setattr(sharded, "_nccl", lambda: True)
    ctl, _a, _o, kw = load_case({"golden": "ega", "kernel": "pallas"})
    assert ctl.usetpu == 0
    with pytest.raises(ValueError, match="USETPU = 0"):
        ShardedForwardModel(ctl, make_mesh(), device="cpu", **kw)
