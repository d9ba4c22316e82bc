"""Ray packages of the port (``RAYPACK``), on the CPU: the twin of
``tests/test_utils_and_raypack.py::test_raypack_bitwise_identical`` for
every pass the port runs, and the sizing of ``RAYPACK = 0`` with the
card's free memory stood in for (``torch.cuda.mem_get_info`` and the
allocator's counters monkeypatched; nothing here needs a card).

Packages are split evenly and not padded (nothing is compiled per
shape); every pass works ray by ray, so a package's rays give the bits
they give in the whole batch.  The hybrid re-runs only the packages that
carry taint, through the table pass, and splices lane by lane."""
import numpy as np
import pytest
import torch

from jurassic_torch import forward as tf
from jurassic_torch.workloads import small_limb

from test_torch_cli import _roughen
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)


def _model(kernel):
    ctl, ft, atm, obs = small_limb(ng=3, nd=8, nr=37, nlos=120,
                                   rayds=20.0, raydz=2.0)
    if kernel == "hybrid":
        ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
    ctl.kernel = "turbo" if kernel == "hybrid" else kernel
    return tf.ForwardModel(ctl, fast_tables=ft, device="cpu"), atm, obs


@pytest.mark.parametrize("kernel, variant", [
    ("turbo", "turbo"), ("pallas", "table"), ("jax", "fast"),
    ("hybrid", "turbo+hybrid")])
def test_raypack_bitwise_identical(kernel, variant, capsys):
    """RAYPACK 16 on 37 rays (packages of 13, 13 and 11) is bit for bit
    the one-package run."""
    m, atm, obs = _model(kernel)
    o1 = obs.copy()
    m.formod(atm.copy(), o1)
    assert m.last_variant == variant
    assert m.package_size(37) == 0
    n1 = capsys.readouterr().out.count("lanes re-evaluated")
    m.ctl.raypack = 16
    assert m.package_size(37) == 13
    o2 = obs.copy()
    m.formod(atm.copy(), o2)
    assert m.last_variant == variant
    n2 = capsys.readouterr().out.count("lanes re-evaluated")
    assert (n1, n2) == ((1, 3) if kernel == "hybrid" else (0, 0))
    for f in ("rad", "tau", "tpz", "tplon", "tplat"):
        np.testing.assert_array_equal(getattr(o2, f), getattr(o1, f), f)
    assert np.isfinite(o1.rad).all() and (o1.rad > 0).any()


def test_even_split():
    """An explicit RAYPACK n runs as many packages as n implies, of
    equal size (forward.py:555-569); RAYPACK >= nr or < 0: one."""
    m, _a, _o = _model("turbo")
    for pack, nr, want in ((16, 37, 13), (717, 1084, 542),
                           (500, 1084, 362), (1, 5, 1), (37, 37, 0),
                           (50, 37, 0)):
        assert m.package_size(nr, pack) == want
    m.ctl.raypack = -1
    assert m.package_size(10 ** 6) == 0


class _FakeCard:
    """torch.cuda's memory counters with a free-memory figure that the
    test sets, and a count of the reads."""

    def __init__(self, monkeypatch, free):
        self.free, self.reads = free, 0
        monkeypatch.setattr(torch.cuda, "mem_get_info", self.mem_get_info)
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 3 << 20)
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1 << 20)

    def mem_get_info(self, device):
        self.reads += 1
        return self.free, 80 << 30


@pytest.mark.parametrize("kernel", ["turbo", "hybrid", "jax"])
def test_raypack_auto_sizing(kernel, monkeypatch, capsys):
    """RAYPACK = 0 on a card: two packages in flight plus what every
    package keeps until the pull fit 90 % of the free memory (the
    allocator's cached, unused 2 MiB count as free); the figure is read
    on every call, and the sizing line names bytes per ray, free GB and
    rays per package.  The figure is the card's route's (for ``jax``, the
    RT kernel's)."""
    m, _a, _o = _model(kernel)
    m.device = torch.device("cuda", 0)
    flight, kept = m._ray_bytes()
    assert m.per_ray_device_bytes() == flight + kept > 0
    # every package keeps its outputs (4 x [D] f32 per ray), the hybrid
    # its LOS as well, for a re-run
    assert (kept > 4 * 8 * 4) == (kernel == "hybrid")
    nr = 1000
    free = nr * kept + 2 * 100 * flight + flight // 2
    card = _FakeCard(monkeypatch, int(free / 0.9) - (2 << 20) + 1)
    assert m._resolve_raypack(nr) == 100
    assert m.package_size(nr) == 100
    out = capsys.readouterr().out
    assert f"# RAYPACK auto: 100 rays/package ({flight + kept} B/ray" in out
    card.free *= 20                               # the whole batch fits
    assert m.package_size(nr) == 0
    assert "1000 rays/package" in capsys.readouterr().out
    assert card.reads == 3
    m.ctl.raypack = 7                             # explicit: no read
    assert m.package_size(nr) == 7
    assert card.reads == 3


def test_exact_counts_its_rows():
    """In exact mode a ray in flight holds a corner's u and eps rows
    [G, D, U]: the figure grows with the table's U."""
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    ctl, ft, _a, _o = small_limb(ng=3, nd=8, nr=4)
    ctl.kernel = "exact"
    tb = fast_to_ega_tables(ft)
    m = tf.ForwardModel(ctl, tb, device="cpu")
    G, D, U = 3, 8, tb.u.shape[3]
    assert m.per_ray_device_bytes() > G * D * U * 2 * (4 + 8)
    ctl.kernel = "jax"
    assert tf.ForwardModel(ctl, tb, device="cpu").per_ray_device_bytes() \
        < m.per_ray_device_bytes()


def test_one_package_on_the_cpu(monkeypatch):
    """On the CPU RAYPACK = 0 is one package and reads no card."""
    def boom(*a):
        raise AssertionError("read the card's memory on the CPU")
    monkeypatch.setattr(torch.cuda, "mem_get_info", boom)
    m, _a, _o = _model("turbo")
    assert m.ctl.raypack == 0 and m.package_size(10 ** 6) == 0
