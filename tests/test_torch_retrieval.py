"""The port's retrieval Jacobians against the JAX package's, float64 on
the CPU.

* The differentiable hydrostatic rebuild ``geometry.
  hydrostatic_profile_torch`` against JAX's ``hydrostatic_profile_jnp``
  and the port's NumPy ``hydrostatic_profile`` (1e-12 relative), and its
  ``torch.func.jacfwd`` in (p, t, q_h2o) against ``jax.jacfwd`` (1e-10).
* ``kernel_autodiff`` against JAX's on the ``setup`` case of
  ``tests/test_retrieval.py:20-34`` (a 10-element state), within 1e-8 of
  max|K|; the port's FD ``kernel`` against its autodiff there at JAX's
  bars (``:67-75``); the matrix round trip (``:188-198``).
* The ray packages of ``kernel_autodiff``: bit for bit one package, with
  masked radiances in them too, and their sizing on a card.

JAX's model runs its jnp pipeline on the CPU under ``KERNEL = auto``;
the port's twin is its eager ``KERNEL = jax`` model (on the CPU the
port's ``auto`` runs the fused kernels' plain versions).  Objects are
made by the JAX package's generators and carried across with the
converters of ``tests/test_torch_host_copies.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jurassic_tpu.geometry as jgeom
import jurassic_torch.geometry as tgeom
import jurassic_torch.retrieval as tret
from jurassic_tpu.forward import ForwardModel as JaxModel
from jurassic_tpu.io_tab import Atm as JaxAtm
from jurassic_tpu.models.synthetic import (limb_workload, synthetic_atm,
                                           synthetic_ctl,
                                           synthetic_fast_tables)
from jurassic_tpu.retrieval import kernel_autodiff as jax_kernel_autodiff
from jurassic_torch.forward import ForwardModel
from jurassic_torch.io_tab import read_matrix, write_matrix
from test_torch_host_copies import (one_thread, port_atm,  # noqa: F401
                                    port_ctl, port_fast_tables, port_obs)
from test_torch_raypack import _FakeCard


def two_profile_atm(ctl, dz=5.0):
    """Two scans' profiles at distinct (lon, lat) and times, the second
    warmer and wetter (``tests/test_retrieval.py:152-164``)."""
    a0, a1 = synthetic_atm(ctl, dz=dz), synthetic_atm(ctl, dz=dz)
    a1.t = a1.t + 6.0
    a1.q[1] = a1.q[1] * 1.4
    return JaxAtm(
        time=np.concatenate([a0.time, a1.time + 3600.0]),
        z=np.concatenate([a0.z, a1.z]),
        lon=np.concatenate([a0.lon, np.full(a1.npts, 10.0)]),
        lat=np.concatenate([a0.lat, np.full(a1.npts, 5.0)]),
        p=np.concatenate([a0.p, a1.p]), t=np.concatenate([a0.t, a1.t]),
        q=np.concatenate([a0.q, a1.q], axis=1),
        k=np.concatenate([a0.k, a1.k], axis=1))


@pytest.fixture(scope="module")
def setup():
    """The JAX case of tests/test_retrieval.py:20-34 and its port twin:
    T in 10-30 km and gas 1 in 20-40 km on a 5 km grid (10 elements),
    4 limb rays, NLOS 96."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as the autouse one_thread does
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 96
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 30.0
    ctl.retq_zmin = [-999.0, 20.0]
    ctl.retq_zmax = [-999.0, 40.0]
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, 4)
    ft = synthetic_fast_tables(ctl, n_p=12, n_t=8, n_k=96)
    jax_model = JaxModel(ctl, fast_tables=ft)
    ctl_t = dataclasses.replace(port_ctl(ctl), kernel="jax")
    model = ForwardModel(ctl_t, fast_tables=port_fast_tables(ft),
                         device="cpu")
    K = tret.kernel_autodiff(ctl_t, port_atm(atm.copy()),
                             port_obs(obs.copy()), model)
    torch.set_num_threads(n_threads)
    return dict(ctl=ctl, atm=atm, obs=obs, jax_model=jax_model, ctl_t=ctl_t,
                model=model, K=K)


def _profiles():
    """(z, p, t, q_h2o, lat) of each profile of the synthetic and the
    two-profile atmospheres, with H2O's vmr."""
    ctl = synthetic_ctl(ng=2, nd=3)       # emitters CO2, H2O
    ig = ctl.emitter_index("H2O")
    out = []
    for atm in (synthetic_atm(ctl), two_profile_atm(ctl)):
        n = atm.npts // (2 if atm.lon[-1] != atm.lon[0] else 1)
        for a in range(0, atm.npts, n):
            sl = slice(a, a + n)
            out.append((atm.z[sl], atm.p[sl], atm.t[sl], atm.q[ig, sl],
                        atm.lat[sl]))
    return out


@pytest.mark.parametrize("hydz", [0.0, 20.0, 55.0])
@pytest.mark.parametrize("with_h2o", [True, False])
def test_hydrostatic_twin(hydz, with_h2o):
    """The differentiable rebuild equals JAX's and the NumPy recursion
    (1e-12 relative) on every profile, and its forward-mode Jacobian in
    (p, t, q_h2o) equals JAX's (1e-10 of its largest element)."""
    for z, p, t, q, lat in _profiles():
        q = q if with_h2o else None
        ipref = int(np.argmin(np.abs(z - hydz)))
        lat0 = float(lat[ipref])
        ten = torch.from_numpy
        got = tgeom.hydrostatic_profile_torch(
            hydz, z, ten(p), ten(t), None if q is None else ten(q), lat0)
        assert got.dtype == torch.float64
        ref_j = np.asarray(jgeom.hydrostatic_profile_jnp(
            hydz, z, jnp.asarray(p), jnp.asarray(t),
            None if q is None else jnp.asarray(q), lat0))
        ref_n = tgeom.hydrostatic_profile(hydz, z, p, t, q, lat)
        np.testing.assert_allclose(got.numpy(), ref_j, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got.numpy(), ref_n, rtol=1e-12, atol=0)

        def f_t(pp, tt, qq):
            return tgeom.hydrostatic_profile_torch(hydz, z, pp, tt, qq, lat0)

        def f_j(pp, tt, qq):
            return jgeom.hydrostatic_profile_jnp(hydz, z, pp, tt, qq, lat0)
        args = (p, t, q) if with_h2o else (p, t)
        argnums = tuple(range(len(args)))
        jt = torch.func.jacfwd(
            (f_t if with_h2o else lambda pp, tt: f_t(pp, tt, None)),
            argnums=argnums)(*(ten(a) for a in args))
        jj = jax.jacfwd(
            (f_j if with_h2o else lambda pp, tt: f_j(pp, tt, None)),
            argnums=argnums)(*(jnp.asarray(a) for a in args))
        for a, b in zip(jt, jj):
            b = np.asarray(b)
            assert np.abs(b).max() > 0
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-10 * np.abs(b).max())


def test_autodiff_matches_jax(setup):
    """The port's kernel_autodiff equals JAX's on the same inputs within
    1e-8 of max|K| (both float64, both through the eager fast pipeline
    with the in-graph profile scatter)."""
    s = setup
    K_j = jax_kernel_autodiff(s["ctl"], s["atm"].copy(), s["obs"].copy(),
                              s["jax_model"])
    K = s["K"]
    assert K.shape == K_j.shape == (s["obs"].nr * s["ctl"].nd, 10)
    assert K.dtype == np.float64
    scale = np.abs(K_j).max()
    assert scale > 0
    np.testing.assert_allclose(K, K_j, rtol=0, atol=1e-8 * scale)


def test_fd_vs_autodiff_jacobian(setup):
    """Twin of tests/test_retrieval.py:67-75: the port's FD kernel (n+1
    formods) against the port's autodiff, at JAX's bars."""
    s = setup
    K_fd = tret.kernel(s["ctl_t"], port_atm(s["atm"].copy()),
                       port_obs(s["obs"].copy()), s["model"])
    K_ad = s["K"]
    assert K_fd.shape == K_ad.shape == (s["obs"].nr * s["ctl"].nd, 10)
    scale = np.abs(K_ad).max()
    assert scale > 0
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)


def test_perturbation_sizes_match_jax(setup):
    from jurassic_tpu.retrieval import atm2x, perturbation_sizes
    s = setup
    ctl = dataclasses.replace(s["ctl"], retp_zmin=0.0, retp_zmax=20.0)
    x, iqa, _ = atm2x(ctl, s["atm"])
    h = tret.perturbation_sizes(port_ctl(ctl), x, iqa)
    np.testing.assert_array_equal(h, perturbation_sizes(ctl, x, iqa))
    assert set(np.unique(iqa)) == {0, 1, 3}


def test_write_read_matrix_roundtrip(tmp_path, setup):
    """Twin of tests/test_retrieval.py:188-198 on the port's K."""
    s = setup
    ctl = dataclasses.replace(s["ctl_t"], write_matrix=1)
    obs1 = port_obs(s["obs"].copy())
    s["model"].formod(port_atm(s["atm"].copy()), obs1)
    K = s["K"]
    path = tmp_path / "matrix.tab"
    write_matrix(path, ctl, K, port_atm(s["atm"].copy()), obs1, "y", "x",
                 "r")
    K2 = read_matrix(path, K.shape)
    nz = K != 0
    assert nz.any()
    np.testing.assert_allclose(K2[nz], K[nz], rtol=1e-4)


def test_packages_bitwise(setup, capsys):
    """RAYPACK 2 on the 4 rays: two packages whose stacked rows equal the
    one-package Jacobian bit for bit (every pass works ray by ray)."""
    s = setup
    ctl = dataclasses.replace(s["ctl_t"], raypack=2)
    model = ForwardModel(ctl, fast_tables=s["model"].fast_tables,
                         device="cpu")
    assert tret.autodiff_package_size(model, 4, 10) == 2
    K2 = tret.kernel_autodiff(ctl, port_atm(s["atm"].copy()),
                              port_obs(s["obs"].copy()), model)
    assert "# kernel_autodiff: 2 package(s) of up to 2 rays, n = 10" \
        in capsys.readouterr().out
    np.testing.assert_array_equal(K2, s["K"])


@pytest.mark.parametrize("nan_at", [
    [(0, 1), (1, 0), (1, 3), (2, 2), (3, 0), (3, 1)],   # in both packages
    [(0, d) for d in range(4)] + [(1, d) for d in range(4)] + [(3, 2)],
], ids=["both packages", "package 0 whole"])
def test_packages_bitwise_masked(setup, nan_at):
    """Masked radiances in the packages of RAYPACK 2: each package's rows
    land at their offset in K, so K is bit for bit the one-package K's
    finite rows (a row does not depend on the mask, which only selects
    rows: the unmasked one-package K of ``setup`` has every row) and the
    stack of the rows of each package's rays alone (what the packages
    gave before their rows were copied into K in place)."""
    from jurassic_torch.forward import _obs_rows

    s = setup
    obs = port_obs(s["obs"].copy())
    for ray, ch in nan_at:
        obs.rad[ray, ch] = np.nan
    finite = np.isfinite(obs.rad).ravel()
    ctl = dataclasses.replace(s["ctl_t"], raypack=2)
    model = ForwardModel(ctl, fast_tables=s["model"].fast_tables,
                         device="cpu")
    K = tret.kernel_autodiff(ctl, port_atm(s["atm"].copy()), obs, model)
    rows = [tret.kernel_autodiff(ctl, port_atm(s["atm"].copy()),
                                 _obs_rows(obs, r), model)
            for r in (slice(0, 2), slice(2, 4))]
    assert K.shape == (int(finite.sum()), 10) == (len(s["K"]) - len(nan_at),
                                                   10)
    assert K.dtype == np.float64 and K.flags.c_contiguous
    np.testing.assert_array_equal(K, s["K"][finite])
    np.testing.assert_array_equal(K, np.concatenate(rows))


def test_package_sizing_on_a_card(setup, monkeypatch):
    """RAYPACK = 0 on a card: one package in flight on the tangent
    kernels' path fits 90 % of the free memory read on every call; an
    explicit RAYPACK reads nothing; the CPU is one package.  Per ray the
    estimate is the LOS, its tangents [NLOS, 3 + 2 G + W, n] and tsurf's
    [n], and the K rows: drad [D, n] and its masked selection in the
    model's dtype, their float64 copy, rad and tau, and the mask; and
    the tracer tangent kernels' records and the RT tangent kernel's
    scratch as the library lays them out (``ops.trace_jvp.record_lengths``
    and ``ops.ega_jvp.scratch_lengths``, here stand-ins): a record per
    step and one per ray; a record per segment and channel and its
    segment index, the epilogue's values per channel and the first-record
    index."""
    from jurassic_torch.ops import ega_jvp, trace_jvp

    s = setup
    m = ForwardModel(dataclasses.replace(s["ctl_t"]),
                     fast_tables=s["model"].fast_tables, device="cpu")
    n, nr = 10, 1000
    S, G, W, D = m.ctl.nlos, m.ctl.ng, m.ctl.nw, m.ctl.nd
    asked = []
    monkeypatch.setattr(ega_jvp, "scratch_lengths",
                        lambda g, w: asked.append((g, w)) or (7 * g + 3, 4))
    monkeypatch.setattr(trace_jvp, "record_lengths", lambda: (84, 4))
    los = S * (6 + 2 * G + W) * 8 + S
    per_ray = tret.autodiff_ray_bytes(m, n)
    records = ((S * 84 + 4) * 8 + (S * (7 * G + 3) + 4) * D * 8 + S * 4
               + 8)
    assert per_ray == (los + (S * (3 + 2 * G + W) + 1) * n * 8 + records
                       + D * n * (2 * 8 + 8) + 2 * D * 8 + D)
    assert tret.autodiff_ray_bytes(m, 0) == los + records + 2 * D * 8 + D
    assert asked == [(G, W), (G, W)]
    assert tret.autodiff_package_size(m, nr, n) == 0       # the CPU
    m.device = torch.device("cuda", 0)
    card = _FakeCard(monkeypatch, 0)
    card.free = int((100 * per_ray + per_ray // 2) / 0.9) - (2 << 20) + 1
    assert tret.autodiff_package_size(m, nr, n) == 100
    card.free *= 20
    assert tret.autodiff_package_size(m, nr, n) == 0       # all fit
    assert card.reads == 2
    m.ctl.raypack = 300
    assert tret.autodiff_package_size(m, nr, n) == 250     # even split
    assert card.reads == 2


def test_fused_model_builds_eager_tables(setup):
    """A fused model builds the eager tables on first use, from the fast
    tables its kernels' tables were made from: its eager pass equals an
    eager model's on the same LOS bit for bit."""
    s = setup
    ctl = dataclasses.replace(s["ctl_t"], kernel="pallas")
    fused = ForwardModel(ctl, fast_tables=s["model"].fast_tables,
                         device="cpu")
    assert fused.kernel_mode == "fused" and fused._eager is None
    e = fused.eager_tables()
    assert e.use_fast and fused.eager_tables() is e
    los = s["model"].trace(port_atm(s["atm"].copy()), port_obs(s["obs"]))
    a, b = fused.integrate_eager(los), s["model"].integrate_eager(los)
    assert torch.equal(a.rad, b.rad) and torch.equal(a.tau, b.tau)

