"""The plain PyTorch version of the fused turbo EGA pass against the JAX
pool kernel (Pallas interpret mode on the CPU, as
``tests/test_pallas_kernel.py`` runs it), on the same JAX-traced LOS and
the same turbo tables.

Tolerance: rad to 5e-5 of max|rad|, tau to 5e-5 absolute -- the turbo
bar of ``tests/test_pallas_kernel.py:138-140``.  Both sides compute in
float32, but in another operation order (XLA may contract into FMAs)
and with other exp/log/pow/tanh implementations.  The packing helpers
(continuum rows, segment stream, corner bracketing) are exact and must
match bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jurassic_tpu.forward import ForwardModel as JaxForwardModel
from jurassic_tpu.ops.pallas import rt_fused_pallas
from jurassic_tpu.ops.pallas import ega_fused as jef
from jurassic_torch.geometry import los_from_numpy
from jurassic_torch.ops import ega_fused as tef
from jurassic_torch.ops.continua import precompute_continua
from jurassic_torch.ops.turbo_fit import turbo_tables_from_jax

from test_torch_host_copies import small_limb_pair


@pytest.fixture(scope="module")
def setup():
    """ng=4, nd=9, nlos=48, 6 limb rays, all four continua on."""
    (ctl, ft, atm, obs), (ctl_t, _ft, _a, _o) = small_limb_pair(
        ng=4, nd=9, nr=6)
    ctl.kernel = "turbo"
    m = JaxForwardModel(ctl, fast_tables=ft)
    assert m.pallas_tbl.mode == "turbo"
    los = m.trace(atm, obs)
    pt = m.pallas_tbl
    tt = turbo_tables_from_jax(
        *(np.asarray(getattr(pt, f)) for f in
          ("eps_aug", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")),
        d_true=pt.d_true, deg_f=pt.deg_f, deg_i=pt.deg_i, n_bad=pt.n_bad)
    cc = tef.pack_continua(precompute_continua(ctl_t),
                           np.asarray(ctl_t.window), ctl_t.nd, ctl_t.nw)
    return ctl_t, m, los, los_from_numpy(los), tt, cc


def test_pack_continua_matches_jax(setup):
    ctl, m, _los, _lt, _tt, cc = setup
    assert cc.dtype == torch.float32
    np.testing.assert_array_equal(cc.numpy(),
                                  np.asarray(m.cc_rows)[:, :ctl.nd])


def test_pack_segments_matches_jax(setup):
    _ctl, m, los, lt, _tt, _cc = setup
    ref = np.asarray(jef._pack_segments(los, m.ig_co2, m.ig_h2o))
    got = tef.pack_segments(lt, m.ig_co2, m.ig_h2o)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_corner_indices_match_jax(setup):
    """Bracketing in the LOS dtype (float64 here)."""
    _ctl, m, los, lt, tt, _cc = setup
    pt = m.pallas_tbl
    ref = np.asarray(jef._corner_indices(
        jnp.asarray(pt.p_ax, los.p.dtype), jnp.asarray(pt.t_ax, los.p.dtype),
        jnp.asarray(pt.np_u), jnp.asarray(pt.nt_u), los.p, los.t))
    got = tef.corner_indices(tt.p_ax, tt.t_ax, tt.np_u, tt.nt_u, lt.p, lt.t)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("flags", [(True, True, True, True),
                                   (False, False, False, False),
                                   (True, False, False, True)])
def test_plain_version_matches_pool_kernel(setup, flags):
    _ctl, m, los, lt, tt, cc = setup
    rad_j, tau_j = rt_fused_pallas(m.pallas_tbl, m.cc_rows, los, flags,
                                   m.ig_co2, m.ig_h2o, interpret=True,
                                   variant="pool")
    rad_j, tau_j = np.asarray(rad_j), np.asarray(tau_j)
    rad, tau, taint = tef.rt_fused_turbo_ref(tt, cc, lt, flags, m.ig_co2,
                                             m.ig_h2o)
    assert taint is None            # no bad-fit rows in these tables
    assert rad.dtype == torch.float32 and rad.shape == rad_j.shape
    scale = np.abs(rad_j).max()
    assert scale > 0
    assert np.abs(rad.numpy() - rad_j).max() <= 5e-5 * scale
    assert np.abs(tau.numpy() - tau_j).max() <= 5e-5


def test_wrapper_takes_plain_version_on_cpu(setup):
    """CPU tensors go through the plain version and launch nothing."""
    _ctl, m, _los, lt, tt, cc = setup
    n0 = tef.LAUNCHES
    args = (tt, cc, lt, m.flags, m.ig_co2, m.ig_h2o)
    rad0, tau0, _ = tef.rt_fused_turbo(*args)
    rad1, tau1, _ = tef.rt_fused_turbo_ref(*args)
    assert tef.LAUNCHES == n0
    assert torch.equal(rad0, rad1) and torch.equal(tau0, tau1)
