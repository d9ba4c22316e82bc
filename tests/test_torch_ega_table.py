"""The plain PyTorch version of the table-mode fused EGA pass against the
JAX group kernel in table mode (Pallas interpret mode on the CPU, as
``tests/test_pallas_kernel.py`` runs it), and the hybrid taint map of the
plain turbo version against the JAX pool kernel's.

Same inputs on both sides: one JAX-traced float64 LOS per fixture, handed
to the port through NumPy, and the JAX-built tables carried across with
``table_tables_from_jax`` / ``turbo_tables_from_jax``.

Tolerances: table mode against the JAX kernel 1e-6 of max|rad| and 1e-6
on tau (the same float32 arithmetic on the same rows; XLA may contract
into FMAs and its exp2/log2 differ in the last bit); against the float64
``KERNEL = jax`` pipeline 1e-5 (the bar of
``tests/test_pallas_kernel.py:41-68``: float32 against float64).  The
taint maps are booleans and must be equal.
"""
import numpy as np
import pytest
import torch

from jurassic_tpu.forward import ForwardModel as JaxForwardModel
from jurassic_tpu.ops.pallas import rt_fused_pallas
from jurassic_torch.geometry import los_from_numpy
from jurassic_torch.ops import ega_fused as tef
from jurassic_torch.ops.continua import precompute_continua
from jurassic_torch.ops.table_pack import table_tables_from_jax
from jurassic_torch.ops.turbo_fit import pack_rows, turbo_tables_from_jax

from test_torch_cli import _roughen
from test_torch_host_copies import small_limb_pair

AX = ("eps_aug", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")


def _np(pt):
    return (np.asarray(getattr(pt, f)) for f in AX)


@pytest.fixture(scope="module")
def setup():
    """ng=4, nd=9, nlos=48, 6 limb rays, all four continua on; the JAX
    model in table mode, its float64 LOS, and the port's inputs."""
    (ctl, ft, atm, obs), (ctl_t, _ft, _a, _o) = small_limb_pair(
        ng=4, nd=9, nr=6)
    ctl.kernel = "pallas"
    m = JaxForwardModel(ctl, fast_tables=ft)
    assert m.kernel_mode == "pallas" and m.pallas_tbl.mode == "table"
    los = m.trace(atm, obs)
    pt = m.pallas_tbl
    tt = table_tables_from_jax(*_np(pt), k_rows=pt.k_rows, d_true=pt.d_true)
    cc = tef.pack_continua(precompute_continua(ctl_t),
                           np.asarray(ctl_t.window), ctl_t.nd, ctl_t.nw)
    ctl.kernel = "jax"
    out64 = JaxForwardModel(ctl, fast_tables=ft).integrate(los)
    return m, los, los_from_numpy(los), tt, cc, out64


@pytest.mark.parametrize("flags", [(True, True, True, True),
                                   (False, False, False, False),
                                   (True, False, False, True)])
def test_plain_table_version_matches_group_kernel(setup, flags):
    m, los, lt, tt, cc, _ = setup
    rad_j, tau_j = rt_fused_pallas(m.pallas_tbl, m.cc_rows, los, flags,
                                   m.ig_co2, m.ig_h2o, interpret=True,
                                   variant="group")
    rad_j, tau_j = np.asarray(rad_j), np.asarray(tau_j)
    rad, tau = tef.rt_fused_table_ref(tt, cc, lt, flags, m.ig_co2, m.ig_h2o)
    assert rad.dtype == torch.float32 and rad.shape == rad_j.shape
    scale = np.abs(rad_j).max()
    assert scale > 0
    assert np.abs(rad.numpy() - rad_j).max() <= 1e-6 * scale
    assert np.abs(tau.numpy() - tau_j).max() <= 1e-6


def test_plain_table_version_matches_f64_pipeline(setup):
    m, _los, lt, tt, cc, out64 = setup
    rad, tau = tef.rt_fused_table_ref(tt, cc, lt, m.flags, m.ig_co2,
                                      m.ig_h2o)
    rad0 = np.asarray(out64.rad)
    assert np.abs(rad.numpy() - rad0).max() <= 1e-5 * np.abs(rad0).max()
    assert np.abs(tau.numpy() - np.asarray(out64.tau)).max() <= 1e-5


def test_ray_chunking_changes_nothing(setup, monkeypatch):
    """The plain version walks the rays in chunks sized by
    REF_BLOCK_BYTES; one ray per chunk gives the same bits."""
    m, _los, lt, tt, cc, _ = setup
    args = (tt, cc, lt, m.flags, m.ig_co2, m.ig_h2o)
    rad0, tau0 = tef.rt_fused_table_ref(*args)
    monkeypatch.setattr(tef, "REF_BLOCK_BYTES", 1)
    rad1, tau1 = tef.rt_fused_table_ref(*args)
    assert torch.equal(rad0, rad1) and torch.equal(tau0, tau1)


def test_scan_form_handles_non_monotone_rows(setup):
    """The literal count/max/min form is defined on any row: a bump
    changes the answer only where the bump is read, and stays finite."""
    m, _los, lt, tt, cc, _ = setup
    aug = tt.rows().clone()
    aug[0, :, 5, :] = aug[0, :, 7, :] + 0.01
    rad, tau = tef.rt_fused_table_ref(
        tt._replace(eps_aug=pack_rows(aug)), cc, lt, m.flags, m.ig_co2,
        m.ig_h2o)
    assert torch.isfinite(rad).all() and torch.isfinite(tau).all()
    assert (tau >= 0).all() and (tau <= 1).all()


def test_wrapper_takes_plain_version_on_cpu(setup):
    m, _los, lt, tt, cc, _ = setup
    n0 = tef.LAUNCHES_TABLE
    args = (tt, cc, lt, m.flags, m.ig_co2, m.ig_h2o)
    rad0, tau0 = tef.rt_fused_table(*args)
    rad1, tau1 = tef.rt_fused_table_ref(*args)
    assert tef.LAUNCHES_TABLE == n0
    assert torch.equal(rad0, rad1) and torch.equal(tau0, tau1)


def test_taint_map_matches_pool_kernel():
    """The roughened tables of test_turbo_hybrid_per_row_fallback
    (tests/test_pallas_kernel.py:377-389): three bad-fit rows; the plain
    turbo version marks exactly the lanes the JAX pool kernel marks, and
    agrees with it on rad/tau at the turbo bar (5e-5)."""
    (ctl, ft, atm, obs), (ctl_t, _f, _a, _o) = small_limb_pair(
        ng=3, nd=5, nr=11, n_k=40)
    ctl.ctm_n2 = ctl.ctm_o2 = ctl_t.ctm_n2 = ctl_t.ctm_o2 = 0
    ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
    ctl.kernel = "turbo"
    m = JaxForwardModel(ctl, fast_tables=ft)
    pt = m.pallas_tbl
    assert pt.mode == "turbo" and pt.n_bad == 3
    los = m.trace(atm, obs)
    rad_j, tau_j, ok, taint_j = rt_fused_pallas(
        pt, m.cc_rows, los, m.flags, m.ig_co2, m.ig_h2o, interpret=True,
        variant="pool!")
    assert bool(np.asarray(ok).all())
    taint_j = np.asarray(taint_j) > 0.5
    tt = turbo_tables_from_jax(*_np(pt), d_true=pt.d_true, deg_f=pt.deg_f,
                               deg_i=pt.deg_i, n_bad=pt.n_bad)
    cc = tef.pack_continua(precompute_continua(ctl_t),
                           np.asarray(ctl_t.window), ctl_t.nd, ctl_t.nw)
    rad, tau, taint = tef.rt_fused_turbo_ref(
        tt, cc, los_from_numpy(los), m.flags, m.ig_co2, m.ig_h2o)
    assert taint.dtype == torch.bool and taint.shape == taint_j.shape
    assert 0 < taint_j.sum() < taint_j.size
    np.testing.assert_array_equal(taint.numpy(), taint_j)
    # only channel 2 reads the roughened rows
    assert not taint.numpy()[:, [0, 1, 3, 4]].any()
    scale = np.abs(np.asarray(rad_j)).max()
    assert np.abs(rad.numpy() - np.asarray(rad_j)).max() <= 5e-5 * scale
    assert np.abs(tau.numpy() - np.asarray(tau_j)).max() <= 5e-5
    # no bad rows, no taint output
    assert tef.rt_fused_turbo_ref(
        tt._replace(n_bad=0), cc, los_from_numpy(los), m.flags, m.ig_co2,
        m.ig_h2o)[2] is None
