"""The port's FD Jacobian against its autodiff Jacobian on a multi-profile
atmosphere, and through the fused turbo model (the seam), float64 on the
CPU at JAX's bars (``atol 2e-2`` of max|K|, ``rtol 0.05``).

* Twin of ``tests/test_retrieval.py:136-185``: two scans with their own
  (lon, lat) profiles and times; the state scatters into the right
  profile, per-ray profiles are gathered by scan time, and the
  cross-profile blocks of K are exactly zero.
* Twin of ``tests/test_retrieval.py:78-106``: ``kernel_autodiff``
  differentiates the eager pipeline even for a model whose forward runs
  the fused turbo pass (on the CPU its plain version), so an FD Jacobian
  through that model mixes paths; the two agree at the FD truncation
  plus turbo-chord tolerance.
"""
import numpy as np

from jurassic_torch.forward import ForwardModel
from jurassic_torch.io_tab import Atm
from jurassic_torch.models.synthetic import (limb_workload, synthetic_atm,
                                             synthetic_ctl,
                                             synthetic_fast_tables)
from jurassic_torch.retrieval import atm2x, kernel, kernel_autodiff
from test_torch_host_copies import one_thread  # noqa: F401


def test_fd_vs_autodiff_multi_profile():
    ctl = synthetic_ctl(ng=2, nd=3)
    ctl.nlos = 96
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.hydz = 20.0
    ctl.kernel = "jax"
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 40.0
    ctl.retq_zmin = [-999.0, 10.0]
    ctl.retq_zmax = [-999.0, 40.0]
    a0 = synthetic_atm(ctl, dz=5.0)
    a1 = synthetic_atm(ctl, dz=5.0)
    a1.t = a1.t + 6.0                    # the second scan sees warmer air
    a1.q[1] = a1.q[1] * 1.4
    atm = Atm(
        time=np.concatenate([a0.time, a1.time + 3600.0]),
        z=np.concatenate([a0.z, a1.z]),
        lon=np.concatenate([a0.lon, np.full(a1.npts, 10.0)]),
        lat=np.concatenate([a0.lat, np.full(a1.npts, 5.0)]),
        p=np.concatenate([a0.p, a1.p]),
        t=np.concatenate([a0.t, a1.t]),
        q=np.concatenate([a0.q, a1.q], axis=1),
        k=np.concatenate([a0.k, a1.k], axis=1))
    obs = limb_workload(ctl, 6)
    obs.time[3:] = 3600.0                # rays 3.. view the second scan
    model = ForwardModel(ctl, fast_tables=synthetic_fast_tables(
        ctl, n_p=12, n_t=8, n_k=96), device="cpu")
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    x, iqa, ipa = atm2x(ctl, atm)
    assert (ipa < a0.npts).any() and (ipa >= a0.npts).any()
    assert K_fd.shape == K_ad.shape == (obs.nr * ctl.nd, x.size)
    scale = np.abs(K_ad).max()
    assert scale > 0
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)
    # ray 0 (scan 1) does not react to scan-2 state, ray 5 not to scan 1
    nd = ctl.nd
    scan2_cols = ipa >= a0.npts
    assert np.abs(K_ad[0:nd][:, scan2_cols]).max() == 0.0
    assert np.abs(K_ad[5 * nd:6 * nd][:, ~scan2_cols]).max() == 0.0
    assert np.abs(K_ad[0:nd][:, ~scan2_cols]).max() > 0.0


def test_autodiff_vs_fd_through_turbo():
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 48
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 20.0     # 3 temperature levels
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, 4)
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=40)
    ctl.kernel = "turbo"
    model = ForwardModel(ctl, fast_tables=ft, device="cpu")
    assert model.kernel_mode == "fused" and model.turbo_tbl is not None
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)     # turbo forward
    assert model.last_variant == "turbo"
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)  # eager
    assert model.eager_tables().use_fast
    assert K_fd.shape == K_ad.shape == (obs.nr * ctl.nd, 3)
    scale = np.abs(K_ad).max()
    assert scale > 0
    # turbo forward deviates from the eager pass by ~1e-5 relative (fit
    # floor); across the 1 K FD step that adds ~1e-3 of the Jacobian
    # scale on top of the 1% FD truncation budget
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)
