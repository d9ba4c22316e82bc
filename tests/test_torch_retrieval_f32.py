"""The port's float32 autodiff Jacobian on a saturated limb path, on the
CPU.

The flagship's lowest ray (tangent point 3 km) saturates several
channels: the eager fast lookup's curve-of-growth inversion puts u_c on
a table node, the segment is too thin to move it, and in float32 the
forward lookup's log2 index can round down into the interval below.
Both intervals give the same eps to rounding but different slopes, so
without the ``ki >= lo`` clamp of ``ops/ega.ega_eps_fast`` the tangent
grows by the slope ratio step after step and overflows to Inf/NaN in 8
channels of this ray.  The float64 autodiff is the reference; the
primal of the clamped lookup is held to JAX's at 1e-12 in
``tests/test_torch_ega_eager.py``.
"""
import numpy as np
import torch

from jurassic_torch.forward import ForwardModel, _obs_rows
from jurassic_torch.retrieval import kernel_autodiff
from jurassic_torch.workloads import flagship
from test_torch_host_copies import one_thread  # noqa: F401


def test_float32_autodiff_finite_on_saturated_ray():
    ctl, ft, atm, obs = flagship()
    ctl.kernel, ctl.hydz = "jax", 20.0
    ctl.rett_zmin = ctl.rett_zmax = 10.0          # T at 10 km: n = 1
    obs = _obs_rows(obs, np.array([0]))
    Ks = {}
    for dtype in (torch.float32, torch.float64):
        model = ForwardModel(ctl, fast_tables=ft, device="cpu", dtype=dtype)
        Ks[dtype] = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    K32, K64 = Ks[torch.float32], Ks[torch.float64]
    assert K32.shape == K64.shape == (ctl.nd, 1)
    assert np.isfinite(K32).all()
    scale = np.abs(K64).max()
    assert scale > 0
    # the float32 derivative of a thin segment is good to percents
    # (chip_smoke.py's AD_F32_TOL holds T to 0.1 of its max|K|)
    assert np.abs(K32 - K64).max() <= 0.1 * scale
