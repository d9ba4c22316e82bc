"""The port's FD Jacobian against its autodiff Jacobian with the
hydrostatic rebuild in the graph and a 108-element state: the twin of
``tests/test_retrieval.py:109-133``, at JAX's bars (``atol 2e-2`` of
max|K|, ``rtol 0.05``), float64 on the CPU.

The FD kernel re-runs ``hydrostatic_atm`` in each of its 109 formods;
the autodiff differentiates ``hydrostatic_profile_torch`` inside the
graph, so pressure derivatives must agree through the rebuild.
``tests/test_torch_retrieval.py`` ties the autodiff to JAX's.  The port's
twin of JAX's ``KERNEL = auto`` model on the CPU (which runs its jnp
pipeline) is its eager ``KERNEL = jax`` model.
"""
import numpy as np

from jurassic_torch.forward import ForwardModel
from jurassic_torch.models.synthetic import (limb_workload, synthetic_atm,
                                             synthetic_ctl,
                                             synthetic_fast_tables)
from jurassic_torch.retrieval import kernel, kernel_autodiff
from test_torch_host_copies import one_thread  # noqa: F401


def test_fd_vs_autodiff_hydrostatic_large_state():
    ctl = synthetic_ctl(ng=2, nd=3)
    ctl.nlos = 96
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.hydz = 20.0
    ctl.kernel = "jax"
    # T + both gas vmr at the 36 levels of 0-70 km -> 108 elements
    ctl.rett_zmin, ctl.rett_zmax = 0.0, 70.0
    ctl.retq_zmin = [0.0, 0.0]
    ctl.retq_zmax = [70.0, 70.0]
    atm = synthetic_atm(ctl)
    obs = limb_workload(ctl, 3)
    model = ForwardModel(ctl, fast_tables=synthetic_fast_tables(
        ctl, n_p=12, n_t=8, n_k=96), device="cpu")
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    assert K_fd.shape == K_ad.shape == (obs.nr * ctl.nd, 108)
    scale = np.abs(K_ad).max()
    assert scale > 0
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)
