"""The Jacobian of a ``KERNEL = exact`` model against JAX's, float64 on
the CPU: ``retrieval.kernel_autodiff`` on an exact model takes the tangent
chain (here the plain statements: ``geometry.trace_rays_jvp_ref`` and
``forward.rt_integrate_jvp_ref`` on the exact tables) and is held to
JAX's ``kernel_autodiff`` on the same exact model (its compiled
``jax.jacfwd`` through ``ega_eps_exact``) within 1e-8 of max|K|: the
small limb scan over two profiles of ``tests/test_torch_jacobian_
chain.py``, HYDZ 20.  ``tests/test_torch_exact_rt.py`` holds the RT
pass's plain tangent statements on exact tables to ``torch.func.jvp``.
"""
import dataclasses

import numpy as np

import jurassic_torch.retrieval as tret
from jurassic_torch.forward import ForwardModel
from jurassic_torch.tables import EgaTables
from jurassic_tpu.forward import ForwardModel as JaxModel
from jurassic_tpu.models.synthetic import \
    fast_to_ega_tables as jax_fast_to_ega_tables
from jurassic_tpu.retrieval import kernel_autodiff as jax_kernel_autodiff
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)
from test_torch_host_copies import port_atm, port_obs
from test_torch_jacobian_chain import _case


def test_exact_chain_matches_jax(capsys):
    ctl, ft, atm, obs, ctl_t, _ = _case(20.0)
    ctl.kernel = "exact"
    ctl_t = dataclasses.replace(ctl_t, kernel="exact")
    jtb = jax_fast_to_ega_tables(ft)
    model = ForwardModel(ctl_t, EgaTables(*(np.asarray(a) for a in jtb)),
                         device="cpu")
    assert model.kernel_mode == "exact" and not model.eager_tables().use_fast
    K = tret.kernel_autodiff(ctl_t, port_atm(atm.copy()),
                             port_obs(obs.copy()), model)
    assert "; plain tangent chain" in capsys.readouterr().out
    K_j = np.asarray(jax_kernel_autodiff(ctl, atm.copy(), obs.copy(),
                                         JaxModel(ctl, jtb)))
    assert K.shape == K_j.shape == (obs.nr * ctl.nd, 10)
    scale = np.abs(K_j).max()
    assert scale > 0 and np.isfinite(K).all()
    np.testing.assert_allclose(K, K_j, rtol=0, atol=1e-8 * scale)
