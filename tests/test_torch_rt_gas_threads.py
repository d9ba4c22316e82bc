"""The fast RT kernel's plain version against the JAX package at the shapes
its thread-per-gas layout walks into, in float64 on the CPU.

``csrc/ega_rt.cu``'s fast kernel runs a thread per (ray, channel, gas):
one gas (a warp's channels of one gas), seven (a gas's channels end
mid-warp) and thirty (a lane's gas threads span warps), on tables whose
(p, T) axes differ between channels (``workloads.perturbed_axes``, the
per-channel brackets the kernel computes ahead of the chain).  Its plain
version is the eager loop ``forward.rt_integrate`` under ``KERNEL =
fast``, which the card holds the kernel to bit for bit; here that loop is
held to JAX's ``ForwardModel.integrate`` under ``KERNEL = jax`` on the LOS
the JAX package traced, rad and tau within 1e-12 of their largest value
(the same float64 arithmetic in another operation order, as in
``tests/test_torch_ega_eager.py``).
"""
import jax
import numpy as np
import pytest
import torch

from jurassic_tpu import forward as jf
from jurassic_torch import forward as tf
from jurassic_torch.geometry import los_from_numpy
from jurassic_torch.workloads import perturbed_axes

from test_torch_host_copies import port_fast_tables, small_limb_pair
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

RTOL = 1e-12


@pytest.mark.parametrize("ng, nd", [(1, 5), (7, 33), (30, 3)])
def test_fast_rt_per_channel_axes_matches_jax(ng, nd):
    (ctl_j, ft_j, atm_j, obs_j), (ctl, _ft, _a, _o) = small_limb_pair(
        ng=ng, nd=nd, nr=3, nlos=32)
    ft_j = perturbed_axes(ft_j._replace(
        p=np.asarray(ft_j.p), t=np.asarray(ft_j.t)), seed=1)
    ctl_j.kernel, ctl.kernel = "jax", "fast"
    m_j = jf.ForwardModel(ctl_j, fast_tables=ft_j)
    fm = tf.ForwardModel(ctl, fast_tables=port_fast_tables(ft_j),
                         device="cpu")
    assert fm.kernel_mode == "fast"
    assert not fm.eager_tables().tbl.uniform      # per-channel brackets
    los = m_j.trace(atm_j, obs_j)
    ref = m_j.integrate(los)
    out = fm.integrate(los_from_numpy(jax.tree.map(np.asarray, los)))
    assert fm.last_variant == "fast"
    assert out.rad.dtype == torch.float64
    assert tuple(out.rad.shape) == (obs_j.nr, nd)
    for name in ("rad", "tau"):
        r = np.asarray(getattr(ref, name))
        g = getattr(out, name).numpy()
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * np.abs(r).max(),
                                   err_msg=name)
