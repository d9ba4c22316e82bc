"""The branches of the tracer the CUDA kernel reproduces, held in its
plain version ``geometry.trace_rays_ref`` (float64, on the CPU) to the
JAX package's ``trace_rays`` on the same inputs.

``tests/test_torch_geometry.py`` covers the limb, nadir and ega goldens
and a synthetic scan.  Here a small synthetic limb scan (16 rays, NLOS
64) is set up in each branch the goldens do not all reach
(``workloads.trace_branch``): REFRAC 0, RAYDZ 0, an observer inside the
atmosphere (no entry bisection), rays that are never traced, and
one-level windows (times past the atmosphere's last).  The tolerances
are those of ``tests/test_torch_geometry.py``: identical ``np_`` and
``valid``, and 1e-9 relative per element with its absolute floors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jurassic_tpu import geometry as jg
from jurassic_torch import geometry as tg
from jurassic_torch.workloads import TRACE_BRANCHES, trace_branch

from test_torch_host_copies import one_thread  # noqa: F401 (autouse)
from test_torch_host_copies import small_limb_pair

GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")
ANGLES = ("lon", "lat", "tplon", "tplat")


@pytest.mark.parametrize("branch", TRACE_BRANCHES)
def test_trace_branch_matches_jax(branch):
    (ctl, _f, atm, obs), (ctl_t, _ft, atm_t, obs_t) = small_limb_pair(
        ng=4, nd=9, nr=16, nlos=64)
    trace_branch(branch, ctl, atm, obs)
    trace_branch(branch, ctl_t, atm_t, obs_t)
    prof = jg.build_ray_profiles(ctl, atm, obs, jnp.float64)
    los_j = jg.trace_rays(ctl, prof,
                          {k: jnp.asarray(getattr(obs, k)) for k in GEO},
                          jnp.float64)
    prof_t = tg.build_ray_profiles(ctl_t, atm_t, obs_t, torch.float64)
    assert prof_t.short == (branch == "one_level")
    los_t = tg.trace_rays_ref(ctl_t, prof_t,
                              {k: getattr(obs_t, k) for k in GEO})
    np.testing.assert_array_equal(los_t.np_.numpy(), np.asarray(los_j.np_))
    np.testing.assert_array_equal(los_t.valid.numpy(),
                                  np.asarray(los_j.valid))
    for f in tg.LosData._fields:
        if f in ("np_", "valid"):
            continue
        ref = np.asarray(getattr(los_j, f))
        got = getattr(los_t, f).numpy()
        assert got.shape == ref.shape, f
        floor = 1e-9 * np.abs(ref).max()
        if f in ANGLES:
            floor = max(floor, 1e-12 * 180.0)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=floor,
                                   err_msg=f)
    # the branch is really taken
    np_ = los_t.np_.numpy()
    if branch == "never_traced":
        assert (np_[1::2] == 0).all() and (np_[0::2] > 0).all()
        np.testing.assert_array_equal(los_t.tpz.numpy()[1::2],
                                      obs_t.vpz[1::2])
    elif branch == "one_level":
        assert (prof_t.nlev.numpy()[1::2] == 1).all()
    elif branch == "observer_inside":
        assert (obs_t.obsz <= prof_t.zmax.numpy()).all()
