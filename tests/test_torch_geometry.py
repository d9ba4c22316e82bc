"""The port's ray tracer and hydrostatics against the JAX package's, in
float64 on the CPU.

Tolerances: the discrete outputs (``np_``, ``valid``) must be identical.
The continuous LosData fields agree to 1e-9 relative per element, with
an absolute floor: 1e-9 of the field's largest magnitude, and for angles
at least 1e-12 of 180 degrees.  The floor is for entries whose own value
sits at a cancellation: altitudes of the ground-clipped point (|x| - RE,
~1e-7 km from zero, where one ulp of RE is 1e-12 km), the
escape-shortened segment (ds * frac, frac a difference quotient of
nearly equal altitudes), and longitudes of the meridian-plane limb scans,
which are 0 in exact arithmetic and come out as accumulated roundoff
(|lon| < 4e-7 deg).  XLA's and PyTorch's float64 sin/asin/atan2/sqrt
differ in the last bit on a fraction of inputs (measured), and those
last bits accumulate over the 400 steps.  The hydrostatic pressures are
NumPy on both sides: 1e-12 relative.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jurassic_tpu.config as jcfg
import jurassic_tpu.io_tab as jio
from jurassic_tpu import geometry as jg
from jurassic_torch import geometry as tg

from test_torch_host_copies import golden_case, small_limb_pair

GOLD = Path(__file__).parent / "goldens"
GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")
ANGLES = ("lon", "lat", "tplon", "tplat")


def _case(case):
    """((ctl, atm, obs) of the JAX package, the same of the port): each
    side gets its own classes, read by its own readers or carried across
    as NumPy copies."""
    if case == "synthetic":
        (cj, _f, aj, oj), (ct, _ft, at, ot) = small_limb_pair(ng=4, nd=9,
                                                              nr=6)
        cj.hydz = ct.hydz = 0.0   # exercise the hydrostatic rebuild too
        return (cj, aj, oj), (ct, at, ot)
    cj, oj, aj = golden_case(case, jcfg, jio)
    ct, ot, at = golden_case(case)
    return (cj, aj, oj), (ct, at, ot)


def _traced(case):
    (ctl, a_j, obs), (ctl_t, a_t, obs_t) = _case(case)
    jg.hydrostatic_atm(ctl, a_j)
    tg.hydrostatic_atm(ctl_t, a_t)
    prof = jg.build_ray_profiles(ctl, a_j, obs, jnp.float64)
    los_j = jg.trace_rays(ctl, prof,
                          {k: jnp.asarray(getattr(obs, k)) for k in GEO},
                          jnp.float64)
    prof_t = tg.build_ray_profiles(ctl_t, a_t, obs_t, torch.float64)
    los_t = tg.trace_rays(ctl_t, prof_t,
                          {k: getattr(obs_t, k) for k in GEO})
    return a_j, a_t, los_j, los_t


@pytest.mark.parametrize("case", ["limb", "nadir", "ega", "synthetic"])
def test_trace_matches_jax(case):
    a_j, a_t, los_j, los_t = _traced(case)
    np.testing.assert_allclose(a_t.p, a_j.p, rtol=1e-12, atol=0)
    assert los_t.np_.dtype == torch.int32
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


def test_los_from_numpy_roundtrip():
    """A LOS traced by JAX reaches the port unchanged."""
    _a_j, _a_t, los_j, _los_t = _traced("ega")
    los = tg.los_from_numpy(los_j)
    for f in tg.LosData._fields:
        ref = np.asarray(getattr(los_j, f))
        got = getattr(los, f).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f)
    assert los.valid.dtype == torch.bool and los.np_.dtype == torch.int32
    assert los.p.dtype == torch.float64
