"""Tangent points of the port's float32 tracer (the CUDA dtype) against
the JAX package's float32 tracer and the C oracle, on the CPU.

In float32 the parabola fit of the tangent point (``geometry.py``
``tangent_point``, shared formula) divides by zero on a few ``nadir``
rays: a step lands exactly on z = 0, the ground clip adds a second
point there with ds = 0, so the lowest point is not the last one (the
limb branch is taken) and x1 == x2.  Those rays get NaN tangent points.  JAX's float32 tracer shows the same fault on the
same rays and on a few more (last-bit differences of the two float32
tracers decide which rays hit it), so the port may have non-finite
tangent points only on rays where JAX has them too.

Every finite tangent point agrees with JAX's and with the oracle's
``rad.tab`` (columns 7-9) within ``TP_TOL``: 1e-2 km in altitude and
1e-2 degrees in longitude and latitude.  Measured here: at most 6.8e-3
km and 4.1e-3 degrees for either tracer against the oracle.  One ulp of
the Earth radius in float32 is 0.5 m, and it accumulates over the steps.
``chip_smoke.py`` holds the port on the card to the same bounds.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jurassic_tpu import geometry as jg
from jurassic_tpu.config import read_ctl
from jurassic_tpu.io_tab import read_atm, read_obs
from jurassic_torch import geometry as tg

GOLD = Path(__file__).parent / "goldens"
GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")
TP = ("tpz", "tplon", "tplat")
TP_TOL = 1e-2
# rays with non-finite tangent points that JAX's float32 tracer gives
# on each golden; chip_smoke.py allows the port no more than these
MAX_NONFINITE = {"limb": 0, "nadir": 8, "ega": 0}


def _tangent_points(case):
    d = GOLD / case
    ctl = read_ctl(["formod", str(next(d.glob("*.ctl"))), "o", "a", "r"],
                   verbose=False)
    atm, obs = read_atm(d / "atm.tab", ctl), read_obs(d / "obs.tab", ctl)
    a_j, a_t = atm.copy(), atm.copy()
    jg.hydrostatic_atm(ctl, a_j)
    tg.hydrostatic_atm(ctl, a_t)
    prof = jg.build_ray_profiles(ctl, a_j, obs, jnp.float32)
    los_j = jg.trace_rays(
        ctl, prof, {k: jnp.asarray(getattr(obs, k), jnp.float32)
                    for k in GEO}, jnp.float32)
    prof_t = tg.build_ray_profiles(ctl, a_t, obs, torch.float32)
    los_t = tg.trace_rays(ctl, prof_t, {k: getattr(obs, k) for k in GEO})
    tp_j = np.stack([np.asarray(getattr(los_j, f)) for f in TP], axis=1)
    tp_t = np.stack([getattr(los_t, f).numpy() for f in TP], axis=1)
    assert tp_j.dtype == tp_t.dtype == np.float32
    return tp_j, tp_t, np.loadtxt(d / "rad.tab")[:, 7:10]


@pytest.mark.parametrize("case", ["limb", "nadir", "ega"])
def test_float32_tangent_points(case):
    tp_j, tp_t, tp_ref = _tangent_points(case)
    bad_j = ~np.isfinite(tp_j).all(axis=1)
    bad_t = ~np.isfinite(tp_t).all(axis=1)
    assert bad_j.sum() == MAX_NONFINITE[case]
    assert not (bad_t & ~bad_j).any(), np.flatnonzero(bad_t & ~bad_j)
    assert np.isfinite(tp_ref).all()
    both = ~bad_j & ~bad_t
    np.testing.assert_allclose(tp_t[both], tp_j[both], rtol=0, atol=TP_TOL)
    np.testing.assert_allclose(tp_t[~bad_t], tp_ref[~bad_t], rtol=0,
                               atol=TP_TOL)
