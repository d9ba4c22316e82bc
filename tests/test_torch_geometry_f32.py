"""Tangent points of the port's float32 tracer (the CUDA dtype) against
the JAX package's float32 tracer and the C oracle, on the CPU.

In float32 the parabola fit of the tangent point divides by zero on a few
``nadir`` rays: a step lands exactly on z = 0, the ground clip adds a
second point there with ds = 0, so the lowest point is not the last one
(the limb branch is taken) and x1 == x2.  JAX's float32 tracer
(``geometry.py:439-451``) gives those rays NaN tangent points (8 on
``nadir``).  The port guards the fit (``geometry.tangent_point``, a
listed deviation): such a ray takes its last point, as the C oracle's
double-precision tracer does, so no port ray has a NaN tangent point.

Every port tangent point agrees with the oracle's ``rad.tab`` (columns
7-9) within ``TP_TOL``: 1e-2 km in altitude and 1e-2 degrees in
longitude and latitude, and with JAX's wherever JAX's is finite.
Measured here: at most 6.0e-3 km and 3.4e-3 degrees against the oracle,
4.9e-4 km on the guarded ``nadir`` rays.  One ulp of the Earth radius in
float32 is 0.5 m, and it accumulates over the steps.  ``chip_smoke.py``
holds the port on the card to the same bounds.

The guard touches the tangent points only: every other field of the
float32 ``nadir`` LOS is bit for bit that of a trace whose tangent points
are all NaN, so radiances and transmittances cannot move.
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

from test_torch_host_copies import golden_case

GOLD = Path(__file__).parent / "goldens"
GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")
TP = ("tpz", "tplon", "tplat")
TP_TOL = 1e-2
# rays with non-finite tangent points that JAX's float32 tracer gives
# on each golden (the port guards them)
MAX_NONFINITE_JAX = {"limb": 0, "nadir": 8, "ega": 0}


def _port_trace(case):
    """The port's float32 LOS of a golden."""
    ctl_t, obs_t, a_t = golden_case(case)
    tg.hydrostatic_atm(ctl_t, a_t)
    prof_t = tg.build_ray_profiles(ctl_t, a_t, obs_t, torch.float32)
    return tg.trace_rays(ctl_t, prof_t, {k: getattr(obs_t, k) for k in GEO})


_PORT_LOS = {}


def _tangent_points(case):
    d = GOLD / case
    ctl, obs, a_j = golden_case(case, jcfg, jio)
    jg.hydrostatic_atm(ctl, a_j)
    prof = jg.build_ray_profiles(ctl, a_j, obs, jnp.float32)
    los_j = jg.trace_rays(
        ctl, prof, {k: jnp.asarray(getattr(obs, k), jnp.float32)
                    for k in GEO}, jnp.float32)
    los_t = _PORT_LOS[case] = _port_trace(case)
    tp_j = np.stack([np.asarray(getattr(los_j, f)) for f in TP], axis=1)
    tp_t = np.stack([getattr(los_t, f).numpy() for f in TP], axis=1)
    assert tp_j.dtype == tp_t.dtype == np.float32
    return tp_j, tp_t, np.loadtxt(d / "rad.tab")[:, 7:10]


@pytest.mark.parametrize("case", ["limb", "nadir", "ega"])
def test_float32_tangent_points(case):
    tp_j, tp_t, tp_ref = _tangent_points(case)
    bad_j = ~np.isfinite(tp_j).all(axis=1)
    assert bad_j.sum() == MAX_NONFINITE_JAX[case]
    assert np.isfinite(tp_t).all(), np.flatnonzero(~np.isfinite(tp_t))
    assert np.isfinite(tp_ref).all()
    np.testing.assert_allclose(tp_t[~bad_j], tp_j[~bad_j], rtol=0,
                               atol=TP_TOL)
    np.testing.assert_allclose(tp_t, tp_ref, rtol=0, atol=TP_TOL)


def test_tangent_guard_leaves_radiances(monkeypatch):
    """The float32 ``nadir`` LOS is bit for bit that of a trace whose
    tangent points are all NaN, in every field but the tangent points:
    rad and tau, computed from those fields alone, cannot have moved with
    the guard.  Its tangent points are finite."""
    guarded = _PORT_LOS.get("nadir") or _port_trace("nadir")
    assert all(torch.isfinite(getattr(guarded, f)).all() for f in TP)

    def no_tangent(z, lon, lat, ds, ipl, np_):
        nan = torch.full_like(z[:, 0], float("nan"))
        return nan, nan, nan

    monkeypatch.setattr(tg, "tangent_point", no_tangent)
    bare = _port_trace("nadir")
    assert torch.isnan(bare.tpz).all()
    for f in guarded._fields:
        if f not in TP:
            assert torch.equal(getattr(guarded, f), getattr(bare, f)), f
