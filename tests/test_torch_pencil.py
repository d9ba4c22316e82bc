"""The port's IP = 2/3 pencil path on the CPU: the twin of
``tests/test_interp_atm.py::test_pencil_formod_matches_1d_on_uniform_track``
(IP = 2/3 against IP = 1 on identical track profiles, 2e-3 / 0.1 of
max|rad|: IP = 3 averages over the vertical influence radius), and
against the JAX package on the same track atmosphere: ``pencil_trace``'s
LOS fields within 1e-12 of their largest value (float64; the host
re-sampling is a NumPy copy, the geometry the port's tracer), ``formod``
within 1e-10 of max|rad| in ``jax`` mode (both float64 eager) and 5e-5
in ``turbo`` mode (the fused pass in float32, the bar of the port's
other formod tests)."""
import numpy as np
import pytest

import jurassic_tpu.forward as jf
from jurassic_torch import forward as tf

from test_interp_atm import _track_atm
from test_torch_host_copies import port_atm, small_limb_pair
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)


def _pair(kernel):
    """(JAX (ctl, ft, atm, obs), port's) of a small limb scan with
    straight rays."""
    pair = small_limb_pair(ng=3, nd=5, nr=4, nlos=60)
    for ctl in (pair[0][0], pair[1][0]):
        ctl.refrac, ctl.kernel = 0, kernel
    return pair


def _track(ctl_j, ctl_t, atm1, ip):
    """The three-profile track atmosphere with every profile equal to
    ``atm1`` (JAX's Atm, and the port's copy), IP set on both ctls."""
    for c in (ctl_j, ctl_t):
        c.ip = ip
        c.cz, c.cx = 2.0, 8000.0
    atm = _track_atm(ctl_j)
    atm.t[:] = np.tile(atm1.t, 3)
    return atm, port_atm(atm)


@pytest.mark.parametrize("ip", [2, 3])
def test_pencil_formod_matches_1d_on_uniform_track(ip):
    (ctl_j, _ft, atm1, _o), (ctl, ft, atm1_t, obs) = _pair("auto")
    m1 = tf.ForwardModel(ctl, fast_tables=ft, device="cpu")
    o1 = obs.copy()
    m1.formod(atm1_t, o1)
    _atm, atm_t = _track(ctl_j, ctl, atm1, ip)
    m2 = tf.ForwardModel(ctl, fast_tables=ft, device="cpu")
    o2 = obs.copy()
    m2.formod(atm_t, o2)
    assert m2.last_variant == "turbo"
    scale = np.abs(o1.rad).max()
    tol = 2e-3 if ip == 2 else 0.1
    assert np.abs(o2.rad - o1.rad).max() <= tol * scale


@pytest.mark.parametrize("ip", [2, 3])
def test_pencil_trace_matches_jax(ip):
    (ctl_j, ft_j, atm1, obs_j), (ctl, ft, _a, obs) = _pair("jax")
    atm_j, atm_t = _track(ctl_j, ctl, atm1, ip)
    los_j = jf.ForwardModel(ctl_j, fast_tables=ft_j).pencil_trace(atm_j,
                                                                  obs_j)
    los = tf.ForwardModel(ctl, fast_tables=ft, device="cpu").pencil_trace(
        atm_t, obs)
    for f in ("p", "t", "q", "k", "u", "ds", "tsurf"):
        ref = np.asarray(getattr(los_j, f))
        got = getattr(los, f).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all(), f
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=f)
    np.testing.assert_array_equal(los.valid.numpy(), np.asarray(los_j.valid))


@pytest.mark.parametrize("ip, kernel, tol", [(2, "jax", 1e-10),
                                             (3, "jax", 1e-10),
                                             (2, "turbo", 5e-5)])
def test_pencil_formod_matches_jax(ip, kernel, tol):
    (ctl_j, ft_j, atm1, obs_j), (ctl, ft, _a, obs) = _pair(kernel)
    atm_j, atm_t = _track(ctl_j, ctl, atm1, ip)
    jf.ForwardModel(ctl_j, fast_tables=ft_j).formod(atm_j, obs_j)
    fm = tf.ForwardModel(ctl, fast_tables=ft, device="cpu")
    fm.formod(atm_t, obs)
    assert fm.last_variant == ("fast" if kernel == "jax" else "turbo")
    scale = np.abs(obs_j.rad).max()
    assert scale > 0
    assert np.abs(obs.rad - obs_j.rad).max() <= tol * scale
    assert np.abs(obs.tau - obs_j.tau).max() <= tol
    for f in ("tpz", "tplon", "tplat"):
        np.testing.assert_allclose(getattr(obs, f), getattr(obs_j, f),
                                   rtol=0, atol=1e-9, err_msg=f)


def test_pencil_needs_straight_rays():
    """IP = 2/3 with REFRAC = 1 raises in both packages."""
    (ctl_j, ft_j, atm1, obs_j), (ctl, ft, _a, obs) = _pair("jax")
    atm_j, atm_t = _track(ctl_j, ctl, atm1, 2)
    ctl_j.refrac = ctl.refrac = 1
    with pytest.raises(NotImplementedError, match="REFRAC"):
        jf.ForwardModel(ctl_j, fast_tables=ft_j).formod(atm_j, obs_j)
    with pytest.raises(ValueError, match="REFRAC = 0"):
        tf.ForwardModel(ctl, fast_tables=ft, device="cpu").formod(atm_t, obs)
