"""The port's ``formod`` on the CPU against the JAX package's
``formod`` (``KERNEL = turbo``, ``pallas``, the turbo hybrid and
``auto``'s demotion) and against the C oracle's goldens.

The JAX side runs exactly as ``tests/test_pallas_kernel.py`` runs it:
turbo tables, the pool kernel in Pallas interpret mode, float64 tracing.
The port traces in float64 and runs the plain PyTorch version of the
fused pass in float32.  Bars: 5e-5 of max|rad| and 5e-5 on tau against
JAX (both float32 RT, another operation order); 5e-3 against the C
oracle (the turbo bar of test_pallas_kernel.py:105-108: turbo evaluates
the smooth curve, the oracle its linear-in-u chords).  Table mode
(``KERNEL = pallas``) against JAX's table kernel: 1e-6 (the same
arithmetic on the same rows).  The hybrid: 1e-4 against JAX's float64
``KERNEL = jax`` pipeline (the bar of
test_turbo_hybrid_per_row_fallback) and 5e-5 against JAX's own spliced
result.

Each package gets its own classes: the goldens are read by each side's
own readers, synthetic inputs are built once and carried across as NumPy
copies (``test_torch_host_copies``).
"""
from pathlib import Path

import numpy as np
import pytest

import jax

from jurassic_tpu.forward import ForwardModel as JaxForwardModel
from jurassic_torch.forward import ForwardModel, formod

from test_forward_golden import run_case
from test_torch_cli import _roughen
from test_torch_host_copies import (golden_case, port_fast_tables,
                                    small_limb_pair)

GOLD = Path(__file__).parent / "goldens"


def _port_case(case, **over):
    """(ctl, obs, atm) of a golden case, read by the port's readers."""
    return golden_case(case, **over)


@pytest.mark.parametrize("case", ["ega", "nadir"])
def test_formod_matches_jax_turbo_and_oracle(case):
    ctl_j, obs_j, ref = run_case(case, "turbo")
    ctl, obs, atm = _port_case(case)
    fm = ForwardModel(ctl, directory=str(GOLD / case), device="cpu")
    fm.formod(atm, obs)
    nd = ctl.nd
    assert obs.rad.shape == obs_j.rad.shape == (obs.nr, nd)
    scale = np.abs(obs_j.rad).max()
    assert np.abs(obs.rad - obs_j.rad).max() <= 5e-5 * scale
    assert np.abs(obs.tau - obs_j.tau).max() <= 5e-5
    for f in ("tpz", "tplon", "tplat"):
        np.testing.assert_allclose(getattr(obs, f), getattr(obs_j, f),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    assert np.abs(obs.rad - rad_ref).max() <= 5e-3 * np.abs(rad_ref).max()
    assert np.abs(obs.tau - tau_ref).max() <= 5e-3


def test_observation_mask():
    """NaN radiances in the input come back NaN (save_mask/apply_mask,
    jr_common.h:193-210); the rest is computed."""
    ctl, obs, atm = _port_case("ega")
    obs.rad[2, 1] = np.nan
    ForwardModel(ctl, directory=str(GOLD / "ega")).formod(atm, obs)
    assert np.isnan(obs.rad[2, 1])
    assert np.isfinite(obs.rad[2, 0]) and np.isfinite(obs.rad[3, 1])


def test_checkmode_skips_compute(capsys):
    ctl, obs, atm = _port_case("ega", checkmode=1)
    rad0 = obs.rad.copy()
    out = formod(ctl, atm, obs, directory=str(GOLD / "ega"))
    assert out is obs
    np.testing.assert_array_equal(obs.rad, rad0)
    assert "no actual computation" in capsys.readouterr().out


def test_formod_pallas_matches_jax_on_small_limb():
    """KERNEL = pallas end to end on the small synthetic limb scan: the
    port's table-mode pass against the JAX group kernel in table mode
    (interpret mode), 1e-6."""
    (ctl, ft, atm, obs), (ctl_t, ft_t, atm_t, obs_t) = small_limb_pair(
        ng=4, nd=9, nr=6)
    ctl.kernel = ctl_t.kernel = "pallas"
    JaxForwardModel(ctl, fast_tables=ft).formod(atm, obs)
    fm = ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")
    assert fm.turbo_tbl is None and fm.table_tbl is not None
    fm.formod(atm_t, obs_t)
    assert fm.last_variant == "table"
    scale = np.abs(obs.rad).max()
    assert scale > 0
    assert np.abs(obs_t.rad - obs.rad).max() <= 1e-6 * scale
    assert np.abs(obs_t.tau - obs.tau).max() <= 1e-6


def test_turbo_hybrid_per_row_fallback(capsys):
    """Port twin of tests/test_pallas_kernel.py::
    test_turbo_hybrid_per_row_fallback: three rough rows do not demote
    the configuration; tainted lanes are re-evaluated through the table
    pass and every lane ends within 1e-4 of the float64 pipeline and
    within 5e-5 of JAX's spliced result."""
    (ctl, ft, atm, obs), (ctl_t, _f, atm_t, obs_t) = small_limb_pair(
        ng=3, nd=5, nr=11, n_k=40)
    for c in (ctl, ctl_t):
        c.ctm_n2 = c.ctm_o2 = 0
    ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
    ft_t = port_fast_tables(ft)

    ctl.kernel = "jax"
    m_jax = JaxForwardModel(ctl, fast_tables=ft)
    los = m_jax.trace(atm.copy(), obs)
    rad0 = np.asarray(m_jax.integrate(los).rad)
    tau0 = np.asarray(m_jax.integrate(los).tau)
    ctl.kernel = "turbo"
    m_j = JaxForwardModel(ctl, fast_tables=ft)
    o_j = obs.copy()
    m_j.formod(atm.copy(), o_j)
    assert m_j.last_variant == "pool+hybrid"

    ctl_t.kernel = "turbo"
    fm = ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")  # no raise
    assert fm.turbo_tbl.n_bad == 3
    assert fm.table_tbl is not None                # exact backing built
    assert "3 of" in capsys.readouterr().out
    fm.formod(atm_t, obs_t)
    assert fm.last_variant == "turbo+hybrid"
    assert "lanes re-evaluated through the table kernel" \
        in capsys.readouterr().out
    scale = np.abs(rad0).max()
    assert np.abs(obs_t.rad - rad0).max() <= 1e-4 * scale
    assert np.abs(obs_t.tau - tau0).max() <= 1e-4
    assert np.abs(obs_t.rad - o_j.rad).max() <= 5e-5 * scale
    assert np.abs(obs_t.tau - o_j.tau).max() <= 5e-5


def test_auto_falls_back_on_unfittable_tables(monkeypatch):
    """Port twin of tests/test_pallas_kernel.py::
    test_auto_falls_back_on_unfittable_tables: every row a staircase the
    fit cannot follow; KERNEL = auto must not raise and runs the table
    pass, matching JAX's demoted result; KERNEL = turbo raises.  The bar
    is 5e-6 here, not 1e-6: the staircase has steps of up to a tenth
    between neighbouring rows, and that slope amplifies the last-bit
    differences of exp2/log2 between XLA and PyTorch."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    (ctl, ft, atm, obs), (ctl_t, _f, atm_t, obs_t) = small_limb_pair(
        ng=2, nd=4, nr=5, n_p=6, n_t=4)
    rng = np.random.default_rng(0)
    eps = np.asarray(ft.eps, np.float64)
    stair = np.cumsum(rng.uniform(0, 1, eps.shape[3]) ** 8, axis=-1)
    stair = 0.1 + 0.8 * stair / stair[-1]
    eps[..., :, :] = stair[None, None, None, :, None]
    ft = ft._replace(eps=eps.astype(np.float32))
    ft_t = port_fast_tables(ft)
    ctl.kernel = ctl_t.kernel = "auto"
    m_j = JaxForwardModel(ctl, fast_tables=ft)
    assert m_j.turbo_stats is None and m_j.pallas_tbl.mode == "table"
    m_j.pallas_interpret = True     # the patched backend name is not real
    m_j.formod(atm, obs)
    fm = ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")  # no raise
    assert fm.turbo_tbl is None and fm.turbo_stats is None
    fm.formod(atm_t, obs_t)
    assert fm.last_variant == "table"
    scale = np.abs(obs.rad).max()
    assert np.abs(obs_t.rad - obs.rad).max() <= 5e-6 * scale
    assert np.abs(obs_t.tau - obs.tau).max() <= 5e-6
    ctl_t.kernel = "turbo"
    with pytest.raises(ValueError, match="fit validation failed"):
        ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")


def test_pallas_rejects_ragged_tables():
    """Port twin of the ValueError half of tests/test_pallas_kernel.py::
    test_pallas_rejects_ragged_tables; auto on such tables needs the jnp
    pipeline, which is not ported."""
    _, (ctl_t, ft_t, _a, _o) = small_limb_pair(ng=2, nd=4, nr=2, n_p=6,
                                               n_t=4, n_k=32)
    p = np.array(ft_t.p)
    p[0, :, 1] *= 1.5
    ft_t = ft_t._replace(p=p)
    for kernel in ("pallas", "turbo"):
        ctl_t.kernel = kernel
        with pytest.raises(ValueError, match="channel-uniform"):
            ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")
    ctl_t.kernel = "auto"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")


def test_hybrid_max_knob(monkeypatch):
    """JURASSIC_TURBO_HYBRID_MAX, the JAX package's knob: at 0 the three
    bad rows reject the fit (turbo raises, auto demotes)."""
    _, (ctl_t, ft_t, _a, _o) = small_limb_pair(ng=3, nd=5, nr=2, n_k=40)
    ft_t = _roughen(ft_t, ((3, 2), (4, 2), (4, 3)))
    monkeypatch.setenv("JURASSIC_TURBO_HYBRID_MAX", "0")
    ctl_t.kernel = "turbo"
    with pytest.raises(ValueError, match="bad rows 3"):
        ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")
    ctl_t.kernel = "auto"
    fm = ForwardModel(ctl_t, fast_tables=ft_t, device="cpu")
    assert fm.turbo_tbl is None and fm.table_tbl is not None
