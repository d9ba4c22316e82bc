"""The port's ``formod`` on the CPU against the JAX package's
``formod(KERNEL = turbo)`` and against the C oracle's goldens.

The JAX side runs exactly as ``tests/test_pallas_kernel.py`` runs it:
turbo tables, the pool kernel in Pallas interpret mode, float64 tracing.
The port traces in float64 and runs the plain PyTorch version of the
fused pass in float32.  Bars: 5e-5 of max|rad| and 5e-5 on tau against
JAX (both float32 RT, another operation order); 5e-3 against the C
oracle (the turbo bar of test_pallas_kernel.py:105-108: turbo evaluates
the smooth curve, the oracle its linear-in-u chords).
"""
from pathlib import Path

import numpy as np
import pytest

from jurassic_tpu.config import read_ctl
from jurassic_tpu.io_tab import read_atm, read_obs
from jurassic_torch.forward import ForwardModel, formod

from test_forward_golden import run_case

GOLD = Path(__file__).parent / "goldens"


def _port_case(case, **over):
    d = GOLD / case
    ctl = read_ctl(["formod", str(next(d.glob("*.ctl"))), "o", "a", "r"],
                   verbose=False)
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    obs, atm = read_obs(d / "obs.tab", ctl), read_atm(d / "atm.tab", ctl)
    for k, v in over.items():
        setattr(ctl, k, v)
    return ctl, obs, atm


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
