"""The port's eager pipeline against the C oracle's goldens on the CPU,
at the JAX package's bars (``tests/test_forward_golden.py:46-70``,
``tests/test_flagship_golden.py:91-107``): ``KERNEL = exact`` in float64
on ``limb``, ``nadir``, ``ega`` and ``fov`` -- tangent points within
2e-4 km / deg, rad within 5e-6 of max|rad| (the 6 significant digits the
oracle prints), tau within 2e-6 -- and ``KERNEL = fast`` on ``ega``
within 2e-3.  The ``flagship`` and ``gas30`` goldens run on the card
(``chip_smoke.py``)."""
from pathlib import Path

import numpy as np
import pytest

from jurassic_torch.forward import ForwardModel

from test_torch_host_copies import golden_case
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"


def _run(case, kernel):
    d = GOLD / case
    over = {"kernel": kernel}
    if case == "fov":
        over["fov"] = str(d / "fov.tab")
    ctl, obs, atm = golden_case(case, **over)
    fm = ForwardModel(ctl, directory=str(d), device="cpu")
    fm.formod(atm, obs)
    assert fm.last_variant == ("exact" if kernel == "exact" else "fast")
    ref = np.loadtxt(d / ("rad_fov.tab" if case == "fov" else "rad.tab"))
    nd = ctl.nd
    return obs, ref, ref[:, 10:10 + nd], ref[:, 10 + nd:10 + 2 * nd]


@pytest.mark.parametrize("case", ["limb", "nadir", "ega", "fov"])
def test_exact_matches_oracle(case):
    obs, ref, rad_ref, tau_ref = _run(case, "exact")
    if case != "fov":
        np.testing.assert_allclose(obs.tpz, ref[:, 7], rtol=0, atol=2e-4)
        np.testing.assert_allclose(obs.tplat, ref[:, 9], rtol=0, atol=2e-4)
    scale = np.abs(rad_ref).max()
    assert np.abs(obs.rad - rad_ref).max() <= 5e-6 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 2e-6


def test_fast_close_to_oracle():
    obs, _ref, rad_ref, tau_ref = _run("ega", "fast")
    scale = np.abs(rad_ref).max()
    assert np.abs(obs.rad - rad_ref).max() <= 2e-3 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 2e-3
