"""The port's CLI and driver edges on the CPU: the plain formod path of
``python -m jurassic_torch.cli.formod``, the modes this slice does not
port (each must raise, naming the ROADMAP), and the host-side FOV
convolution copied from the JAX package."""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from jurassic_tpu import forward as jf
from jurassic_tpu.config import read_ctl
from jurassic_tpu.io_tab import read_obs
from jurassic_torch import forward as tf
from jurassic_torch.cli import formod as cli
from jurassic_torch.workloads import small_limb

GOLD = Path(__file__).parent / "goldens"


def test_cli_formod_ega_golden(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU (ega.ctl pins USEGPU = 0) writes a rad.tab
    within the turbo bar of the C oracle."""
    work = tmp_path / "ega"
    shutil.copytree(GOLD / "ega", work)
    monkeypatch.chdir(work)
    assert cli.main(["formod", "ega.ctl", "obs.tab", "atm.tab",
                     "rad_port.tab"]) == 0
    assert "device cpu, fused EGA kernel launches 0" in \
        capsys.readouterr().out
    ref = np.loadtxt(work / "rad.tab")
    out = np.loadtxt(work / "rad_port.tab")
    nd = 2
    np.testing.assert_allclose(out[:, :10], ref[:, :10], rtol=0, atol=2e-4)
    scale = np.abs(ref[:, 10:10 + nd]).max()
    assert np.abs(out[:, 10:10 + nd] - ref[:, 10:10 + nd]).max() \
        <= 5e-3 * scale
    assert np.abs(out[:, 10 + nd:] - ref[:, 10 + nd:]).max() <= 5e-3


def test_cli_reports_unported_modes(tmp_path, monkeypatch, capsys):
    work = tmp_path / "ega"
    shutil.copytree(GOLD / "ega", work)
    monkeypatch.chdir(work)
    with pytest.raises(SystemExit) as e:
        cli.main(["formod", "ega.ctl", "obs.tab", "atm.tab", "rad.out",
                  "KERNEL", "pallas"])
    assert e.value.code == 1
    assert "ROADMAP" in capsys.readouterr().out
    assert not (work / "rad.out").exists()


def _small(kernel="turbo", **over):
    ctl, ft, atm, obs = small_limb(ng=2, nd=4, nr=3, nlos=32)
    ctl.kernel = kernel
    for k, v in over.items():
        setattr(ctl, k, v)
    return ctl, ft, atm, obs


@pytest.mark.parametrize("kernel", ["pallas", "jax", "exact", "fast"])
def test_unported_kernels_raise(kernel):
    ctl, ft, _atm, _obs = _small(kernel)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.ForwardModel(ctl, fast_tables=ft)


def _roughen(ft, cells):
    """Jagged monotone eps rows at (gas 0, channel 2) cells: the
    Chebyshev fit cannot follow them (test_pallas_kernel.py:369-389)."""
    eps = np.asarray(ft.eps, np.float64).copy()
    rng = np.random.default_rng(7)
    stair = np.cumsum(rng.uniform(0, 1, eps.shape[3]) ** 8)
    stair = 0.1 + 0.8 * stair / stair[-1]
    for (p_, t_) in cells:
        eps[0, p_, t_, :, 2] = stair
    return ft._replace(eps=eps.astype(np.float32))


def test_hybrid_tables_raise():
    """A few bad-fit rows (n_bad > 0) need the hybrid re-run."""
    ctl, ft, _atm, _obs = _small()
    ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
    with pytest.raises(NotImplementedError, match="bad-fit rows"):
        tf.ForwardModel(ctl, fast_tables=ft)


@pytest.mark.parametrize("kernel, exc", [("turbo", ValueError),
                                         ("auto", NotImplementedError)])
def test_rejected_fit(kernel, exc):
    """Every row jagged: the fit gate rejects the tables; turbo refuses
    them, auto would need the (unported) table-mode kernel."""
    ctl, ft, _atm, _obs = _small(kernel)
    P, T = ft.eps.shape[1:3]
    ft = _roughen(ft, [(p, t) for p in range(P) for t in range(T)])
    eps = np.asarray(ft.eps).copy()
    eps[:] = eps[0:1, :, :, :, 2:3]
    with pytest.raises(exc, match="fit"):
        tf.ForwardModel(ctl, fast_tables=ft._replace(eps=eps))
    if kernel == "turbo":       # the JAX driver refuses the same tables
        with pytest.raises(ValueError, match="fit validation"):
            jf.ForwardModel(ctl, fast_tables=ft._replace(eps=eps))


@pytest.mark.parametrize("over", [{"ip": 2}, {"raypack": 2}])
def test_unported_formod_options_raise(over):
    ctl, ft, atm, obs = _small(**over)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.ForwardModel(ctl, fast_tables=ft).formod(atm, obs)


def test_early_exit_and_monolithic_raypack_run():
    """EARLY_EXIT is accepted (bitwise no-op); RAYPACK < 0 is one batch."""
    ctl, ft, atm, obs = _small(raypack=-1)
    o0 = tf.ForwardModel(ctl, fast_tables=ft).formod(atm.copy(), obs.copy())
    ctl.early_exit = 1
    o1 = tf.ForwardModel(ctl, fast_tables=ft).formod(atm.copy(), obs.copy())
    np.testing.assert_array_equal(o0.rad, o1.rad)
    assert np.isfinite(o0.rad).all() and (o0.rad > 0).any()


def test_usegpu_required_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ctl, ft, _atm, _obs = _small(usetpu=1)
    with pytest.raises(ValueError, match="USEGPU = 1"):
        tf.ForwardModel(ctl, fast_tables=ft)


def test_fov_matches_jax():
    """The host-side FOV convolution is a NumPy copy: bitwise equal to
    the JAX package's."""
    d = GOLD / "fov"
    ctl = read_ctl(["formod", str(d / "limb.ctl"), "o", "a", "r"],
                   verbose=False)
    ctl.fov = str(d / "fov.tab")
    obs = read_obs(d / "obs.tab", ctl)
    rng = np.random.default_rng(3)
    obs.rad = rng.uniform(0, 1, obs.rad.shape)
    obs.tau = rng.uniform(0, 1, obs.tau.shape)
    o_j, o_t = obs.copy(), obs.copy()
    jf.formod_fov(ctl, o_j)
    tf.formod_fov(ctl, o_t)
    np.testing.assert_array_equal(o_t.rad, o_j.rad)
    np.testing.assert_array_equal(o_t.tau, o_j.tau)
    assert not np.array_equal(o_t.rad, obs.rad)
