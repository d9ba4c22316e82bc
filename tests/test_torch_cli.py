"""The port's CLI and driver edges on the CPU: the plain formod path of
``python -m jurassic_torch.cli.formod`` in turbo and table mode
(``KERNEL pallas``: 2e-3 of max|rad| and 2e-3 on tau against the C
oracle, the table bar of tests/test_pallas_kernel.py:28-38), the modes
that later slices brought in (the eager oracles, ``auto`` on ragged
tables, the pencil path, ray packages: each against the JAX package on
the same inputs), a configuration both packages refuse, and the
host-side FOV convolution copied from the JAX package."""
import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jurassic_tpu.config as jcfg
import jurassic_tpu.io_tab as jio
from jurassic_tpu import forward as jf
from jurassic_torch import forward as tf
from jurassic_torch.cli import formod as cli
from jurassic_torch.models.synthetic import fast_to_ega_tables
from jurassic_torch.workloads import small_limb
import jurassic_tpu.tables as jtab

from test_torch_host_copies import golden_case
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"


def test_cli_formod_ega_golden(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU (ega.ctl pins USEGPU = 0) writes a rad.tab
    within the turbo bar of the C oracle."""
    work = tmp_path / "ega"
    shutil.copytree(GOLD / "ega", work)
    monkeypatch.chdir(work)
    assert cli.main(["formod", "ega.ctl", "obs.tab", "atm.tab",
                     "rad_port.tab"]) == 0
    assert "device cpu, variant turbo, fused EGA kernel launches turbo 0 " \
        "table 0" in capsys.readouterr().out
    ref = np.loadtxt(work / "rad.tab")
    out = np.loadtxt(work / "rad_port.tab")
    nd = 2
    np.testing.assert_allclose(out[:, :10], ref[:, :10], rtol=0, atol=2e-4)
    scale = np.abs(ref[:, 10:10 + nd]).max()
    assert np.abs(out[:, 10:10 + nd] - ref[:, 10:10 + nd]).max() \
        <= 5e-3 * scale
    assert np.abs(out[:, 10 + nd:] - ref[:, 10 + nd:]).max() <= 5e-3


@pytest.mark.parametrize("case", ["limb", "nadir", "ega"])
def test_cli_formod_kernel_pallas_goldens(case, tmp_path, monkeypatch,
                                          capsys):
    """``KERNEL pallas`` through the CLI on the three goldens, at the
    table bar against the C oracle (2e-3 of max|rad|, 2e-3 on tau)."""
    work = tmp_path / case
    shutil.copytree(GOLD / case, work)
    monkeypatch.chdir(work)
    ctl = next(work.glob("*.ctl")).name
    assert cli.main(["formod", ctl, "obs.tab", "atm.tab", "rad_port.tab",
                     "KERNEL", "pallas", "USEGPU", "0"]) == 0
    assert "device cpu, variant table, fused EGA kernel launches turbo 0 " \
        "table 0" in capsys.readouterr().out
    ref = np.loadtxt(work / "rad.tab")
    out = np.loadtxt(work / "rad_port.tab")
    nd = (ref.shape[1] - 10) // 2
    rad_ref, tau_ref = ref[:, 10:10 + nd], ref[:, 10 + nd:]
    assert np.isfinite(out).all()
    assert np.abs(out[:, 10:10 + nd] - rad_ref).max() \
        <= 2e-3 * np.abs(rad_ref).max()
    assert np.abs(out[:, 10 + nd:] - tau_ref).max() <= 2e-3


def test_cli_reports_unported_modes(tmp_path, monkeypatch, capsys):
    """A configuration the port cannot run -- here IP = 2 with ray
    bending, which the JAX package refuses too -- exits 1 with the
    reason and writes no output."""
    work = tmp_path / "ega"
    shutil.copytree(GOLD / "ega", work)
    monkeypatch.chdir(work)
    with pytest.raises(SystemExit) as e:
        cli.main(["formod", "ega.ctl", "obs.tab", "atm.tab", "rad.out",
                  "IP", "2", "REFRAC", "1"])
    assert e.value.code == 1
    assert "REFRAC = 0" in capsys.readouterr().out
    assert not (work / "rad.out").exists()


def _small(kernel="turbo", **over):
    ctl, ft, atm, obs = small_limb(ng=2, nd=4, nr=3, nlos=32)
    ctl.kernel = kernel
    for k, v in over.items():
        setattr(ctl, k, v)
    return ctl, ft, atm, obs


def _jax_formod(ctl, ft, atm, obs, tables=None):
    """The JAX package's formod on copies of the port's inputs."""
    j_ctl = jcfg.Ctl(**dataclasses.asdict(ctl))
    j_obs = jio.Obs(**dataclasses.asdict(obs))
    j_atm = jio.Atm(**dataclasses.asdict(atm))
    kw = ({"fast_tables": jtab.FastTables(**ft._asdict())} if tables is None
          else {"tables": jtab.EgaTables(**tables._asdict())})
    jf.ForwardModel(j_ctl, **kw).formod(j_atm, j_obs)
    return j_obs


@pytest.mark.parametrize("kernel", ["auto-ragged", "jax", "exact", "fast"])
def test_unported_kernels_raise(kernel, capsys):
    """The eager oracles, and KERNEL = auto on tables whose axes are
    ragged across channels (JAX sends those to its jnp pipeline, the port
    to its eager fast pipeline, saying so): no raise, and the radiances
    of the JAX package's formod within 1e-10 of max|rad| (both float64
    eager pipelines)."""
    ctl, ft, atm, obs = _small(kernel.split("-")[0])
    tables = None
    if kernel == "auto-ragged":
        p = np.array(ft.p)
        p[0, :, 1] *= 1.5
        ft = ft._replace(p=p)
    if kernel == "exact":
        tables = fast_to_ega_tables(ft)
    o_j = _jax_formod(ctl, ft, atm.copy(), obs.copy(), tables)
    fm = tf.ForwardModel(ctl, tables, fast_tables=ft)
    o = fm.formod(atm.copy(), obs.copy())
    assert fm.last_variant == ("exact" if kernel == "exact" else "fast")
    assert ("not channel-uniform" in capsys.readouterr().out) \
        == (kernel == "auto-ragged")
    scale = np.abs(o_j.rad).max()
    assert scale > 0
    assert np.abs(o.rad - o_j.rad).max() <= 1e-10 * scale
    assert np.abs(o.tau - o_j.tau).max() <= 1e-10


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


def test_hybrid_tables_raise(monkeypatch, capsys):
    """A few bad-fit rows (n_bad > 0) raise only past the hybrid's
    share of rows (JURASSIC_TURBO_HYBRID_MAX); within it the model builds
    with the exact backing for the tainted lanes."""
    ctl, ft, _atm, _obs = _small()
    ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
    fm = tf.ForwardModel(ctl, fast_tables=ft)
    assert fm.turbo_tbl.n_bad == 3 and fm.table_tbl is not None
    assert "tainted lanes re-evaluate" in capsys.readouterr().out
    monkeypatch.setenv("JURASSIC_TURBO_HYBRID_MAX", "0.001")
    with pytest.raises(ValueError, match="bad rows 3"):
        tf.ForwardModel(ctl, fast_tables=ft)


@pytest.mark.parametrize("kernel, exc", [("turbo", ValueError),
                                         ("auto", None)])
def test_rejected_fit(kernel, exc):
    """Every row jagged: the fit gate rejects the tables; turbo refuses
    them, auto demotes to the table-mode pass."""
    ctl, ft, _atm, _obs = _small(kernel)
    P, T = ft.eps.shape[1:3]
    ft = _roughen(ft, [(p, t) for p in range(P) for t in range(T)])
    eps = np.asarray(ft.eps).copy()
    eps[:] = eps[0:1, :, :, :, 2:3]
    ft = ft._replace(eps=eps)
    if exc is None:
        fm = tf.ForwardModel(ctl, fast_tables=ft)
        assert fm.turbo_tbl is None and fm.table_tbl is not None
        return
    with pytest.raises(exc, match="fit"):
        tf.ForwardModel(ctl, fast_tables=ft)
    # the JAX package refuses the same tables
    with pytest.raises(ValueError, match="fit validation"):
        jf.ForwardModel(jcfg.Ctl(**dataclasses.asdict(ctl)),
                        fast_tables=jtab.FastTables(**ft._asdict()))


@pytest.mark.parametrize("over", [{"ip": 2}, {"raypack": 2}])
def test_unported_formod_options_raise(over):
    """The pencil path (IP = 2, straight rays) and ray packages
    (RAYPACK 2 on 3 rays) run, within 5e-5 of the JAX package's turbo
    formod (both float32 fused passes)."""
    ctl, ft, atm, obs = _small(refrac=0, **over)
    o_j = _jax_formod(ctl, ft, atm.copy(), obs.copy())
    fm = tf.ForwardModel(ctl, fast_tables=ft)
    o = fm.formod(atm.copy(), obs.copy())
    assert fm.last_variant == "turbo"
    assert fm.package_size(obs.nr) == (2 if "raypack" in over else 0)
    scale = np.abs(o_j.rad).max()
    assert scale > 0
    assert np.abs(o.rad - o_j.rad).max() <= 5e-5 * scale
    assert np.abs(o.tau - o_j.tau).max() <= 5e-5


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
    ctl_j, o_j, _ = golden_case("fov", jcfg, jio, fov=str(d / "fov.tab"))
    ctl_t, o_t, _ = golden_case("fov", fov=str(d / "fov.tab"))
    rng = np.random.default_rng(3)
    obs = o_t.copy()
    obs.rad = rng.uniform(0, 1, obs.rad.shape)
    obs.tau = rng.uniform(0, 1, obs.tau.shape)
    for o in (o_j, o_t):
        o.rad, o.tau = obs.rad.copy(), obs.tau.copy()
    jf.formod_fov(ctl_j, o_j)
    tf.formod_fov(ctl_t, o_t)
    np.testing.assert_array_equal(o_t.rad, o_j.rad)
    np.testing.assert_array_equal(o_t.tau, o_j.tau)
    assert not np.array_equal(o_t.rad, obs.rad)
