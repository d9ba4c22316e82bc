"""The port's eager pipeline (``KERNEL = exact|jax|fast``) against the JAX
package's, in float64 on the CPU: ``ops.ega.ega_eps_exact`` /
``ega_eps_fast`` against JAX's (vmapped over rays) on random ragged
tables and states, ``ops.continua.beta_ds`` for every combination of
continuum flags, and ``forward.rt_integrate`` on lines of sight traced
by the JAX package.

Bar: 1e-12 relative (ROADMAP section 1, item 3) -- of each value for the
EGA factors and the continua, of max|rad| and max|tau| for the radiance
pass (a transmittance of 1e-5 carries the absolute error of the larger
ones): the same float64 arithmetic in another operation order, with the
same interval searches (counted within each row's count, so the padding
beyond it -- random here -- is never read as data).
"""
import itertools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jurassic_tpu.config as jcfg
import jurassic_tpu.io_tab as jio
import jurassic_tpu.ops.continua as jcont
import jurassic_tpu.ops.ega as jega
import jurassic_tpu.tables as jtab
from jurassic_tpu import forward as jf
from jurassic_torch import forward as tf
from jurassic_torch.geometry import los_from_numpy
from jurassic_torch.ops import continua as tcont
from jurassic_torch.ops import ega as tega

from test_torch_host_copies import golden_case, small_limb_pair
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"
RTOL = 1e-12


def _ascending(rng, lo, hi, n, size):
    """``size`` rows of ``n`` ascending values in [lo, hi] (log-uniform
    for lo > 0)."""
    if lo > 0:
        v = np.exp(rng.uniform(np.log(lo), np.log(hi), size + (n,)))
    else:
        v = rng.uniform(lo, hi, size + (n,))
    return np.sort(v, axis=-1)


def random_tables(seed=0, G=3, P=5, T=4, U=14, D=4):
    """EgaTables with ragged counts (some tables missing: np_ < 2,
    nt < 2 and n_u < 2 rows), ascending axes and rows within each count
    and random values beyond it; the p and T axes span 1e-3..1e4 hPa and
    100..400 K."""
    rng = np.random.default_rng(seed)
    np_ = rng.integers(2, P + 1, (G, D)).astype(np.int32)
    np_[0, 1] = 1
    nt = rng.integers(2, T + 1, (G, P, D)).astype(np.int32)
    nt[1, 2, 0] = 1
    nu = rng.integers(2, U + 1, (G, P, T, D)).astype(np.int32)
    nu[rng.uniform(size=nu.shape) < 0.04] = 1
    nu[2, 0, 0, 3] = 0
    p = np.moveaxis(_ascending(rng, 1e-2, 1e3, P, (G, D)), -1, 1)
    t = np.moveaxis(_ascending(rng, 150.0, 320.0, T, (G, P, D)), -1, 2)
    u = np.moveaxis(_ascending(rng, 1e16, 1e25, U, (G, P, T, D)), -1, 3)
    eps = np.moveaxis(_ascending(rng, 1e-4, 0.999, U, (G, P, T, D)), -1, 3)
    # the end points of every axis bracket the states' p and t (beyond
    # them the bilinear step extrapolates and amplifies last-bit
    # differences of exp2/log2 without bound)
    ip, it = np.arange(P), np.arange(T)
    p = np.where(ip[None, :, None] == np_[:, None, :] - 1, 1e4, p)
    p[:, 0, :] = 1e-3
    t = np.where(it[None, None, :, None] == nt[:, :, None, :] - 1, 400.0, t)
    t[:, :, 0, :] = 100.0
    # garbage beyond each count
    ip, it, iu = np.arange(P), np.arange(T), np.arange(U)
    pad = ip[None, :, None] >= np_[:, None, :]
    p = np.where(pad, rng.uniform(-1e3, 1e3, p.shape), p)
    pad = it[None, None, :, None] >= nt[:, :, None, :]
    t = np.where(pad, rng.uniform(0, 400, t.shape), t)
    pad = iu[None, None, None, :, None] >= nu[:, :, :, None, :]
    u = np.where(pad, rng.uniform(-1e25, 1e25, u.shape), u)
    eps = np.where(pad, rng.uniform(-1, 2, eps.shape), eps)
    S = 1201
    st = 100.0 + 0.25 * np.arange(S)
    sr = rng.uniform(1e-6, 1e-3, (S, D))
    return jtab.EgaTables(np_=np_, nt=nt, nu=nu, p=p, t=t,
                          u=u.astype(np.float32), eps=eps.astype(np.float32),
                          sr=sr, st=st)


def random_states(seed, R, G, D):
    """(tau_path [R, G, D], t [R], u_seg [R, G], p [R]), some paths
    opaque; u_seg from far below to far beyond the u axes."""
    rng = np.random.default_rng(seed)
    tau_path = rng.uniform(0.0, 1.0, (R, G, D))
    tau_path[rng.uniform(size=tau_path.shape) < 0.1] = 1e-12
    tau_path[0] = 1.0
    t = rng.uniform(120.0, 340.0, R)
    p = np.exp(rng.uniform(np.log(3e-3), np.log(3e3), R))
    u_seg = np.exp(rng.uniform(np.log(1e14), np.log(1e24), (R, G)))
    return tau_path, t, u_seg, p


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ega_eps_matches_jax(mode, seed):
    tbl = random_tables(seed)
    G, _, _, _, D = tbl.u.shape
    st = random_states(seed + 10, 23, G, D)
    if mode == "exact":
        jt, fn = jf.ega_tables_to_device(tbl), jega.ega_eps_exact
        tt = tega.ega_tables_to_device(tbl, "cpu")
        port = tega.ega_eps_exact
    else:
        ft = jtab.build_fast_tables(tbl)
        assert (ft.nu < 2).any() and (ft.np_ < 2).any()
        jt, fn = jf.fast_tables_to_device(ft), jega.ega_eps_fast
        tt = tega.fast_tables_to_device(ft, "cpu")
        port = tega.ega_eps_fast
    ref = np.asarray(jax.vmap(lambda a, b, c, d: fn(jt, a, b, c, d))(
        *(jnp.asarray(x) for x in st)))
    got = port(tt, *(torch.from_numpy(x) for x in st)).numpy()
    assert got.dtype == np.float64 and got.shape == ref.shape
    # every guard is taken somewhere: opaque paths, missing tables, and
    # ordinary factors strictly between
    assert (ref == 0).any() and (ref == 1).any()
    assert ((ref > 0) & (ref < 1)).sum() > ref.size // 5
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("flags", list(itertools.product([False, True],
                                                         repeat=4)))
def test_beta_ds_matches_jax(flags):
    ctl = jcfg.Ctl()
    ctl.nd = 9
    ctl.nu = list(np.linspace(700.0, 2600.0, 9))
    ctl.window = [0] * 9
    cc = jcont.precompute_continua(ctl)
    rng = np.random.default_rng(5)
    R = 6
    args = [rng.uniform(0, 1e-3, (R, 9)),                 # window_k
            rng.uniform(0.1, 20.0, (R, 1)),               # ds
            rng.uniform(1e-3, 1e3, (R, 1)),               # p
            rng.uniform(180.0, 310.0, (R, 1)),            # t
            rng.uniform(1e-6, 1e-2, (R, 1)),              # q_h2o
            rng.uniform(1e17, 1e22, (R, 1)),              # u_co2
            rng.uniform(1e17, 1e22, (R, 1))]              # u_h2o
    ref = np.asarray(jcont.beta_ds(
        flags, jf.continua_to_device(cc, jnp.float64),
        *(jnp.asarray(a) for a in args)))
    got = tcont.beta_ds(flags, tcont.continua_to_device(cc, torch.float64,
                                                        "cpu"),
                        *(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == (R, 9)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def _jax_golden_model(case, kernel):
    """The JAX model of a golden, with its atmosphere and every 25th ray
    of its observations."""
    ctl_j, obs_j, atm_j = golden_case(case, jcfg, jio, kernel=kernel)
    obs_j = jio.Obs(**{f: getattr(obs_j, f)[::25]
                       for f in obs_j.__dataclass_fields__})
    return jf.ForwardModel(ctl_j, directory=str(GOLD / case)), atm_j, obs_j


@pytest.mark.parametrize("case, kernel", [("ega", "exact"),
                                          ("nadir", "exact"),
                                          ("ega", "fast"),
                                          ("small", "jax")])
def test_rt_integrate_matches_jax(case, kernel):
    """rt_integrate on the LOS the JAX package traced, through each
    package's ForwardModel.integrate: rad and tau within 1e-12 of their
    largest value (``nadir`` adds the surface term and the brightness
    conversion)."""
    if case == "small":
        (ctl_j, ft, atm_j, obs_j), (ctl, ft_t, _a, _o) = small_limb_pair(
            ng=3, nd=5, nr=6)
        ctl_j.kernel = ctl.kernel = kernel
        m_j = jf.ForwardModel(ctl_j, fast_tables=ft)
        fm = tf.ForwardModel(ctl, fast_tables=ft_t, device="cpu")
    else:
        m_j, atm_j, obs_j = _jax_golden_model(case, kernel)
        ctl, _o, _a = golden_case(case, kernel=kernel)
        fm = tf.ForwardModel(ctl, directory=str(GOLD / case), device="cpu")
    assert m_j.kernel_mode == ("exact" if kernel == "exact" else "jax")
    assert fm.kernel_mode == ("exact" if kernel == "exact" else "fast")
    los = m_j.trace(atm_j, obs_j)
    ref = m_j.integrate(los)
    out = fm.integrate(los_from_numpy(jax.tree.map(np.asarray, los)))
    assert fm.last_variant == fm.kernel_mode
    assert out.rad.dtype == torch.float64
    for name in ("rad", "tau"):
        r = np.asarray(getattr(ref, name))
        g = getattr(out, name).numpy()
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * np.abs(r).max(),
                                   err_msg=name)


def test_exact_needs_ega_tables():
    _, (ctl, ft, _a, _o) = small_limb_pair(ng=2, nd=3, nr=2)
    ctl.kernel = "exact"
    with pytest.raises(ValueError, match="EgaTables"):
        tf.ForwardModel(ctl, fast_tables=ft, device="cpu")


def test_turbo_file_cache(tmp_path, capsys):
    """The fitted turbo tables go to a file beside the table cache under
    WRITE_BINARY (the port's own name) and come back from it under
    READ_BINARY, equal, with no second fit."""
    work = tmp_path / "ega"
    shutil.copytree(GOLD / "ega", work)
    ctl, _o, _a = golden_case("ega", kernel="turbo", write_binary=1,
                              read_binary=-1)
    ctl.tblbase = str(work / "synth")
    fm = tf.ForwardModel(ctl, directory=str(work), device="cpu")
    assert "rows fitted" in capsys.readouterr().out
    files = sorted(p.name for p in work.glob("*.npz"))
    assert len(files) == 2 and files[1].endswith("_turbo.npz") \
        and files[1].startswith("jurassic_torch_tables_")
    fm2 = tf.ForwardModel(ctl, directory=str(work), device="cpu")
    assert "rows fitted" not in capsys.readouterr().out
    assert fm2.turbo_stats == fm.turbo_stats
    for f in ("coef", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u"):
        assert torch.equal(getattr(fm2.turbo_tbl, f),
                           getattr(fm.turbo_tbl, f)), f
    ctl.read_binary = 0
    tf.ForwardModel(ctl, directory=str(work), device="cpu")
    assert "rows fitted" in capsys.readouterr().out
