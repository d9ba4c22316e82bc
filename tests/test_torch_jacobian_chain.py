"""The chained forward-mode Jacobian of ``retrieval.kernel_autodiff``
(the state map's ``torch.func.jacfwd`` on the atm axis, then the tracer's
and the fast RT pass's tangents, on the CPU their plain versions) against
JAX's ``kernel_autodiff`` (its compiled ``jax.jacfwd`` through the
pipeline) within 1e-8 of max|K|, and against the port's own
``kernel_autodiff_jacfwd`` within 1e-10, float64 on the CPU.

The case: a small limb scan (4 rays per scan, NLOS 60, 2 gases, 4
channels) over two scans' profiles at their own (lon, lat) and times
(the multi-profile atmosphere of ``tests/test_torch_retrieval_seam.py``),
with HYDZ on (the hydrostatic rebuild inside the seed) and off; the
state is T at 10-20 km and gas 1 at 20-25 km of both profiles (10
elements).  ``tests/test_torch_retrieval.py`` holds the single-profile
case to JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jurassic_torch.retrieval as tret
from jurassic_tpu.forward import ForwardModel as JaxModel
from jurassic_tpu.models.synthetic import (limb_workload, synthetic_ctl,
                                           synthetic_fast_tables)
from jurassic_tpu.retrieval import kernel_autodiff as jax_kernel_autodiff
from jurassic_torch.forward import ForwardModel, _obs_rows
from test_torch_host_copies import (one_thread,  # noqa: F401 (autouse)
                                    port_atm, port_ctl, port_fast_tables,
                                    port_obs)
from test_torch_retrieval import two_profile_atm


def _case(hydz: float):
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 60
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.hydz = hydz
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 20.0
    ctl.retq_zmin = [-999.0, 20.0]
    ctl.retq_zmax = [-999.0, 25.0]
    atm = two_profile_atm(ctl)
    obs = limb_workload(ctl, 8)
    obs.time[4:] = 3600.0                 # rays 4.. view the second scan
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=6, n_k=48)
    ctl_t = dataclasses.replace(port_ctl(ctl), kernel="jax")
    model = ForwardModel(ctl_t, fast_tables=port_fast_tables(ft),
                         device="cpu")
    return ctl, ft, atm, obs, ctl_t, model


@pytest.mark.parametrize("hydz", [-999.0, 20.0])
def test_chain_matches_jax_and_jacfwd(hydz, capsys):
    ctl, ft, atm, obs, ctl_t, model = _case(hydz)
    K = tret.kernel_autodiff(ctl_t, port_atm(atm.copy()),
                             port_obs(obs.copy()), model)
    assert "; plain tangent chain" in capsys.readouterr().out
    K_j = np.asarray(jax_kernel_autodiff(ctl, atm.copy(), obs.copy(),
                                         JaxModel(ctl, fast_tables=ft)))
    K_f = tret.kernel_autodiff_jacfwd(ctl_t, port_atm(atm.copy()),
                                      port_obs(obs.copy()), model)
    assert "; torch.func.jacfwd" in capsys.readouterr().out
    x, _, ipa = tret.atm2x(ctl_t, port_atm(atm.copy()))
    assert x.size == 10 and (ipa >= atm.npts // 2).any()
    assert K.shape == K_j.shape == K_f.shape == (obs.nr * ctl.nd, 10)
    assert K.dtype == np.float64 and np.isfinite(K).all()
    scale = np.abs(K_j).max()
    assert scale > 0
    np.testing.assert_allclose(K, K_j, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(K, K_f, rtol=0, atol=1e-10 * scale)
    # each scan's rays see only their own profile's state
    second = ipa >= atm.npts // 2
    nd = ctl.nd
    assert np.abs(K[:4 * nd][:, second]).max() == 0.0
    assert np.abs(K[4 * nd:][:, ~second]).max() == 0.0


def test_exact_tables_take_jacfwd(capsys):
    """A ``KERNEL = exact`` model's Jacobian takes the tangent chain on
    its exact tables (on a card the record kernel's exact instantiation,
    here the plain chain ``forward.rt_integrate_jvp_ref``) and names it on
    its package line; ``kernel_autodiff_jacfwd``, called by name, is its
    oracle: within 1e-10 of max|K| (the ``ega`` golden's geometry and
    tables, three rays, NLOS 40).  The same model on ``KERNEL = jax``
    runs the chain on the fast tables, and the two Jacobians agree to the
    fast tables' resampling."""
    from pathlib import Path

    from test_torch_host_copies import golden_case
    Ks = {}
    for kernel in ("exact", "jax"):
        ctl, obs, atm = golden_case("ega", kernel=kernel)
        ctl.nlos, ctl.rayds, ctl.raydz = 40, 20.0, 2.0
        ctl.rett_zmin, ctl.rett_zmax = 10.0, 20.0
        obs = _obs_rows(obs, slice(0, 3))
        m = ForwardModel(ctl, directory=str(Path(ctl.tblbase).parent),
                         device="cpu")
        assert m.eager_tables().use_fast == (kernel == "jax")
        Ks[kernel] = tret.kernel_autodiff(ctl, atm.copy(), obs.copy(), m)
        assert "; plain tangent chain" in capsys.readouterr().out
        if kernel == "exact":
            K_f = tret.kernel_autodiff_jacfwd(ctl, atm.copy(), obs.copy(),
                                              m)
            assert "; torch.func.jacfwd" in capsys.readouterr().out
            scale = np.abs(K_f).max()
            assert scale > 0 and K_f.shape == Ks["exact"].shape
            assert np.abs(Ks["exact"] - K_f).max() <= 1e-10 * scale
    scale = np.abs(Ks["exact"]).max()
    assert Ks["exact"].shape == Ks["jax"].shape and scale > 0
    assert np.abs(Ks["jax"] - Ks["exact"]).max() <= 2e-2 * scale


# The RT tangent kernel's hinted corner search (``ops.ega_jvp.
# hinted_halving``) on monotone rows (``ops.ega.rows_monotone``).

def _halving_cases(rows, nks, K, rng, n):
    from jurassic_torch.ops.ega_jvp import fixed_halving, hinted_halving
    hits = 0
    for _ in range(n):
        i = rng.integers(len(rows))
        row, nk = rows[i], int(nks[i])
        pick = rng.integers(4)
        if pick == 0:                   # a value of the row itself
            target = float(row[rng.integers(max(nk, 1))])
        elif pick == 1:                 # below or above the row
            target = float(row[0]) - 1.0 if rng.integers(2) else \
                float(row[max(nk - 1, 0)]) + 1.0
        elif pick == 2:
            target = float("nan")
        else:
            target = float(rng.uniform(row[0], row[max(nk - 1, 0)]))
        want = fixed_halving(row, nk, K, target)
        for hint in (want, want - 1, want + 1, want + 2,
                     int(rng.integers(-2, K + 2))):
            got, hit = hinted_halving(row, nk, K, target, hint)
            assert got == want, (i, nk, target, hint)
            hits += hit
    return hits


def test_hinted_halving_equals_fixed_random():
    """Random non-decreasing rows with ties, of every valid length nk
    (1 to K) and K not a power of 2; targets on the row's values, beyond
    both ends, NaN and between; hints at, next to and far from the
    answer."""
    rng = np.random.default_rng(5)
    K = 37
    rows = np.sort(rng.integers(0, 12, (400, K)).astype(np.float32), axis=1)
    nks = rng.integers(1, K + 1, 400)
    assert _halving_cases(rows, nks, K, rng, 3000) > 0


def test_hinted_halving_equals_fixed_flagship():
    """The flagship's eps rows (K = 224), which ``rows_monotone`` accepts,
    and one row made non-monotone, which it refuses."""
    from jurassic_torch.ops.ega import rows_monotone
    from jurassic_torch.workloads import flagship
    ft = flagship()[1]
    assert rows_monotone(ft)
    G, P, T, K, D = ft.eps.shape
    rng = np.random.default_rng(6)
    idx = [(g, p, t, d) for g, p, t, d in zip(*(rng.integers(0, s, 50)
                                                for s in (G, P, T, D)))]
    rows = np.stack([ft.eps[g, p, t, :, d] for g, p, t, d in idx])
    nks = np.array([ft.nu[g, p, t, d] for g, p, t, d in idx])
    assert _halving_cases(rows, nks, K, rng, 400) > 0
    eps = ft.eps.copy()
    eps[1, 2, 3, 100, 4] = eps[1, 2, 3, 99, 4] - 1e-3
    assert not rows_monotone(ft._replace(eps=eps))
    nu = ft.nu.copy()
    nu[1, 2, 3, 4] = 100                # the step now lies past nu
    assert rows_monotone(ft._replace(eps=eps, nu=nu))
