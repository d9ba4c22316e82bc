"""The benchmark's plain reference against the program's CPU path on a
small limb scan of the program's own (``jurassic_torch.workloads.
small_limb``): the eager exact and fast passes and the Jacobian's plain
tangent chain agree to rounding in float64; the turbo pass within its
fit."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from h100bench.reference.forward import Reference


def _small(kernel: str):
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    from jurassic_torch.workloads import small_limb
    ctl, ft, atm, obs = small_limb(ng=4, nd=9, nr=12, nlos=60)
    ctl.kernel, ctl.hydz, ctl.usetpu = kernel, 20.0, 0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 60.0
    ctl.retq_zmin, ctl.retq_zmax = [10.0] * ctl.ng, [60.0] * ctl.ng
    cfg = dict(emitters=list(ctl.emitter), nd=ctl.nd, nu0=ctl.nu[0],
               nu1=ctl.nu[-1], nlos=ctl.nlos, rayds=ctl.rayds,
               raydz=ctl.raydz, refrac=ctl.refrac, hydz=ctl.hydz,
               continua=dict(co2=1, h2o=1, n2=1, o2=1),
               retrieval=dict(t_zmin=10.0, t_zmax=60.0, q_zmin=10.0,
                              q_zmax=60.0))
    assert np.allclose(np.linspace(cfg["nu0"], cfg["nu1"], ctl.nd), ctl.nu,
                       rtol=0, atol=0)
    ftd = ft._asdict()
    u = fast_to_ega_tables(ft).u if kernel == "exact" else None
    a = {f.name: np.array(getattr(atm, f.name))
         for f in dataclasses.fields(atm)}
    geo = {f.name: np.array(getattr(obs, f.name))
           for f in dataclasses.fields(obs)}
    return ctl, ft, atm, obs, cfg, ftd, u, a, geo


@pytest.mark.parametrize("kernel,tol", [("exact", 1e-13), ("jax", 1e-13),
                                        ("auto", 2e-3)])
def test_formod_matches_the_program(kernel, tol):
    from jurassic_torch.forward import ForwardModel
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    torch.set_num_threads(1)
    ctl, ft, atm, obs, cfg, ftd, u, a, geo = _small(kernel)
    if kernel == "exact":
        fm = ForwardModel(ctl, fast_to_ega_tables(ft), device="cpu",
                          dtype=torch.float64)
    else:
        fm = ForwardModel(ctl, fast_tables=ft, device="cpu",
                          dtype=torch.float64)
    fm.formod(atm.copy(), obs)
    ref = Reference(cfg, ftd, u, torch.device("cpu"))
    (rad, tau), = ref.formod([a], geo, np.arange(obs.nr))
    scale = np.abs(rad).max(axis=0)
    assert np.all(np.abs(obs.rad - rad) <= tol * scale)
    assert np.all(np.abs(obs.tau - tau) <= tol)


def test_jacobian_matches_the_program():
    from jurassic_torch.forward import ForwardModel
    from jurassic_torch.models.synthetic import fast_to_ega_tables
    from jurassic_torch.retrieval import kernel_autodiff
    torch.set_num_threads(1)
    ctl, ft, atm, obs, cfg, ftd, u, a, geo = _small("exact")
    fm = ForwardModel(ctl, fast_to_ega_tables(ft), device="cpu",
                      dtype=torch.float64)
    rows = np.array([0, 5, 11])
    K = kernel_autodiff(ctl, atm.copy(), obs, fm).reshape(obs.nr, ctl.nd,
                                                            -1)[rows]
    ref = Reference(cfg, ftd, u, torch.device("cpu"))
    Kr, = ref.jacobian([a], geo, rows)
    assert K.shape == Kr.shape == (3, 9, 130)
    assert np.abs(K - Kr).max() <= 1e-12 * np.abs(Kr).max()
