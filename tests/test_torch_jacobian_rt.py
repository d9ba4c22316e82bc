"""The plain version of the RT pass's tangent kernel of
``kernel_autodiff`` (``forward.rt_integrate_jvp_ref``, plain version of
``csrc/ega_jvp_fast.cu``) against ``torch.func.jvp`` of
``forward.rt_integrate`` on the fast tables, float64 on the CPU, at 1e-12
of drad's largest |tangent|, with random LOS tangents at each field's
scale: on the ``ega`` golden's geometry, on a small limb scan with and
without the brightness conversion, with ground hits, and on the
flagship's lowest ray (tangent point 3 km), whose saturated channels take
the clamps and the ``ki >= lo`` guard of ``ops.ega.ega_eps_fast``; its
primal bit for bit ``rt_integrate``'s.  On the same cases the plain
statement of the kernels' adjoint form (``ops.ega_jvp.
rt_jvp_adjoint_ref``: records, A by a sweep back, then the contraction)
against ``rt_integrate_jvp_ref`` at 1e-12 of max|drad|, its primal bit
for bit.  ``tests/test_torch_jacobian_kernels.py`` has the tracer's.
"""
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from jurassic_torch import geometry as tg
from jurassic_torch.forward import ForwardModel, _obs_rows, rt_integrate_jvp_ref
from jurassic_torch.ops.ega_jvp import rt_jvp_adjoint_ref
from jurassic_torch.workloads import flagship
from test_torch_host_copies import golden_case
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)
from test_torch_jacobian_kernels import BAR, RT_FIELDS, _scan


def _rt_inputs(ctl, ft, atm, obs, bbt=False, seed=1, n_tan=5):
    """(model, LOS, random LOS tangents at each field's scale, the plain
    tangent pass's arguments) of the eager fast model on a scan."""
    ctl.kernel, ctl.write_bbt = "jax", int(bbt)
    m = ForwardModel(ctl, fast_tables=ft, device="cpu", dtype=torch.float64)
    los = m.trace(atm, obs)
    e = m.eager_tables()
    assert e.use_fast
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    rng = np.random.default_rng(seed)
    scale = [los.p, los.t] + [los.q] * G + [los.k] * W + [los.u] * G \
        + [los.ds]
    seg = rng.standard_normal((R, S, 3 + 2 * G + W, n_tan)) * np.array(
        [float(x.abs().max()) * 1e-2 + 1e-30 for x in scale])[:, None]
    tan = tg.LosTangents(torch.from_numpy(seg),
                         torch.from_numpy(rng.standard_normal((R, n_tan))))
    args = (e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, tan, m.flags,
            m.ig_co2, m.ig_h2o, bbt)
    return m, los, tan, args


def _ega_inputs():
    """The ``ega`` golden's geometry (its three gases and two channels on
    synthetic tables), NLOS cut to 60 with 20 km steps."""
    ctl, obs, atm = golden_case("ega", kernel="jax")
    ctl.nlos, ctl.rayds, ctl.raydz = 60, 20.0, 2.0
    obs = _obs_rows(obs, np.arange(0, obs.nr, 3)[:9])
    fm = ForwardModel(ctl, directory=str(Path(ctl.tblbase).parent),
                      device="cpu")
    return _rt_inputs(ctl, fm.fast_tables, atm, obs)


def _saturated_inputs():
    """The flagship's lowest ray on its 40 x 30 x 224 tables, 100
    channels, all four continua."""
    ctl, ft, atm, obs = flagship()
    tg.hydrostatic_atm(ctl, atm)
    return _rt_inputs(ctl, ft, atm, _obs_rows(obs, np.array([0])), n_tan=2)


@lru_cache(maxsize=None)
def _inputs(case: str):
    """The inputs of each case, made once for this file's tests."""
    if case == "ega":
        return _ega_inputs()
    if case == "saturated":
        return _saturated_inputs()
    if case == "ground":
        return _rt_inputs(*_scan(ground=True))
    return _rt_inputs(*_scan(), bbt=case == "scan_bbt")


CASES = ("ega", "scan", "scan_bbt", "ground", "saturated")


def _rt_case(case: str):
    """The plain tangent pass against the jvp of the eager pass."""
    m, los, tan, args = _inputs(case)
    out, drad = rt_integrate_jvp_ref(*args)
    ref = m.integrate_eager(los)
    assert torch.equal(out.rad, ref.rad) and torch.equal(out.tau, ref.tau)
    R, n_tan = tan.tsurf.shape
    assert drad.shape == (R, m.ctl.nd, n_tan)
    G, W = los.u.shape[2], los.k.shape[2]
    got = tg.los_tangent_fields(tan, G, W)

    def rad(*fields):
        return m.integrate_eager(los._replace(**dict(zip(RT_FIELDS,
                                                         fields)))).rad
    for j in range(n_tan):
        _, jt = torch.func.jvp(
            rad, tuple(getattr(los, f) for f in RT_FIELDS),
            tuple(got[f][..., j].contiguous() for f in RT_FIELDS))
        scale = float(jt.abs().max())
        assert scale > 0
        np.testing.assert_allclose(drad[..., j].numpy(), jt.numpy(), rtol=0,
                                   atol=BAR * scale, err_msg=f"tangent {j}")
    return los


def test_rt_tangents_match_jvp_ega():
    _rt_case("ega")


@pytest.mark.parametrize("bbt", [False, True])
def test_rt_tangents_match_jvp_scan(bbt):
    _rt_case("scan_bbt" if bbt else "scan")


def test_rt_tangents_match_jvp_ground():
    los = _rt_case("ground")
    assert (los.tsurf[::2] > 0).all()


def test_rt_tangents_match_jvp_saturated_ray():
    _rt_case("saturated")


@pytest.mark.parametrize("case", CASES)
def test_rt_adjoint_matches_plain_version(case):
    """The kernels' algebra in plain PyTorch (records, the adjoint sweep
    to A, the contraction) against the plain forward-mode pass: the
    primal bit for bit, drad within 1e-12 of max|drad| (float64): the
    same sum in another order."""
    _m, _los, _tan, args = _inputs(case)
    out_r, drad_r = rt_integrate_jvp_ref(*args)
    out, drad = rt_jvp_adjoint_ref(*args)
    assert torch.equal(out.rad, out_r.rad) and torch.equal(out.tau, out_r.tau)
    scale = float(drad_r.abs().max())
    assert scale > 0 and drad.shape == drad_r.shape
    assert float((drad - drad_r).abs().max()) <= BAR * scale
