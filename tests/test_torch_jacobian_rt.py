"""The plain version of the RT pass's tangent kernel of
``kernel_autodiff`` (``forward.rt_integrate_jvp_ref``, plain version of
``csrc/ega_jvp_fast.cu``) against ``torch.func.jvp`` of
``forward.rt_integrate`` on the fast tables, float64 on the CPU, at 1e-12
of drad's largest |tangent|, with random LOS tangents at each field's
scale: on the ``ega`` golden's geometry, on a small limb scan with and
without the brightness conversion, with ground hits, and on the
flagship's lowest ray (tangent point 3 km), whose saturated channels take
the clamps and the ``ki >= lo`` guard of ``ops.ega.ega_eps_fast``; its
primal bit for bit ``rt_integrate``'s.  ``tests/
test_torch_jacobian_kernels.py`` has the tracer's.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from jurassic_torch import geometry as tg
from jurassic_torch.forward import ForwardModel, _obs_rows, rt_integrate_jvp_ref
from jurassic_torch.workloads import flagship
from test_torch_host_copies import golden_case
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)
from test_torch_jacobian_kernels import BAR, RT_FIELDS, _scan


def _rt_case(ctl, ft, atm, obs, bbt=False, seed=1, n_tan=5):
    """The eager fast model's LOS of a scan, random LOS tangents at each
    field's scale, and the plain tangent pass against the jvp of the
    eager pass."""
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
    out, drad = rt_integrate_jvp_ref(e.tbl, m.sr, m.st, m.nu, e.cc, e.window,
                                     los, tan, m.flags, m.ig_co2, m.ig_h2o,
                                     bbt)
    ref = m.integrate_eager(los)
    assert torch.equal(out.rad, ref.rad) and torch.equal(out.tau, ref.tau)
    assert drad.shape == (R, ctl.nd, n_tan)
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
    """The ``ega`` golden's geometry (its three gases and two channels on
    synthetic tables), NLOS cut to 60 with 20 km steps."""
    ctl, obs, atm = golden_case("ega", kernel="jax")
    ctl.nlos, ctl.rayds, ctl.raydz = 60, 20.0, 2.0
    obs = _obs_rows(obs, np.arange(0, obs.nr, 3)[:9])
    fm = ForwardModel(ctl, directory=str(Path(ctl.tblbase).parent),
                      device="cpu")
    _rt_case(ctl, fm.fast_tables, atm, obs)


@pytest.mark.parametrize("bbt", [False, True])
def test_rt_tangents_match_jvp_scan(bbt):
    _rt_case(*_scan(), bbt=bbt)


def test_rt_tangents_match_jvp_ground():
    los = _rt_case(*_scan(ground=True))
    assert (los.tsurf[::2] > 0).all()


def test_rt_tangents_match_jvp_saturated_ray():
    """The flagship's lowest ray on its 40 x 30 x 224 tables, 100
    channels, all four continua."""
    ctl, ft, atm, obs = flagship()
    tg.hydrostatic_atm(ctl, atm)
    _rt_case(ctl, ft, atm, _obs_rows(obs, np.array([0])), n_tan=2)
