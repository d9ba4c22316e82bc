"""The RT pass's plain tangent statements on exact tables, and the eager
loop of CPU models, float64 on the CPU.

* ``forward.rt_integrate_jvp_ref`` on exact tables against
  ``torch.func.jvp`` of the eager pass at 1e-12 of max|drad|, its primal
  bit for bit; ``ops.ega_jvp.rt_jvp_adjoint_ref`` (the record kernel's
  algebra) against it at 1e-12: a small limb scan, with and without the
  brightness conversion, on exact tables with one decreasing eps row.
* A CPU model of ``KERNEL = exact|jax`` runs the eager loop (the RT
  kernel runs on CUDA tensors only and refuses others);
  ``tests/test_torch_ega_eager.py`` holds that loop to JAX's
  ``rt_integrate`` at 1e-12.
"""
import numpy as np
import pytest
import torch

from jurassic_torch import geometry as tg
from jurassic_torch.forward import ForwardModel, rt_integrate_jvp_ref
from jurassic_torch.models.synthetic import fast_to_ega_tables
from jurassic_torch.ops.ega_jvp import rt_jvp_adjoint_ref
from jurassic_torch.workloads import small_limb
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)
from test_torch_jacobian_kernels import BAR, RT_FIELDS


def _exact_scan(bbt: bool):
    """(model, LOS, LOS tangents, the plain tangent pass's arguments) of a
    small limb scan on exact tables with one decreasing eps row, float64
    on the CPU."""
    ctl, ft, atm, obs = small_limb(ng=3, nd=4, nr=6, nlos=48)
    tg.hydrostatic_atm(ctl, atm)
    tb = fast_to_ega_tables(ft)
    eps = np.array(tb.eps)
    eps[0, 3, 2, 10, 1], eps[0, 3, 2, 12, 1] = eps[0, 3, 2, 12, 1], \
        eps[0, 3, 2, 10, 1]
    ctl.kernel, ctl.write_bbt = "exact", int(bbt)
    m = ForwardModel(ctl, tb._replace(eps=eps), device="cpu",
                     dtype=torch.float64)
    assert int((m.eager_tables().tbl.row_monotone != 3).sum()) == 1
    los = m.trace(atm, obs)
    R, S = los.ds.shape
    G, W = los.u.shape[2], los.k.shape[2]
    rng = np.random.default_rng(2)
    scale = [los.p, los.t] + [los.q] * G + [los.k] * W + [los.u] * G \
        + [los.ds]
    seg = rng.standard_normal((R, S, 3 + 2 * G + W, 3)) * np.array(
        [float(x.abs().max()) * 1e-2 + 1e-30 for x in scale])[:, None]
    tan = tg.LosTangents(torch.from_numpy(seg),
                         torch.from_numpy(rng.standard_normal((R, 3))))
    e = m.eager_tables()
    args = (e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, tan, m.flags,
            m.ig_co2, m.ig_h2o, bbt)
    return m, los, tan, args


@pytest.mark.parametrize("bbt", [False, True])
def test_exact_rt_tangents_match_jvp(bbt):
    m, los, tan, args = _exact_scan(bbt)
    out, drad = rt_integrate_jvp_ref(*args)
    ref = m.integrate_eager(los)
    assert torch.equal(out.rad, ref.rad) and torch.equal(out.tau, ref.tau)
    G, W = los.u.shape[2], los.k.shape[2]
    got = tg.los_tangent_fields(tan, G, W)

    def rad(*fields):
        return m.integrate_eager(los._replace(**dict(zip(RT_FIELDS,
                                                         fields)))).rad
    for j in range(tan.tsurf.shape[1]):
        _, jt = torch.func.jvp(
            rad, tuple(getattr(los, f) for f in RT_FIELDS),
            tuple(got[f][..., j].contiguous() for f in RT_FIELDS))
        scale = float(jt.abs().max())
        assert scale > 0
        np.testing.assert_allclose(drad[..., j].numpy(), jt.numpy(), rtol=0,
                                   atol=BAR * scale, err_msg=f"tangent {j}")
    out_a, drad_a = rt_jvp_adjoint_ref(*args)
    assert torch.equal(out_a.rad, out.rad) and torch.equal(out_a.tau, out.tau)
    assert float((drad_a - drad).abs().max()) <= \
        BAR * float(drad.abs().max())


@pytest.mark.parametrize("kernel", ["exact", "jax"])
def test_cpu_models_run_the_eager_loop(kernel):
    """On the CPU ``integrate`` (and ``formod``) runs the eager loop,
    bit for bit ``integrate_eager``, and launches no RT kernel; the RT
    kernel's wrapper refuses CPU tensors.  The package sizing follows the
    route: the eager loop's per-step rows on the CPU, the RT kernel's
    outputs only on a card (``ray_terms("kernel")``)."""
    from jurassic_torch.ops import ega_rt
    ctl, ft, atm, obs = small_limb(ng=3, nd=5, nr=6)
    ctl.kernel = kernel
    tb = fast_to_ega_tables(ft) if kernel == "exact" else None
    m = ForwardModel(ctl, tb, fast_tables=ft, device="cpu")
    want = "exact" if kernel == "exact" else "fast"
    assert m.pass_mode() == m.kernel_mode == want
    n0 = ega_rt.LAUNCHES
    los = m.trace(atm.copy(), obs.copy())
    out = m.integrate(los)
    assert m.last_variant == want and ega_rt.LAUNCHES == n0
    ref = m.integrate_eager(los)
    assert torch.equal(out.rad, ref.rad) and torch.equal(out.tau, ref.tau)
    with pytest.raises(ValueError, match="CUDA tensors"):
        m.integrate_kernel(los)
    D = ctl.nd
    assert m.ray_terms("kernel")["step"] == (2 * D * 8, 0)
    assert sum(m.ray_terms()["step"]) > sum(m.ray_terms("kernel")["step"])
