"""The plain version of the tracer's tangent kernel of
``kernel_autodiff`` against ``torch.func.jvp`` of the tracer, float64 on
the CPU, at 1e-12 of each output's largest |tangent|.

* ``geometry.trace_rays_jvp_ref`` (plain version of ``csrc/
  trace_rays_jvp.cu``) against the jvp of ``geometry.trace_rays_ref`` in
  every field of ``LosTangents``, random profile tangents at the atm
  points, on a small limb scan (9 rays, NLOS 60: every ray stops at the
  top and then repeats its fixed point) in each branch of
  ``workloads.TRACE_BRANCHES`` (REFRAC 0, RAYDZ 0, an observer inside,
  never-traced rays, one-level windows) and with ground hits (the
  surface temperature's tangent); its primal bit for bit the plain
  tracer's.
``tests/test_torch_jacobian_rt.py`` holds the RT pass's plain tangent
version to ``torch.func.jvp``, ``tests/test_torch_jacobian_chain.py`` the
chained Jacobian to JAX's and to ``kernel_autodiff_jacfwd``.
"""
import numpy as np
import pytest
import torch

from jurassic_torch import geometry as tg
from jurassic_torch.workloads import TRACE_BRANCHES, small_limb, trace_branch
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")
RT_FIELDS = ("p", "t", "q", "k", "u", "ds", "tsurf")  # what the RT reads
N_TAN = 5
BAR = 1e-12


def _scan(branch=None, ground=False, nd=6):
    """(ctl, fast tables, atm, obs) of a 9-ray limb scan, NLOS 60, with
    HYDZ applied; ``ground`` lowers every other view point below the
    ground at REFRAC 0."""
    ctl, ft, atm, obs = small_limb(ng=3, nd=nd, nr=9, nlos=60)
    if branch:
        trace_branch(branch, ctl, atm, obs)
    if ground:
        ctl.refrac = 0
        obs.vpz[::2] = -20.0
    tg.hydrostatic_atm(ctl, atm)
    return ctl, ft, atm, obs


def _profile_tangents(atm, G, W, seed=0):
    """Random tangents of p, t, q, k at the atm points, [N, 2 + G + W,
    n], each field at its own scale."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((atm.npts, 2 + G + W, N_TAN))
    d[:, 0] *= np.abs(atm.p).max() * 1e-2
    d[:, 2:2 + G] *= np.abs(atm.q).max() * 1e-2
    return torch.from_numpy(d)


@pytest.mark.parametrize("case", (None, "ground") + TRACE_BRANCHES)
def test_tracer_tangents_match_jvp(case):
    ctl, _ft, atm, obs = _scan(branch=None if case in (None, "ground")
                               else case, ground=case == "ground")
    G, W = ctl.ng, ctl.nw
    prof = tg.build_ray_profiles(ctl, atm, obs, torch.float64)
    gi = torch.from_numpy(tg.ray_window_indices(atm, obs)[2])
    geo = {k: getattr(obs, k) for k in GEO}
    d = _profile_tangents(atm, G, W)
    los, tan, flag = tg.trace_rays_jvp(ctl, prof, tg.ProfileTangents(d, gi),
                                       geo)
    assert not flag.any()
    ref = tg.trace_rays_ref(ctl, prof, geo)
    for f in tg.LosData._fields:
        a, b = getattr(los, f), getattr(ref, f)
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()), f
    assert tan.seg.shape == (obs.nr, ctl.nlos, 3 + 2 * G + W, N_TAN)
    got = tg.los_tangent_fields(tan, G, W)
    base = [torch.from_numpy(a) for a in (atm.p, atm.t, atm.q, atm.k)]

    def fields(p, t, q, k):
        pr = prof._replace(p=p[gi], t=t[gi], q=q[:, gi].movedim(0, 1),
                           k=k[:, gi].movedim(0, 1))
        out = tg.trace_rays_ref(ctl, pr, geo)
        return tuple(getattr(out, f) for f in RT_FIELDS)
    for j in range(N_TAN):
        dirs = (d[:, 0, j], d[:, 1, j], d[:, 2:2 + G, j].T.contiguous(),
                d[:, 2 + G:, j].T.contiguous())
        _, jt = torch.func.jvp(fields, tuple(base), dirs)
        for f, ref_t in zip(RT_FIELDS, jt):
            scale = ref_t.abs().max()
            # straight rays carry no geometry tangent, and only ground
            # hits a surface temperature's
            if (f != "ds" or ctl.refrac) and (f != "tsurf"
                                              or case == "ground"):
                assert scale > 0, f
            np.testing.assert_allclose(got[f][..., j].numpy(), ref_t.numpy(),
                                       rtol=0, atol=BAR * float(scale),
                                       err_msg=f"{case} {f} tangent {j}")
    if case == "ground":
        assert (los.tsurf[::2] > 0).all()


# The RT tangent kernel's decisions on the tables (``ops.ega``): whether
# the (p, T) axes are bitwise the same in every channel, and then the
# bracket it takes once per (segment, gas) from channel 0.

def _tables(name: str):
    from jurassic_torch.workloads import flagship
    if name == "flagship":
        return flagship()[1]
    return small_limb(ng=4, nd=9, nr=1)[1]


@pytest.mark.parametrize("field", [None, "p", "t", "nt"])
@pytest.mark.parametrize("tables", ["flagship", "small_limb"])
def test_axes_uniform_decision(tables, field):
    """True on the synthetic tables, whose channels share their axes;
    False once one channel's axis moves by one ulp (or one count by
    one), decided on upload."""
    from jurassic_torch.ops.ega import axes_uniform, fast_tables_to_device
    ft = _tables(tables)
    if field is not None:
        a = getattr(ft, field).copy()
        at = (0, 1) + (2,) * (a.ndim - 3) + (a.shape[-1] - 1,)
        a[at] = (a[at] - 1 if field == "nt"
                 else np.nextafter(a[at], np.inf))
        ft = ft._replace(**{field: a})
    assert axes_uniform(ft) == (field is None)
    assert fast_tables_to_device(ft, "cpu").uniform == (field is None)


@pytest.mark.parametrize("tables", ["flagship", "small_limb"])
def test_shared_bracket_equals_count_index(tables):
    """On channel-uniform axes the record kernel's one bracket of a
    (segment, gas), channel 0's count searches, is every channel's
    ``ops.ega._brackets`` (``_count_index``), at points inside, on and
    outside the axes."""
    from jurassic_torch.ops.ega import _brackets, fast_tables_to_device
    from jurassic_torch.ops.ega_jvp import shared_brackets
    tbl = fast_tables_to_device(_tables(tables), "cpu")
    assert tbl.uniform
    G, D = tbl.np_.shape
    rng = np.random.default_rng(3)
    p = np.exp(rng.uniform(np.log(1e-4), np.log(2e3), 300))
    t = rng.uniform(140.0, 350.0, 300)
    p[:20] = tbl.p[0, 0, rng.integers(0, tbl.p.shape[2], 20)].numpy()
    t[20:40] = tbl.t[0, 0, 0, rng.integers(0, tbl.t.shape[3], 20)].numpy()
    p, t = torch.from_numpy(p), torch.from_numpy(t)
    ipr, it0, it1 = shared_brackets(tbl, p, t)
    _, _, ipr_d, _, _, _, _, it0_d, it1_d, _, _ = _brackets(tbl, p, t, G, D)
    for a, b in ((ipr, ipr_d), (it0, it0_d), (it1, it1_d)):
        assert torch.equal(a.unsqueeze(-1).expand_as(b), b)
