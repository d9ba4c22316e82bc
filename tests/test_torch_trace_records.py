"""The plain statement of the Jacobian's two tracer kernels
(``csrc/trace_rays_jvp.cu``), float64 on the CPU.

* ``geometry.trace_step_records_ref`` (the record kernel's step and ray
  records) composed with ``geometry.trace_tangents_from_records_ref`` (the
  tangent kernel's rules applied to them) against
  ``geometry.trace_rays_jvp_ref`` in every field of ``LosTangents``, at
  1e-12 of each field's max|tangent|: a small limb scan (9 rays, NLOS 60)
  in each branch of ``workloads.TRACE_BRANCHES`` and with ground hits, and
  every 30th flagship ray (37 rays, NLOS 400);
* the records' primal is the plain tracer's (the step altitudes bit for
  bit ``trace_rays_ref``'s), and a stopped ray whose state repeats the
  last computed step's input repeats that step's record bit for bit: the
  record kernel writes the record again without running the step;
* the record layout named in ``geometry.TRACE_RECORD_FIELDS`` is the one
  ``jrec`` lays out in ``csrc/trace_common.cuh``;
* the kernels' wrappers refuse CPU tensors before loading the library.
The card holds the kernels to these statements (``chip_smoke.py``,
``tests/test_torch_kernel_cuda.py``).
"""
import re

import numpy as np
import pytest
import torch

from jurassic_torch import geometry as tg
from jurassic_torch.forward import _obs_rows
from jurassic_torch.ops import _build
from jurassic_torch.workloads import (TRACE_BRANCHES, flagship, small_limb,
                                      trace_branch)
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")
N_TAN = 5
BAR = 1e-12


def _case(case):
    """(ctl, profiles, profile tangents, geometry) of a case: the small
    limb scan in a branch (None: as it is; "ground": every other view
    point below the ground at REFRAC 0), or every 30th flagship ray."""
    if case == "flagship/30":
        ctl, _ft, atm, obs = flagship()
        obs = _obs_rows(obs, slice(0, None, 30))
    else:
        ctl, _ft, atm, obs = small_limb(ng=3, nd=6, nr=9, nlos=60)
        if case == "ground":
            ctl.refrac = 0
            obs.vpz[::2] = -20.0
        elif case:
            trace_branch(case, ctl, atm, obs)
    tg.hydrostatic_atm(ctl, atm)
    G, W = ctl.ng, ctl.nw
    prof = tg.build_ray_profiles(ctl, atm, obs, torch.float64)
    gi = torch.from_numpy(tg.ray_window_indices(atm, obs)[2])
    d = np.random.default_rng(0).standard_normal((atm.npts, 2 + G + W, N_TAN))
    d[:, 0] *= np.abs(atm.p).max() * 1e-2
    d[:, 2:2 + G] *= np.abs(atm.q).max() * 1e-2
    geo = {k: getattr(obs, k) for k in GEO}
    return ctl, prof, tg.ProfileTangents(torch.from_numpy(d), gi), geo


CASES = (None, "ground") + TRACE_BRANCHES + ("flagship/30",)


def _repeats(rec: tg.TraceRecords) -> torch.Tensor:
    """[R, NLOS] True where the record kernel repeats the last computed
    step (its rule in ``csrc/trace_rays_jvp.cu``, after the tracer
    kernel's): from step 2 on, the ray stopped before this step and the
    last, and this step's input position, direction, last point and its
    altitude bit for bit the last step's."""
    f = tg.trace_record_fields(rec.step)
    bit = lambda name: (f["flags"][..., 0].to(torch.int64)
                        >> tg.TRACE_RECORD_FLAGS.index(name)) & 1 == 1
    esc = bit("escaped").unsqueeze(-1)
    point = torch.where(esc, f["xe"], f["x0"])          # the clipped point
    stopped = (rec.ray[:, 2:3] == 0) | (
        torch.cumsum(bit("stopping").to(torch.int64), dim=1)
        - bit("stopping").to(torch.int64) > 0)          # before the step
    same = lambda a: (a[:, 2:] == a[:, 1:-1]).all(-1)       # ip vs ip - 1
    before = lambda a: (a[:, 1:-1] == a[:, :-2]).all(-1)    # ip - 1, ip - 2
    rep = (stopped[:, 2:] & stopped[:, 1:-1] & same(f["x0"]) & same(f["ex0"])
           & before(point) & before(f["z"]))
    return torch.cat([torch.zeros_like(rep[:, :2]), rep], dim=1)


@pytest.mark.parametrize("case", CASES)
def test_records_to_tangents_match_plain_version(case):
    ctl, prof, ptan, geo = _case(case)
    G, W = ctl.ng, ctl.nw
    los, tan = tg.trace_rays_jvp_ref(ctl, prof, ptan, geo)
    rec = tg.trace_step_records_ref(ctl, prof, geo)
    R, S = prof.z.shape[0], ctl.nlos
    assert rec.step.shape == (R, S, sum(w for _, w in
                                        tg.TRACE_RECORD_FIELDS))
    assert rec.ray.shape == (R, len(tg.TRACE_RAY_FIELDS))
    # the primal is the plain tracer's
    f = tg.trace_record_fields(rec.step)
    assert torch.equal(f["z"][..., 0], los.z)
    assert torch.equal(f["ex0"][:, 1:], torch.where(
        (f["flags"][:, :-1, :1].to(torch.int64)
         >> tg.TRACE_RECORD_FLAGS.index("advance")) & 1 == 1,
        f["ex1"][:, :-1], f["ex0"][:, :-1]))
    got = tg.los_tangent_fields(
        tg.trace_tangents_from_records_ref(ctl, prof, ptan, los, rec), G, W)
    for k, ref in tg.los_tangent_fields(tan, G, W).items():
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=0,
                                   atol=BAR * scale, err_msg=f"{case} {k}")
    # a repeated step's record is the last computed step's, bit for bit
    rep = _repeats(rec)
    if case in (None, "flagship/30"):
        assert int(rep.sum()) > R          # most rays reach a fixed point
    prev = torch.cat([rec.step[:, :1], rec.step[:, :-1]], dim=1)
    same = (rec.step == prev) | (torch.isnan(rec.step) & torch.isnan(prev))
    assert bool(same.all(-1)[rep].all())


def _enum(text: str, first: str) -> dict:
    """{name: value} of the C enum in ``text`` whose first name is
    ``first`` (values given or counted on)."""
    body = re.search(r"enum\s*:\s*\w+\s*\{\s*" + first + r"\b([^}]*)\}",
                     text).group(0)
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:-1])
    out, nxt = {}, 0
    for item in body.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, val = item.partition("=")
        nxt = int(val) if val.strip() else nxt
        out[name.strip()] = nxt
        nxt += 1
    return out


def test_record_layout_is_the_library_s():
    """``jrec``'s offsets, per-altitude values, flag bits and ray record
    in ``csrc/trace_common.cuh`` are those the plain statement names."""
    text = (_build.CSRC / "trace_common.cuh").read_text()
    offsets = _enum(text, "X0")
    at = 0
    for name, width in tg.TRACE_RECORD_FIELDS:
        if name == "pad":
            break
        assert offsets[name.upper()] == at, name
        at += width
    assert offsets["LEN"] == sum(w for _, w in tg.TRACE_RECORD_FIELDS)
    assert offsets["OWN"] + 5 * len(tg.TRACE_OWN_FIELDS) == offsets["LEN"] - 1
    own = _enum(text, "O_T")
    assert [own["O_" + k.upper()] for k in tg.TRACE_OWN_FIELDS] == \
        list(range(len(tg.TRACE_OWN_FIELDS)))
    assert own["O_LEN"] == len(tg.TRACE_OWN_FIELDS)
    flags = _enum(text, "F_DS_VAR")
    assert [flags["F_" + k.upper()] for k in tg.TRACE_RECORD_FLAGS] == \
        [1 << i for i in range(len(tg.TRACE_RECORD_FLAGS))]
    ray = _enum(text, "R_CORR_IDX")
    assert [ray["R_" + k.upper()] for k in tg.TRACE_RAY_FIELDS[:3]] == \
        [0, 1, 2]
    assert ray["R_LEN"] == len(tg.TRACE_RAY_FIELDS)


def test_wrappers_refuse_cpu_tensors_before_loading(monkeypatch):
    from jurassic_torch.ops import trace_jvp

    def no_load():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "load_library", no_load)
    ctl, prof, ptan, geo = _case("one_level")
    args = (ctl.rayds, ctl.raydz, bool(ctl.refrac), ctl.nlos)
    with pytest.raises(ValueError, match="CUDA"):
        trace_jvp.trace_jvp_records_cuda(prof, geo, *args)
    los = tg.trace_rays_ref(ctl, prof, geo)
    rec = tg.trace_step_records_ref(ctl, prof, geo)
    with pytest.raises(ValueError, match="CUDA"):
        trace_jvp.trace_jvp_tangents_cuda(prof, ptan, los, rec, ctl.refrac)
    with pytest.raises(ValueError, match="CUDA"):
        trace_jvp.trace_rays_jvp_cuda(prof, ptan, geo, *args)
