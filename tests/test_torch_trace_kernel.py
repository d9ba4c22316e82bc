"""The tracer kernel's dispatch and binding, on the CPU (the kernel itself
runs in ``tests/test_torch_kernel_cuda.py`` on a card).

* On CPU tensors ``geometry.trace_rays`` is its plain version
  ``trace_rays_ref``, bit for bit, and ``ForwardModel.trace`` goes
  through it.
* The wrapper's checks (``ops.trace.check_inputs``) refuse a dtype, a
  shape or a layout the kernel cannot read, and the wrapper refuses a
  tensor off the card before it loads the library.
* ``_build.ENTRY_POINTS`` declares as many arguments as each C entry
  point's ``extern "C"`` signature in ``csrc/`` has, every pointer as a
  ``c_void_p``: passing a pointer as a 32-bit int would cut it.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from jurassic_torch import geometry as tg
from jurassic_torch.ops import _build
from jurassic_torch.ops import trace as ktrace
from jurassic_torch.workloads import small_limb, trace_branch

from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GEO = ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")


def _inputs(branch=None, dtype=torch.float64):
    ctl, _ft, atm, obs = small_limb(ng=4, nd=9, nr=12, nlos=40)
    if branch:
        trace_branch(branch, ctl, atm, obs)
    prof = tg.build_ray_profiles(ctl, atm, obs, dtype)
    return ctl, atm, obs, prof, {k: getattr(obs, k) for k in GEO}


@pytest.mark.parametrize("branch", [None, "one_level"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_dispatch_is_the_plain_version(branch, dtype):
    ctl, _atm, _obs, prof, geo = _inputs(branch, dtype)
    got = tg.trace_rays(ctl, prof, geo)
    ref = tg.trace_rays_ref(ctl, prof, geo)
    los, flag = tg.trace_rays_deferred(ctl, prof, geo)
    assert flag.dtype == torch.int32 and not flag.any()
    for f in tg.LosData._fields:
        for a in (getattr(got, f), getattr(los, f)):
            assert a.dtype == getattr(ref, f).dtype, f
            assert torch.equal(a, getattr(ref, f)), f


def test_forward_trace_on_the_cpu_is_the_plain_version():
    from jurassic_torch.forward import ForwardModel

    ctl, ft, atm, obs = small_limb(ng=4, nd=9, nr=12, nlos=40)
    m = ForwardModel(ctl, fast_tables=ft, device="cpu")
    los = m.trace(atm.copy(), obs)
    tg.hydrostatic_atm(ctl, atm)
    prof = tg.build_ray_profiles(ctl, atm, obs, m.dtype)
    ref = tg.trace_rays_ref(ctl, prof, {k: getattr(obs, k) for k in GEO})
    for f in tg.LosData._fields:
        assert torch.equal(getattr(los, f), getattr(ref, f)), f


def test_entry_flag_raises_the_plain_versions_error():
    tg.check_entry_flag(np.zeros(3))
    with pytest.raises(RuntimeError, match=tg.ENTRY_ERROR):
        tg.check_entry_flag(np.array([0.0, 1.0, 0.0]))


def _kernel_inputs(dtype=torch.float32):
    _ctl, _atm, obs, prof, _geo = _inputs(dtype=dtype)
    geo = torch.as_tensor(np.stack([getattr(obs, k) for k in GEO])).to(dtype)
    return prof._replace(nlev=prof.nlev.to(torch.int32)), geo


def test_check_accepts_the_kernels_inputs():
    for dt in (torch.float32, torch.float64):
        prof, geo = _kernel_inputs(dt)
        ktrace.check_inputs(prof, geo, 40)


@pytest.mark.parametrize("fault", ["float16", "noncontiguous", "shape",
                                   "nlev_int64", "geo_shape", "nlos"])
def test_check_refuses(fault):
    prof, geo = _kernel_inputs()
    nlos = 40
    if fault == "float16":
        prof = prof._replace(**{f: getattr(prof, f).half() for f in
                                ("z", "p", "t", "q", "k", "zmin", "zmax")})
        geo = geo.half()
    elif fault == "noncontiguous":
        prof = prof._replace(p=prof.p.t().contiguous().t())
    elif fault == "shape":
        prof = prof._replace(q=prof.q[:, :, :-1].contiguous())
    elif fault == "nlev_int64":
        prof = prof._replace(nlev=prof.nlev.long())
    elif fault == "geo_shape":
        geo = geo[:5].contiguous()
    else:
        nlos = 2
    with pytest.raises(ValueError):
        ktrace.check_inputs(prof, geo, nlos)


def test_wrapper_refuses_cpu_tensors_before_loading(monkeypatch):
    def no_load():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "load_library", no_load)
    ctl, _atm, _obs, prof, geo = _inputs(dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ktrace.trace_rays_cuda(prof, geo, ctl.rayds, ctl.raydz, ctl.refrac,
                               ctl.nlos)


C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "double": ctypes.c_double,
           "longlong": ctypes.c_longlong}


def _c_signatures():
    """{entry point: [ctypes type per parameter]} parsed from the
    ``extern "C"`` definitions in csrc/, macros expanded."""
    text = "\n".join(f.read_text() for f in _build.sources())
    text = re.sub(r"//[^\n]*", "", text)
    macros = {m.group(1): m.group(2).replace("\\\n", " ") for m in
              re.finditer(r"#define\s+(\w+)\s+((?:[^\n]*\\\n)*[^\n]*)",
                          text)}
    sigs = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
        params = m.group(2)
        for name, body in macros.items():
            params = re.sub(rf"\b{name}\b", body, params)
        types = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()
            if "*" in words:
                types.append(C_TYPES["void*"])
                continue
            base = " ".join(w for w in words[:-1] if w != "const")
            types.append(C_TYPES[base.replace("long long", "longlong")])
        sigs[m.group(1)] = types
    return sigs


@pytest.mark.parametrize("entry", sorted(_build.ENTRY_POINTS))
def test_entry_point_types_match_the_c_signature(entry):
    sigs = _c_signatures()
    assert set(sigs) == set(_build.ENTRY_POINTS)
    assert _build.ENTRY_POINTS[entry] == sigs[entry]
