"""The tracer kernel's dispatch and binding, on the CPU (the kernel itself
runs in ``tests/test_torch_kernel_cuda.py`` on a card).

* On CPU tensors ``geometry.trace_rays`` is its plain version
  ``trace_rays_ref``, bit for bit, and ``ForwardModel.trace`` goes
  through it.
* The wrapper's checks (``ops.trace.check_inputs``) refuse a dtype, a
  shape or a layout the kernel cannot read, and the wrapper refuses a
  tensor off the card before it loads the library.
* ``ops.trace.shared_memory_bytes`` takes a ray's shared memory up to
  one block's limit and refuses it beyond, naming the limit (the bytes
  themselves are the kernel library's count, held at the flagship, the
  goldens' largest shape and the limit on a card).
* The kernel's interval search, a count by warp vote over chunks of 32
  levels, mirrored in NumPy, is ``geometry._interval_index`` on seeded
  grids with padding, ties, non-monotone levels and one-level windows:
  the argument that keeps the index, and so the bits, the same.
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
from jurassic_torch.workloads import (TRACE_EDGE_SHAPES, profiles_to,
                                     small_limb, trace_branch,
                                     trace_edge_case)

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


class _SmemLibrary:
    """Stands in for the kernel library: ``jt_trace_smem_bytes`` reports
    ``n`` bytes."""

    def __init__(self, n):
        self.n, self.calls = n, []

    def jt_trace_smem_bytes(self, L, G, W, nlos, is_double, out):
        self.calls.append((L, G, W, nlos, is_double))
        ctypes.c_longlong.from_address(out).value = self.n
        return 0


@pytest.mark.parametrize("over", [0, 1])
def test_shared_memory_up_to_the_limit(monkeypatch, over):
    """A ray's shared memory is taken up to one block's 232,448 bytes and
    refused beyond with a ValueError that names the limit; the library is
    asked in the kernel's dtype."""
    lib = _SmemLibrary(ktrace.SMEM_LIMIT + over)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    if over:
        with pytest.raises(ValueError, match="232448 bytes"):
            ktrace.shared_memory_bytes(92, 30, 1, 3914, torch.float64)
    else:
        assert ktrace.shared_memory_bytes(92, 30, 1, 3913, torch.float64) \
            == 232448
    assert lib.calls == [(92, 30, 1, 3913 + over, 1)]


@pytest.mark.parametrize("shape", TRACE_EDGE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_check_accepts_the_edge_shapes(shape):
    """Every edge shape of the card tests (G = 0 and W = 0 among them)
    passes the wrapper's checks in both dtypes, padded as
    ``build_ray_profiles`` pads."""
    ctl, prof, geo = trace_edge_case(*shape)
    L, G, W, R, nlos, _grid = shape
    assert prof.q.shape == (R, G, L) and prof.k.shape == (R, W, L)
    assert prof.short == bool((prof.nlev < 2).any())
    for dt in (torch.float32, torch.float64):
        p = profiles_to(prof, dt, "cpu")
        p = p._replace(nlev=p.nlev.to(torch.int32))
        g = torch.as_tensor(np.stack([geo[k] for k in GEO])).to(dt)
        ktrace.check_inputs(p, g, nlos)


def vote_index(z, nlev, z0):
    """The kernel's ``interval_index``: lane l of the warp tests level
    c + l of each chunk c of 32 (false beyond L), the ballot's bits are
    counted, the chunks' counts summed; then the clamp."""
    L = z.shape[0]
    below = 0
    for c in range(0, L, 32):
        lanes = c + np.arange(32)
        pred = (lanes < L) & (z[np.minimum(lanes, L - 1)] <= z0)
        ballot = sum(1 << lane for lane in np.nonzero(pred)[0].tolist())
        below += bin(ballot).count("1")
    return min(max(below - 1, 0), nlev - 2)


@pytest.mark.parametrize("shape", TRACE_EDGE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_vote_count_is_the_interval_index(shape):
    ctl, prof, _geo = trace_edge_case(*shape, seed=3)
    R = min(prof.z.shape[0], 12)
    z, nlev = prof.z[:R].numpy(), prof.nlev[:R].numpy()
    rng = np.random.default_rng(4)
    # altitudes between, below and above the levels, the levels
    # themselves (ties at equality) and NaN
    z0 = np.concatenate([rng.uniform(-10.0, 90.0, (R, 6)),
                         z[:, rng.integers(0, z.shape[1], 4)],
                         np.full((R, 1), np.nan)], axis=1)
    ref = tg._interval_index(prof._replace(z=prof.z[:R],
                                           nlev=prof.nlev[:R]),
                             torch.from_numpy(z0)).numpy()
    got = np.array([[vote_index(z[r], nlev[r], v) for v in z0[r]]
                    for r in range(R)])
    np.testing.assert_array_equal(got, ref)


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
