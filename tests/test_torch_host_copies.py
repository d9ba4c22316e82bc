"""The port's own copies of the NumPy host modules against the JAX
package's originals, and the converters that carry objects of one class
family across to the other.

The two packages have distinct ``Ctl``/``Atm``/``Obs``/``EgaTables``/
``FastTables`` classes.  The parity tests build inputs once, on the JAX
side or from files, and hand the port NumPy copies through the helpers
below (``port_ctl`` ... ``small_limb_pair``): the port never sees a JAX
class.  Everything here is NumPy on both sides, so every comparison is
exact (equal arrays, equal fields, equal bytes of written files).
"""
import dataclasses
import importlib
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

import jurassic_tpu._compat_random as jrand
import jurassic_tpu.climatology as jclim
import jurassic_tpu.config as jcfg
import jurassic_tpu.constants as jconst
import jurassic_tpu.interp_atm as jinterp
import jurassic_tpu.io_tab as jio
import jurassic_tpu.models.geometry_gen as jgeo
import jurassic_tpu.models.synthetic as jsyn
import jurassic_tpu.native as jnative
import jurassic_tpu.ops.planck as jplanck
import jurassic_tpu.retrieval as jret
import jurassic_tpu.tables as jtab
import jurassic_tpu.utils  # noqa: F401  (loads utils.timer)
import jurassic_torch._compat_random as trand
import jurassic_torch.climatology as tclim
import jurassic_torch.config as tcfg
import jurassic_torch.constants as tconst
import jurassic_torch.interp_atm as tinterp
import jurassic_torch.io_tab as tio
import jurassic_torch.models.geometry_gen as tgeo
import jurassic_torch.models.synthetic as tsyn
import jurassic_torch.native as tnative
import jurassic_torch.ops.planck as tplanck
import jurassic_torch.retrieval as tret
import jurassic_torch.tables as ttab
import jurassic_torch.utils  # noqa: F401

# ``utils`` re-exports the function ``timer`` over the submodule's name
jtimer = sys.modules["jurassic_tpu.utils.timer"]
ttimer = sys.modules["jurassic_torch.utils.timer"]

REPO = Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"


# ---------------------------------------------------------------------------
# Converters used by the other tests/test_torch_*.py files


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for torch while a test runs.  The tests' tensors
    are small, and the suite runs in parallel worker processes: there
    torch's default of one spinning OpenMP thread per core oversubscribes
    the CPU and slows a test several times over.  Modules that import
    this fixture get it too."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def fields(obj) -> dict:
    """Field dict of a dataclass or NamedTuple instance."""
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}
    return obj._asdict()


def port_ctl(jctl):
    return tcfg.ctl_from_fields(dataclasses.asdict(jctl))


def port_atm(jatm):
    return tio.atm_from_fields(fields(jatm))


def port_obs(jobs):
    return tio.obs_from_fields(fields(jobs))


def port_fast_tables(jft):
    return ttab.fast_tables_from_fields(jft._asdict())


def small_limb_pair(ng, nd, nr, nlos=48, rayds=50.0, raydz=5.0,
                    n_p=8, n_t=5, n_k=48):
    """((ctl, ft, atm, obs) of the JAX package, the same of the port):
    the small synthetic limb scan of ``jurassic_torch.workloads.
    small_limb`` built once with the JAX package's generators and
    carried across as NumPy copies."""
    ctl = jsyn.synthetic_ctl(ng=ng, nd=nd)
    ctl.nlos = nlos
    ctl.rayds, ctl.raydz = rayds, raydz
    ctl.ctm_co2 = ctl.ctm_h2o = ctl.ctm_n2 = ctl.ctm_o2 = 1
    ft = jsyn.synthetic_fast_tables(ctl, n_p=n_p, n_t=n_t, n_k=n_k)
    atm, obs = jsyn.synthetic_atm(ctl), jsyn.limb_workload(ctl, nr)
    return ((ctl, ft, atm, obs),
            (port_ctl(ctl), port_fast_tables(ft), port_atm(atm),
             port_obs(obs)))


def golden_case(case, mod_cfg=tcfg, mod_io=tio, **over):
    """(ctl, obs, atm) of tests/goldens/<case> read by one package's own
    readers (the port's by default)."""
    d = GOLD / case
    ctl = mod_cfg.read_ctl(
        ["formod", str(next(d.glob("*.ctl"))), "o", "a", "r"], verbose=False)
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    for k, v in over.items():
        setattr(ctl, k, v)
    return ctl, mod_io.read_obs(d / "obs.tab", ctl), \
        mod_io.read_atm(d / "atm.tab", ctl)


def assert_same_fields(got, ref, what=""):
    got, ref = fields(got), fields(ref)
    assert got.keys() == ref.keys(), what
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, (what, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
        else:
            assert got[k] == v, (what, k)


# ---------------------------------------------------------------------------
# The copies against the originals

PAIRS = {"constants": (jconst, tconst), "config": (jcfg, tcfg),
         "io_tab": (jio, tio), "tables": (jtab, ttab),
         "ops.planck": (jplanck, tplanck), "native": (jnative, tnative),
         "models.synthetic": (jsyn, tsyn),
         "models.geometry_gen": (jgeo, tgeo), "utils.timer": (jtimer, ttimer),
         "interp_atm": (jinterp, tinterp), "climatology": (jclim, tclim),
         "_compat_random": (jrand, trand)}
CLIS = ("_common", "brightness", "climatology", "formod", "limb",
        "memoryinfo", "nadir", "obs2spec", "planck", "strhash", "timeconv")
for _n in CLIS:
    PAIRS[f"cli.{_n}"] = (importlib.import_module(f"jurassic_tpu.cli.{_n}"),
                          importlib.import_module(f"jurassic_torch.cli.{_n}"))


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", mod.__name__) == mod.__name__}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_copy_has_every_public_name(name):
    """Every public name the original defines exists in the copy, with
    the same signature (callables) or the same value (constants)."""
    jmod, tmod = PAIRS[name]
    for n in sorted(_public(jmod)):
        assert hasattr(tmod, n), f"{name}.{n} missing in the port"
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if callable(jv) and not inspect.isclass(jv):      # lru_cache
            jv, tv = inspect.unwrap(jv), inspect.unwrap(tv)
        if inspect.isfunction(jv):
            assert str(inspect.signature(jv)) == str(inspect.signature(tv)), n
        elif inspect.isclass(jv):
            if dataclasses.is_dataclass(jv):
                assert [(f.name, f.type) for f in dataclasses.fields(jv)] \
                    == [(f.name, f.type) for f in dataclasses.fields(tv)], n
            elif hasattr(jv, "_fields"):
                assert jv._fields == tv._fields, n
        else:
            assert jv == tv, n


def test_retrieval_pack_half_is_copied():
    for n in ("IDXP", "IDXT", "idxq", "idxk", "idx2name", "atm2x", "x2atm",
              "obs2y", "y2obs"):
        assert hasattr(tret, n) and hasattr(jret, n), n
    ctl_t, obs_t, atm_t = golden_case("ega", retq_zmin=[0.0] * 3,
                                      retq_zmax=[50.0] * 3)
    ctl_j, obs_j, atm_j = golden_case("ega", jcfg, jio,
                                      retq_zmin=[0.0] * 3,
                                      retq_zmax=[50.0] * 3)
    for a, b in zip(tret.atm2x(ctl_t, atm_t), jret.atm2x(ctl_j, atm_j)):
        np.testing.assert_array_equal(a, b)
    assert tret.atm2x(ctl_t, atm_t)[0].size > 0
    for a, b in zip(tret.obs2y(ctl_t, obs_t), jret.obs2y(ctl_j, obs_j)):
        np.testing.assert_array_equal(a, b)
    assert [tret.idx2name(ctl_t, i) for i in range(5)] \
        == [jret.idx2name(ctl_j, i) for i in range(5)]


def test_continua_data_is_a_byte_copy():
    a = REPO / "jurassic_tpu" / "data" / "continua.npz"
    b = REPO / "jurassic_torch" / "data" / "continua.npz"
    assert a.read_bytes() == b.read_bytes()


def test_climatology_data_is_a_byte_copy():
    a = REPO / "jurassic_tpu" / "data" / "climatology.npz"
    b = REPO / "jurassic_torch" / "data" / "climatology.npz"
    assert a.read_bytes() == b.read_bytes()


def test_climatology_matches():
    """climatology() fills the same atmosphere, warning lines included
    (an emitter without a climatology table)."""
    ctl_j, _o, atm_j = golden_case("limb", jcfg, jio)
    ctl_t, _o, atm_t = golden_case("limb")
    for c in (ctl_j, ctl_t):
        c.emitter[1] = "XYZ"
    assert_same_fields(tclim.climatology(ctl_t, atm_t),
                       jclim.climatology(ctl_j, atm_j))
    assert (atm_t.t > 0).all()
    g_j, g_t = jrand.ref_uniform_sequence(3), trand.ref_uniform_sequence(3)
    assert [next(g_t) for _ in range(5)] == [next(g_j) for _ in range(5)]


@pytest.mark.parametrize("ip", [1, 2, 3])
def test_interp_atm_matches(ip):
    """intpol_atm_geo on a three-profile track: the same arrays."""
    from test_interp_atm import _track_atm
    ctl_j = jsyn.synthetic_ctl(ng=2, nd=3)
    ctl_j.ip, ctl_j.cz, ctl_j.cx = ip, 2.0, 300.0
    atm_j = _track_atm(ctl_j)
    ctl_t, atm_t = port_ctl(ctl_j), port_atm(atm_j)
    rng = np.random.default_rng(ip)
    z = rng.uniform(0, 80, 40)
    lon = rng.uniform(-2, 2, 40)
    lat = rng.uniform(-6, 6, 40)
    tp_j = jinterp.split_profiles(atm_j) if ip == 2 else None
    tp_t = tinterp.split_profiles(atm_t) if ip == 2 else None
    got = tinterp.intpol_atm_geo(ctl_t, atm_t, z, lon, lat, tp_t)
    ref = jinterp.intpol_atm_geo(ctl_j, atm_j, z, lon, lat, tp_j)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(got[1]).any()


@pytest.mark.parametrize("case", ["limb", "ega", "nadir", "gas30", "fov"])
def test_ctl_atm_obs_readers_match(case):
    """Same parsed Ctl, same Atm/Obs arrays, and the converters give the
    port's classes with the same content."""
    ctl_j, obs_j, atm_j = golden_case(case, jcfg, jio)
    ctl_t, obs_t, atm_t = golden_case(case)
    assert type(ctl_t) is tcfg.Ctl and type(obs_t) is tio.Obs
    assert dataclasses.asdict(ctl_t) == dataclasses.asdict(ctl_j)
    assert ctl_t.table_hash == ctl_j.table_hash
    assert_same_fields(atm_t, atm_j, "atm")
    assert_same_fields(obs_t, obs_j, "obs")
    c2, a2, o2 = port_ctl(ctl_j), port_atm(atm_j), port_obs(obs_j)
    assert type(c2) is tcfg.Ctl and type(a2) is tio.Atm \
        and type(o2) is tio.Obs
    assert c2 == ctl_t
    assert_same_fields(a2, atm_t)
    assert_same_fields(o2, obs_t)
    assert not np.shares_memory(a2.p, atm_j.p)


def test_ctl_from_fields_rejects_unknown():
    with pytest.raises(tcfg.CtlError, match="Unknown"):
        tcfg.ctl_from_fields({"no_such_field": 1})


@pytest.mark.parametrize("case", ["ega", "nadir"])
def test_writers_match(case, tmp_path):
    ctl_j, obs_j, atm_j = golden_case(case, jcfg, jio)
    ctl_t, obs_t, atm_t = golden_case(case)
    jio.write_obs(tmp_path / "oj.tab", ctl_j, obs_j)
    tio.write_obs(tmp_path / "ot.tab", ctl_t, obs_t)
    jio.write_atm(tmp_path / "aj.tab", ctl_j, atm_j)
    tio.write_atm(tmp_path / "at.tab", ctl_t, atm_t)
    assert (tmp_path / "oj.tab").read_bytes() \
        == (tmp_path / "ot.tab").read_bytes()
    assert (tmp_path / "aj.tab").read_bytes() \
        == (tmp_path / "at.tab").read_bytes()


@pytest.mark.parametrize("case", ["limb", "ega", "nadir"])
def test_tables_match_bytewise(case):
    """load_tables (through each package's own native parser build) and
    build_fast_tables: byte-equal EgaTables and FastTables."""
    ctl_j, _, _ = golden_case(case, jcfg, jio)
    ctl_t, _, _ = golden_case(case)
    d = GOLD / case
    tj = jtab.load_tables(ctl_j, d, verbose=False)
    tt = ttab.load_tables(ctl_t, d, verbose=False)
    assert type(tt) is ttab.EgaTables
    assert_same_fields(tt, tj, "EgaTables")
    fj, ft = jtab.build_fast_tables(tj), ttab.build_fast_tables(tt)
    assert type(ft) is ttab.FastTables
    assert_same_fields(ft, fj, "FastTables")
    for k in ft._fields:
        assert getattr(ft, k).tobytes() == getattr(fj, k).tobytes(), k
    assert_same_fields(port_fast_tables(fj), ft)
    assert_same_fields(ttab.ega_tables_from_fields(tj._asdict()), tt)
    assert ttab.cache_filename(ctl_t, d).name.startswith(
        "jurassic_torch_tables_")
    assert ttab.cache_filename(ctl_t, d).name[len("jurassic_torch"):] \
        == jtab.cache_filename(ctl_j, d).name[len("jurassic_tpu"):]


def test_native_parser_matches_python_parser():
    """The port's C parser (built into jurassic_torch/_build) and its
    NumPy path give the same arrays, as in the original."""
    if not tnative.available():
        pytest.skip("no C compiler")
    f = GOLD / "ega" / "synth_792.0000_CO2.tab"
    dn = tnative.parse_tab_file(f)
    dp = ttab._blocks_to_dense(ttab._parse_tab_file(f))
    dj = jnative.parse_tab_file(f)
    for k, v in dp.items():
        np.testing.assert_array_equal(dn[k], v, err_msg=k)
        if dj is not None:
            np.testing.assert_array_equal(dn[k], dj[k], err_msg=k)
    assert tnative._BUILD_DIR == REPO / "jurassic_torch" / "_build"


def test_synthetic_generators_match():
    (cj, fj, aj, oj), (ct, ft, at, ot) = small_limb_pair(ng=4, nd=9, nr=6)
    c2 = tsyn.synthetic_ctl(ng=4, nd=9)
    assert dataclasses.asdict(c2) == dataclasses.asdict(
        jsyn.synthetic_ctl(ng=4, nd=9))
    assert_same_fields(tsyn.synthetic_fast_tables(ct, n_p=8, n_t=5, n_k=48),
                       fj, "synthetic_fast_tables")
    assert_same_fields(tsyn.synthetic_atm(ct), aj, "synthetic_atm")
    assert_same_fields(tsyn.limb_workload(ct, 6), oj, "limb_workload")
    assert_same_fields(tsyn.fast_to_ega_tables(ft),
                       jsyn.fast_to_ega_tables(fj), "fast_to_ega_tables")
    assert_same_fields(tgeo.limb_geometry(z0=3.0, z1=20.0, dz=0.5, nd=9),
                       jgeo.limb_geometry(z0=3.0, z1=20.0, dz=0.5, nd=9))
    assert_same_fields(tgeo.nadir_geometry(nd=3), jgeo.nadir_geometry(nd=3))
    from jurassic_torch.workloads import small_limb
    for got, ref in zip(small_limb(ng=4, nd=9, nr=6), (ct, ft, at, ot)):
        assert_same_fields(got, ref, "small_limb")


def test_planck_matches():
    nu = np.linspace(700.0, 1200.0, 7)
    t = np.linspace(150.0, 320.0, 11)[:, None]
    np.testing.assert_array_equal(tplanck.planck(t, nu),
                                  jplanck.planck(t, nu))
    rad = jplanck.planck(t, nu)
    np.testing.assert_array_equal(tplanck.brightness(rad, nu),
                                  jplanck.brightness(rad, nu))
    np.testing.assert_array_equal(tplanck.source_temperature_axis(),
                                  jplanck.source_temperature_axis())


def test_timer_and_profile_trace(tmp_path, capsys):
    ttimer.timer("X", 1)
    assert ttimer.timer("X", -3) >= 0.0
    with ttimer.timed("Y", silent=True) as box:
        pass
    assert box.dt >= 0.0
    with ttimer.profile_trace(None):
        pass
    import torch
    with ttimer.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
