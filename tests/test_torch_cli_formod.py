"""``python -m jurassic_torch.cli.formod`` against the JAX package's
formod CLI on the same inputs, on the CPU: ``BENCH`` and
``BENCH_SCALING`` (on cut copies of the ``ega`` golden), and the port's
``PROFILE``.

formod's output files are equal to the digits printed (see
``_same_rad_files``); printed lines are equal but for timings (timer
lines and "formod took ..."), and the port's closing
``# formod: device ...`` line.  ``BENCH_SCALING`` compares the sweep's
own lines: the JAX CLI reloads the tables for every channel count and
prints their report each time, the port cuts its loaded tables by
channel and reads none.
"""
import dataclasses
import importlib
import shutil
from pathlib import Path

import numpy as np

import jurassic_tpu.config as jcfg
import jurassic_tpu.io_tab as jio

from test_torch_cli_all import _lines
from test_torch_host_copies import golden_case
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"


def _ega_dir(work, nr=None):
    """A copy of the ega golden in ``work``, cut to its first ``nr`` rays."""
    work.mkdir()
    for f in (GOLD / "ega").iterdir():
        shutil.copy(f, work / f.name)
    if nr is not None:
        ctl, obs, _a = golden_case("ega", jcfg, jio)
        jio.write_obs(work / "obs.tab", ctl, jio.Obs(**{
            f.name: getattr(obs, f.name)[:nr]
            for f in dataclasses.fields(obs)}))


def _formod_both(tmp_path, monkeypatch, capsys, args, nr=None):
    """The two formod CLIs on the ega golden (its first ``nr`` rays):
    (port's lines, JAX's lines); the rad files must agree."""
    res = {}
    for pkg, sub in (("jurassic_tpu", "j"), ("jurassic_torch", "t")):
        work = tmp_path / sub
        _ega_dir(work, nr)
        monkeypatch.chdir(work)
        capsys.readouterr()
        mod = importlib.import_module(f"{pkg}.cli.formod")
        assert mod.main(["formod", "ega.ctl", "obs.tab", "atm.tab",
                         "rad_out.tab"] + args) == 0
        res[sub] = capsys.readouterr().out
    _same_rad_files(tmp_path / "t" / "rad_out.tab",
                    tmp_path / "j" / "rad_out.tab")
    return res["t"], res["j"]


def _same_rad_files(a, b):
    """formod's output files: the same header lines, and numbers equal to
    the 6 digits printed.  Not byte-equal: a tangent-point longitude of
    -7.91e-09 is float64 roundoff around 0 and its digits follow the
    tracer's operation order, which differs between the packages."""
    ta, tb = a.read_text().splitlines(), b.read_text().splitlines()
    assert [ln for ln in ta if ln.startswith("#")] \
        == [ln for ln in tb if ln.startswith("#")]
    assert len(ta) == len(tb)
    na, nb = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
    assert na.shape == nb.shape and na.size > 0
    np.testing.assert_allclose(na, nb, rtol=1e-5, atol=1e-7)


def test_formod_bench_matches_jax(tmp_path, monkeypatch, capsys):
    """``BENCH 2`` (``KERNEL jax``, the first 3 rays): two timed runs,
    the repeat-run gate shows no deviations, the printed lines are
    JAX's."""
    out_t, out_j = _formod_both(tmp_path, monkeypatch, capsys,
                                ["KERNEL", "jax", "BENCH", "2"], nr=3)
    assert "shows no deviations" in out_t
    assert "# always run 2 iterations for benchmarking" in out_t
    assert "device cpu, variant fast, fused EGA kernel launches turbo 0 " \
        "table 0" in out_t
    assert _lines(out_t, "jurassic_torch") == _lines(out_j, "jurassic_tpu")


def test_formod_bench_scaling_matches_jax(tmp_path, monkeypatch, capsys):
    """``BENCH_SCALING 1`` on the first ray (``KERNEL jax``): the same
    sweep of channel counts."""
    out_t, out_j = _formod_both(tmp_path, monkeypatch, capsys,
                                ["KERNEL", "jax", "BENCH_SCALING", "1"],
                                nr=1)

    def sweep(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("# with", "scaling test"))
                and "formod took" not in ln and "sparse" not in ln]
    assert sweep(out_t) == sweep(out_j)
    assert len(sweep(out_t)) == 6
    assert sum("formod took" in ln for ln in out_t.splitlines()) == 2


def test_formod_profile(tmp_path, monkeypatch, capsys):
    """``PROFILE <dir>``: a torch.profiler trace of set-up and the first
    formod, whose spans it prints split by leaf with the call's counts
    beside the launch line, after the device's idle time by span."""
    work = tmp_path / "ega"
    _ega_dir(work, nr=1)
    monkeypatch.chdir(work)
    from jurassic_torch.cli import formod
    assert formod.main(["formod", "ega.ctl", "obs.tab", "atm.tab",
                        "rad_out.tab", "KERNEL", "fast", "PROFILE",
                        "prof"]) == 0
    assert (work / "prof" / "trace.json").stat().st_size > 0
    out = capsys.readouterr().out
    assert "variant fast" in out
    assert "# profile_trace: device idle" in out
    split = [ln for ln in out.splitlines()
             if ln.startswith("# formod: warm-up split hydrostatics")]
    assert len(split) == 1 and "counts rays 1, packages 1" in split[0]
