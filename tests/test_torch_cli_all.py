"""The nine NumPy CLIs of the port against the JAX package's CLIs on the
same inputs, on the CPU: ``limb``, ``nadir``, ``climatology``,
``obs2spec``, ``brightness``, ``planck``, ``timeconv``'s two entry
points, ``strhash``, ``memoryinfo`` (``formod``'s flags are in
``test_torch_cli_formod.py``).  Output files are byte-equal; printed
lines are equal but for the package's name in ``memoryinfo``.
Also here: slicing fitted turbo tables by channel (what formod's
``BENCH_SCALING`` does) is byte-equal to fitting the sliced tables.
"""
import importlib
import shutil
from pathlib import Path

import pytest

from jurassic_torch.forward import channel_slice
from jurassic_torch.ops.turbo_fit import (build_turbo_tables,
                                          slice_turbo_tables)
from jurassic_torch.workloads import small_limb

from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

GOLD = Path(__file__).parent / "goldens"

# name -> (module, entry point, golden dir, argv after the program name,
#          files written)
CASES = {
    "limb": ("limb", "main", "limb",
             ["limb.ctl", "obs.tab", "Z0", "3", "Z1", "68", "DZ", "1.0"],
             ["obs.tab"]),
    "nadir": ("nadir", "main", "nadir", ["nadir.ctl", "obs.tab", "T1", "10"],
              ["obs.tab"]),
    "climatology": ("climatology", "main", "limb",
                    ["limb.ctl", "atm.tab", "DZ", "2.5"], ["atm.tab"]),
    "climatology-rand": ("climatology", "main", "limb",
                         ["limb.ctl", "atm.tab", "T1", "2", "RAND", "1"],
                         ["atm.tab"]),
    "obs2spec": ("obs2spec", "main", "ega",
                 ["ega.ctl", "rad.tab", "spec.tab"], ["spec.tab"]),
    "brightness": ("brightness", "main", None, ["1.5e-4", "792.0"], []),
    "planck": ("planck", "main", None, ["250.5", "792.0"], []),
    "time2jsec": ("timeconv", "time2jsec_main", None,
                  ["2010", "1", "2", "3", "4", "5", "0.25"], []),
    "jsec2time": ("timeconv", "jsec2time_main", None, ["315633845.25"], []),
    "strhash": ("strhash", "main", None, ["CLIMATOLOGY"], []),
    "memoryinfo": ("memoryinfo", "main", None, [], []),
    "memoryinfo-ctl": ("memoryinfo", "main", "ega", ["ega.ctl"], []),
}


def _lines(text, pkg):
    """Printed lines, the package's name made neutral, without timings
    and the port's closing formod line."""
    keep = []
    for ln in text.replace(pkg, "<pkg>").splitlines():
        if ln.startswith("Timer '") or "formod took" in ln \
                or ln.startswith("# formod: device"):
            continue
        keep.append(ln)
    return keep


def _run(pkg, module, entry, gold, args, work, monkeypatch, capsys):
    """Run ``pkg``'s CLI in ``work`` (a copy of the golden dir, if any);
    returns its printed lines."""
    work.mkdir()
    if gold:
        for f in (GOLD / gold).iterdir():
            shutil.copy(f, work / f.name)
    monkeypatch.chdir(work)
    capsys.readouterr()
    fn = getattr(importlib.import_module(f"{pkg}.cli.{module}"), entry)
    assert fn([module] + list(args)) == 0
    return _lines(capsys.readouterr().out, pkg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_matches_jax(name, tmp_path, monkeypatch, capsys):
    module, entry, gold, args, outputs = CASES[name]
    out_j = _run("jurassic_tpu", module, entry, gold, args, tmp_path / "j",
                 monkeypatch, capsys)
    out_t = _run("jurassic_torch", module, entry, gold, args,
                 tmp_path / "t", monkeypatch, capsys)
    assert out_t == out_j
    assert out_j or outputs
    for f in outputs:
        assert (tmp_path / "t" / f).read_bytes() \
            == (tmp_path / "j" / f).read_bytes(), f


def test_turbo_slice_is_a_refit():
    """Rows are fitted one by one: the first nd channels of fitted turbo
    tables are byte-equal to the fit of the first nd channels, with the
    same row and bad-row counts (three rough rows on channel 2)."""
    from test_torch_cli import _roughen
    _c, ft, _a, _o = small_limb(ng=3, nd=6, nr=2)
    ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
    tt, st = build_turbo_tables(ft)
    assert tt.n_bad == 3
    for nd in (1, 3, 6):
        got, st_g = slice_turbo_tables(tt, st, nd)
        ref, st_r = build_turbo_tables(channel_slice(ft, nd))
        for f in ("coef", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u"):
            a, b = getattr(got, f).numpy(), getattr(ref, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (nd, f)
        assert (got.n_bad, st_g.rows) == (ref.n_bad, st_r.rows)
        assert got.n_bad == (3 if nd > 2 else 0)
        # the error maxima are those of all channels: bounds of the slice's
        assert st_g.max_fwd_err >= st_r.max_fwd_err
        assert st_g.max_chord_dev >= st_r.max_chord_dev
