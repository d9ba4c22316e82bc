"""The program's own spans and counters (``jurassic_torch.utils.phases``):
``ForwardModel.phase_log`` records of ``formod`` and
``retrieval.kernel_autodiff`` on the CPU, at the size of the
benchmark's CPU cells (``h100bench.tests.tinycell``); profiler ranges
only under ``utils.timer.profile_trace``; the benchmark's readers of the
spans and counters."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import gen, harness
from h100bench.reference.forward import Reference
from h100bench.tests import tinycell
from jurassic_torch import forward
from jurassic_torch.retrieval import kernel_autodiff
from jurassic_torch.utils import phases, profile_trace

from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

FORMOD_LEAVES = [
    ("hydrostatics", "formod"), ("raypack sizing", "formod"),
    ("profiles", "package 0"), ("trace", "package 0"),
    ("kernel", "package 0"), ("epilogue", "package 0"),
    ("D2H", "formod"), ("host", "formod"), ("FOV + mask", "formod")]
AUTODIFF_LEAVES = [
    ("seed", "kernel_autodiff"), ("sizing", "kernel_autodiff"),
    ("package tangents", "package 0"), ("tracer tangents", "package 0"),
    ("RT tangents", "package 0"), ("K gather", "package 0"),
    ("K to host", "package 0"), ("K assembly", "kernel_autodiff")]
NAMES = {n for n, _ in FORMOD_LEAVES + AUTODIFF_LEAVES} | {
    "formod", "kernel_autodiff", "package 0"}


def _entry(workload: str):
    _, cfg, traffic, _ = tinycell.spec(workload)
    inp = gen.Inputs(cfg, traffic, tinycell.SEED)
    kind = harness.module("entries", traffic["entry"])
    return kind.Entry(cfg, inp, torch.device("cpu"))


@pytest.fixture(scope="module")
def flagship():
    return _entry("limb_flagship.formod")


@pytest.fixture(scope="module")
def jacobian():
    return _entry("limb_wide_exact.jacobian")


def _range_names(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()}


def test_off_records_nothing(flagship, jacobian, tmp_path, capsys):
    """With ``phase_log`` None no record is made and no range, even
    under ``profile_trace`` (which then prints no idle split)."""
    for e in (flagship, jacobian):
        e.model.phase_log = None
        with profile_trace(str(tmp_path / "p")) as prof:
            e.call(0)
        assert not _range_names(prof) & NAMES
    assert "# profile_trace" not in capsys.readouterr().out


def test_formod_record(flagship, monkeypatch):
    """A ``formod`` record's leaves tile the call in order under their
    parents; the flat view sums to the call; the RAYPACK sizing is its
    own span, outside ``profiles``; the counts."""
    m = flagship.model
    at = []
    size = forward.ForwardModel.package_size

    def timed(self, *a):
        at.append(time.time_ns())
        return size(self, *a)
    monkeypatch.setattr(forward.ForwardModel, "package_size", timed)
    m.phase_log = []
    flagship.call(1)
    flagship.call(2)
    rec = m.phase_log[1]
    m.phase_log = None
    assert (rec.root, rec.seq) == ("formod", 1)
    assert [(s.name, s.parent) for s in rec.leaves()] == FORMOD_LEAVES
    leaves, root = rec.leaves(), rec.spans[0]
    assert (root.name, root.parent) == ("formod", None)
    assert leaves[0].host_ns[0] == root.host_ns[0]
    assert leaves[-1].host_ns[1] == root.host_ns[1]
    assert all(a.host_ns[1] == b.host_ns[0] and a.stream_ms[1]
               == b.stream_ms[0] for a, b in zip(leaves, leaves[1:]))
    assert list(rec) == [n for n, _ in FORMOD_LEAVES]
    assert sum(rec.values()) == pytest.approx(root.stream_ms[1], rel=1e-9)
    sizing = dict((s.name, s.host_ns) for s in leaves)
    a, b = sizing["raypack sizing"]
    assert a <= at[-1] < b
    assert not sizing["profiles"][0] <= at[-1] < sizing["profiles"][1]
    R = flagship.inp.nr
    assert rec.counts == dict(rays=R, packages=1, rays_per_package=R,
                              segments=rec.counts["segments"], lanes_rerun=0)


def test_formod_segments_counter(flagship):
    """The ``segments`` count is the reference tracer's count of valid
    LOS segments of the same call."""
    m = flagship.model
    m.phase_log = []
    for i in range(2):
        flagship.call(i)
    log, m.phase_log = m.phase_log, None
    inp = flagship.inp
    ref = Reference(flagship.cfg, inp.ft, inp.u, torch.device("cpu"))
    want = ref.segments([flagship.atm(i) for i in range(2)], inp.geo,
                        np.arange(inp.nr))
    assert [r.counts["segments"] for r in log] == want


def test_kernel_autodiff_record(jacobian):
    """A ``kernel_autodiff`` record: its leaves under their parents;
    ``k_bytes``, the bytes of K copied to the host, K's own; on the CPU
    none of them page-locked (``k_pinned_bytes``) and no page-locked
    block made (``k_pin_allocs``)."""
    from h100bench import program
    m = jacobian.model
    m.phase_log = []
    K = kernel_autodiff(jacobian.ctl, program.program_atm(jacobian.atm(0)),
                        jacobian.obs, m)
    (rec,), m.phase_log = m.phase_log, None
    assert rec.root == "kernel_autodiff"
    assert [(s.name, s.parent) for s in rec.leaves()] == AUTODIFF_LEAVES
    assert sum(rec.values()) == pytest.approx(rec.spans[0].stream_ms[1],
                                              rel=1e-9)
    assert rec.counts == dict(k_bytes=K.nbytes, k_pinned_bytes=0,
                              k_pin_allocs=0)


def test_ranges_only_under_profile_trace(flagship, tmp_path, capsys):
    """Under a profiler the program did not open, no span is a range;
    under ``profile_trace`` each is (a root or group span starting when
    its range opens, before its first leaf), and the idle split is
    printed."""
    m = flagship.model
    m.phase_log = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flagship.call(0)
    assert not _range_names(prof) & NAMES
    with profile_trace(str(tmp_path / "p")) as prof:
        flagship.call(1)
    rec = m.phase_log[-1]
    m.phase_log = None
    assert _range_names(prof) >= {"formod", "package 0"} | {
        n for n, _ in FORMOD_LEAVES}
    spans = {s.name: s.host_ns for s in rec.spans}
    assert spans["formod"][0] <= spans["hydrostatics"][0]
    assert spans["package 0"][0] <= spans["profiles"][0]
    out = capsys.readouterr().out
    assert "# profile_trace: device idle" in out
    assert "under no program span 0.0 % of idle" in out


def _rec(spans):
    return phases.PhaseRecord("formod", 0, [
        phases.Span(n, p, h, (0.0, 0.0)) for n, p, h in spans], {})


def test_idle_split_by_overlap():
    """Each gap between device work is split by its overlap with the
    leaves; what no leaf covers (between calls) is under no program
    span; device work outside the calls is clipped."""
    a = _rec([("formod", None, (0, 100)), ("x", "formod", (0, 40)),
              ("y", "formod", (40, 100))])
    b = _rec([("formod", None, (150, 200)), ("z", "formod", (150, 200))])
    dev = [(-50, 10), (30, 60), (90, 160), (170, 180), (190, 900)]
    window, idle = phases.idle_split(dev, [a, b])
    assert window == 200
    assert idle == {"x": 20, "y": 30, "z": 20}
    _, idle = phases.idle_split([(20, 30)], [b, a])
    assert idle == {"x": 30, "y": 60, "no program span": 50, "z": 50}


def test_raising_call_closes_its_ranges(flagship, jacobian, monkeypatch,
                                        tmp_path):
    """A call that raises under ``profile_trace`` appends no record and
    leaves no range open: each of its ranges ends in the trace."""
    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(forward, "formod_fov", boom)
    monkeypatch.setattr(jacobian.model, "integrate_jvp", boom)
    from h100bench import program
    for run, names in (
            (lambda: flagship.call(0), {"formod", "FOV + mask"}),
            (lambda: kernel_autodiff(
                jacobian.ctl, program.program_atm(jacobian.atm(0)),
                jacobian.obs, jacobian.model),
             {"kernel_autodiff", "package 0", "RT tangents"})):
        m = flagship.model if "formod" in names else jacobian.model
        m.phase_log = []
        with profile_trace(str(tmp_path / "p")) as prof:
            with pytest.raises(RuntimeError, match="boom"):
                run()
        log, m.phase_log = m.phase_log, None
        assert log == []
        assert _range_names(prof) >= names


def test_metrics_read_the_spans():
    """The benchmark's readers of the program's spans and counters give
    finite values in traced CPU runs of the formod and jacobian cells (a
    process of their own: a benchmark run refuses a process that loaded
    the JAX package, as this one has)."""
    code = (
        "import json\n"
        "from h100bench.tests import tinycell\n"
        "print(json.dumps({w: tinycell.run(w, trace=True, seconds=0.2)"
        "['metrics'] for w in ('limb_flagship.formod', "
        "'limb_wide_exact.jacobian')}))\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    want = {"limb_flagship.formod": ("raypack_ms", "assemble_ms"),
            "limb_wide_exact.jacobian": ("autodiff_prep_ms",
                                         "k_to_host_ms", "k_d2h_gbps")}
    for w, names in want.items():
        for n in names:
            assert np.isfinite(got[w][n]["value"]), (w, n)
            assert got[w][n]["value"] > 0, (w, n)
