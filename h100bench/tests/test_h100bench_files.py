"""BENCHMARK.json against the benchmark's contract, and every file of the
benchmark found by its name."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from h100bench import harness
from h100bench.tests import tinycell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_contract():
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in
                                                b["command"])
    assert b["paths"] == ["h100bench"]
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    cfgs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(cfgs) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("h100bench/")
        f = harness.load_json(harness.ROOT / c["file"])
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in f for k in c["reduced"])
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == set(cfgs)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {w["name"]: {m["name"] for m in b["end_to_end"]
                       if w["name"] in m.get("workloads", [w["name"]])}
           for w in cells}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert _line(m["layer"]) and m["better"] in ("lower", "higher")
        assert all(m["moves"] in e2e[w] for w in m["workloads"])
    for w in cells:
        assert "setup_s" in e2e[w["name"]] and len(e2e[w["name"]]) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])


def test_every_file_parses():
    b = tinycell.bench()
    for w in b["workloads"]:
        _, cfg, traffic, limits = harness.cell_spec(b, w["name"])
        kind = harness.module("entries", traffic["entry"])
        assert callable(kind.compare) and callable(kind.Entry.call)
        for gen in ("tables", "geometry", "atmosphere"):
            assert callable(harness.module(f"gen/{gen}", cfg[gen]).make)
        assert all(v["limit"] > 0 for v in limits.values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)


RAGGED = """\
\"\"\"The analytic exact tables with ragged rows: each (gas, p, T,
channel) row cut by up to a quarter of its points, drawn from the
configuration's table seed.\"\"\"
import numpy as np

from h100bench.gen import synthetic


def make(cfg):
    ft = synthetic.fast_tables(cfg)
    u = synthetic.exact_u(ft)
    rng = np.random.default_rng(int(cfg["table_seed"]))
    K = ft["eps"].shape[3]
    ft["nu"] = (K - rng.integers(0, K // 4 + 1, size=ft["nu"].shape)
                ).astype(np.int32)
    return ft, u
"""

COARSE = """\
from h100bench.gen import synthetic


def make(cfg):
    return synthetic.limb_scan(dict(cfg, scan_dz=2 * cfg["scan_dz"]))
"""

RAD_ONLY = """\
from h100bench import check, program


class Entry(program.Entry):

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.obs = program.program_obs(self.inp.geo, self.ctl.nd)
        self.work = self.inp.nr * self.ctl.nd

    def call(self, i):
        self.model.formod(program.program_atm(self.atm(i)), self.obs)
        self.kept.append((self.obs.rad[self.inp.rows].copy(), None))


def compare(reference, atms, geo, rows, got):
    ref = reference.formod(atms, geo, rows)
    return {"rad_gap": check.formod_numbers(
        [(r, t) for (r, _), (_, t) in zip(got, ref)], ref)["rad_gap"]}
"""


def test_new_files_are_found(tmp_path, monkeypatch):
    """A configuration with generators of its own (ragged exact tables, a
    coarser scan), a mix driving an entry of its own, a cell and a metric,
    all added as files only: the harness finds and reports them with no
    file of it edited, and the cell is correct."""
    here = tmp_path / "h100bench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (here / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(run.done)\n")
    (here / "gen" / "tables" / "ragged_exact.py").write_text(RAGGED)
    (here / "gen" / "geometry" / "limb_coarse.py").write_text(COARSE)
    (here / "entries" / "formod_rad.py").write_text(RAD_ONLY)
    cfg = json.loads((here / "configs" / "limb_wide_exact.json").read_text())
    cfg.update(name="limb_ragged", tables="ragged_exact",
               geometry="limb_coarse", table_seed=5)
    (here / "configs" / "limb_ragged.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "formod.json").read_text())
    (here / "traffic" / "formod_rad.json").write_text(
        json.dumps(dict(traffic, entry="formod_rad", pool=8)))
    limits = json.loads((here / "limits" / "limb_wide_exact.formod.json")
                        .read_text())
    (here / "limits" / "limb_ragged.formod_rad.json").write_text(
        json.dumps({"rad_gap": limits["rad_gap"]}))
    b = tinycell.bench()
    b["configs"].append({"name": "limb_ragged", "source": "a test",
                         "file": "h100bench/configs/limb_ragged.json",
                         "reduced": cfg["reduced"], "why": "a test"})
    cell = "limb_ragged.formod_rad"
    b["workloads"].append({"name": cell, "config": "limb_ragged",
                           "traffic": "formod_rad", "chips": 1,
                           "why": "a test cell"})
    for m in b["end_to_end"]:
        if m["name"] == "formod_rate":
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "calls_done", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "forward entry (ForwardModel.formod)",
                           "moves": "formod_rate", "workloads": [cell]})
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    _, cfg2, traffic2, _ = harness.cell_spec(b, cell)
    assert traffic2["pool"] == 8 and cfg2["tables"] == "ragged_exact"
    sp = tinycell.spec(cell, b)
    from h100bench import gen
    ft, u = gen.make("tables", sp[1])
    assert u is not None and ft["nu"].min() < ft["nu"].max()
    assert gen.make("geometry", sp[1])["vpz"].size < gen.make(
        "geometry", dict(sp[1], geometry="limb_scan"))["vpz"].size
    r = tinycell.run(cell, trace=True, b=b, sp=sp)
    assert r["correct"] and r["metrics"]["calls_done"]["value"] >= 1
    r = tinycell.run(cell, b=b, sp=sp)
    assert r["correct"] and set(r["metrics"]) == {"formod_rate", "setup_s"}
    assert set(r["check"]) == {"rad_gap"}


@pytest.mark.parametrize("workload", ["limb_flagship.formod",
                                      "limb_wide_exact.formod",
                                      "limb_wide_exact.jacobian"])
def test_result_line(workload):
    """The result line's keys, the metrics of the cell, and the compared
    numbers beside their limits under the last key."""
    r = tinycell.run(workload)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "check" and r["correct"] and r["failed"] == 0
    assert all(set(v) == {"value", "limit"} for v in r["check"].values())
    b = tinycell.bench()
    want = {m["name"] for m in harness.cell_metrics(b, workload, False)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
