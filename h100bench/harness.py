"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
in a file of its own, found by the name ``BENCHMARK.json`` or another
such file gives it: ``configs/<config>.json`` (through the config's
``file``), ``traffic/<mix>.json``, ``limits/<workload>.json``,
``metrics/<metric>.py``, the entry a mix drives (``entries/<entry>.py``)
and the generators a configuration names (``gen/tables/<name>.py``,
``gen/geometry/<name>.py``, ``gen/atmosphere/<name>.py``).  Adding a
cell, a mix, a metric or a generator adds files and entries; no file
here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import importcheck

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_T_IMPORT = time.monotonic()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``), or since this module was imported where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


_MODULES: dict = {}


def module(where: str, name: str):
    """The benchmark's file ``<where>/<name>.py`` (``metrics``,
    ``entries``, ``gen/tables``, ...) as a module, loaded once."""
    path = HERE / where / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise SystemExit(f"no file {where}/{name}.py in the benchmark")
        tag = f"{where}/{name}".replace("/", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(
            f"h100bench._files.{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones, each where its
    ``workloads`` lists the cell (a per-layer metric without the key:
    where its ``moves`` is reported)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def card() -> dict:
    """The card's name, count and power limit."""
    import torch
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "power_limit": limit}


class Run:
    """What one run measured: the metric readers' input."""

    def __init__(self, workload: str, cfg: dict, entry_name: str, entry,
                 inputs):
        self.workload, self.cfg = workload, cfg
        self.entry_name = entry_name
        self.work = entry.work
        self.inputs = inputs
        self.calls_ms: list[float] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace = None           # tracing.Trace of a --trace 1 run
        self.phases: list = []      # ForwardModel.phase_log of the window
        self.pool_of_call: list[int] = []
        self.reference = None       # reference.forward.Reference
        self._segments: dict = {}

    @property
    def done(self) -> int:
        return len(self.calls_ms)

    def segments(self) -> list[int]:
        """The valid LOS segments of every window call, by the reference
        tracer (each distinct pooled atmosphere traced once)."""
        new = sorted(set(self.pool_of_call) - set(self._segments))
        counts = self.reference.segments([self.inputs.pool[k] for k in new],
                                         self.inputs.geo,
                                         np.arange(self.inputs.nr))
        self._segments.update(zip(new, counts))
        return [self._segments[k] for k in self.pool_of_call]


def cell_spec(bench: dict, workload: str) -> tuple:
    """(workload entry, configuration, traffic mix, limits) of a cell, each
    read from its own file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    return (w, load_json(ROOT / cfgs[w["config"]]["file"]),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            load_json(HERE / "limits" / f"{workload}.json"))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             bench: dict | None = None, spec: tuple | None = None,
             device=None, require_cuda=True, out=sys.stdout,
             err=sys.stderr) -> dict:
    """Run one cell and return its result line (a dict); print the
    compared numbers beside their limits as the last lines of ``err``.
    Tests only: ``spec`` replaces the cell's files (``cell_spec``), and
    ``require_cuda`` False runs on ``device`` without the look for a
    card."""
    import torch

    from . import check, gen
    from .reference.forward import Reference

    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    w, cfg, traffic, limits = cell_spec(bench, workload) if spec is None \
        else spec
    bad = importcheck.loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    print(f"# import check: none of {', '.join(importcheck.FORBIDDEN)} "
          "loaded", file=out, flush=True)
    if require_cuda:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(w["chips"]):
            raise SystemExit(f"{workload} needs {w['chips']} CUDA "
                             "device(s); found "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda:0")
        info = card()
        print(f"# card: {info['kind']} x{info['count']}, power limit "
              f"{info['power_limit']}", file=out, flush=True)
    device = torch.device(device)
    cuda = device.type == "cuda"

    # -- set-up: inputs from the seed, the program, warm-up calls
    stamp = [time.perf_counter()]

    def note(what: str) -> None:
        now = time.perf_counter()
        print(f"# {what}: {now - stamp[0]:.2f} s", file=out, flush=True)
        stamp[0] = now
    inp = gen.Inputs(cfg, traffic, seed)
    note("inputs")
    kind = module("entries", traffic["entry"])
    entry = kind.Entry(cfg, inp, device)
    note("program set-up")
    run = Run(workload, cfg, traffic["entry"], entry, inp)
    n_warm = int(traffic["warmup"])
    for i in range(n_warm):
        entry.call(i)
    entry.kept.clear()
    if cuda:
        torch.cuda.synchronize()
    note(f"{n_warm} warm-up call(s)")

    # -- the window
    failed = 0
    prof = None
    ctx = []
    if trace:
        from . import tracing
        entry.model.phase_log = []
        ctx = [tracing.spans(getattr(kind, "SPANS", ())),
               tracing.profiler()]
    run.setup_s = process_age()
    for c in ctx:
        prof = c.__enter__()
    try:
        t0 = time.perf_counter()
        k = n_warm
        while True:
            t = time.perf_counter()
            try:
                if trace:
                    with torch.profiler.record_function("call"):
                        entry.call(k)
                else:
                    entry.call(k)
            except Exception:               # a failed call ends the window
                traceback.print_exc(file=err)
                failed += 1
                break
            now = time.perf_counter()
            run.calls_ms.append((now - t) * 1e3)
            run.pool_of_call.append(k % len(inp.pool))
            k += 1
            if now - t0 >= seconds:
                break
        run.window_s = time.perf_counter() - t0
    finally:
        for c in reversed(ctx):
            c.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    note(f"window of {run.done} call(s) (set-up {run.setup_s:.2f} s)")
    if trace:
        run.phases = entry.model.phase_log or []
    kept = entry.kept
    entry.free()
    del entry

    # -- the check, on the freed device
    run.reference = Reference(cfg, inp.ft, inp.u, device)
    numbers = {}
    if run.done:
        picks = gen.check_calls(traffic, seed, run.done)
        numbers = kind.compare(
            run.reference, [inp.pool[run.pool_of_call[j]] for j in picks],
            inp.geo, inp.rows, [kept[j] for j in picks])
        # compared: the numbers the cell's limits name
        numbers = {k: v for k, v in numbers.items() if k in limits}
    correct = bool(run.done and not failed
                   and check.verdict(numbers, limits))
    note("check")

    # -- the metrics
    if trace:
        from .tracing import Trace
        run.trace = Trace(prof, run.calls_ms, run.phases,
                          getattr(kind, "SPANS", ()))
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    note("metrics")
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": run.done + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = {k: {"value": v, "limit": float(limits[k]["limit"])}
                       for k, v in numbers.items()}
    bad = importcheck.loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded after the window: {bad}")
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']:.6e} (limit {v['limit']:.6e})",
              file=err, flush=True)
    return result
