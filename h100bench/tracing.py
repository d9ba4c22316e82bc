"""What a traced run (``--trace 1``) records, and what it reduces to.

The window runs under ``torch.profiler`` (host operators and device
activity).  Spans of the benchmark's own are recorded around the calls
into the program's layers (``torch.profiler.record_function`` wrapped
around the program's functions for the traced run only), so that every
idle gap of the device can be named by what the host was doing.  The
program's own phase split (``ForwardModel.phase_log``, CUDA events at its
phase boundaries) is switched on for the window as well.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict

import torch

CALL_SPAN = "call"


@contextlib.contextmanager
def spans(where):
    """Wrap the program's functions ``where`` names -- (module, class or
    None, attribute, span name), an entry's ``SPANS``: the calls into
    each layer -- in named spans while the context is open; restore them
    after."""
    import importlib
    saved = []
    try:
        for mod, cls, attr, name in where:
            owner = importlib.import_module(mod)
            if cls is not None:
                owner = getattr(owner, cls)
            raw = owner.__dict__[attr]
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw

            def wrapped(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)
            functools.update_wrapper(wrapped, fn)
            saved.append((owner, attr, raw))
            setattr(owner, attr, staticmethod(wrapped)
                    if isinstance(raw, staticmethod) else wrapped)
        yield
    finally:
        for owner, attr, raw in reversed(saved):
            setattr(owner, attr, raw)


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events(prof, names: set):
    """(device activities, host spans) of a finished profile, from its raw
    Kineto events: device [(name, start_ns, end_ns)], spans [(name,
    start_ns, end_ns)] of ``names`` and ``CALL_SPAN``.  The
    profiler also draws each span on the device's timeline (a user
    annotation, not an activity): those are not device activities."""
    from torch.autograd import DeviceType
    names = set(names) | {CALL_SPAN}
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, n = e.start_ns(), e.name()
        if n in names:
            if e.device_type() != DeviceType.CUDA:
                host.append((n, s, s + e.duration_ns()))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((n, s, s + e.duration_ns()))
    return dev, host


def union(intervals):
    """The merged (start, end) intervals of ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """The traced window reduced: busy seconds (the union of the device
    activities, clipped to the window), device time by kernel name, idle
    gaps by host span (of the spans ``where``: an entry's ``SPANS``), and
    the calls' host latencies and phase splits."""

    def __init__(self, prof, calls_ms: list, phases: list, where=()):
        dev, host = events(prof, {s[3] for s in where})
        # the window: from the first call's start to the last call's end
        calls = [h for h in host if h[0] == CALL_SPAN]
        w0, w1 = min(h[1] for h in calls), max(h[2] for h in calls)
        dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev
               if b > w0 and a < w1]
        self.window_s = (w1 - w0) / 1e9
        busy = union([(a, b) for _, a, b in dev])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        by_name = defaultdict(int)
        for n, a, b in dev:
            by_name[n] += b - a
        self.kernel_ns = dict(by_name)
        self.n_device = len(dev)
        self.calls_ms, self.phases = calls_ms, phases
        # idle gaps named by the innermost span open at their midpoint:
        # of the spans begun by then, the latest begun that is still open
        gaps = defaultdict(int)
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        host.sort(key=lambda h: h[1])
        starts = [h[1] for h in host]
        longest = max(h[2] - h[1] for h in host)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = "between calls"
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if starts[j] < mid - longest:
                    break
                if host[j][2] > mid:
                    name = host[j][0]
                    break
            if name == CALL_SPAN:
                name = "call, outside the named layers"
            gaps[name] += b - a
        self.idle_ns = dict(gaps)

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the activities whose name holds any of
        ``parts``."""
        return sum(v for k, v in self.kernel_ns.items()
                   if any(p in k for p in parts)) / 1e9

    def breakdown(self) -> dict:
        top = sorted(self.kernel_ns.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_ns.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:200], v / 1e9] for k, v in top],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps]}
