"""Where one call's time goes, recorded inside the call.

A :class:`PhaseClock` is made for one call of a root (``formod``,
``kernel_autodiff``) when the model's ``phase_log`` is a list; with
``phase_log`` None no clock exists and each boundary costs one ``is
None`` test.  The call names the span that starts at each boundary
(:meth:`PhaseClock.begin`): the open leaf ends there, so the leaves tile
the call and every millisecond of it falls in exactly one leaf.

At each boundary the clock reads the host clock in the clock that
``torch.profiler`` stamps its host events with (``time.time_ns``), and
takes a stream mark: a CUDA event recorded on the stream the closing
leaf began on, so that a leaf's stream interval ends when its stream has
done the leaf's work (on the CPU, the host clock again).

:meth:`PhaseClock.finish` appends a :class:`PhaseRecord` to the log.
While :func:`~jurassic_torch.utils.timer.profile_trace` is open, every
span is also a ``torch.profiler`` range and the record goes to that
trace's idle split (:func:`idle_split`); a root or group span then
starts when its range is entered, a moment before its first leaf.  Under
any other profiler no range is made: a profiler that does not know the
program's span names would count their copies on the device's timeline
as device work.  A call that raises makes no record, and
:meth:`PhaseClock.close` exits the ranges it left open.
"""
from __future__ import annotations

import bisect
import itertools
import time
from typing import NamedTuple

import torch

from .timer import open_trace_records


class Span(NamedTuple):
    name: str
    parent: str | None              # the enclosing span; None for the root
    host_ns: tuple[int, int]        # start, end (time.time_ns)
    stream_ms: tuple[float, float]  # start, end from the call's start


class PhaseRecord(dict):
    """One call's record.  As a mapping, the flat view: {leaf name:
    stream milliseconds}, summed over the leaves of that name, in the
    order of their first start; the values add up to the call.
    ``root`` (``"formod"`` or ``"kernel_autodiff"``), ``seq`` (the
    record's index in its log), ``spans`` (the root, then each group and
    leaf in the order of its start) and ``counts`` (what the call
    counted)."""

    def __init__(self, root: str, seq: int, spans: list, counts: dict):
        super().__init__()
        self.root, self.seq, self.spans, self.counts = root, seq, spans, counts
        for s in self.leaves():
            self[s.name] = self.get(s.name, 0.0) + (s.stream_ms[1]
                                                    - s.stream_ms[0])

    def leaves(self) -> list[Span]:
        parents = {s.parent for s in self.spans}
        return [s for s in self.spans if s.name not in parents]


class PhaseClock:
    """The spans and counts of one call of ``root`` on ``device``;
    :meth:`finish` appends its record to ``log``.  A leaf of ``package``
    k is a child of the span ``"package k"``, one of package None a
    child of the root.  The call fills ``counts``."""

    def __init__(self, root: str, device, log: list):
        self.root, self.log = root, log
        self.cuda = torch.device(device).type == "cuda"
        self.counts: dict = {}
        self._records = open_trace_records()
        self._marks: list = []      # (host ns, stream mark) per boundary
        self._leaves: list = []     # (name, group, index of its start mark)
        self._stream = None         # the open leaf's stream
        self._ranges: list = []     # open profiler ranges, innermost last
        self._entered: list = []    # host ns of each root or group range

    def _boundary(self) -> None:
        host = time.time_ns()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._stream = torch.cuda.current_stream()
        else:
            ev = time.perf_counter()
        self._marks.append((host, ev))

    def begin(self, name: str, package=...) -> None:
        """End the open leaf and begin leaf ``name`` of ``package`` (an
        index or None; by default the open leaf's); the first begins the
        call.  The open leaf itself goes on."""
        was = self._leaves[-1][1] if self._leaves else None
        group = was if package is ... else (
            None if package is None else f"package {package}")
        if self._leaves and (name, group) == self._leaves[-1][:2]:
            return
        if self._records is not None:
            if not self._leaves:
                self._entered.append(self._enter(self.root))
            else:
                self._exit()
                if was is not None and group != was:
                    self._exit()
            if group is not None and group != was:
                self._entered.append(self._enter(group))
            self._enter(name)
        self._boundary()
        self._leaves.append((name, group, len(self._marks) - 1))

    def _enter(self, name: str) -> int:
        """Open range ``name``; the host ns it was opened at (read after
        the opening: the profiler's first range of a trace stamps its
        start late in the call)."""
        r = torch.profiler.record_function(name)
        r.__enter__()
        self._ranges.append(r)
        return time.time_ns()

    def _exit(self) -> None:
        self._ranges.pop().__exit__(None, None, None)

    def close(self) -> None:
        """Exit the profiler ranges still open (those of a call that
        raised); after :meth:`finish` there are none."""
        while self._ranges:
            self._exit()

    def finish(self) -> PhaseRecord:
        """End the call; its record."""
        self.close()
        self._boundary()
        host = [h for h, _ in self._marks]
        if self.cuda:
            self._marks[-1][1].synchronize()
            e0 = self._marks[0][1]
            ms = [0.0] + [e0.elapsed_time(e) for _, e in self._marks[1:]]
        else:
            ms = [(t - self._marks[0][1]) * 1e3 for _, t in self._marks]

        entered = iter(self._entered)

        def span(name, parent, a, b, opened=None):
            return Span(name, parent, (host[a] if opened is None else opened,
                                      host[b]),
                        (ms[a], ms[b]))
        ends = [k for _, _, k in self._leaves[1:]] + [len(self._marks) - 1]
        spans = [span(self.root, None, 0, ends[-1], next(entered, None))]
        for group, run in itertools.groupby(zip(self._leaves, ends),
                                            key=lambda x: x[0][1]):
            run = list(run)
            if group is not None:
                spans.append(span(group, self.root, run[0][0][2], run[-1][1],
                                  next(entered, None)))
            spans += [span(name, group or self.root, a, b)
                      for (name, _, a), b in run]
        rec = PhaseRecord(self.root, len(self.log), spans, self.counts)
        self.log.append(rec)
        if self._records is not None:
            self._records.append(rec)
        return rec


def begin(clock: PhaseClock | None, name: str, package=...) -> None:
    """:meth:`PhaseClock.begin` of a root's clock, None with recording
    off."""
    if clock is not None:
        clock.begin(name, package)


def device_activity(prof) -> list[tuple[int, int]]:
    """(start ns, end ns) of the device work of a finished
    ``torch.profiler`` profile, told by the kind of activity: on the
    device's timeline every activity but a user annotation (a range's
    copy there) is work."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def idle_split(device: list, records: list) -> tuple[int, dict]:
    """(window ns, {leaf name or ``"no program span"``: idle ns}) over the
    window from the first leaf's start to the last one's end (a root's
    range opens a moment before its first leaf): each gap in the union
    of the ``device`` intervals is split by its overlap with the leaves'
    host intervals; what no leaf covers is under no program span."""
    leaves = sorted(s.host_ns + (s.name,) for r in records
                    for s in r.leaves())
    ends = [b for _, b, _ in leaves]        # the leaves do not overlap
    w0, w1 = leaves[0][0], ends[-1]
    busy: list = []
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in device
                       if b > w0 and a < w1):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle: dict = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        rest = b - a
        j = bisect.bisect_right(ends, a)
        while j < len(leaves) and leaves[j][0] < b:
            s, e, name = leaves[j]
            cut = min(b, e) - max(a, s)
            idle[name] = idle.get(name, 0) + cut
            rest -= cut
            j += 1
        if rest:
            idle["no program span"] = idle.get("no program span", 0) + rest
    return w1 - w0, idle


def idle_report(prof, records: list) -> str:
    """One line: the device's idle time over ``records``' calls in the
    finished profile ``prof``, by span (:func:`idle_split`), and the
    share of it under no program span."""
    window, idle = idle_split(device_activity(prof), records)
    total = sum(idle.values())
    return (f"# profile_trace: device idle {total / 1e6:.2f} of "
            f"{window / 1e6:.2f} ms over {len(records)} call(s), by span: "
            + ", ".join(f"{k} {v / 1e6:.2f}" for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1]))
            + " ms; under no program span "
            f"{100 * idle.get('no program span', 0) / max(total, 1):.1f} "
            "% of idle")
