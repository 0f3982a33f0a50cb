"""A traced window's device time split by the program's phases.

The program names its layers with host spans (``repro_torch.spans`` in
the port: ``repro_torch.step``, ``.forward``, ``.backward``, ``.sync``,
``.update``, ...). A device activity (kernel, copy, set) belongs to the
span the host was in when it launched it: its CUDA runtime or driver
call (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
...), which shares its correlation id, starts inside a host interval of
that span. The interval may be on any thread: the backward's kernels
are launched from autograd's device thread while the caller's thread
sits in ``backward``. ``phase_seconds`` is the union of those
activities' intervals, so two streams at work at once count once, as
in ``Trace.busy_s``.

Read from the profiler's raw (Kineto) events: ``trace.from_profiler``
keeps no correlation ids. The program's spans are operator-scope
ranges, so they have no copy on the device's timeline; the harness's
own ``bench.*`` spans are user annotations, whose device copies are
left out here as in ``Trace``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from harness.trace import SPAN_PREFIX, Trace, _short

PROGRAM_PREFIX = "repro_torch."
# the span whose launches are the feed's (the next batch's copies on a
# side stream), which are no part of a step's device work
FEED = PROGRAM_PREFIX + "feed"

Interval = Tuple[str, float, float]


class Phases:
    """Device activities ``(name, start_s, end_s, launch_s or None)``,
    the program's host spans, the harness's spans and the other host
    operators ``(name, start_s, end_s)``, and the window ``[t0, t1]``,
    in seconds on the profiler's clock."""

    def __init__(self, device: List[Tuple[str, float, float,
                                          Optional[float]]],
                 program: List[Interval], harness: List[Interval],
                 host_ops: List[Interval], t0: float, t1: float):
        self.device = sorted(device, key=lambda e: e[1])
        self.program = program
        self.harness = harness
        self.host_ops = host_ops
        self.t0, self.t1 = t0, t1
        self._by_name: Dict[str, Tuple[List[float], List[float]]] = {}

    def _intervals(self, name: str) -> Tuple[List[float], List[float]]:
        """The merged host intervals of span ``name``, all threads:
        (starts, ends), sorted."""
        if name not in self._by_name:
            merged: List[List[float]] = []
            for a, b in sorted((a, b) for n, a, b in self.program
                               if n == name):
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            self._by_name[name] = ([a for a, _ in merged],
                                   [b for _, b in merged])
        return self._by_name[name]

    def launched_in(self, launch: Optional[float], name: str) -> bool:
        """Whether a launch at ``launch`` lies inside span ``name``."""
        if launch is None:
            return False
        starts, ends = self._intervals(name)
        i = bisect.bisect_right(starts, launch) - 1
        return i >= 0 and launch <= ends[i]

    def _union(self, events) -> float:
        """``Trace.busy_s`` of ``events``: the length of the union of
        their intervals inside the window."""
        return Trace([e[:3] for e in events], [], [], self.t0,
                     self.t1).busy_s

    def phase_seconds(self, name: str) -> float:
        """Device time (the union of intervals) of the activities
        launched inside span ``name``."""
        return self._union(e for e in self.device
                           if self.launched_in(e[3], name))

    def step_seconds(self) -> float:
        """Device time of the window's steps: every activity but the
        feed's."""
        return self._union(e for e in self.device
                           if not self.launched_in(e[3], FEED))

    def outside_seconds(self, names: Sequence[str]) -> float:
        """Device time of the step's activities launched in none of the
        spans ``names`` (or whose launch was not recorded)."""
        keep = [FEED, *names]
        return self._union(e for e in self.device
                           if not any(self.launched_in(e[3], n)
                                      for n in keep))

    def unlinked(self) -> int:
        """Device activities whose launch the trace does not hold."""
        return sum(e[3] is None for e in self.device)

    def top_ops(self, name: str, n: int = 8) -> List[List]:
        """The device operations launched inside span ``name`` that took
        most time, summed by name."""
        by: Dict[str, float] = {}
        for op, a, b, launch in self.device:
            if self.launched_in(launch, name):
                by[op] = by.get(op, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def idle_by_span(self) -> Dict[str, float]:
        """The window's idle time by the innermost program span the host
        was in at each gap's middle (``idle`` outside every span)."""
        spans = sorted(self.program, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        out: Dict[str, float] = {}
        for a, b in self._gaps():
            t = (a + b) / 2
            # spans nest on the calling thread: the latest-started one
            # still open at t is the innermost
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and spans[i][2] < t:
                i -= 1
            name = spans[i][0] if i >= 0 else "idle"
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def _host_at(self, t: float) -> str:
        """The harness span, the innermost program span and the
        innermost host operator at ``t``."""
        parts = []
        for group, none in ((self.harness, "idle"), (self.program, None),
                            (self.host_ops, None)):
            inside = [s for s in group if s[1] <= t <= s[2]]
            if inside:
                parts.append(min(inside, key=lambda s: s[2] - s[1])[0])
            elif none:
                parts.append(none)
        return _short(" / ".join(parts))

    def _gaps(self) -> List[Tuple[float, float]]:
        busy = Trace([e[:3] for e in self.device], [], [], self.t0,
                     self.t1).busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest spans of the window in which no device activity
        ran, each labelled with what the host was in then."""
        gaps = sorted(self._gaps(), key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), b - a] for a, b in gaps[:n]]


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...); operators are
    namespaced (``aten::``)."""
    return name.startswith("cu") and "::" not in name


def from_profiler(prof, span_names: Tuple[str, str]) -> Phases:
    """The ``Phases`` of a finished ``torch.profiler.profile``, in
    seconds from its first event; its window runs from the start of the
    first harness span named ``span_names[0]`` to the end of the last
    named ``span_names[1]``, as ``trace.from_profiler``'s does."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    # seconds from the first event: absolute nanoseconds lose
    # sub-microsecond steps in a double
    base = min(e.start_ns() for e in events)

    def sec(ns: int) -> float:
        return (ns - base) * 1e-9

    device_raw, cpu = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                device_raw.append(e)
        else:
            cpu.append(e)
    # a host operator's correlation id may equal a device activity's:
    # only the runtime calls carry the device's
    wanted = {e.correlation_id() for e in device_raw}
    launches = {e.correlation_id(): sec(e.start_ns()) for e in cpu
                if e.correlation_id() in wanted and _is_launch(e.name())}
    device = [(e.name(), sec(e.start_ns()), sec(e.end_ns()),
               launches.get(e.correlation_id())) for e in device_raw]
    program, harness, host_ops = [], [], []
    for e in cpu:
        span = (e.name(), sec(e.start_ns()), sec(e.end_ns()))
        if span[0].startswith(PROGRAM_PREFIX):
            program.append(span)
        elif span[0].startswith(SPAN_PREFIX):
            harness.append(span)
        else:
            host_ops.append(span)
    first = [s for s in harness if s[0] == span_names[0]]
    last = [s for s in harness if s[0] == span_names[1]]
    if not first or not last:
        raise RuntimeError("the traced window holds none of the harness's "
                           "spans")
    return Phases(device, program, harness, host_ops,
                  min(s[1] for s in first), max(s[2] for s in last))
