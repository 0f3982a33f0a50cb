"""The traced window's reduction: device activity from ``torch.profiler``
(CUPTI) and the harness's own host spans, in one clock.

``busy_s`` is the length of the union of every device activity's
interval (kernels, copies, sets; all streams), so two streams at work at
once count once. ``breakdown`` names the device operations that took
most time and the longest idle gaps, each with the harness span the host
was in and its innermost operator then.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."


class Trace:
    """Device intervals ``(name, start_s, end_s)``, host spans of the
    harness and host operators, and the window ``[t0, t1]``, all in
    seconds on the profiler's clock."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]],
                 t0: float, t1: float):
        self.device = sorted(device, key=lambda e: e[1])
        self.spans = spans
        self.host_ops = host_ops
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, patterns) -> Optional[float]:
        """Summed device time of the activities whose name matches any
        of ``patterns`` (regular expressions), or None if none does."""
        rx = [re.compile(p) for p in patterns]
        hits = [b - a for name, a, b in self.device
                if any(r.search(name) for r in rx)]
        return sum(hits) if hits else None

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def _host_at(self, t: float) -> str:
        span = [s for s in self.spans if s[1] <= t <= s[2]]
        ops = [o for o in self.host_ops if o[1] <= t <= o[2]]
        label = min(span, key=lambda s: s[2] - s[1])[0] if span else "idle"
        if ops:
            label += " / " + min(ops, key=lambda o: o[2] - o[1])[0]
        return _short(label)

    def idle_gaps(self, n: int = 10) -> List[List]:
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), b - a] for a, b in gaps[:n]]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def from_profiler(prof, span_names: Tuple[str, str]) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``; its window
    runs from the start of the first span named ``span_names[0]`` to the
    end of the last named ``span_names[1]``."""
    from torch.autograd import DeviceType
    device, spans, host_ops = [], [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # the harness's spans have a copy on the device's timeline
            # (a user annotation), which is no device work
            if not e.name.startswith(SPAN_PREFIX):
                device.append((e.name, a, b))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name, a, b))
        else:
            host_ops.append((e.name, a, b))
    first = [s for s in spans if s[0] == span_names[0]]
    last = [s for s in spans if s[0] == span_names[1]]
    if not first or not last:
        raise RuntimeError("the traced window holds none of the harness's "
                           "spans")
    return Trace(device, spans, host_ops, min(s[1] for s in first),
                 max(s[2] for s in last))
