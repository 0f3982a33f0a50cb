"""The traced window's readings with the program's spans in it, on
synthetic traces: ``trace.Trace`` (the program's spans are host
operators there, never device work, and an idle gap's label names the
innermost one where no operator runs) and ``phases.Phases`` (device time
given to the span its launch fell in, on any thread; the feed's copies
left out of a step's work; labels unchanged without program spans),
``phases.from_profiler`` on stand-ins of the profiler's raw events, and
``phase_split.split``'s report."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import phase_split  # noqa: E402
from harness import phases, trace  # noqa: E402
from harness.phases import Phases  # noqa: E402
from harness.trace import Trace  # noqa: E402

P = phases.PROGRAM_PREFIX
KERNELS = [("gemm", 0.10, 0.30), ("add", 0.25, 0.40), ("div", 0.70, 0.80)]
HARNESS = [("bench.train_step", 0.0, 1.0)]
OPS = [("ProfilerStep#3", 0.0, 1.0), ("aten::div", 0.52, 0.58)]
PROGRAM = [(P + "step", 0.01, 0.99), (P + "sync", 0.45, 0.65),
           (P + "sync.unpack", 0.50, 0.65)]


def test_program_spans_are_no_device_work():
    plain = Trace(KERNELS, HARNESS, OPS, 0.0, 1.0)
    spanned = Trace(KERNELS, HARNESS, OPS + PROGRAM, 0.0, 1.0)
    assert spanned.busy_s == pytest.approx(plain.busy_s)
    assert spanned.busy_s == pytest.approx(0.40)
    assert spanned.top_ops() == plain.top_ops()
    assert not any(name.startswith(P) for name, _ in spanned.top_ops())


def test_gap_label_names_the_program_span():
    plain = Trace(KERNELS, HARNESS, OPS, 0.0, 1.0)
    spanned = Trace(KERNELS, HARNESS, OPS + PROGRAM, 0.0, 1.0)
    # the gap 0.40-0.70: at its middle (0.55) aten::div runs on the host
    assert plain.idle_gaps(1)[0][0] == "bench.train_step / aten::div"
    assert spanned.idle_gaps(1)[0][0] == "bench.train_step / aten::div"
    # no operator at 0.62: the innermost program span, not the profiler's
    # step range
    assert plain._host_at(0.62) == "bench.train_step / ProfilerStep#3"
    assert (spanned._host_at(0.62)
            == "bench.train_step / " + P + "sync.unpack")


def _phases(device, program, host_ops=(), t0=0.0, t1=10.0):
    return Phases(device, program, [("bench.train_step", t0, t1)],
                  list(host_ops), t0, t1)


def test_device_time_goes_to_the_launching_span():
    program = [(P + "forward", 0.0, 1.0), (P + "backward", 1.0, 2.0),
               (P + "sync", 2.0, 3.0), (P + "sync.pack", 2.0, 2.5),
               (P + "feed", 3.0, 3.2)]
    device = [
        # launched in the forward, run while the host is in the backward
        ("fwd", 0.6, 1.4, 0.5),
        # launched by another thread while the caller sits in backward
        ("bwd", 1.4, 2.5, 1.5),
        # a second stream at once: counted once
        ("bwd2", 2.0, 2.3, 1.9),
        ("pack", 2.5, 2.7, 2.2),
        ("Memcpy HtoD", 3.1, 3.3, 3.1),
        ("unknown", 4.0, 4.5, None),
    ]
    ph = _phases(device, program)
    assert ph.phase_seconds(P + "forward") == pytest.approx(0.8)
    assert ph.phase_seconds(P + "backward") == pytest.approx(1.1)
    assert ph.phase_seconds(P + "sync") == pytest.approx(0.2)
    assert ph.phase_seconds(P + "sync.pack") == pytest.approx(0.2)
    assert ph.phase_seconds(P + "update") == 0.0
    # the feed's copy is no step work; the unlinked activity is
    assert ph.step_seconds() == pytest.approx(2.1 + 0.5)
    assert ph.outside_seconds([P + "forward", P + "backward",
                               P + "sync"]) == pytest.approx(0.5)
    assert ph.unlinked() == 1
    assert ph.top_ops(P + "backward") == [["bwd", pytest.approx(1.1)],
                                          ["bwd2", pytest.approx(0.3)]]
    # idle 0-0.6 in the forward, 2.7-3.1 in the sync (its pack ended at
    # 2.5), 3.3-4.0 and 4.5-10 outside every span
    assert ph.idle_by_span() == {P + "forward": pytest.approx(0.6),
                                 P + "sync": pytest.approx(0.4),
                                 "idle": pytest.approx(6.2)}


def test_split_reports_per_step_and_the_phases_share():
    program = [(P + "step", 0.0, 4.0), (P + "forward", 0.0, 1.0),
               (P + "backward", 1.0, 2.0), (P + "sync", 2.0, 3.0),
               (P + "sync.pack", 2.0, 2.5), (P + "update", 3.0, 4.0),
               (P + "feed", 4.0, 5.0)]
    device = [("f", 0.5, 1.0, 0.5), ("b", 1.0, 2.0, 1.5),
              ("p", 2.0, 2.5, 2.2), ("u", 3.0, 3.5, 3.5),
              ("h2d", 4.0, 4.5, 4.2)]
    out = phase_split.split(_phases(device, program), steps=2)
    ms = out["device_ms"]
    assert ms["forward"] == pytest.approx(250.0)
    assert ms["sync"] == ms["sync.pack"] == pytest.approx(250.0)
    assert ms["feed"] == pytest.approx(250.0)
    assert out["step_work_ms"] == pytest.approx(1250.0)
    assert out["phases_share"] == pytest.approx(1.0)
    assert out["idle_ms_by_span"][P + "forward"] == pytest.approx(250.0)


def test_phases_clip_to_the_window():
    ph = _phases([("k", -1.0, 1.0, -1.5)], [(P + "step", -2.0, 0.5)])
    assert ph.phase_seconds(P + "step") == pytest.approx(1.0)


def test_phase_gap_labels_match_the_trace_without_program_spans():
    device = [(n, a, b, a) for n, a, b in KERNELS]
    plain = Trace(KERNELS, HARNESS, OPS, 0.0, 1.0)
    ph = Phases(device, [], HARNESS, OPS, 0.0, 1.0)
    assert ph.idle_gaps() == plain.idle_gaps()
    spanned = Phases(device, PROGRAM, HARNESS, OPS, 0.0, 1.0)
    assert (spanned.idle_gaps(1)[0][0] == "bench.train_step / "
            + P + "sync.unpack / aten::div")


class _Event:
    """A stand-in of the profiler's ``_KinetoEvent``."""

    def __init__(self, name, dev, corr, a_us, b_us, user=False):
        self._name, self._dev, self._corr = name, dev, corr
        self._a, self._b, self._user = a_us, b_us, user

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._user

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return int(self._a * 1e3)

    def end_ns(self):
        return int(self._b * 1e3)


class _Prof:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def test_from_profiler_links_launches_by_correlation():
    events = [
        _Event("bench.data_wait", False, 1, 0, 10, user=True),
        _Event("bench.data_wait", True, 1, 5, 6, user=True),
        _Event(P + "forward", False, 2, 10, 100),
        # an operator whose id equals a kernel's correlation id
        _Event("aten::mm", False, 7, 12, 30),
        _Event("cudaLaunchKernel", False, 7, 20, 25),
        _Event("gemm", True, 7, 40, 90),
        # a kernel whose launch the trace lacks
        _Event("orphan", True, 9, 95, 99),
        _Event("bench.sync", False, 3, 100, 120, user=True),
    ]
    ph = phases.from_profiler(_Prof(events),
                              ("bench.data_wait", "bench.sync"))
    assert (ph.t0, ph.t1) == (0.0, pytest.approx(120e-6))
    assert [d[0] for d in ph.device] == ["gemm", "orphan"]
    assert ph.device[0][3] == pytest.approx(20e-6)
    assert ph.device[1][3] is None
    assert [s[0] for s in ph.program] == [P + "forward"]
    assert [s[0] for s in ph.harness] == ["bench.data_wait", "bench.sync"]
    assert ph.phase_seconds(P + "forward") == pytest.approx(50e-6)
    with pytest.raises(RuntimeError):
        phases.from_profiler(_Prof(events[2:7]),
                             ("bench.data_wait", "bench.sync"))
