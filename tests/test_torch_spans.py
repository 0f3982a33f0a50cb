"""The port's spans (``repro_torch.spans``): one data-parallel step of
the reduced ResNet-50 on a one-worker gloo group under ``torch.profiler``
(CPU activity) records ``step`` holding ``input``, ``forward``,
``backward``, ``sync`` (``sync.pack``, one ``sync.all_reduce`` per
bucket of the plan, ``sync.unpack``) and ``update``, in that order; the
pipeline's ``next()`` records ``feed`` holding ``feed.wait`` and
``feed.stage``. Without a profiler a step enters no profiler range.
The benchmark's readers (``bench/harness/trace.py``, ``phases.py``) file
the spans of a real profile as the port's: host operators to
``trace.py``, program spans to ``phases.py``, never device work."""
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.configs import OptimizerConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataPipeline, host_put
from repro_torch.distributed import init_workers, shutdown
from repro_torch.distributed.bucketing import plan_buckets
from repro_torch.launch.train import build_train_setup

BENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "bench")
BATCH = 4
# small enough that the reduced ResNet's bf16 stream takes several buckets
BUCKET_BYTES = 64 * 1024


@pytest.fixture
def dp_step(tmp_path):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        _, state, step, data, put, _ = build_train_setup(
            reduced_config(get_config("resnet50")), global_batch=BATCH,
            seq_len=0, opt_cfg=OptimizerConfig(), steps_per_epoch=4,
            dp_mode="shardmap", compression="bf16+bucketed",
            bucket_bytes=BUCKET_BYTES, device="cpu")
        yield state, step, data, put
    finally:
        shutdown()


def _spans(prof):
    """The port's ranges, (name without the prefix, start, end), by
    start."""
    out = [(e.name[len(spans.PREFIX):], e.time_range.start,
            e.time_range.end) for e in prof.events()
           if e.name.startswith(spans.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_dp_step_spans_nest_in_order(dp_step):
    state, step, data, put = dp_step
    n_buckets = plan_buckets(state["params"], BUCKET_BYTES,
                             "bf16").n_buckets
    assert n_buckets > 1
    batch = put(data.batch_at(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    got = _spans(prof)
    names = [s[0] for s in got]
    assert names == (["step", "input", "forward", "backward", "sync",
                      "sync.pack"] + ["sync.all_reduce"] * n_buckets
                     + ["sync.unpack", "update"])
    root, rest = got[0], got[1:]
    assert all(_inside(s, root) for s in rest)
    sync = got[names.index("sync")]
    phases = [s for s in rest if "." not in s[0]]
    for a, b in zip(phases, phases[1:]):
        assert a[2] <= b[1], (a, b)  # one after the other
    for s in rest:
        if s is not sync:
            assert _inside(s, sync) == s[0].startswith("sync."), s


def test_feed_spans(dp_step):
    _, _, data, _ = dp_step
    pipe = DataPipeline(data, depth=2, put=host_put(torch.device("cpu")),
                        device_ahead=1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step, _ = next(pipe)
    finally:
        pipe.close()
    assert step == 0
    got = _spans(prof)
    assert got[0][0] == "feed"
    # cold start: block for step 0, stage it; then stage step 1 if ready
    assert [s[0] for s in got[1:3]] == ["feed.wait", "feed.stage"]
    assert {s[0] for s in got[3:]} <= {"feed.stage"}
    assert all(_inside(s, got[0]) for s in got[1:])


def test_no_profiler_enters_no_range(dp_step, monkeypatch):
    state, step, data, put = dp_step
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    state, _ = step(state, put(data.batch_at(0)))
    assert entered == []
    # the same step under a profiler goes through the patched range
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, put(data.batch_at(1)))
    assert entered[0] == spans.PREFIX + "step"


def test_the_benchmark_files_the_spans_as_the_ports(dp_step):
    sys.path.insert(0, BENCH)
    from harness import phases, trace
    assert spans.PREFIX == phases.PROGRAM_PREFIX
    assert not spans.PREFIX.startswith(trace.SPAN_PREFIX)
    state, step, data, put = dp_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.data_wait"):
            batch = put(data.batch_at(0))
        with record_function("bench.train_step"):
            step(state, batch)
        with record_function("bench.sync"):
            pass
    window = ("bench.data_wait", "bench.sync")
    tr = trace.from_profiler(prof, window)
    ours = {n for n, _, _ in tr.host_ops if n.startswith(spans.PREFIX)}
    assert {spans.PREFIX + n for n in ("step", "forward", "sync.unpack",
                                       "update")} <= ours
    assert not [n for n, _, _ in tr.spans + tr.device
                if n.startswith(spans.PREFIX)]
    ph = phases.from_profiler(prof, window)
    assert {n for n, _, _ in ph.program} == ours
    assert {n for n, _, _ in ph.harness} == {"bench.data_wait",
                                             "bench.train_step",
                                             "bench.sync"}
    assert ph.device == [] and ph.phase_seconds(spans.PREFIX + "step") == 0
