"""The port's input pipeline (``repro_torch.data.pipeline``): the
counterparts of ``tests/test_pipeline.py`` on the port's
``DataPipeline`` (ordered delivery, restart, backpressure, the error
contract, close, the device stage, the wait counters), the
``StepStampSource``, and the CPU device stage; each stream is held
against the JAX package's ``DataPipeline`` on the same source, bitwise.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataPipeline as JPipeline
from repro_torch.data.pipeline import (
    DataPipeline,
    StepStampSource,
    host_put,
    make_put_batch,
)
from repro_torch.data.synthetic import SyntheticImageData


class CountingSource:
    """batch_at returns a recognizable payload and records every step
    (thread-safely), with an optional per-step delay or failure."""

    def __init__(self, batch=4, delay=0.0, fail_at=None, delays=None):
        self.batch = batch
        self.delay = delay
        self.fail_at = fail_at
        self.delays = delays or {}
        self.calls = []
        self._lock = threading.Lock()

    def batch_at(self, step):
        with self._lock:
            self.calls.append(step)
        time.sleep(self.delays.get(step, self.delay))
        if self.fail_at is not None and step == self.fail_at:
            raise RuntimeError(f"boom at {step}")
        return {"x": np.full((self.batch,), step, np.int64)}


@pytest.mark.parametrize("workers", [1, 4])
def test_ordered_delivery_matches_jax_pipeline(workers):
    src = SyntheticImageData(4, 8, 4, seed=3)
    pipe = DataPipeline(src, num_workers=workers, depth=4)
    jpipe = JPipeline(src, num_workers=1, depth=4)
    try:
        for want in range(6):
            (step, batch), (jstep, jbatch) = next(pipe), next(jpipe)
            assert step == jstep == want
            for k in jbatch:
                np.testing.assert_array_equal(batch[k], jbatch[k])
    finally:
        pipe.close()
        jpipe.close()


@pytest.mark.parametrize("start", [0, 3])
def test_start_step_and_transform(start):
    src = CountingSource()
    pipe = DataPipeline(src, start_step=start, num_workers=2,
                        transform=lambda b: {"x": b["x"] * 10})
    try:
        for want in range(start, start + 4):
            step, batch = next(pipe)
            assert step == want
            np.testing.assert_array_equal(batch["x"], want * 10)
    finally:
        pipe.close()


def test_backpressure_bounds_claim_horizon():
    src = CountingSource()
    depth = 3
    pipe = DataPipeline(src, num_workers=4, depth=depth)
    try:
        next(pipe)  # the consumer is at step 1 now
        time.sleep(0.3)  # give the producers every chance to overrun
        assert max(src.calls) <= depth  # claims < next_out(1) + depth
    finally:
        pipe.close()


@pytest.mark.parametrize("workers,put", [(1, False), (3, False),
                                         (2, True)])
def test_error_raised_once_at_its_step_then_stopiteration(workers, put):
    """Earlier steps still arrive, the error comes exactly once at its
    own step (also when staging ahead saw it pending), then the stream
    is closed."""
    src = CountingSource(fail_at=2)
    pipe = DataPipeline(src, num_workers=workers, depth=4,
                        put=(lambda b: b) if put else None, device_ahead=2)
    try:
        for want in range(2):
            step, _ = next(pipe)
            assert step == want
        with pytest.raises(RuntimeError, match="boom at 2"):
            next(pipe)
        with pytest.raises(StopIteration):
            next(pipe)
    finally:
        pipe.close()


def test_error_attributed_to_smallest_failed_step():
    src = CountingSource(fail_at=1, delays={0: 0.2})
    pipe = DataPipeline(src, num_workers=4, depth=4)
    try:
        step, _ = next(pipe)  # step 0, though it is the slowest
        assert step == 0
        with pytest.raises(RuntimeError, match="boom at 1"):
            next(pipe)
    finally:
        pipe.close()


def test_close_unblocks_waiting_consumer_and_is_idempotent():
    src = CountingSource(delay=60.0)  # nothing will ever be ready
    pipe = DataPipeline(src, num_workers=2, depth=2)
    got = {}

    def consume():
        try:
            next(pipe)
        except StopIteration:
            got["stopped"] = True

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.2)
    pipe.close()
    t.join(timeout=5)
    assert not t.is_alive(), "consumer stayed parked across close()"
    assert got.get("stopped")
    pipe.close()
    fast = DataPipeline(CountingSource(), num_workers=3)
    next(fast)
    fast.close()
    fast.close()
    assert all(not th.is_alive() for th in fast._threads)


def test_device_stage_orders_and_stages_each_step_once():
    staged = []

    def put(batch):
        staged.append(int(batch["x"][0]))
        return {"x": batch["x"] + 1000}

    pipe = DataPipeline(CountingSource(), num_workers=2, depth=4, put=put,
                        device_ahead=2)
    try:
        for want in range(8):
            step, batch = next(pipe)
            assert step == want
            np.testing.assert_array_equal(batch["x"], want + 1000)
        assert staged[:8] == list(range(8))
        assert len(staged) == len(set(staged))
    finally:
        pipe.close()


def test_wait_attribution_counters():
    src = CountingSource(delays={3: 0.25})
    pipe = DataPipeline(src, num_workers=1, depth=2)
    try:
        waits = []
        for _ in range(5):
            next(pipe)
            waits.append(pipe.last_wait_s)
        assert pipe.batches_delivered == 5
        assert pipe.wait_s_total == pytest.approx(sum(waits))
        assert max(waits) >= 0.1  # the slow step shows up as wait
    finally:
        pipe.close()


def test_step_stamp_source_and_cpu_put():
    src = StepStampSource(CountingSource())
    b = src.batch_at(7)
    assert b["input_step"] == np.int32(7)
    assert b["input_step"].dtype == np.int32
    np.testing.assert_array_equal(b["x"], 7)
    put = make_put_batch(torch.device("cpu"))
    out = put({**b, "labels": np.arange(3, dtype=np.int32)})
    assert out["input_step"] == 7 and isinstance(out["input_step"], int)
    assert out["labels"].dtype == torch.int64
    assert torch.equal(out["x"], torch.full((4,), 7))
    assert host_put(torch.device("cpu"))(b)["x"].device.type == "cpu"
