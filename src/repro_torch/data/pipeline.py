"""The input pipeline: a multi-worker host feed with an ordered reorder
buffer, and a device stage one step ahead (the JAX package's
``data/pipeline.py``).

1. **Host producers.** ``num_workers`` threads claim step numbers from a
   shared counter and call ``source.batch_at(step)`` concurrently; every
   sample is keyed by ``(seed, split, step, index)`` (``synthetic.py``),
   so steps are independent and order is only a delivery matter. The
   producers never touch CUDA.
2. **Ordered reorder buffer.** Finished batches wait in a dict keyed by
   step; the consumer takes them strictly in step order. Producers may
   claim at most ``depth`` steps past the last delivered one, so a
   stalled consumer stalls them instead of buffering without bound.
3. **Device stage.** With a ``put`` callable, the next step's batch is
   staged onto the device on the consumer's thread while the caller
   computes the current one. ``CudaStager`` is the card's ``put``: it
   copies the host arrays into pinned memory and issues the copies on a
   side CUDA stream; when the batch is delivered, the consumer's stream
   waits on the copies' event and each tensor is marked used on that
   stream (``record_stream``), so the allocator never hands its memory
   out early.

Error contract: a producer's exception is kept with its step (the
earliest failed step wins) and raised from ``next()`` when the consumer
*reaches* that step, exactly once; later calls raise ``StopIteration``.
``close()`` is race-free against blocked consumers and producers: all
wait on one condition variable and re-check the closed flag.

``wait_s_total`` / ``last_wait_s`` accrue the time the consumer spent
blocked on the host stage: about zero when the feed keeps ahead.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels.fused_input import input_augment_params


class DataPipeline:
    """Multi-worker, step-ordered, optionally device-staged prefetcher
    over ``source.batch_at(step)``; iterates ``(step, batch)``.

    Args:
      source: object with ``batch_at(step) -> dict of np.ndarray``.
      start_step: first step to produce.
      depth: producers run at most ``depth`` steps ahead of the consumer.
      transform: host-side callable applied by the producing thread.
      num_workers: producer thread count (>= 1).
      put: optional device-staging callable, applied on the consumer's
        thread ``device_ahead`` steps ahead of delivery.
      device_ahead: steps staged through ``put`` beyond the one returned
        (0 disables staging even with ``put``).
    """

    def __init__(self, source, start_step: int = 0, depth: int = 4,
                 transform: Optional[Callable[[Any], Any]] = None,
                 *, num_workers: int = 1,
                 put: Optional[Callable[[Any], Any]] = None,
                 device_ahead: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.source = source
        self.transform = transform
        self.num_workers = num_workers
        self._put = put
        self._device_ahead = max(0, device_ahead) if put is not None else 0
        self._depth = depth
        self._cv = threading.Condition()
        self._ready: Dict[int, Any] = {}  # step -> host batch
        self._next_claim = start_step  # next step a producer takes
        self._next_out = start_step  # next step the consumer needs
        self._closed = False
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None
        self._raised = False
        self._staged: deque = deque()  # (step, staged batch), step order
        self.wait_s_total = 0.0
        self.last_wait_s = 0.0
        self.batches_delivered = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"data-worker-{i}")
            for i in range(num_workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ producers

    def _worker(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed or self._error is not None:
                        return
                    if self._next_claim < self._next_out + self._depth:
                        step = self._next_claim
                        self._next_claim += 1
                        break
                    self._cv.wait(timeout=0.1)
            try:
                batch = self.source.batch_at(step)
                if self.transform is not None:
                    batch = self.transform(batch)
            except BaseException as e:
                with self._cv:
                    # the smallest failed step is the one the consumer
                    # meets first; later ones may only be its consequence
                    if self._error is None or step < self._error_step:
                        self._error = e
                        self._error_step = step
                    self._cv.notify_all()
                return
            with self._cv:
                if self._closed:
                    return
                self._ready[step] = batch
                self._cv.notify_all()

    # ------------------------------------------------------------- consumer

    def _host_get(self, step: int, block: bool):
        """Take ``step``'s host batch. Raises a producer's error only
        once the consumer has reached the failed step; non-blocking mode
        returns None when the batch is not ready and never raises."""
        with self._cv:
            while True:
                if step in self._ready:
                    batch = self._ready.pop(step)
                    self._cv.notify_all()  # frees a claim slot
                    return batch
                if not block:
                    return None
                if self._error is not None and self._error_step <= step:
                    if self._raised:
                        raise StopIteration
                    self._raised = True
                    raise self._error
                if self._closed:
                    raise StopIteration
                self._cv.wait(timeout=0.1)

    def _stage_through(self, step: int) -> None:
        """Push host batches up to ``step`` through the device stage, as
        far as they are ready (non-blocking)."""
        last = self._staged[-1][0] if self._staged else self._next_out - 1
        while last < step:
            host = self._host_get(last + 1, block=False)
            if host is None:
                return
            last += 1
            self._staged.append((last, self._put(host)))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step = self._next_out
        t0 = time.perf_counter()
        if self._put is not None:
            if not (self._staged and self._staged[0][0] == step):
                # cold start, or staging fell behind: block for this step
                self._staged.append(
                    (step, self._put(self._host_get(step, block=True))))
            wait = time.perf_counter() - t0
            _, batch = self._staged.popleft()
            if isinstance(batch, StagedBatch):
                batch = batch.take()
        else:
            batch = self._host_get(step, block=True)
            wait = time.perf_counter() - t0
        self._next_out = step + 1
        with self._cv:
            self._cv.notify_all()
        if self._put is not None:
            # stage the next steps while the caller computes this one
            self._stage_through(step + self._device_ahead)
        self.last_wait_s = wait
        self.wait_s_total += wait
        self.batches_delivered += 1
        return step, batch

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)
        with self._cv:
            self._ready.clear()
            self._staged.clear()


class StagedBatch:
    """A batch whose host-to-device copies were issued on a side stream;
    ``take()`` makes the current stream wait for them and returns the
    batch (device tensors and host scalars)."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 scalars: Dict[str, int], event, device: torch.device):
        self.tensors = tensors
        self.scalars = scalars
        self.event = event
        self.device = device

    def take(self) -> Dict[str, Any]:
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(cur)
        return {**self.tensors, **self.scalars}


def _split_scalars(batch: Dict[str, Any]):
    """(host arrays as tensors, scalars as ints); labels become int64."""
    arrays, scalars = {}, {}
    for k, v in batch.items():
        if np.ndim(v) == 0 and not torch.is_tensor(v):
            scalars[k] = int(v)
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(
            np.ascontiguousarray(v))
        arrays[k] = t.long() if k == "labels" else t
    return arrays, scalars


class CudaStager:
    """The card's ``put`` stage: host arrays -> pinned memory -> device
    tensors, copied on a side stream; scalars such as the ``input_step``
    stamp stay host integers. ``staged`` counts the batches staged."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self.staged = 0

    def __call__(self, batch: Dict[str, Any]) -> StagedBatch:
        arrays, scalars = _split_scalars(batch)
        pinned = {k: t.pin_memory() for k, t in arrays.items()}
        with torch.cuda.stream(self.stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        self.staged += 1
        return StagedBatch(out, scalars, event, self.device)


def host_put(device: torch.device) -> Callable[[Dict[str, Any]], Dict]:
    """The CPU's ``put`` stage: host arrays -> tensors on ``device``
    (labels int64, scalars kept as host integers)."""
    def put(batch):
        arrays, scalars = _split_scalars(batch)
        return {**{k: t.to(device) for k, t in arrays.items()}, **scalars}
    return put


def make_put_batch(device: torch.device):
    """The device stage for ``device``: ``CudaStager`` on a card,
    ``host_put`` on the CPU."""
    device = torch.device(device)
    return CudaStager(device) if device.type == "cuda" else host_put(device)


class AugmentedSource:
    """Host-path augmentation, the numpy mirror of the fused input
    kernel: per-sample horizontal flip and cyclic translation, then the
    per-channel normalize, with parameters from the port's
    ``input_augment_params`` drawn at the *global* batch size and sliced
    at this shard's offset, so the host path and the fused path apply
    the same transform (bitwise equal in float32). ``train=False``
    normalizes only (the eval variant)."""

    def __init__(self, source, seed: int, mean, std, max_shift: int = 4,
                 train: bool = True, global_batch: Optional[int] = None):
        self.source = source
        self.seed = seed
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
        self.inv_std = (np.float32(1.0)
                        / np.asarray(std, np.float32)).reshape(1, 1, 1, -1)
        self.max_shift = max_shift
        self.train = train
        self.sample_offset = getattr(source, "sample_offset", 0)
        self.global_batch = (global_batch if global_batch is not None
                             else self.sample_offset + source.batch)

    @property
    def batch(self) -> int:
        return self.source.batch

    def batch_at(self, step: int) -> Dict[str, Any]:
        batch = dict(self.source.batch_at(step))
        x = batch["images"].astype(np.float32, copy=True)
        if self.train:
            b = x.shape[0]
            params = input_augment_params(self.seed, step, self.global_batch,
                                          max_shift=self.max_shift)
            params = params[self.sample_offset:self.sample_offset + b]
            for j in range(b):
                flip, dy, dx, _ = (int(v) for v in params[j])
                img = x[j]
                if flip:
                    img = img[:, ::-1, :]
                x[j] = np.roll(img, (dy, dx), axis=(0, 1))
        batch["images"] = (x - self.mean) * self.inv_std
        return batch


class StepStampSource:
    """Wraps a source so each batch carries its step number as an
    ``input_step`` scalar: the seed material of the fused input
    kernel's augmentation parameters."""

    def __init__(self, source):
        self.source = source
        self.sample_offset = getattr(source, "sample_offset", 0)

    @property
    def batch(self) -> int:
        return self.source.batch

    def batch_at(self, step: int) -> Dict[str, Any]:
        batch = dict(self.source.batch_at(step))
        batch["input_step"] = np.int32(step)
        return batch
