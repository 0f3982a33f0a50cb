"""One run of a training cell, on one worker of ``world``.

Set-up builds the program's train step once, loads the benchmark's
initial weights into it, makes the traffic's pool of batches and drives
the step from step 0 through the window's own loop: its first
``CHECK_STEPS`` steps are the ones the reference follows (the program's
readings are taken between them), the rest of ``warmup_steps`` warm every
shape and the allocator. Then the window: steps back to back in a closed
loop for ``seconds`` (``--trace 0``), or ``trace_steps`` steps under
``torch.profiler`` (``--trace 1``). Each step is timed as the port's
``Trainer`` times it: from the wait for its batch to the read of its
loss. After the window the program is freed and the reference runs its
``CHECK_STEPS`` steps from the same weights and batches.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from harness import counts, judge, weights
from harness.trace import Trace, from_profiler
from reference.common import Precision
from reference.train import follow, task_for
from traffic.generate import PoolSource, make_pool, pinned

CHECK_STEPS = 3


def _no_span(name: str):
    return contextlib.nullcontext()


def log(msg: str) -> None:
    """A timestamped line on standard error (set-up's phases)."""
    print(f"[{time.perf_counter():10.3f}] {msg}", file=sys.stderr, flush=True)


class Run:
    """What a metric reader reads of one run."""

    def __init__(self, cfg: Dict, mix: Dict, world: int):
        self.cfg, self.mix, self.world = cfg, mix, world
        self.setup_s = 0.0
        self.window_s = 0.0
        self.step_s: List[float] = []
        self.data_wait_s: List[float] = []
        self.step_host_s: List[float] = []
        # the traced steps' wall times (the profiler slows the host)
        self.traced_step_s: List[float] = []
        self.peak_bytes = 0
        self.trace: Optional[Trace] = None
        self.busy_s: Optional[float] = None

    @property
    def steps(self) -> int:
        return len(self.step_s)

    @property
    def images_per_step(self) -> int:
        return self.mix["batch"] * self.world

    @property
    def tokens_per_step(self) -> int:
        return self.mix["batch"] * self.mix.get("seq_len", 0) * self.world

    def busy_share(self) -> Optional[float]:
        """Device work of a traced step over an untraced step's wall
        time: the share of the window in which the device works, with
        the profiler's own host cost left out."""
        if self.trace is None or not self.steps or not self.traced_step_s:
            return None
        per_step = self.busy_s / len(self.traced_step_s)
        return per_step * self.steps / self.window_s

    def step_flops(self) -> float:
        """Model FLOPs of one step on one worker."""
        return counts.step_flops(self.cfg, self.mix)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    """The program driven through set-up, window and check."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 rank: int = 0, world: int = 1,
                 wrap_step: Optional[Callable] = None):
        from harness.program import Program
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.rank, self.world = rank, world
        self.task = task_for(cfg)
        log("building the program's train step")
        self.prog = Program(cfg, mix, seed % 2 ** 31, device, world)
        self.device = self.prog.device
        log("drawing the weights")
        w = weights.make(self.task.leaves, seed, self.device)
        self.prog.load_weights(w)
        del w
        log("making the traffic's pool")
        self.pool = make_pool(mix, cfg["model"], seed, rank, self.device)
        feed = pinned(self.pool) if self.device.type == "cuda" else self.pool
        log("pool made")
        stamp = bool(cfg.get("input", {}).get("fused"))
        self.pipe = self.prog.pipeline(PoolSource(feed, stamp),
                                       mix.get("data_workers", 1), 4)
        self.step_fn = self.prog.train_step
        if wrap_step is not None:
            self.step_fn = wrap_step(self.prog, self.step_fn)
        self.readings: Dict = {"losses": []}
        self.failed = 0

    def _step(self, span) -> tuple:
        """One step: (seconds, in the pipeline, in the step call, loss)."""
        t0 = time.perf_counter()
        with span("bench.data_wait"):
            _, batch = next(self.pipe)
        t1 = time.perf_counter()
        with span("bench.train_step"):
            self.prog.state, metrics = self.step_fn(self.prog.state, batch)
        t2 = time.perf_counter()
        with span("bench.loss_read"):
            loss = float(metrics["loss"])
        return time.perf_counter() - t0, t1 - t0, t2 - t1, loss

    def warm_up(self) -> None:
        """The checked steps, with the program's readings between them,
        then the rest of the warm-up."""
        mu2 = self.cfg["optimizer"]["mu2"]
        names = [leaf.name for leaf in self.task.leaves]
        for i in range(max(self.mix["warmup_steps"], CHECK_STEPS)):
            dt, _, _, loss = self._step(_no_span)
            log(f"warm-up step {i}: {dt * 1e3:.1f} ms, loss {loss:.5f}")
            if i < CHECK_STEPS:
                self.readings["losses"].append(loss)
            if i == 0:
                # m = (1 - mu2) g^2 after one step from zero
                m = weights.leaf_sums(self.prog.opt_field("m"), names)
                self.readings["grad1"] = {k: math.sqrt(v / (1.0 - mu2))
                                          for k, v in m.items()}
                bn = self.prog.bn_stats()
                self.readings["bn"] = weights.leaf_norms(bn, list(bn))
            if i == CHECK_STEPS - 1:
                self.readings["change"] = weights.change_norms(
                    self.task.leaves, self.seed, self.prog.params)
                self.readings["delta"] = weights.leaf_norms(
                    self.prog.opt_field("delta"), names)
        _sync(self.device)

    def window(self, run: Run, seconds: float) -> None:
        """Closed loop for ``seconds``; the last step synced."""
        start = time.perf_counter()
        while True:
            dt, wait, host, loss = self._step(_no_span)
            run.step_s.append(dt)
            run.data_wait_s.append(wait)
            run.step_host_s.append(host)
            self.failed += not math.isfinite(loss)
            if time.perf_counter() - start >= seconds:
                break
        _sync(self.device)
        run.window_s = time.perf_counter() - start
        q = statistics.quantiles(run.step_s, n=4) if run.steps > 1 else []
        n = run.steps // 4
        fourths = [round(statistics.median(run.step_s[i * n:(i + 1) * n])
                         * 1e3, 2) for i in range(4)] if n else []
        log(f"window: {run.steps} steps in {run.window_s:.3f} s, step "
            f"quartiles {[round(v * 1e3, 2) for v in q]} ms, median step "
            f"of each fourth {fourths} ms, mean in the feed "
            f"{statistics.mean(run.data_wait_s) * 1e3:.2f} ms, in the "
            f"step call {statistics.mean(run.step_host_s) * 1e3:.2f} ms")

    def traced_window(self, run: Run, steps: int, warm: int = 2) -> None:
        """``steps`` more steps under the profiler (CPU and CUDA
        activity), after ``warm`` steps that start it untimed."""
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        plan = schedule(wait=0, warmup=warm, active=steps, repeat=1)
        with profile(activities=acts, schedule=plan) as prof:
            for i in range(warm + steps):
                dt, _, _, loss = self._step(record_function)
                if i >= warm:
                    run.traced_step_s.append(dt)
                    self.failed += not math.isfinite(loss)
                if i == warm + steps - 1:
                    with record_function("bench.sync"):
                        _sync(self.device)
                prof.step()
        run.trace = from_profiler(prof, ("bench.data_wait", "bench.sync"))
        run.busy_s = self.prog.group_mean(run.trace.busy_s)

    def finish(self, run: Optional[Run] = None) -> None:
        """Read the peak into ``run``, stop the pipeline and free the
        program."""
        if run is not None and self.device.type == "cuda":
            run.peak_bytes = int(self.prog.group_max(
                float(torch.cuda.max_memory_allocated(self.device))))
        self.pipe.close()
        self.prog.close()
        self.prog = self.pipe = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check_batches(self, count: int) -> List[List[Dict]]:
        """Every worker's batch of the first ``count`` steps, as the
        reference reads them."""
        mix = dict(self.mix, pool_batches=count)
        out: List[List[Dict]] = [[] for _ in range(count)]
        for r in range(self.world):
            pool = (self.pool[:count] if r == self.rank
                    else make_pool(mix, self.cfg["model"], self.seed, r,
                                   self.device))
            for t in range(count):
                out[t].append(dict(pool[t], row_offset=r * self.mix["batch"],
                                   global_rows=self.mix["batch"] * self.world))
        return out

    def reference(self, prec: Precision = Precision(),
                  fault: Optional[str] = None) -> Dict:
        """The reference's readings of the checked steps (with ``prec``
        the control's precision, with ``fault`` a planted fault)."""
        w = weights.make(self.task.leaves, self.seed, self.device)
        return follow(self.cfg, w, self.check_batches(CHECK_STEPS),
                      self.seed % 2 ** 31, self.device, prec, fault)


def check(session: Session, cell: str,
          limits: Optional[Dict[str, float]] = None) -> tuple:
    """(correct, {number: (value, limit, where)}) of a finished run,
    against the cell's limits (or ``limits``)."""
    ref = session.reference()
    nums = judge.numbers(session.readings, ref)
    limits = judge.load_limits(cell) if limits is None else limits
    table = {k: (nums[k][0], lim, nums[k][1]) for k, lim in limits.items()}
    return judge.verdict(nums, limits) and session.failed == 0, table
