"""Training loop: the epoch-driven trainer of the JAX package, with its
checkpointing and fault-tolerance hooks.

``Trainer`` interleaves train steps with validation on the held-out
split at epoch boundaries, keeps per-epoch top-1 / loss history and the
best epoch, and times every step and the time it waited for its batch.
Batches come through the ``DataPipeline`` (``data/pipeline.py``): host
producer threads, an ordered reorder buffer and, with ``put_batch``, a
device stage one step ahead. The paper's BN technique lives at
validation: eval normalizes with the last minibatch's statistics, which
the data-parallel path all-reduces first (``finalize_state``; on one
device it is the identity).

With a ``checkpoint_dir`` the loop resumes from the newest intact
checkpoint (with its eval history and best epoch), saves every
``checkpoint_every`` steps in the background, keeps the best-top-1
state under ``best/`` and writes a final checkpoint, in the JAX
package's on-disk format (``interop.train_state_to_jax``). With
``resilience`` the step must be the sentinel-wrapped one
(``resilience/sentinel.py``): bad steps are skipped, a streak of them
rolls back to the last good checkpoint, a dead input worker restarts
the pipeline, and every action goes to the event log; ``chaos`` injects
faults deterministically.

On the data-parallel path (``state_shardings`` is an
``interop.WorkerSharding``) every worker runs this loop. Only the
group's first rank writes checkpoints and the event log file; each save
gathers the workers' BN state and EF residuals to it first (a
collective), so the file has the JAX package's stacked per-worker
layout. A restore is decided by that rank (the newest intact step,
after any corrupt-file fallback) and broadcast; every worker then loads
that step and takes its own row. Decisions of the recovery state
machine come from the all-reduced loss and gradient norm, so the
workers take them alike. On the GSPMD path (an ``interop.MeshSharding``)
each save gathers the placed parameters and optimizer fields whole
(the first rank writes them), and a restore places each whole array by
the state's own placements, whatever mesh saved it.

``run_training`` is the step-driven API (one epoch, no eval) on the same
loop.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, list_checkpoints, restore
from repro_torch.checkpoint.checkpointer import BEST_DIR
from repro_torch.data.pipeline import DataPipeline
from repro_torch.interop import (MeshSharding, WorkerSharding,
                                 train_state_from_jax,
                                 train_state_to_jax)
from repro_torch.resilience.events import EventLog
from repro_torch.resilience.recovery import (Action, RecoveryManager,
                                             ResilienceConfig)
from repro_torch.resilience.sentinel import SENTINEL_METRICS

Tree = Dict[str, Any]

# the state layouts of the data-parallel and the GSPMD paths
StateShardings = Union[WorkerSharding, MeshSharding]


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 1
    steps_per_epoch: int = 100
    # validation cadence: every N epochs (0 disables eval entirely);
    # the final epoch is always evaluated when eval is enabled.
    eval_every_epochs: int = 1
    val_batches: int = 4
    checkpoint_every: int = 50  # steps; 0 => final checkpoint only
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    keep_best: bool = True  # retain best-top-1 state outside the GC window
    log_every: int = 10
    # a step longer than deadline_factor x the median step time is
    # logged as a straggler event
    deadline_factor: float = 3.0
    # input pipeline: host producer threads, reorder-buffer bound, and
    # steps staged on the device past the current one (needs put_batch)
    data_workers: int = 1
    prefetch_depth: int = 4
    device_ahead: int = 1


@dataclasses.dataclass
class TrainResult:
    state: Tree
    # per-step train log {"step", "loss", "time", "data_wait"}: "time"
    # is the whole step, "data_wait" the part spent waiting for its batch
    history: list
    epoch_history: list  # per-eval {"epoch", "step", "top1", "loss"}
    straggler_events: list
    resumed_from: Optional[int]
    best: Optional[Dict]  # {"top1", "epoch", "step"} (eval enabled only)
    # resilience event records: skipped steps, rollbacks, chaos
    # injections, corrupt checkpoints skipped on restore
    events: list = dataclasses.field(default_factory=list)


class Trainer:
    """Epoch-driven train/eval loop.

    ``train_step``: (state, batch) -> (state, metrics); with
        ``resilience``, the sentinel-wrapped (state, batch, controls)
        form (``resilience.wrap_step_with_sentinel``).
    ``eval_step``: (params, model_state, batch) -> metrics dict (with
        ``top1`` for best tracking).
    ``finalize_state``: model_state -> eval model_state; None is the
        identity (one device).
    ``put_batch``: the pipeline's device stage (host batch -> device
        batch), or None to hand host batches to the step.
    ``val_data``: held-out pipeline whose ``batch_at(i)`` is disjoint
        from the training split; eval replays batches ``0..val_batches-1``
        so every epoch is scored on the same set.
    ``metadata``: written into every checkpoint's manifest, beside the
        eval history and the best epoch.
    ``state_shardings``: ``interop.WorkerSharding`` on the data-parallel
        path, ``interop.MeshSharding`` on the GSPMD path, None on one
        device.
    ``chaos``: a ``resilience.ChaosEngine`` for fault injection.
    """

    def __init__(self, train_step: Callable, state: Tree, train_data,
                 cfg: TrainerConfig, *,
                 eval_step: Optional[Callable] = None, val_data=None,
                 finalize_state: Optional[Callable] = None,
                 put_batch: Optional[Callable] = None,
                 metadata: Optional[Dict] = None,
                 state_shardings: Optional[StateShardings] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 chaos=None):
        if cfg.eval_every_epochs and eval_step is not None \
                and val_data is None:
            raise ValueError("eval enabled but no val_data given")
        self.train_step = train_step
        self.state = state
        self.train_data = train_data
        self.cfg = cfg
        self.eval_step = eval_step
        self.val_data = val_data
        self.finalize_state = finalize_state
        self.put_batch = put_batch
        self.metadata = dict(metadata or {})
        self.state_shardings = state_shardings
        self.resilience = resilience
        self.chaos = chaos
        self._val_batches = None  # built once: the held-out set is fixed

    # ------------------------------------------------------------- eval
    def _eval_enabled(self) -> bool:
        return (self.eval_step is not None
                and self.cfg.eval_every_epochs > 0
                and self.cfg.val_batches > 0)

    def evaluate(self, state: Tree, epoch: int, step: int) -> Dict:
        """One validation pass over the held-out set, metrics averaged
        over ``val_batches`` fixed batches."""
        mstate = state["model_state"]
        if self.finalize_state is not None:
            mstate = self.finalize_state(mstate)
        if self._val_batches is None:
            self._val_batches = [self.val_data.batch_at(i)
                                 for i in range(self.cfg.val_batches)]
        sums: Dict[str, float] = {}
        for batch in self._val_batches:
            metrics = self.eval_step(state["params"], mstate, batch)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        rec = {k: v / self.cfg.val_batches for k, v in sums.items()}
        rec.update(epoch=epoch, step=step)
        return rec

    # ------------------------------------------------- checkpoint i/o
    def _writer(self) -> bool:
        """Whether this process writes checkpoints and the event file."""
        return self.state_shardings is None or \
            self.state_shardings.rank() == 0

    def _ckpt_metadata(self, eval_history: List[Dict],
                       best: Optional[Dict]) -> Dict:
        # snapshot, not reference: the writer thread json.dumps it while
        # the loop keeps appending records
        meta = dict(self.metadata)
        meta["eval_history"] = [dict(r) for r in eval_history]
        if best is not None:
            meta["best"] = dict(best)
        return meta

    def _save(self, ckpt: Optional[AsyncCheckpointer], step: int,
              state: Tree, metadata: Dict, block: bool = False) -> None:
        """Snapshot the state in the JAX layout (a collective on the
        data-parallel path) and hand it to the writer's checkpointer."""
        tree = train_state_to_jax(state, self.state_shardings)
        if ckpt is not None:
            ckpt.save(step, tree, metadata=metadata, block=block)

    def _broadcast_step(self, step: int, state: Tree) -> int:
        """The first rank's ``step`` on every worker."""
        sh = self.state_shardings
        if sh is None or sh.world() == 1:
            return step
        dev = next(iter(state["params"].values())).device
        t = torch.tensor([step], dtype=torch.int64, device=dev)
        src = (dist.get_global_rank(sh.group, 0) if sh.group is not None
               else 0)
        dist.broadcast(t, src=src, group=sh.group)
        return int(t.item())

    def _restore(self, state: Tree, on_corrupt) -> Optional[Dict]:
        """Restore the newest intact checkpoint into ``state`` (in place)
        on every worker; returns its manifest, or None when there is no
        checkpoint. The first rank picks the step and broadcasts it."""
        directory = self.cfg.checkpoint_dir
        arrays = manifest = None
        step = -1  # no checkpoint
        if self._writer():
            try:
                if list_checkpoints(directory):
                    arrays, manifest = restore(directory,
                                               on_corrupt=on_corrupt)
                    step = manifest["step"]
            except BaseException:
                self._broadcast_step(-2, state)  # let the others raise
                raise
        step = self._broadcast_step(step, state)
        if step == -2:
            raise RuntimeError("the first rank failed to restore a "
                               f"checkpoint from {directory}")
        if step == -1:
            return None
        if arrays is None:  # another rank: load the step it chose
            arrays, manifest = restore(directory, step=step)
        train_state_from_jax(arrays, state, self.state_shardings)
        return manifest

    # -------------------------------------------------------------- run
    def run(self) -> TrainResult:
        cfg = self.cfg
        total_steps = cfg.epochs * cfg.steps_per_epoch
        saving = cfg.checkpoint_dir is not None
        writer = self._writer()
        ckpt = (AsyncCheckpointer(cfg.checkpoint_dir, cfg.keep_checkpoints)
                if saving and writer else None)
        # best-top-1 retention, off the hot path: keep=1 leaves exactly
        # one best checkpoint, outside the main rotating window
        keep_best = saving and self._eval_enabled() and cfg.keep_best
        best_ckpt = (AsyncCheckpointer(
            os.path.join(cfg.checkpoint_dir, BEST_DIR), keep=1)
            if keep_best and writer else None)

        # ---- resilience plumbing ----
        events = (EventLog(self.resilience.event_log
                           if self.resilience and writer else None)
                  if (self.resilience or self.chaos) is not None else None)
        manager = (RecoveryManager(self.resilience, events)
                   if self.resilience is not None else None)
        chaos = self.chaos
        if chaos is not None and chaos.events is None:
            chaos.events = events
        train_source = (chaos.wrap_source(self.train_data)
                        if chaos is not None else self.train_data)

        def on_corrupt(s, exc):  # corrupt checkpoint skipped on restore
            if events is not None:
                events.emit("corrupt_checkpoint_skipped", step=s,
                            error=str(exc))

        # ---- resume from the newest intact checkpoint, with the eval
        # trajectory and best-so-far of its manifest ----
        state = self.state
        start_step = 0
        resumed_from = None
        eval_history: List[Dict] = []
        best: Optional[Dict] = None
        manifest = self._restore(state, on_corrupt) if saving else None
        if manifest is not None:
            start_step = manifest["step"]
            resumed_from = start_step
            eval_history = list(manifest["metadata"].get(
                "eval_history", []))
            best = manifest["metadata"].get("best")

        def make_pipeline(at_step):
            return DataPipeline(
                train_source, start_step=at_step,
                depth=cfg.prefetch_depth, num_workers=cfg.data_workers,
                put=self.put_batch, device_ahead=cfg.device_ahead)

        prefetch = make_pipeline(start_step)
        history: List[Dict] = []
        straggler_events: List[Dict] = []
        step_times: List[float] = []
        last_saved = start_step if resumed_from is not None else -1
        try:
            # anchor checkpoint: rollback must always have a target, even
            # when the divergence hits before the first periodic save
            if manager is not None and saving and resumed_from is None:
                self._save(ckpt, start_step, state,
                           self._ckpt_metadata(eval_history, best))
                last_saved = start_step

            step = start_step
            data_retries_left = (self.resilience.data_retries
                                 if self.resilience else 0)
            while step < total_steps:
                if chaos is not None:
                    chaos.on_step_start(step)
                t0 = time.perf_counter()  # includes the wait for the batch
                try:
                    got_step, batch = next(prefetch)
                except Exception as exc:
                    # a dead input worker. With resilience: bounded
                    # pipeline restarts at the current step; without:
                    # propagate
                    if manager is None or data_retries_left <= 0:
                        raise
                    data_retries_left -= 1
                    events.emit("data_restart", step=step, error=str(exc),
                                retries_left=data_retries_left)
                    prefetch.close()
                    prefetch = make_pipeline(step)
                    continue
                data_wait = prefetch.last_wait_s
                if got_step != step:
                    raise RuntimeError(f"pipeline misalignment: got the "
                                       f"batch of step {got_step}, "
                                       f"expected {step}")
                if self.resilience is not None:
                    data_retries_left = self.resilience.data_retries
                if manager is not None:
                    state, metrics = self.train_step(
                        state, batch, manager.controls(step))
                else:
                    state, metrics = self.train_step(state, batch)
                loss = metrics.get("loss")
                if loss is not None:
                    loss = float(loss)  # waits for the device
                dt = time.perf_counter() - t0
                step_times.append(dt)
                med = float(np.median(step_times[-50:]))
                if len(step_times) > 5 and dt > cfg.deadline_factor * med:
                    straggler_events.append({"step": step, "time": dt,
                                             "median": med})
                    if events is not None:
                        events.emit("straggler", step=step, time=dt,
                                    median=med)

                # ---- recovery decision (before eval/save: a bad step
                # must never be checkpointed or scored) ----
                if manager is not None:
                    host = {"loss": loss}
                    for k in SENTINEL_METRICS + ("grad_norm",):
                        if k in metrics:
                            host[k] = float(metrics[k])
                    action = manager.observe(step, host)
                    if action is Action.ABORT:
                        raise RuntimeError(
                            f"training aborted at step {step}: "
                            f"{manager.cfg.max_rollbacks} rollbacks "
                            "exhausted and the step is still diverging "
                            "(see the resilience event log)")
                    if action is Action.ROLLBACK:
                        if not saving:
                            raise RuntimeError(
                                "resilience rollback requires "
                                "TrainerConfig.checkpoint_dir (no "
                                "checkpoint to restore from)")
                        if ckpt is not None:
                            ckpt.wait()  # flush in-flight save + errors
                        manifest = self._restore(state, on_corrupt)
                        restored = manifest["step"]
                        eval_history = list(manifest["metadata"].get(
                            "eval_history", []))
                        best = manifest["metadata"].get("best")
                        history = [r for r in history
                                   if r["step"] < restored]
                        prefetch.close()
                        prefetch = make_pipeline(restored)
                        manager.on_rollback(from_step=step,
                                            to_step=restored)
                        last_saved = restored
                        step = restored
                        continue
                    # CONTINUE / SKIPPED fall through: on a skipped step
                    # the sentinel put the state back; the batch is
                    # simply abandoned

                # mid-streak, hold back eval and checkpoints: the state
                # is the pre-streak state, and saving here would move
                # the rollback target past the steps that need replaying
                in_bad_streak = (manager is not None
                                 and manager.consecutive_bad > 0)

                if step % cfg.log_every == 0 or step == total_steps - 1:
                    history.append({"step": step, "loss": loss, "time": dt,
                                    "data_wait": data_wait})

                done = step + 1
                # ---- epoch boundary: the paper's eval path ----
                if self._eval_enabled() and not in_bad_streak \
                        and done % cfg.steps_per_epoch == 0:
                    epoch = done // cfg.steps_per_epoch
                    if epoch % cfg.eval_every_epochs == 0 \
                            or epoch == cfg.epochs:
                        rec = self.evaluate(state, epoch, done)
                        eval_history.append(rec)
                        top1 = rec.get("top1")
                        if top1 is not None and (best is None
                                                 or top1 > best["top1"]):
                            best = {"top1": top1, "epoch": epoch,
                                    "step": done}
                            if keep_best:
                                self._save(best_ckpt, done, state,
                                           self._ckpt_metadata(
                                               eval_history, best))
                # eval before checkpoint so a resume replays from a
                # manifest that already holds this epoch's record
                if saving and cfg.checkpoint_every and not in_bad_streak \
                        and done % cfg.checkpoint_every == 0:
                    self._save(ckpt, done, state,
                               self._ckpt_metadata(eval_history, best))
                    last_saved = done
                    if ckpt is not None and chaos is not None \
                            and chaos.has_pending_ckpt_fault(done):
                        ckpt.wait()  # land the save, then corrupt it
                        chaos.after_save(cfg.checkpoint_dir, done)
                step = done
            # final checkpoint, unless the periodic save above already
            # wrote this exact step
            if saving and last_saved != total_steps:
                self._save(ckpt, total_steps, state,
                           self._ckpt_metadata(eval_history, best),
                           block=True)
        finally:
            prefetch.close()
            if best_ckpt:
                best_ckpt.wait()
            if ckpt:
                ckpt.wait()
            if events is not None:
                events.close()
        self.state = state
        return TrainResult(state=state, history=history,
                           epoch_history=eval_history,
                           straggler_events=straggler_events,
                           resumed_from=resumed_from, best=best,
                           events=list(events.records) if events else [])


# ---------------------------------------------------------------------------
# the step-driven API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    deadline_factor: float = 3.0
    data_workers: int = 1


@dataclasses.dataclass
class LoopResult:
    state: Tree
    history: list
    straggler_events: list
    resumed_from: Optional[int]


def run_training(
    train_step: Callable,  # (state, batch) -> (state, metrics)
    state: Tree,
    data,  # has batch_at(step)
    loop_cfg: LoopConfig,
    put_batch: Optional[Callable] = None,  # host batch -> device batch
    metadata: Optional[Dict] = None,
    state_shardings: Optional[StateShardings] = None,
) -> LoopResult:
    """Step-counter training without validation: one ``Trainer`` epoch."""
    cfg = TrainerConfig(
        epochs=1, steps_per_epoch=loop_cfg.total_steps,
        eval_every_epochs=0, val_batches=0,
        checkpoint_every=loop_cfg.checkpoint_every,
        checkpoint_dir=loop_cfg.checkpoint_dir,
        keep_checkpoints=loop_cfg.keep_checkpoints,
        log_every=loop_cfg.log_every,
        deadline_factor=loop_cfg.deadline_factor,
        data_workers=loop_cfg.data_workers)
    result = Trainer(train_step, state, data, cfg, put_batch=put_batch,
                     metadata=metadata,
                     state_shardings=state_shardings).run()
    return LoopResult(state=result.state, history=result.history,
                      straggler_events=result.straggler_events,
                      resumed_from=result.resumed_from)
