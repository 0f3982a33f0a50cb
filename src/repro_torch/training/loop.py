"""Training loop: the epoch-driven trainer of the JAX package.

``Trainer`` interleaves train steps with validation on the held-out
split at epoch boundaries, keeps per-epoch top-1 / loss history and the
best epoch, and times every step and the time it waited for its batch.
Batches come through the ``DataPipeline`` (``data/pipeline.py``): host
producer threads, an ordered reorder buffer and, with ``put_batch``, a
device stage one step ahead. The paper's BN technique lives at
validation: eval normalizes with the last minibatch's statistics, which
the data-parallel path all-reduces first (``finalize_state``; on one
device it is the identity). Checkpointing and the resilience machinery
are later slices (ROADMAP queue 1, items 7 and 14): asking for them
raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.data.pipeline import DataPipeline

Tree = Dict[str, Any]


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 1
    steps_per_epoch: int = 100
    # validation cadence: every N epochs (0 disables eval entirely);
    # the final epoch is always evaluated when eval is enabled.
    eval_every_epochs: int = 1
    val_batches: int = 4
    checkpoint_dir: Optional[str] = None  # not ported yet: must be None
    log_every: int = 10
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
    best: Optional[Dict]  # {"top1", "epoch", "step"} (eval enabled only)


class Trainer:
    """Epoch-driven train/eval loop.

    ``train_step``: (state, batch) -> (state, metrics).
    ``eval_step``: (params, model_state, batch) -> metrics dict (with
        ``top1`` for best tracking).
    ``finalize_state``: model_state -> eval model_state; None is the
        identity (one device).
    ``put_batch``: the pipeline's device stage (host batch -> device
        batch), or None to hand host batches to the step.
    ``val_data``: held-out pipeline whose ``batch_at(i)`` is disjoint
        from the training split; eval replays batches ``0..val_batches-1``
        so every epoch is scored on the same set.
    """

    def __init__(self, train_step: Callable, state: Tree, train_data,
                 cfg: TrainerConfig, *,
                 eval_step: Optional[Callable] = None, val_data=None,
                 finalize_state: Optional[Callable] = None,
                 put_batch: Optional[Callable] = None,
                 resilience=None, chaos=None):
        if cfg.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointing is not ported yet (ROADMAP queue 1, item 7)")
        if resilience is not None or chaos is not None:
            raise NotImplementedError(
                "the resilience machinery is not ported yet (ROADMAP "
                "queue 1, item 14)")
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
        self._val_batches = None  # built once: the held-out set is fixed

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

    def run(self) -> TrainResult:
        cfg = self.cfg
        total_steps = cfg.epochs * cfg.steps_per_epoch
        state = self.state
        history: List[Dict] = []
        eval_history: List[Dict] = []
        best: Optional[Dict] = None
        pipeline = DataPipeline(
            self.train_data, start_step=0, depth=cfg.prefetch_depth,
            num_workers=cfg.data_workers, put=self.put_batch,
            device_ahead=cfg.device_ahead)
        try:
            for step in range(total_steps):
                t0 = time.perf_counter()  # includes the wait for the batch
                got_step, batch = next(pipeline)
                if got_step != step:
                    raise RuntimeError(f"pipeline misalignment: got the "
                                       f"batch of step {got_step}, "
                                       f"expected {step}")
                data_wait = pipeline.last_wait_s
                state, metrics = self.train_step(state, batch)
                loss = metrics.get("loss")
                if loss is not None:
                    loss = float(loss)  # waits for the device
                dt = time.perf_counter() - t0
                if step % cfg.log_every == 0 or step == total_steps - 1:
                    history.append({"step": step, "loss": loss, "time": dt,
                                    "data_wait": data_wait})
                done = step + 1
                if self._eval_enabled() and done % cfg.steps_per_epoch == 0:
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
        finally:
            pipeline.close()
        self.state = state
        return TrainResult(state=state, history=history,
                           epoch_history=eval_history, best=best)
