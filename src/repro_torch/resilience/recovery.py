"""Recovery state machine: skip -> rollback -> bounded retries (the JAX
package's ``resilience/recovery.py``).

The sentinel (``sentinel.py``) already undid the bad update inside the
wrapped step; this module is the host-side policy that decides what
happens *next*. It is deliberately a plain state machine driven by the
training loop (``training/loop.py:Trainer``):

    good step     -> feed the EMA spike detector, reset the bad streak
    bad step      -> emit ``step_skipped``; the state was carried over
                     unchanged, the batch is abandoned (a transient
                     fault costs exactly one minibatch)
    K bad in a row-> ``rollback``: the loop restores the last good
                     checkpoint (falling back past corrupt ones,
                     checkpoint/checkpointer.py), rewinds the data
                     pipeline to the restored step, and re-enters with
                     the LR damped by ``lr_backoff**n_rollbacks`` for
                     ``backoff_steps`` steps
    budget spent  -> ``abort``: after ``max_rollbacks`` restores the
                     run raises instead of looping forever

The EMA spike detector arms after ``warmup_steps`` good steps and flags
``grad_norm > spike_factor * ema`` — the "loss blew up but is still
finite" divergence mode that non-finite checks alone miss. Thresholds
ride into the wrapped step as inputs (``sentinel.sentinel_controls``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

from repro_torch.resilience.events import EventLog
from repro_torch.resilience.sentinel import sentinel_controls


class Action(enum.Enum):
    CONTINUE = "continue"
    SKIPPED = "skipped"
    ROLLBACK = "rollback"
    ABORT = "abort"


@dataclasses.dataclass
class ResilienceConfig:
    """Policy knobs for the sentinel + recovery state machine."""

    max_consecutive_bad: int = 3  # K bad steps before a rollback
    max_rollbacks: int = 3  # bounded retries; exceeded -> abort
    lr_backoff: float = 0.5  # LR scale multiplier per rollback
    backoff_steps: int = 10  # damped steps after each rollback
    spike_factor: float = 0.0  # grad_norm > factor*EMA flags a spike
    #                            (0 disables spike detection)
    ema_decay: float = 0.9  # grad-norm EMA decay (good steps only)
    warmup_steps: int = 10  # good steps before the spike check arms
    data_retries: int = 2  # prefetcher crash restarts per step
    event_log: Optional[str] = None  # JSONL path (None: in-memory only)


class RecoveryManager:
    """Drives one training run's recovery decisions.

    The Trainer calls ``controls()`` before each step (the inputs of
    the sentinel gate), ``observe(step, metrics)`` after it (the
    decision), and ``on_rollback(from_step, to_step)`` when it has
    actually restored a checkpoint."""

    def __init__(self, cfg: ResilienceConfig, events: EventLog):
        self.cfg = cfg
        self.events = events
        self.consecutive_bad = 0
        self.n_rollbacks = 0
        self.n_skipped = 0
        self._ema: Optional[float] = None
        self._good_steps = 0
        self._damped_until = -1  # step index the LR damping expires at

    # ---------------------------------------------------------- inputs
    def spike_threshold(self) -> float:
        if (self.cfg.spike_factor <= 0.0 or self._ema is None
                or self._good_steps < self.cfg.warmup_steps):
            return float("inf")
        return self.cfg.spike_factor * self._ema

    def lr_scale(self, step: int) -> float:
        if step < self._damped_until and self.n_rollbacks:
            return self.cfg.lr_backoff ** self.n_rollbacks
        return 1.0

    def controls(self, step: int) -> Dict:
        return sentinel_controls(spike_threshold=self.spike_threshold(),
                                 lr_scale=self.lr_scale(step))

    # -------------------------------------------------------- decision
    def observe(self, step: int, metrics: Dict) -> Action:
        """``metrics`` are host-side floats for this completed step
        (must contain ``bad_step``; ``loss``/``grad_norm``/
        ``nonfinite_step``/``grad_spike`` are used when present)."""
        bad = bool(metrics.get("bad_step", 0.0))
        if not bad:
            self.consecutive_bad = 0
            self._good_steps += 1
            gnorm = metrics.get("grad_norm")
            if gnorm is not None and _finite(gnorm):
                d = self.cfg.ema_decay
                self._ema = (float(gnorm) if self._ema is None
                             else d * self._ema + (1.0 - d) * float(gnorm))
            return Action.CONTINUE
        self.consecutive_bad += 1
        self.n_skipped += 1
        self.events.emit(
            "step_skipped", step=step,
            consecutive_bad=self.consecutive_bad,
            nonfinite=bool(metrics.get("nonfinite_step", 0.0)),
            spike=bool(metrics.get("grad_spike", 0.0)),
            loss=_as_float(metrics.get("loss")),
            grad_norm=_as_float(metrics.get("grad_norm")),
            spike_threshold=self.spike_threshold())
        if self.consecutive_bad < self.cfg.max_consecutive_bad:
            return Action.SKIPPED
        if self.n_rollbacks >= self.cfg.max_rollbacks:
            self.events.emit("abort", step=step,
                             rollbacks=self.n_rollbacks,
                             max_rollbacks=self.cfg.max_rollbacks)
            return Action.ABORT
        return Action.ROLLBACK

    def on_rollback(self, from_step: int, to_step: int):
        self.n_rollbacks += 1
        self.consecutive_bad = 0
        # the restored regime may have a very different gradient scale;
        # re-learn the EMA before re-arming the spike check
        self._ema = None
        self._good_steps = 0
        self._damped_until = to_step + self.cfg.backoff_steps
        self.events.emit("rollback", from_step=from_step, to_step=to_step,
                         n_rollbacks=self.n_rollbacks,
                         wasted_steps=from_step - to_step,
                         lr_scale=self.cfg.lr_backoff ** self.n_rollbacks,
                         backoff_steps=self.cfg.backoff_steps)


def _as_float(v) -> Optional[float]:
    return None if v is None else float(v)


def _finite(v) -> bool:
    import math

    return math.isfinite(float(v))
