"""Fault-tolerant training (the JAX package's ``resilience``).

* ``sentinel``      — bad-step detection (non-finite loss or gradient
                      norm, an EMA spike threshold) and a skip gate that
                      puts the in-place-updated state back after a bad
                      step.
* ``recovery``      — host-side state machine: skip, then after K
                      consecutive bad steps restore-from-last-good
                      checkpoint with LR backoff and bounded retries.
* ``events``        — structured JSON-lines event log every recovery
                      action is emitted to.
* ``chaos``         — deterministic, seed-driven fault injection
                      (``--chaos`` in launch/train.py).
"""
from repro_torch.resilience.chaos import ChaosEngine, ChaosError, parse_chaos
from repro_torch.resilience.events import EventLog
from repro_torch.resilience.recovery import (
    Action,
    RecoveryManager,
    ResilienceConfig,
)
from repro_torch.resilience.sentinel import (
    SENTINEL_METRICS,
    sentinel_controls,
    wrap_step_with_sentinel,
)

__all__ = [
    "Action",
    "ChaosEngine",
    "ChaosError",
    "EventLog",
    "RecoveryManager",
    "ResilienceConfig",
    "SENTINEL_METRICS",
    "parse_chaos",
    "sentinel_controls",
    "wrap_step_with_sentinel",
]
