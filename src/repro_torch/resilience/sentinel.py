"""Divergence sentinel: bad-step detection and the skip gate around a
train step (the JAX package's ``resilience/sentinel.py``).

* **Flags.** A step is bad when its loss or its ``grad_norm`` is not
  finite, or when ``grad_norm`` exceeds ``controls["spike_threshold"]``
  (``inf`` disables the spike check). Every sync mode of the
  data-parallel step already reports the all-reduced loss and the norm
  of the synced gradient, so a NaN anywhere in any worker's gradient
  shows in both; the single-device step computes the norm when the
  launcher asks it to (``make_train_step(log_grad_norm=True)``). The
  flags are read on the host from these all-reduced scalars, so every
  worker takes the same decision and the replicas cannot diverge.

* **The skip gate.** The JAX step donates its input state and selects
  ``where(bad, old, new)`` per leaf inside the compiled program. The
  port's steps update the parameters and the optimizer state **in
  place** (``optim/interface.py``), so "old" is gone by the time the
  flag is known. The wrapped step therefore copies those tensors into
  buffers allocated once, before the step (one multi-tensor copy,
  ``torch._foreach_copy_``), and copies them back after a bad step; the
  optimizer's host ``step`` counter is put back too. The BN statistics
  and the error-feedback residuals are returned as new tensors by every
  step builder, so the wrapper keeps the old ones by reference. A bad
  step thus leaves params, optimizer (its ``step`` included), BN state
  and EF residuals exactly as they were, as if it never ran.

* **LR backoff.** With ``controls["lr_scale"] < 1`` (damped re-entry
  after a rollback) the parameters become ``old + scale * (new - old)``
  in float32 and the optimizer state advances normally. ``scale >= 1``
  leaves the step's own result untouched, so a good step is bitwise the
  unwrapped step.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tree = Dict[str, Any]

#: metric keys every sentinel-wrapped step adds (bool scalars).
SENTINEL_METRICS = ("bad_step", "nonfinite_step", "grad_spike")


def sentinel_controls(spike_threshold: float = float("inf"),
                      lr_scale: float = 1.0) -> Dict[str, float]:
    """The per-step control inputs of a wrapped step, as float32 values
    (the JAX package passes them as float32 scalars)."""
    return {"spike_threshold": float(np.float32(spike_threshold)),
            "lr_scale": float(np.float32(lr_scale))}


def _flags(metrics: Dict, threshold: float):
    """(bad, nonfinite, spike) from the step's metrics; a mode without
    ``grad_norm`` gets a loss-only check."""
    host = {k: float(metrics[k]) for k in ("loss", "grad_norm")
            if metrics.get(k) is not None}  # waits for the device
    nonfinite = "loss" in host and not math.isfinite(host["loss"])
    spike = False
    gnorm = host.get("grad_norm")
    if gnorm is not None:
        nonfinite |= not math.isfinite(gnorm)
        spike = math.isfinite(gnorm) and gnorm > threshold
    return nonfinite or spike, nonfinite, spike


def _in_place_tensors(state: Tree) -> List[torch.Tensor]:
    """The tensors a step updates in place: the parameters, every
    tensor of the optimizer state (per-leaf dicts or flat streams) and
    of the model state (``training/step.py`` ``keep_storage``); of a
    DTensor (the GSPMD step's placed state), this worker's shard."""
    out = list(state["params"].values())

    def add(tree):
        for v in tree.values():
            if isinstance(v, dict):
                add(v)
            elif torch.is_tensor(v):
                out.append(v)
    add(state["opt"])
    add(state.get("model_state", {}))
    return [t.to_local() if hasattr(t, "to_local") else t for t in out]


def wrap_step_with_sentinel(step: Callable) -> Callable:
    """Wrap a ``(state, batch) -> (state', metrics)`` train step into a
    ``(state, batch, controls) -> (state', metrics)`` resilient step
    (``controls`` from ``sentinel_controls``). Works on every step
    builder of the port: it needs only that the step report ``loss``
    (and ideally ``grad_norm``) and update params, ``opt`` and the
    model state in place."""
    backup: List[torch.Tensor] = []

    def resilient_step(state: Tree, batch: Tree, controls: Dict):
        live = _in_place_tensors(state)
        if [(t.shape, t.dtype, t.device) for t in backup] != \
                [(t.shape, t.dtype, t.device) for t in live]:
            backup[:] = [torch.empty_like(t) for t in live]
        with torch.no_grad():
            torch._foreach_copy_(backup, live)
        old_step = state["opt"]["step"]
        kept = {k: v for k, v in state.items() if k not in ("params", "opt")}
        new_state, metrics = step(state, batch)
        bad, nonfinite, spike = _flags(metrics, controls["spike_threshold"])
        scale = controls["lr_scale"]
        with torch.no_grad():
            if bad:
                torch._foreach_copy_(live, backup)
                new_state = {**new_state, **kept}
                new_state["opt"]["step"] = old_step
            elif scale < 1.0:
                params = live[:len(new_state["params"])]
                old = backup[:len(params)]
                damped = torch._foreach_sub(params, old)
                torch._foreach_mul_(damped, scale)
                torch._foreach_add_(damped, old)
                torch._foreach_copy_(params, damped)
        metrics = dict(metrics)
        metrics["bad_step"] = bad
        metrics["nonfinite_step"] = nonfinite
        metrics["grad_spike"] = spike
        return new_state, metrics

    return resilient_step
