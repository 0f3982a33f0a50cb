"""Minimal optimizer interface, as in the JAX package.

An ``Optimizer`` owns its schedule closures; ``update`` maps
(params, grads, state) -> (params', state', metrics). State layout:

    {"step": int, "delta": {name: tensor}, "m": {name: tensor}?}

The port updates parameters and state **in place** (it returns the same
dicts): that saves a second copy of the parameters and the optimizer
state, and keeps a model's own ``nn.Parameter``s current when the train
state holds them. ``step`` is a host integer, so computing the schedule
never waits on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Dict[str, torch.Tensor]], Tree]
    update: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                      Tree], Tuple[Dict[str, torch.Tensor], Tree, Dict]]


def tree_zeros_like(params: Dict[str, torch.Tensor],
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
            for k, p in params.items()}


def epoch_of(step: int, steps_per_epoch: int) -> torch.Tensor:
    """float32(step) / steps_per_epoch, as the JAX step computes it."""
    return torch.tensor(step, dtype=torch.float32) / steps_per_epoch
