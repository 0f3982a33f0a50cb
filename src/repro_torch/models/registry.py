"""Model registry: arch family -> model class (conv family so far; the
LM families are ROADMAP queue 1, item 15)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.resnet import ResNet50

_FAMILIES = {"conv": ResNet50}


def build_model(cfg: ModelConfig, compute_dtype=torch.bfloat16, *,
                seed: int = 0, device: DeviceLike = "cuda") -> Any:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"arch family {cfg.family!r} is not ported yet (ROADMAP "
            "queue 1, item 15); the port has the conv family")
    return _FAMILIES[cfg.family](cfg, compute_dtype=compute_dtype,
                                 seed=seed, device=device)


def init_model_state(model) -> Dict:
    """BN-bearing models carry last-minibatch stats; others empty."""
    if hasattr(model, "init_state"):
        return model.init_state()
    return {}
