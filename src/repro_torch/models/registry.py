"""Model registry: arch family -> model class (the conv family, ResNet-50,
and the dense LM family; the other LM families are ROADMAP queue 1,
item 15)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.resnet import ResNet50
from repro_torch.models.transformer import TransformerLM

_FAMILIES = {"conv": ResNet50, "dense": TransformerLM}


def build_model(cfg: ModelConfig, compute_dtype=torch.bfloat16, *,
                attention_impl: str = "chunked", seed: int = 0,
                device: DeviceLike = "cuda", bn_group=None) -> Any:
    """The model of ``cfg``'s family. ResNet-50 draws its parameters from
    ``seed`` here; an LM's come from ``model.init_params(seed)``, as in
    the JAX package. ``attention_impl`` applies to LMs, ``bn_group``
    (cross-replica BN over that process group) to ResNet-50."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"arch family {cfg.family!r} is not ported yet (ROADMAP "
            "queue 1, item 15); the port has the conv and dense families")
    if cfg.family == "conv":
        return ResNet50(cfg, compute_dtype=compute_dtype, seed=seed,
                        device=device, bn_group=bn_group)
    return TransformerLM(cfg, compute_dtype=compute_dtype,
                         attention_impl=attention_impl, device=device)


def init_model_state(model) -> Dict:
    """BN-bearing models carry last-minibatch stats; others empty."""
    if hasattr(model, "init_state"):
        return model.init_state()
    return {}
