"""Model registry: arch family -> model class, for every family of the
JAX package (the conv family, ResNet-50; the dense, MoE and VLM
``TransformerLM``; the hybrid ``Zamba2Model``; the SSM ``XLSTMModel``;
the audio ``WhisperModel``).

Model protocol (duck-typed, as in the JAX package):
  init_params(seed, draw_device=, dtype=) -> (params, logical axes)
      [ResNet-50: init_params() of the weights drawn when it was built]
  loss_fn(params, model_state, batch, label_smoothing)
      -> (loss, (state', metrics))
  cache_shape(batch, max_seq, dtype) -> (cache_zeros, cache_axes)   [LMs]
  prefill(params, tokens, cache, **frontend) -> (last_logits, cache)
  decode_step(params, cache, tokens, cache_index) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.mamba import Zamba2Model
from repro_torch.models.resnet import ResNet50
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.xlstm import XLSTMModel

_FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
    "hybrid": Zamba2Model,
    "ssm": XLSTMModel,
    "audio": WhisperModel,
    "conv": ResNet50,
}


def build_model(cfg: ModelConfig, compute_dtype=torch.bfloat16, *,
                attention_impl: str = "chunked", remat: bool = False,
                seed: int = 0, device: DeviceLike = "cuda",
                bn_group=None) -> Any:
    """The model of ``cfg``'s family. ResNet-50 draws its parameters from
    ``seed`` here; an LM's come from ``model.init_params(seed)``, as in
    the JAX package. ``attention_impl`` and ``remat`` (checkpoint each
    layer in training; the JAX launcher passes ``n_layers > 8``) apply
    to LMs, ``bn_group`` (cross-replica BN over that process group) to
    ResNet-50."""
    cls = _FAMILIES[cfg.family]
    if cfg.family == "conv":
        return cls(cfg, compute_dtype=compute_dtype, seed=seed,
                   device=device, bn_group=bn_group)
    return cls(cfg, compute_dtype=compute_dtype,
               attention_impl=attention_impl, remat=remat, device=device)


def init_model_state(model) -> Dict:
    """BN-bearing models carry last-minibatch stats; others empty."""
    if hasattr(model, "init_state"):
        return model.init_state()
    return {}
