"""Batch normalization *without moving averages* (paper §2), unfused.

The model keeps only the last minibatch's statistics as state. This is
the plain path of every BN site; ``kernels/fused_bn.py`` fuses the same
math into the CUDA kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def bn_batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and **centered** variance E[(x - mu)^2] over all but the
    channel (last) axis, fp32 accumulation: the uncentered
    E[x^2] - mu^2 cancels almost every bit for a large-mean activation."""
    dims = tuple(range(x.dim() - 1))
    x32 = x.to(F32)
    mean = x32.mean(dim=dims)
    var = (x32 - mean).square().mean(dim=dims)
    return mean, var


def bn_apply_stats(x: torch.Tensor, mean, var, scale, bias,
                   eps: float = 1e-5) -> torch.Tensor:
    """Normalize in the compute dtype; only the per-channel scale and
    offset are folded in fp32."""
    inv = torch.rsqrt(var + eps) * scale.to(F32)
    off = bias.to(F32) - mean * inv
    return (x * inv.to(x.dtype) + off.to(x.dtype)).to(x.dtype)
