"""Initializers, norms and activations shared by the port's models.

Initializers draw from an explicit ``torch.Generator`` on the CPU, so a
seed gives the same weights on every device; the JAX package's
threefry draws cannot be reproduced, so tests carry JAX-initialized
weights across instead (``interop.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def normal_init(gen: torch.Generator, shape: Sequence[int],
                stddev: float = 0.02) -> Tensor:
    return stddev * torch.randn(tuple(shape), generator=gen)


def fan_in_init(gen: torch.Generator, shape: Sequence[int],
                fan_in_dims: Sequence[int] = (-2,)) -> Tensor:
    """A normal draw over the square root of the fan-in, the product of
    ``shape``'s dims at ``fan_in_dims``."""
    fan_in = 1
    for d in fan_in_dims:
        fan_in *= shape[d]
    return torch.randn(tuple(shape), generator=gen) / math.sqrt(
        max(fan_in, 1))


def he_init(gen: torch.Generator, shape: Sequence[int],
            fan_in: int) -> Tensor:
    return torch.randn(tuple(shape), generator=gen) * math.sqrt(2.0 / fan_in)


def dense(gen: torch.Generator, d_in: int, d_out: int,
          stacked: int = 0) -> Tensor:
    """A ``(stacked?, d_in, d_out)`` weight, fan-in initialized."""
    shape = (d_in, d_out) if not stacked else (stacked, d_in, d_out)
    return fan_in_init(gen, shape, (-2,))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, stacked: int = 0) -> Dict[str, Tensor]:
    shape = (d,) if not stacked else (stacked, d)
    return {"scale": torch.ones(shape)}


def layernorm_init(d: int, stacked: int = 0) -> Dict[str, Tensor]:
    shape = (d,) if not stacked else (stacked, d)
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def norm_init(kind: str, d: int, stacked: int = 0) -> Dict[str, Tensor]:
    return (rmsnorm_init(d, stacked) if kind == "rmsnorm"
            else layernorm_init(d, stacked))


def apply_norm(p: Dict[str, Tensor], x: Tensor, kind: str,
               eps: float = 1e-5) -> Tensor:
    """Normalize over the last dim with f32 statistics; the result is in
    x's dtype. ``rmsnorm`` is the kernel (``kernels.ops.rmsnorm``, its
    plain version on the CPU) in the JAX package's ``apply_norm``
    rounding order: ``inv`` is rounded to x's dtype before ``x * inv``
    (``round_inv=True``; the Pallas kernel's order rounds ``x * inv``
    instead). ``layernorm`` stays plain PyTorch, in the JAX package's op
    order."""
    dtype = x.dtype
    if kind == "rmsnorm":
        from repro_torch.kernels.ops import rmsnorm
        return rmsnorm(x, p["scale"], eps=eps, round_inv=True)
    if kind == "layernorm":
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        mean_sq = x32.square().mean(-1, keepdim=True)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        inv = torch.rsqrt(var + eps).to(dtype)
        y = (x - mean.to(dtype)) * inv
        y = y * p["scale"].to(dtype) + p["bias"].to(dtype)
        return y.to(dtype)
    raise ValueError(kind)


def gelu(x: Tensor) -> Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
