"""Initializers, norms and activations shared by the port's models, and
the staged loss of the overlapped data-parallel step.

Initializers draw from an explicit ``torch.Generator`` on the CPU, so a
seed gives the same weights on every device; the JAX package's
threefry draws cannot be reproduced, so tests carry JAX-initialized
weights across instead (``interop.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# staged loss (the backward-overlapped gradient sync)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StagedLoss:
    """A model's loss as K chained segments, for the overlapped DP step
    (``training/step.py:make_dp_overlap_train_step``): each segment's
    backward runs on its own, so the gradients come out segment by
    segment, last segment first, and a bucket's all-reduce can start as
    soon as its last gradient exists.

    ``seg_fns[i](seg_params[i], carry) -> (carry', aux)``; the carry is
    the activation handed from one segment to the next, and the last
    segment's carry' is the scalar loss. Every parameter lives in
    exactly one segment (the model's ``segment_trees`` cuts a
    parameter-shaped dict the same way), so the union of the segments'
    gradient dicts is the whole gradient.
    ``finalize_aux(auxes) -> (new_model_state, metrics)``."""

    names: Tuple[str, ...]
    seg_params: Tuple[Dict[str, Tensor], ...]
    seg_fns: Tuple[Callable, ...]
    x0: Any
    finalize_aux: Callable

    def __len__(self) -> int:
        return len(self.seg_fns)


def staged_forward(staged: StagedLoss):
    """The forward as a chain of segments, each on a detached copy of
    the incoming carry. Returns ``(loss, vjp_fns, auxes)``;
    ``vjp_fns[i](ct)`` is ``(segment parameter gradients, carry
    cotangent)``, the cotangent None for the first segment. The
    parameters must be leaves that require grad. Chained from the last
    segment back, they run the ops of the monolithic backward, segment
    by segment, so the gradients are bitwise those of
    ``torch.autograd.grad`` of the whole loss."""
    carry = staged.x0
    vjps: List[Callable] = []
    auxes = []
    for i, (sp, fn) in enumerate(zip(staged.seg_params, staged.seg_fns)):
        carry_in = carry if i == 0 else carry.detach().requires_grad_(True)
        carry, aux = fn(sp, carry_in)
        vjps.append(_segment_vjp(carry, list(sp), list(sp.values()),
                                 None if i == 0 else carry_in))
        auxes.append(aux)
    return carry, vjps, auxes


def _segment_vjp(out: Tensor, names: List[str], leaves: List[Tensor],
                 carry_in):
    def vjp(ct: Tensor):
        inputs = leaves + ([] if carry_in is None else [carry_in])
        gs = torch.autograd.grad(out, inputs, grad_outputs=ct)
        return dict(zip(names, gs)), (None if carry_in is None
                                      else gs[-1])
    return vjp


def staged_value_and_grad(staged: StagedLoss):
    """The chained backward without overlap: ``(loss, (new_state,
    metrics), grads)``, the gradients in the parameters' own dtype and
    by their names."""
    loss, vjps, auxes = staged_forward(staged)
    ct: Any = torch.ones_like(loss)
    grads: Dict[str, Tensor] = {}
    for i in reversed(range(len(vjps))):
        g_seg, ct = vjps[i](ct)
        grads.update(g_seg)
    new_state, metrics = staged.finalize_aux(auxes)
    return loss, (new_state, metrics), grads
