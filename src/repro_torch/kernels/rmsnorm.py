"""RMSNorm with f32 statistics and compute-dtype output, ported from the
Pallas kernel of the JAX package (``repro/kernels/rmsnorm.py``
``_kernel``) to ``csrc/rmsnorm.cu`` ``rmsnorm``.

``rmsnorm(x, scale, eps, round_inv)`` normalizes each row of x
``(..., d)`` (float32 or bfloat16) by the root mean square of its f32
values and multiplies by ``scale`` ``(d,)``, in one of two rounding
orders (T = x.dtype):

    inv = 1 / sqrt(mean(f32(x)^2) + eps)
    y   = T(T(f32(x) * inv)    * T(scale))    round_inv=False: the
                                              Pallas kernel's order
    y   = T(T(f32(x) * T(inv)) * T(scale))    round_inv=True: the JAX
                                              model's ``apply_norm``

In float32 the two are the same ops. On CPU tensors it runs the plain
version, these ops in this order; on CUDA tensors it launches the
kernel, which sums the squares in another order and so agrees to the
last bit of ``inv``.

Gradients: when grad is on and x or scale requires it, the call goes
through ``_RMSNormFn``, whose backward recomputes the plain version from
the saved inputs and differentiates it (the Pallas kernel has no VJP;
the JAX model trains through jnp). Otherwise nothing is saved.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._launch import (F32, I32, I64, P, Library, on_cpu,
                                        plain_grads, stream)

Tensor = torch.Tensor

_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = Library("rmsnorm", {"rmsnorm": [P, P, P, I32, I64, I32, F32, I32, P]})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset


def _rmsnorm_plain(x: Tensor, scale: Tensor, eps: float,
                   round_inv: bool = False) -> Tensor:
    x32 = x.float()
    var = x32.square().sum(-1, keepdim=True) / x.shape[-1]
    inv = 1.0 / torch.sqrt(var + eps)
    if round_inv:
        inv = inv.to(x.dtype).float()
    return (x32 * inv).to(x.dtype) * scale.to(x.dtype)


PLAIN = {"rmsnorm": _rmsnorm_plain}


def _rmsnorm_forward(x: Tensor, scale: Tensor, eps: float,
                     round_inv: bool) -> Tensor:
    if on_cpu("rmsnorm", x, scale):
        return _rmsnorm_plain(x, scale, eps, round_inv)
    if not x.is_contiguous():
        raise ValueError("rmsnorm needs a contiguous x")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    # the Pallas wrapper casts the scale to x's dtype; so does this one
    s = scale.to(x.dtype).contiguous()
    _LIB.launch("rmsnorm", x.data_ptr(), s.data_ptr(), out.data_ptr(),
                _CODE[x.dtype], rows, d, float(eps), int(round_inv), stream())
    return out


class _RMSNormFn(torch.autograd.Function):
    """The kernel forward; the plain version's gradient, recomputed."""

    @staticmethod
    def forward(ctx, x, scale, eps: float, round_inv: bool):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.round_inv = eps, round_inv
        return _rmsnorm_forward(x, scale, eps, round_inv)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return plain_grads(
            lambda xs, s: _rmsnorm_plain(xs, s, ctx.eps, ctx.round_inv),
            (x, scale), ctx.needs_input_grad[:2], dy) + (None, None)


def rmsnorm(x: Tensor, scale: Tensor, *, eps: float = 1e-5,
            round_inv: bool = False) -> Tensor:
    """x ``(..., d)`` RMS-normalized over its last dim, times ``scale``
    ``(d,)``; the result has x's shape and dtype. ``round_inv`` picks the
    JAX model's rounding order (see the module docstring)."""
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm takes x (..., d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _CODE:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, float(eps), bool(round_inv))
    return _rmsnorm_forward(x, scale, eps, round_inv)
