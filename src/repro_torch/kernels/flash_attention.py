"""Tiled online-softmax (flash) attention with GQA and causal /
sliding-window masks, ported from the Pallas kernel of the
JAX package (``repro/kernels/flash_attention.py`` ``_kernel``) to
``csrc/flash_attention.cu`` ``flash_attention``.

``flash_attention(q, k, v, causal=True, window=None)`` takes q
``(B, Sq, Hq, Dh)`` and k, v ``(B, Sk, Hkv, Dh)`` in float32 or
bfloat16, with ``Hq`` a multiple of ``Hkv``, and returns ``(B, Sq, Hq,
Dh)`` in q's dtype. Scores are the f32 dot of the inputs times
``1/sqrt(Dh)``; masked scores are ``-1e30``; positions count from 0 for
q and k alike; query head h reads kv head ``h // (Hq // Hkv)``. Any
``Sq`` and ``Sk`` work (the Pallas wrapper asserts whole 128-row
blocks). On CPU tensors it runs the plain version, a straightforward f32
attention with the same masks and output cast, at any ``Dh``; on CUDA
tensors it launches the kernel, which has instances for the head dims
in ``HEAD_DIMS`` (every attention config of the registry) and raises for
any other. Its sums run in another order, so the two agree to f32
rounding (and to one ulp of bf16 in bf16). bf16 inputs go to the
tensor-core kernel, which reads rows with 16-byte copies: a tensor whose
rows do not all start 16-byte aligned (an offset view) is first copied
into a fresh contiguous one; f32 inputs go to the CUDA-core kernel.

Gradients: when grad is on and q, k or v requires it, the call goes
through ``_FlashFn``, whose backward recomputes the plain version from
the saved inputs and differentiates it (the Pallas kernel has no VJP;
the JAX model trains through its jnp ``chunked_attention``). Otherwise
nothing is saved.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels._launch import (F32, I32, I64, P, Library, on_cpu,
                                        plain_grads, stream)

Tensor = torch.Tensor

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 112, 128)  # the kernel's instances
_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = Library("flash_attention", {
    "flash_attention": [P, P, P, P, I32, I32, I32, I32, I32, I32, I32]
    + [I64] * 12 + [F32, I32, I32, P],
})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset


def _flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                           window: Optional[int]) -> Tensor:
    """Full-materialization f32 attention: f32 scores, f32 probabilities
    into the P.V product (unlike ``ref.attention``, which rounds p to
    q's dtype), output cast to q's dtype."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (
        1.0 / math.sqrt(dh))
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= qi - kj < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


PLAIN = {"flash_attention": _flash_attention_plain}


def _rows_aligned(t: Tensor) -> bool:
    """Every (b, s, h) row of ``t`` starts on a 16-byte boundary."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * es) % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
        if n > 1)


def _flash_forward(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                   window: Optional[int]) -> Tensor:
    if on_cpu("flash_attention", q, k, v):
        return _flash_attention_plain(q, k, v, causal, window)
    dh = q.shape[3]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention on the card takes head dims "
                         f"{HEAD_DIMS}, got {dh}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies rows 16 bytes at a time; a fresh
        # tensor from the caching allocator starts aligned, and Dh * 2
        # bytes is a multiple of 16 at every instance
        q, k, v = (t if _rows_aligned(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    b, sq, hq, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _LIB.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), _CODE[q.dtype], b, sq, sk, hq, hkv, dh,
                *strides, float(1.0 / math.sqrt(dh)), int(causal),
                0 if window is None else int(window), stream())
    return out


class _FlashFn(torch.autograd.Function):
    """The kernel forward; the plain version's gradient, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        return plain_grads(
            lambda q, k, v: _flash_attention_plain(q, k, v, ctx.causal,
                                                   ctx.window),
            ctx.saved_tensors, ctx.needs_input_grad[:3], dout) + (None, None)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> Tensor:
    """Attention of q ``(B, Sq, Hq, Dh)`` over k, v ``(B, Sk, Hkv, Dh)``;
    returns ``(B, Sq, Hq, Dh)`` in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, Hq, Dh) and k, v "
                         f"(B, Sk, Hkv, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or (hkv and hq % hkv):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch, head dim, Hq a "
                         f"multiple of Hkv)")
    if q.dtype not in _CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if min(b, sq, sk, hkv) == 0:
        raise ValueError(f"flash_attention needs B, Sq, Sk and Hkv > 0, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFn.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window)
