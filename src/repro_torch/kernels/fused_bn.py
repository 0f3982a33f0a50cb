"""Fused batch norm for the paper's BN variant (no moving averages): the
ResNet-50 per-step hot path, ported from the Pallas family in the JAX
package (``repro/kernels/fused_bn.py``) to the CUDA kernels in
``csrc/fused_bn.cu``.

Four kernels work on the ``(rows, C)`` view of an NHWC activation (C
fastest), in f32 or bf16 with f32 math:

  bn_stats     per-channel mean and centered variance (M2 / rows)
  bn_apply     y = relu?(x * a + o [+ r]) in x's dtype
  bn_bwd_sums  S1 = sum(dy_m), S2 = sum(dy_m * x_hat); dy_m is dy masked
               by the saved output (y > 0) when the site has a ReLU
  bn_bwd_dx    dx = A * dy_m - B - x_hat * C, and dres = dy_m

Each wrapper has a plain PyTorch version beside it (``_*_plain``) and a
launch count in ``LAUNCHES``. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
It raises on a ``(rows, C)`` view that is not contiguous rather than
copying, so the model keeps its activations NHWC-contiguous.

``_TrainFn`` and ``_ApplyFn`` are the autograd functions of the
train-mode (batch statistics) and given-statistics sites, mirroring
``_train_fn`` and ``_apply_fn`` of the JAX package with the full mean /
var cotangents.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._launch import (I32, I64, P, Library, on_cpu, ptr,
                                        stream)

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CH = 32               # channels per reduction block (csrc kCh)
_TARGET_BLOCKS = 1056  # about one full wave of reduction blocks on 132 SMs
_MIN_CHUNK_ROWS = 64
_MAX_CHUNKS = 65535    # gridDim.y limit


def rows_view(x: Tensor) -> Tensor:
    """The ``(rows, C)`` view of a ``(..., C)`` tensor; raises if it is
    not contiguous (the kernels index it densely)."""
    x2 = x.view(-1, x.shape[-1])
    if not x2.is_contiguous():
        raise ValueError(
            f"fused BN needs a contiguous (rows, C) view; got shape "
            f"{tuple(x.shape)} with strides {x.stride()}")
    return x2


def reduction_chunks(rows: int, c: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of the two-launch reductions: enough
    chunks to fill the card once, fixed by the shape alone so results do
    not depend on anything else."""
    col_blocks = -(-c // _CH)
    chunks = max(1, min(-(-_TARGET_BLOCKS // col_blocks),
                        -(-rows // _MIN_CHUNK_ROWS), _MAX_CHUNKS))
    rpc = -(-rows // chunks)
    return rpc, -(-rows // rpc)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

_LIB = Library("fused_bn", {
    "bn_stats": [P, I64, I32, I32, I64, P, P, P, P, P],
    "bn_apply": [P, P, P, P, P, I64, I32, I32, I32, P],
    "bn_bwd_sums": [P, P, P, P, P, I64, I32, I32, I32, I64, P, P, P, P, P],
    "bn_bwd_dx": [P, P, P, P, P, P, P, P, P, P, I64, I32, I32, I32, P],
})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset
_launch = _LIB.launch


def _on_cpu(*ts: Optional[Tensor]) -> bool:
    return on_cpu("fused BN", *ts)


def _check_rows(c: int, *ts: Optional[Tensor]) -> torch.dtype:
    """Every (rows, C) stream shares the first one's shape and dtype,
    which must be f32 or bf16; returns it."""
    first = ts[0]
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused BN takes float32 or bfloat16, got "
                        f"{first.dtype}")
    for t in ts:
        if t is None:
            continue
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError("fused BN (rows, C) streams must share shape "
                             f"and dtype: {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(first.shape)} {first.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused BN (rows, C) streams must be "
                             "contiguous")
    if first.dim() != 2 or first.shape[1] != c or first.shape[0] == 0:
        raise ValueError(f"expected a non-empty (rows, {c}) tensor, got "
                         f"{tuple(first.shape)}")
    return first.dtype


def _check_channel(c: int, *vs: Tensor) -> None:
    for v in vs:
        if v.dtype != torch.float32 or v.shape != (c,) \
                or not v.is_contiguous():
            raise ValueError(f"per-channel vectors must be contiguous "
                             f"float32 ({c},), got {v.dtype} "
                             f"{tuple(v.shape)}")


# ---------------------------------------------------------------------------
# bn_stats
# ---------------------------------------------------------------------------


def _bn_stats_plain(x: Tensor) -> Tuple[Tensor, Tensor]:
    x32 = x.float()
    mean = x32.sum(0) / x.shape[0]
    var = (x32 - mean).square().sum(0) / x.shape[0]
    return mean, var


def bn_stats(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-channel (mean, centered var) of a (rows, C) tensor, f32."""
    if _on_cpu(x):
        return _bn_stats_plain(x)
    rows, c = x.shape
    dtype = _check_rows(c, x)
    rpc, chunks = reduction_chunks(rows, c)
    scratch = torch.empty((2, chunks, c), dtype=torch.float32,
                          device=x.device)
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _launch("bn_stats", x.data_ptr(), rows, c, _DTYPE_CODE[dtype], rpc,
            scratch[0].data_ptr(), scratch[1].data_ptr(), mean.data_ptr(),
            var.data_ptr(), stream())
    return mean, var


# ---------------------------------------------------------------------------
# bn_apply
# ---------------------------------------------------------------------------


def _bn_apply_plain(x, a, o, residual, relu):
    y = x.float() * a + o
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype)


def bn_apply(x: Tensor, a: Tensor, o: Tensor,
             residual: Optional[Tensor] = None,
             relu: bool = False) -> Tensor:
    """y = relu?(x * a + o [+ residual]) on (rows, C), stored in x's
    dtype; a and o are f32 (C,)."""
    if _on_cpu(x, a, o, residual):
        return _bn_apply_plain(x, a, o, residual, relu)
    rows, c = x.shape
    dtype = _check_rows(c, x, residual)
    _check_channel(c, a, o)
    y = torch.empty_like(x)
    _launch("bn_apply", x.data_ptr(), ptr(residual), a.data_ptr(),
            o.data_ptr(), y.data_ptr(), rows, c, _DTYPE_CODE[dtype],
            int(relu), stream())
    return y


# ---------------------------------------------------------------------------
# bn_bwd_sums
# ---------------------------------------------------------------------------


def _masked_dy(dy, y, relu):
    dy = dy.float()
    if relu:
        dy = torch.where(y > 0, dy, torch.zeros_like(dy))
    return dy


def _bn_bwd_sums_plain(dy, x, y, mu, rstd, relu):
    dym = _masked_dy(dy, y, relu)
    xhat = (x.float() - mu) * rstd
    return dym.sum(0), (dym * xhat).sum(0)


def bn_bwd_sums(dy: Tensor, x: Tensor, y: Tensor, mu: Tensor,
                rstd: Tensor, relu: bool) -> Tuple[Tensor, Tensor]:
    """(S1, S2) = (sum(dy_m), sum(dy_m * x_hat)) per channel, f32; the
    ReLU mask comes from the saved output y."""
    if _on_cpu(dy, x, y, mu, rstd):
        return _bn_bwd_sums_plain(dy, x, y, mu, rstd, relu)
    rows, c = x.shape
    dtype = _check_rows(c, x, dy, y)
    _check_channel(c, mu, rstd)
    rpc, chunks = reduction_chunks(rows, c)
    scratch = torch.empty((2, chunks, c), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _launch("bn_bwd_sums", dy.data_ptr(), x.data_ptr(),
            ptr(y if relu else None), mu.data_ptr(), rstd.data_ptr(), rows,
            c, _DTYPE_CODE[dtype], int(relu), rpc, scratch[0].data_ptr(),
            scratch[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream())
    return out[0], out[1]


# ---------------------------------------------------------------------------
# bn_bwd_dx
# ---------------------------------------------------------------------------


def _bn_bwd_dx_plain(dy, x, y, mu, rstd, ca, cb, cc, relu, with_dres):
    dym = _masked_dy(dy, y, relu)
    xhat = (x.float() - mu) * rstd
    dx = (ca * dym - cb - xhat * cc).to(x.dtype)
    return dx, (dym.to(x.dtype) if with_dres else None)


def bn_bwd_dx(dy: Tensor, x: Tensor, y: Tensor, mu: Tensor, rstd: Tensor,
              ca: Tensor, cb: Tensor, cc: Tensor, relu: bool,
              with_dres: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """dx = ca * dy_m - cb - x_hat * cc in x's dtype, and, with
    ``with_dres``, the residual gradient dres = dy_m in the same dtype."""
    if _on_cpu(dy, x, y, mu, rstd, ca, cb, cc):
        return _bn_bwd_dx_plain(dy, x, y, mu, rstd, ca, cb, cc, relu,
                                with_dres)
    rows, c = x.shape
    dtype = _check_rows(c, x, dy, y)
    _check_channel(c, mu, rstd, ca, cb, cc)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if with_dres else None
    _launch("bn_bwd_dx", dy.data_ptr(), x.data_ptr(),
            ptr(y if relu else None), mu.data_ptr(), rstd.data_ptr(),
            ca.data_ptr(), cb.data_ptr(), cc.data_ptr(), dx.data_ptr(),
            ptr(dres), rows, c, _DTYPE_CODE[dtype], int(relu), stream())
    return dx, dres


# each kernel's plain PyTorch version, by kernel name (the CPU path, and
# what chip_smoke.py holds the kernels against on the card)
PLAIN = {"bn_stats": _bn_stats_plain, "bn_apply": _bn_apply_plain,
         "bn_bwd_sums": _bn_bwd_sums_plain, "bn_bwd_dx": _bn_bwd_dx_plain}


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------


def _residual_rows(x: Tensor, residual: Optional[Tensor]):
    if residual is None:
        return None
    if residual.dtype != x.dtype:
        raise TypeError(f"residual dtype {residual.dtype} must match the "
                        f"activation's {x.dtype}")
    return rows_view(residual)


class _TrainFn(torch.autograd.Function):
    """Train-mode fused BN: (x, scale, bias[, residual]) -> (y, mean,
    var) from one stats pass and one normalize/epilogue pass; the
    backward is one sums pass and one dx pass."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu: bool, eps: float):
        x2 = rows_view(x)
        mean, var = bn_stats(x2)
        rstd = torch.rsqrt(var + eps)
        a = rstd * scale.float()
        off = bias.float() - mean * a
        y = bn_apply(x2, a, off, _residual_rows(x, residual),
                     relu).view(x.shape)
        ctx.save_for_backward(x, y, mean, var, scale)
        ctx.relu, ctx.eps, ctx.has_res = relu, eps, residual is not None
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, y, mean, var, scale = ctx.saved_tensors
        x2, y2 = rows_view(x), rows_view(y)
        # cotangents arrive in whatever layout the next op produced
        dy2 = rows_view(dy.contiguous())
        rstd = torch.rsqrt(var + ctx.eps)
        s1, s2 = bn_bwd_sums(dy2, x2, y2, mean, rstd, ctx.relu)
        m = float(x2.shape[0])
        a_coef = scale.float() * rstd
        # the stats-output cotangents (zero in the train step, where the
        # new BN state is aux) fold into the two per-channel offsets:
        # dmean adds dmean/M, dvar adds 2*dvar*(x-mu)/M
        b_coef = a_coef * s1 / m - dmean / m
        c_coef = a_coef * s2 / m - 2.0 * dvar / (m * rstd)
        dx2, dr2 = bn_bwd_dx(dy2, x2, y2, mean, rstd, a_coef, b_coef,
                             c_coef, ctx.relu, ctx.has_res)
        dres = dr2.view(x.shape) if dr2 is not None else None
        return (dx2.view(x.shape), s2.to(scale.dtype), s1.to(scale.dtype),
                dres, None, None)


class _ApplyFn(torch.autograd.Function):
    """Given-statistics fused BN (eval): (x, mean, var, scale, bias[,
    residual]) -> y, differentiable in every input."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, residual, relu: bool,
                eps: float):
        x2 = rows_view(x)
        rstd = torch.rsqrt(var.float() + eps)
        a = rstd * scale.float()
        off = bias.float() - mean.float() * a
        y = bn_apply(x2, a, off, _residual_rows(x, residual),
                     relu).view(x.shape)
        ctx.save_for_backward(x, y, mean, var, scale)
        ctx.relu, ctx.eps, ctx.has_res = relu, eps, residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, mean, var, scale = ctx.saved_tensors
        x2, y2 = rows_view(x), rows_view(y)
        dy2 = rows_view(dy.contiguous())
        mean32 = mean.float()
        rstd = torch.rsqrt(var.float() + ctx.eps)
        s1, s2 = bn_bwd_sums(dy2, x2, y2, mean32, rstd, ctx.relu)
        g32 = scale.float()
        a_coef = g32 * rstd
        zero = torch.zeros_like(a_coef)
        dx2, dr2 = bn_bwd_dx(dy2, x2, y2, mean32, rstd, a_coef, zero, zero,
                             ctx.relu, ctx.has_res)
        dres = dr2.view(x.shape) if dr2 is not None else None
        dmean = (-a_coef * s1).to(mean.dtype)
        dvar = (-0.5 * g32 * rstd.square() * s2).to(var.dtype)
        return (dx2.view(x.shape), dmean, dvar, s2.to(scale.dtype),
                s1.to(scale.dtype), dres, None, None)


def fused_bn_train(x: Tensor, scale: Tensor, bias: Tensor, *,
                   residual: Optional[Tensor] = None, relu: bool = False,
                   eps: float = 1e-5) -> Tuple[Tensor, Tensor, Tensor]:
    """Train-mode fused BN over the last axis: (y, mean, var)."""
    return _TrainFn.apply(x, scale, bias, residual, bool(relu), float(eps))


def fused_bn_apply(x: Tensor, mean: Tensor, var: Tensor, scale: Tensor,
                   bias: Tensor, *, residual: Optional[Tensor] = None,
                   relu: bool = False, eps: float = 1e-5) -> Tensor:
    """Given-statistics fused BN over the last axis (eval)."""
    return _ApplyFn.apply(x, mean, var, scale, bias, residual, bool(relu),
                          float(eps))
