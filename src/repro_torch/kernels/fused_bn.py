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
  bn_bwd_dx    dx = A * dy_m - B - x_hat * C, and dres = dy_m, with the
               per-channel A, B, C formed in the same launch from scale,
               rstd, S1, S2, the mean / var cotangents and the count the
               statistics were taken over

Each wrapper has a plain PyTorch version beside it (``_*_plain``) and a
launch count in ``LAUNCHES``. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
It raises on a ``(rows, C)`` view that is not contiguous rather than
copying, so the model keeps its activations NHWC-contiguous.

``_TrainFn`` and ``_ApplyFn`` are the autograd functions of the
train-mode (batch statistics) and given-statistics sites, mirroring
``_train_fn`` and ``_apply_fn`` of the JAX package with the full mean /
var cotangents. With a process group, ``_TrainFn`` is cross-replica BN
(sync-BN): the statistics of the workers' concatenated batches, from the
local moments combined moment-correctly (two all-reduces), and in the
backward the all-reduced sums over the global count (one all-reduce).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels._launch import (F32, I32, I64, P, Library, on_cpu,
                                        ptr, stream)

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CH = 32               # channels per reduction block (csrc kCh)
_TARGET_BLOCKS = 1056  # about one full wave of reduction blocks on 132 SMs
_MIN_CHUNK_ROWS = 64
_MAX_CHUNKS = 65535    # gridDim.y limit
# bn_stats (csrc kStatsThreads, stats_block_units): 256 threads a block.
# Up to 2,048 rows, one chunk: a block per 16-byte channel unit, its 256
# lanes over the rows (at most 8 rows a thread), no merge. Above, up to 8
# units across (32 single channels where C is not a multiple of the
# vector width), a power of two; about two blocks per SM on 132 SMs, at
# least 8 rows per thread, and at most 8 chunks per lane of the block
# that merges them (bn_cast_variants.py picked these on an H100)
_STATS_THREADS, _STATS_UNITS, _STATS_SCALAR_UNITS = 256, 8, 32
_STATS_ONE_CHUNK_ROWS = 2048
_STATS_TARGET_BLOCKS = 264
_STATS_MIN_THREAD_ROWS = 8
_STATS_LANE_CHUNKS = 8
_STATS_COUNTERS: Dict[torch.device, Tensor] = {}


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


def stats_chunks(rows: int, c: int, esize: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of ``bn_stats``, fixed by the shape and
    the element size alone (see the constants above). (``reduction_chunks``
    sizes ``bn_bwd_sums``, whose bits stay as they are.)"""
    if rows <= _STATS_ONE_CHUNK_ROWS:
        return rows, 1
    v = 16 // esize
    units, most = ((c // v, _STATS_UNITS) if c % v == 0
                   else (c, _STATS_SCALAR_UNITS))
    ub = 1 << (min(units, most).bit_length() - 1)
    lanes = _STATS_THREADS // ub
    groups = -(-units // ub)
    chunks = max(1, min(-(-_STATS_TARGET_BLOCKS // groups),
                        rows // (lanes * _STATS_MIN_THREAD_ROWS),
                        lanes * _STATS_LANE_CHUNKS, _MAX_CHUNKS))
    rpc = -(-rows // chunks)
    return rpc, -(-rows // rpc)


def _stats_counter(device: torch.device, c: int) -> Tensor:
    """The zeroed per-column-group counters of ``bn_stats`` on
    ``device``, made once (each launch leaves them zero again); enough
    for ``c`` channels."""
    need = -(-c // _STATS_SCALAR_UNITS)  # the most column groups that merge
    buf = _STATS_COUNTERS.get(device)
    if buf is None or buf.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bn_stats: call it once outside CUDA graph "
                               "capture first (its counters are made then)")
        buf = torch.zeros(max(need, 4096), dtype=torch.int32, device=device)
        _STATS_COUNTERS[device] = buf
    return buf


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

_LIB = Library("fused_bn", {
    "bn_stats": [P, I64, I32, I32, I64, P, P, P, P, P, P],
    "bn_apply": [P, P, P, P, P, I64, I32, I32, I32, P],
    "bn_bwd_sums": [P, P, P, P, P, I64, I32, I32, I32, I64, P, P, P, P, P],
    "bn_bwd_dx": [P, P, P, P, P, P, P, P, P, P, F32, F32, P, P, I64, I32,
                  I32, I32, P],
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
    rpc, chunks = stats_chunks(rows, c, x.element_size())
    scratch = torch.empty((2, chunks, c), dtype=torch.float32,
                          device=x.device)
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _launch("bn_stats", x.data_ptr(), rows, c, _DTYPE_CODE[dtype], rpc,
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            _stats_counter(x.device, c).data_ptr(), mean.data_ptr(),
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


def _bn_bwd_dx_plain(dy, x, y, mu, rstd, scale, s1, s2, dmean, dvar, inv_m,
                     relu, with_dres, count=None):
    # the kernel's per-channel coefficients, each op in its order
    count = float(x.shape[0]) if count is None else float(count)
    a = scale * rstd
    zero = torch.zeros_like(a)
    b = zero if s1 is None else a * s1 * inv_m
    c = zero if s2 is None else a * s2 * inv_m
    if dmean is not None:
        b = b - dmean * inv_m
    if dvar is not None:
        c = c - 2.0 * dvar / (count * rstd)
    dym = _masked_dy(dy, y, relu)
    xhat = (x.float() - mu) * rstd
    dx = (a * dym - b - xhat * c).to(x.dtype)
    return dx, (dym.to(x.dtype) if with_dres else None)


def bn_bwd_dx(dy: Tensor, x: Tensor, y: Tensor, mu: Tensor, rstd: Tensor,
              scale: Tensor, s1: Optional[Tensor], s2: Optional[Tensor],
              dmean: Optional[Tensor], dvar: Optional[Tensor], inv_m: float,
              relu: bool, with_dres: bool = False,
              count: Optional[float] = None
              ) -> Tuple[Tensor, Optional[Tensor]]:
    """dx = A * dy_m - B - x_hat * C in x's dtype, and, with
    ``with_dres``, the residual gradient dres = dy_m in the same dtype.
    A, B and C are formed per channel from the f32 (C,) ``scale``,
    ``rstd``, the sums ``s1`` / ``s2`` of ``bn_bwd_sums`` (both None in
    given-stats mode: B = C = 0) and the mean / var cotangents ``dmean``
    / ``dvar`` (each None for a zero cotangent). ``count`` is the number
    of rows the statistics were taken over (None: these rows; rows x
    workers under cross-replica BN, whose ``s1`` / ``s2`` / cotangents
    are then the all-reduced ones) and ``inv_m`` is 1 / count.
    """
    if (s1 is None) != (s2 is None):
        raise ValueError("bn_bwd_dx takes s1 and s2 both or neither")
    if _on_cpu(dy, x, y, mu, rstd, scale, s1, s2, dmean, dvar):
        return _bn_bwd_dx_plain(dy, x, y, mu, rstd, scale, s1, s2, dmean,
                                dvar, inv_m, relu, with_dres, count)
    rows, c = x.shape
    dtype = _check_rows(c, x, dy, y)
    _check_channel(c, *(v for v in (mu, rstd, scale, s1, s2, dmean, dvar)
                        if v is not None))
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if with_dres else None
    _launch("bn_bwd_dx", dy.data_ptr(), x.data_ptr(),
            ptr(y if relu else None), mu.data_ptr(), rstd.data_ptr(),
            scale.data_ptr(), ptr(s1), ptr(s2), ptr(dmean), ptr(dvar),
            float(inv_m), float(rows if count is None else count),
            dx.data_ptr(), ptr(dres), rows, c,
            _DTYPE_CODE[dtype], int(relu), stream())
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


def _channel(v: Optional[Tensor]) -> Optional[Tensor]:
    """A (C,) cotangent as the kernel takes it: f32 and contiguous (a
    copy only where it is not: a sum's cotangent is an expanded view)."""
    return None if v is None else v.float().contiguous()


def _sync_moments(mean: Tensor, var: Tensor, group) -> Tuple[Tensor,
                                                                Tensor]:
    """The moment-correct combine of the workers' local (mean, var):
    the global mean, then each worker's variance re-centered about it,
    averaged (the JAX package's two pmeans)."""
    n = dist.get_world_size(group)
    mean_g = mean.clone()
    dist.all_reduce(mean_g, group=group)
    mean_g = mean_g / n
    var_g = var + (mean - mean_g).square()
    dist.all_reduce(var_g, group=group)
    return mean_g, var_g / n


class _TrainFn(torch.autograd.Function):
    """Train-mode fused BN: (x, scale, bias[, residual]) -> (y, mean,
    var) from one stats pass and one normalize/epilogue pass; the
    backward is one sums pass and one dx pass, which also folds in the
    per-channel glue. Cotangents are not materialised, so a detached
    mean / var costs nothing (None, a zero cotangent).

    With a process ``group`` (cross-replica BN) the forward combines the
    local moments over the group (two all-reduces), and the backward
    all-reduces S1, S2 and any mean / var cotangents in one collective
    and takes dx over the global count; dscale / dbias stay the local
    S2 / S1, which the data-parallel gradient sync averages like any
    other gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu: bool, eps: float,
                group):
        x2 = rows_view(x)
        mean, var = bn_stats(x2)
        if group is not None:
            mean, var = _sync_moments(mean, var, group)
        rstd = torch.rsqrt(var + eps)
        a = rstd * scale.float()
        off = bias.float() - mean * a
        y = bn_apply(x2, a, off, _residual_rows(x, residual),
                     relu).view(x.shape)
        ctx.save_for_backward(x, y, mean, rstd, scale)
        ctx.set_materialize_grads(False)
        ctx.relu, ctx.has_res = relu, residual is not None
        ctx.group = group
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, y, mean, rstd, scale = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        x2, y2 = rows_view(x), rows_view(y)
        # cotangents arrive in whatever layout the next op produced
        dy2 = rows_view(dy.contiguous())
        s1, s2 = bn_bwd_sums(dy2, x2, y2, mean, rstd, ctx.relu)
        # the stats-output cotangents (None in the train step, where the
        # new BN state is aux) fold into B and C inside the dx launch
        dm, dv = _channel(dmean), _channel(dvar)
        s1g, s2g, count = s1, s2, x2.shape[0]
        if ctx.group is not None:
            # the global sums over the global count: one collective for
            # S1, S2 and whichever cotangents are present
            parts = [s1, s2] + [v for v in (dm, dv) if v is not None]
            both = torch.stack(parts)
            dist.all_reduce(both, group=ctx.group)
            s1g, s2g, rest = both[0], both[1], list(both[2:])
            dm = rest.pop(0) if dm is not None else None
            dv = rest.pop(0) if dv is not None else None
            count *= dist.get_world_size(ctx.group)
        dx2, dr2 = bn_bwd_dx(dy2, x2, y2, mean, rstd, scale.float(), s1g,
                             s2g, dm, dv, 1.0 / count, ctx.relu, ctx.has_res,
                             count=count)
        dres = dr2.view(x.shape) if dr2 is not None else None
        return (dx2.view(x.shape), s2.to(scale.dtype), s1.to(scale.dtype),
                dres, None, None, None)


class _ApplyFn(torch.autograd.Function):
    """Given-statistics fused BN (eval): (x, mean, var, scale, bias[,
    residual]) -> y, differentiable in every input."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, residual, relu: bool,
                eps: float):
        x2 = rows_view(x)
        mean32 = mean.float()
        rstd = torch.rsqrt(var.float() + eps)
        a = rstd * scale.float()
        off = bias.float() - mean32 * a
        y = bn_apply(x2, a, off, _residual_rows(x, residual),
                     relu).view(x.shape)
        ctx.save_for_backward(x, y, mean32, rstd, scale)
        ctx.relu, ctx.has_res = relu, residual is not None
        ctx.stat_dtypes = (mean.dtype, var.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, mean32, rstd, scale = ctx.saved_tensors
        x2, y2 = rows_view(x), rows_view(y)
        dy2 = rows_view(dy.contiguous())
        s1, s2 = bn_bwd_sums(dy2, x2, y2, mean32, rstd, ctx.relu)
        g32 = scale.float()
        dx2, dr2 = bn_bwd_dx(dy2, x2, y2, mean32, rstd, g32, None, None,
                             None, None, 1.0 / x2.shape[0], ctx.relu,
                             ctx.has_res)
        dres = dr2.view(x.shape) if dr2 is not None else None
        a_coef = g32 * rstd
        mean_dtype, var_dtype = ctx.stat_dtypes
        dmean = (-a_coef * s1).to(mean_dtype)
        dvar = (-0.5 * g32 * rstd.square() * s2).to(var_dtype)
        return (dx2.view(x.shape), dmean, dvar, s2.to(scale.dtype),
                s1.to(scale.dtype), dres, None, None)


def fused_bn_train(x: Tensor, scale: Tensor, bias: Tensor, *,
                   residual: Optional[Tensor] = None, relu: bool = False,
                   eps: float = 1e-5, group=None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Train-mode fused BN over the last axis: (y, mean, var). With a
    process ``group``, cross-replica BN over its workers: the statistics
    of their concatenated batches."""
    return _TrainFn.apply(x, scale, bias, residual, bool(relu), float(eps),
                          group)


def fused_bn_apply(x: Tensor, mean: Tensor, var: Tensor, scale: Tensor,
                   bias: Tensor, *, residual: Optional[Tensor] = None,
                   relu: bool = False, eps: float = 1e-5) -> Tensor:
    """Given-statistics fused BN over the last axis (eval)."""
    return _ApplyFn.apply(x, mean, var, scale, bias, residual, bool(relu),
                          float(eps))
