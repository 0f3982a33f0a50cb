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

The kernel's launch plan (``launch_plan``) is decided here: the layout
of a row over the threads, and so the order of its sum, by ``d`` and
the dtype alone (``row_layout``); a persistent grid of as many blocks
as the card holds at once; the evict-first hint where x outgrows L2.

Gradients: when grad is on and x or scale requires it, the call goes
through ``_RMSNormFn``, whose backward recomputes the plain version from
the saved inputs and differentiates it (the Pallas kernel has no VJP;
the JAX model trains through jnp). Otherwise nothing is saved.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels._launch import (F32, I32, I64, P, Library, on_cpu,
                                        plain_grads, stream)

Tensor = torch.Tensor

_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = Library(
    "rmsnorm",
    {"rmsnorm": [P, P, P, I32, I64, I32, F32, I32, I32, I32, I32, I32, I32,
                 I32, P]},
    queries={"rmsnorm_resident": [I32, I32, I32, I32, ctypes.POINTER(I32)]})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset

MAX_WARPS = 8       # warps on a row (csrc/rmsnorm.cu kMaxWarps)
MAX_LOADS = 8       # 16-byte vectors a thread covers, where a d allows it
HELD_LOADS = (5, 6, 7, 8)  # csrc/rmsnorm.cu's rmsnorm_held instances
WARP_ROWS = 4       # rows a block holds when one warp holds a row


class Layout(NamedTuple):
    """How a row lies on the threads: ``warps`` warps share it, each
    thread covers ``loads`` 16-byte vectors; ``held`` is the L of the
    instance that holds the row in registers, 0 for the generic one."""
    held: int
    warps: int
    loads: int
    rows_per_block: int


class Plan(NamedTuple):
    """A ``Layout``, the grid, and ``evict``: x read and y written with
    the evict-first hint (x larger than L2, a held instance)."""
    held: int
    warps: int
    loads: int
    rows_per_block: int
    grid: int
    evict: bool


@functools.lru_cache(maxsize=None)
def row_layout(d: int, dtype: torch.dtype, aligned: bool = True) -> Layout:
    """The layout of a row of ``d`` elements of ``dtype``. ``warps`` and
    ``loads`` (so the row sum's order) depend on ``d`` and ``dtype``
    alone: the fewest warps, up to ``MAX_WARPS``, that split the row's
    warp-wide slices of vectors evenly at most ``MAX_LOADS`` a thread.
    The held instance takes the row where its vectors cover ``d``
    exactly, ``loads`` has an instance and the pointers are 16-byte
    ``aligned``; the generic one (same order) takes the rest."""
    vec = 16 // dtype.itemsize
    n_vec = -(-d // vec)
    slices = -(-n_vec // 32)  # warp-wide slices of 32 vectors
    low = min(MAX_WARPS, -(-slices // MAX_LOADS))
    warps = next((w for w in range(low, MAX_WARPS + 1) if slices % w == 0),
                 low)
    loads = -(-n_vec // (32 * warps))
    exact = 32 * warps * loads * vec == d
    held = loads if aligned and exact and loads in HELD_LOADS else 0
    return Layout(held, warps, loads, WARP_ROWS if warps == 1 else 1)


def evicts(rows: int, d: int, dtype: torch.dtype, l2_bytes: int,
           held: int) -> bool:
    """Whether a held instance streams x and y past L2 (x is larger)."""
    return bool(held) and rows * d * dtype.itemsize > l2_bytes


def launch_plan(rows: int, d: int, dtype: torch.dtype, n_sms: int,
                resident: int, l2_bytes: int, aligned: bool = True) -> Plan:
    """The launch of ``rows`` rows on a card of ``n_sms`` SMs and
    ``l2_bytes`` of L2: ``row_layout``, a persistent grid of min(row
    groups, ``n_sms`` x ``resident`` blocks an SM), and ``evicts``."""
    if rows <= 0 or n_sms <= 0 or resident <= 0:
        raise ValueError(f"rmsnorm plan needs rows, SMs and resident blocks"
                         f" > 0, got {rows}, {n_sms}, {resident}")
    lay = row_layout(d, dtype, aligned)
    groups = -(-rows // lay.rows_per_block)
    return Plan(*lay, min(groups, n_sms * resident),
                evicts(rows, d, dtype, l2_bytes, lay.held))


@functools.lru_cache(maxsize=None)
def _card(device: int):
    """(SMs, L2 bytes) of a device, read once."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.L2_cache_size


@functools.lru_cache(maxsize=None)
def _resident(device: int, code: int, held: int, evict: bool,
              threads: int) -> int:
    """Blocks of an instance resident on one SM (read once a device)."""
    blocks = I32(0)
    with torch.cuda.device(device):
        _LIB.query("rmsnorm_resident", code, held, int(evict), threads,
                   ctypes.byref(blocks))
    return blocks.value


@functools.lru_cache(maxsize=4096)
def _device_plan(device: int, rows: int, d: int, dtype: torch.dtype,
                 aligned: bool) -> Plan:
    lay = row_layout(d, dtype, aligned)
    n_sms, l2_bytes = _card(device)
    resident = _resident(device, _CODE[dtype], lay.held,
                         evicts(rows, d, dtype, l2_bytes, lay.held),
                         32 * lay.warps * lay.rows_per_block)
    return launch_plan(rows, d, dtype, n_sms, resident, l2_bytes, aligned)


def plan_for(x: Tensor, scale: Tensor, out: Tensor) -> Plan:
    """The plan of x ``(..., d)`` on the card, scale and output beside
    (kept per shape: a decode step asks for the same few plans)."""
    d = x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    dev = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    return _device_plan(dev, x.numel() // d, d, x.dtype, aligned)


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
                _CODE[x.dtype], rows, d, float(eps), int(round_inv),
                *plan_for(x, s, out), stream())
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
