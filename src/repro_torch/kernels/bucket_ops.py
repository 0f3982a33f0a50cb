"""The wire casts of the bucketed all-reduce, ported from the Pallas
kernel of the JAX package (``repro/kernels/bucket_ops.py``
``_cast_kernel``) to ``csrc/bucket_ops.cu``'s ``cast_kernel``, with
three entry points, all counted as ``cast_copy``:

- ``pack_cast`` (float32 -> bfloat16 / float16) and ``unpack_cast``
  (back to float32), ``cast_copy``: one 1-D contiguous stream of any
  length; the kernel masks the tail, so nothing is padded;
- ``pack_leaves``: the pack of the bucketed sync in one pass, every
  float32 leaf cast into its place in a new wire stream and the zero
  tail written, with no concatenation of the leaves first;
- ``unpack_buckets``: the unpack in one pass, the synced buckets cast
  back into one float32 stream, divided by the worker count, and with
  ``with_sq_norm`` the squared L2 norm of that stream.

On CPU (and ``meta``) tensors each runs its plain version, the PyTorch
sequence the sync ran before the kernels (``torch.cat``, ``Tensor.to``,
``/ denom``, ``.square().sum()``); on CUDA tensors the kernel, which
rounds to nearest even as ``Tensor.to`` does and divides as ATen's CUDA
``t / n`` does (a multiplication by the f32 reciprocal), so its values
are bitwise the plain version's on the card. The norm sums in another
order (float64, a fixed tree): it agrees to rounding, and gives the
same bits on every run.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._launch import (F32, I32, I64, P, Library, on_cpu,
                                         stream)

Tensor = torch.Tensor

_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WIRE = (torch.bfloat16, torch.float16)
_LIB = Library("bucket_ops", {
    "cast_copy": [P, I32, P, I32, I64, P],
    "pack_leaves": [P, P, P, I32, P, I32, P],
    "unpack_buckets": [P, P, P, I32, I32, P, I32, F32, P, I32, P, P],
}, counts_as={"pack_leaves": "cast_copy", "unpack_buckets": "cast_copy"})
LAUNCHES: Dict[str, int] = _LIB.launches
# per C entry: how often the one-pass pack and unpack ran, apart from the
# plain stream casts
ENTRY_LAUNCHES: Dict[str, int] = _LIB.entry_launches
reset_launch_counts = _LIB.reset
# the segments one launch takes (kMaxSegments): more take further
# launches of the same call
MAX_SEGMENTS = 256
# float64 partials of the norm: one per block of the kernel's grid, which
# is at most this many blocks when the norm is asked for
SQ_PARTIALS = 4096


def _cast_copy_plain(flat: Tensor, dtype: torch.dtype) -> Tensor:
    return flat.to(dtype)


def _pack_leaves_plain(leaves: Sequence[Tensor], wire_dtype: torch.dtype,
                       pad: int = 0) -> Tensor:
    flat = torch.cat([t.reshape(-1) for t in leaves]).to(wire_dtype)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def _unpack_buckets_plain(buckets: Sequence[Tensor], n: int,
                          denom: Optional[int] = None,
                          with_sq_norm: bool = False
                          ) -> Tuple[Tensor, Optional[Tensor]]:
    flat = buckets[0] if len(buckets) == 1 else torch.cat(list(buckets))
    flat = flat[:n].contiguous().to(torch.float32)
    if denom is not None:
        flat = flat / denom
    return flat, (flat.square().sum() if with_sq_norm else None)


PLAIN = {"cast_copy": _cast_copy_plain, "pack_leaves": _pack_leaves_plain,
         "unpack_buckets": _unpack_buckets_plain}


def cast_copy(flat: Tensor, dtype: torch.dtype) -> Tensor:
    """A new 1-D tensor holding ``flat`` cast to ``dtype``: float32 to a
    half-precision wire dtype, or back."""
    if flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError(f"cast_copy takes a contiguous 1-D stream, got "
                         f"shape {tuple(flat.shape)}")
    pair = (flat.dtype, dtype)
    if torch.float32 not in pair or pair[0] == pair[1] \
            or not set(pair) <= set(_CODE):
        raise TypeError(f"cast_copy casts float32 to bfloat16/float16 "
                        f"and back, not {flat.dtype} -> {dtype}")
    if on_cpu("cast_copy", flat):
        return _cast_copy_plain(flat, dtype)
    out = torch.empty(flat.shape, dtype=dtype, device=flat.device)
    if flat.numel():
        _LIB.launch("cast_copy", flat.data_ptr(), _CODE[flat.dtype],
                    out.data_ptr(), _CODE[dtype], flat.numel(), stream())
    return out


def pack_cast(flat: Tensor, wire_dtype: torch.dtype) -> Tensor:
    """The float32 gradient stream cast to the wire dtype."""
    if flat.dtype != torch.float32:
        raise TypeError(f"pack_cast takes a float32 stream, got "
                        f"{flat.dtype}")
    return cast_copy(flat, wire_dtype)


def unpack_cast(flat: Tensor, acc_dtype: torch.dtype = torch.float32
                ) -> Tensor:
    """The inverse of ``pack_cast``: the wire stream back to float32."""
    if acc_dtype != torch.float32:
        raise TypeError(f"unpack_cast returns float32, not {acc_dtype}")
    return cast_copy(flat, acc_dtype)


def _table(ts: Sequence[Tensor], sizes: Sequence[int]):
    """The host arrays of a segment table: pointers, output offsets and
    lengths of the non-empty ``ts`` (their first ``sizes`` elements)."""
    keep = [(t, k) for t, k in zip(ts, sizes) if k]
    ptr = np.fromiter((t.data_ptr() for t, _ in keep), np.uint64, len(keep))
    n = np.fromiter((k for _, k in keep), np.int64, len(keep))
    off = np.cumsum(n) - n
    return ptr, off, n


def pack_leaves(leaves: Sequence[Tensor], wire_dtype: torch.dtype,
                pad: int = 0) -> Tensor:
    """A new 1-D ``wire_dtype`` stream: the float32 ``leaves``, each
    flattened, one after the other, cast to bfloat16 or float16, then
    ``pad`` zeros. One launch on the card for any number of leaves (a
    non-contiguous leaf, e.g. a channels-last conv gradient, is made
    contiguous first)."""
    if wire_dtype not in _WIRE:
        raise TypeError(f"pack_leaves casts to bfloat16/float16, not "
                        f"{wire_dtype}")
    if not leaves:
        raise ValueError("pack_leaves needs at least one leaf")
    bad = [t.dtype for t in leaves if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"pack_leaves takes float32 leaves, got {bad[0]}")
    if on_cpu("pack_leaves", *leaves):
        return _pack_leaves_plain(leaves, wire_dtype, pad)
    leaves = [t if t.is_contiguous() else t.contiguous() for t in leaves]
    ptr, off, n = _table(leaves, [t.numel() for t in leaves])
    total = int(n.sum())
    out = torch.empty(total + pad, dtype=wire_dtype, device=leaves[0].device)
    if pad:  # the zero tail: a segment with no source
        ptr = np.append(ptr, np.uint64(0))
        off = np.append(off, total)
        n = np.append(n, pad)
    if n.size:
        _LIB.launch("pack_leaves", ptr.ctypes.data, off.ctypes.data,
                    n.ctypes.data, n.size, out.data_ptr(), _CODE[wire_dtype],
                    stream())
    return out


def unpack_buckets(buckets: Sequence[Tensor], n: int,
                   denom: Optional[int] = None, with_sq_norm: bool = False
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    """``(stream, sq_norm)``: the first ``n`` elements of the buckets
    (1-D, contiguous, one wire dtype, in stream order, anywhere in
    memory) cast back to a new float32 stream, divided by ``denom``
    (None: not divided), and with ``with_sq_norm`` the 0-d float32
    squared L2 norm of that stream (else None). One launch on the card
    for any number of buckets."""
    if not buckets:
        raise ValueError("unpack_buckets needs at least one bucket")
    dtype = buckets[0].dtype
    for b in buckets:
        if b.dtype != dtype or dtype not in _WIRE:
            raise TypeError(f"unpack_buckets casts bfloat16/float16 "
                            f"buckets of one dtype back, got {b.dtype}")
        if b.dim() != 1 or not b.is_contiguous():
            raise ValueError(f"unpack_buckets takes contiguous 1-D "
                             f"buckets, got shape {tuple(b.shape)}")
    held = sum(b.numel() for b in buckets)
    if not 0 <= n <= held:
        raise ValueError(f"{n} elements asked of buckets of {held}")
    if on_cpu("unpack_buckets", *buckets):
        return _unpack_buckets_plain(buckets, n, denom, with_sq_norm)
    dev = buckets[0].device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out, (out.new_zeros(()) if with_sq_norm else None)
    sq = out.new_empty(()) if with_sq_norm else None
    sizes, left = [], n
    for b in buckets:
        sizes.append(min(b.numel(), left))
        left -= sizes[-1]
    ptr, off, lens = _table(buckets, sizes)
    # ATen's CUDA ``t / denom``: t times the f32 reciprocal of f32(denom)
    scale = 1.0 if denom is None else float(np.float32(1.0)
                                             / np.float32(denom))
    partials = torch.empty(SQ_PARTIALS, dtype=torch.float64, device=dev) \
        if with_sq_norm else None
    _LIB.launch("unpack_buckets", ptr.ctypes.data, off.ctypes.data,
                lens.ctypes.data, lens.size, _CODE[dtype], out.data_ptr(),
                int(denom is not None), scale,
                None if partials is None else partials.data_ptr(),
                SQ_PARTIALS, None if sq is None else sq.data_ptr(), stream())
    return out, sq
