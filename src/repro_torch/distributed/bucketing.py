"""Bucketed gradient all-reduce (the JAX package's
``distributed/bucketing.py``, its plain flat part).

The per-leaf ``compressed_psum`` issues one collective per parameter
leaf, 161 for ResNet-50. This module lays the gradients out as one
contiguous wire-dtype stream, cuts it into fixed-size buckets (64 MiB by
default, so ResNet-50's 51 MB bf16 stream is one bucket), runs **one
all-reduce per bucket**, and cuts the result back into leaves. Leaves
may span bucket boundaries: the stream is split at fixed element
offsets, so the collective count is ``ceil(wire bytes / bucket bytes)``.

The layout is the JAX package's, field by field: leaves in the order
``jax.tree.flatten`` gives the nested parameter dict (sorted path by
path), the same offsets, ``bucket_elems``, ``n_buckets`` and
``pad_elems``. Numerics are those of the per-leaf path: cast to the
wire dtype, sum over the workers, cast back, divide; packing only moves
where element i sits during the sum. The casts of the whole stream are
the ``cast_copy`` kernel (``kernels/bucket_ops.py``) on the card.

Not ported yet: the ready-order plans of the overlapped step, the shard
layouts of ZeRO and the hierarchical schedules (ROADMAP queue 1, items
10, 11 and 13), and error feedback (item 6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.compression import _wire
from repro_torch.kernels.bucket_ops import pack_cast, unpack_cast

DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one gradient leaf lives in the packed stream."""

    offset: int  # element offset into the flat stream
    size: int
    shape: Tuple[int, ...]
    dtype: torch.dtype  # the leaf's own (accumulation) dtype


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static layout of the gradients packed into fixed buckets; derived
    from shapes only, so one plan serves every step. ``names`` holds the
    leaves' names in stream order (the JAX plan's treedef)."""

    names: Tuple[str, ...]
    slots: Tuple[LeafSlot, ...]
    total_elems: int
    bucket_elems: int  # elements per bucket (fixed; the last may be short)
    n_buckets: int
    wire: Optional[str]  # wire dtype name, None = no cast
    stream_dtype: torch.dtype
    align: int = 1  # every bucket length is a multiple of this
    pad_elems: int = 0  # zero tail making the last bucket align-even

    @property
    def padded_total(self) -> int:
        return self.total_elems + self.pad_elems

    def bucket_bounds(self, i: int) -> Tuple[int, int]:
        lo = i * self.bucket_elems
        return lo, min(lo + self.bucket_elems, self.padded_total)

    @property
    def bucket_bytes(self) -> int:
        return self.bucket_elems * self.stream_dtype.itemsize

    def describe(self) -> str:
        mib = self.total_elems * self.stream_dtype.itemsize / 2 ** 20
        pad = f" +{self.pad_elems}pad" if self.pad_elems else ""
        return (f"{len(self.slots)} leaves / {mib:.1f} MiB wire -> "
                f"{self.n_buckets} bucket(s) of <= "
                f"{self.bucket_bytes / 2 ** 20:.0f} MiB "
                f"({self.wire or 'f32'} wire{pad})")


def stream_layout(total_elems: int, bucket_bytes: int, itemsize: int,
                  align: int = 1) -> Tuple[int, int, int]:
    """``(bucket_elems, n_buckets, pad_elems)`` of a stream of
    ``total_elems``: the bucket arithmetic of every plan."""
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    bucket_elems = max(1, int(bucket_bytes) // itemsize)
    bucket_elems = -(-bucket_elems // align) * align  # round up to align
    n_buckets = max(1, -(-total_elems // bucket_elems))
    last = total_elems - (n_buckets - 1) * bucket_elems
    return bucket_elems, n_buckets, (-last) % align


def leaf_order(names) -> List[str]:
    """Leaf names in ``jax.tree.flatten`` order of the nested dict they
    come from: sorted path component by path component."""
    return sorted(names, key=lambda k: tuple(k.split("/")))


def plan_buckets(grads: Dict[str, Tensor],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 wire: Optional[str] = "bf16", align: int = 1
                 ) -> BucketPlan:
    """Lay the gradients out as a contiguous wire-dtype stream cut into
    fixed-size buckets; ``align > 1`` pads the stream so every bucket is
    an ``align`` multiple."""
    if not grads:
        raise ValueError("cannot plan buckets for an empty gradient dict")
    names = leaf_order(grads)
    wdt = _wire(wire)
    if wdt is None:
        dtypes = {grads[k].dtype for k in names}
        if len(dtypes) > 1:
            raise ValueError(
                "bucketing without a wire dtype needs uniform leaf dtypes, "
                f"got {sorted(str(d) for d in dtypes)}; set a wire dtype "
                "(e.g. 'bf16+bucketed')")
        wdt = next(iter(dtypes))
    slots, offset = [], 0
    for k in names:
        shape = tuple(grads[k].shape)
        size = math.prod(shape)
        slots.append(LeafSlot(offset, size, shape, grads[k].dtype))
        offset += size
    bucket_elems, n_buckets, pad = stream_layout(offset, bucket_bytes,
                                                 wdt.itemsize, align)
    return BucketPlan(names=tuple(names), slots=tuple(slots),
                      total_elems=offset, bucket_elems=bucket_elems,
                      n_buckets=n_buckets, wire=wire, stream_dtype=wdt,
                      align=align, pad_elems=pad)


def pack(grads: Dict[str, Tensor], plan: BucketPlan) -> List[Tensor]:
    """Gradients -> ``n_buckets`` wire-dtype buckets: the leaves are
    concatenated into one stream, which is cast as a whole (the
    ``cast_copy`` kernel on the card), zero-padded to the plan's length
    and cut into views."""
    leaves = [grads[k].reshape(-1) for k in plan.names]
    stream = torch.cat(leaves)
    if stream.dtype != plan.stream_dtype:
        stream = pack_cast(stream, plan.stream_dtype)
    if plan.pad_elems:
        stream = torch.cat([stream, stream.new_zeros(plan.pad_elems)])
    return [stream[lo:hi] for lo, hi in
            (plan.bucket_bounds(i) for i in range(plan.n_buckets))]


def unpack(buckets: Sequence[Tensor], plan: BucketPlan,
           denom: Optional[int] = None, with_sq_norm: bool = False):
    """Buckets -> gradients (views into one float stream). ``denom``
    divides after the cast back, as ``compressed_psum`` does.
    ``with_sq_norm`` also returns the squared L2 norm of the whole
    (cast back, divided) stream, from one pass over it."""
    stream = buckets[0] if len(buckets) == 1 else torch.cat(list(buckets))
    stream = stream[:plan.total_elems]
    dtypes = {s.dtype for s in plan.slots}
    if len(dtypes) != 1:
        raise ValueError("unpack needs one accumulation dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    acc = next(iter(dtypes))
    if stream.dtype != acc:
        stream = unpack_cast(stream.contiguous(), acc)
    if denom is not None:
        stream = stream / denom
    grads = {k: stream[s.offset:s.offset + s.size].view(s.shape)
             for k, s in zip(plan.names, plan.slots)}
    if with_sq_norm:
        return grads, stream.float().square().sum()
    return grads


def bucketed_psum(grads: Dict[str, Tensor], wire: Optional[str] = "bf16",
                  bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                  mean: bool = True, plan: Optional[BucketPlan] = None,
                  with_sq_norm: bool = False, group=None):
    """Drop-in for ``compressed_psum`` issuing one all-reduce per bucket
    instead of one per leaf. ``with_sq_norm=True`` returns ``(grads,
    sq_norm)``."""
    if plan is None:
        plan = plan_buckets(grads, bucket_bytes, wire)
    n = dist.get_world_size(group)
    buckets = pack(grads, plan)
    for b in buckets:
        dist.all_reduce(b, group=group)
    return unpack(buckets, plan, denom=n if mean else None,
                  with_sq_norm=with_sq_norm)
