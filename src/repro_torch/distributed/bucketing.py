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

The stream-LARS path adds the leaf-segment map of the stream
(``segment_ids_stream``), its per-segment squared norms
(``segment_sq_partials``, the plain version of the ``seg_sq_partials``
kernel) and a worker's 1/N slice of it (``local_shard``), and
``bucketed_psum_ef`` threads error feedback through the bucketed sync.

The overlapped step lays the stream out in backward-completion order
instead (``plan_ready_buckets``): the segments' gradients in the order
the backward produces them, so a bucket closes as soon as the segment
holding its last element is done, and ``pack_bucket`` casts each
segment's gradients as they come and hands out the buckets they close.

ZeRO (``--zero``) keeps its optimizer state in the *shard layout* of the
stream: worker-major, each worker's chunks in bucket order
(``shard_perm``, ``stream_to_shard_layout`` and its inverse), so worker
w's state is block w of it. ``split_shard`` cuts a shard back into its
per-bucket chunks.

The hierarchical schedules (``Hierarchy``, ``hierarchical_psum``,
``hierarchical_psum_scatter``, ``hierarchical_all_gather``) run each
bucket's collective in two levels over a DP layout split into an outer
(inter-node) and an inner (intra-node) stage, so the expensive link
carries 1/inner of the bucket; ``bucketed_psum(..., hierarchy=)`` takes
them in place of the flat all-reduce.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.compression import _wire, apply_error_feedback
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
    return _plan(leaf_order(grads), grads, bucket_bytes, wire, align)


def _plan(names: List[str], grads: Dict[str, Tensor], bucket_bytes: int,
          wire: Optional[str], align: int) -> BucketPlan:
    """The plan of the leaves ``names`` of ``grads``, in that order."""
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
                  with_sq_norm: bool = False, group=None,
                  hierarchy: Optional["Hierarchy"] = None):
    """Drop-in for ``compressed_psum`` issuing one all-reduce per bucket
    instead of one per leaf. ``with_sq_norm=True`` returns ``(grads,
    sq_norm)``. ``hierarchy`` (with its process groups,
    ``hierarchy_groups``) runs each bucket through the two-level
    ``hierarchical_psum`` instead; the plan is then shard-aligned
    (``align = hierarchy.n_workers``) so every bucket splits evenly over
    the inner stage."""
    if plan is None:
        align = hierarchy.n_workers if hierarchy is not None else 1
        plan = plan_buckets(grads, bucket_bytes, wire, align=align)
    n = dist.get_world_size(group)
    buckets = pack(grads, plan)
    for b in buckets:
        if hierarchy is not None:
            hierarchical_psum(b, hierarchy)
        else:
            dist.all_reduce(b, group=group)
    return unpack(buckets, plan, denom=n if mean else None,
                  with_sq_norm=with_sq_norm)


def bucketed_psum_ef(grads: Dict[str, Tensor], residual: Dict[str, Tensor],
                     wire: str = "bf16",
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     mean: bool = True, plan: Optional[BucketPlan] = None,
                     with_sq_norm: bool = False, group=None,
                     hierarchy: Optional["Hierarchy"] = None):
    """``bucketed_psum`` with error feedback threaded through: q = Q(g +
    r) is packed and reduced, r' stays with the worker. Error feedback
    runs before packing, so its residuals are those of the per-leaf
    ``compressed_psum_ef``. Returns ``(synced, new_residual)``, or
    ``(synced, new_residual, sq_norm)`` with ``with_sq_norm``."""
    quant, new_residual = apply_error_feedback(grads, residual, wire)
    out = bucketed_psum(quant, wire, bucket_bytes, mean=mean, plan=plan,
                        with_sq_norm=with_sq_norm, group=group,
                        hierarchy=hierarchy)
    if with_sq_norm:
        synced, sq_norm = out
        return synced, new_residual, sq_norm
    return out, new_residual


# ---------------------------------------------------------------------------
# worker shards of the stream and its leaf segments (stream-LARS)
# ---------------------------------------------------------------------------
#
# Every bucket of an ``align=n`` plan splits into n equal chunks, one per
# worker; a worker's shard is its chunk of every bucket, in bucket order.
# The stream-LARS step reduces its trust norms on that shard only, so
# the workers' partials add up to the whole stream's.


def shard_chunks(plan: BucketPlan, n_shards: int) -> Tuple[int, ...]:
    """Per-bucket chunk length owned by each of ``n_shards`` workers."""
    sizes = []
    for b in range(plan.n_buckets):
        lo, hi = plan.bucket_bounds(b)
        if (hi - lo) % n_shards:
            raise ValueError(
                f"bucket {b} has {hi - lo} elements, not divisible by "
                f"{n_shards} shards; plan with align={n_shards}")
        sizes.append((hi - lo) // n_shards)
    return tuple(sizes)


def shard_size(plan: BucketPlan, n_shards: int) -> int:
    """Elements per worker shard (== padded_total / n_shards)."""
    return sum(shard_chunks(plan, n_shards))


def local_shard(stream: Tensor, plan: BucketPlan, n_shards: int,
                shard_idx: int) -> Tensor:
    """Worker ``shard_idx``'s shard of a full packed (padded) stream: the
    concatenation of its per-bucket chunks (a view when the plan has one
    bucket)."""
    parts = []
    for b, c in enumerate(shard_chunks(plan, n_shards)):
        lo, _ = plan.bucket_bounds(b)
        parts.append(stream[lo + shard_idx * c:lo + (shard_idx + 1) * c])
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def split_shard(shard: Tensor, plan: BucketPlan, n_shards: int
                ) -> List[Tensor]:
    """The inverse of ``local_shard``'s concatenation: a worker shard cut
    back into its per-bucket chunks (views)."""
    out, off = [], 0
    for c in shard_chunks(plan, n_shards):
        out.append(shard[off:off + c])
        off += c
    return out


def shard_perm(plan: BucketPlan, n_shards: int) -> np.ndarray:
    """Gather indices ``perm`` with ``shard_layout = stream[perm]``:
    worker-major, bucket order within each worker. A plan constant, used
    on the host by the checkpoint path."""
    idx = []
    chunks = shard_chunks(plan, n_shards)
    for w in range(n_shards):
        for b, c in enumerate(chunks):
            lo, _ = plan.bucket_bounds(b)
            idx.append(np.arange(lo + w * c, lo + (w + 1) * c))
    return np.concatenate(idx)


def stream_to_shard_layout(arr, plan: BucketPlan, n_shards: int):
    """A padded-stream-order array (numpy, or a tensor) in shard layout:
    block w of the result is worker w's ``local_shard``."""
    return arr[_index(shard_perm(plan, n_shards), arr)]


def shard_layout_to_stream(arr, plan: BucketPlan, n_shards: int):
    """The inverse of ``stream_to_shard_layout``."""
    perm = shard_perm(plan, n_shards)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return arr[_index(inv, arr)]


def _index(idx: np.ndarray, arr):
    return (torch.from_numpy(idx).to(arr.device) if torch.is_tensor(arr)
            else idx)


# ---------------------------------------------------------------------------
# hierarchical collective schedules
# ---------------------------------------------------------------------------
#
# At the paper's scale the expensive link sits between nodes. Per bucket,
# the two-level schedule runs an intra-node reduce-scatter (the whole
# bucket, on cheap links), an inter-node all-reduce of the 1/inner shard,
# and an intra-node all-gather, so the inter-node link carries 1/inner of
# the bucket. Workers are ranked row-major over the DP axes, w = outer_idx
# * inner_size + inner_idx, as the JAX package's ``_dp_linear_index``
# ranks its devices: the inner group of worker w is {n*I + d' : d'}, its
# outer group {n'*I + d : n'}. Both stages accumulate in f32 and round to
# the wire dtype once, as the JAX package does: on the same inputs the
# result is its bits.


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """A two-level schedule over the DP axes: ``outer`` the inter-node
    axes, ``inner`` the intra-node ones. ``make_hierarchy`` makes the
    spec; ``hierarchy_groups`` adds this worker's two process groups,
    which the collectives below need."""

    outer: Tuple[str, ...]
    inner: Tuple[str, ...]
    outer_size: int
    inner_size: int
    inner_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    outer_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @property
    def n_workers(self) -> int:
        return self.outer_size * self.inner_size

    def describe(self) -> str:
        return (f"hier[{'x'.join(self.outer)}({self.outer_size}) | "
                f"{'x'.join(self.inner)}({self.inner_size})]")


def make_hierarchy(dp_axes: Sequence[str], mesh_shape: Mapping[str, int],
                   split: int) -> Hierarchy:
    """Split ``dp_axes`` into outer ``dp_axes[:split]`` and inner
    ``dp_axes[split:]``; ``mesh_shape`` maps an axis name to its size.
    Both stages must have two workers or more: a stage of one is the
    flat collective, which the caller should use instead."""
    dp_axes = tuple(dp_axes)
    if not 1 <= split < len(dp_axes):
        raise ValueError(
            f"hier_split must be in [1, {len(dp_axes) - 1}] for dp_axes "
            f"{dp_axes}, got {split}")
    outer, inner = dp_axes[:split], dp_axes[split:]
    outer_size = math.prod(int(mesh_shape[a]) for a in outer)
    inner_size = math.prod(int(mesh_shape[a]) for a in inner)
    if outer_size < 2 or inner_size < 2:
        raise ValueError(
            f"hierarchical schedule needs both stages >= 2 ranks, got "
            f"outer={outer}:{outer_size} inner={inner}:{inner_size}; "
            "use the flat schedule on this mesh")
    return Hierarchy(outer=outer, inner=inner, outer_size=outer_size,
                     inner_size=inner_size)


# (outer size, inner size) -> (the default group they were built in,
# this worker's inner group, its outer group)
_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any, Any]] = {}


def hierarchy_groups(hier: Hierarchy) -> Hierarchy:
    """``hier`` with this worker's inner and outer process groups, made
    with ``dist.new_group`` the first time a layout is asked for in this
    worker group and kept. Every worker makes every subgroup, all in the
    same order (or the run deadlocks), so every worker must call this at
    the same point: the step builders do, once."""
    world = dist.group.WORLD
    n = dist.get_world_size()
    if n != hier.n_workers:
        raise ValueError(
            f"{hier.describe()} lays out {hier.n_workers} workers, the "
            f"worker group has {n}")
    key = (hier.outer_size, hier.inner_size)
    got = _GROUPS.get(key)
    if got is None or got[0] is not world:
        o_n, i_n = key
        inner = [dist.new_group([o * i_n + d for d in range(i_n)])
                 for o in range(o_n)]
        outer = [dist.new_group([o * i_n + d for o in range(o_n)])
                 for d in range(i_n)]
        w = dist.get_rank()
        got = _GROUPS[key] = (world, inner[w // i_n], outer[w % i_n])
    return dataclasses.replace(hier, inner_group=got[1], outer_group=got[2])


def forget_hierarchy_groups() -> None:
    """Drop the kept subgroups (``process_group.shutdown`` calls this
    after leaving the worker group)."""
    _GROUPS.clear()


def inner_major_perm(x, outer_size: int, inner_size: int):
    """The stream re-laid inner-major, so that the inner-then-outer
    double reduce-scatter hands worker ``w = n*inner_size + d`` the chunk
    the flat reduce-scatter would: viewed as ``n_workers`` chunks, chunk
    ``w`` moves to inner position ``d``, outer position ``n``. A reshape
    and a transpose: numpy arrays and tensors alike."""
    a, b = outer_size, inner_size
    c = x.shape[0] // (a * b)
    return x.reshape(a, b, c).swapaxes(0, 1).reshape(-1)


def inner_major_unperm(x, outer_size: int, inner_size: int):
    """The inverse of ``inner_major_perm``."""
    a, b = outer_size, inner_size
    c = x.shape[0] // (a * b)
    return x.reshape(b, a, c).swapaxes(0, 1).reshape(-1)


class ChainedWork:
    """The handle of an asynchronous two-level collective. torch gives
    one handle per call and a later stage needs the earlier one's
    output, so only the first stage runs asynchronously; ``wait()``
    waits for it and runs the rest. ``keep`` holds the first stage's
    tensors until then."""

    def __init__(self, first, rest, keep=()):
        self._first, self._rest, self._keep = first, rest, keep

    def wait(self) -> bool:
        self._first.wait()
        self._rest()
        self._keep = ()
        return True


def _chain(first, rest, async_op: bool, keep=()):
    if async_op:
        return ChainedWork(first, rest, keep)
    rest()
    return None


def _need_groups(hier: Hierarchy) -> None:
    if hier.inner_group is None or hier.outer_group is None:
        raise ValueError(f"{hier.describe()} has no process groups: pass "
                         "it through hierarchy_groups first")


def hierarchical_psum(bucket: Tensor, hier: Hierarchy,
                      async_op: bool = False) -> Optional[ChainedWork]:
    """The two-level all-reduce of one packed bucket, in place, as
    ``dist.all_reduce``: an f32 reduce-scatter over the inner group, an
    f32 all-reduce of the 1/inner shard over the outer group, one
    rounding to the bucket's dtype, an all-gather over the inner group.
    The bucket's length must split over the inner group (a plan with
    ``align = hier.n_workers`` does). ``async_op`` returns a
    ``ChainedWork`` whose ``wait()`` runs the last two stages."""
    _need_groups(hier)
    if bucket.numel() % hier.inner_size:
        raise ValueError(
            f"bucket of {bucket.numel()} elements does not split over "
            f"{hier.inner_size} inner ranks; plan with "
            f"align={hier.n_workers}")
    f = bucket.float()
    shard = f.new_empty(f.numel() // hier.inner_size)
    first = dist.reduce_scatter_tensor(shard, f, group=hier.inner_group,
                                       async_op=async_op)

    def rest():
        dist.all_reduce(shard, group=hier.outer_group)
        dist.all_gather_into_tensor(bucket, shard.to(bucket.dtype),
                                    group=hier.inner_group)

    return _chain(first, rest, async_op, (f,))


def hierarchical_psum_scatter(output: Tensor, bucket: Tensor,
                              hier: Hierarchy, async_op: bool = False
                              ) -> Optional[ChainedWork]:
    """The two-level reduce-scatter of one packed bucket (ZeRO), as
    ``dist.reduce_scatter_tensor``: after ``inner_major_perm``, an f32
    reduce-scatter over the inner group and one over the outer group
    leave worker ``w`` holding chunk ``w`` of the summed bucket, the
    chunk the flat reduce-scatter gives it, rounded to ``output``'s
    dtype once. Shard ownership, and so the optimizer state's layout and
    the checkpoints, do not change under a hierarchy."""
    _need_groups(hier)
    if bucket.numel() % hier.n_workers:
        raise ValueError(
            f"bucket of {bucket.numel()} elements does not split over "
            f"{hier.n_workers} ranks; plan with align={hier.n_workers}")
    f = inner_major_perm(bucket.float(), hier.outer_size, hier.inner_size)
    mid = f.new_empty(f.numel() // hier.inner_size)
    first = dist.reduce_scatter_tensor(mid, f, group=hier.inner_group,
                                       async_op=async_op)

    def rest():
        s = mid.new_empty(mid.numel() // hier.outer_size)
        dist.reduce_scatter_tensor(s, mid, group=hier.outer_group)
        output.copy_(s)

    return _chain(first, rest, async_op, (f,))


def hierarchical_all_gather(output: Tensor, shard: Tensor,
                            hier: Hierarchy) -> None:
    """The two-level inverse of the flat all-gather, as
    ``dist.all_gather_into_tensor``: gather over the outer group, then
    the inner group, then undo the inner-major layout. It only moves
    data, so it is bitwise the flat gather on any input."""
    _need_groups(hier)
    g = shard.new_empty(shard.numel() * hier.outer_size)
    dist.all_gather_into_tensor(g, shard, group=hier.outer_group)
    full = shard.new_empty(g.numel() * hier.inner_size)
    dist.all_gather_into_tensor(full, g, group=hier.inner_group)
    output.copy_(inner_major_unperm(full, hier.outer_size, hier.inner_size))


def segment_ids_stream(plan: BucketPlan) -> np.ndarray:
    """int32[padded_total] mapping each stream position to its leaf index
    in ``plan.slots`` order; the alignment pad maps to the extra trailing
    segment ``len(plan.slots)`` (never trusted, never decayed). The ids
    are non-decreasing along the stream, and so along every
    ``local_shard`` of it (asserted: the ``seg_sq_partials`` kernel
    relies on it for its speed)."""
    ids = np.full((plan.padded_total,), len(plan.slots), np.int32)
    for i, s in enumerate(plan.slots):
        ids[s.offset:s.offset + s.size] = i
    assert (np.diff(ids) >= 0).all(), "leaf slots out of stream order"
    return ids


def segment_sq_partials(x: Tensor, seg_ids: Tensor, num_segments: int
                        ) -> Tensor:
    """f32[num_segments] per-segment sums of squares of flat ``x``; ids
    outside ``[0, num_segments)`` are dropped, as ``segment_sum`` drops
    them, and a segment with no elements sums to 0.

    Ids may come in any order. Each segment is summed as one contiguous
    slice (after a stable sort when the ids are not sorted), so its sum
    does not depend on where its elements sit in ``x``: a leaf's norm on
    its own (``optim/lars.py``) and as a segment of the stream are
    bitwise equal. No float atomics, so a CUDA tensor gets the same
    answer every time (``index_add_`` would not); the slice bounds are
    read on the host."""
    sq = x.reshape(-1).float().square()
    seg = seg_ids.reshape(-1).long()
    if seg.numel() > 1 and not bool((seg[1:] >= seg[:-1]).all()):
        seg, order = torch.sort(seg, stable=True)
        sq = sq[order]
    bounds = torch.searchsorted(
        seg, torch.arange(num_segments + 1, device=seg.device)).tolist()
    return torch.stack([sq[lo:hi].sum() for lo, hi in
                        zip(bounds[:-1], bounds[1:])])


# ---------------------------------------------------------------------------
# ready-order buckets (the backward-overlapped sync)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReadyBucketPlan:
    """A ``BucketPlan`` whose stream is laid out in backward-completion
    order: the stage trees (segments) in the order the backward produces
    them, last forward segment first, each stage's leaves in
    ``leaf_order``. ``ready_stage[b]`` is the stage (in that order)
    whose gradients complete bucket ``b``; it never decreases in ``b``."""

    base: BucketPlan
    stage_ends: Tuple[int, ...]  # cumulative element end of each stage
    ready_stage: Tuple[int, ...]  # per bucket

    @property
    def n_buckets(self) -> int:
        return self.base.n_buckets

    def buckets_ready_at(self, stage_idx: int) -> Tuple[int, ...]:
        return tuple(b for b, s in enumerate(self.ready_stage)
                     if s == stage_idx)


def plan_ready_buckets(stage_trees: Sequence[Dict[str, Tensor]],
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                       wire: Optional[str] = "bf16",
                       align: int = 1) -> ReadyBucketPlan:
    """Lay out per-stage gradient dicts, given in backward-completion
    order, as one stream cut into fixed-size buckets. Only where a leaf
    sits changes against ``plan_buckets``, and the sync is elementwise
    (cast, sum, cast back, divide), so the values cannot change. The
    shard-aligned zero tail (``align > 1``) belongs to the last bucket,
    which closes with the last real element."""
    stage_trees = list(stage_trees)
    if not stage_trees or not any(stage_trees):
        raise ValueError("need at least one stage with gradients")
    names = [k for t in stage_trees for k in leaf_order(t)]
    if len(set(names)) != len(names):
        raise ValueError("a leaf name appears in more than one stage")
    merged = {k: v for t in stage_trees for k, v in t.items()}
    base = _plan(names, merged, bucket_bytes, wire, align)
    ends: List[int] = []
    off = 0
    for t in stage_trees:
        off += sum(v.numel() for v in t.values())
        ends.append(off)
    assert off == base.total_elems
    ready = []
    for b in range(base.n_buckets):
        # the stage that holds the bucket's last real element (the zero
        # tail of a shard-aligned plan needs no stage)
        hi_real = min(base.bucket_bounds(b)[1], base.total_elems)
        ready.append(next(i for i, e in enumerate(ends) if e >= hi_real))
    return ReadyBucketPlan(base=base, stage_ends=tuple(ends),
                           ready_stage=tuple(ready))


def pack_bucket(plan: ReadyBucketPlan, stage_idx: int,
                stage_tree: Dict[str, Tensor],
                carry: Optional[Tensor] = None
                ) -> Tuple[List[Tuple[int, Tensor]], Tensor]:
    """Feed stage ``stage_idx``'s gradients, stages in ready order
    (0, 1, ...): they are concatenated in ``leaf_order`` and cast to the
    wire dtype in one pass (the ``cast_copy`` kernel on the card).
    Returns ``(ready, carry')``: the ``(bucket id, wire tensor)`` of the
    buckets this stage closed, and the unemitted tail for the next
    stage. A bucket that lies inside this stage is a view of its cast
    stream; one that begins in the carry is a new tensor."""
    base = plan.base
    leaves = [stage_tree[k].reshape(-1) for k in leaf_order(stage_tree)]
    flat = (torch.cat(leaves) if leaves else torch.empty(
        (0,), dtype=base.stream_dtype,
        device=None if carry is None else carry.device))
    if flat.dtype != base.stream_dtype:
        flat = pack_cast(flat, base.stream_dtype)
    carry_len = 0 if carry is None else carry.numel()
    fed_end = plan.stage_ends[stage_idx]
    flat_start = fed_end - flat.numel()
    stream_start = flat_start - carry_len
    joined: Optional[Tensor] = None

    def view(lo: int, hi: int) -> Tensor:
        nonlocal joined
        if lo >= flat_start:
            return flat[lo - flat_start:hi - flat_start]
        if joined is None:
            joined = torch.cat([carry, flat])
        return joined[lo - stream_start:hi - stream_start]

    ready = []
    emitted_end = stream_start
    for b in plan.buckets_ready_at(stage_idx):
        lo, hi = base.bucket_bounds(b)
        # only a shard-aligned plan's final tail may be zero-filled: a
        # bucket marked ready before its last real element is fed must
        # trip the assert, never sync zeros in its place
        hi_real = min(hi, base.total_elems)
        assert lo >= stream_start and hi_real <= fed_end, (b, lo, hi)
        arr = view(lo, hi_real)
        if hi > hi_real:
            arr = torch.cat([arr, arr.new_zeros(hi - hi_real)])
        ready.append((b, arr))
        emitted_end = hi_real
    return ready, view(emitted_end, fed_end)


def reorder_stream(stream: Tensor, src: BucketPlan, dst: BucketPlan
                   ) -> Tensor:
    """A packed stream laid out by ``src``, laid out by ``dst`` instead
    (the same leaves and padded length, in another order; the zero tail
    stays last): one copy, no arithmetic."""
    slots = dict(zip(src.names, src.slots))
    assert set(slots) == set(dst.names), "plans of different leaves"
    assert src.padded_total == dst.padded_total == stream.numel()
    parts = [stream[s.offset:s.offset + s.size]
             for s in (slots[k] for k in dst.names)]
    return torch.cat(parts + [stream[src.total_elems:]])
