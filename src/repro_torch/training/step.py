"""Step builders: the single-device step and the paper's explicit
data-parallel step.

``make_train_step`` is the single-device step of the JAX package's
``make_train_step`` with no mesh: cast every float parameter to the
compute dtype, take the loss and its gradients (accumulated over
``microbatches`` if asked), round-trip the gradients through the wire
dtype of ``compression`` (paper §3), and apply the optimizer.

``make_dp_shardmap_train_step`` is the JAX package's
``make_dp_shardmap_train_step``. PyTorch has no shard_map: every worker
is its own process (``distributed/process_group.py``) running this step
on its own shard of the global batch, with its own BN statistics. The
gradients are all-reduced in half precision, per leaf
(``compressed_psum``) or per bucket (``bucketed_psum``), optionally
with error feedback, the scalar metrics are averaged in one all-reduce,
and every worker applies the same optimizer update to its replica of
the parameters. A packed-stream optimizer (stream-LARS,
``optim/stream.py``) takes ``_make_dp_stream_train_step`` instead: the
update runs on the flat synced stream, and the LARS trust norms are
reduced on each worker's 1/N slice of it.

ZeRO (``zero_dp``, ``_make_dp_zero_train_step``) reduce-scatters each
bucket instead of all-reducing it: every worker updates only its shard
of the packed stream with a stream optimizer, keeps only that shard of
the optimizer state, and all-gathers the updated parameter slices back.
Its end state is bitwise that of the all-reduce paths.

``make_dp_overlap_train_step`` is the same step with the gradient
all-reduces (or ZeRO's reduce-scatters) started during the backward
pass: the loss runs as a chain of segments (``model.loss_segments``),
the segments' backwards run last segment first, and each bucket of a
stream laid out in that order is synced asynchronously as soon as the
segment holding its last gradient is done, while the earlier segments'
backwards compute.

A hierarchical schedule (``parallel.hier_split`` over a DP layout of two
stages, ``mesh_shape``) runs every bucketed path's per-bucket collective
in two levels (``distributed/bucketing.py``): the all-reduce as
``hierarchical_psum``, ZeRO's reduce-scatter and all-gather as
``hierarchical_psum_scatter`` and ``hierarchical_all_gather``. The
scalar metrics and the LARS trust-norm partials stay one flat
all-reduce each, as in the JAX package.

``make_prefill_step`` and ``make_decode_step`` are the serving steps of
an LM, thin wrappers around the model's ``prefill`` and ``decode_step``
as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.core.batchnorm import finalize_bn_stats
from repro_torch.core.compression import (
    apply_error_feedback,
    compressed_psum,
    compressed_psum_ef,
    parse_compression,
    simulate_wire_cast,
)
from repro_torch.distributed.bucketing import (
    BucketPlan,
    Hierarchy,
    ReadyBucketPlan,
    bucketed_psum,
    bucketed_psum_ef,
    hierarchical_all_gather,
    hierarchical_psum,
    hierarchical_psum_scatter,
    hierarchy_groups,
    leaf_order,
    make_hierarchy,
    local_shard,
    pack,
    pack_bucket,
    plan_buckets,
    plan_ready_buckets,
    reorder_stream,
    segment_ids_stream,
    shard_chunks,
    split_shard,
    unpack,
)
from repro_torch.kernels.ops import (
    fused_input_eval,
    fused_input_train,
    input_augment_params,
    unpack_cast,
)
from repro_torch.models.common import staged_forward
from repro_torch.optim.interface import Optimizer
from repro_torch.optim.stream import trust_mask_segments

Tree = Dict[str, Any]


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, Any]:
    """Host batch (numpy or tensors) -> tensors on ``device``; labels
    become int64 (the index type of ``gather``). Scalars that are not
    tensors (the ``input_step`` stamp) stay host integers."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v) and np.ndim(v) == 0:
            out[k] = int(v)
            continue
        t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        if k == "labels":
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def _grads_of(model, train_cfg: TrainConfig, params, mstate, mbatch):
    """(new BN state, metrics, f32 gradients) of one (micro)batch. Every
    parameter is cast to the compute dtype first; the gradients reach
    the f32 masters through that cast."""
    names = list(params)
    pc = {k: params[k].detach().to(model.compute_dtype).requires_grad_(True)
          for k in names}
    loss, (new_mstate, metrics) = model.loss_fn(
        pc, mstate, mbatch, train_cfg.label_smoothing)
    gs = torch.autograd.grad(loss, [pc[k] for k in names])
    return new_mstate, metrics, {k: g.float() for k, g in zip(names, gs)}


def make_train_step(model, optimizer: Optimizer, train_cfg: TrainConfig,
                    microbatches: int = 1):
    """Train step: (state, batch) -> (state', metrics), with
    state = {"params", "opt", "model_state"}. ``train_cfg.log_grad_norm``
    adds the norm of the (wire-cast) gradients as ``grad_norm``, as in
    the JAX package. ``microbatches`` > 1 splits
    the batch's leading dim and accumulates the mean of the microbatch
    gradients (equal to the full-batch gradient for a mean loss); the BN
    state threads through the microbatches and the last one's is kept."""
    wire, _ = parse_compression(train_cfg.parallel.compression)
    device = model.device

    def train_step(state: Tree, batch: Tree):
        batch = to_device(batch, device)
        params = state["params"]
        if microbatches <= 1:
            new_mstate, metrics, grads = _grads_of(
                model, train_cfg, params, state["model_state"], batch)
        else:
            b = batch["images"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mstate = state["model_state"]
            grads = None
            seq = []
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
                mstate, metrics, g = _grads_of(model, train_cfg, params,
                                               mstate, mb)
                g = {k: v / microbatches for k, v in g.items()}
                grads = g if grads is None else {
                    k: grads[k] + g[k] for k in grads}
                seq.append(metrics)
            new_mstate = mstate
            metrics = {k: torch.stack([m[k].float() for m in seq]).mean()
                       for k in seq[0]}
        grads = simulate_wire_cast(grads, wire)
        new_params, new_opt, opt_metrics = optimizer.update(
            params, grads, state["opt"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        if train_cfg.log_grad_norm:
            # opt-in: one extra reduction over every gradient (the
            # sentinel's whole-gradient health flag)
            metrics["grad_norm"] = global_norm(grads)
        new_state = {"params": new_params, "opt": new_opt,
                     "model_state": new_mstate}
        return new_state, metrics

    return train_step


def make_eval_step(model, train_cfg: Optional[TrainConfig] = None):
    """Validation step: (params, model_state, batch) -> metrics. The
    parameters stay fp32 masters (only conv and fc weights are cast to
    the activation dtype inside the model), as in the JAX package."""
    del train_cfg  # schedules don't enter the eval path

    @torch.no_grad()
    def eval_step(params, model_state, batch) -> Dict:
        return model.eval_fn(params, model_state,
                             to_device(batch, model.device))

    return eval_step


# ---------------------------------------------------------------------------
# the paper's explicit data-parallel step
# ---------------------------------------------------------------------------


def _pmean_metrics(metrics: Dict, group=None) -> Dict:
    """One all-reduce for all scalar metrics (stacked in key order, then
    divided by the worker count) instead of one per metric."""
    n = dist.get_world_size(group)
    out = dict(metrics)
    scalar = sorted(k for k, v in metrics.items()
                    if torch.is_tensor(v) and v.dim() == 0)
    if scalar:
        stacked = torch.stack([metrics[k].detach().float() for k in scalar])
        dist.all_reduce(stacked, group=group)
        stacked = stacked / n
        out.update({k: stacked[i] for i, k in enumerate(scalar)})
    for k, v in metrics.items():
        if torch.is_tensor(v) and v.dim() > 0:
            v = v.detach().float().clone()
            dist.all_reduce(v, group=group)
            out[k] = v / n
    return out


def make_batch_input_transform(input_cfg, seed: int, model, rank: int,
                               world: int):
    """The per-worker fused input transform of the DP step, or None when
    the fused path is off. It pops the batch's ``input_step`` stamp,
    draws the augmentation table of that step at the *global* batch size
    (``rank``'s rows are this worker's shard, as the data rows are), and
    runs the fused augment + normalize + cast kernel; with
    ``augment=False`` the normalize + cast kernel only."""
    if input_cfg is None or not input_cfg.fused:
        return None
    device = model.device
    out_dtype = model.compute_dtype
    mean = torch.tensor(input_cfg.mean, dtype=torch.float32, device=device)
    inv_std = 1.0 / torch.tensor(input_cfg.std, dtype=torch.float32,
                                 device=device)

    def transform(batch):
        batch = dict(batch)
        step_no = int(batch.pop("input_step"))
        x = batch["images"]
        if input_cfg.augment:
            b = x.shape[0]
            table = input_augment_params(seed, step_no, b * world,
                                         max_shift=input_cfg.max_shift)
            mine = torch.from_numpy(table[rank * b:(rank + 1) * b]).to(
                device)
            batch["images"] = fused_input_train(x, mine, mean, inv_std,
                                                out_dtype=out_dtype)
        else:
            batch["images"] = fused_input_eval(x, mean, inv_std,
                                               out_dtype=out_dtype)
        return batch

    return transform


def make_dp_shardmap_train_step(model, optimizer: Optimizer,
                                train_cfg: TrainConfig, group=None,
                                input_transform=None,
                                mesh_shape: Optional[Dict[str, int]] = None):
    """The paper's synchronous data-parallel step, as each worker runs
    it: forward and backward on the local batch with the worker's own
    BN statistics, the **half-precision all-reduce of the gradients**,
    one all-reduce of the scalar metrics, and the replicated optimizer
    update. The name is the JAX package's; there is no shard_map in
    PyTorch, and the collectives go through ``torch.distributed``
    (``group`` None is the default group).

    ``compression="<wire>+bucketed"`` swaps the per-leaf all-reduce for
    one all-reduce per ``bucket_bytes`` of wire traffic, and the
    gradient norm then comes from the packed stream.
    ``error_feedback=True`` threads each worker's rounding residual
    through either sync path (the state gains ``ef_residual``, one per
    worker like the BN statistics). An optimizer with ``update_shard``
    (stream-LARS) takes the packed-stream step. ``zero_dp`` (``--zero``)
    takes ``_make_dp_zero_train_step``, and ``overlap_comm``
    ``make_dp_overlap_train_step``.

    ``parallel.hier_split`` runs each bucket's collective through the
    two-level schedule over the DP layout ``mesh_shape`` (DP axis name
    -> workers; None is the pure-DP default, every worker on the first
    axis), on every bucketed path (``_hier_or_none``)."""
    parallel = train_cfg.parallel
    if parallel.overlap_comm:
        return make_dp_overlap_train_step(model, optimizer, train_cfg, group,
                                          input_transform, mesh_shape)
    wire, bucketed = parse_compression(parallel.compression)
    use_ef = parallel.error_feedback
    if use_ef and wire is None:
        raise ValueError("error_feedback requires a wire dtype "
                         f"(compression={parallel.compression!r})")
    hier = _hier_or_none(parallel, mesh_shape, bucketed, group)
    if parallel.zero_dp:
        return _make_dp_zero_train_step(model, optimizer, train_cfg, wire,
                                        bucketed, group, input_transform,
                                        hier)
    if hasattr(optimizer, "update_shard"):
        return _make_dp_stream_train_step(model, optimizer, train_cfg, wire,
                                          bucketed, group, input_transform,
                                          hier)
    device = model.device
    plan = None

    def sync_grads(grads, residual):
        """One of the four (per-leaf | bucketed) x (plain | EF) sync
        paths: (synced, new residual or None, squared norm or None)."""
        nonlocal plan
        if bucketed and plan is None:
            # a hierarchy splits every bucket over the inner group
            plan = plan_buckets(grads, parallel.bucket_bytes, wire,
                                align=hier.n_workers if hier else 1)
        if use_ef:
            if bucketed:
                return bucketed_psum_ef(grads, residual, wire, plan=plan,
                                        with_sq_norm=True, group=group,
                                        hierarchy=hier)
            synced, new_residual = compressed_psum_ef(grads, residual, wire,
                                                      group=group)
            return synced, new_residual, None
        if bucketed:
            synced, sq = bucketed_psum(grads, wire, plan=plan, mean=True,
                                       with_sq_norm=True, group=group,
                                       hierarchy=hier)
            return synced, None, sq
        return compressed_psum(grads, wire, mean=True, group=group), None, \
            None

    def train_step(state: Tree, batch: Tree):
        batch = to_device(batch, device)
        if input_transform is not None:
            batch = input_transform(batch)
        params = state["params"]
        new_mstate, metrics, grads = _grads_of(
            model, train_cfg, params, state["model_state"], batch)
        # ---- the paper's technique: fp16/bf16 compressed all-reduce ----
        grads, new_residual, sq_norm = sync_grads(
            grads, state.get("ef_residual"))
        new_params, new_opt, metrics = _synced_update(
            optimizer, params, grads, state["opt"], metrics, sq_norm, group)
        new_state = {"params": new_params, "opt": new_opt,
                     "model_state": new_mstate}
        if use_ef:
            new_state["ef_residual"] = new_residual
        return new_state, metrics

    return train_step


def _synced_update(optimizer, params, grads, opt, metrics: Dict,
                   sq_norm: Optional[torch.Tensor], group=None):
    """The replicated update from the synced gradients, and the step's
    metrics: averaged over the workers, with the optimizer's and the
    norm of the synced gradient (from ``sq_norm`` when the sync gave
    it). Returns ``(params', opt', metrics)``."""
    metrics = _pmean_metrics(metrics, group)
    new_params, new_opt, opt_metrics = optimizer.update(params, grads, opt)
    metrics.update(opt_metrics)
    metrics["grad_norm"] = (torch.sqrt(sq_norm) if sq_norm is not None
                            else global_norm(grads))
    return new_params, new_opt, metrics


# ---------------------------------------------------------------------------
# the packed-stream step (stream-LARS)
# ---------------------------------------------------------------------------


def _hier_or_none(parallel, mesh_shape: Optional[Dict[str, int]],
                  bucketed: bool, group=None) -> Optional[Hierarchy]:
    """The ``Hierarchy`` of ``parallel.hier_split`` with this worker's
    process groups, or None for the flat schedule (the JAX package's
    ``_hier_or_none``). It reschedules packed buckets, so it needs
    bucketed compression; ``make_hierarchy`` validates the split (a DP
    layout of two stages of two workers or more). ``mesh_shape`` None is
    the pure-DP layout: every worker on the first DP axis."""
    if parallel.hier_split is None:
        return None
    if not bucketed:
        raise ValueError(
            "hier_split reschedules packed buckets, which requires "
            "bucketed compression (e.g. compression='bf16+bucketed', "
            f"got {parallel.compression!r})")
    dp_axes = tuple(parallel.dp_axes)
    if mesh_shape is None:
        mesh_shape = {a: 1 for a in dp_axes}
        mesh_shape[dp_axes[0]] = dist.get_world_size(group)
    hier = make_hierarchy(dp_axes, mesh_shape, parallel.hier_split)
    if group is not None and group is not dist.group.WORLD:
        raise ValueError("a hierarchical schedule splits the default "
                         "worker group: pass group=None")
    return hierarchy_groups(hier)


def _all_reduce(bucket, hier: Optional[Hierarchy], group=None,
                async_op: bool = False):
    """One bucket's all-reduce, in place: flat, or the two-level
    ``hierarchical_psum``."""
    if hier is not None:
        return hierarchical_psum(bucket, hier, async_op=async_op)
    return dist.all_reduce(bucket, group=group, async_op=async_op)


def _reduce_scatter(out, bucket, hier: Optional[Hierarchy], group=None,
                    async_op: bool = False):
    """One bucket's reduce-scatter into ``out`` (ZeRO): flat, or the
    two-level ``hierarchical_psum_scatter``, which hands this worker the
    same chunk."""
    if hier is not None:
        return hierarchical_psum_scatter(out, bucket, hier,
                                         async_op=async_op)
    return dist.reduce_scatter_tensor(out, bucket, group=group,
                                      async_op=async_op)


def _stream_checks(parallel, optimizer, bucketed: bool) -> None:
    """Validate a packed-stream step without ZeRO (stream-LARS)."""
    if not bucketed:
        raise ValueError(
            "the packed-stream optimizer updates a contiguous stream, "
            "which requires bucketed compression (e.g. "
            "compression='bf16+bucketed', got "
            f"{parallel.compression!r})")
    if optimizer.kind != "lars":
        raise ValueError(
            "non-zero packed-stream updates exist for kind='lars' only "
            "(rmsprop_warmup uses the replicated tree update unless "
            f"--zero shards it); got kind={optimizer.kind!r}")


def _zero_checks(parallel, optimizer, bucketed: bool, group=None) -> int:
    """Validate a ZeRO step request; returns the worker count."""
    if not bucketed:
        raise ValueError(
            "zero_dp reduce-scatters packed buckets, which requires "
            "bucketed compression (e.g. compression='bf16+bucketed', "
            f"got {parallel.compression!r})")
    if not hasattr(optimizer, "update_shard"):
        raise ValueError(
            "zero_dp needs a packed-stream optimizer "
            "(optim/stream.py:make_stream_optimizer), got "
            f"{type(optimizer).__name__}")
    n = dist.get_world_size(group)
    if n < 2:
        raise ValueError(f"zero_dp needs DP degree >= 2, got {n}")
    return n


def _stream_aux(optimizer, plan: BucketPlan, params, n: int, w: int,
                device, sharded: bool = False) -> Dict[str, torch.Tensor]:
    """The static per-element side inputs of the stream update, built
    once and kept on the device: the weight-decay and segment-id streams
    (whole, for the update; worker ``w``'s slice, for the norms) and the
    per-segment trust mask. ``sharded`` (ZeRO) keeps only worker ``w``'s
    block of each stream's shard layout (its ``local_shard``), as
    ``wd`` and ``seg``: the side inputs of its shard of the update."""
    wd = torch.from_numpy(optimizer.wd_stream(params, plan)).to(device)
    seg = torch.from_numpy(segment_ids_stream(plan)).to(device)
    mask = torch.from_numpy(trust_mask_segments(params, plan)).to(device)
    wd_loc, seg_loc = (local_shard(wd, plan, n, w),
                       local_shard(seg, plan, n, w))
    if sharded:
        return {"wd": wd_loc.clone(), "seg": seg_loc.clone(),
                "trust_mask": mask}
    return {"wd": wd, "seg": seg, "wd_loc": wd_loc, "seg_loc": seg_loc,
            "trust_mask": mask}


def _cast_divide_stream(stream: torch.Tensor, plan: BucketPlan, n: int
                        ) -> torch.Tensor:
    """The synced wire stream cast back to f32 and divided by the worker
    count, with ``unpack``'s ops."""
    dtypes = {s.dtype for s in plan.slots}
    if dtypes != {torch.float32}:
        raise ValueError(
            "packed-stream updates need a uniform fp32 param tree; got "
            f"leaf dtypes {sorted(str(d) for d in dtypes)}")
    if stream.dtype != torch.float32:
        stream = unpack_cast(stream.contiguous(), torch.float32)
    return stream / n


def _stream_full_update(optimizer, plan: BucketPlan, params, g_stream, opt,
                        n: int, w: int, aux, group=None):
    """The replicated LARS update over the full synced stream, every
    worker alike, with the trust norms reduced on this worker's 1/N
    slice only (the chunks a ZeRO reduce-scatter would hand it) and the
    (2, L + 1) partials summed with one all-reduce: the JAX package's
    program, which ZeRO will share. The parameters are packed into one
    f32 stream, updated in place and copied back into the leaves.
    Returns ``(opt_metrics, local squared gradient norm)``."""
    pad = [params[plan.names[0]].new_zeros(plan.pad_elems)] \
        if plan.pad_elems else []
    p_stream = torch.cat([params[k].reshape(-1) for k in plan.names] + pad)
    g_loc = local_shard(g_stream, plan, n, w)
    local_sq = g_loc.square().sum()
    partials = optimizer.segment_partials(
        local_shard(p_stream, plan, n, w), g_loc, aux["wd_loc"],
        aux["seg_loc"], len(plan.slots) + 1)
    dist.all_reduce(partials, group=group)
    trust = optimizer.trust_ratios(partials, aux["trust_mask"])
    _, _, opt_metrics = optimizer.update_shard(
        p_stream, g_stream, opt["delta"], opt["step"], aux["wd"],
        aux["seg"], trust)
    opt["step"] += 1
    for k, s in zip(plan.names, plan.slots):
        params[k].copy_(p_stream[s.offset:s.offset + s.size].view(s.shape))
    return opt_metrics, local_sq


def _stream_synced_update(optimizer, plan: BucketPlan, params, buckets,
                          opt, n: int, w: int, aux, metrics: Dict,
                          group=None) -> Dict:
    """The stream update from the all-reduced wire buckets (in plan
    order), and the step's metrics: averaged over the workers, with the
    global gradient norm and the optimizer's."""
    g_stream = _cast_divide_stream(
        buckets[0] if len(buckets) == 1 else torch.cat(buckets), plan, n)
    opt_metrics, local_sq = _stream_full_update(
        optimizer, plan, params, g_stream, opt, n, w, aux, group)
    metrics["grad_sq_local"] = local_sq
    metrics = _zero_grad_norm(_pmean_metrics(metrics, group), n)
    metrics.update(opt_metrics)
    return metrics


def _param_shard(params, plan: BucketPlan, n: int, w: int) -> torch.Tensor:
    """Worker ``w``'s shard of the f32 parameter stream of ``plan`` (its
    chunk of every bucket, in bucket order; the pad as zeros), copied
    from the leaves that overlap it."""
    parts = []
    for b, c in enumerate(shard_chunks(plan, n)):
        lo = plan.bucket_bounds(b)[0] + w * c
        hi = lo + c
        for k, s in zip(plan.names, plan.slots):
            a, z = max(lo, s.offset), min(hi, s.offset + s.size)
            if a < z:
                parts.append(params[k].reshape(-1)[a - s.offset:z - s.offset])
        if hi > plan.total_elems:
            parts.append(params[plan.names[0]].new_zeros(
                hi - max(lo, plan.total_elems)))
    return torch.cat(parts)


def _zero_sharded_update(optimizer, plan: BucketPlan, params, g_shard, opt,
                         n: int, w: int, aux, group=None,
                         hier: Optional[Hierarchy] = None):
    """The worker-local half of the ZeRO step: update this worker's
    shard of the f32 parameter stream against its shard of the optimizer
    state (``g_shard`` already cast and divided), all-gather the updated
    slices bucket by bucket (``hierarchical_all_gather`` under a
    hierarchy: the same bits), and copy them back into the parameters,
    in place. LARS's trust norms are the shard's per-segment partials
    summed with one all-reduce (a leaf may span shards). Returns
    ``(opt_metrics, local squared gradient norm)``."""
    local_sq = g_shard.square().sum()
    p_shard = _param_shard(params, plan, n, w)
    if optimizer.kind == "lars":
        partials = optimizer.segment_partials(
            p_shard, g_shard, aux["wd"], aux["seg"], len(plan.slots) + 1)
        dist.all_reduce(partials, group=group)
        trust = optimizer.trust_ratios(partials, aux["trust_mask"])
        _, _, opt_metrics = optimizer.update_shard(
            p_shard, g_shard, opt["delta"], opt["step"], aux["wd"],
            aux["seg"], trust)
    else:
        _, _, _, opt_metrics = optimizer.update_shard(
            p_shard, g_shard, opt["delta"], opt["m"], opt["step"],
            aux["wd"])
    opt["step"] += 1
    full = p_shard.new_empty(plan.padded_total)
    for b, piece in enumerate(split_shard(p_shard, plan, n)):
        lo, hi = plan.bucket_bounds(b)
        if hier is not None:
            hierarchical_all_gather(full[lo:hi], piece, hier)
        else:
            dist.all_gather_into_tensor(full[lo:hi], piece, group=group)
    torch._foreach_copy_(
        [params[k] for k in plan.names],
        [full[s.offset:s.offset + s.size].view(s.shape) for s in plan.slots])
    return opt_metrics, local_sq


def _zero_synced_update(optimizer, plan: BucketPlan, params, shards, opt,
                        n: int, w: int, aux, metrics: Dict,
                        group=None, hier: Optional[Hierarchy] = None
                        ) -> Dict:
    """The ZeRO update from this worker's reduce-scattered wire chunks
    (in bucket order), and the step's metrics: averaged over the
    workers, with the global gradient norm and the optimizer's."""
    g_shard = _cast_divide_stream(
        shards[0] if len(shards) == 1 else torch.cat(shards), plan, n)
    opt_metrics, local_sq = _zero_sharded_update(
        optimizer, plan, params, g_shard, opt, n, w, aux, group, hier)
    metrics["grad_sq_local"] = local_sq
    metrics = _zero_grad_norm(_pmean_metrics(metrics, group), n)
    metrics.update(opt_metrics)
    return metrics


def _zero_grad_norm(metrics: Dict, n: int) -> Dict:
    """The global gradient norm from the averaged per-worker partial sums
    (exact when n is a power of two)."""
    metrics["grad_norm"] = torch.sqrt(metrics.pop("grad_sq_local") * n)
    return metrics


def _make_dp_stream_train_step(model, optimizer, train_cfg: TrainConfig,
                               wire, bucketed: bool, group=None,
                               input_transform=None,
                               hier: Optional[Hierarchy] = None):
    """The bucketed DP step with a packed-stream optimizer (stream-LARS):
    pack -> one all-reduce per bucket -> the replicated update over the
    full f32 stream, trust norms reduced worker by worker
    (``_stream_full_update``). Error feedback stays with the worker and
    runs on the leaves before packing, as in ``bucketed_psum_ef``. The
    plan (``align`` = the worker count, so every worker's norm slice is
    the one ZeRO would give it) and the side streams are built at the
    first step and kept."""
    parallel = train_cfg.parallel
    use_ef = parallel.error_feedback
    _stream_checks(parallel, optimizer, bucketed)
    n, w = dist.get_world_size(group), dist.get_rank(group)
    device = model.device
    plan: Optional[BucketPlan] = None
    aux: Dict[str, torch.Tensor] = {}

    def train_step(state: Tree, batch: Tree):
        nonlocal plan, aux
        batch = to_device(batch, device)
        if input_transform is not None:
            batch = input_transform(batch)
        params = state["params"]
        new_mstate, metrics, grads = _grads_of(
            model, train_cfg, params, state["model_state"], batch)
        if use_ef:
            quant, new_residual = apply_error_feedback(
                grads, state["ef_residual"], wire)
        else:
            quant = grads
        if plan is None:
            plan = plan_buckets(quant, parallel.bucket_bytes, wire, align=n)
            aux = _stream_aux(optimizer, plan, params, n, w, device)
        buckets = pack(quant, plan)
        for b in buckets:
            _all_reduce(b, hier, group)
        metrics = _stream_synced_update(optimizer, plan, params, buckets,
                                        state["opt"], n, w, aux, metrics,
                                        group)
        new_state = {"params": params, "opt": state["opt"],
                     "model_state": new_mstate}
        if use_ef:
            new_state["ef_residual"] = new_residual
        return new_state, metrics

    return train_step


def _make_dp_zero_train_step(model, optimizer, train_cfg: TrainConfig,
                             wire, bucketed: bool, group=None,
                             input_transform=None,
                             hier: Optional[Hierarchy] = None):
    """ZeRO on the bucketed DP step (the JAX package's DESIGN.md §9):
    pack -> one reduce-scatter per bucket -> the update of this worker's
    shard of the stream (``_zero_sharded_update``) -> one all-gather of
    the updated parameter slices per bucket. The optimizer state holds
    this worker's shard only. Error feedback stays with the worker and
    runs on its whole gradient tree before packing, as in
    ``bucketed_psum_ef``, so the residuals, and everything after them,
    are bitwise those of the all-reduce path. The plan (``align`` = the
    worker count) and the side streams are built at the first step.
    gloo takes CUDA tensors for both collectives, and its reduce-scatter
    gives each worker the bits of its slice of the all-reduce (checked
    with two processes on one H100, torch 2.11, bf16 / f16 / f32).
    Under a hierarchy both collectives are the two-level ones, and the
    shard a worker owns is the same."""
    parallel = train_cfg.parallel
    use_ef = parallel.error_feedback
    n = _zero_checks(parallel, optimizer, bucketed, group)
    w = dist.get_rank(group)
    device = model.device
    plan: Optional[BucketPlan] = None
    aux: Dict[str, torch.Tensor] = {}

    def train_step(state: Tree, batch: Tree):
        nonlocal plan, aux
        batch = to_device(batch, device)
        if input_transform is not None:
            batch = input_transform(batch)
        params = state["params"]
        new_mstate, metrics, grads = _grads_of(
            model, train_cfg, params, state["model_state"], batch)
        if use_ef:
            quant, new_residual = apply_error_feedback(
                grads, state["ef_residual"], wire)
        else:
            quant = grads
        if plan is None:
            plan = plan_buckets(quant, parallel.bucket_bytes, wire, align=n)
            aux = _stream_aux(optimizer, plan, params, n, w, device,
                              sharded=True)
        shards = []
        for b in pack(quant, plan):
            shards.append(b.new_empty(b.numel() // n))
            _reduce_scatter(shards[-1], b, hier, group)
        metrics = _zero_synced_update(optimizer, plan, params, shards,
                                      state["opt"], n, w, aux, metrics,
                                      group, hier)
        new_state = {"params": params, "opt": state["opt"],
                     "model_state": new_mstate}
        if use_ef:
            new_state["ef_residual"] = new_residual
        return new_state, metrics

    return train_step


def zero_stream_plan(model, params, train_cfg: TrainConfig, n: int
                     ) -> BucketPlan:
    """The stream plan a ZeRO step of ``n`` workers builds for ``params``
    (the ready-order plan's base under ``overlap_comm``): the layout of
    its sharded optimizer state, which checkpoints are converted
    through (``interop.WorkerSharding.zero_plan``)."""
    parallel = train_cfg.parallel
    wire, _ = parse_compression(parallel.compression)
    shapes = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
              for k, v in params.items()}
    if parallel.overlap_comm:
        return plan_ready_buckets(_ready_stages(model, shapes),
                                  parallel.bucket_bytes, wire, n).base
    return plan_buckets(shapes, parallel.bucket_bytes, wire, align=n)


# ---------------------------------------------------------------------------
# the backward-overlapped step
# ---------------------------------------------------------------------------


def make_dp_overlap_train_step(model, optimizer: Optimizer,
                               train_cfg: TrainConfig, group=None,
                               input_transform=None,
                               mesh_shape: Optional[Dict[str, int]] = None):
    """The bucketed DP step with the gradient all-reduces overlapped with
    the backward pass; its state after a step is bitwise that of
    ``make_dp_shardmap_train_step``'s bucketed step (plain, with error
    feedback, or stream-LARS).

    The model's loss runs as K chained segments (``loss_segments``,
    ``models/common.py:staged_forward``) and their backwards run last
    segment first. The gradient stream is laid out in that order
    (``plan_ready_buckets``), so a bucket is complete as soon as the
    segment holding its last element is done: each such bucket is cast
    to the wire dtype (``pack_bucket``, one ``cast_copy`` a segment) and
    all-reduced with ``async_op=True`` right after that segment's
    backward, and waited for two segments later, so at most two
    segments' collectives are in flight (the JAX package's
    ``optimization_barrier`` pipeline). Error feedback runs per segment
    before packing. The update is the optimizer's on the unpacked
    stream, or, for a packed-stream optimizer (stream-LARS), the
    bucketed step's stream update, on the synced stream put back in
    that step's leaf order (``reorder_stream``): its trust norms are
    summed in the same order, and ``delta`` keeps the bucketed layout
    (the JAX package keeps it in ready order, ``overlap_stream_order``,
    which its checkpoints carry).

    With ``zero_dp`` each ready bucket is reduce-scattered instead
    (``async_op=True``, in the same pipeline), and the update is
    ``_make_dp_zero_train_step``'s on this worker's shard of the
    ready-order stream, as the JAX package's is. A ZeRO worker holds only
    its shard, so stream-LARS cannot be put back in leaf order there: its
    trust norms are summed over ready-order shards, and it agrees with
    the overlapped stream-LARS step to rounding, not bitwise. The
    elementwise updates (rmsprop_warmup, momentum_sgd) stay bitwise.

    Under a hierarchy (``mesh_shape``, ``parallel.hier_split``) every
    plan is shard-aligned and each ready bucket launches its two-level
    collective at the same point: only the first stage (the inner
    reduce-scatter) runs asynchronously, behind the next segment's
    backward; the pipeline's wait, two segments later, runs the rest
    (``bucketing.ChainedWork``). The numbers are the bucketed step's."""
    parallel = train_cfg.parallel
    wire, bucketed = parse_compression(parallel.compression)
    use_ef = parallel.error_feedback
    if use_ef and wire is None:
        raise ValueError("error_feedback requires a wire dtype "
                         f"(compression={parallel.compression!r})")
    if not hasattr(model, "loss_segments"):
        raise ValueError(
            f"{type(model).__name__} has no loss_segments(); overlap_comm "
            "needs a staged model (ResNet50)")
    hier = _hier_or_none(parallel, mesh_shape, bucketed, group)
    use_zero = parallel.zero_dp
    use_stream = hasattr(optimizer, "update_shard")
    if use_zero:
        _zero_checks(parallel, optimizer, bucketed, group)
    elif use_stream:
        _stream_checks(parallel, optimizer, bucketed)
    n, w = dist.get_world_size(group), dist.get_rank(group)
    device = model.device
    plan: Optional[ReadyBucketPlan] = None
    stream_plan: Optional[BucketPlan] = None  # stream-LARS, leaf order
    aux: Dict[str, torch.Tensor] = {}

    def train_step(state: Tree, batch: Tree):
        nonlocal plan, stream_plan, aux
        batch = to_device(batch, device)
        if input_transform is not None:
            batch = input_transform(batch)
        params = state["params"]
        pc = {k: v.detach().to(model.compute_dtype).requires_grad_(True)
              for k, v in params.items()}
        staged = model.loss_segments(pc, state["model_state"], batch,
                                     train_cfg.label_smoothing)
        loss, vjps, auxes = staged_forward(staged)
        if plan is None:
            # the f32 gradients' layout, segments in backward order (the
            # stream-LARS plan shard-aligned as the bucketed step's)
            shapes = {k: torch.empty(v.shape, dtype=torch.float32,
                                     device="meta")
                      for k, v in params.items()}
            align = n if use_stream or hier is not None else 1
            plan = plan_ready_buckets(_ready_stages(model, shapes),
                                      parallel.bucket_bytes, wire, align)
            if use_zero:
                aux = _stream_aux(optimizer, plan.base, params, n, w, device,
                                  sharded=True)
            elif use_stream:
                stream_plan = plan_buckets(shapes, parallel.bucket_bytes,
                                           wire, align)
                aux = _stream_aux(optimizer, stream_plan, params, n, w,
                                  device)
        res_rev = (_ready_stages(model, state["ef_residual"]) if use_ef
                   else None)
        ct = torch.ones_like(loss)
        synced: Dict[int, torch.Tensor] = {}
        sent: Dict[int, torch.Tensor] = {}  # a reduce-scatter's input
        works: Dict[int, Any] = {}
        pending = []  # bucket ids launched after each segment, oldest first
        carry = None
        new_residual: Dict[str, torch.Tensor] = {}
        for ridx, i in enumerate(reversed(range(len(vjps)))):
            if len(pending) >= 2:
                for b in pending.pop(0):
                    works.pop(b).wait()
                    sent.pop(b, None)
            g_seg, ct = vjps[i](ct)
            g_seg = {k: g.float() for k, g in g_seg.items()}
            if use_ef:
                g_seg, r_new = apply_error_feedback(g_seg, res_rev[ridx],
                                                    wire)
                new_residual.update(r_new)
            ready, carry = pack_bucket(plan, ridx, g_seg, carry)
            for b, arr in ready:
                # the bucket stays referenced here until its wait
                if use_zero:
                    sent[b] = arr
                    synced[b] = arr.new_empty(arr.numel() // n)
                    works[b] = _reduce_scatter(synced[b], arr, hier, group,
                                               async_op=True)
                else:
                    synced[b] = arr
                    works[b] = _all_reduce(arr, hier, group, async_op=True)
            pending.append([b for b, _ in ready])
        for ids in pending:
            for b in ids:
                works.pop(b).wait()
                sent.pop(b, None)
        assert len(synced) == plan.n_buckets, (len(synced), plan.n_buckets)
        new_mstate, metrics = staged.finalize_aux(auxes)
        buckets = [synced[b] for b in range(plan.n_buckets)]
        if use_zero:
            # this worker's shard of the ready-order stream, updated as
            # the JAX package's zero-overlap step updates it
            metrics = _zero_synced_update(
                optimizer, plan.base, params, buckets, state["opt"], n, w,
                aux, metrics, group, hier)
            new_params, new_opt = params, state["opt"]
        elif use_stream:
            # back in the bucketed step's leaf order, the update, its
            # trust norms and ``delta`` are that step's, bit for bit
            g_wire = reorder_stream(torch.cat(buckets), plan.base,
                                    stream_plan)
            metrics = _stream_synced_update(
                optimizer, stream_plan, params, [g_wire], state["opt"], n,
                w, aux, metrics, group)
            new_params, new_opt = params, state["opt"]
        else:
            grads, sq_norm = unpack(buckets, plan.base, denom=n,
                                    with_sq_norm=True)
            new_params, new_opt, metrics = _synced_update(
                optimizer, params, {k: grads[k] for k in params},
                state["opt"], metrics, sq_norm, group)
        new_state = {"params": new_params, "opt": new_opt,
                     "model_state": new_mstate}
        if use_ef:
            new_state["ef_residual"] = {k: new_residual[k] for k in params}
        return new_state, metrics

    return train_step


def _ready_stages(model, tree: Dict) -> List[Dict]:
    """A parameter-shaped dict cut into the staged loss's segments, in
    the order their backwards run: last segment first."""
    return list(reversed(model.segment_trees(tree)))


def overlap_stream_order(model, params: Dict) -> Tuple[str, ...]:
    """The leaf order of the overlapped step's wire stream
    (``plan_ready_buckets`` of ``_ready_stages``), which is also the
    layout of the JAX package's stream-LARS ``delta`` under
    ``overlap_comm`` (``interop.WorkerSharding.stream_order``)."""
    return tuple(k for t in _ready_stages(model, params)
                 for k in leaf_order(t))


def finalize_worker_bn_stats(model_state, group=None):
    """Paper §2: the all-reduce of every worker's last-minibatch BN
    statistics before validation, moment-correct (see
    ``core.batchnorm.finalize_bn_stats``)."""
    return finalize_bn_stats(model_state, group)


def make_prefill_step(model):
    """``prefill_step(params, cache, batch) -> (last logits, cache)``;
    ``batch["tokens"]`` is the (B, S) prompt."""
    def prefill_step(params, cache, batch):
        kw = {k: batch[k] for k in ("frames", "patches") if k in batch}
        return model.prefill(params, batch["tokens"], cache, **kw)

    return prefill_step


def make_decode_step(model):
    """``decode_step(params, cache, batch) -> (logits, cache)``;
    ``batch`` holds the (B, 1) ``tokens`` and their ``cache_index``."""
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"],
                                 batch["cache_index"])

    return decode_step
