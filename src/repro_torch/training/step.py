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

``make_prefill_step`` and ``make_decode_step`` are the serving steps of
an LM, thin wrappers around the model's ``prefill`` and ``decode_step``
as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

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
    bucketed_psum,
    bucketed_psum_ef,
    local_shard,
    pack,
    plan_buckets,
    segment_ids_stream,
)
from repro_torch.kernels.ops import (
    fused_input_eval,
    fused_input_train,
    input_augment_params,
    unpack_cast,
)
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
                                input_transform=None):
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
    (stream-LARS) takes the packed-stream step. ZeRO, overlap and
    hierarchical schedules are not ported yet (ROADMAP queue 1, items
    11, 10 and 13)."""
    parallel = train_cfg.parallel
    for flag, what, item in (
            (parallel.zero_dp, "ZeRO sync (--zero)", 11),
            (parallel.overlap_comm, "overlapped sync (--overlap-comm)", 10),
            (parallel.hier_split is not None, "hierarchical sync", 13)):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1, item {item})")
    wire, bucketed = parse_compression(parallel.compression)
    use_ef = parallel.error_feedback
    if use_ef and wire is None:
        raise ValueError("error_feedback requires a wire dtype "
                         f"(compression={parallel.compression!r})")
    if hasattr(optimizer, "update_shard"):
        return _make_dp_stream_train_step(model, optimizer, train_cfg, wire,
                                          bucketed, group, input_transform)
    device = model.device
    plan = None

    def sync_grads(grads, residual):
        """One of the four (per-leaf | bucketed) x (plain | EF) sync
        paths: (synced, new residual or None, squared norm or None)."""
        nonlocal plan
        if bucketed and plan is None:
            plan = plan_buckets(grads, parallel.bucket_bytes, wire)
        if use_ef:
            if bucketed:
                return bucketed_psum_ef(grads, residual, wire, plan=plan,
                                        with_sq_norm=True, group=group)
            synced, new_residual = compressed_psum_ef(grads, residual, wire,
                                                      group=group)
            return synced, new_residual, None
        if bucketed:
            synced, sq = bucketed_psum(grads, wire, plan=plan, mean=True,
                                       with_sq_norm=True, group=group)
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
        metrics = _pmean_metrics(metrics, group)
        new_params, new_opt, opt_metrics = optimizer.update(
            params, grads, state["opt"])
        metrics.update(opt_metrics)
        metrics["grad_norm"] = (torch.sqrt(sq_norm) if sq_norm is not None
                                else global_norm(grads))
        new_state = {"params": new_params, "opt": new_opt,
                     "model_state": new_mstate}
        if use_ef:
            new_state["ef_residual"] = new_residual
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# the packed-stream step (stream-LARS)
# ---------------------------------------------------------------------------


def _stream_aux(optimizer, plan: BucketPlan, params, n: int, w: int,
                device) -> Dict[str, torch.Tensor]:
    """The static per-element side inputs of the stream update, built
    once and kept on the device: the weight-decay and segment-id streams
    (whole, for the update; worker ``w``'s slice, for the norms) and the
    per-segment trust mask."""
    wd = torch.from_numpy(optimizer.wd_stream(params, plan)).to(device)
    seg = torch.from_numpy(segment_ids_stream(plan)).to(device)
    return {"wd": wd, "seg": seg,
            "wd_loc": local_shard(wd, plan, n, w),
            "seg_loc": local_shard(seg, plan, n, w),
            "trust_mask": torch.from_numpy(
                trust_mask_segments(params, plan)).to(device)}


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


def _zero_grad_norm(metrics: Dict, n: int) -> Dict:
    """The global gradient norm from the averaged per-worker partial sums
    (exact when n is a power of two)."""
    metrics["grad_norm"] = torch.sqrt(metrics.pop("grad_sq_local") * n)
    return metrics


def _make_dp_stream_train_step(model, optimizer, train_cfg: TrainConfig,
                               wire, bucketed: bool, group=None,
                               input_transform=None):
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
    if not bucketed:
        raise ValueError(
            "the packed-stream optimizer updates a contiguous stream, "
            "which requires bucketed compression (e.g. "
            "compression='bf16+bucketed', got "
            f"{parallel.compression!r})")
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
            dist.all_reduce(b, group=group)
        g_stream = _cast_divide_stream(
            buckets[0] if len(buckets) == 1 else torch.cat(buckets), plan, n)
        opt_metrics, local_sq = _stream_full_update(
            optimizer, plan, params, g_stream, state["opt"], n, w, aux,
            group)
        metrics["grad_sq_local"] = local_sq
        metrics = _zero_grad_norm(_pmean_metrics(metrics, group), n)
        metrics.update(opt_metrics)
        new_state = {"params": params, "opt": state["opt"],
                     "model_state": new_mstate}
        if use_ef:
            new_state["ef_residual"] = new_residual
        return new_state, metrics

    return train_step


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
