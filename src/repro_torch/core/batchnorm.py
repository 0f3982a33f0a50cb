"""Batch normalization *without moving averages* (paper §2), unfused.

The model keeps only the last minibatch's statistics as state. This is
the plain path of every BN site; ``kernels/fused_bn.py`` fuses the same
math into the CUDA kernels. In the data-parallel step every worker keeps
the statistics of its own minibatch; before validation they are
all-reduced moment-correctly (``finalize_bn_stats``, paper §2). With a
process group, ``bn_batch_stats`` is cross-replica BN (sync-BN): the
statistics of the workers' concatenated batches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

F32 = torch.float32


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, differentiable: its gradient is the
    sum of the workers' cotangents (the transpose of a psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


def bn_batch_stats(x: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and **centered** variance E[(x - mu)^2] over all but the
    channel (last) axis, fp32 accumulation: the uncentered
    E[x^2] - mu^2 cancels almost every bit for a large-mean activation.

    ``group``: a process group for cross-replica BN. The mean is
    averaged over it first, then each worker's second moment about the
    *global* mean is averaged (the JAX package's two pmeans, in its
    order): the statistics of the concatenated batches."""
    dims = tuple(range(x.dim() - 1))
    x32 = x.to(F32)
    mean = x32.mean(dim=dims)
    if group is not None:
        mean = _pmean(mean, group)
    var = (x32 - mean).square().mean(dim=dims)
    if group is not None:
        var = _pmean(var, group)
    return mean, var


def bn_apply_stats(x: torch.Tensor, mean, var, scale, bias,
                   eps: float = 1e-5) -> torch.Tensor:
    """Normalize in the compute dtype; only the per-channel scale and
    offset are folded in fp32."""
    inv = torch.rsqrt(var + eps) * scale.to(F32)
    off = bias.to(F32) - mean * inv
    return (x * inv.to(x.dtype) + off.to(x.dtype)).to(x.dtype)


State = Dict[str, Dict[str, torch.Tensor]]


def _combine_moments(mean_w, var_w, reduce_mean):
    """Average per-worker (mean, var) pairs moment-correctly: through
    E[x^2] = var + mean^2, so the result is exactly the statistics of
    the concatenated minibatch when every worker saw an equal shard."""
    mean = reduce_mean(mean_w)
    ex2 = reduce_mean(var_w + mean_w.square())
    return mean, torch.clamp_min(ex2 - mean.square(), 0.0)


def combine_worker_bn_stats(state: State) -> State:
    """The pre-validation combine in host form: every leaf carries a
    leading worker dim (the JAX package's shard_map layout); returns the
    global statistics with that dim reduced (``mean`` averaged, ``var``
    through E[x^2], other leaves averaged)."""
    def mean0(x):
        return x.mean(dim=0)

    out = {}
    for site, rec in state.items():
        mean, var = _combine_moments(rec["mean"], rec["var"], mean0)
        out[site] = {k: mean0(v) for k, v in rec.items()}
        out[site].update(mean=mean, var=var)
    return out


def finalize_bn_stats(state: State, group=None) -> State:
    """Paper §2: all-reduce every worker's last-minibatch statistics
    before validation, moment-correctly (as ``combine_worker_bn_stats``),
    in one collective over all sites. Returns new tensors, equal on
    every worker. A model without BN (an LM: no sites) has nothing to
    reduce."""
    sites = list(state)
    if not sites:
        return {}
    n = dist.get_world_size(group)
    parts = []
    for site in sites:
        rec = state[site]
        parts += [rec["mean"].reshape(-1).float(),
                  (rec["var"] + rec["mean"].square()).reshape(-1).float(),
                  rec["count"].reshape(-1).float()]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    flat = flat / n
    out, i = {}, 0
    for site in sites:
        rec = state[site]
        c, shape = rec["mean"].numel(), rec["mean"].shape
        mean = flat[i:i + c].view(shape)
        ex2 = flat[i + c:i + 2 * c].view(shape)
        count = flat[i + 2 * c:i + 2 * c + 1].view(rec["count"].shape)
        i += 2 * c + 1
        out[site] = {"mean": mean,
                     "var": torch.clamp_min(ex2 - mean.square(), 0.0),
                     "count": count}
    return out
