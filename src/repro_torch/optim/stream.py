"""Packed-stream optimizers: the update runs on the flat parameter
stream of a ``BucketPlan`` instead of leaf by leaf.

The port has the stream form of LARS (the JAX package's DESIGN.md §11):
the trust ratio needs per-leaf norms, so the update splits in three.
``segment_partials`` reduces whatever slice of the stream this worker
holds to per-segment squared-norm partials ``(2, L + 1)``; the caller
(``training/step.py``) sums them over the workers with one all-reduce;
``trust_ratios`` turns the totals into one trust value per segment; and
``update_shard`` applies the trust-scaled momentum step elementwise. The
optimizer holds no collective, so the same code serves a ZeRO shard or
the full stream. With ``use_fused`` the norms and the step are the
``seg_sq_partials`` and ``lars_update`` kernels.

The stream forms of ``rmsprop_warmup`` and ``momentum_sgd`` serve the
ZeRO path and are not ported yet (ROADMAP queue 1, item 11), nor are the
checkpoint converters between tree and stream state (item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.compression import _wire, parse_compression
from repro_torch.core.schedules import make_lr_schedule
from repro_torch.distributed.bucketing import BucketPlan, stream_layout
from repro_torch.kernels.ops import (
    fused_lars_update,
    fused_segment_sq_partials,
)
from repro_torch.kernels.fused_update import PLAIN
from repro_torch.optim.interface import epoch_of
from repro_torch.optim.lars import trust_from_sq
from repro_torch.optim.rmsprop_warmup import decays

Tensor = torch.Tensor
_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class StreamOptimizer:
    """The packed-stream twin of ``optim.interface.Optimizer``.

    ``init(padded_total, device)`` builds the flat state; ``update_shard``
    advances one stream slice in place; ``wd_stream`` gives the
    per-element weight decay of a plan."""

    init: Callable[..., Dict[str, Any]]
    # lars: (p, g, delta, step, wd, seg, trust) -> (p', delta', metrics)
    update_shard: Callable
    wd_stream: Callable  # (params, plan) -> np.float32[padded_total]
    kind: str
    # (p, g, wd, seg, num_segments) -> (2, num_segments) partial sums
    segment_partials: Optional[Callable] = None
    # ((2, L + 1) totals, bool mask) -> (L + 1,) trust
    trust_ratios: Optional[Callable] = None


def make_stream_optimizer(cfg: OptimizerConfig, steps_per_epoch: int,
                          global_batch: int,
                          use_fused: bool = False) -> StreamOptimizer:
    """The packed-stream optimizer of ``cfg.kind``: ``lars`` (with
    ``use_fused``, through the two stream-LARS kernels)."""
    if cfg.kind in ("rmsprop_warmup", "momentum_sgd"):
        raise NotImplementedError(
            f"the packed-stream {cfg.kind} update serves ZeRO, which is "
            "not ported yet (ROADMAP queue 1, item 11)")
    if cfg.kind != "lars":
        raise ValueError(
            f"the packed stream shards the rmsprop_warmup, momentum_sgd "
            f"and lars updates; got optimizer kind {cfg.kind!r}")
    return _make_stream_lars(cfg, steps_per_epoch, global_batch, use_fused)


def _make_stream_lars(cfg: OptimizerConfig, steps_per_epoch: int,
                      global_batch: int, use_fused: bool) -> StreamOptimizer:
    lr_fn = make_lr_schedule(cfg.schedule, global_batch,
                             base_lr_per_256=cfg.base_lr_per_256,
                             warmup_epochs=cfg.warmup_epochs,
                             total_epochs=cfg.total_epochs,
                             poly_power=cfg.poly_power)
    state_dtype = _STATE_DTYPES[cfg.state_dtype]
    seg_sq = (fused_segment_sq_partials if use_fused
              else PLAIN["seg_sq_partials"])
    step_fn = fused_lars_update if use_fused else PLAIN["lars_update"]

    def init(padded_total: int, device) -> Dict[str, Any]:
        return {"step": 0, "delta": torch.zeros(
            padded_total, dtype=state_dtype, device=device)}

    def trust_ratios(totals: Tensor, trust_mask: Tensor) -> Tensor:
        """(L + 1,) trust from the summed (2, L + 1) totals; 1.0 on the
        masked segments (bias/BN leaves, the alignment pad)."""
        return trust_from_sq(totals[0], totals[1], cfg.trust_coef,
                             trust_mask)

    @torch.no_grad()
    def update_shard(p_loc, g_loc, delta_loc, step: int, wd_loc, seg_loc,
                     trust):
        """One trust-scaled momentum step, in place over ``p_loc`` and
        ``delta_loc``. Pad elements sit in the last segment with wd = 0,
        g = 0 and delta = 0, and stay exactly 0."""
        epoch = epoch_of(step, steps_per_epoch)
        eta = float(lr_fn(epoch))
        d32 = delta_loc.float()
        step_fn(g_loc, p_loc, d32, wd_loc, seg_loc, trust, eta, cfg.mu1)
        if d32 is not delta_loc:
            delta_loc.copy_(d32)
        return p_loc, delta_loc, {"lr": eta, "epoch": float(epoch)}

    def wd_stream(params, plan: BucketPlan) -> np.ndarray:
        return decay_wd_stream(params, plan, cfg.weight_decay)

    return StreamOptimizer(init=init, update_shard=update_shard,
                           wd_stream=wd_stream, kind="lars",
                           segment_partials=seg_sq,
                           trust_ratios=trust_ratios)


def trust_mask_segments(params, plan: BucketPlan) -> np.ndarray:
    """bool[len(slots) + 1]: True where a segment takes the LARS trust
    ratio. The exempt set is the no-decay set (bias/BN leaves); the
    trailing alignment-pad segment is always exempt."""
    assert set(plan.names) == set(params)
    return np.asarray([decays(k) for k in plan.names] + [False], bool)


def decay_wd_stream(params, plan: BucketPlan,
                    weight_decay: float) -> np.ndarray:
    """Per-element weight decay of the packed stream: ``weight_decay``
    on decayed leaves, 0.0 on the no-decay leaves and the pad."""
    assert set(plan.names) == set(params)
    wd = np.zeros((plan.padded_total,), np.float32)
    for name, slot in zip(plan.names, plan.slots):
        if decays(name):
            wd[slot.offset:slot.offset + slot.size] = weight_decay
    return wd


def zero_padded_total(params, compression: str, bucket_bytes: int,
                      n_workers: int) -> int:
    """Length of the flat stream state: every parameter element plus the
    tail that makes each bucket split evenly over ``n_workers``. It
    depends only on these scalars, never on leaf order."""
    wire_name, bucketed = parse_compression(compression)
    if not bucketed:
        raise ValueError(
            "the packed stream is cut into buckets: use a bucketed "
            f"compression spec (got {compression!r}, e.g. "
            "'bf16+bucketed')")
    wdt = _wire(wire_name)
    itemsize = wdt.itemsize if wdt is not None else 4
    total = sum(v.numel() for v in params.values())
    _, _, pad = stream_layout(total, bucket_bytes, itemsize,
                              align=n_workers)
    return total + pad
