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

The stream forms of ``rmsprop_warmup`` and ``momentum_sgd`` serve ZeRO
(``--zero``, the JAX package's DESIGN.md §9): each worker updates only
its shard of the stream and keeps only that shard of ``delta`` and
``m``. The update is the per-leaf formula applied elementwise; the only
per-leaf input, the decay, rides along as the ``wd`` stream (0.0 on the
no-decay leaves and the pad), so the parameters are bitwise those of the
per-leaf update. With ``use_fused`` the ``rmsprop_warmup`` step is the
``hybrid_update`` kernel with its per-element decay pointer.

The converters at the end carry a checkpoint's optimizer state between
the per-leaf layout of a run without ZeRO and the flat shard layout of a
ZeRO run, so either restores the other's checkpoints
(``checkpoint.restore(transform=make_zero_restore_transform(...))``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import keystr
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.compression import _wire, parse_compression
from repro_torch.core.optimizer import (
    HybridHyper,
    hybrid_update,
    momentum_sgd_update,
)
from repro_torch.core.schedules import alpha_sgd_schedule, make_lr_schedule
from repro_torch.distributed.bucketing import (
    BucketPlan,
    shard_layout_to_stream,
    stream_layout,
    stream_to_shard_layout,
)
from repro_torch.interop import hwio_shape
from repro_torch.kernels.ops import (
    fused_hybrid_update,
    fused_lars_update,
    fused_segment_sq_partials,
)
from repro_torch.kernels.fused_update import PLAIN
from repro_torch.optim.interface import epoch_of
from repro_torch.optim.lars import trust_from_sq
from repro_torch.optim.rmsprop_warmup import decays

Tensor = torch.Tensor
_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

ZERO_STATE_FIELDS = ("delta", "m")


@dataclasses.dataclass(frozen=True)
class StreamOptimizer:
    """The packed-stream twin of ``optim.interface.Optimizer``.

    ``init(elements, device)`` builds the flat state (the whole padded
    stream, or a ZeRO worker's shard of it); ``update_shard`` advances
    one stream slice in place; ``wd_stream`` gives the per-element
    weight decay of a plan; ``state_fields`` names the flat state
    fields (what ZeRO shards and the checkpoint converters carry)."""

    init: Callable[..., Dict[str, Any]]
    # rmsprop_warmup, momentum_sgd:
    #   (p, g, delta, m, step, wd) -> (p', delta', m', metrics)
    # lars: (p, g, delta, step, wd, seg, trust) -> (p', delta', metrics)
    update_shard: Callable
    wd_stream: Callable  # (params, plan) -> np.float32[padded_total]
    kind: str
    state_fields: Tuple[str, ...] = ZERO_STATE_FIELDS
    # (p, g, wd, seg, num_segments) -> (2, num_segments) partial sums
    segment_partials: Optional[Callable] = None
    # ((2, L + 1) totals, bool mask) -> (L + 1,) trust
    trust_ratios: Optional[Callable] = None


def make_stream_optimizer(cfg: OptimizerConfig, steps_per_epoch: int,
                          global_batch: int,
                          use_fused: bool = False) -> StreamOptimizer:
    """The packed-stream optimizer of ``cfg.kind``: ``rmsprop_warmup``
    (with ``use_fused``, through the ``hybrid_update`` kernel),
    ``momentum_sgd`` or ``lars`` (with ``use_fused``, through the two
    stream-LARS kernels)."""
    if cfg.kind == "lars":
        return _make_stream_lars(cfg, steps_per_epoch, global_batch,
                                 use_fused)
    if cfg.kind == "momentum_sgd":
        return _make_stream_momentum_sgd(cfg, steps_per_epoch, global_batch)
    if cfg.kind != "rmsprop_warmup":
        raise ValueError(
            f"the packed stream shards the rmsprop_warmup, momentum_sgd "
            f"and lars updates; got optimizer kind {cfg.kind!r}")
    lr_fn = _lr_schedule(cfg, global_batch)
    state_dtype = _STATE_DTYPES[cfg.state_dtype]

    @torch.no_grad()
    def update_shard(p, g, delta, m, step: int, wd):
        """One hybrid update of a stream slice, in place over ``p``,
        ``delta`` and ``m``. ``wd`` is the per-element decay: 0.0 on the
        no-decay leaves and on the pad, whose g = 0 / m = 0 elements stay
        exactly 0."""
        epoch = epoch_of(step, steps_per_epoch)
        eta = lr_fn(epoch)
        a_sgd = alpha_sgd_schedule(epoch, cfg.beta_center, cfg.beta_period,
                                   kind=cfg.transition)
        h = HybridHyper(eta=float(eta), alpha_sgd=float(a_sgd),
                        mu1=cfg.mu1, mu2=cfg.mu2, eps=cfg.eps,
                        eta_rmsprop=cfg.eta_rmsprop)
        # the kernel takes f32 state: a bf16 state is cast in and out
        d32, m32 = delta.float(), m.float()
        if use_fused:
            fused_hybrid_update(g, p, d32, m32, h, wd)
        else:
            p2, d32, m32 = hybrid_update(g, p, d32, m32, h, wd)
            p.copy_(p2)
        if d32 is not delta:
            delta.copy_(d32)
        if m32 is not m:
            m.copy_(m32)
        return p, delta, m, {"lr": float(eta), "alpha_sgd": float(a_sgd),
                             "epoch": float(epoch)}

    return StreamOptimizer(
        init=_stream_init(state_dtype, ZERO_STATE_FIELDS),
        update_shard=update_shard,
        wd_stream=_wd_stream_fn(cfg), kind=cfg.kind)


def _lr_schedule(cfg: OptimizerConfig, global_batch: int):
    return make_lr_schedule(cfg.schedule, global_batch,
                            base_lr_per_256=cfg.base_lr_per_256,
                            warmup_epochs=cfg.warmup_epochs,
                            total_epochs=cfg.total_epochs,
                            poly_power=cfg.poly_power)


def _stream_init(state_dtype: torch.dtype, fields: Tuple[str, ...]):
    def init(elements: int, device) -> Dict[str, Any]:
        """The zero state of ``elements`` stream elements: a ZeRO
        worker's shard, or the whole padded stream."""
        return {"step": 0, **{f: torch.zeros(elements, dtype=state_dtype,
                                             device=device)
                              for f in fields}}

    return init


def _wd_stream_fn(cfg: OptimizerConfig):
    def wd_stream(params, plan: BucketPlan) -> np.ndarray:
        return decay_wd_stream(params, plan, cfg.weight_decay)

    return wd_stream


def _make_stream_momentum_sgd(cfg: OptimizerConfig, steps_per_epoch: int,
                              global_batch: int) -> StreamOptimizer:
    """Momentum SGD on the stream, so ZeRO runs the Goyal baseline too:
    ``rmsprop_warmup``'s ``update_shard`` signature, with ``m`` riding
    along untouched (zeros) so the ZeRO step's state is the same, and
    the per-leaf ``momentum_sgd_update`` with the decay as a stream.
    Adding ``0.0 * p`` off the decay set leaves a finite value as it was,
    so the parameters are those of the per-leaf update."""
    lr_fn = _lr_schedule(cfg, global_batch)
    state_dtype = _STATE_DTYPES[cfg.state_dtype]

    @torch.no_grad()
    def update_shard(p, g, delta, m, step: int, wd):
        epoch = epoch_of(step, steps_per_epoch)
        eta = lr_fn(epoch)
        h = HybridHyper(eta=float(eta), alpha_sgd=1.0, mu1=cfg.mu1)
        p2, d2 = momentum_sgd_update(g, p, delta.float(), h, wd)
        p.copy_(p2)
        delta.copy_(d2)
        return p, delta, m, {"lr": float(eta), "epoch": float(epoch)}

    return StreamOptimizer(
        init=_stream_init(state_dtype, ZERO_STATE_FIELDS),
        update_shard=update_shard,
        wd_stream=_wd_stream_fn(cfg), kind=cfg.kind)


def _make_stream_lars(cfg: OptimizerConfig, steps_per_epoch: int,
                      global_batch: int, use_fused: bool) -> StreamOptimizer:
    lr_fn = _lr_schedule(cfg, global_batch)
    state_dtype = _STATE_DTYPES[cfg.state_dtype]
    seg_sq = (fused_segment_sq_partials if use_fused
              else PLAIN["seg_sq_partials"])
    step_fn = fused_lars_update if use_fused else PLAIN["lars_update"]

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

    return StreamOptimizer(init=_stream_init(state_dtype, ("delta",)),
                           update_shard=update_shard,
                           wd_stream=_wd_stream_fn(cfg), kind="lars",
                           state_fields=("delta",),
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


# ---------------------------------------------------------------------------
# checkpoints across the ZeRO boundary (per-leaf <-> shard layout)
# ---------------------------------------------------------------------------
#
# A run without ZeRO checkpoints its optimizer state one array per
# parameter leaf ("['opt']['delta']['stem']['conv']", ...); a ZeRO run one
# flat shard-layout array per field ("['opt']['delta']"). The converters
# rewrite a loaded checkpoint's flat {key string: array} dict, which is in
# the JAX package's layout (conv leaves HWIO), from either layout into the
# other. ``plan`` is the ZeRO run's stream plan (its leaves in the order
# of the checkpoint's stream; the port's shapes, converted here).


def param_key_tree(params: Mapping[str, Any]) -> Dict[str, str]:
    """Each parameter's key string (``"['stem']['conv']"``): the suffix
    every per-leaf optimizer entry of a checkpoint carries after
    ``"['opt']['<field>']"``."""
    return {name: keystr(tuple(name.split("/"))) for name in params}


def zero_state_to_tree_arrays(arrays: Dict[str, np.ndarray],
                              plan: BucketPlan, key_tree: Mapping[str, str],
                              n_shards: int,
                              fields: Tuple[str, ...] = ZERO_STATE_FIELDS
                              ) -> Dict[str, np.ndarray]:
    """A ZeRO checkpoint's flat shard-layout optimizer fields rewritten as
    per-leaf arrays (the schema of a checkpoint without ZeRO)."""
    out = dict(arrays)
    for f in fields:
        flat_key = f"['opt']['{f}']"
        if flat_key not in out:
            raise KeyError(f"checkpoint has no shard-layout field "
                           f"{flat_key!r}; is it a ZeRO checkpoint?")
        stream = shard_layout_to_stream(np.asarray(out.pop(flat_key)), plan,
                                        n_shards)
        for name, slot in zip(plan.names, plan.slots):
            out[flat_key + key_tree[name]] = stream[
                slot.offset:slot.offset + slot.size].reshape(
                    hwio_shape(slot.shape))
    return out


def tree_arrays_to_zero_state(arrays: Dict[str, np.ndarray],
                              plan: BucketPlan, key_tree: Mapping[str, str],
                              n_shards: int,
                              fields: Tuple[str, ...] = ZERO_STATE_FIELDS
                              ) -> Dict[str, np.ndarray]:
    """A checkpoint's per-leaf optimizer fields rewritten as the flat
    shard-layout arrays a ZeRO run restores (the pad tail zeros, the
    state its elements hold forever)."""
    out = dict(arrays)
    for f in fields:
        flat_key = f"['opt']['{f}']"
        parts = []
        for name in plan.names:
            leaf_key = flat_key + key_tree[name]
            if leaf_key not in out:
                raise KeyError(f"checkpoint missing {leaf_key!r}; is it a "
                               "per-leaf (non-ZeRO) checkpoint?")
            parts.append(np.asarray(out.pop(leaf_key)).reshape(-1))
        stream = np.concatenate(parts)
        if plan.pad_elems:
            stream = np.concatenate(
                [stream, np.zeros((plan.pad_elems,), stream.dtype)])
        out[flat_key] = stream_to_shard_layout(stream, plan, n_shards)
    return out


def make_zero_restore_transform(plan: BucketPlan,
                                key_tree: Mapping[str, str], n_shards: int,
                                to_zero: bool,
                                fields: Tuple[str, ...] = ZERO_STATE_FIELDS):
    """A ``checkpoint.restore(transform=...)`` hook across the ZeRO
    boundary: ``to_zero=True`` rewrites a per-leaf checkpoint for a ZeRO
    target, ``False`` the reverse. ``fields`` are the flat optimizer
    fields: ``("delta", "m")`` for rmsprop_warmup, ``("delta",)`` for
    LARS (``StreamOptimizer.state_fields``)."""
    def transform(arrays, manifest):
        del manifest
        fn = (tree_arrays_to_zero_state if to_zero
              else zero_state_to_tree_arrays)
        return fn(arrays, plan, key_tree, n_shards, fields=fields)

    return transform
