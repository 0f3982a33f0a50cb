"""LARS (You et al.), the per-leaf tree update: the large-batch
alternative of the JAX package's ablations, and the reference of the
packed-stream LARS in ``optim/stream.py``.

Both take their squared norms through the same plain
``segment_sq_partials`` (a leaf here is one segment) and their ratio
through the same ``trust_from_sq``, so a one-worker stream step is
bitwise equal to this one. Bias and BN leaves, the ``NO_DECAY`` set,
take no trust ratio (trust 1), as they take no weight decay. The update
is in place, like every optimizer of the port.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.schedules import make_lr_schedule
from repro_torch.distributed.bucketing import segment_sq_partials
from repro_torch.optim.interface import Optimizer, epoch_of, tree_zeros_like
from repro_torch.optim.rmsprop_warmup import decays


def leaf_sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm of one leaf, as one segment of
    ``segment_sq_partials`` (the stream's per-segment primitive)."""
    flat = x.reshape(-1)
    return segment_sq_partials(
        flat, torch.zeros(flat.shape, dtype=torch.int32,
                          device=flat.device), 1)[0]


def trust_from_sq(p_sq, g_sq, trust_coef: float, apply_trust):
    """You et al.'s layer-wise trust ratio from squared norms, in the JAX
    package's order of operations; 1 where ``apply_trust`` is False
    (bias/BN leaves, the stream's alignment-pad segment) or either norm
    vanishes."""
    p_n = torch.sqrt(p_sq)
    g_n = torch.sqrt(g_sq)
    return torch.where(
        torch.as_tensor(apply_trust, device=p_n.device) & (p_n > 0)
        & (g_n > 0),
        trust_coef * p_n / (g_n + 1e-9), torch.ones_like(p_n))


@contextlib.contextmanager
def tape_trust_ratios():
    """While open, every trust ratio the per-leaf update computes is
    appended (as a float, leaf by leaf in the update's order) to the list
    it yields: a sharded step's whole-leaf ratios can be held against
    one device's."""
    mod, ratios = sys.modules[__name__], []
    plain = mod.trust_from_sq

    def taped(*a):
        t = plain(*a)
        ratios.append(float(t))
        return t

    mod.trust_from_sq = taped
    try:
        yield ratios
    finally:
        mod.trust_from_sq = plain


def lars(cfg: OptimizerConfig, steps_per_epoch: int, global_batch: int,
         **_) -> Optimizer:
    lr_fn = make_lr_schedule(cfg.schedule, global_batch,
                             base_lr_per_256=cfg.base_lr_per_256,
                             warmup_epochs=cfg.warmup_epochs,
                             total_epochs=cfg.total_epochs,
                             poly_power=cfg.poly_power)

    def init(params):
        return {"step": 0, "delta": tree_zeros_like(params)}

    @torch.no_grad()
    def update(params, grads, state, sq_reduce=None) -> Tuple:
        """``sq_reduce`` (the GSPMD step on local shards): maps {leaf:
        its shard's squared norms of p and of the decayed g} to the
        whole leaf's; None: the leaves are whole."""
        step = state["step"]
        epoch = epoch_of(step, steps_per_epoch)
        eta = float(lr_fn(epoch))
        sq = {}
        if sq_reduce is not None:
            for k, p in params.items():
                if decays(k):
                    p32 = p.float()
                    g32 = grads[k].float() + cfg.weight_decay * p32
                    sq[k] = torch.stack([leaf_sq_norm(p32),
                                         leaf_sq_norm(g32)])
            sq = sq_reduce(sq)
        for k, p in params.items():
            g32 = grads[k].float()
            p32 = p.float()
            if decays(k):
                g32 = g32 + cfg.weight_decay * p32
                p_sq, g_sq = (sq[k] if k in sq else
                              (leaf_sq_norm(p32), leaf_sq_norm(g32)))
                trust = trust_from_sq(p_sq, g_sq, cfg.trust_coef, True)
            else:
                trust = 1.0  # bias/BN: plain momentum, as the stream's
                # masked segments
            d_new = cfg.mu1 * state["delta"][k] - trust * g32
            p.copy_(p32 + eta * d_new)
            state["delta"][k].copy_(d_new)
        state["step"] = step + 1
        return params, state, {"lr": eta, "epoch": float(epoch)}

    return Optimizer(init=init, update=update)
