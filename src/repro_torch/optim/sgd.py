"""Momentum SGD with the Goyal et al. schedule — the paper's baseline
(what the hybrid rule reduces to at alpha_sgd = 1)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.optimizer import HybridHyper, momentum_sgd_update
from repro_torch.core.schedules import make_lr_schedule
from repro_torch.optim.interface import Optimizer, epoch_of, tree_zeros_like
from repro_torch.optim.rmsprop_warmup import decays


def momentum_sgd(cfg: OptimizerConfig, steps_per_epoch: int,
                 global_batch: int, **_) -> Optimizer:
    lr_fn = make_lr_schedule(cfg.schedule, global_batch,
                             base_lr_per_256=cfg.base_lr_per_256,
                             warmup_epochs=cfg.warmup_epochs,
                             total_epochs=cfg.total_epochs,
                             poly_power=cfg.poly_power)

    def init(params):
        return {"step": 0, "delta": tree_zeros_like(params)}

    @torch.no_grad()
    def update(params, grads, state) -> Tuple:
        step = state["step"]
        epoch = epoch_of(step, steps_per_epoch)
        eta = lr_fn(epoch)
        h = HybridHyper(eta=float(eta), alpha_sgd=1.0, mu1=cfg.mu1)
        for k, p in params.items():
            d = state["delta"][k]
            wd = cfg.weight_decay if decays(k) else 0.0
            p2, d2 = momentum_sgd_update(grads[k], p, d, h, wd)
            p.copy_(p2)
            d.copy_(d2)
        state["step"] = step + 1
        return params, state, {"lr": float(eta), "epoch": float(epoch)}

    return Optimizer(init=init, update=update)
