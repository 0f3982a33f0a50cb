"""Paper schedules (Appendix A): ELU-shaped RMSprop->SGD transition,
slow-start LR, linear scaling; plus the Goyal et al. and poly baselines.

Every function takes a float ``epoch`` (or a 0-d tensor) and returns a
0-d float32 CPU tensor, computed op for op as the JAX package does, so
the values agree bitwise wherever both sides round the same primitive
the same way (``exp`` and ``sigmoid`` may differ in the last bit).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32)


def _where(cond, a, b) -> torch.Tensor:
    return torch.where(cond, _f32(a), _f32(b))


def alpha_sgd_schedule(epoch, beta_center: float = 10.0,
                       beta_period: float = 5.0,
                       kind: str = "elu") -> torch.Tensor:
    """Paper A.1: exponential rise to 1/2 at beta_center, linear to 1 at
    beta_center + beta_period/2, then 1. ``kind`` also gives the shapes
    the paper rejected (sudden, linear) and sigmoid, for ablations."""
    epoch = _f32(epoch)
    if kind == "elu":
        exp_part = 0.5 * torch.exp(2.0 * (epoch - beta_center) / beta_period)
        lin_part = 0.5 + 2.0 * (epoch - beta_center) / beta_period
        out = torch.where(epoch < beta_center, exp_part, lin_part)
        return torch.minimum(out, _f32(1.0))
    if kind == "sudden":
        return _where(epoch < beta_center, 0.0, 1.0)
    if kind == "linear":
        start = beta_center - beta_period
        return torch.clamp((epoch - start) / (1.5 * beta_period), 0.0, 1.0)
    if kind == "sigmoid":
        return torch.sigmoid(4.0 * (epoch - beta_center) / beta_period)
    raise ValueError(kind)


def linear_scaling_lr(global_batch: int, base_lr_per_256: float = 0.1):
    """Goyal linear-scaling rule: eta_base = 0.1 * B / 256."""
    return base_lr_per_256 * global_batch / 256.0


def slow_start_lr(epoch, eta_base: float) -> torch.Tensor:
    """Paper A.2: 0.5x for 40 epochs, 0.075x for 30, 0.01x for 15,
    0.001x for the last 5."""
    epoch = _f32(epoch)
    return eta_base * torch.where(
        epoch < 40.0, _f32(0.5),
        torch.where(epoch < 70.0, _f32(0.075),
                    _where(epoch < 85.0, 0.01, 0.001)))


def goyal_lr(epoch, eta_base: float, warmup_epochs: float = 5.0,
             base_lr_per_256: float = 0.1) -> torch.Tensor:
    """Goyal et al.: gradual warmup from the single-worker LR to eta_base
    over ``warmup_epochs``, then steps at 30/60/80 epochs."""
    epoch = _f32(epoch)
    start = base_lr_per_256
    frac = torch.clamp(epoch / warmup_epochs, 0.0, 1.0)
    warm = start + (eta_base - start) * frac
    stepped = eta_base * torch.where(
        epoch < 30.0, _f32(1.0),
        torch.where(epoch < 60.0, _f32(0.1),
                    _where(epoch < 80.0, 0.01, 0.001)))
    return torch.where(epoch < warmup_epochs, warm, stepped)


def poly_lr(epoch, eta_base: float, total_epochs: float = 90.0,
            power: float = 2.0, warmup_epochs: float = 5.0,
            base_lr_per_256: float = 0.1) -> torch.Tensor:
    """LARS-recipe schedule: gradual warmup, then
    ``eta_base * (1 - progress)**power`` to zero at ``total_epochs``."""
    epoch = _f32(epoch)
    start = base_lr_per_256
    frac = torch.clamp(epoch / warmup_epochs, 0.0, 1.0)
    warm = start + (eta_base - start) * frac
    span = max(total_epochs - warmup_epochs, 1e-6)
    t = torch.clamp((epoch - warmup_epochs) / span, 0.0, 1.0)
    decayed = eta_base * (1.0 - t) ** power
    return torch.where(epoch < warmup_epochs, warm, decayed)


def make_lr_schedule(kind: str, global_batch: int, *,
                     base_lr_per_256: float = 0.1,
                     warmup_epochs: float = 5.0,
                     total_epochs: float = 90.0,
                     poly_power: float = 2.0):
    eta_base = linear_scaling_lr(global_batch, base_lr_per_256)
    if kind == "slow_start":
        return lambda epoch: slow_start_lr(epoch, eta_base)
    if kind == "goyal":
        return lambda epoch: goyal_lr(epoch, eta_base, warmup_epochs,
                                      base_lr_per_256)
    if kind == "poly":
        return lambda epoch: poly_lr(epoch, eta_base, total_epochs,
                                     poly_power, warmup_epochs,
                                     base_lr_per_256)
    if kind == "constant":
        return lambda epoch: _f32(eta_base)
    raise ValueError(kind)
