"""What both plain references share: the paper's hybrid RMSprop->SGD
update with its schedules, the weight-decay rule, the parameters'
initializers, and the lower-precision stand-in that the control runs.

Written from the paper (arXiv:1711.04325, Appendix A) and frozen against
the port's ``core/optimizer.py``, ``core/schedules.py`` and
``optim/rmsprop_warmup.py``. Departures: the update runs as plain float32
tensor ops per leaf (no fused kernel, no packed stream). The bf16 wire
is in ``reference/train.py``. Imports nothing of the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

# name fragments that take no weight decay, matched by exact equality
# against each "/"-separated fragment of a leaf's name
NO_DECAY = ("scale", "bias", "b_if", "b_gates", "A_log", "dt_bias", "D",
            "conv_b", "bq", "bk", "bv")


def decays(name: str) -> bool:
    return not any(frag in NO_DECAY for frag in name.split("/"))


@dataclass(frozen=True)
class Leaf:
    """One parameter: its name, shape and initializer. ``init`` is
    "normal" (a draw times ``std``), "ones" or "zeros"."""

    name: str
    shape: tuple
    init: str
    std: float = 0.0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def fan_in_leaf(name: str, shape: Sequence[int], fan_in: int,
                gain: float = 1.0) -> Leaf:
    return Leaf(name, tuple(shape), "normal", math.sqrt(gain / fan_in))


# ---------------------------------------------------------------- schedules

def _f32(v) -> np.float32:
    return np.float32(v)


def slow_start_lr(epoch: np.float32, eta_base: float) -> np.float32:
    """Paper A.2: 0.5x the base rate for 40 epochs, 0.075x to 70, 0.01x
    to 85, then 0.001x."""
    frac = (0.5 if epoch < 40.0 else 0.075 if epoch < 70.0
            else 0.01 if epoch < 85.0 else 0.001)
    return _f32(_f32(eta_base) * _f32(frac))


def alpha_sgd(epoch: np.float32, center: float, period: float
              ) -> np.float32:
    """Paper A.1's ELU transition: exponential rise to 1/2 at ``center``,
    linear to 1 at ``center + period / 2``."""
    e = _f32(epoch)
    if e < center:
        out = _f32(0.5) * np.exp(_f32(2.0) * (e - _f32(center))
                                 / _f32(period), dtype=np.float32)
    else:
        out = _f32(0.5) + _f32(2.0) * (e - _f32(center)) / _f32(period)
    return _f32(min(out, _f32(1.0)))


@dataclass
class Hyper:
    eta: float
    alpha: float
    a_rms: float
    mu1: float
    mu2: float
    eps: float


def step_hyper(opt: Dict, step: int, steps_per_epoch: int,
               global_batch: int) -> Hyper:
    """The update's scalars at optimizer step ``step`` (0-based)."""
    if opt["schedule"] != "slow_start" or opt["transition"] != "elu":
        raise ValueError("the reference follows the slow-start schedule "
                         "and the ELU transition")
    epoch = _f32(step) / _f32(steps_per_epoch)
    eta_base = opt["base_lr_per_256"] * global_batch / 256.0
    eta = slow_start_lr(epoch, eta_base)
    a = alpha_sgd(epoch, opt["beta_center"], opt["beta_period"])
    a_rms = _f32((_f32(1.0) - a) * _f32(opt["eta_rmsprop"]) / eta)
    return Hyper(float(eta), float(a), float(a_rms), opt["mu1"],
                 opt["mu2"], opt["eps"])


def hybrid_update(theta: torch.Tensor, delta: torch.Tensor,
                  m: torch.Tensor, g: torch.Tensor, h: Hyper,
                  wd: float) -> None:
    """Paper A.1, in place, float32:
    m = mu2 m + (1 - mu2) g'^2;  Delta = mu1 Delta - (a + a_rms /
    (sqrt(m) + eps)) g';  theta += eta Delta;  with g' = g + wd theta."""
    if wd:
        g = g + wd * theta
    m.mul_(h.mu2).add_((1.0 - h.mu2) * g.square())
    coef = h.alpha + h.a_rms / (m.sqrt() + h.eps)
    delta.mul_(h.mu1).sub_(coef * g)
    theta.add_(h.eta * delta)


# ------------------------------------------------------ the lower precision

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fake_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to an fp8 format under one per-tensor scale, back in
    its own dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    q = (t.float() * scale).to(dtype).float() / scale
    return q.to(t.dtype)


class _FP8Operand(torch.autograd.Function):
    """Forward: the operand in fp8 e4m3. Backward: the incoming gradient
    in fp8 e5m2 (the formats of fp8 training)."""

    @staticmethod
    def forward(ctx, t):
        return _fake_fp8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """The precision of the products: ``fp8`` False is the configuration's
    own (bf16 operands, f32 accumulation); True is the control's, every
    operand of a convolution or matrix product in fp8."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _FP8Operand.apply(t) if self.fp8 else t


def set_reference_math() -> None:
    """Full-precision float32 products (no TF32) wherever the reference
    computes in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
