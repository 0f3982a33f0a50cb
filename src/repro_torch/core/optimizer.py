"""The paper's hybrid RMSprop-warm-up update rule (Appendix A.1), as
per-leaf math on tensors. ``optim/`` applies it to every parameter.

    m_t     = mu2 * m_{t-1} + (1 - mu2) * g_t^2
    Delta_t = mu1 * Delta_{t-1} - (a_sgd + a_rms / (sqrt(m_t) + eps)) * g_t
    theta_t = theta_{t-1} + eta * Delta_t

with  a_rms = (1 - a_sgd) * eta_rmsprop / eta_sgd  so that Delta stays
learning-rate independent (Goyal momentum correction, paper A.1).
At a_sgd = 1 this is momentum SGD; at a_sgd = 0 RMSprop with momentum.

The per-step scalars are float32 values held as Python floats; every
tensor op rounds to float32 in the order the JAX package uses.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

F32 = torch.float32


class HybridHyper(NamedTuple):
    """Per-step scalars."""

    eta: float  # eta_SGD(t) from the LR schedule (a float32 value)
    alpha_sgd: float  # transition schedule value in [0, 1] (float32)
    mu1: float = 0.9
    mu2: float = 0.99
    eps: float = 1e-8
    eta_rmsprop: float = 3e-4


def alpha_rmsprop(h: HybridHyper) -> float:
    """Paper A.1 coupling: a_rms = (1 - a_sgd) * eta_rms / eta_sgd, in
    float32 arithmetic."""
    one = np.float32(1.0)
    return float((one - np.float32(h.alpha_sgd))
                 * np.float32(h.eta_rmsprop) / np.float32(h.eta))


def hybrid_update(g, theta, delta, m, h: HybridHyper,
                  weight_decay=0.0) -> Tuple:
    """One leaf update. Returns (theta', delta', m'). fp32 math.
    ``weight_decay`` is a scalar or a per-element tensor shaped like
    the leaf (the packed-stream form)."""
    g = g.to(F32)
    theta32 = theta.to(F32)
    if torch.is_tensor(weight_decay) or weight_decay:
        g = g + weight_decay * theta32  # L2-in-gradient (Goyal baseline)
    m_new = h.mu2 * m + (1.0 - h.mu2) * g.square()
    a_rms = torch.tensor(alpha_rmsprop(h), dtype=F32)
    coef = h.alpha_sgd + torch.div(a_rms, m_new.sqrt() + h.eps)
    delta_new = h.mu1 * delta - coef * g
    theta_new = theta32 + h.eta * delta_new
    return theta_new.to(theta.dtype), delta_new, m_new


def momentum_sgd_update(g, theta, delta, h: HybridHyper,
                        weight_decay=0.0) -> Tuple:
    """Goyal et al. baseline: the a_sgd = 1 special case, no m state.
    ``weight_decay`` is a scalar or a per-element tensor, as in
    ``hybrid_update``."""
    g = g.to(F32)
    theta32 = theta.to(F32)
    if torch.is_tensor(weight_decay) or weight_decay:
        g = g + weight_decay * theta32
    delta_new = h.mu1 * delta - g
    theta_new = theta32 + h.eta * delta_new
    return theta_new.to(theta.dtype), delta_new
