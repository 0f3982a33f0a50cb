"""The fused hybrid RMSprop-warm-up update (paper A.1) of one parameter
leaf, ported from the Pallas kernels of the JAX package
(``repro/kernels/fused_update.py`` ``_kernel`` and ``_kernel_wd``) to
``csrc/fused_update.cu`` ``hybrid_update``.

``fused_hybrid_update`` updates the parameter, ``delta`` and ``m``
**in place** (the Pallas kernel writes new arrays; in place saves a
second copy of the parameters and the optimizer state) and returns
them. Weight decay is a scalar or a per-element stream shaped like the
leaf (the kernel's optional ``wd`` pointer). On CPU tensors it runs the
plain version, ``core.optimizer.hybrid_update``; on CUDA tensors it
launches the kernel, which rounds every operation in the same order and
so is bitwise equal to it.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.optimizer import HybridHyper, alpha_rmsprop, hybrid_update
from repro_torch.kernels._launch import F32, I64, P, Library, on_cpu, stream

Tensor = torch.Tensor

_LIB = Library("fused_update", {
    "hybrid_update": [P, P, P, P, P, I64, F32, F32, F32, F32, F32, F32, F32,
                      F32, P],
})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset


def _hybrid_update_plain(g, p, d, m, h: HybridHyper,
                         weight_decay: Union[float, Tensor] = 0.0):
    p2, d2, m2 = hybrid_update(g, p, d, m, h, weight_decay)
    p.copy_(p2)
    d.copy_(d2)
    m.copy_(m2)
    return p, d, m


PLAIN = {"hybrid_update": _hybrid_update_plain}


def _f32(v) -> float:
    return float(np.float32(v))


def fused_hybrid_update(g: Tensor, p: Tensor, d: Tensor, m: Tensor,
                        h: HybridHyper,
                        weight_decay: Union[float, Tensor] = 0.0
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """One leaf of the hybrid update, **in place** over ``p``, ``d`` and
    ``m`` (all float32, contiguous, the same shape as ``g``); returns
    ``(p, d, m)``."""
    wd_t = weight_decay if torch.is_tensor(weight_decay) else None
    with torch.no_grad():
        if on_cpu("fused update", g, p, d, m, wd_t):
            return _hybrid_update_plain(g, p, d, m, h, weight_decay)
        for name, t in (("g", g), ("p", p), ("delta", d), ("m", m),
                        ("weight_decay", wd_t)):
            if t is None:
                continue
            if t.dtype != torch.float32 or t.shape != p.shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"fused update: {name} must be contiguous float32 of "
                    f"shape {tuple(p.shape)}, got {t.dtype} "
                    f"{tuple(t.shape)}")
        _LIB.launch(
            "hybrid_update", g.data_ptr(), p.data_ptr(), d.data_ptr(),
            m.data_ptr(), None if wd_t is None else wd_t.data_ptr(),
            p.numel(), _f32(h.eta), _f32(h.alpha_sgd), alpha_rmsprop(h),
            _f32(h.mu1), _f32(h.mu2), _f32(1.0 - h.mu2), _f32(h.eps),
            0.0 if wd_t is not None else _f32(weight_decay), stream())
    return p, d, m
