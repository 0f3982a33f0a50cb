"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``). On CUDA tensors they launch the hand-written
kernels; on CPU tensors they run each kernel's plain PyTorch version."""
from __future__ import annotations

from repro_torch.kernels.fused_bn import (  # noqa: F401
    fused_bn_apply,
    fused_bn_train,
)
