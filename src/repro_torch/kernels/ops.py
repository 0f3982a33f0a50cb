"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``). On CUDA tensors they launch the hand-written
kernels; on CPU tensors they run each kernel's plain PyTorch version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bucket_ops import (  # noqa: F401
    pack_cast,
    unpack_buckets,
    unpack_cast,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_bn import (  # noqa: F401
    fused_bn_apply,
    fused_bn_train,
)
from repro_torch.kernels.fused_input import (  # noqa: F401
    fused_input_eval,
    fused_input_train,
    input_augment_params,
)
from repro_torch.kernels.fused_update import (  # noqa: F401
    fused_hybrid_update,
    fused_hybrid_update_leaves,
    fused_lars_update,
    fused_segment_sq_partials,
)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """Tiled online-softmax attention (GQA-aware); its gradient is the
    plain version's, recomputed."""
    return flash_attention(q, k, v, causal=causal, window=window)
