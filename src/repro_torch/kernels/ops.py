"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``). On CUDA tensors they launch the hand-written
kernels; on CPU tensors they run each kernel's plain PyTorch version."""
from __future__ import annotations

from repro_torch.kernels.bucket_ops import (  # noqa: F401
    pack_cast,
    unpack_cast,
)
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
    fused_lars_update,
    fused_segment_sq_partials,
)
