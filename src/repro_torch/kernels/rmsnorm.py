"""RMSNorm with f32 statistics and compute-dtype output, ported from the
Pallas kernel of the JAX package (``repro/kernels/rmsnorm.py``
``_kernel``) to ``csrc/rmsnorm.cu`` ``rmsnorm``.

``rmsnorm(x, scale, eps)`` normalizes each row of x ``(..., d)``
(float32 or bfloat16) by the root mean square of its f32 values and
multiplies by ``scale`` ``(d,)``, in the Pallas kernel's rounding:

    inv = 1 / sqrt(mean(f32(x)^2) + eps)
    y   = T(T(f32(x) * inv) * T(scale))        T = x.dtype

On CPU tensors it runs the plain version, these ops in this order; on
CUDA tensors it launches the kernel, which sums the squares in another
order and so agrees to the last bit of ``inv``.

Known difference from the JAX model's norm sites: ``apply_norm``
(``repro/models/common.py:127-129``) rounds ``inv`` to T *before*
``x * inv``, where the Pallas kernel and this port round ``x * inv``.
In float32 the two are the same ops in the same order; in bfloat16 the
port's norm sites differ from the JAX model's by up to one bf16 ulp.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._launch import F32, I32, I64, P, Library, on_cpu, stream

Tensor = torch.Tensor

_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = Library("rmsnorm", {"rmsnorm": [P, P, P, I32, I64, I32, F32, P]})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset


def _rmsnorm_plain(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    x32 = x.float()
    var = x32.square().sum(-1, keepdim=True) / x.shape[-1]
    inv = 1.0 / torch.sqrt(var + eps)
    return (x32 * inv).to(x.dtype) * scale.to(x.dtype)


PLAIN = {"rmsnorm": _rmsnorm_plain}


def rmsnorm(x: Tensor, scale: Tensor, *, eps: float = 1e-5) -> Tensor:
    """x ``(..., d)`` RMS-normalized over its last dim, times ``scale``
    ``(d,)``; the result has x's shape and dtype."""
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm takes x (..., d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _CODE:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if on_cpu("rmsnorm", x, scale):
        return _rmsnorm_plain(x, scale, eps)
    if not x.is_contiguous():
        raise ValueError("rmsnorm needs a contiguous x")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    # the Pallas wrapper casts the scale to x's dtype; so does this one
    s = scale.to(x.dtype).contiguous()
    _LIB.launch("rmsnorm", x.data_ptr(), s.data_ptr(), out.data_ptr(),
                _CODE[x.dtype], rows, d, float(eps), stream())
    return out
