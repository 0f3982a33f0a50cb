"""Cast-copy of the flat gradient stream to and from the wire dtype of
the bucketed all-reduce, ported from the Pallas kernel of the JAX
package (``repro/kernels/bucket_ops.py`` ``_cast_kernel``) to
``csrc/bucket_ops.cu`` ``cast_copy``.

``pack_cast`` (float32 -> bfloat16 / float16) and ``unpack_cast`` (back
to float32) take a 1-D contiguous stream of any length; the kernel
masks the tail, so nothing is padded. On CPU tensors they run the plain
version, ``Tensor.to``; on CUDA tensors they launch the kernel, which
rounds to nearest even as ``Tensor.to`` does and is bitwise equal to it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._launch import I32, I64, P, Library, on_cpu, stream

Tensor = torch.Tensor

_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = Library("bucket_ops", {"cast_copy": [P, I32, P, I32, I64, P]})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset


def _cast_copy_plain(flat: Tensor, dtype: torch.dtype) -> Tensor:
    return flat.to(dtype)


PLAIN = {"cast_copy": _cast_copy_plain}


def cast_copy(flat: Tensor, dtype: torch.dtype) -> Tensor:
    """A new 1-D tensor holding ``flat`` cast to ``dtype``: float32 to a
    half-precision wire dtype, or back."""
    if flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError(f"cast_copy takes a contiguous 1-D stream, got "
                         f"shape {tuple(flat.shape)}")
    pair = (flat.dtype, dtype)
    if torch.float32 not in pair or pair[0] == pair[1] \
            or not set(pair) <= set(_CODE):
        raise TypeError(f"cast_copy casts float32 to bfloat16/float16 "
                        f"and back, not {flat.dtype} -> {dtype}")
    if on_cpu("cast_copy", flat):
        return _cast_copy_plain(flat, dtype)
    out = torch.empty(flat.shape, dtype=dtype, device=flat.device)
    if flat.numel():
        _LIB.launch("cast_copy", flat.data_ptr(), _CODE[flat.dtype],
                    out.data_ptr(), _CODE[dtype], flat.numel(), stream())
    return out


def pack_cast(flat: Tensor, wire_dtype: torch.dtype) -> Tensor:
    """The float32 gradient stream cast to the wire dtype."""
    if flat.dtype != torch.float32:
        raise TypeError(f"pack_cast takes a float32 stream, got "
                        f"{flat.dtype}")
    return cast_copy(flat, wire_dtype)


def unpack_cast(flat: Tensor, acc_dtype: torch.dtype = torch.float32
                ) -> Tensor:
    """The inverse of ``pack_cast``: the wire stream back to float32."""
    if acc_dtype != torch.float32:
        raise TypeError(f"unpack_cast returns float32, not {acc_dtype}")
    return cast_copy(flat, acc_dtype)
