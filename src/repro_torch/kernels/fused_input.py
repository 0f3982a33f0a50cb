"""The input transform of an image batch in one device pass, ported from
the Pallas kernels of the JAX package (``repro/kernels/fused_input.py``
``_train_kernel`` and ``_eval_kernel``) to ``csrc/fused_input.cu``
``input_train`` and ``input_eval``:

  train: per sample, a horizontal flip when ``p[0] > 0``, then a cyclic
         roll by ``(p[1], p[2])`` rows and columns (``torch.roll`` /
         ``jnp.roll`` semantics), then ``(x - mean) * inv_std`` per
         channel, then a cast to the compute dtype
  eval:  the normalize and the cast only

Images are NHWC float32 pixels. On CPU tensors the wrappers run the
plain versions below; on CUDA tensors they launch the kernels, which
round the subtract and the multiply separately, as the plain versions
do, and so are bitwise equal to them.

The augmentation parameters come from ``input_augment_params``, the
port's own counter-based stream (numpy Philox keyed by ``(seed,
step)``): the JAX package draws them with threefry, which the port does
not reproduce. The table is always drawn at the *global* batch size and
each worker slices its rows, so the host path (``data.pipeline.
AugmentedSource``) and the device path see the same parameters.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels._launch import I32, I64, P, Library, on_cpu, stream

Tensor = torch.Tensor

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = Library("fused_input", {
    "input_train": [P, P, P, P, P, I32, I32, I32, I32, I32, P],
    "input_eval": [P, P, P, P, I64, I32, I32, P],
})
LAUNCHES: Dict[str, int] = _LIB.launches
reset_launch_counts = _LIB.reset

# Philox key words that keep this stream apart from the data's sample
# streams (data/synthetic.py), which key on (seed-mix, sample index)
_AUGMENT_DOMAIN = 0x1A6_3E17


def input_augment_params(seed: int, step: int, total: int, *,
                         max_shift: int = 4) -> np.ndarray:
    """(total, 4) int32 per-sample parameters ``[flip, dy, dx, 0]`` of
    ``step``: flip in {0, 1}, shifts in [-max_shift, max_shift], drawn
    from a numpy Philox stream keyed by ``(seed, step)``. Deterministic
    per (seed, step) on every host; ``total`` is the global batch, and a
    shard takes its rows of the table."""
    rng = np.random.Generator(np.random.Philox(
        key=np.array([(seed << 32) ^ _AUGMENT_DOMAIN, step],
                     dtype=np.uint64)))
    out = np.zeros((total, 4), np.int32)
    out[:, 0] = rng.integers(0, 2, total)
    out[:, 1:3] = rng.integers(-max_shift, max_shift + 1, (total, 2))
    return out


def _check(x: Tensor, mean: Tensor, inv_std: Tensor, out_dtype) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fused input takes contiguous NHWC float32 "
                         f"images, got {x.dtype} {tuple(x.shape)}")
    c = x.shape[-1]
    for name, v in (("mean", mean), ("inv_std", inv_std)):
        if v.dtype != torch.float32 or v.shape != (c,) \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({c},)")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"fused input writes float32, bfloat16 or "
                        f"float16, not {out_dtype}")


def _input_train_plain(x, params, mean, inv_std, out_dtype):
    b, h, w, _ = x.shape
    p = params.long()
    dev = p.device
    rows = (torch.arange(h, device=dev)[None, :] - p[:, 1:2]) % h  # (B, H)
    cols = (torch.arange(w, device=dev)[None, :] - p[:, 2:3]) % w  # (B, W)
    cols = torch.where(p[:, 0:1] > 0, w - 1 - cols, cols)  # flip first
    bi = torch.arange(b, device=dev)[:, None, None]
    src = x[bi, rows[:, :, None], cols[:, None, :]]
    return ((src - mean) * inv_std).to(out_dtype)


def _input_eval_plain(x, mean, inv_std, out_dtype):
    return ((x - mean) * inv_std).to(out_dtype)


PLAIN = {"input_train": _input_train_plain, "input_eval": _input_eval_plain}


def fused_input_train(x: Tensor, params: Tensor, mean: Tensor,
                      inv_std: Tensor, *, out_dtype) -> Tensor:
    """(B, H, W, C) float32 pixels -> flipped, rolled, normalized
    ``out_dtype``; ``params`` is the (B, 4) int32 table of
    ``input_augment_params``, ``mean`` and ``inv_std`` are (C,)."""
    _check(x, mean, inv_std, out_dtype)
    b, h, w, c = x.shape
    if params.shape != (b, 4) or params.dtype != torch.int32:
        raise ValueError(f"params must be ({b}, 4) int32, got "
                         f"{params.dtype} {tuple(params.shape)}")
    if on_cpu("fused input", x, params, mean, inv_std):
        return _input_train_plain(x, params, mean, inv_std, out_dtype)
    params = params.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _LIB.launch("input_train", x.data_ptr(), params.data_ptr(),
                mean.data_ptr(), inv_std.data_ptr(), y.data_ptr(), b, h, w,
                c, _OUT_CODE[out_dtype], stream())
    return y


def fused_input_eval(x: Tensor, mean: Tensor, inv_std: Tensor, *,
                     out_dtype) -> Tensor:
    """The eval variant: normalize and cast only."""
    _check(x, mean, inv_std, out_dtype)
    if on_cpu("fused input", x, mean, inv_std):
        return _input_eval_plain(x, mean, inv_std, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _LIB.launch("input_eval", x.data_ptr(), mean.data_ptr(),
                inv_std.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1],
                _OUT_CODE[out_dtype], stream())
    return y
