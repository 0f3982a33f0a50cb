"""Half-precision gradient communication (paper §3).

The paper casts gradients to fp16 for the all-reduce. bf16 is the
default wire format (fp32 exponent range, so no loss scaling); fp16 is
available for paper-faithfulness. ``compressed_psum`` is the per-leaf
all-reduce of the data-parallel step. On one device there is no
collective, so the single-device step applies the wire numerics with
``simulate_wire_cast``: every gradient round-trips through the wire
dtype. Error feedback (``apply_error_feedback``, beyond the paper)
carries each worker's rounding residual into its next step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

WIRE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, None: None,
               "none": None}


def _wire(dtype_name: Optional[str]):
    if dtype_name not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {dtype_name}")
    return WIRE_DTYPES[dtype_name]


def parse_compression(spec: Optional[str]) -> Tuple[Optional[str], bool]:
    """Split a ``ParallelConfig.compression`` string into
    ``(wire_dtype_name, bucketed)``: None/"none" -> (None, False);
    "bf16" -> ("bf16", False); "bf16+bucketed" -> ("bf16", True);
    "bucketed" -> (None, True)."""
    if spec is None:
        return None, False
    wire: Optional[str] = None
    bucketed = False
    seen_wire = False
    for part in spec.split("+"):
        if part == "bucketed":
            if bucketed:
                raise ValueError(f"duplicate 'bucketed' in {spec!r}")
            bucketed = True
        elif part in WIRE_DTYPES:
            if seen_wire:
                raise ValueError(
                    f"conflicting wire dtypes in {spec!r}")
            seen_wire = True
            wire = None if part == "none" else part
        else:
            raise ValueError(f"unknown compression spec part {part!r} "
                             f"in {spec!r}")
    return wire, bucketed


def simulate_wire_cast(grads: Dict[str, torch.Tensor],
                       wire: Optional[str] = "bf16"
                       ) -> Dict[str, torch.Tensor]:
    """Round-trip every gradient through the wire dtype, so the numerics
    of compressed communication apply on a single device."""
    wdt = _wire(wire)
    if wdt is None:
        return grads
    return {k: g.to(wdt).to(g.dtype) for k, g in grads.items()}


def compressed_psum(grads: Dict[str, torch.Tensor],
                    wire: Optional[str] = "bf16", mean: bool = True,
                    group=None) -> Dict[str, torch.Tensor]:
    """Paper-faithful compressed all-reduce, one collective per leaf:
    cast each gradient to the wire dtype, sum it over the workers, cast
    it back, and divide by the worker count when ``mean`` (the order of
    the JAX package's ``compressed_psum``, so sums of two workers agree
    bitwise)."""
    wdt = _wire(wire)
    n = dist.get_world_size(group)
    out = {}
    for k, g in grads.items():
        x = g.to(wdt) if wdt is not None else g.clone()
        dist.all_reduce(x, group=group)
        x = x.to(g.dtype)
        out[k] = x / n if mean else x
    return out


# ---------------------------------------------------------------------------
# error feedback (beyond the paper)
# ---------------------------------------------------------------------------


def init_error_feedback(grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def apply_error_feedback(grads: Dict[str, torch.Tensor],
                         residual: Dict[str, torch.Tensor],
                         wire: str = "bf16"):
    """q = Q(g + r);  r' = (g + r) - q.  Returns (quantized, new_residual)
    in the JAX package's order of operations, so bitwise equal to it."""
    wdt = _wire(wire)
    quant, resid = {}, {}
    for k, g in grads.items():
        corrected = g.float() + residual[k]
        q = corrected.to(wdt).float()
        quant[k] = q.to(g.dtype)
        resid[k] = corrected - q
    return quant, resid


def compressed_psum_ef(grads: Dict[str, torch.Tensor],
                       residual: Dict[str, torch.Tensor],
                       wire: str = "bf16", mean: bool = True, group=None):
    """Per-leaf compressed all-reduce with error feedback. The residual
    is worker-local (it sees the local gradient); only the wire-rounded
    value crosses the interconnect, and its cast inside
    ``compressed_psum`` is exact. Returns (synced, new_residual)."""
    quant, new_residual = apply_error_feedback(grads, residual, wire)
    return compressed_psum(quant, wire, mean=mean, group=group), \
        new_residual
