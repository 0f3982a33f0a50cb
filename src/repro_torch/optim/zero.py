"""ZeRO-1 optimizer-state sharding for the GSPMD step, as DTensor
placements: the port of the JAX package's ``optim/zero.py``.

Optimizer state mirrors param shapes. Each state leaf is sharded over the
data axes on the first dim that (a) is divisible by the DP degree and
(b) is not already sharded by the param spec. The train step redistributes
the *gradients* to the same placements before the optimizer update
(``zero_constraint``), which turns the gradient all-reduce into a
reduce-scatter (+ a param all-gather after the update). Distinct from
``--zero`` (``zero_dp``), the explicit bucketed reduce-scatter of the
data-parallel step.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

from repro_torch.distributed.sharding import (Spec, mesh_shape, placements,
                                              redistribute)


def zero_spec_for(shape: Tuple[int, ...], param_spec: Spec, mesh,
                  dp_axes: Sequence[str]) -> Spec:
    """The ZeRO-1 spec of a state leaf of ``shape`` whose param has
    ``param_spec`` (mesh axes the param spec uses are not reused)."""
    sizes = mesh_shape(mesh)
    used = set()
    for e in param_spec:
        if e is None:
            continue
        used.update((e,) if isinstance(e, str) else e)
    dp_axes = tuple(a for a in dp_axes if a in sizes and a not in used)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    if dp <= 1 or not shape:
        return tuple(param_spec)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % dp == 0 and dim >= dp:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            return tuple(entries)
    return tuple(param_spec)  # nothing shardable: the param layout


def zero_specs(shapes: Dict[str, Tuple[int, ...]],
               param_specs: Dict[str, Spec], mesh,
               dp_axes: Sequence[str]) -> Dict[str, Spec]:
    """The ZeRO-1 spec of each leaf (delta / m, and the gradients at the
    update)."""
    return {k: zero_spec_for(tuple(shapes[k]), param_specs[k], mesh, dp_axes)
            for k in shapes}


def zero_shardings(params, param_specs: Dict[str, Spec], mesh,
                   dp_axes: Sequence[str]) -> Dict[str, Tuple]:
    """The DTensor placements of ``zero_specs`` on ``mesh``."""
    specs = zero_specs({k: tuple(p.shape) for k, p in params.items()},
                       param_specs, mesh, dp_axes)
    return {k: placements(s, mesh) for k, s in specs.items()}


def zero_constraint(shardings: Dict[str, Tuple]) -> Callable:
    """The step's ``grad_constraint``: each gradient redistributed to its
    ZeRO-1 placements (``sharding.redistribute``: a Partial sum
    all-reduced, then this worker's shard cut)."""
    def constrain_grads(grads):
        return {k: redistribute(g, tuple(shardings[k]))
                for k, g in grads.items()}
    return constrain_grads
