"""Move parameters and BN state between the JAX package and the port.

The JAX package's trees are nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); the port's are flat dicts of
tensors named by the same paths joined with "/"
(``stage1/block0/proj_bn/scale``). Conv weights go from HWIO to OIHW;
the fc weight keeps its ``(C_in, classes)`` layout. ``flat_name`` also
reads the keys of a checkpoint's ``arrays.npz`` (``['params']['fc']['w']``),
so such a file loads directly. The JAX package's data-parallel step keeps
every worker's BN state under a leading worker dim; the port keeps one
state per worker process (``worker_state_from_jax`` /
``stack_worker_states``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.bucketing import leaf_order

_KEY = re.compile(r"\['([^']*)'\]")


def flat_name(key: str) -> str:
    """``"['stage1']['block0']['conv1']"`` -> ``"stage1/block0/conv1"``;
    a "/" path is returned as it is."""
    parts = _KEY.findall(key)
    return "/".join(parts) if parts else key


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        node = out
        *heads, last = name.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def params_from_jax(tree: Mapping, device: DeviceLike = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """JAX ResNet parameters (nested numpy) -> the port's flat tensors."""
    dev = resolve_device(device)
    out = {}
    for name, v in _flatten(tree).items():
        a = np.asarray(v)
        if a.ndim == 4:  # conv: HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(a, order="C")).to(dev)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat parameters -> the JAX package's nested numpy."""
    flat = {}
    for name, t in params.items():
        a = t.detach().cpu().numpy()
        if a.ndim == 4:  # conv: OIHW -> HWIO
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        flat[name] = a
    return _unflatten(flat)


def state_from_jax(state: Mapping, device: DeviceLike = "cuda"
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """BN state ``{site: {"mean", "var", "count"}}`` -> tensors."""
    dev = resolve_device(device)
    return {site: {k: torch.from_numpy(np.array(v)).to(dev)
                   for k, v in rec.items()}
            for site, rec in state.items()}


def state_to_jax(state: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    return {site: {k: v.detach().cpu().numpy() for k, v in rec.items()}
            for site, rec in state.items()}


def worker_state_from_jax(state: Mapping, worker: int,
                          device: DeviceLike = "cuda"
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Worker ``worker``'s BN state out of the JAX package's per-worker
    state (every leaf with a leading worker dim)."""
    return state_from_jax({site: {k: np.asarray(v)[worker]
                                  for k, v in rec.items()}
                           for site, rec in state.items()}, device)


def stack_worker_states(states) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's per-worker BN states (one per rank, in rank order) as
    the JAX package's per-worker state: numpy leaves with a leading
    worker dim."""
    flat = [state_to_jax(s) for s in states]
    return {site: {k: np.stack([f[site][k] for f in flat])
                   for k in flat[0][site]}
            for site in flat[0]}


def load_reference_arrays(arrays: Mapping[str, np.ndarray],
                          device: DeviceLike = "cuda"
                          ) -> Dict[str, torch.Tensor]:
    """The ``params`` entries of a JAX checkpoint's ``arrays.npz``
    (keyed ``['params'][...]``) as the port's flat parameters."""
    flat = {}
    for key, v in arrays.items():
        name = flat_name(key)
        if name.startswith("params/"):
            flat[name[len("params/"):]] = v
    return params_from_jax(_unflatten(flat), device)


def _restream(flat: np.ndarray, params: Mapping[str, torch.Tensor],
              to_port: bool) -> np.ndarray:
    """Reorder each conv leaf's elements inside a flat packed stream
    between HWIO (JAX) and OIHW (port); the other leaves and the pad
    tail keep their places."""
    out = np.array(flat, copy=True)
    off = 0
    for name in leaf_order(params):
        shape = tuple(params[name].shape)
        size = int(np.prod(shape))
        if len(shape) == 4:
            o, i, h, w = shape
            seg = flat[off:off + size]
            seg = (seg.reshape(h, w, i, o).transpose(3, 2, 0, 1) if to_port
                   else seg.reshape(o, i, h, w).transpose(2, 3, 1, 0))
            out[off:off + size] = seg.reshape(-1)
        off += size
    return out


def stream_opt_state_from_jax(opt: Mapping, params: Mapping[str, torch.Tensor],
                              device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The JAX package's stream optimizer state (``step``, the flat padded
    ``delta``) -> the port's, for the parameters ``params`` (the port's
    own, which give the leaves' names and shapes)."""
    dev = resolve_device(device)
    delta = _restream(np.asarray(opt["delta"]), params, to_port=True)
    return {"step": int(opt["step"]),
            "delta": torch.from_numpy(delta).to(dev)}


def stream_opt_state_to_jax(opt: Mapping, params: Mapping[str, torch.Tensor]
                            ) -> Dict[str, np.ndarray]:
    delta = opt["delta"].detach().cpu().numpy()
    return {"step": np.int32(opt["step"]),
            "delta": _restream(delta, params, to_port=False)}


def ef_residual_from_jax(residual: Mapping, worker: int,
                         device: DeviceLike = "cuda"
                         ) -> Dict[str, torch.Tensor]:
    """Worker ``worker``'s error-feedback residual out of the JAX
    package's per-worker residual (a parameter-shaped tree with a
    leading worker dim)."""
    return params_from_jax(_unflatten({k: np.asarray(v)[worker] for k, v in
                                       _flatten(residual).items()}), device)


def stack_ef_residuals(residuals) -> Dict[str, Any]:
    """The port's per-worker residuals (in rank order) as the JAX
    package's: a nested tree with a leading worker dim."""
    flat = [_flatten(params_to_jax(r)) for r in residuals]
    return _unflatten({k: np.stack([f[k] for f in flat]) for k in flat[0]})
