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
