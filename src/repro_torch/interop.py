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
``stack_worker_states``). An LM's parameters (``lm_params_from_jax``)
have the same layout in both packages and are only renamed.

``train_state_to_jax`` / ``train_state_from_jax`` carry a whole train
state (parameters, optimizer state in the per-leaf or the stream layout,
or ZeRO's shards of the stream, BN state, error-feedback residuals) both
ways, in the key strings and layout of the JAX package's checkpoints, so
the port's checkpoints are that package's checkpoints
(``checkpoint/checkpointer.py``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import _flatten as _keyed_arrays
from repro_torch.checkpoint.checkpointer import keystr, to_numpy, to_tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.bucketing import (
    BucketPlan,
    leaf_order,
    shard_layout_to_stream,
    shard_size,
    stream_to_shard_layout,
)

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


def _hwio(t: torch.Tensor) -> torch.Tensor:
    """A conv leaf (optionally under a leading worker dim) as HWIO."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 5:
        return t.permute(0, 3, 4, 2, 1)
    return t


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


def lm_params_from_jax(tree: Mapping, device: DeviceLike = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` parameters -> the port's flat tensors, no
    transposes: the layouts are the same. ``tree`` is the nested numpy
    tree (``embed/table``, ``sub0/attn/wq``, ...) or a flat mapping whose
    keys ``flat_name`` reads, such as the ``['params'][...]`` keys of a
    checkpoint's ``arrays.npz``."""
    dev = resolve_device(device)
    flat = {flat_name(k): v for k, v in _flatten(tree).items()}
    if any(n.startswith("params/") for n in flat):  # a whole checkpoint
        flat = {n[len("params/"):]: v for n, v in flat.items()
                if n.startswith("params/")}
    return {n: torch.from_numpy(np.array(v, order="C")).to(dev)
            for n, v in flat.items()}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat parameters (or any parameter-shaped tree, also
    under a leading worker dim) -> the JAX package's nested numpy, conv
    leaves as HWIO: transposed on the tensors' device, then copied to
    the host once."""
    return _unflatten({name: to_numpy(_hwio(t).contiguous())
                       for name, t in params.items()})


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


def _restream(flat, params: Mapping[str, torch.Tensor], to_port: bool,
              order: Optional[Sequence[str]] = None,
              port_order: Optional[Sequence[str]] = None):
    """Carry a flat packed stream between the port's layout (the leaves
    in ``port_order``, ``leaf_order`` when None; conv leaves OIHW) and
    the JAX package's (the leaves in ``order``, ``leaf_order`` when
    None; conv leaves HWIO); the pad tail keeps its place. ``flat`` is a
    tensor (the result stays on its device) or a numpy array (the result
    is one)."""
    src = flat if torch.is_tensor(flat) else torch.from_numpy(np.array(flat))
    names = leaf_order(params)
    port_order = names if port_order is None else list(port_order)
    jax_order = names if order is None else list(order)
    if sorted(jax_order) != names or sorted(port_order) != names:
        raise ValueError("the stream order must name every parameter once")
    sizes = {k: int(np.prod(tuple(params[k].shape))) for k in port_order}
    port_off = dict(zip(port_order, np.cumsum(
        [0] + [sizes[k] for k in port_order[:-1]]).tolist()))
    jax_off = dict(zip(jax_order, np.cumsum(
        [0] + [sizes[k] for k in jax_order[:-1]]).tolist()))
    out = src.clone()
    for name in port_order:
        shape, size = tuple(params[name].shape), sizes[name]
        lo, to = ((jax_off[name], port_off[name]) if to_port
                  else (port_off[name], jax_off[name]))
        seg = src[lo:lo + size]
        if len(shape) == 4:
            o, i, h, w = shape
            seg = (seg.view(h, w, i, o).permute(3, 2, 0, 1) if to_port
                   else seg.view(o, i, h, w).permute(2, 3, 1, 0))
        out[to:to + size] = seg.reshape(-1)
    return out if torch.is_tensor(flat) else out.numpy()


def stream_opt_state_from_jax(opt: Mapping, params: Mapping[str, torch.Tensor],
                              device: DeviceLike = "cuda",
                              order: Optional[Sequence[str]] = None
                              ) -> Dict[str, Any]:
    """The JAX package's stream optimizer state (``step``, the flat padded
    ``delta``, its leaves in ``order``: see ``_restream``) -> the port's,
    for the parameters ``params`` (the port's own, which give the
    leaves' names and shapes)."""
    dev = resolve_device(device)
    delta = _restream(np.asarray(opt["delta"]), params, to_port=True,
                      order=order)
    return {"step": int(opt["step"]),
            "delta": torch.from_numpy(delta).to(dev)}


def stream_opt_state_to_jax(opt: Mapping, params: Mapping[str, torch.Tensor],
                            order: Optional[Sequence[str]] = None
                            ) -> Dict[str, np.ndarray]:
    delta = opt["delta"].detach().cpu().numpy()
    return {"step": np.int32(opt["step"]),
            "delta": _restream(delta, params, to_port=False, order=order)}


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


# ---------------------------------------------------------------------------
# the whole train state, in the JAX package's checkpoint layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerSharding:
    """The data-parallel path's state layout: ``model_state`` and
    ``ef_residual`` are each worker's own (one per rank of ``group``;
    None is the default group), which the JAX package keeps under a
    leading worker dim; everything else is replicated.
    ``stream_order`` is the leaf order of the JAX package's stream
    optimizer state: None for ``leaf_order`` (the bucketed step's, and
    the port's without ZeRO), the ready order under ``overlap_comm``
    (``training.step.overlap_stream_order``).

    ``zero_plan`` (ZeRO) says that the flat fields of ``opt`` are
    sharded: each worker holds its block of the shard layout
    (``bucketing.stream_to_shard_layout``) of the port's stream under
    this plan, whose ``names`` give the port's leaf order (the ready
    order under ``overlap_comm``). The JAX package holds the same fields
    as one global shard-layout array of its own stream; the bucket
    bounds depend only on the stream's length, the bucket bytes, the
    wire itemsize and the alignment, so one plan's ``shard_perm`` serves
    both streams."""

    group: Any = None
    stream_order: Optional[Tuple[str, ...]] = None
    zero_plan: Optional[BucketPlan] = None

    def world(self) -> int:
        return dist.get_world_size(self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group)


def _path(name: str) -> tuple:
    return tuple(name.split("/"))


def hwio_shape(shape: Sequence[int]) -> tuple:
    """A leaf's shape in the JAX package's layout: a conv weight's OIHW
    as HWIO, any other shape as it is."""
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return tuple(shape)


def _jax_shape(t: torch.Tensor) -> tuple:
    return tuple(_hwio(t).shape)


def _gather_rows(tensors: List[torch.Tensor], shardings: WorkerSharding
                 ) -> Optional[List[torch.Tensor]]:
    """Every worker's copy of ``tensors`` (float32) stacked under a
    leading worker dim, on the group's first rank; None on the others.
    A collective: every worker calls it with tensors of the same
    shapes."""
    world = shardings.world()
    if world == 1:
        return [t.unsqueeze(0) for t in tensors]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if dist.get_backend(shardings.group) == "gloo":
        flat = flat.cpu()  # gloo gathers host tensors
    first = shardings.rank() == 0
    rows = [torch.empty_like(flat) for _ in range(world)] if first else None
    dst = (dist.get_global_rank(shardings.group, 0)
           if shardings.group is not None else 0)
    dist.gather(flat, rows, dst=dst, group=shardings.group)
    if not first:
        return None
    stacked = torch.stack(rows)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(stacked[:, off:off + n].reshape(world, *t.shape)
                   .to(t.dtype))
        off += n
    return out


def train_state_to_jax(state: Mapping, shardings: Optional[WorkerSharding]
                       = None) -> Optional[Dict[str, Any]]:
    """The port's train state -> the JAX package's nested tree of host
    numpy arrays, in its layout: conv leaves of the parameters, of every
    per-leaf optimizer tree and of the EF residuals as HWIO; a stream
    optimizer state (a flat tensor) reordered to the JAX stream
    (``_restream``, its leaves in ``shardings.stream_order``); the host ``step`` counter as a 0-d int32 array, as
    the JAX optimizers keep it. The tensors are copied to the host here,
    once (the checkpoint snapshot).

    With ``shardings`` (the data-parallel path) this is a collective:
    every worker calls it, the per-worker BN state and EF residuals are
    gathered to the group's first rank under a leading worker dim (the
    JAX package's per-worker layout), and the tree is returned there and
    None on the other ranks. Under ZeRO (``shardings.zero_plan``) the
    workers' shards of each flat ``opt`` field are gathered in rank order
    too, which gives the global shard layout of the port's stream; it
    becomes the JAX package's through the whole stream:
    ``shard_layout_to_stream``, ``_restream``, ``stream_to_shard_layout``
    (a worker's port shard and its JAX shard hold different elements:
    the conv leaves are laid out differently)."""
    rows: Dict[tuple, torch.Tensor] = {}
    if shardings is not None:
        leaves = _worker_leaves(state, shardings.zero_plan is not None)
        gathered = _gather_rows([t for _, t in leaves], shardings)
        if gathered is None:
            return None
        rows = dict(zip([path for path, _ in leaves], gathered))
    tree: Dict[str, Any] = {}
    for key, sub in state.items():
        if key == "params":
            tree[key] = params_to_jax(sub)
        elif key == "opt":
            order = shardings.stream_order if shardings is not None \
                else None
            tree[key] = {k: _opt_leaf_to_jax(v, state["params"], order)
                         if ("opt", k) not in rows else
                         _zero_field_to_jax(rows[("opt", k)], state["params"],
                                            order, shardings.zero_plan)
                         for k, v in sub.items()}
        elif key == "model_state":
            tree[key] = {site: {k: to_numpy(rows.get((key, site, k), t))
                                for k, t in rec.items()}
                         for site, rec in sub.items()}
        elif key == "ef_residual":
            tree[key] = params_to_jax({n: rows.get((key, n), t)
                                       for n, t in sub.items()})
        else:
            raise KeyError(f"unknown train-state entry {key!r}")
    return tree


def _worker_leaves(state: Mapping, zero: bool = False) -> List[tuple]:
    """(path, tensor) of every per-worker tensor: the BN state's
    ``(site, field)``, the EF residual's leaves and, under ZeRO, the
    flat ``opt`` fields (each worker's shard)."""
    out = []
    if zero:
        out += [(("opt", k), t) for k, t in state["opt"].items()
                if torch.is_tensor(t)]
    if "model_state" in state:
        out += [(("model_state", site, k), t)
                for site, rec in state["model_state"].items()
                for k, t in rec.items()]
    if "ef_residual" in state:
        out += [(("ef_residual", n), t)
                for n, t in state["ef_residual"].items()]
    return out


def _zero_field_to_jax(rows: torch.Tensor, params, order,
                       plan: BucketPlan) -> np.ndarray:
    """The workers' shards of a ZeRO field (``rows``, one per rank) as
    the JAX package's global shard-layout array of its own stream."""
    n = rows.shape[0]
    stream = _restream(shard_layout_to_stream(rows.reshape(-1), plan, n),
                       params, to_port=False, order=order,
                       port_order=plan.names)
    return to_numpy(stream_to_shard_layout(stream, plan, n))


def _zero_field_from_jax(arr: np.ndarray, params, order, plan: BucketPlan,
                         n: int, w: int) -> np.ndarray:
    """Worker ``w``'s shard of a ZeRO field out of the JAX package's
    global shard-layout array (the inverse of ``_zero_field_to_jax``)."""
    stream = _restream(shard_layout_to_stream(arr, plan, n), params,
                       to_port=True, order=order, port_order=plan.names)
    size = shard_size(plan, n)
    return stream_to_shard_layout(stream, plan, n)[w * size:(w + 1) * size]


def _opt_leaf_to_jax(v, params, order):
    if isinstance(v, Mapping):
        return params_to_jax(v)
    if torch.is_tensor(v):  # the flat stream of a stream optimizer
        return to_numpy(_restream(v, params, to_port=False, order=order))
    return np.asarray(v, np.int32)


def train_state_from_jax(arrays: Mapping, target: Dict[str, Any],
                         shardings: Optional[WorkerSharding] = None
                         ) -> Dict[str, Any]:
    """The inverse of ``train_state_to_jax``, keyed against ``target``
    (the port's train state) the way ``checkpoint.restore`` keys against
    its target: ``arrays`` is a checkpoint's flat ``{key string: array}``
    dict or the JAX package's nested tree; a missing key raises
    ``KeyError`` and a shape that differs from the target leaf's JAX
    shape ``ValueError``. Every tensor of ``target`` is overwritten in
    place (a model's own parameters stay bound to it), the host ``step``
    counter is set, and ``target`` is returned. With ``shardings`` each
    worker takes its own row of the per-worker entries, and under ZeRO
    its own shard of the flat ``opt`` fields."""
    if any(isinstance(v, Mapping) for v in arrays.values()):
        arrays = _keyed_arrays(arrays)
    row = shardings.rank() if shardings is not None else None
    world = shardings.world() if shardings is not None else None
    order = shardings.stream_order if shardings is not None else None
    zero_plan = shardings.zero_plan if shardings is not None else None

    def fetch(path: tuple, shape: tuple) -> np.ndarray:
        key = keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = np.asarray(arrays[key])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs target {tuple(shape)}")
        return arr

    def load(t: torch.Tensor, arr: np.ndarray) -> None:
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        t.copy_(to_tensor(arr, t))

    def per_worker(path: tuple, t: torch.Tensor) -> np.ndarray:
        if row is None:
            return fetch(path, _jax_shape(t))
        return fetch(path, (world,) + _jax_shape(t))[row]

    with torch.no_grad():
        for key, sub in target.items():
            if key == "params":
                for n, t in sub.items():
                    load(t, fetch((key,) + _path(n), _jax_shape(t)))
            elif key == "opt":
                for k, v in list(sub.items()):
                    if isinstance(v, Mapping):
                        for n, t in v.items():
                            load(t, fetch((key, k) + _path(n),
                                          _jax_shape(t)))
                    elif torch.is_tensor(v) and zero_plan is not None:
                        v.copy_(to_tensor(_zero_field_from_jax(
                            fetch((key, k), (v.numel() * world,)),
                            target["params"], order, zero_plan, world, row),
                            v))
                    elif torch.is_tensor(v):
                        v.copy_(to_tensor(_restream(
                            fetch((key, k), tuple(v.shape)),
                            target["params"], to_port=True,
                            order=order), v))
                    else:
                        sub[k] = int(fetch((key, k), ()))
            elif key == "model_state":
                for site, rec in sub.items():
                    for k, t in rec.items():
                        t.copy_(to_tensor(per_worker((key, site, k), t), t))
            elif key == "ef_residual":
                for n, t in sub.items():
                    load(t, per_worker((key,) + _path(n), t))
            else:
                raise KeyError(f"unknown train-state entry {key!r}")
    return target
