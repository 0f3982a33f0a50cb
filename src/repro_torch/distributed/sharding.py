"""Logical-axis sharding rules and activation constraints: the GSPMD
mode's half of the distribution layer, on DTensor.

The port of the JAX package's ``distributed/sharding.py``. Models tag
every parameter dim with a *logical* axis name ("embed", "heads", "ffn",
"experts", "vocab", ...; the models' ``axes()``), and ``make_rules`` maps
the names onto the mesh axes of one (arch, mesh, parallel) cell, with
the same divisibility fallbacks:

  DP   : "batch"  -> ("pod", "data")
  TP   : "heads"/"kv_heads"/"ffn"/"vocab" -> "model" (Megatron-style)
  EP   : "experts" -> "model" when n_experts % model == 0, else experts
         stay local and "ffn" carries the model axis
  FSDP : "embed" -> the data axes (``fsdp_params``)
  SP   : "seq" -> "model" (``sequence_sharding``), and "kv_seq" for the
         serve cells' KV cache (``kv_seq_sharding``)

A spec is a tuple with one entry per tensor dim (None, a mesh-axis name
or a tuple of them), trailing Nones dropped: the JAX package's
``PartitionSpec``. ``placements`` turns one into DTensor placements on a
``DeviceMesh`` whose dims carry the mesh-axis names (``launch/mesh.py``:
``("data", "model")`` or ``("pod", "data", "model")``): ``Shard(d)``
on each mesh dim named at tensor dim d, ``Replicate()`` elsewhere.

``make_rules``, ``spec_for``, ``prune_spec`` and ``tree_specs`` read
only the mesh's axis sizes: a ``DeviceMesh``, a ``{name: size}`` dict,
or anything with such a ``shape`` mapping (the JAX package's meshes).

Inside ``activation_sharding(mesh, rules)``, ``constrain(x, axes)``
redistributes a DTensor activation to ``prune_spec(spec_for(axes))``
(a Partial sum left by a row-parallel product is reduced there, as
XLA's partitioner does at a ``with_sharding_constraint``); outside one,
or for a plain tensor, it is the identity. ``local_apply`` runs a
function (a hand-written kernel's wrapper) on the local shards of its
DTensor arguments (``local_map``), with the gradient placements that
make each input's gradient whole: an input replicated over a mesh dim
on which the output is sharded gets a Partial gradient there.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]
Rules = Dict[str, Any]

_STATE = threading.local()


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a dict, or an object
    with such a ``shape`` mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(shape: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def make_rules(cfg, mesh, parallel) -> Rules:
    """Logical-axis -> mesh-axis rules for one (arch, mesh, parallel)
    cell; the divisibility fallbacks are resolved here, per arch, as in
    the JAX package."""
    shape = mesh_shape(mesh)
    tp = parallel.tp_axis
    tp_size = _axis_size(shape, tp) if tp else 1
    dp_axes = tuple(a for a in parallel.dp_axes if a in shape)
    if "pod" in shape and "pod" not in dp_axes:
        dp_axes = ("pod",) + dp_axes

    rules: Rules = {
        "batch": dp_axes,
        "layers": None,
        "head_dim": None,
        "seq": None,
        "kv_seq": None,
        "conv_spatial": None,
        "stats": None,
    }

    def divisible(n: int) -> bool:
        return tp_size > 1 and n > 0 and n % tp_size == 0

    rules["vocab"] = tp if divisible(cfg.vocab_size) else None
    rules["heads"] = tp if divisible(cfg.n_heads) else None
    rules["kv_heads"] = tp if divisible(cfg.n_kv_heads) else None
    rules["ffn"] = tp if divisible(cfg.d_ff) else None

    if cfg.n_experts:
        # EP over the model axis, or TP inside each expert ("ffn" keeps
        # tp; duplicate mesh axes are dropped per tensor by spec_for)
        rules["experts"] = tp if divisible(cfg.n_experts) else None

    # FSDP / ZeRO-3-style parameter sharding over the data axes
    if parallel.fsdp_params:
        fsdp = dp_axes
        rules["embed"] = (fsdp if cfg.d_model % _axis_size(shape, fsdp) == 0
                          else None)
    else:
        rules["embed"] = None

    # heads that do not divide tp (llama4's 40): the attention weights'
    # embed dim takes the model axis instead, and the attention runs
    # batch-parallel over it ("attn_batch")
    rules["attn_batch"] = rules["batch"]
    if cfg.n_heads and not divisible(cfg.n_heads) and cfg.d_model and \
            divisible(cfg.d_model):
        emb = rules["embed"]
        if emb is None:
            rules["embed"] = tp
        elif isinstance(emb, tuple) and tp not in emb:
            rules["embed"] = emb + (tp,)

    # sequence parallelism for activations (long-context cells)
    if parallel.sequence_sharding and tp:
        rules["seq"] = tp

    # serve cells: the KV cache's sequence dim on the model axis when the
    # kv heads cannot shard
    if parallel.kv_seq_sharding:
        target = tp if tp else ("model" if "model" in shape else None)
        kv_ok = cfg.n_kv_heads and tp and cfg.n_kv_heads % tp_size == 0
        if target and not kv_ok:
            rules["kv_seq"] = target

    # conv nets (ResNet-50, the paper's arch): pure DP, channels
    # replicated unless fsdp_params
    rules["conv_in"] = None
    rules["conv_out"] = dp_axes if parallel.fsdp_params else None

    # xLSTM / Mamba inner dims
    rules["inner"] = tp if divisible(cfg.ssm_expand * cfg.d_model) else None
    rules["ssm_state"] = None
    rules["ssm_heads"] = None
    return rules


def spec_for(axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """A spec of logical ``axes``, dropping mesh axes already used by an
    earlier dim."""
    used = set()
    out = []
    for name in axes:
        mesh_axes = rules.get(name) if name else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        fresh = tuple(a for a in mesh_axes if a not in used)
        used.update(fresh)
        out.append(fresh if len(fresh) > 1 else (fresh[0] if fresh else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def prune_spec(shape, spec: Spec, mesh) -> Spec:
    """Per-dim divisibility pruning: trim mesh axes from each dim's entry
    (right to left) until the dim divides evenly."""
    sizes = mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        while axes and dim % _axis_size(sizes, axes):
            axes = axes[:-1]
        out.append(None if not axes else
                   (axes[0] if len(axes) == 1 else axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_specs(axes_tree: Dict[str, Tuple], rules: Rules) -> Dict[str, Spec]:
    return {k: spec_for(a, rules) for k, a in axes_tree.items()}


def placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    named dims): for each mesh dim, ``Shard(d)`` if tensor dim d names
    it, else ``Replicate()``. A tensor dim named by several mesh dims is
    split over them major to minor, as a ``PartitionSpec`` entry is."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def tree_shardings(axes_tree: Dict[str, Tuple], mesh, rules: Rules
                   ) -> Dict[str, Tuple]:
    """Each leaf's DTensor placements on ``mesh`` (the JAX package's
    ``NamedSharding``s)."""
    return {k: placements(s, mesh)
            for k, s in tree_specs(axes_tree, rules).items()}


def batch_placements(mesh, rules: Rules) -> Tuple:
    """The placements of a batch: its rows over the "batch" rule's
    axes, replicated elsewhere."""
    return placements(spec_for(("batch",), rules), mesh)


# ---------------------------------------------------------------------------
# Activation constraint context (used inside model code)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def activation_sharding(mesh, rules: Rules):
    """While active, ``constrain(x, axes)`` pins activation placements."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor activation to its logical ``axes``' spec
    (pruned per dim to what divides) while a context is active; the
    identity otherwise and for plain tensors."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    want = placements(prune_spec(x.shape, spec_for(axes, rules), mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def current_rules() -> Optional[Rules]:
    ctx = getattr(_STATE, "ctx", None)
    return ctx[1] if ctx else None


def _grad_placements(p_in: Tuple, p_out: Tuple) -> Tuple:
    """The placements of an input's local gradient: Partial where the
    input is replicated but the output sharded (each shard of the
    output gives part of the gradient), the input's own elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if a.is_replicate() and b.is_shard() else a
                 for a, b in zip(p_in, p_out))


def local_apply(fn, *args, like: int = 0, **kwargs):
    """``fn(*args, **kwargs)`` on the local shards of the DTensor
    ``args`` (``local_map``); the output is a DTensor with
    ``args[like]``'s placements. With no DTensor argument it is the
    plain call. Plain tensors (and other values) pass as they are."""
    from torch.distributed.tensor.experimental import local_map
    if not any(is_dtensor(a) for a in args):
        return fn(*args, **kwargs)
    ref = args[like]
    out = tuple(ref.placements)
    ins = tuple(tuple(a.placements) if is_dtensor(a) else None
                for a in args)
    grads = tuple(None if p is None else _grad_placements(p, out)
                  for p in ins)
    return local_map(functools.partial(fn, **kwargs), out_placements=list(out),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=ref.device_mesh)(*args)


def local_slice(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This worker's shard of a whole tensor that every worker holds
    alike, by ``placements`` (evenly divided dims; nothing is sent)."""
    for i, pl in enumerate(placements):
        if pl.is_shard():
            t = t.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return t


def distribute_local(t: torch.Tensor, mesh, placements):
    """A whole tensor that every worker holds alike as a DTensor with
    ``placements``, from this worker's slice alone (a view of ``t``)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_slice(t, mesh, placements), mesh,
                              tuple(placements), shape=t.shape,
                              stride=t.stride())


def rows_like(t: torch.Tensor, x) -> Any:
    """A plain tensor whose dim 0 runs over the rows of the DTensor
    ``x`` (positions of a batch), as a DTensor sharded on that dim as
    ``x`` is on its dim 0 and replicated elsewhere; ``t`` itself when
    ``x`` is plain."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(0) if p == Shard(0) else Replicate()
               for p in x.placements)
    return distribute_local(t.contiguous(), x.device_mesh, pl)
