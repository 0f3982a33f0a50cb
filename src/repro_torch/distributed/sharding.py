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
function (a hand-written kernel's wrapper, or a loop DTensor has no
rules for: the MoE routing, the recurrences of the SSM families) on the
local shards of its DTensor arguments (``local_map``), with the
gradient placements that make each input's gradient whole: an input
replicated over a mesh dim on which the output is sharded or a Partial
sum gets a Partial gradient there.

Every placement change goes through ``redistribute``: a shard is
gathered by ``dist.all_gather`` (the list form), a new shard is this
worker's cut (its gradient a Partial sum), a Partial sum is
all-reduced. gloo takes a CUDA tensor's all-reduce and list all-gather,
but DTensor's own all-gather of one through it (the single-tensor form)
crashes, and the card's multi-process paths run gloo. ``whole``
makes tensor dims whole (a row a normalization reads), ``split_whole``
the pieces of a packed projection, ``relaid`` / ``placed_like`` lay a
tensor out as another (the heads of ``heads_placements``) before a
``local_apply``, and ``assign`` writes a placed cache in place.

A parameter is read at its use placements (``use_rules``: the rules
without FSDP's "embed" / "conv_out", llama4's "embed" on the model axis
or a table's "seq"): ``UseTree`` gathers a leaf where the model reads
it (``_UseGather``: cast first, list all-gathers; the backward an f32
all-reduce and a cut back to the shard).
"""
from __future__ import annotations

import contextlib
import functools
import types
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]
Rules = Dict[str, Any]

# the active (mesh, rules): process-wide, not per thread, so that the
# backward's recompute of a checkpointed layer, which a CUDA device's
# autograd thread runs, places its activations as the forward did
_STATE = types.SimpleNamespace(ctx=None)


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
    split over them major to minor, as a ``PartitionSpec`` entry is. A
    mesh dim of one worker replicates (the same layout; DTensor will not
    flatten a batch of one split over it, as a prefill's row is)."""
    from torch.distributed.tensor import Replicate, Shard
    try:
        sizes = mesh_shape(mesh)
    except AttributeError:  # axis names alone: no size known to be 1
        sizes = {}
    where = {}
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            where[a] = d
    return tuple(Shard(where[a]) if a in where and sizes.get(a) != 1
                 else Replicate() for a in mesh.mesh_dim_names)


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
    # an activation's "embed" dim stays whole: FSDP's "embed" is on the
    # batch's axes already, and llama4's on the model axis (its heads do
    # not divide it) would leave the products a Partial gradient, which
    # DTensor reduce-scatters; its weights are gathered at their use
    axes = tuple(None if a == "embed" else a for a in axes)
    return redistribute(x, placements(
        prune_spec(x.shape, spec_for(axes, rules), mesh), mesh))


def current_rules() -> Optional[Rules]:
    ctx = getattr(_STATE, "ctx", None)
    return ctx[1] if ctx else None


def _grad_placements(p_in: Tuple, p_out: Tuple) -> Tuple:
    """The placements of an input's local gradient: Partial where the
    input is replicated but the output sharded or a Partial sum (each
    worker's part of the output gives part of the gradient), the
    input's own elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if a.is_replicate() and not b.is_replicate()
                 else a for a, b in zip(p_in, p_out))


def local_apply(fn, *args, like: int = 0, out: Optional[Tuple] = None,
                outs: Optional[Sequence] = None, **kwargs):
    """``fn(*args, **kwargs)`` on the local shards of the DTensor
    ``args`` (``local_map``); the output is a DTensor with ``out``'s
    placements (None: ``args[like]``'s), or, with ``outs`` (one
    placements tuple per output), ``fn`` returns a tuple placed so. The
    gradient placements follow the (first) output. With no DTensor
    argument it is the plain call. Plain tensors (and other values)
    pass as they are."""
    from torch.distributed.tensor.experimental import local_map
    if not any(is_dtensor(a) for a in args):
        return fn(*args, **kwargs)
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    if outs is not None:
        placed = tuple(tuple(o) for o in outs)
        first = placed[0]
    else:
        first = tuple(args[like].placements) if out is None else tuple(out)
        placed = list(first)
    ins = tuple(tuple(a.placements) if is_dtensor(a) else None
                for a in args)
    grads = tuple(None if p is None else _grad_placements(p, first)
                  for p in ins)
    return local_map(functools.partial(fn, **kwargs), out_placements=placed,
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh)(*args)


class _GatherDim(torch.autograd.Function):
    """The shards of a group's ``n`` workers along ``dim`` concatenated
    in group-rank order (``dist.all_gather``, the list form); the
    gradient is this worker's slice of the whole one."""

    @staticmethod
    def forward(ctx, t, group, dim: int, index: int, n: int):
        import torch.distributed as dist
        ctx.dim, ctx.lo, ctx.size = dim, index * t.shape[dim], t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.size), None, None, None, None


def _set(pl: Tuple, i: int, p) -> Tuple:
    return tuple(p if j == i else q for j, q in enumerate(pl))


def _gather(x, i: int):
    """``x``'s shard over mesh dim ``i`` gathered whole (``_GatherDim``)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = x.device_mesh, tuple(x.placements)
    d, group = pl[i].dim, mesh.get_group(i)
    index, n = mesh.get_local_rank(i), mesh.size(i)
    return local_map(lambda t: _GatherDim.apply(t, group, d, index, n),
                     out_placements=list(_set(pl, i, Replicate())),
                     in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=mesh)(x)


def _cut(x, i: int, d: int):
    """``x``, whole over mesh dim ``i``, cut to this worker's slice of
    its dim ``d``; the gradient a Partial sum of zero-padded slices."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = x.device_mesh, tuple(x.placements)
    n = x.to_local().shape[d] // mesh.size(i)
    lo = mesh.get_local_rank(i) * n
    return local_map(lambda t: t.narrow(d, lo, n),
                     out_placements=list(_set(pl, i, Shard(d))),
                     in_placements=(pl,),
                     in_grad_placements=(_set(pl, i, Partial()),),
                     device_mesh=mesh)(x)


# DTensor's own collectives that ``redistribute`` never calls
_DTENSOR_COLLECTIVES = (
    ("torch.distributed._functional_collectives",
     ("all_gather_single", "all_gather_tensor", "all_gather_tensor_autograd",
      "reduce_scatter_single", "reduce_scatter_tensor",
      "reduce_scatter_tensor_autograd", "all_to_all_single",
      "all_to_all_single_autograd")),
    ("torch.distributed.tensor.placement_types", ("shard_dim_alltoall",)))


def count_dtensor_collectives() -> Dict[str, Any]:
    """Wraps DTensor's own all-gathers, reduce-scatters and all-to-alls
    for the rest of the process and returns their counter: ``calls["n"]``
    goes up by one a call while ``calls["on"]``. A step that moves every
    placement through ``redistribute`` leaves it at 0."""
    import importlib
    calls = {"n": 0, "on": False}

    def counted(fn):
        def call(*a, **k):
            calls["n"] += calls["on"]
            return fn(*a, **k)
        return call

    for mod_name, names in _DTENSOR_COLLECTIVES:
        mod = importlib.import_module(mod_name)
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, counted(getattr(mod, name)))
    return calls


def redistribute(x, want: Tuple):
    """``x.redistribute(mesh, want)`` by all-reduces, list all-gathers
    and local slices: a Partial sum all-reduced, a shard that moves or
    goes gathered whole (``_gather``), a new shard cut from the whole
    (``_cut``). gloo takes a CUDA tensor's all-reduce and list
    all-gather, but DTensor's all-gather of one through it crashes, so
    every placement change of the GSPMD steps comes here. A plain ``x``
    is returned as it is."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(want):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    cur = tuple(x.placements)
    one = tuple(w if mesh.size(i) == 1 and not (p.is_partial() or
                                                 w.is_partial()) else p
                for i, (p, w) in enumerate(zip(cur, want)))
    if one != cur:  # a mesh dim of one worker: relabelled, nothing moves
        from torch.distributed.tensor.experimental import local_map
        x = local_map(lambda t: t, out_placements=list(one),
                      in_placements=(cur,), in_grad_placements=(cur,),
                      device_mesh=mesh)(x)
        cur = one
        if cur == tuple(want):
            return x
    if any(isinstance(w, Shard) and x.shape[w.dim] % mesh.size(i) or
           w.is_partial() and not p.is_partial()
           for i, (p, w) in enumerate(zip(cur, want))):
        return x.redistribute(mesh, tuple(want))  # uneven: DTensor's own
    mid = tuple(Replicate() if p.is_partial() and not w.is_partial() else p
                for p, w in zip(cur, want))
    if mid != cur:
        x = x.redistribute(mesh, mid)
    for i, w in enumerate(want):
        if isinstance(x.placements[i], Shard) and x.placements[i] != w:
            x = _gather(x, i)
    for i, w in enumerate(want):
        if isinstance(w, Shard) and x.placements[i] != w:
            x = _cut(x, i, w.dim)
    return x


def split_whole(x, sizes: Sequence[int], dim: int = -1):
    """``torch.split(x, sizes, dim)`` of ``x`` made whole along ``dim``:
    the pieces of a packed projection whose columns are cut elsewhere
    than between its pieces. On a DTensor the gather and the split are
    one local op (``local_map``), so each piece's gradient is taken
    whole (a Partial sum all-reduced) before it is put back into the
    shard; the pieces keep ``x``'s other placements."""
    if not is_dtensor(x):
        return torch.split(x, list(sizes), dim)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    d = dim % x.dim()
    mesh, pl = x.device_mesh, tuple(x.placements)
    cut = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == d]
    if any(x.shape[d] % mesh.size(i) for i in cut):
        return split_whole(whole(x, d), sizes, d)
    out = tuple(Replicate() if i in cut else p for i, p in enumerate(pl))

    def fn(t):
        for i in reversed(cut):  # the minor mesh dim first
            t = _GatherDim.apply(t, mesh.get_group(i), d,
                                 mesh.get_local_rank(i), mesh.size(i))
        return tuple(torch.split(t, list(sizes), d))

    return local_map(fn, out_placements=(out,) * len(sizes),
                     in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=mesh)(x)


def whole(x, *dims: int):
    """The DTensor ``x`` with its tensor dims ``dims`` whole on every
    worker (a Partial sum reduced too): its other placements kept. A
    plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = tuple(d % x.dim() for d in dims)
    return redistribute(x, tuple(
        Replicate() if p.is_partial() or (isinstance(p, Shard) and
                                          p.dim in dims) else p
        for p in x.placements))


def remap(pl: Tuple, dims: Dict[int, int]) -> Tuple:
    """Placements for another tensor: where ``pl`` shards tensor dim d
    and d is in ``dims``, ``Shard(dims[d])``; ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in pl)


def relaid(t, mesh, pl: Tuple):
    """``t`` with placements ``pl`` on ``mesh``: a DTensor redistributed,
    a plain tensor (whole on every worker) sliced (nothing sent)."""
    if is_dtensor(t):
        return redistribute(t, tuple(pl))
    return distribute_local(t.contiguous(), mesh, tuple(pl))


def placed_like(t, x, dims: Dict[int, int]):
    """``t`` placed as the DTensor ``x`` is (``remap(x.placements,
    dims)``); ``t`` itself when ``x`` is plain."""
    if t is None or not is_dtensor(x):
        return t
    return relaid(t, x.device_mesh, remap(x.placements, dims))


def heads_placements(x, n_heads: int, axis: str) -> Tuple:
    """The placements of a ``(B, S, n_heads, ...)`` activation of the
    DTensor ``x``'s rows (x's dim 0) whose heads (dim 2) split over the
    mesh axes of the logical ``axis``, pruned to what divides
    ``n_heads``; a ``(B, S, n_heads * dh)`` one splits the same way."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return remap(x.placements, {0: 0})
    mesh, rules = ctx
    spec = prune_spec((x.shape[0], x.shape[1], n_heads),
                      spec_for(("batch", None, axis), rules), mesh)
    return placements(spec, mesh)


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


# ---------------------------------------------------------------------------
# parameters gathered where they are read (FSDP)
# ---------------------------------------------------------------------------

# the logical axes whose parameter shards are gathered where the
# parameter is read: FSDP's "embed" / "conv_out" over the data axes,
# llama4's "embed" on the model axis (heads that do not divide it), and
# a positional table's "seq" under sequence parallelism
GATHERED_AXES = ("embed", "conv_out", "seq")


def use_rules(rules: Rules) -> Rules:
    """The rules a parameter is read by: ``rules`` without its
    ``GATHERED_AXES`` (a dim that gave up its mesh axis to "embed", as
    "ffn" does to llama4's, takes it back: Megatron TP's layout)."""
    return {**rules, **{a: None for a in GATHERED_AXES}}


def tree_uses(axes_tree: Dict[str, Tuple], placed: Dict[str, Tuple], mesh,
              rules: Rules) -> Dict[str, Tuple]:
    """The use placements (by ``use_rules``) of the leaves read
    elsewhere than they are placed (``placed``: each leaf's
    placements)."""
    read = use_rules(rules)
    out = {}
    for k, pl in placed.items():
        use = placements(spec_for(axes_tree[k], read), mesh)
        if use != tuple(pl):
            out[k] = use
    return out


def _all_gather_dim(t: torch.Tensor, mesh, i: int, d: int) -> torch.Tensor:
    """The shards of mesh dim ``i``'s group along ``d``, concatenated in
    group-rank order (``dist.all_gather``, the list form)."""
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
    dist.all_gather(parts, t, group=mesh.get_group(i))
    return torch.cat(parts, d)


def _narrow_dim(t: torch.Tensor, mesh, i: int, d: int) -> torch.Tensor:
    """This worker's slice of ``t``'s dim ``d`` over mesh dim ``i``."""
    if t.shape[d] % mesh.size(i):
        raise ValueError(f"dim {d} of a tensor shaped {tuple(t.shape)} "
                         f"does not divide over mesh dim {i}")
    n = t.shape[d] // mesh.size(i)
    return t.narrow(d, mesh.get_local_rank(i) * n, n)


class _UseGather(torch.autograd.Function):
    """A parameter (a DTensor placed ``pl``) moved to its use placements
    ``want``, cast to ``dtype`` first (None: kept), so the gathers move
    the compute dtype: on each mesh dim where the two differ, its shard
    gathered whole (the minor mesh dim of a tensor dim split over
    several first), then the use's shard cut. The backward reduces the
    gradient to the parameter's placements on those mesh dims: a
    Partial sum all-reduced in f32 (a shard gathered), then the
    parameter's shard cut; on the others it keeps the gradient's own
    placements (a Partial sum over the batch axes is reduced by the
    step)."""

    @staticmethod
    def forward(ctx, x, want, dtype):
        from torch.distributed.tensor import DTensor
        mesh, pl = x.device_mesh, tuple(x.placements)
        ctx.dims = [i for i, (p, w) in enumerate(zip(pl, want)) if p != w]
        ctx.mesh, ctx.pl, ctx.shape = mesh, pl, x.shape
        ctx.stride, ctx.dtype = x.stride(), x.dtype
        t = x.to_local() if dtype is None else x.to_local().to(dtype)
        for i in reversed(ctx.dims):
            if pl[i].is_shard():
                t = _all_gather_dim(t, mesh, i, pl[i].dim)
        for i in ctx.dims:
            if want[i].is_shard():
                t = _narrow_dim(t, mesh, i, want[i].dim)
        return DTensor.from_local(t.contiguous(), mesh, tuple(want),
                                  shape=x.shape, stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor
        mesh = ctx.mesh
        pl = list(g.placements)
        t = g.to_local().float()
        for i in reversed(ctx.dims):
            if pl[i].is_shard():
                t = _all_gather_dim(t, mesh, i, pl[i].dim)
            elif pl[i].is_partial():
                t = t.clone()
                dist.all_reduce(t, group=mesh.get_group(i))
        for i in ctx.dims:
            if ctx.pl[i].is_shard():
                t = _narrow_dim(t, mesh, i, ctx.pl[i].dim)
            pl[i] = ctx.pl[i]
        return DTensor.from_local(t.contiguous().to(ctx.dtype), mesh,
                                  tuple(pl), shape=ctx.shape,
                                  stride=ctx.stride), None, None


def _drop_lead(pl: Tuple) -> Tuple:
    """The placements of a stacked leaf's row (its dim 0 dropped)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim - 1) if p.is_shard() else p for p in pl)


class UseTree(dict):
    """A step's parameters (by name) whose reads gather (FSDP): ``p[k]``
    is leaf k at its use placements (``uses[k]``, ``_UseGather``: cast
    to ``dtype``, then gathered); a leaf without a use placement is
    read as it is stored. ``sub(prefix, layer)`` is ``sub_params``: one
    row of the stacked leaves under ``prefix``, each gathered as it is
    cut, so a layer's weights are gathered when the layer runs (inside
    its checkpoint, with remat: the recompute gathers again). With
    ``local`` (the step's local forward) a read is this worker's plain
    tensor, its gradient this worker's share (a Partial sum over the
    mesh dims where ``local`` says so)."""

    def __init__(self, leaves: Dict[str, Any], uses: Dict[str, Tuple],
                 dtype, local: Optional[Tuple] = None):
        super().__init__(leaves)
        self.uses, self.dtype, self.local = uses, dtype, local

    def __getitem__(self, k):
        return self._read(dict.__getitem__(self, k), self.uses.get(k))

    def _read(self, v, want):
        if want is None:
            return v
        v = _UseGather.apply(v, want, self.dtype)
        return v if self.local is None else v.to_local(
            grad_placements=self.local)

    def sub(self, prefix: str, layer: Optional[int] = None):
        cut = len(prefix) + 1
        keys = [k for k in self if k.startswith(prefix + "/")]
        if layer is None:
            return UseTree({k[cut:]: dict.__getitem__(self, k) for k in keys},
                           {k[cut:]: self.uses[k] for k in keys
                            if k in self.uses}, self.dtype, self.local)
        out = {}
        for k in keys:
            want = self.uses.get(k)
            out[k[cut:]] = self._read(dict.__getitem__(self, k)[layer],
                                      None if want is None
                                      else _drop_lead(want))
        return out


def assign(dst, src) -> None:
    """``dst.copy_(src)``: ``dst`` a view of a buffer written in place
    (a cache's rows), in its dtype. A DTensor ``dst`` is written on each
    worker's own shard: ``src`` is redistributed to its placements
    first (a plain ``src``, whole on every worker, sliced)."""
    if is_dtensor(dst):
        if is_dtensor(src):
            src = redistribute(src, tuple(dst.placements)).to_local()
        else:
            src = local_slice(src, dst.device_mesh, dst.placements)
        dst = dst.to_local()
    dst.copy_(src)
