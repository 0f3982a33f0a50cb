"""The GSPMD train, eval, prefill and decode steps: the JAX package's
``make_train_step``, ``make_eval_step``, ``make_prefill_step`` and
``make_decode_step`` with a mesh, on DTensor.

The step computes the function of the one-device step on the whole
global batch, with the state placed over a ``DeviceMesh`` by the
logical-axis rules (``distributed/sharding.py``): parameters and
optimizer fields as DTensors (the fields by their parameters'
placements, or ZeRO-1's), the model state replicated. Each worker is
handed its own rows of the global batch (the rows of its coordinate on
the mesh's batch axes; the workers along the other axes get the same
rows).

* The loss is the global mean: the token mean over every worker's
  targets (an LM) or the image mean (ResNet-50), and the BN statistics
  are the global batch's (the model's ``bn_group`` is the mesh's batch
  group: the sync-BN route).
* The gradients are summed over the workers in **f32**, then rounded
  once to the wire dtype (XLA's GSPMD programs carry f32 all-reduces,
  and ``simulate_wire_cast`` rounds the summed gradient), unlike the
  data-parallel step's half-precision all-reduce.
* The optimizer update runs on each worker's local shard of every leaf
  (its parameter, gradient and state fields share one placement).
  ``grad_constraint`` (``optim/zero.py:zero_constraint``, ZeRO-1)
  redistributes the gradients first, a Partial sum becoming a
  reduce-scatter; the update then runs on each worker's ZeRO shard and
  the parameters are gathered back to their own placements.
  ``param_shardings`` pins the compute-dtype copy of the parameters
  to given placements (FSDP's gathers move the compute dtype without
  it: ``UseTree`` casts each shard before its gather).

How the forward runs depends on the placements. When every parameter
is replicated (pure DP over any mesh, ResNet-50 on any mesh: its conv
rules replicate every channel), the model runs on each worker's local
rows and parameters as the one-device step does, its loss weighted by
the worker's share of the global count, and the gradients are Partial
sums over the batch axes. Otherwise (every LM family under a model
axis: Megatron TP, the MoE experts or their ``ffn`` over it, the SSM
families' heads) the forward runs on DTensors: the products shard by
DTensor's rules, the models' ``constrain`` sites redistribute (the
row-parallel partial sums are all-reduced there), and what DTensor has
no rules for runs on local shards through ``sharding.local_apply``: the
hand-written kernels (``flash_attention`` on each worker's heads,
``rmsnorm`` on its rows), the MoE routing and experts, the SSM
recurrences. The token lookup (``layers._sharded_lookup``) and the
cross entropy (``common._sharded_cross_entropy``) are redistributed
explicitly, as DTensor has no rule for a vocab-sharded gather.

A parameter placed otherwise than it is read (FSDP's "embed" /
"conv_out" over the data axes, llama4's "embed" on the model axis, a
positional table's "seq": ``sharding.tree_uses``) stays an f32 shard;
the forward reads it through ``sharding.UseTree``: cast to the compute
dtype, then gathered to its use placements where the layer runs (inside
its checkpoint under remat), its gradient all-reduced in f32 and cut
back to the shard in the backward. The forward is local when every
parameter is read whole (ResNet-50 under ``fsdp_params``).

``microbatches`` > 1 cuts each worker's rows into equal microbatches
and accumulates the mean of their f32 gradients, the model state
threaded through them and the metrics their mean; their Partial sums
are reduced once, after the last. LARS on sharded leaves (TP, FSDP,
ZeRO-1) sums each leaf's squared norms over the mesh dims that split it
(``_sq_reducer``) before its trust ratio.

The serve steps take the whole batch on every worker (each keeps its
rows), write the cache (``place_cache``: placed by its logical axes, as
the JAX package's dry-run places it) in place, and return the logits
whole on every worker. Under sequence parallelism ("seq") the
activations between blocks split over the sequence and each block
gathers it whole; a cache whose positions split ("kv_seq") is written
by position and attended without a gather (``layers._kv_seq_decode``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.compression import parse_compression
from repro_torch.training.step import keep_storage
from repro_torch.distributed.sharding import (
    UseTree,
    activation_sharding,
    batch_placements,
    redistribute,
    tree_uses,
)

Tree = Dict[str, Any]


def _uses(model, params: Dict[str, Any], mesh, rules) -> Dict[str, Tuple]:
    """The use placements of the parameters read elsewhere than they are
    placed (FSDP's gathers: ``sharding.tree_uses`` of the model's axes)."""
    return tree_uses(model.axes(), {k: tuple(p.placements)
                                    for k, p in params.items()}, mesh, rules)


def _tensor_parallel(params: Dict[str, Any], uses: Dict[str, Tuple]
                     ) -> bool:
    """Whether some parameter is read sharded (the DTensor forward), or
    every one whole, after its gathers (the local forward)."""
    return any(not pl.is_replicate() for k, p in params.items()
               for pl in uses.get(k, p.placements))


def _batch_dims(mesh, rules) -> Tuple[int, ...]:
    """The mesh dims that split the batch's rows."""
    return tuple(i for i, pl in enumerate(batch_placements(mesh, rules))
                 if pl.is_shard())


def _batch_group_sum(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``t`` summed over the workers along the mesh dims ``dims``."""
    for i in dims:
        dist.all_reduce(t, group=mesh.get_group(i))
    return t


def place_batch(batch: Dict[str, Any], mesh, rules) -> Dict[str, Any]:
    """This worker's rows of a batch (tensors on its device) as DTensors
    of the global batch, placed by the "batch" rule."""
    from torch.distributed.tensor import DTensor
    pl = batch_placements(mesh, rules)
    return {k: DTensor.from_local(v, mesh, pl)
            if torch.is_tensor(v) and v.dim() else v
            for k, v in batch.items()}


def _batch_rows(batch: Tree, n: int):
    """``batch`` (this worker's rows) cut into ``n`` equal microbatches."""
    rows = [v.shape[0] for v in batch.values()
            if torch.is_tensor(v) and v.dim()]
    if rows and rows[0] % n:
        raise ValueError(f"a worker's {rows[0]} rows do not split into "
                         f"{n} microbatches")
    return [{k: v.chunk(n)[i] if torch.is_tensor(v) and v.dim() else v
             for k, v in batch.items()} for i in range(n)]


def _local_loss_grads(model, train_cfg, params, mstate, batch, mesh, dims,
                      uses):
    """The local forward: ``(new state, metrics, gradients)``, each
    gradient this worker's f32 share of the global one (its loss
    weighted by its share of the global token or row count), the
    metrics already global. A gathered leaf (``uses``: FSDP) is read
    through ``UseTree``: its gradient comes back reduced to its shard
    (a DTensor); the others' are plain local tensors."""
    from torch.distributed.tensor import Partial, Replicate
    names = list(params)
    cd = model.compute_dtype
    pc = {k: (params[k].detach() if k in uses else
              params[k].to_local().detach().to(cd)).requires_grad_(True)
          for k in names}
    tree = pc
    if uses:
        share = tuple(Partial() if i in dims else Replicate()
                      for i in range(mesh.ndim))
        tree = UseTree(pc, uses, cd, local=share)
    loss, (new_mstate, metrics) = model.loss_fn(
        tree, mstate, batch, train_cfg.label_smoothing)
    metrics = dict(metrics)
    if "tokens" in metrics:  # the token mean over every worker's targets
        count = torch.stack([metrics["tokens"].detach().float()])
        total = _batch_group_sum(count.clone(), mesh, dims)
        weight = (count / total)[0]
        metrics["tokens"] = total[0]
    else:  # equal rows a worker
        n = 1
        for i in dims:
            n *= mesh.size(i)
        weight = torch.tensor(1.0 / n, device=loss.device)
    gs = torch.autograd.grad(loss * weight, [pc[k] for k in names])
    scalars = sorted(k for k, v in metrics.items() if k != "tokens"
                     and torch.is_tensor(v) and v.dim() == 0)
    if scalars:
        stacked = torch.stack([metrics[k].detach().float() * weight
                               for k in scalars])
        _batch_group_sum(stacked, mesh, dims)
        metrics.update({k: stacked[i] for i, k in enumerate(scalars)})
    return new_mstate, metrics, {k: g.float() for k, g in zip(names, gs)}


def _dtensor_loss_grads(model, train_cfg, params, mstate, batch, mesh,
                        rules, param_shardings, uses):
    """The DTensor forward (tensor parallel): ``(new state, metrics,
    gradients)``, the gradients f32 DTensors, Partial sums where the
    forward left them so. A gathered leaf (``uses``: FSDP, llama4's
    embed on the model axis) stays an f32 shard and is read through
    ``UseTree`` (cast, then gathered at its use); its gradient comes
    back reduced to the shard."""
    names = list(params)
    cd = model.compute_dtype
    pc = {k: (params[k].detach() if k in uses else
              params[k].detach().to(cd)).requires_grad_(True)
          for k in names}
    leaves = [pc[k] for k in names]
    if param_shardings is not None:
        pc = {k: v.redistribute(mesh, param_shardings[k])
              for k, v in pc.items()}
    tree = UseTree(pc, uses, cd) if uses else pc
    with activation_sharding(mesh, rules):
        loss, (new_mstate, metrics) = model.loss_fn(
            tree, mstate, place_batch(batch, mesh, rules),
            train_cfg.label_smoothing)
        gs = torch.autograd.grad(loss, leaves)
    return new_mstate, dict(metrics), {k: g.float()
                                       for k, g in zip(names, gs)}


def _partial_grads(grads: Dict[str, torch.Tensor], mesh, dims):
    """Local gradient shares as DTensors: Partial sums over the batch
    dims, replicated over the others (a DTensor, a gathered leaf's
    gradient already reduced to its shard, as it is)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = tuple(Partial() if i in dims else Replicate()
               for i in range(mesh.ndim))
    return {k: g if isinstance(g, DTensor) else
            DTensor.from_local(g, mesh, pl) for k, g in grads.items()}


def _accumulate(acc, grads: Dict[str, Any], n: int):
    """``acc + grads / n`` on the local tensors (each gradient keeps its
    placements: a Partial sum is reduced once, after the last
    microbatch)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, g in grads.items():
        local = g.to_local() / n
        if acc is not None:
            if tuple(acc[k].placements) != tuple(g.placements):
                raise RuntimeError(f"{k}: microbatch gradients placed "
                                   f"{acc[k].placements} and {g.placements}")
            local = acc[k].to_local() + local
        out[k] = DTensor.from_local(local, g.device_mesh, g.placements,
                                    shape=g.shape, stride=g.stride())
    return out


def make_gspmd_train_step(model, optimizer, train_cfg, mesh, rules,
                          grad_constraint: Optional[Callable] = None,
                          param_shardings: Optional[Dict] = None,
                          microbatches: int = 1):
    """The GSPMD step (see the module docstring): ``(state, batch) ->
    (state', metrics)``, ``batch`` this worker's rows, the state's
    parameters and optimizer fields DTensors on ``mesh``.
    ``microbatches`` > 1 cuts each worker's rows into that many equal
    microbatches and accumulates the mean of their f32 gradients (the
    model state threaded through them, the metrics their mean), then
    reduces, casts and updates once."""
    lars = train_cfg.optimizer.kind == "lars"
    wire, _ = parse_compression(train_cfg.parallel.compression)
    wdt = {"bf16": torch.bfloat16, "f16": torch.float16}.get(wire)
    dims = _batch_dims(mesh, rules)
    device = model.device

    def loss_grads(params, mstate, batch, uses):
        """One (micro)batch: (new state, metrics, gradient DTensors)."""
        if _tensor_parallel(params, uses):
            return _dtensor_loss_grads(model, train_cfg, params, mstate,
                                       batch, mesh, rules, param_shardings,
                                       uses)
        new_mstate, metrics, local = _local_loss_grads(
            model, train_cfg, params, mstate, batch, mesh, dims, uses)
        return new_mstate, metrics, _partial_grads(local, mesh, dims)

    def train_step(state: Tree, batch: Tree):
        from repro_torch.training.step import to_device
        batch = to_device(batch, device)
        params = state["params"]
        uses = _uses(model, params, mesh, rules)
        if microbatches <= 1:
            new_mstate, metrics, grads = loss_grads(
                params, state["model_state"], batch, uses)
        else:
            new_mstate, grads, seq = state["model_state"], None, []
            for mb in _batch_rows(batch, microbatches):
                new_mstate, met, g = loss_grads(params, new_mstate, mb, uses)
                grads = _accumulate(grads, g, microbatches)
                seq.append(met)
            metrics = {k: torch.stack([torch.as_tensor(m[k]).float()
                                       for m in seq]).mean()
                       for k in seq[0]}
        # the f32 sums: ZeRO-1's reduce-scatter, or to each parameter's
        # own placements
        if grad_constraint is not None:
            grads = grad_constraint(grads)
        else:
            grads = {k: redistribute(g, tuple(params[k].placements))
                     for k, g in grads.items()}
        with torch.no_grad():
            g_loc = {k: g.to_local().contiguous() for k, g in grads.items()}
            if wdt is not None:  # one rounding of the summed gradient
                g_loc = {k: g.to(wdt).to(torch.float32)
                         for k, g in g_loc.items()}
            _update_shards(optimizer, params, grads, g_loc, state["opt"],
                           metrics, mesh if lars else None)
        if train_cfg.log_grad_norm:
            metrics["grad_norm"] = _global_norm(g_loc, grads, mesh)
        return {"params": params, "opt": state["opt"],
                "model_state": keep_storage(state["model_state"],
                                            new_mstate)}, metrics

    return train_step


def _global_norm(g_loc, grads, mesh) -> torch.Tensor:
    """The norm of the whole (wire-cast) gradient: each worker's local
    squares, a leaf's divided by the number of workers that hold the
    same shard of it, summed over every worker."""
    sq = torch.zeros((), dtype=torch.float32, device=mesh.device_type)
    for k, g in g_loc.items():
        copies = 1
        for i, pl in enumerate(grads[k].placements):
            if pl.is_replicate():
                copies *= mesh.size(i)
        sq = sq + g.square().sum() / copies
    sq = sq.reshape(1)
    dist.all_reduce(sq)
    return torch.sqrt(sq[0])


def _sq_reducer(grads, mesh) -> Callable:
    """LARS's ``sq_reduce`` on local shards: each leaf's squared norms
    (of its parameter and its decayed gradient) summed over exactly the
    mesh dims that shard it where the update runs (a replicated dim
    holds the same squares on every worker: not summed), leaves that
    share those dims in one all-reduce each."""
    def reduce(sq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        groups: Dict[Tuple[int, ...], list] = {}
        for k in sq:  # the parameters' order: every worker alike
            split = tuple(i for i, p in enumerate(grads[k].placements)
                          if p.is_shard())
            groups.setdefault(split, []).append(k)
        out = dict(sq)
        for split, keys in groups.items():
            if not split:
                continue
            t = torch.stack([sq[k] for k in keys])
            for i in split:
                dist.all_reduce(t, group=mesh.get_group(i))
            out.update(zip(keys, t.unbind(0)))
        return out
    return reduce


def _update_shards(optimizer, params, grads, g_loc, opt, metrics,
                   lars_mesh=None) -> None:
    """The optimizer update on each worker's local shards, in place: on
    the parameters' own shards, or (ZeRO-1: the gradients placed
    otherwise) on the gradients' shards of the parameters, gathered
    back after (``sharding.redistribute``). LARS (``lars_mesh``) takes
    its trust ratios from whole-leaf norms (``_sq_reducer``)."""
    # a list in the parameters' order: every worker gathers alike
    moved = [k for k in params
             if tuple(grads[k].placements) != tuple(params[k].placements)]
    p_loc = {}
    for k, p in params.items():
        if k in moved:  # a copy of the shard (the update runs in place)
            p_loc[k] = redistribute(p, tuple(grads[k].placements)
                                    ).to_local().contiguous()
        else:
            p_loc[k] = p.to_local()
    fields = {f: {k: v.to_local() for k, v in opt[f].items()}
              for f in opt if isinstance(opt[f], dict)}
    local_opt = dict(opt)
    local_opt.update(fields)
    kw = {} if lars_mesh is None else {
        "sq_reduce": _sq_reducer(grads, lars_mesh)}
    _, new_opt, opt_metrics = optimizer.update(p_loc, g_loc, local_opt, **kw)
    for f in opt:
        if not isinstance(opt[f], dict):
            opt[f] = new_opt[f]
    metrics.update(opt_metrics)
    from torch.distributed.tensor import DTensor
    for k in moved:
        p = params[k]
        shard = DTensor.from_local(p_loc[k], p.device_mesh,
                                   grads[k].placements, shape=p.shape,
                                   stride=p.stride())
        p.to_local().copy_(redistribute(shard, tuple(p.placements))
                           .to_local())


def make_gspmd_eval_step(model, mesh, rules):
    """Validation on the placed state: ``(params, model_state, batch) ->
    metrics``, ``batch`` this worker's rows, the metrics global."""
    dims = _batch_dims(mesh, rules)
    device = model.device

    @torch.no_grad()
    def eval_step(params, model_state, batch) -> Dict:
        from torch.distributed.tensor import Replicate

        from repro_torch.training.step import to_device
        batch = to_device(batch, device)
        uses = _uses(model, params, mesh, rules)
        if _tensor_parallel(params, uses):
            params = _read_tree(model, params, mesh, rules)
            with activation_sharding(mesh, rules):
                placed = place_batch(batch, mesh, rules)
                if hasattr(model, "eval_fn"):
                    return model.eval_fn(params, model_state, placed)
                loss, (_, metrics) = model.loss_fn(params, model_state,
                                                   placed)
        else:
            local = {k: v if k in uses else v.to_local()
                     for k, v in params.items()}
            if uses:  # FSDP: each leaf read whole
                local = UseTree(local, uses, None,
                                local=(Replicate(),) * mesh.ndim)
            if hasattr(model, "eval_fn"):
                metrics = model.eval_fn(local, model_state, batch)
                loss = metrics.pop("loss")
            else:
                loss, (_, metrics) = model.loss_fn(local, model_state, batch)
            n = 1
            for i in dims:
                n *= mesh.size(i)
            keys = sorted(k for k, v in metrics.items() if k != "tokens"
                          and torch.is_tensor(v) and v.dim() == 0)
            stacked = torch.stack([loss.float()] + [
                metrics[k].float() for k in keys]) / n
            _batch_group_sum(stacked, mesh, dims)
            loss = stacked[0]
            metrics = {k: stacked[i + 1] for i, k in enumerate(keys)}
        out = {k: v for k, v in metrics.items()
               if not torch.is_tensor(v) or v.dim() == 0}
        out["loss"] = loss
        return out

    return eval_step


def _read_tree(model, params: Dict[str, Any], mesh, rules):
    """``params`` as the forward reads them: a ``UseTree`` when some leaf
    is read elsewhere than it is placed (FSDP's gathers, in the leaves'
    own dtype), else as they are."""
    uses = _uses(model, params, mesh, rules)
    return UseTree(params, uses, None) if uses else params


def _placed_batch(batch: Dict[str, Any], mesh, rules) -> Dict[str, Any]:
    """A whole batch (the same on every worker) as DTensors placed by the
    "batch" rule, pruned to what divides: each worker keeps its rows."""
    from repro_torch.distributed.sharding import (distribute_local,
                                                  placements, prune_spec,
                                                  spec_for)
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v) and v.dim():
            pl = placements(prune_spec(v.shape, spec_for(("batch",), rules),
                                       mesh), mesh)
            v = distribute_local(v.contiguous(), mesh, pl)
        out[k] = v
    return out


def _whole_logits(logits):
    """The logits whole on every worker (a vocabulary split over the
    model axis gathered by an all-reduce: ``sharding.redistribute``)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import is_dtensor
    if not is_dtensor(logits):
        return logits
    return redistribute(logits, (Replicate(),) * logits.device_mesh.ndim
                        ).to_local()


def make_gspmd_prefill_step(model, mesh, rules):
    """The JAX package's ``make_prefill_step(model, mesh, rules)``:
    ``prefill_step(params, cache, batch) -> (last logits, cache)`` on the
    placed parameters and cache (``place_cache``), ``batch`` the whole
    prompt batch on every worker (``tokens``, and a VLM's ``patches`` or
    the audio model's ``frames``), each worker keeping its rows. The
    forward runs on DTensors as the train step's (its kernels on local
    shards); the logits come back whole on every worker, the cache is
    written in place in its placements."""
    device = model.device

    @torch.no_grad()
    def prefill_step(params, cache, batch):
        from repro_torch.training.step import to_device
        with activation_sharding(mesh, rules):
            placed = _placed_batch(to_device(batch, device), mesh, rules)
            kw = {k: placed[k] for k in ("frames", "patches") if k in placed}
            logits, cache = model.prefill(
                _read_tree(model, params, mesh, rules), placed["tokens"],
                cache, **kw)
        return _whole_logits(logits), cache

    return prefill_step


def make_gspmd_decode_step(model, mesh, rules):
    """The JAX package's ``make_decode_step(model, mesh, rules)``:
    ``decode_step(params, cache, batch) -> (logits, cache)``, ``batch``
    the whole (B, 1) ``tokens`` on every worker and their
    ``cache_index``; the logits whole, the cache written in place."""
    device = model.device

    @torch.no_grad()
    def decode_step(params, cache, batch):
        from repro_torch.training.step import to_device
        with activation_sharding(mesh, rules):
            placed = _placed_batch(to_device(batch, device), mesh, rules)
            logits, cache = model.decode_step(
                _read_tree(model, params, mesh, rules), cache,
                placed["tokens"], placed["cache_index"])
        return _whole_logits(logits), cache

    return decode_step


# ---------------------------------------------------------------------------
# placing a state
# ---------------------------------------------------------------------------


def place_cache(cache: Dict[str, torch.Tensor], axes: Dict, mesh, rules
                ) -> Dict[str, Any]:
    """A whole serve cache (the same on every worker, the model's
    ``cache_shape``) as DTensors placed by its logical ``axes``, each
    spec pruned per dim to what divides, as the JAX package's dry-run
    places it: each worker keeps a copy of its own slice."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import (local_slice, placements,
                                                  prune_spec, spec_for)
    out = {}
    for k, v in cache.items():
        pl = placements(prune_spec(v.shape, spec_for(axes[k], rules), mesh),
                        mesh)
        out[k] = DTensor.from_local(local_slice(v, mesh, pl).clone(), mesh,
                                    pl, shape=v.shape, stride=v.stride())
    return out


def place_params(params: Dict[str, torch.Tensor], shardings: Dict, mesh
                 ) -> Dict[str, Any]:
    """Whole parameters, the same on every worker (drawn from one seed),
    as DTensors with ``shardings``' placements: each worker keeps a copy
    of its own slice (never a view of ``params``), nothing is sent."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_slice
    return {k: DTensor.from_local(
        local_slice(v.detach(), mesh, shardings[k]).clone(), mesh,
        tuple(shardings[k]), shape=v.shape, stride=v.stride())
        for k, v in params.items()}


def init_placed_opt(optimizer, params: Dict[str, Any],
                    field_shardings: Optional[Dict] = None) -> Tree:
    """``optimizer.init`` of the placed ``params``: each per-leaf field a
    DTensor with ``field_shardings``' placements (None: the parameters'
    own), made from its local shards alone."""
    from torch.distributed.tensor import DTensor
    pl = {k: tuple(field_shardings[k]) if field_shardings else
          tuple(p.placements) for k, p in params.items()}
    local = {k: redistribute(p, pl[k]).to_local()
             for k, p in params.items()}
    state = optimizer.init(local)
    for f, v in state.items():
        if isinstance(v, dict):
            state[f] = {k: DTensor.from_local(t, params[k].device_mesh,
                                              pl[k])
                        for k, t in v.items()}
    return state


def gather_tree(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Whole tensors of a dict of DTensors (plain tensors as they are),
    on every worker (``sharding.redistribute``: list all-gathers, which
    gloo takes for CUDA tensors)."""
    from torch.distributed.tensor import DTensor, Replicate
    return {k: redistribute(v, (Replicate(),) * v.device_mesh.ndim)
            .to_local() if isinstance(v, DTensor) else v
            for k, v in tree.items()}
