"""Initializers, norms and activations shared by the port's models, and
the staged loss of the overlapped data-parallel step.

Initializers draw from an explicit ``torch.Generator`` (wrapped in a
``LeafDraw``), on the device the generator lives on (the CPU unless a
caller asks for another, so a seed gives the same weights on every
device); the JAX package's threefry draws cannot be reproduced, so
tests carry JAX-initialized weights across instead (``interop.py``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class LeafDraw:
    """The initializers' source of weights: a ``torch.Generator`` whose
    draws are handed over leaf by leaf. Each leaf is drawn in f32 on the
    generator's device, cast to ``dtype`` (None: kept f32) on ``device``
    (None: where it was drawn), and the f32 draw is freed before the
    next one. A tree drawn so never holds more than one f32 leaf beside
    its finished leaves (llama4-maverick's expert leaves alone are 32 GB
    in bf16); the values are those of drawing the whole tree and casting
    it afterwards."""

    def __init__(self, gen: Optional[torch.Generator], device=None,
                 dtype=None):
        """``gen`` None draws nothing: every leaf is an empty tensor on
        the ``meta`` device (shapes and dtypes only, ``training/
        specs.py``)."""
        self.gen, self.dtype = gen, dtype
        self.device = (device if device is not None else
                       gen.device if gen is not None else
                       torch.device("meta"))

    def randn(self, shape: Sequence[int]) -> Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), device="meta")
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.gen.device)

    @classmethod
    def from_seed(cls, seed: int, draw_device, device, dtype=None
                  ) -> "LeafDraw":
        """Draws from ``seed`` on ``draw_device``, each leaf put on
        ``device`` in ``dtype`` (an LM's ``init``). A ``meta``
        ``draw_device`` skips the draw (``gen`` None)."""
        from repro_torch.device import resolve_device
        dev = resolve_device(draw_device)
        if dev.type == "meta":
            return cls(None, device, dtype)
        gen = torch.Generator(device=dev)
        return cls(gen.manual_seed(seed), device, dtype)

    def put(self, t: Tensor) -> Tensor:
        # cast where the leaf was drawn, then move the cast bytes
        return t.to(self.dtype or t.dtype).to(self.device)


def prefixed(prefix: str, tree: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """``tree``'s names under ``prefix`` (``"attn"`` + ``"wq"`` ->
    ``"attn/wq"``): a subtree flattened into its parent's "/" paths."""
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def sub_params(p: Dict[str, Tensor], prefix: str,
               layer: Optional[int] = None) -> Dict[str, Tensor]:
    """The params under ``prefix`` by their names below it (``sub0/attn``
    -> ``{"wq": ..., ...}``); layer ``layer``'s slice of stacked ones.
    Of a ``sharding.UseTree`` (the GSPMD steps under FSDP) the leaves are
    gathered as they are read (``UseTree.sub``)."""
    if hasattr(p, "sub"):
        return p.sub(prefix, layer)
    cut = len(prefix) + 1
    return {k[cut:]: v if layer is None else v[layer]
            for k, v in p.items() if k.startswith(prefix + "/")}


def normal_init(gen: LeafDraw, shape: Sequence[int],
                stddev: float = 0.02) -> Tensor:
    return gen.put(stddev * gen.randn(shape))


def fan_in_init(gen: LeafDraw, shape: Sequence[int],
                fan_in_dims: Sequence[int] = (-2,)) -> Tensor:
    """A normal draw over the square root of the fan-in, the product of
    ``shape``'s dims at ``fan_in_dims``."""
    fan_in = 1
    for d in fan_in_dims:
        fan_in *= shape[d]
    return gen.put(gen.randn(shape) / math.sqrt(max(fan_in, 1)))


def he_init(gen: LeafDraw, shape: Sequence[int], fan_in: int) -> Tensor:
    return gen.put(gen.randn(shape) * math.sqrt(2.0 / fan_in))


def dense(gen: LeafDraw, d_in: int, d_out: int,
          stacked: int = 0) -> Tensor:
    """A ``(stacked?, d_in, d_out)`` weight, fan-in initialized."""
    shape = (d_in, d_out) if not stacked else (stacked, d_in, d_out)
    return fan_in_init(gen, shape, (-2,))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, stacked: int = 0) -> Dict[str, Tensor]:
    shape = (d,) if not stacked else (stacked, d)
    return {"scale": torch.ones(shape)}


def layernorm_init(d: int, stacked: int = 0) -> Dict[str, Tensor]:
    shape = (d,) if not stacked else (stacked, d)
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def norm_init(kind: str, d: int, stacked: int = 0) -> Dict[str, Tensor]:
    return (rmsnorm_init(d, stacked) if kind == "rmsnorm"
            else layernorm_init(d, stacked))


# ---------------------------------------------------------------------------
# Logical axes (the JAX package's ``Boxed`` tags, one name per dim)
# ---------------------------------------------------------------------------

Axes = Tuple[Optional[str], ...]


def layer_axes(stacked) -> Axes:
    """The leading axis of a leaf stacked over layers, or none."""
    return ("layers",) if stacked else ()


def norm_axes(kind: str, stacked: int = 0) -> Dict[str, Axes]:
    """A norm's leaves (``norm_init``) over "embed"."""
    names = ("scale",) if kind == "rmsnorm" else ("scale", "bias")
    return {n: layer_axes(stacked) + ("embed",) for n in names}


def apply_norm(p: Dict[str, Tensor], x: Tensor, kind: str,
               eps: float = 1e-5) -> Tensor:
    """Normalize over the last dim with f32 statistics; the result is in
    x's dtype. ``rmsnorm`` is the kernel (``kernels.ops.rmsnorm``, its
    plain version on the CPU) in the JAX package's ``apply_norm``
    rounding order: ``inv`` is rounded to x's dtype before ``x * inv``
    (``round_inv=True``; the Pallas kernel's order rounds ``x * inv``
    instead). ``layernorm`` stays plain PyTorch, in the JAX package's op
    order. On a DTensor ``x`` (the GSPMD steps; rows split, features
    whole) either runs on each worker's rows (``local_apply``), so its
    backward takes the output's gradient whole (a Partial sum
    all-reduced)."""
    from repro_torch.distributed.sharding import local_apply
    if kind == "rmsnorm":
        from repro_torch.kernels.ops import rmsnorm
        return local_apply(rmsnorm, x, p["scale"], eps=eps, round_inv=True)
    if kind == "layernorm":
        return local_apply(_layernorm, x, p["scale"], p["bias"], eps=eps)
    raise ValueError(kind)


def _layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float
               ) -> Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    mean_sq = x32.square().mean(-1, keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps).to(dtype)
    y = (x - mean.to(dtype)) * inv
    y = y * scale.to(dtype) + bias.to(dtype)
    return y.to(dtype)


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant, the RNG state preserved
    for a layer that draws): the JAX package's ``jax.checkpoint`` of a
    layer (group)."""
    import torch.utils.checkpoint
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=True)


def gelu(x: Tensor) -> Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def count_params(tree: Dict[str, Tensor]) -> int:
    return sum(t.numel() for t in tree.values())


def cross_entropy_loss(logits: Tensor, targets: Tensor, ignore_id: int = -1,
                       label_smoothing: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Token-mean softmax cross entropy in f32, the JAX package's ops:
    ``(mean loss over the targets that are not ignore_id, their
    count)``. logits (..., V) floating; targets (...) integers. Label
    smoothing mixes in the loss against the mean logit.

    DTensor logits (the GSPMD step) have their vocabulary gathered and
    their rows' sums reduced over the workers: the loss and the count
    come back as plain tensors, the same on every worker."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, targets, ignore_id,
                                      label_smoothing)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(
        -1, targets.long().clamp_min(0)[..., None])[..., 0]
    nll = lse - target_logit
    if label_smoothing:
        smooth_nll = lse - logits.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth_nll
    mask = (targets != ignore_id).float()
    total = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / total, mask.sum()


def _ce_sums(logits: Tensor, targets: Tensor, ignore_id: int,
             label_smoothing: float) -> Tuple[Tensor, Tensor]:
    """The masked nll sum and the target count of some rows."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(
        -1, targets.long().clamp_min(0)[..., None])[..., 0]
    nll = lse - target_logit
    if label_smoothing:
        smooth_nll = lse - logits.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth_nll
    mask = (targets != ignore_id).float()
    return (nll * mask).sum(), mask.sum()


class _SumOver(torch.autograd.Function):
    """The sum of a tensor over a process group, whose gradient is the
    gradient itself: every worker of the group goes on with the same
    sum, so each one's gradient of it is already whole."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_sums(logits: Tensor, targets: Tensor, ignore_id: int,
                         label_smoothing: float, group, lo: int, vocab: int
                         ) -> Tuple[Tensor, Tensor]:
    """``_ce_sums`` of rows whose logits are split over ``group`` by
    vocabulary (this worker's columns start at ``lo``, of ``vocab``):
    the row max, the sum of exponentials, the target logit and the mean
    logit each reduced over the group (Megatron's vocab-parallel cross
    entropy), so no worker gathers the logits."""
    import torch.distributed as dist
    logits = logits.float()
    m = logits.amax(dim=-1).detach()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    sum_exp = _SumOver.apply(torch.exp(logits - m[..., None]).sum(dim=-1),
                             group)
    lse = m + torch.log(sum_exp)
    t = targets.long() - lo
    hit = (t >= 0) & (t < logits.shape[-1])
    picked = logits.gather(-1, t.clamp(0, logits.shape[-1] - 1)[..., None])
    target_logit = _SumOver.apply(picked[..., 0] * hit, group)
    nll = lse - target_logit
    if label_smoothing:
        mean = _SumOver.apply(logits.sum(dim=-1), group) / vocab
        nll = (1 - label_smoothing) * nll + label_smoothing * (lse - mean)
    mask = (targets != ignore_id).float()
    return (nll * mask).sum(), mask.sum()


def _sharded_cross_entropy(logits, targets, ignore_id: int,
                           label_smoothing: float):
    """``cross_entropy_loss`` of DTensor logits: each worker sums its own
    rows, over its own slice of the vocabulary when the logits split it
    (``_vocab_parallel_sums``; DTensor has no rule for the target gather
    over a sharded vocabulary), and the sums are reduced over the
    rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import distribute_local
    mesh = logits.device_mesh
    vocab_dim = logits.dim() - 1
    split = [i for i, p in enumerate(logits.placements)
             if p == Shard(vocab_dim)]
    if len(split) > 1 or any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, tuple(
            p if p == Shard(0) else Replicate() for p in logits.placements))
        split = []
    rows = tuple(p if p == Shard(0) else Replicate()
                 for p in logits.placements)
    if not isinstance(targets, DTensor):
        targets = distribute_local(targets, mesh, rows)
    elif tuple(targets.placements) != rows:
        targets = targets.redistribute(mesh, rows)
    sums = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    if split:
        i = split[0]
        vocab = logits.shape[-1]
        lo = mesh.get_local_rank(i) * (vocab // mesh.size(i))

        def fn(lg, t):
            return _vocab_parallel_sums(lg, t, ignore_id, label_smoothing,
                                        mesh.get_group(i), lo, vocab)
    else:
        def fn(lg, t):
            return _ce_sums(lg, t, ignore_id, label_smoothing)
    total, count = local_map(
        fn, out_placements=(sums, sums),
        in_placements=(tuple(logits.placements), rows),
        in_grad_placements=(tuple(logits.placements), rows),
        device_mesh=mesh)(logits, targets)
    total, count = total.full_tensor(), count.full_tensor()
    return total / torch.clamp(count, min=1.0), count


# ---------------------------------------------------------------------------
# staged loss (the backward-overlapped gradient sync)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StagedLoss:
    """A model's loss as K chained segments, for the overlapped DP step
    (``training/step.py:make_dp_overlap_train_step``): each segment's
    backward runs on its own, so the gradients come out segment by
    segment, last segment first, and a bucket's all-reduce can start as
    soon as its last gradient exists.

    ``seg_fns[i](seg_params[i], carry) -> (carry', aux)``; the carry is
    what one segment hands the next, a tensor or a tuple of tensors
    (an LM's ``(x, moe_aux[, tied table])``), and the last segment's
    carry' is the scalar loss. Every parameter lives in exactly one
    segment, whole or as a leading-dim slice (``slice_key``; the model's
    ``segment_trees`` cuts a parameter-shaped dict the same way), so
    ``merge_slices`` of the union of the segments' gradient dicts is the
    whole gradient. ``finalize_aux(auxes) -> (new_model_state,
    metrics)``."""

    names: Tuple[str, ...]
    seg_params: Tuple[Dict[str, Tensor], ...]
    seg_fns: Tuple[Callable, ...]
    x0: Any
    finalize_aux: Callable

    def __len__(self) -> int:
        return len(self.seg_fns)


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _detach_carry(carry):
    """A carry cut from its segment's graph: each tensor a detached
    copy that requires grad, so the next segment's VJP ends at it."""
    if isinstance(carry, tuple):
        return tuple(c.detach().requires_grad_(True) for c in carry)
    return carry.detach().requires_grad_(True)


def staged_forward(staged: StagedLoss):
    """The forward as a chain of segments, each on a detached copy of
    the incoming carry. Returns ``(loss, vjp_fns, auxes)``;
    ``vjp_fns[i](ct)`` is ``(segment parameter gradients, carry
    cotangent)``, the cotangent None for the first segment and shaped as
    the carry (a tensor or a tuple). The parameters must require grad
    (leaves, or slices of leaves). Chained from the last segment back,
    they run the ops of the monolithic backward, segment by segment, so
    the gradients are bitwise those of ``torch.autograd.grad`` of the
    whole loss."""
    carry = staged.x0
    vjps: List[Callable] = []
    auxes = []
    for i, (sp, fn) in enumerate(zip(staged.seg_params, staged.seg_fns)):
        carry_in = carry if i == 0 else _detach_carry(carry)
        carry, aux = fn(sp, carry_in)
        vjps.append(_segment_vjp(carry, list(sp), list(sp.values()),
                                 None if i == 0 else carry_in))
        auxes.append(aux)
    return carry, vjps, auxes


def _segment_vjp(out, names: List[str], leaves: List[Tensor], carry_in):
    def vjp(ct):
        # an output that does not require grad (a carried constant, as
        # the embedding segment's zero MoE aux) takes no cotangent
        pairs = [(o, c) for o, c in zip(_as_tuple(out), _as_tuple(ct))
                 if o.requires_grad]
        ins = leaves + ([] if carry_in is None else list(_as_tuple(carry_in)))
        gs = torch.autograd.grad([o for o, _ in pairs], ins,
                                 grad_outputs=[c for _, c in pairs])
        grads = dict(zip(names, gs[:len(leaves)]))
        if carry_in is None:
            return grads, None
        ct_in = tuple(gs[len(leaves):])
        return grads, ct_in if isinstance(carry_in, tuple) else ct_in[0]
    return vjp


def staged_value_and_grad(staged: StagedLoss):
    """The chained backward without overlap: ``(loss, (new_state,
    metrics), grads)``, the gradients in the parameters' own dtype and
    by their names (slices merged back into their leaves)."""
    loss, vjps, auxes = staged_forward(staged)
    ct: Any = torch.ones_like(loss)
    grads: Dict[str, Tensor] = {}
    for i in reversed(range(len(vjps))):
        g_seg, ct = vjps[i](ct)
        grads.update(g_seg)
    new_state, metrics = staged.finalize_aux(auxes)
    return loss, (new_state, metrics), merge_slices(grads)


# ---------------------------------------------------------------------------
# leading-dim slices of stacked leaves (an LM's layer segments)
# ---------------------------------------------------------------------------

_SLICE = re.compile(r"layers(\d+)_(\d+)/(.+)")


def slice_key(lo: int, hi: int, name: str) -> str:
    """The key of rows ``[lo, hi)`` of the stacked leaf ``name`` in a
    staged loss's layer segment ``layers{lo}_{hi}``: unique across
    segments, and sorted within one segment as ``name`` is
    (``bucketing.leaf_order``), which is the JAX package's order of a
    segment's stage tree."""
    return f"layers{lo}_{hi}/{name}"


def split_slice_key(key: str) -> Tuple[str, Optional[int], Optional[int]]:
    """``(leaf name, lo, hi)`` of a ``slice_key``; ``(key, None, None)``
    for a whole leaf."""
    m = _SLICE.fullmatch(key)
    if m is None:
        return key, None, None
    return m.group(3), int(m.group(1)), int(m.group(2))


def slice_views(tree: Dict[str, Tensor], keys) -> Dict[str, Tensor]:
    """``keys`` (whole leaves or ``slice_key``s) as views into ``tree``:
    writing into a slice's view writes into its leaf."""
    out = {}
    for k in keys:
        name, lo, hi = split_slice_key(k)
        out[k] = tree[name] if lo is None else tree[name][lo:hi]
    return out


def slice_parts(keys) -> Dict[str, List[str]]:
    """Leaf name -> the keys of ``keys`` that hold it, in row order."""
    parts: Dict[str, List[Tuple[int, str]]] = {}
    for k in keys:
        name, lo, _ = split_slice_key(k)
        parts.setdefault(name, []).append((-1 if lo is None else lo, k))
    return {n: [k for _, k in sorted(v)] for n, v in parts.items()}


def merge_slices(tree: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A dict of whole leaves and ``slice_key`` slices -> whole leaves,
    each leaf's slices concatenated in row order (the JAX package's
    ``merge_grads``)."""
    return {name: tree[name] if keys == [name] else
            torch.cat([tree[k] for k in keys])
            for name, keys in slice_parts(tree).items()}
