"""Transformer building blocks of the dense and MoE families: RoPE, GQA
attention (full forward, prefill into a KV cache, decode against it),
the MLPs, the MoE layer, the embedding and the LM head.

The port of the JAX package's ``models/layers.py``, function for
function, in the same layouts: activations ``(B, S, H, Dh)``, attention
weights ``(d, H, Dh)`` and ``(H, Dh, d)``. Functions are pure in their
parameters except the KV cache, which attention updates in place (the
JAX package writes a new cache, in place too once its buffer is
donated). ``chunked_attention`` at ``precision="f32"`` is the flash
kernel (``kernels.ops.attention``); the JAX package's pure-jnp chunked
loop and its Pallas kernel compute the same function. At
``precision="bf16"`` (the ``chunked_opt`` training path) it is that
jnp loop, in plain PyTorch: tiles in the compute dtype, f32 softmax
statistics and accumulator, each q block optionally checkpointed. Plain
products and ``decode_attention`` stay ``torch.matmul`` / einsum, as
the JAX package leaves them to XLA; so do the MoE layer's routing and
its four einsums (``moe_apply``), where the JAX package has no Pallas
kernel either.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    assign,
    constrain,
    is_dtensor,
    local_apply,
    local_slice,
    placed_like,
    redistribute,
    whole,
)
from repro_torch.models import common
from repro_torch.models.common import dense, gelu

Tensor = torch.Tensor
Params = Dict[str, Tensor]
NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Rotary position embedding (llama split-half convention)
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integers. cos and sin are cast
    to x's dtype before the products, as in the JAX package. A DTensor
    ``x`` (the GSPMD step) is rotated shard by shard, its positions
    split over the rows as its batch is."""
    if is_dtensor(x):
        return local_apply(rope, x, placed_like(positions, x, {0: 0}), theta)
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_init(gen: common.LeafDraw, cfg: ModelConfig, stacked: int = 0,
                   kv_dim: Optional[int] = None) -> Params:
    """QKV + output projection, weights shaped (d, H, Dh) and (H, Dh, d)
    (with a leading layer dim when ``stacked``)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    kv = cfg.n_kv_heads
    kd = kv_dim or d
    L = (stacked,) if stacked else ()

    def w(d_in, n_heads):
        return common.fan_in_init(gen, L + (d_in, n_heads, dh), (-3,))

    p: Params = {
        "wq": w(d, h),
        "wk": w(kd, kv),
        "wv": w(kd, kv),
        "wo": common.fan_in_init(gen, L + (h, dh, d), (-3, -2)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(L + (h, dh))
        p["bk"] = torch.zeros(L + (kv, dh))
        p["bv"] = torch.zeros(L + (kv, dh))
    return p


def attention_axes(cfg: ModelConfig, stacked: int = 0
                   ) -> Dict[str, common.Axes]:
    """The logical axes of ``attention_init``'s leaves."""
    L = common.layer_axes(stacked)
    a = {"wq": L + ("embed", "heads", "head_dim"),
         "wk": L + ("embed", "kv_heads", "head_dim"),
         "wv": L + ("embed", "kv_heads", "head_dim"),
         "wo": L + ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        a.update(bq=L + ("heads", "head_dim"), bk=L + ("kv_heads", "head_dim"),
                 bv=L + ("kv_heads", "head_dim"))
    return a


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: Params, x: Tensor, kv_x: Tensor, cfg: ModelConfig,
         positions: Optional[Tensor], kv_positions: Optional[Tensor],
         use_rope: bool) -> Tuple[Tensor, Tensor, Tensor]:
    q = _proj(x, p["wq"])
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    # "attn_batch" is "batch" unless the heads cannot shard. The sequence
    # stays whole inside a block: sequence parallelism ("seq") splits the
    # activations between blocks, and a "kv_seq" cache is written by
    # position (_cache_write)
    q = constrain(q, ("attn_batch", None, "heads", None))
    k = constrain(k, ("attn_batch", None, "kv_heads", None))
    v = constrain(v, ("attn_batch", None, "kv_heads", None))
    return q, k, v


def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """GQA: repeat kv heads to match query heads (reference path), in
    ``jnp.repeat``'s order: query head h reads kv head h // group."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> Tensor:
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= qi - kj < window
    return mask


def naive_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    window: Optional[int] = None, q_offset: int = 0
                    ) -> Tensor:
    """Materializes (B, H, Sq, Sk) scores. Reference / smoke-test path:
    scores in q's dtype, then f32 for the softmax, probabilities rounded
    to q's dtype before the product with v (the JAX package's order)."""
    h, dh = q.shape[2], q.shape[3]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: Optional[int] = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024, precision: str = "f32",
                      inner_checkpoint: bool = False) -> Tensor:
    """Online-softmax attention. At ``precision="f32"`` without
    ``inner_checkpoint`` this is the flash kernel
    (``kernels.ops.attention``: f32 tiles, f32 statistics, f32 p), which
    needs no chunk sizes or padding; ``q_chunk`` and ``kv_chunk`` only
    shape the JAX package's jnp loop and give the same result. It
    differentiates through the kernel's plain version, recomputed.

    ``precision="bf16"`` (with ``inner_checkpoint``: the ``chunked_opt``
    training path) runs the JAX package's loop over ``q_chunk`` x
    ``kv_chunk`` tiles in plain PyTorch (``_chunked_loop``): the tiles
    stay in q's dtype, scores, softmax statistics and the accumulator
    are f32, p is rounded to q's dtype. ``inner_checkpoint`` recomputes
    each q block in the backward instead of keeping its p tiles."""
    if precision == "f32" and not inner_checkpoint:
        from repro_torch.kernels.ops import attention
        return attention(q, k, v, causal=causal, window=window)
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    return _chunked_loop(q, k, v, causal, window, q_chunk, kv_chunk,
                         precision, inner_checkpoint)


def _chunked_loop(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  window: Optional[int], q_chunk: int, kv_chunk: int,
                  precision: str, inner_checkpoint: bool) -> Tensor:
    """The JAX package's jnp ``chunked_attention``, op for op: q and kv
    padded to whole chunks, every kv chunk visited by every q block
    (masked scores are -1e30), ``p = exp(s - m)`` in the tile dtype, its
    row sums and ``p @ v`` accumulated in f32. A product of tiles in the
    compute dtype takes f32 copies of them: the products are exact, the
    sums f32, as with ``preferred_element_type=f32``."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    pad_q, pad_k = (-sq) % q_chunk, (-sk) % kv_chunk
    tile = q.dtype if precision == "bf16" else torch.float32
    qr = F.pad(q, (0, 0, 0, 0, 0, pad_q)).to(tile)
    kr = F.pad(k, (0, 0, 0, 0, 0, pad_k)).to(tile)
    vr = F.pad(v, (0, 0, 0, 0, 0, pad_k)).to(tile)
    n_q, n_k = (sq + pad_q) // q_chunk, (sk + pad_k) // kv_chunk
    scale = 1.0 / math.sqrt(dh)
    dev = q.device

    def q_block(qi: int, q_blk: Tensor) -> Tensor:
        m = torch.full((b, h, q_chunk), -math.inf, device=dev)
        l = torch.zeros((b, h, q_chunk), device=dev)
        acc = torch.zeros((b, q_chunk, h, dh), device=dev)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
        for kj in range(n_k):
            k_blk = kr[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            v_blk = vr[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(),
                             k_blk.float()) * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)[None]
            mask = kpos < sk  # exclude kv padding
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (qpos - kpos < window)
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp((s - m_new[..., None]).to(tile))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, dtype=torch.float32)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p.float(), v_blk.float())
            m = m_new
        denom = torch.clamp(l, min=1e-30)  # fully padded q rows: no 0/0
        return acc / denom.transpose(1, 2)[..., None]

    outs = []
    for qi in range(n_q):
        q_blk = qr[:, qi * q_chunk:(qi + 1) * q_chunk]
        if inner_checkpoint and torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                q_block, qi, q_blk, use_reentrant=False))
        else:
            outs.append(q_block(qi, q_blk))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     valid_len: Tensor, window: Optional[int] = None
                     ) -> Tensor:
    """Single-token query vs cache. q: (B, 1, H, Dh); cache: (B, S, KV,
    Dh). GQA by a grouped einsum: the cache is never repeated to H
    heads."""
    b, one, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, one, kv, g, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    kj = torch.arange(s, device=q.device)[None, None, None, None, :]
    valid = valid_len.reshape(-1, 1, 1, 1, 1)
    mask = kj < valid
    if window is not None:
        mask &= kj >= valid - window
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, one, h, dh)


def attention_apply(
    p: Params,
    x: Tensor,
    cfg: ModelConfig,
    *,
    positions: Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    impl: str = "chunked",
    kv_x: Optional[Tensor] = None,  # cross-attention source
    kv_positions: Optional[Tensor] = None,
    cache: Optional[Params] = None,  # {"k","v"} (B,Smax,KV,Dh)
    cache_index: Optional[int] = None,
    use_rope: bool = True,
) -> Tuple[Tensor, Optional[Params]]:
    """Returns (output, updated cache); the cache tensors are written in
    place and returned.

    On DTensors the input's sequence is gathered whole first (sequence
    parallelism splits it between blocks; the flash kernel's causal mask
    takes no query offset), and the output leaves split over it again
    at its ``constrain``. A cache whose positions split over a mesh dim
    ("kv_seq") is written by each worker at its own positions, and a
    decode step attends to it without gathering it
    (``_kv_seq_decode``).

    If the cache is *smaller* than the position index it behaves as a
    ring buffer (sliding-window serving): writes go to ``index %
    cache_len`` and the whole ring is valid once full. RoPE phases are
    absolute, so scores are storage-order independent.
    """
    cross = kv_x is not None
    x = whole(x, 1)
    kv_x = x if kv_x is None else whole(kv_x, 1)
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _qkv(p, x, kv_x, cfg, positions, kv_positions,
                   use_rope and not cross and cfg.pos_embedding == "rope")

    opt = impl == "chunked_opt"

    def chunked(q, k, v, *, causal, window):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 precision="bf16" if opt else "f32",
                                 inner_checkpoint=opt)

    new_cache = None
    if cache is not None and not cross:
        cache_len = cache["k"].shape[1]
        idx = int(cache_index)
        if x.shape[1] == 1:  # decode
            write = idx % cache_len if window else idx
            _cache_write(cache, write, k, v)
            new_cache = cache
            valid = torch.full((x.shape[0],), min(idx + 1, cache_len),
                               device=x.device)
            attend = (_kv_seq_decode if _position_dim(cache["k"]) is not None
                      else functools.partial(_local_attention,
                                             decode_attention))
            out = attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                         placed_like(valid, q, {0: 0}),
                         None)  # the ring IS the window
        else:  # prefill into cache (keep the last cache_len positions)
            keep = min(k.shape[1], cache_len)
            # jax.lax.dynamic_update_slice clamps the start so the update
            # fits inside the cache
            _cache_write(cache, min(idx, cache_len - keep), k, v, keep)
            new_cache = cache
            out = _local_attention(
                chunked if impl.startswith("chunked") else naive_attention,
                q, k, v, causal=causal, window=window)
    else:
        fn = chunked if impl.startswith("chunked") else naive_attention
        if impl.startswith("chunked") and (x.shape[1] < 128 or
                                           kv_x.shape[1] < 128):
            fn = naive_attention  # smoke shapes
        out = _local_attention(fn, q, k, v, causal=causal and not cross,
                               window=window)

    out = constrain(out, ("attn_batch", None, "heads", None))
    h, dh, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], h * dh) @ p["wo"].to(x.dtype).reshape(
        h * dh, d)
    return constrain(y, ("batch", "seq", "embed")), new_cache


def _local_attention(fn, q: Tensor, k: Tensor, v: Tensor, *args,
                     **kw) -> Tensor:
    """``fn(q, k, v, *args)``; on DTensors (the GSPMD steps) on each
    worker's heads: q, k and v (or the KV cache) must split their heads
    over the same mesh axes (or the kv heads be a single one), so that
    query head h still reads kv head h // group within a shard."""
    if is_dtensor(q) and k.shape[2] > 1 and tuple(q.placements) != tuple(
            k.placements):
        raise NotImplementedError(
            f"attention with q placed {q.placements} and kv placed "
            f"{k.placements}: the heads of q and kv must shard alike")
    return local_apply(fn, q, k, v, *args, **kw)


def _position_dim(buf) -> Optional[int]:
    """The mesh dim that splits a placed cache's positions (its dim 1:
    "kv_seq"), or None."""
    if not is_dtensor(buf):
        return None
    return next((i for i, p in enumerate(buf.placements)
                 if p.is_shard() and p.dim == 1), None)


def _cache_write(cache: Params, start: int, k: Tensor, v: Tensor,
                 keep: Optional[int] = None) -> None:
    """``cache["k"][:, start:start + n] = k[:, -n:]`` (and v), n = ``keep``
    or all of k's positions, in the cache's dtype. A placed cache (the
    GSPMD serve steps) is written on each worker's own rows and kv heads
    by its own k and v, which the cache's placements redistribute; a
    cache whose positions split over a mesh dim ("kv_seq") is written by
    each worker at the positions it holds, nothing sent (a decode step's
    position by its owner alone)."""
    n = k.shape[1] if keep is None else keep
    for name, new in (("k", k), ("v", v)):
        buf, new = cache[name], new[:, new.shape[1] - n:]
        i = _position_dim(buf)
        if i is None:
            assign(buf[:, start:start + n], new)
            continue
        from torch.distributed.tensor import Replicate
        mesh = buf.device_mesh
        rows = tuple(Replicate() if j == i else p
                     for j, p in enumerate(buf.placements))
        local = buf.to_local()
        m = local.shape[1]
        lo = mesh.get_local_rank(i) * m
        a, b = max(start, lo), min(start + n, lo + m)
        src = (redistribute(new, rows).to_local() if is_dtensor(new)
               else local_slice(new, mesh, rows))
        if a < b:
            local[:, a - lo:b - lo].copy_(src[:, a - start:b - start])


def _kv_seq_decode(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                   valid_len: Tensor, window=None) -> Tensor:
    """``decode_attention`` against a cache whose positions split over a
    mesh dim ("kv_seq"), no cache gathered: q's heads are gathered whole
    over that dim (one token's), each worker takes its f32 scores over
    the valid positions it holds, and the softmax is combined over the
    dim by all-reduces of the row max, then of the exp-sums and of the
    weighted values (in f32: each worker's probabilities times its
    values, one rounding of the sum)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    del window  # the ring IS the window
    mesh = k_cache.device_mesh
    i = _position_dim(k_cache)
    group = mesh.get_group(i)
    lo = mesh.get_local_rank(i) * k_cache.to_local().shape[1]
    q = redistribute(q, tuple(Replicate() if j == i else p
                              for j, p in enumerate(q.placements)))

    def fn(q, kc, vc, valid):
        b, one, h, dh = q.shape
        s, kv = kc.shape[1], kc.shape[2]
        qg = q.reshape(b, one, kv, h // kv, dh)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float() / \
            math.sqrt(dh)
        kj = lo + torch.arange(s, device=q.device)
        mask = kj[None, None, None, None, :] < valid.reshape(-1, 1, 1, 1, 1)
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
        m = scores.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(scores - m)
        total = e.sum(dim=-1, keepdim=True)
        dist.all_reduce(total, group=group)
        probs = (e / total).to(q.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), vc.float())
        dist.all_reduce(out, group=group)
        return out.to(q.dtype).reshape(b, one, h, dh)

    return local_apply(fn, q, k_cache, v_cache, valid_len)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_init(gen: common.LeafDraw, cfg: ModelConfig, stacked: int = 0,
             d_ff: Optional[int] = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_variant == "swiglu":
        return {
            "w_gate": dense(gen, d, ff, stacked),
            "w_up": dense(gen, d, ff, stacked),
            "w_down": dense(gen, ff, d, stacked),
        }
    return {
        "w_up": dense(gen, d, ff, stacked),
        "w_down": dense(gen, ff, d, stacked),
    }


def mlp_axes(cfg: ModelConfig, stacked: int = 0) -> Dict[str, common.Axes]:
    L = common.layer_axes(stacked)
    a = {"w_up": L + ("embed", "ffn"), "w_down": L + ("ffn", "embed")}
    if cfg.mlp_variant == "swiglu":
        a["w_gate"] = L + ("embed", "ffn")
    return a


def mlp_apply(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = whole(x, 1)  # sequence parallelism: the block's sequence whole
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = gelu(x @ p["w_up"].to(x.dtype))
    h = constrain(h, ("batch", None, "ffn"))
    return constrain(h @ p["w_down"].to(x.dtype), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# MoE: GShard/GLaM-style grouped capacity dispatch
# ---------------------------------------------------------------------------

# tokens per dispatch group, and the expert capacity factor; both read
# at call time, as in the JAX package
MOE_GROUP = 256
CAPACITY_FACTOR = 1.25


def moe_init(gen: common.LeafDraw, cfg: ModelConfig, stacked: int = 0
             ) -> Params:
    """The router ``(d, e)``, the experts ``(e, d, ff)`` / ``(e, ff, d)``
    and, with ``n_shared_experts``, the always-on shared expert's MLP
    under ``shared/`` (a leading layer dim when ``stacked``)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = (stacked,) if stacked else ()

    def ew(d_in, d_out):
        return common.fan_in_init(gen, L + (e, d_in, d_out), (-2,))

    p: Params = {"router": dense(gen, d, e, stacked)}
    if cfg.mlp_variant == "swiglu":
        p["w_gate"] = ew(d, ff)
    p["w_up"] = ew(d, ff)
    p["w_down"] = ew(ff, d)
    if cfg.n_shared_experts:
        shared = mlp_init(gen, cfg, stacked,
                          d_ff=cfg.d_ff * cfg.n_shared_experts)
        p.update({f"shared/{k}": v for k, v in shared.items()})
    return p


def moe_axes(cfg: ModelConfig, stacked: int = 0) -> Dict[str, common.Axes]:
    L = common.layer_axes(stacked)
    a = {"router": L + ("embed", "experts_router"),
         "w_up": L + ("experts", "embed", "ffn"),
         "w_down": L + ("experts", "ffn", "embed")}
    if cfg.mlp_variant == "swiglu":
        a["w_gate"] = L + ("experts", "embed", "ffn")
    if cfg.n_shared_experts:
        a.update(common.prefixed("shared", mlp_axes(cfg, stacked)))
    return a


def _route(probs: Tensor, k: int, cap: int, dt) -> Tuple[Tensor, Tensor]:
    """``moe_apply``'s routing of the router ``probs`` (groups, tokens,
    experts): each of a token's top ``k`` choices (repeated argmax)
    takes the next slot of its expert in the group (a cumsum) and is
    dropped past ``cap``. Returns the dispatch one-hots (groups, tokens,
    experts, cap) in ``dt`` and the kept gates (groups, tokens, experts)
    in f32."""
    n_groups, g_size, e = probs.shape
    f32 = torch.float32
    dispatch = torch.zeros((n_groups, g_size, e, cap), dtype=dt,
                           device=probs.device)
    gates_full = torch.zeros((n_groups, g_size, e), dtype=f32,
                             device=probs.device)
    remaining = probs
    position_in_expert = torch.zeros((n_groups, e), dtype=torch.int32,
                                     device=probs.device)
    for _ in range(k):
        idx = remaining.argmax(-1)  # (g, s)
        gate = remaining.gather(-1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, e).to(torch.int32)
        pos = (position_in_expert[:, None, :] + onehot.cumsum(1,
               dtype=torch.int32) - onehot)
        pos = (pos * onehot).sum(-1)  # (g, s) slot within its expert
        keep = pos < cap
        # a slot past the capacity has no one-hot (JAX's one_hot of an
        # index out of range is all zeros); keep masks it anyway
        slot = F.one_hot(pos.clamp(max=cap - 1), cap).to(dt)
        dispatch = dispatch + (F.one_hot(idx, e).to(dt)[..., None]
                               * slot[:, :, None, :]
                               * keep[..., None, None].to(dt))
        gates_full = gates_full + onehot.to(f32) * (gate * keep)[..., None]
        position_in_expert = position_in_expert + onehot.sum(
            1, dtype=torch.int32)
        remaining = remaining * (1.0 - F.one_hot(idx, e).to(f32))
    return dispatch, gates_full


def _router(xg: Tensor, router: Tensor, k: int, cap: int
            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The router of some token groups: ``(probs, density, dispatch,
    combine)``, the f32 softmax of the router logits, each group's share
    of tokens whose first choice is each expert, ``_route``'s dispatch
    one-hots and the combine one-hots (dispatch x the kept gates)."""
    e = router.shape[-1]
    logits = torch.einsum("gsd,de->gse", xg, router.to(xg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    density = F.one_hot(probs.argmax(-1), e).to(torch.float32).mean(dim=1)
    # looked up at call time: a caller may stand in for the routing
    dispatch, gates_full = _route(probs, k, cap, xg.dtype)
    combine = dispatch * gates_full[..., None].to(xg.dtype)
    return probs, density, dispatch, combine


def _experts(xg: Tensor, dispatch: Tensor, combine: Tensor, w_up: Tensor,
             w_down: Tensor, w_gate: Optional[Tensor] = None) -> Tensor:
    """The experts' MLPs of the dispatched tokens, combined back into
    the groups (four einsums). On a worker that holds some of the
    experts (EP) or a slice of each one's ``ffn`` (TP) the result is its
    part of the sum over them."""
    dt = xg.dtype
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    if w_gate is not None:
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate.to(dt)))
        h = h * torch.einsum("gecd,edf->gecf", xe, w_up.to(dt))
    else:
        h = gelu(torch.einsum("gecd,edf->gecf", xe, w_up.to(dt)))
    ye = torch.einsum("gecf,efd->gecd", h, w_down.to(dt))
    return torch.einsum("gsec,gecd->gsd", combine, ye)


def _regroup(x: Tensor, rows: int) -> Tensor:
    """``x`` reshaped to ``(-1, rows, d)`` (tokens cut into groups, or
    groups put back into sequences). A DTensor is reshaped on each
    worker's rows; when its rows do not make whole groups they are
    gathered first."""
    d = x.shape[-1]
    if not is_dtensor(x):
        return x.reshape(-1, rows, d)
    if x.to_local().numel() % (rows * d):
        x = whole(x, 0)
    return local_apply(lambda t: t.reshape(-1, rows, d), x)


def moe_apply(p: Params, x: Tensor, cfg: ModelConfig,
              capacity_factor: Optional[float] = None
              ) -> Tuple[Tensor, Tensor]:
    """``(output, load-balance aux loss)``: the JAX package's
    ``moe_apply``, op for op. Tokens are cut into groups of
    ``MOE_GROUP``; the router's softmax is f32; each of the top
    ``experts_per_token`` choices (repeated argmax) takes the next slot
    of its expert in the group (a cumsum) and is dropped past the
    capacity ``max(4, int(group * k * capacity_factor / e))``; the
    tokens reach their experts and come back through the dispatch and
    combine (dispatch x gate) one-hots in four einsums; the shared
    expert adds its MLP of every token. The aux loss is Switch's,
    ``mean(density * density_proxy) * e**2``.

    On DTensors (the GSPMD steps) the router and the routing run on
    each worker's groups (``local_apply``: DTensor has no rules for the
    one-hots and the cumsum), on the router probabilities every worker
    of the model axis holds alike. The dispatch and combine one-hots
    are then placed by their ``constrain`` sites: over the experts
    (EP, "experts" on the model axis) or whole (TP inside the experts,
    "ffn" on it). Each worker runs the experts it holds, or its slice
    of each, on its own (``_experts``), which leaves a Partial sum over
    the model axis that the output's ``constrain`` all-reduces."""
    if capacity_factor is None:
        capacity_factor = CAPACITY_FACTOR
    x = whole(x, 1)  # sequence parallelism: the block's sequence whole
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g_size = min(MOE_GROUP, b * s)
    xg = constrain(_regroup(x, g_size), ("batch", None, "embed"))
    dt = x.dtype

    cap = max(4, int(g_size * k * capacity_factor / e))
    pl = tuple(xg.placements) if is_dtensor(xg) else None
    probs, density, dispatch, combine = local_apply(
        _router, xg, p["router"], k, cap, outs=None if pl is None
        else (pl,) * 4)
    density_proxy = probs.mean(dim=1)
    aux = (density * density_proxy).mean() * (e * e)

    dispatch = constrain(dispatch, ("batch", None, "experts", None))
    combine = constrain(combine, ("batch", None, "experts", None))
    w = [p["w_up"], p["w_down"]] + ([p["w_gate"]] if "w_gate" in p else [])
    out = None
    if pl is not None:  # a Partial sum where the experts' weights split
        from torch.distributed.tensor import Partial
        out = tuple(Partial() if any(not t.placements[i].is_replicate()
                                     for t in w) else q
                    for i, q in enumerate(pl))
    # ye is a partial sum over the model axis when ffn is TP-sharded: not
    # reduced inside, so the reduction lands on y, which is smaller
    y = local_apply(_experts, xg, dispatch, combine, *w, out=out)
    y = constrain(_regroup(constrain(y, ("batch", None, "embed")), s),
                  ("batch", "seq", "embed"))
    shared = {k_[len("shared/"):]: v for k_, v in p.items()
              if k_.startswith("shared/")}
    if shared:  # every token's MLP (the groups' rows are the tokens')
        y = y + mlp_apply(shared, x, cfg)
    return y, aux


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------


def embedding_init(gen: common.LeafDraw, cfg: ModelConfig) -> Params:
    return {"table": common.normal_init(gen, (cfg.vocab_size, cfg.d_model))}


EMBEDDING_AXES = {"table": ("vocab", "embed")}


def embed(p: Params, tokens: Tensor, compute_dtype) -> Tensor:
    table = p["table"].to(compute_dtype)
    x = _sharded_lookup(table, tokens) if is_dtensor(table) else table[tokens]
    return constrain(x, ("batch", "seq", "embed"))


def _sharded_lookup(table, tokens):
    """The token lookup of a DTensor table (DTensor has no rule for a
    vocab-sharded gather's backward): each worker looks up the tokens
    its rows of the vocabulary hold, zeros elsewhere, and the result is
    a Partial sum over the vocab's mesh axis (reduced by the caller's
    ``constrain``); its rows are placed as the tokens' rows are. The
    table's gradient is whole on its own rows, and a Partial sum over
    the mesh axes that split the batch. A table whose "embed" columns
    split (FSDP) has them gathered first (the steps read it through
    ``UseTree``, which gathers them already)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    table = whole(table, 1)  # FSDP's "embed" split: the columns whole
    mesh = table.device_mesh
    tok_pl = (tuple(tokens.placements) if is_dtensor(tokens)
              else (Replicate(),) * mesh.ndim)
    n = table.to_local().shape[0]
    lo = 0
    out_pl, grad_pl = [], []
    for i, (tp, kp) in enumerate(zip(table.placements, tok_pl)):
        if tp == Shard(0) and kp.is_replicate():  # the vocab over axis i
            lo += mesh.get_local_rank(i) * n
            out_pl.append(Partial())
            grad_pl.append(Shard(0))
        elif tp.is_replicate():
            out_pl.append(kp)
            grad_pl.append(Partial() if kp.is_shard() else Replicate())
        else:  # the vocabulary and the tokens split over one axis
            raise NotImplementedError(
                f"token lookup of a table placed {table.placements} with "
                f"tokens placed {tok_pl}")
    local = table.to_local(grad_placements=tuple(grad_pl))
    ids = tokens.to_local() if is_dtensor(tokens) else tokens
    hit = (ids >= lo) & (ids < lo + n)
    x = local[(ids - lo).clamp(0, n - 1)] * hit[..., None].to(local.dtype)
    return DTensor.from_local(x, mesh, tuple(out_pl))


def lm_head(table_or_w: Tensor, x: Tensor, tied: bool) -> Tensor:
    """The logits, the sequence whole (sequence parallelism splits it
    only between blocks)."""
    x = whole(x, 1)
    w = table_or_w.to(x.dtype)
    return constrain(x @ (w.T if tied else w), ("batch", None, "vocab"))
