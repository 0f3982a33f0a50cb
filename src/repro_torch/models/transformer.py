"""Decoder-only transformer LM, the dense, MoE and VLM families
(llama3.2-1b, yi-9b, granite-34b, qwen2-72b; mixtral-8x7b,
llama4-maverick; phi-3-vision-4.2b).

The port of the JAX package's ``models/transformer.py``: the same
parameter tree, flattened to "/" paths (``embed/table``,
``sub0/norm1/scale``, ``sub0/attn/wq``, ..., ``sub1/moe/w_up``,
``final_norm/scale``), with the layer params stacked on a leading dim
of layer *groups*. A MoE config with ``moe_layer_every=k`` has groups
of k sub-layers ``sub0 .. sub{k-1}``, the last of them MoE (llama4's
alternating pattern); every other config has one sub-layer a group.
``forward`` loops over the groups where the JAX package scans them.
The KV cache is ``{"sub{j}/k", "sub{j}/v"}``, each ``(G, B, S, KV,
Dh)``, written in place by ``prefill`` and ``decode_step``.

``loss_fn`` is the training loss (token-mean cross entropy in f32, plus
0.01 x the MoE aux loss); ``loss_segments`` is the same loss as chained
segments for the overlapped data-parallel step. A VLM (a config with
``vision``) does early fusion: its ``patches`` (B, P, patch_dim),
projected by ``vision_proj`` in the compute dtype, are prepended to the
token embeddings, and their positions are dropped after the final norm.
``remat`` (the JAX launcher's ``n_layers > 8``) recomputes each layer
group's forward in the backward pass (``torch.utils.checkpoint``, as the
JAX package rematerializes its scan body): the same values, bitwise,
for less activation memory. ``init_params`` returns the parameters and
their logical axes (``axes``), which ``distributed/sharding.py`` places;
on DTensor parameters (the GSPMD step) the forward is tensor parallel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import is_dtensor, whole
from repro_torch.models import common, layers
from repro_torch.models.common import (
    LeafDraw,
    StagedLoss,
    apply_norm,
    norm_axes,
    norm_init,
    prefixed,
    slice_key,
    slice_views,
    sub_params,
)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

ATTENTION_IMPLS = ("naive", "chunked", "chunked_opt")


class TransformerLM:
    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 attention_impl: str = "chunked", *, comm_stages: int = 4,
                 remat: bool = False, device: DeviceLike = "cuda"):
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {attention_impl!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        # how many slices loss_segments cuts the layer groups into: the
        # granularity of the overlapped step's gradient sync
        self.comm_stages = comm_stages
        self.remat = remat
        self.device = resolve_device(device)
        self.group = cfg.moe_layer_every if cfg.n_experts else 1
        if cfg.n_layers % self.group:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"make groups of {self.group}")
        self.n_groups = cfg.n_layers // self.group

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
             dtype: Optional[torch.dtype] = None) -> Params:
        """Parameters by their JAX-tree paths, drawn from ``seed`` on
        ``draw_device`` (the CPU: the same weights for every model
        device), each leaf moved to the model's device and cast to
        ``dtype`` (None: f32) as soon as it is drawn, its f32 draw freed
        before the next (``common.LeafDraw``). Drawing on the card gives
        other values and spares the host a copy of the weights (35 GB
        in f32 at yi-9b's size)."""
        cfg = self.cfg
        gen = LeafDraw.from_seed(seed, draw_device, self.device, dtype)
        G = self.n_groups
        p: Params = prefixed("embed", layers.embedding_init(gen, cfg))
        if cfg.vision is not None:
            p["vision_proj"] = common.dense(gen, cfg.vision.patch_dim,
                                            cfg.d_model)
        for j in range(self.group):
            pre = f"sub{j}"
            p.update(prefixed(f"{pre}/norm1",
                              norm_init(cfg.norm, cfg.d_model, G)))
            p.update(prefixed(f"{pre}/attn",
                              layers.attention_init(gen, cfg, G)))
            p.update(prefixed(f"{pre}/norm2",
                              norm_init(cfg.norm, cfg.d_model, G)))
            if cfg.is_moe_layer(j):
                p.update(prefixed(f"{pre}/moe", layers.moe_init(gen, cfg, G)))
            else:
                p.update(prefixed(f"{pre}/mlp", layers.mlp_init(gen, cfg, G)))
        p.update(prefixed("final_norm", norm_init(cfg.norm, cfg.d_model)))
        if not cfg.tie_embeddings:
            p["head"] = common.dense(gen, cfg.d_model, cfg.vocab_size)
        return {k: gen.put(v) for k, v in p.items()}

    def init_params(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
                    dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        """``(params, logical axes)``, as the JAX package's."""
        return self.init(seed, draw_device=draw_device, dtype=dtype), \
            self.axes()

    def axes(self) -> Dict[str, Tuple]:
        """Each parameter's logical axes, one name per dim (the JAX
        package's ``Boxed`` tags)."""
        cfg = self.cfg
        a = prefixed("embed", layers.EMBEDDING_AXES)
        if cfg.vision is not None:
            a["vision_proj"] = (None, "embed")
        for j in range(self.group):
            pre = f"sub{j}"
            a.update(prefixed(f"{pre}/norm1", norm_axes(cfg.norm, 1)))
            a.update(prefixed(f"{pre}/attn", layers.attention_axes(cfg, 1)))
            a.update(prefixed(f"{pre}/norm2", norm_axes(cfg.norm, 1)))
            if cfg.is_moe_layer(j):
                a.update(prefixed(f"{pre}/moe", layers.moe_axes(cfg, 1)))
            else:
                a.update(prefixed(f"{pre}/mlp", layers.mlp_axes(cfg, 1)))
        a.update(prefixed("final_norm", norm_axes(cfg.norm)))
        if not cfg.tie_embeddings:
            a["head"] = ("embed", "vocab")
        return a

    # ------------------------------------------------------------- sub-layer
    def _block(self, p: Params, j: int, g: int, x: Tensor,
               positions: Tensor, cache: Optional[Params], cache_index
               ) -> Tuple[Tensor, Optional[Tensor]]:
        """Sub-layer ``j`` of layer group ``g`` (an index into ``p``'s
        stacked leaves): ``(x', its MoE aux loss or None)``."""
        cfg = self.cfg
        pre = f"sub{j}"
        h = apply_norm(sub_params(p, f"{pre}/norm1", g), x, cfg.norm,
                       cfg.norm_eps)
        layer_cache = None if cache is None else {
            "k": cache[f"{pre}/k"][g], "v": cache[f"{pre}/v"][g]}
        attn_out, _ = layers.attention_apply(
            sub_params(p, f"{pre}/attn", g), h, cfg,
            positions=positions,
            causal=True,
            window=cfg.sliding_window,
            impl=self.attention_impl,
            cache=layer_cache,
            cache_index=cache_index,
        )
        x = x + attn_out
        h = apply_norm(sub_params(p, f"{pre}/norm2", g), x, cfg.norm,
                       cfg.norm_eps)
        if cfg.is_moe_layer(j):
            out, aux = layers.moe_apply(sub_params(p, f"{pre}/moe", g), h, cfg)
            return x + out, aux
        return x + layers.mlp_apply(sub_params(p, f"{pre}/mlp", g), h,
                                    cfg), None

    def _groups(self, p: Params, n: int, x: Tensor, positions: Tensor,
                cache: Optional[Params], cache_index, aux):
        """The layer groups of ``p`` (its ``n`` rows of stacked leaves:
        all of them, or a segment's slice) in order; ``aux`` threads the
        MoE aux loss across them, gaining the last sub-layer's aux of
        each group, as the JAX package's group body does. With ``remat``
        (and gradients on) each group is checkpointed."""
        for g in range(n):
            if self.remat and cache is None and torch.is_grad_enabled():
                x, aux = common.checkpointed(self._group, p, g, x, positions,
                                             cache, cache_index, aux)
            else:
                x, aux = self._group(p, g, x, positions, cache, cache_index,
                                     aux)
        return x, aux

    def _group(self, p: Params, g: int, x: Tensor, positions: Tensor,
               cache: Optional[Params], cache_index, aux):
        for j in range(self.group):
            x, a = self._block(p, j, g, x, positions, cache, cache_index)
        if a is not None:
            aux = aux + a
        return x, aux

    # ---------------------------------------------------------------- fwd
    def forward(self, p: Params, tokens: Tensor, *,
                patches: Optional[Tensor] = None, mode: str = "train",
                cache: Optional[Params] = None,
                cache_index=None) -> Tuple[Tensor, Any, Optional[Params]]:
        """Returns (logits, moe_aux, cache); the cache is written in
        place. tokens: (B, S) integers. In decode mode S == 1 and
        ``cache_index`` is the write position. ``moe_aux`` is 0.0 for a
        model without MoE layers."""
        cfg = self.cfg
        x = self._embed(p, tokens, patches)
        b, s, _ = x.shape
        if mode == "decode":
            positions = torch.full((b, 1), int(cache_index),
                                   device=x.device)
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
            if cache is not None and cache_index is None:
                cache_index = 0
        x, aux = self._groups(p, self.n_groups, x, positions, cache,
                              cache_index, 0.0)
        x = apply_norm(sub_params(p, "final_norm"), x, cfg.norm, cfg.norm_eps)
        if patches is not None:  # the sequence whole (SP) for the cut
            x = whole(x, 1)[:, patches.shape[1]:, :]
        w = p["embed/table"] if cfg.tie_embeddings else p["head"]
        logits = layers.lm_head(w, x, cfg.tie_embeddings)
        return logits, aux, cache

    def _embed(self, p: Params, tokens: Tensor,
               patches: Optional[Tensor]) -> Tensor:
        """The token embeddings, after the projected patches if any."""
        x = layers.embed(sub_params(p, "embed"), tokens, self.compute_dtype)
        if patches is None:
            return x
        cd = self.compute_dtype
        pe = patches.to(cd) @ p["vision_proj"].to(cd)
        return torch.cat([pe, x], dim=1)

    # --------------------------------------------------------------- losses
    def loss_fn(self, p: Params, model_state: Dict, batch: Dict,
                label_smoothing: float = 0.0):
        """``(total, (model_state, {"loss", "moe_aux", "tokens"}))`` of a
        batch ``{"tokens", "targets"}`` (B, S) integers: the token-mean
        cross entropy of the train-mode forward, plus 0.01 x the MoE aux
        loss (0 without MoE layers)."""
        logits, moe_aux, _ = self.forward(
            p, batch["tokens"], patches=batch.get("patches"), mode="train")
        loss, n_tok = common.cross_entropy_loss(
            logits, batch["targets"], label_smoothing=label_smoothing)
        if is_dtensor(moe_aux):  # the GSPMD step: one value on every worker
            moe_aux = moe_aux.full_tensor()
        moe_aux = torch.as_tensor(moe_aux, dtype=torch.float32,
                                  device=loss.device)
        total = loss + 0.01 * moe_aux
        metrics = {"loss": loss.detach(), "moe_aux": moe_aux.detach(),
                   "tokens": n_tok}
        return total, (model_state, metrics)

    # ----------------------------------------------------- staged apply
    def _bounds(self) -> List[int]:
        n_lseg = max(1, min(self.comm_stages, self.n_groups))
        return [round(i * self.n_groups / n_lseg) for i in range(n_lseg + 1)]

    def segment_names(self) -> Tuple[str, ...]:
        """The staged loss's segments, forward order: ``embed``,
        ``layers{lo}_{hi}`` for each slice of at most ``comm_stages`` of
        the layer groups, ``head``."""
        b = self._bounds()
        return (("embed",) + tuple(f"layers{lo}_{hi}"
                                   for lo, hi in zip(b, b[1:])) + ("head",))

    def segment_trees(self, tree: Dict) -> List[Dict]:
        """A parameter-shaped dict cut into the staged loss's segments
        (forward order): the embedding (with a VLM's ``vision_proj``);
        rows ``[lo, hi)`` of every stacked leaf, keyed
        ``common.slice_key(lo, hi, name)`` (views: writing into one writes
        into its leaf); the final norm and the untied head. The JAX
        package's ``split_tree``."""
        b = self._bounds()
        stacked = [k for k in tree if k.startswith("sub")]
        segs = [{k: v for k, v in tree.items()
                 if k.startswith("embed/") or k == "vision_proj"}]
        for lo, hi in zip(b, b[1:]):
            segs.append(slice_views(tree, [slice_key(lo, hi, k)
                                           for k in stacked]))
        segs.append({k: v for k, v in tree.items()
                     if k.startswith("final_norm/") or k == "head"})
        return segs

    def loss_segments(self, p: Params, model_state: Dict, batch: Dict,
                      label_smoothing: float = 0.0) -> StagedLoss:
        """``loss_fn`` as chained segments (``segment_names``) over
        ``segment_trees(p)``, for the overlapped DP step: each layer
        segment runs its slice of the groups with the monolithic
        forward's ops. The carry is ``(x, moe_aux)``; with tied
        embeddings the table rides in it too, so each parameter leaf
        belongs to one segment and its two gradient contributions (the
        lookup and the head) meet in the embedding segment's backward.
        The JAX package's ``loss_segments``."""
        cfg = self.cfg
        tied = cfg.tie_embeddings
        tokens = batch["tokens"]
        patches = batch.get("patches")

        def embed_fn(sp, _x0):
            x = self._embed(sp, tokens, patches)
            carry = (x, torch.zeros((), dtype=torch.float32,
                                    device=x.device))
            if tied:
                carry += (sp["embed/table"],)
            return carry, None

        def make_layer_fn(lo: int, hi: int):
            cut = len(slice_key(lo, hi, ""))

            def layer_fn(sp, carry):
                x, aux = carry[0], carry[1]
                b, s, _ = x.shape
                positions = torch.arange(s, device=x.device)[None, :] \
                    .expand(b, s)
                x, aux = self._groups({k[cut:]: v for k, v in sp.items()},
                                      hi - lo, x, positions, None, None, aux)
                return (x, aux) + carry[2:], None
            return layer_fn

        def head_fn(sp, carry):
            x, moe_aux = carry[0], carry[1]
            x = apply_norm(sub_params(sp, "final_norm"), x, cfg.norm,
                           cfg.norm_eps)
            if patches is not None:
                x = x[:, patches.shape[1]:, :]
            w = carry[2] if tied else sp["head"]
            logits = layers.lm_head(w, x, tied)
            loss, n_tok = common.cross_entropy_loss(
                logits, batch["targets"], label_smoothing=label_smoothing)
            total = loss + 0.01 * moe_aux
            return total, ({}, {"loss": loss.detach(),
                                "moe_aux": moe_aux.detach(),
                                "tokens": n_tok})

        b = self._bounds()
        seg_fns = ((embed_fn,) + tuple(make_layer_fn(lo, hi)
                                       for lo, hi in zip(b, b[1:]))
                   + (head_fn,))

        def finalize_aux(auxes):
            return model_state, auxes[-1][1]

        return StagedLoss(names=self.segment_names(),
                          seg_params=tuple(self.segment_trees(p)),
                          seg_fns=seg_fns, x0=None,
                          finalize_aux=finalize_aux)

    # ---------------------------------------------------------------- serve
    def cache_shape(self, batch: int, max_seq: int, dtype=torch.bfloat16
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        """A zero KV cache on the model's device and its logical axes,
        one ``(G, B, S, KV, Dh)`` pair per sub-layer. SWA archs keep a
        ring buffer of the window's size only."""
        cfg = self.cfg
        s = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
            else max_seq
        shape = (self.n_groups, batch, s, cfg.n_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        vals = {f"sub{j}/{n}": torch.zeros(shape, dtype=dtype,
                                           device=self.device)
                for j in range(self.group) for n in ("k", "v")}
        return vals, {k: axes for k in vals}

    def prefill(self, p: Params, tokens: Tensor, cache: Params, *,
                patches: Optional[Tensor] = None) -> Tuple[Tensor, Params]:
        logits, _, new_cache = self.forward(
            p, tokens, patches=patches, mode="prefill", cache=cache,
            cache_index=0)
        return logits[:, -1:, :], new_cache

    def decode_step(self, p: Params, cache: Params, tokens: Tensor,
                    cache_index) -> Tuple[Tensor, Params]:
        logits, _, new_cache = self.forward(
            p, tokens, mode="decode", cache=cache, cache_index=cache_index)
        return logits, new_cache
