"""Decoder-only transformer LM, the dense family (llama3.2-1b, yi-9b,
granite-34b, qwen2-72b).

The port of the JAX package's ``models/transformer.py`` for
``family="dense"``: the same parameter tree, flattened to "/" paths
(``embed/table``, ``sub0/norm1/scale``, ``sub0/attn/wq``, ...,
``final_norm/scale``), with the layer params stacked on a leading
``L`` dim; ``forward`` loops over that dim where the JAX package scans
it. The KV cache is ``{"sub0/k", "sub0/v"}``, each ``(L, B, S, KV,
Dh)``, written in place by ``prefill`` and ``decode_step``.

``loss_fn`` is the training loss (token-mean cross entropy in f32);
the staged loss of the overlapped step (``loss_segments``), MoE configs
and the VLM patch frontend are not ported yet (ROADMAP queue 1, items
15.2 and 15.3-15.4). The JAX package rematerializes the layer scan of a
model of more than 8 layers; the port keeps every activation, which
gives the same values.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, layers
from repro_torch.models.common import apply_norm, norm_init

Tensor = torch.Tensor
Params = Dict[str, Tensor]

ATTENTION_IMPLS = ("naive", "chunked", "chunked_opt")


def _flat(prefix: str, tree: Dict[str, Tensor]) -> Params:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


class TransformerLM:
    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 attention_impl: str = "chunked", *,
                 device: DeviceLike = "cuda"):
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue "
                "1, item 15.3)")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {attention_impl!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.device = resolve_device(device)
        self.n_groups = cfg.n_layers  # one layer per group: no MoE groups

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, *, draw_device: DeviceLike = "cpu"
             ) -> Params:
        """Parameters by their JAX-tree paths, drawn from ``seed`` on
        ``draw_device`` (the CPU: the same weights for every model
        device) and moved to the model's device. Drawing on the card
        gives other values and spares the host a copy of the weights
        (35 GB in f32 at yi-9b's size)."""
        cfg = self.cfg
        gen = torch.Generator(device=resolve_device(draw_device)
                              ).manual_seed(seed)
        L = self.n_groups
        p: Params = _flat("embed", layers.embedding_init(gen, cfg))
        p.update(_flat("sub0/norm1", norm_init(cfg.norm, cfg.d_model, L)))
        p.update(_flat("sub0/attn", layers.attention_init(gen, cfg, L)))
        p.update(_flat("sub0/norm2", norm_init(cfg.norm, cfg.d_model, L)))
        p.update(_flat("sub0/mlp", layers.mlp_init(gen, cfg, L)))
        p.update(_flat("final_norm", norm_init(cfg.norm, cfg.d_model)))
        if not cfg.tie_embeddings:
            p["head"] = common.dense(gen, cfg.d_model, cfg.vocab_size)
        return {k: v.to(self.device) for k, v in p.items()}

    def init_params(self, seed: int = 0, *, draw_device: DeviceLike = "cpu"
                    ) -> Tuple[Params, None]:
        """``(params, None)``: the JAX package returns its logical-axes
        tree second; the port shards nothing yet."""
        return self.init(seed, draw_device=draw_device), None

    # ------------------------------------------------------------- sub-layer
    def _block(self, p: Params, layer: int, x: Tensor, positions: Tensor,
               cache: Optional[Params], cache_index) -> Tensor:
        cfg = self.cfg
        h = apply_norm(_sub(p, "sub0/norm1", layer), x, cfg.norm,
                       cfg.norm_eps)
        layer_cache = None if cache is None else {
            "k": cache["sub0/k"][layer], "v": cache["sub0/v"][layer]}
        attn_out, _ = layers.attention_apply(
            _sub(p, "sub0/attn", layer), h, cfg,
            positions=positions,
            causal=True,
            window=cfg.sliding_window,
            impl=self.attention_impl,
            cache=layer_cache,
            cache_index=cache_index,
        )
        x = x + attn_out
        h = apply_norm(_sub(p, "sub0/norm2", layer), x, cfg.norm,
                       cfg.norm_eps)
        return x + layers.mlp_apply(_sub(p, "sub0/mlp", layer), h, cfg)

    # ---------------------------------------------------------------- fwd
    def forward(self, p: Params, tokens: Tensor, *,
                patches: Optional[Tensor] = None, mode: str = "train",
                cache: Optional[Params] = None,
                cache_index=None) -> Tuple[Tensor, Any, Optional[Params]]:
        """Returns (logits, moe_aux, cache); the cache is written in
        place. tokens: (B, S) integers. In decode mode S == 1 and
        ``cache_index`` is the write position."""
        if patches is not None:
            raise NotImplementedError(
                "the VLM patch frontend is not ported yet (ROADMAP queue 1, "
                "item 15.4)")
        cfg = self.cfg
        x = layers.embed(_sub(p, "embed"), tokens, self.compute_dtype)
        b, s, _ = x.shape
        if mode == "decode":
            positions = torch.full((b, 1), int(cache_index),
                                   device=x.device)
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
            if cache is not None and cache_index is None:
                cache_index = 0
        for layer in range(self.n_groups):
            x = self._block(p, layer, x, positions, cache, cache_index)
        x = apply_norm(_sub(p, "final_norm"), x, cfg.norm, cfg.norm_eps)
        w = p["embed/table"] if cfg.tie_embeddings else p["head"]
        logits = layers.lm_head(w, x, cfg.tie_embeddings)
        return logits, 0.0, cache

    # --------------------------------------------------------------- losses
    def loss_fn(self, p: Params, model_state: Dict, batch: Dict,
                label_smoothing: float = 0.0):
        """``(total, (model_state, {"loss", "moe_aux", "tokens"}))`` of a
        batch ``{"tokens", "targets"}`` (B, S) integers: the token-mean
        cross entropy of the train-mode forward, plus 0.01 x the MoE aux
        loss, which is 0 for the dense family."""
        logits, moe_aux, _ = self.forward(
            p, batch["tokens"], patches=batch.get("patches"), mode="train")
        loss, n_tok = common.cross_entropy_loss(
            logits, batch["targets"], label_smoothing=label_smoothing)
        moe_aux = torch.as_tensor(moe_aux, dtype=torch.float32,
                                  device=loss.device)
        total = loss + 0.01 * moe_aux
        metrics = {"loss": loss.detach(), "moe_aux": moe_aux,
                   "tokens": n_tok}
        return total, (model_state, metrics)

    def loss_segments(self, p: Params, model_state: Dict, batch: Dict,
                      label_smoothing: float = 0.0):
        raise NotImplementedError(
            "the staged LM loss (loss_segments, for the overlapped "
            "data-parallel step) is not ported yet (ROADMAP queue 1, item "
            "15.2)")

    # ---------------------------------------------------------------- serve
    def cache_shape(self, batch: int, max_seq: int, dtype=torch.bfloat16
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        """A zero KV cache on the model's device and its logical axes.
        SWA archs keep a ring buffer of the window's size only."""
        cfg = self.cfg
        s = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
            else max_seq
        shape = (self.n_groups, batch, s, cfg.n_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        vals = {f"sub0/{n}": torch.zeros(shape, dtype=dtype,
                                         device=self.device)
                for n in ("k", "v")}
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


def _sub(p: Params, prefix: str, layer: Optional[int] = None) -> Params:
    """The params under ``prefix`` by their names below it (``sub0/attn``
    -> ``{"wq": ..., ...}``); layer ``layer``'s slice of stacked ones."""
    cut = len(prefix) + 1
    return {k[cut:]: v if layer is None else v[layer]
            for k, v in p.items() if k.startswith(prefix + "/")}
