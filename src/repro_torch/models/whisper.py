"""Whisper-tiny encoder-decoder backbone. The conv/mel frontend is a stub:
the batch supplies precomputed frame embeddings (B, n_frames, frame_dim);
a learned projector lifts them to d_model and sinusoidal positions are
added (standing in for the conv stack).

The port of the JAX package's ``models/whisper.py``: the same parameter
tree, flattened to "/" paths (``frame_proj``, ``pos_dec``,
``enc/attn/wq``, ``dec/cross_attn/wq``, ``dec_norm/scale``, ...), each
stack's leaves on a leading layer dim, and the same op order. The
encoder's self-attention is non-causal without RoPE; the decoder adds
the learned ``pos_dec``, then per layer causal self-attention (with a KV
cache when serving), cross-attention to the encoder output (no cache)
and the MLP; the head is tied to ``embed/table``. The cache is
``{"kv/k", "kv/v": (L, B, S, KV, Dh), "enc_out": (B, n_frames, d)}``,
written in place: the prefill encodes the frames and keeps the encoder
output, and each decode step reads it there instead of encoding again.
Every norm is a LayerNorm; under ``chunked`` the encoder's, the decoder
prefill's and the cross attention of a prefill are the flash kernel (a
decode step's single query takes the naive path, as in the JAX
package).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import assign, placed_like
from repro_torch.models import common, layers
from repro_torch.models.common import (
    LeafDraw,
    apply_norm,
    norm_init,
    prefixed,
    sub_params,
)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

POS_DEC_ROWS = 32768


def _sinusoid(n: int, d: int, device=None) -> Tensor:
    pos = torch.arange(n, device=device)[:, None].to(torch.float32)
    dim = torch.arange(d // 2, device=device)[None, :].to(torch.float32)
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class WhisperModel:
    """The audio family: an encoder over the frames, a decoder with
    cross attention. ``remat`` checkpoints each encoder and decoder
    layer in training, as the JAX package's scan bodies."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 attention_impl: str = "chunked", *, remat: bool = False,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.device = resolve_device(device)

    def init(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
             dtype: Optional[torch.dtype] = None) -> Params:
        """Parameters by their JAX-tree paths, drawn leaf by leaf from
        ``seed`` on ``draw_device`` (``TransformerLM.init``)."""
        cfg = self.cfg
        gen = LeafDraw.from_seed(seed, draw_device, self.device, dtype)
        enc_l, dec_l, d = cfg.n_encoder_layers, cfg.n_layers, cfg.d_model
        p: Params = {"frame_proj": common.dense(gen, cfg.audio.frame_dim, d)}
        p.update(prefixed("embed", layers.embedding_init(gen, cfg)))
        # whisper caps at 448 positions; sized as the JAX package's
        p["pos_dec"] = common.normal_init(gen, (POS_DEC_ROWS, d), 0.01)
        p.update(prefixed("enc/norm1", norm_init(cfg.norm, d, enc_l)))
        p.update(prefixed("enc/attn", layers.attention_init(gen, cfg, enc_l)))
        p.update(prefixed("enc/norm2", norm_init(cfg.norm, d, enc_l)))
        p.update(prefixed("enc/mlp", layers.mlp_init(gen, cfg, enc_l)))
        p.update(prefixed("enc_norm", norm_init(cfg.norm, d)))
        p.update(prefixed("dec/norm1", norm_init(cfg.norm, d, dec_l)))
        p.update(prefixed("dec/self_attn",
                          layers.attention_init(gen, cfg, dec_l)))
        p.update(prefixed("dec/norm_x", norm_init(cfg.norm, d, dec_l)))
        p.update(prefixed("dec/cross_attn",
                          layers.attention_init(gen, cfg, dec_l)))
        p.update(prefixed("dec/norm2", norm_init(cfg.norm, d, dec_l)))
        p.update(prefixed("dec/mlp", layers.mlp_init(gen, cfg, dec_l)))
        p.update(prefixed("dec_norm", norm_init(cfg.norm, d)))
        return {k: gen.put(v) for k, v in p.items()}

    def init_params(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
                    dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        return self.init(seed, draw_device=draw_device, dtype=dtype), \
            self.axes()

    def axes(self) -> Dict[str, Tuple]:
        """Each parameter's logical axes (the JAX package's)."""
        cfg = self.cfg
        a = {"frame_proj": (None, "embed"), "pos_dec": ("seq", "embed")}
        a.update(prefixed("embed", layers.EMBEDDING_AXES))
        for stack, parts in (
                ("enc", (("norm1", None), ("attn", 1), ("norm2", None),
                         ("mlp", 2))),
                ("dec", (("norm1", None), ("self_attn", 1),
                         ("norm_x", None), ("cross_attn", 1),
                         ("norm2", None), ("mlp", 2)))):
            for name, kind in parts:
                sub = (common.norm_axes(cfg.norm, 1) if kind is None else
                       layers.attention_axes(cfg, 1) if kind == 1 else
                       layers.mlp_axes(cfg, 1))
                a.update(prefixed(f"{stack}/{name}", sub))
        a.update(prefixed("enc_norm", common.norm_axes(cfg.norm)))
        a.update(prefixed("dec_norm", common.norm_axes(cfg.norm)))
        return a

    def _remat(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return common.checkpointed(fn, *args)
        return fn(*args)

    # ----------------------------------------------------------- encoder
    def encode(self, p: Params, frames: Tensor) -> Tensor:
        cfg, cd = self.cfg, self.compute_dtype
        x = frames.to(cd) @ p["frame_proj"].to(cd)
        pos = _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        x = x + placed_like(pos, x, {})  # a DTensor x: replicated
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[:2])
        for i in range(cfg.n_encoder_layers):
            # the layer's weights read (an FSDP gather) inside its
            # checkpoint
            x = self._remat(lambda p, i, *a: self._enc_block(
                sub_params(p, "enc", i), *a), p, i, x, positions)
        return apply_norm(sub_params(p, "enc_norm"), x, cfg.norm,
                          cfg.norm_eps)

    def _enc_block(self, lp: Params, x: Tensor, positions: Tensor) -> Tensor:
        cfg = self.cfg
        h = apply_norm(sub_params(lp, "norm1"), x, cfg.norm, cfg.norm_eps)
        a, _ = layers.attention_apply(
            sub_params(lp, "attn"), h, cfg, positions=positions,
            causal=False, impl=self.attention_impl, use_rope=False)
        x = x + a
        h = apply_norm(sub_params(lp, "norm2"), x, cfg.norm, cfg.norm_eps)
        return x + layers.mlp_apply(sub_params(lp, "mlp"), h, cfg)

    # ----------------------------------------------------------- decoder
    def decode(self, p: Params, tokens: Tensor, enc_out: Tensor, *,
               mode: str = "train", cache: Optional[Params] = None,
               cache_index=None) -> Tensor:
        cfg = self.cfg
        x = layers.embed(sub_params(p, "embed"), tokens, self.compute_dtype)
        b, s, _ = x.shape
        if mode == "decode":
            idx = int(cache_index)
            positions = torch.full((b, 1), idx, device=x.device)
            pos_emb = p["pos_dec"][idx:idx + 1].to(x.dtype)[None]
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
            pos_emb = p["pos_dec"][:s].to(x.dtype)[None]
        x = x + pos_emb
        enc_positions = torch.arange(enc_out.shape[1], device=x.device)[
            None].expand(enc_out.shape[:2])
        for i in range(cfg.n_layers):
            if cache is None:
                x = self._remat(lambda p, i, *a: self._dec_block(
                    sub_params(p, "dec", i), *a), p, i, x, positions,
                    enc_out, enc_positions, None, cache_index)
            else:
                x = self._dec_block(sub_params(p, "dec", i), x, positions,
                                    enc_out, enc_positions,
                                    {"k": cache["kv/k"][i],
                                     "v": cache["kv/v"][i]}, cache_index)
        x = apply_norm(sub_params(p, "dec_norm"), x, cfg.norm, cfg.norm_eps)
        return layers.lm_head(p["embed/table"], x, tied=True)

    def _dec_block(self, lp: Params, x: Tensor, positions: Tensor,
                   enc_out: Tensor, enc_positions: Tensor,
                   c: Optional[Params], cache_index) -> Tensor:
        cfg = self.cfg
        h = apply_norm(sub_params(lp, "norm1"), x, cfg.norm, cfg.norm_eps)
        a, _ = layers.attention_apply(
            sub_params(lp, "self_attn"), h, cfg, positions=positions,
            causal=True, impl=self.attention_impl, cache=c,
            cache_index=cache_index, use_rope=False)
        x = x + a
        h = apply_norm(sub_params(lp, "norm_x"), x, cfg.norm, cfg.norm_eps)
        a, _ = layers.attention_apply(
            sub_params(lp, "cross_attn"), h, cfg, positions=positions,
            kv_x=enc_out, kv_positions=enc_positions,
            impl=self.attention_impl, use_rope=False)
        x = x + a
        h = apply_norm(sub_params(lp, "norm2"), x, cfg.norm, cfg.norm_eps)
        return x + layers.mlp_apply(sub_params(lp, "mlp"), h, cfg)

    # ------------------------------------------------------------- api
    def forward(self, p: Params, tokens: Tensor, *,
                frames: Optional[Tensor] = None, mode: str = "train",
                cache: Optional[Params] = None, cache_index=None
                ) -> Tuple[Tensor, float, Optional[Params]]:
        """Returns (logits, 0.0, cache); the cache is written in place. A
        decode step reads the encoder output from the cache."""
        if cache is not None and mode == "decode":
            enc_out = cache["enc_out"].to(self.compute_dtype)
        else:
            enc_out = self.encode(p, frames)
            if cache is not None:
                assign(cache["enc_out"], enc_out)
        logits = self.decode(p, tokens, enc_out, mode=mode, cache=cache,
                             cache_index=cache_index)
        return logits, 0.0, cache

    def loss_fn(self, p: Params, model_state: Dict, batch: Dict,
                label_smoothing: float = 0.0):
        """``(loss, (model_state, {"loss", "tokens"}))``: the token-mean
        cross entropy of the train-mode forward on ``batch["frames"]``."""
        logits, _, _ = self.forward(p, batch["tokens"],
                                    frames=batch["frames"], mode="train")
        loss, n_tok = common.cross_entropy_loss(
            logits, batch["targets"], label_smoothing=label_smoothing)
        return loss, (model_state, {"loss": loss.detach(), "tokens": n_tok})

    def cache_shape(self, batch: int, max_seq: int, dtype=torch.bfloat16
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        cfg = self.cfg
        kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        shapes = {"kv/k": (kv, kv_axes), "kv/v": (kv, kv_axes),
                  "enc_out": ((batch, cfg.audio.num_frames, cfg.d_model),
                              ("batch", "seq", "embed"))}
        vals = {k: torch.zeros(s, dtype=dtype, device=self.device)
                for k, (s, _) in shapes.items()}
        return vals, {k: a for k, (_, a) in shapes.items()}

    def prefill(self, p: Params, tokens: Tensor, cache: Params, *,
                frames: Optional[Tensor] = None) -> Tuple[Tensor, Params]:
        logits, _, new_cache = self.forward(
            p, tokens, frames=frames, mode="prefill", cache=cache,
            cache_index=0)
        return logits[:, -1:, :], new_cache

    def decode_step(self, p: Params, cache: Params, tokens: Tensor,
                    cache_index) -> Tuple[Tensor, Params]:
        logits, _, new_cache = self.forward(
            p, tokens, mode="decode", cache=cache, cache_index=cache_index)
        return logits, new_cache
