"""Mamba2 blocks and the Zamba2-style hybrid model (zamba2-7b).

Zamba2: a backbone of Mamba2 blocks with a small set of *shared*
(attention + MLP) transformer blocks cycled in every ``shared_attn_every``
layers. Each shared application takes concat(hidden, initial_embedding)
through a learned 2d->d projection (the Zamba "shared transformer"
pattern), so the shared weights are reused with fresh inputs.

The port of the JAX package's ``models/mamba.py``: the same parameter
tree, flattened to "/" paths (``mamba/w_in``, ``mamba/norm/scale``,
``shared0/concat_proj``, ``shared0/attn/wq``, ...), the mamba leaves
stacked on a leading layer dim, and the same op order. In serve mode the
shared attention uses a sliding window (``SHARED_ATTN_SERVE_WINDOW``)
over a ring cache of ``min(max_seq, window)`` positions, so the decode
state stays O(window); training attends causally over the whole
sequence. The cache is ``{"conv": (L, B, W-1, conv_ch), "ssm": (L, B, H,
Dh, N) f32, "attn/k", "attn/v": (G, B, window, KV, Dh)}``, written in
place. Every norm site of the model is an RMSNorm (the rmsnorm kernel);
the shared blocks' attention is the flash kernel under ``chunked``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (
    assign,
    constrain,
    heads_placements,
    is_dtensor,
    local_apply,
    placed_like,
    relaid,
    remap,
    split_whole,
    whole,
)
from repro_torch.models import common, layers, ssd
from repro_torch.models.common import (
    LeafDraw,
    apply_norm,
    norm_init,
    prefixed,
    sub_params,
)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

SHARED_ATTN_SERVE_WINDOW = 4096


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state
    return d_in, n_heads, conv_ch


def mamba2_init(gen: LeafDraw, cfg: ModelConfig, stacked: int = 0) -> Params:
    d = cfg.d_model
    d_in, n_h, conv_ch = mamba2_dims(cfg)
    L = (stacked,) if stacked else ()
    p: Params = prefixed("norm", norm_init(cfg.norm, d, stacked))
    p.update({
        # in_proj -> [z(d_in), x(d_in), B(ds), C(ds), dt(n_h)]
        "w_in": common.fan_in_init(
            gen, L + (d, 2 * d_in + 2 * cfg.ssm_state + n_h), (-2,)),
        "conv_w": common.normal_init(gen, L + (cfg.ssm_conv_width, conv_ch),
                                     0.1),
        "conv_b": torch.zeros(L + (conv_ch,)),
        "A_log": torch.zeros(L + (n_h,)),
        "dt_bias": torch.zeros(L + (n_h,)),
        "D": torch.ones(L + (n_h,)),
    })
    p.update(prefixed("out_norm", norm_init("rmsnorm", d_in, stacked)))
    p["w_out"] = common.fan_in_init(gen, L + (d_in, d), (-2,))
    return p


def _split_in(cfg: ModelConfig, proj: Tensor):
    """``[z | x | B | C | dt]`` -> (z, xBC, dt), the packed projection
    made whole first (``split_whole``)."""
    d_in, n_h, conv_ch = mamba2_dims(cfg)
    return split_whole(proj, (d_in, conv_ch, n_h))


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv along seq. xbc: (B,S,C); w: (W,C).

    Returns (silu(out), new_state) where state holds the last W-1
    inputs."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i].to(xbc.dtype)
              for i in range(width)) + b.to(xbc.dtype)
    new_state = xp[:, -(width - 1):, :]
    return F.silu(out), new_state


def _ssm_heads(xs: Tensor, B: Tensor, C: Tensor, dt: Tensor,
               dt_bias: Tensor, A_log: Tensor, D: Tensor,
               ssm_state: Optional[Tensor], dh: int, decode: bool
               ) -> Tuple[Tensor, Tensor]:
    """The SSD recurrence of some heads: ``xs`` (B, S, H * dh) their
    inputs, ``B`` / ``C`` (B, S, ds) shared by every head, ``dt`` (B, S,
    H) before its softplus. Returns (y (B, S, H * dh) with the skip
    ``D * x``, the final state (B, H, dh, ds) f32)."""
    b, s, _ = xs.shape
    n_h, ds = dt.shape[-1], B.shape[-1]
    dt = softplus(dt.float() + dt_bias)  # (B,S,H)
    a = -torch.exp(A_log.float())  # (H,) negative
    log_decay = dt * a  # (B,S,H)

    xh = xs.reshape(b, s, n_h, dh)
    xbar = xh * dt[..., None].to(xs.dtype)
    # B/C shared across heads (single group)
    Bh = B[:, :, None, :].expand(b, s, n_h, ds)
    Ch = C[:, :, None, :].expand(b, s, n_h, ds)

    if decode:
        y, new_ssm = ssd.gla_decode_step(
            Ch[:, 0], Bh[:, 0], xbar[:, 0], log_decay[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, new_ssm = ssd.chunked_gla(
            Ch, Bh, xbar, log_decay, initial_state=ssm_state)
    y = y + xh * D.to(xs.dtype)[None, None, :, None]
    return y.reshape(b, s, n_h * dh), new_ssm


def mamba2_apply(p: Params, x: Tensor, cfg: ModelConfig,
                 conv_state: Optional[Tensor] = None,
                 ssm_state: Optional[Tensor] = None,
                 decode: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out, new_conv_state, new_ssm_state).

    On DTensors (the GSPMD steps, "inner" on the model axis) the packed
    projection ``[z | x | B | C | dt]`` is gathered whole once (its
    columns are cut inside ``x``, as the parameter's are), the depthwise
    conv runs on every channel (``conv_w`` / ``conv_b`` gathered: they
    pack ``[x | B | C]``), and the recurrence (``_ssm_heads``) runs on
    each worker's heads (``local_apply``), B and C whole. The gated
    output is gathered whole again before ``out_norm``, an RMSNorm over
    ``d_in``, and the row-parallel ``w_out`` leaves a Partial sum that
    the output's ``constrain`` reduces."""
    d_in, n_h, _ = mamba2_dims(cfg)
    ds = cfg.ssm_state
    x = whole(x, 1)  # sequence parallelism: the scan's sequence whole
    h_res = apply_norm(sub_params(p, "norm"), x, cfg.norm, cfg.norm_eps)
    proj = h_res @ p["w_in"].to(x.dtype)
    z, xbc, dt = _split_in(cfg, proj)
    pl = tuple(xbc.placements) if is_dtensor(xbc) else None
    xbc, new_conv = local_apply(
        _causal_conv, xbc, whole(p["conv_w"], -1), whole(p["conv_b"], -1),
        whole(conv_state, -1), outs=None if pl is None else (pl, pl))
    xs, B, C = split_whole(xbc, (d_in, ds, ds))

    heads = None
    if is_dtensor(x):  # each worker's heads (B and C stay whole)
        heads = heads_placements(x, n_h, "inner")
        xs, dt, z = (relaid(t, x.device_mesh, heads) for t in (xs, dt, z))
    hp = {2: 0}
    y, new_ssm = local_apply(
        _ssm_heads, xs, B, C, dt, *(placed_like(p[k], dt, hp)
                                    for k in ("dt_bias", "A_log", "D")),
        placed_like(ssm_state, dt, {0: 0, 2: 1}), cfg.ssm_head_dim, decode,
        outs=None if heads is None else (heads, remap(heads, {0: 0, 2: 1})))
    y = whole(y * F.silu(z), -1)  # the norm's rows whole
    y = apply_norm(sub_params(p, "out_norm"), y, "rmsnorm", cfg.norm_eps)
    if heads is not None:  # the row-parallel product's input, cut
        y = relaid(y, x.device_mesh, heads)
    out = y @ p["w_out"].to(x.dtype)
    return constrain(out, ("batch", "seq", "embed")), new_conv, new_ssm


def mamba2_axes(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Tuple]:
    """The logical axes of ``mamba2_init``'s leaves."""
    L = common.layer_axes(stacked)
    a = prefixed("norm", common.norm_axes(cfg.norm, stacked))
    a.update({"w_in": L + ("embed", "inner"),
              "conv_w": L + ("conv_spatial", "inner"),
              "conv_b": L + ("inner",), "A_log": L + ("ssm_heads",),
              "dt_bias": L + ("ssm_heads",), "D": L + ("ssm_heads",),
              "w_out": L + ("inner", "embed")})
    a.update(prefixed("out_norm", common.norm_axes("rmsnorm", stacked)))
    return a


# ---------------------------------------------------------------------------
# Zamba2 hybrid model
# ---------------------------------------------------------------------------


def shared_block_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    a = {"concat_proj": ("embed", "embed")}
    a.update(prefixed("norm1", common.norm_axes(cfg.norm)))
    a.update(prefixed("attn", layers.attention_axes(cfg)))
    a.update(prefixed("norm2", common.norm_axes(cfg.norm)))
    a.update(prefixed("mlp", layers.mlp_axes(cfg)))
    return a


def shared_block_init(gen: LeafDraw, cfg: ModelConfig) -> Params:
    p: Params = {"concat_proj": common.dense(gen, 2 * cfg.d_model,
                                             cfg.d_model)}
    p.update(prefixed("norm1", norm_init(cfg.norm, cfg.d_model)))
    p.update(prefixed("attn", layers.attention_init(gen, cfg)))
    p.update(prefixed("norm2", norm_init(cfg.norm, cfg.d_model)))
    p.update(prefixed("mlp", layers.mlp_init(gen, cfg)))
    return p


class Zamba2Model:
    """The hybrid family. ``forward`` runs ``n_layers // shared_attn_every``
    groups of mamba layers, each followed by shared block ``g %
    n_shared_attn_blocks``, then the tail of mamba layers without one
    (zamba2-7b: 13 groups of 6, a tail of 3). ``remat`` checkpoints
    each mamba layer in training, as the JAX package's scan body."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 attention_impl: str = "chunked", *, remat: bool = False,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.device = resolve_device(device)
        k = cfg.shared_attn_every
        self.n_full_groups = cfg.n_layers // k  # groups ending in shared attn
        self.tail = cfg.n_layers - self.n_full_groups * k

    def init(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
             dtype: Optional[torch.dtype] = None) -> Params:
        """Parameters by their JAX-tree paths, drawn leaf by leaf from
        ``seed`` on ``draw_device`` (``TransformerLM.init``)."""
        cfg = self.cfg
        gen = LeafDraw.from_seed(seed, draw_device, self.device, dtype)
        p: Params = prefixed("embed", layers.embedding_init(gen, cfg))
        p.update(prefixed("mamba", mamba2_init(gen, cfg, cfg.n_layers)))
        p.update(prefixed("final_norm", norm_init(cfg.norm, cfg.d_model)))
        p["head"] = common.dense(gen, cfg.d_model, cfg.vocab_size)
        for j in range(cfg.n_shared_attn_blocks):
            p.update(prefixed(f"shared{j}", shared_block_init(gen, cfg)))
        return {k: gen.put(v) for k, v in p.items()}

    def init_params(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
                    dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        return self.init(seed, draw_device=draw_device, dtype=dtype), \
            self.axes()

    def axes(self) -> Dict[str, Tuple]:
        """Each parameter's logical axes (the JAX package's)."""
        cfg = self.cfg
        a = prefixed("embed", layers.EMBEDDING_AXES)
        a.update(prefixed("mamba", mamba2_axes(cfg, cfg.n_layers)))
        a.update(prefixed("final_norm", common.norm_axes(cfg.norm)))
        a["head"] = ("embed", "vocab")
        for j in range(cfg.n_shared_attn_blocks):
            a.update(prefixed(f"shared{j}", shared_block_axes(cfg)))
        return a

    def _mamba_span(self, p: Params, x: Tensor, lo: int, hi: int,
                    cache: Optional[Params], decode: bool) -> Tensor:
        """Mamba layers [lo, hi) in order; their cache rows are written
        in place."""
        for i in range(lo, hi):
            conv_c = ssm_c = None
            if cache is not None:
                conv_c, ssm_c = cache["conv"][i], cache["ssm"][i]
            if self.remat and cache is None and torch.is_grad_enabled():
                # the layer's weights read (an FSDP gather) inside the
                # checkpoint: the recompute reads them again
                out, nc, ns = common.checkpointed(
                    lambda p, i, *a: mamba2_apply(sub_params(p, "mamba", i),
                                                  *a),
                    p, i, x, self.cfg, conv_c, ssm_c, decode)
            else:
                out, nc, ns = mamba2_apply(sub_params(p, "mamba", i), x,
                                           self.cfg, conv_c, ssm_c,
                                           decode=decode)
            x = x + out
            if cache is not None:
                assign(cache["conv"][i], nc)
                assign(cache["ssm"][i], ns)
        return x

    def _shared(self, p: Params, g: int, x: Tensor, emb0: Tensor,
                positions: Tensor, cache: Optional[Params], cache_index,
                window: Optional[int]) -> Tensor:
        cfg = self.cfg
        sp = sub_params(p, f"shared{g % cfg.n_shared_attn_blocks}")
        h = torch.cat([x, emb0], dim=-1) @ sp["concat_proj"].to(x.dtype)
        h = apply_norm(sub_params(sp, "norm1"), h, cfg.norm, cfg.norm_eps)
        attn_cache = None if cache is None else {
            "k": cache["attn/k"][g], "v": cache["attn/v"][g]}
        attn_out, _ = layers.attention_apply(
            sub_params(sp, "attn"), h, cfg, positions=positions,
            causal=True, window=window, impl=self.attention_impl,
            cache=attn_cache, cache_index=cache_index)
        x = x + attn_out
        h = apply_norm(sub_params(sp, "norm2"), x, cfg.norm, cfg.norm_eps)
        return x + layers.mlp_apply(sub_params(sp, "mlp"), h, cfg)

    def forward(self, p: Params, tokens: Tensor, *, mode: str = "train",
                cache: Optional[Params] = None, cache_index=None
                ) -> Tuple[Tensor, float, Optional[Params]]:
        """Returns (logits, 0.0, cache); the cache is written in place."""
        cfg = self.cfg
        k = cfg.shared_attn_every
        x = layers.embed(sub_params(p, "embed"), tokens, self.compute_dtype)
        emb0 = x
        b, s, _ = x.shape
        decode = mode == "decode"
        if decode:
            positions = torch.full((b, 1), int(cache_index), device=x.device)
        else:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        window = None if mode == "train" else SHARED_ATTN_SERVE_WINDOW
        for g in range(self.n_full_groups):
            x = self._mamba_span(p, x, g * k, (g + 1) * k, cache, decode)
            x = self._shared(p, g, x, emb0, positions, cache, cache_index,
                             window)
        if self.tail:
            x = self._mamba_span(p, x, self.n_full_groups * k, cfg.n_layers,
                                 cache, decode)
        x = apply_norm(sub_params(p, "final_norm"), x, cfg.norm,
                       cfg.norm_eps)
        logits = layers.lm_head(p["head"], x, tied=False)
        return logits, 0.0, cache

    def loss_fn(self, p: Params, model_state: Dict, batch: Dict,
                label_smoothing: float = 0.0):
        """``(loss, (model_state, {"loss", "tokens"}))``: the token-mean
        cross entropy of the train-mode forward."""
        logits, _, _ = self.forward(p, batch["tokens"], mode="train")
        loss, n_tok = common.cross_entropy_loss(
            logits, batch["targets"], label_smoothing=label_smoothing)
        return loss, (model_state, {"loss": loss.detach(), "tokens": n_tok})

    def cache_shape(self, batch: int, max_seq: int, dtype=torch.bfloat16
                    ) -> Tuple[Params, Dict[str, Tuple]]:
        cfg = self.cfg
        _, n_h, conv_ch = mamba2_dims(cfg)
        attn_window = min(max_seq, SHARED_ATTN_SERVE_WINDOW)
        L, G = cfg.n_layers, self.n_full_groups
        kv = (G, batch, attn_window, cfg.n_kv_heads, cfg.head_dim)
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        shapes = {
            "conv": ((L, batch, cfg.ssm_conv_width - 1, conv_ch),
                     ("layers", "batch", None, "inner"), dtype),
            "ssm": ((L, batch, n_h, cfg.ssm_head_dim, cfg.ssm_state),
                    ("layers", "batch", "ssm_heads", None, None),
                    torch.float32),
            "attn/k": (kv, kv_axes, dtype),
            "attn/v": (kv, kv_axes, dtype),
        }
        vals = {k: torch.zeros(s, dtype=dt, device=self.device)
                for k, (s, _, dt) in shapes.items()}
        return vals, {k: a for k, (_, a, _) in shapes.items()}

    def prefill(self, p: Params, tokens: Tensor, cache: Params, **_
                ) -> Tuple[Tensor, Params]:
        logits, _, new_cache = self.forward(
            p, tokens, mode="prefill", cache=cache, cache_index=0)
        return logits[:, -1:, :], new_cache

    def decode_step(self, p: Params, cache: Params, tokens: Tensor,
                    cache_index) -> Tuple[Tensor, Params]:
        logits, _, new_cache = self.forward(
            p, tokens, mode="decode", cache=cache, cache_index=cache_index)
        return logits, new_cache
