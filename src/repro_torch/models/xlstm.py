"""xLSTM: mLSTM (matrix memory, parallelizable) + sLSTM (scalar memory,
sequential) blocks in a ``slstm_every`` pattern (7:1 for xlstm-350m).

The port of the JAX package's ``models/xlstm.py``: the same parameter
tree, flattened to "/" paths (``mlstm/w_up``, ``mlstm/norm/scale``,
``slstm/r_gates``, ...), each block's leaves stacked on a leading layer
dim, and the same op order.

mLSTM is gated linear attention with an exponential input gate and a
normalizer n, run on the chunked GLA engine (``ssd.py``) with v
augmented by a ones channel: the state carries [i*v; i], so one readout
gives numerator and denominator. sLSTM has a recurrent nonlinearity: a
sequential loop over time in f32 with the stabilized exponential-gate
formulation, its recurrent weights block-diagonal per head.

The cache is ``{"conv": (n_mlstm, B, 3, d_in), "gla": (n_mlstm, B, H,
Dh + 1, Dh) f32, "slstm/h", "slstm/c", "slstm/n", "slstm/m": (n_seg, B,
H, d / H) f32}``, written in place. The mLSTM ``out_norm`` is an RMSNorm
(the rmsnorm kernel); xlstm-350m's other norms are LayerNorms.
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
from repro_torch.models.mamba import _causal_conv

Tensor = torch.Tensor
Params = Dict[str, Tensor]

CONV_W = 4
SLSTM_STATE = ("h", "c", "n", "m")


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.d_model * cfg.mlstm_proj_factor)
    n_h = cfg.n_heads
    return d_in, n_h, d_in // n_h


def mlstm_init(gen: LeafDraw, cfg: ModelConfig, stacked: int = 0) -> Params:
    d = cfg.d_model
    d_in, n_h, dh = _mlstm_dims(cfg)
    L = (stacked,) if stacked else ()

    def headwise():  # block-diagonal per-head projection
        return common.fan_in_init(gen, L + (n_h, dh, dh), (-2,))

    p: Params = prefixed("norm", norm_init(cfg.norm, d, stacked))
    p["w_up"] = common.fan_in_init(gen, L + (d, 2 * d_in), (-2,))
    p["conv_w"] = common.normal_init(gen, L + (CONV_W, d_in), 0.1)
    p["conv_b"] = torch.zeros(L + (d_in,))
    p["wq"], p["wk"], p["wv"] = headwise(), headwise(), headwise()
    p["w_if"] = common.fan_in_init(gen, L + (d_in, 2 * n_h), (-2,))
    # input-gate bias 0, forget-gate bias +3 (standard xLSTM init)
    p["b_if"] = torch.cat([torch.zeros(n_h), torch.full((n_h,), 3.0)]
                          ).expand(L + (2 * n_h,)).clone()
    p.update(prefixed("out_norm", norm_init("rmsnorm", d_in, stacked)))
    p["w_down"] = common.fan_in_init(gen, L + (d_in, d), (-2,))
    return p


def _mlstm_heads(conv_out: Tensor, inner: Tensor, wq: Tensor, wk: Tensor,
                 wv: Tensor, i_pre: Tensor, f_pre: Tensor,
                 gla_state: Optional[Tensor], decode: bool
                 ) -> Tuple[Tensor, Tensor]:
    """The mLSTM cell of some heads: ``conv_out`` / ``inner`` (B, S, H *
    dh) the q/k and v sources, ``wq`` / ``wk`` / ``wv`` (H, dh, dh), the
    gate pre-activations ``i_pre`` / ``f_pre`` (B, S, H) f32. Returns
    (y (B, S, H * dh), the final GLA state)."""
    n_h, dh = wq.shape[0], wq.shape[1]
    b, s, _ = conv_out.shape
    qk_src = conv_out.reshape(b, s, n_h, dh)
    v_src = inner.reshape(b, s, n_h, dh)
    q = torch.einsum("bshd,hde->bshe", qk_src, wq.to(conv_out.dtype))
    k = torch.einsum("bshd,hde->bshe", qk_src, wk.to(conv_out.dtype)) / (
        dh ** 0.5)
    v = torch.einsum("bshd,hde->bshe", v_src, wv.to(conv_out.dtype))

    i_gate = torch.exp(torch.clamp(i_pre, max=10.0))  # capped
    log_a = F.logsigmoid(f_pre)  # forget gate

    v_aug = torch.cat([v, torch.ones((b, s, n_h, 1), dtype=v.dtype,
                                     device=v.device)], dim=-1) \
        * i_gate[..., None].to(v.dtype)

    if decode:
        y, new_state = ssd.gla_decode_step(
            q[:, 0], k[:, 0], v_aug[:, 0], log_a[:, 0], gla_state)
        y = y[:, None]
    else:
        y, new_state = ssd.chunked_gla(q, k, v_aug, log_a,
                                       initial_state=gla_state)
    num, den = y[..., :dh], y[..., dh:]
    y = num / torch.clamp(den.abs(), min=1.0).to(num.dtype)
    return y.reshape(b, s, n_h * dh), new_state


def mlstm_apply(p: Params, x: Tensor, cfg: ModelConfig,
                conv_state: Optional[Tensor] = None,
                gla_state: Optional[Tensor] = None,
                decode: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out, new_conv_state, new_gla_state).

    On DTensors (the GSPMD steps) the up-projection ``[inner | z]`` (its
    columns cut at ``d_in`` over two workers) is gathered whole once;
    the conv and the cell (``_mlstm_heads``) run on each worker's heads
    (``local_apply``), the conv's channels being its heads' (``inner``
    on the model axis); the gates' row-parallel product is reduced
    whole first. The output is gathered whole before ``out_norm``, an
    RMSNorm over ``d_in``, and the row-parallel ``w_down`` leaves a
    Partial sum that the output's ``constrain`` reduces."""
    d_in, n_h, dh = _mlstm_dims(cfg)
    x = whole(x, 1)  # sequence parallelism: the scan's sequence whole
    h = apply_norm(sub_params(p, "norm"), x, cfg.norm, cfg.norm_eps)
    inner, z = split_whole(h @ p["w_up"].to(x.dtype), (d_in, d_in))
    heads = None
    if is_dtensor(x):  # each worker's heads, and their channels
        heads = heads_placements(x, n_h, "inner")
        inner = relaid(inner, x.device_mesh, heads)
    conv_out, new_conv = local_apply(
        _causal_conv, inner, placed_like(p["conv_w"], inner, {2: 1}),
        placed_like(p["conv_b"], inner, {2: 0}),
        placed_like(conv_state, inner, {0: 0, 2: 2}),
        outs=None if heads is None else (heads, heads))
    gates = whole(conv_out @ p["w_if"].to(x.dtype), -1) + \
        whole(p["b_if"], -1).to(x.dtype)
    i_pre, f_pre = (placed_like(g, inner, {0: 0, 2: 2}) for g in
                    split_whole(gates.float(), (n_h, n_h)))
    y, new_state = local_apply(
        _mlstm_heads, conv_out, inner,
        *(placed_like(p[k], inner, {2: 0}) for k in ("wq", "wk", "wv")),
        i_pre, f_pre, placed_like(gla_state, inner, {0: 0, 2: 1}), decode,
        outs=None if heads is None else (heads, remap(heads, {0: 0, 2: 1})))
    y = whole(y, -1)  # the norm's rows whole
    y = apply_norm(sub_params(p, "out_norm"), y, "rmsnorm", cfg.norm_eps)
    if heads is not None:  # the row-parallel product's input, cut
        y, z = (relaid(t, x.device_mesh, heads) for t in (y, z))
    y = y * F.silu(z)
    out = y @ p["w_down"].to(x.dtype)
    return constrain(out, ("batch", "seq", "embed")), new_conv, new_state


def mlstm_axes(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Tuple]:
    """The logical axes of ``mlstm_init``'s leaves."""
    L = common.layer_axes(stacked)
    a = prefixed("norm", common.norm_axes(cfg.norm, stacked))
    a.update({"w_up": L + ("embed", "inner"),
              "conv_w": L + ("conv_spatial", "inner"),
              "conv_b": L + ("inner",),
              "wq": L + ("heads", None, None), "wk": L + ("heads", None, None),
              "wv": L + ("heads", None, None),
              "w_if": L + ("inner", "heads"), "b_if": L + ("heads",),
              "w_down": L + ("inner", "embed")})
    a.update(prefixed("out_norm", common.norm_axes("rmsnorm", stacked)))
    return a


def slstm_axes(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Tuple]:
    """The logical axes of ``slstm_init``'s leaves."""
    L = common.layer_axes(stacked)
    a = prefixed("norm", common.norm_axes(cfg.norm, stacked))
    a.update({"w_gates": L + ("embed", "inner"),
              "r_gates": L + (None, "heads", None, None),
              "b_gates": L + ("inner",), "w_up": L + ("embed", "ffn"),
              "w_down": L + ("ffn", "embed")})
    return a


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_init(gen: LeafDraw, cfg: ModelConfig, stacked: int = 0) -> Params:
    d, n_h = cfg.d_model, cfg.n_heads
    dh = d // n_h
    d_ffn = int(d * cfg.slstm_proj_factor)
    L = (stacked,) if stacked else ()
    p: Params = prefixed("norm", norm_init(cfg.norm, d, stacked))
    p["w_gates"] = common.fan_in_init(gen, L + (d, 4 * d), (-2,))
    # block-diagonal recurrent, per head, 4 gates
    p["r_gates"] = common.fan_in_init(gen, L + (4, n_h, dh, dh), (-2,)) * 0.1
    p["b_gates"] = torch.zeros(L + (4 * d,))
    p["w_up"] = common.fan_in_init(gen, L + (d, 2 * d_ffn), (-2,))
    p["w_down"] = common.fan_in_init(gen, L + (d_ffn, d), (-2,))
    return p


def _slstm_cell(st: Dict[str, Tensor], wx_t: Tensor, r: Tensor
                ) -> Dict[str, Tensor]:
    rh = torch.einsum("bhd,ghde->bghe", st["h"], r)  # (b,4,h,dh)
    pre = wx_t + rh
    zt = torch.tanh(pre[:, 0])
    it = pre[:, 1]
    ft = pre[:, 2]
    ot = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(ft + st["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + st["m"] - m_new)
    c = f_p * st["c"] + i_p * zt
    n = f_p * st["n"] + i_p
    h = ot * c / torch.clamp(n.abs(), min=1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_scan(wx: Tensor, r: Tensor, h: Tensor, c: Tensor, n: Tensor,
                m: Tensor, steps: int) -> Tuple[Tensor, ...]:
    """The sLSTM recurrence of some heads over ``steps`` positions:
    ``wx`` (B, S, 4, H, dh) f32 the gates' input projections, ``r`` (4,
    H, dh, dh) the recurrent weights, the state h, c, n, m (B, H, dh).
    Returns (the hidden states (B, steps, H, dh), h, c, n, m)."""
    state = {"h": h, "c": c, "n": n, "m": m}
    hs = []
    for t in range(steps):
        state = _slstm_cell(state, wx[:, t], r)
        hs.append(state["h"])
    return (torch.stack(hs, 1),) + tuple(state[k] for k in SLSTM_STATE)


def slstm_apply(p: Params, x: Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, Tensor]] = None,
                decode: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """state: dict h, c, n, m, each (B, H, d / H) f32.

    On DTensors (the GSPMD steps) the gates' projection (its columns
    cut across the four gates) is gathered whole, and the recurrence
    runs on each worker's heads (``local_apply``, the heads' recurrent
    weights local); the hidden states are gathered whole for the gated
    FFN."""
    d, n_h = cfg.d_model, cfg.n_heads
    dh = d // n_h
    b, s, _ = x.shape
    x = whole(x, 1)  # sequence parallelism: the scan's sequence whole
    xin = apply_norm(sub_params(p, "norm"), x, cfg.norm, cfg.norm_eps)
    wx = whole(xin @ p["w_gates"].to(x.dtype) + p["b_gates"].to(x.dtype),
               -1)
    wx = local_apply(lambda t: t.float().reshape(t.shape[0], s, 4, n_h, dh),
                     wx)
    r = p["r_gates"].float()

    if state is None:
        zeros = torch.zeros((b, n_h, dh), dtype=torch.float32,
                            device=x.device)
        state = {k: placed_like(zeros, x, {0: 0}) for k in SLSTM_STATE}
    outs = None
    if is_dtensor(x):  # each worker's heads
        heads = heads_placements(x, n_h, "heads")
        mesh = x.device_mesh
        wx = relaid(wx, mesh, remap(heads, {0: 0, 2: 3}))
        r = relaid(r, mesh, remap(heads, {2: 1}))
        st = remap(heads, {0: 0, 2: 1})
        state = {k: relaid(v, mesh, st) for k, v in state.items()}
        outs = (heads,) + (st,) * len(SLSTM_STATE)
    hs, *last = local_apply(_slstm_scan, wx, r,
                            *(state[k] for k in SLSTM_STATE),
                            1 if decode else s, outs=outs)
    state = dict(zip(SLSTM_STATE, last))
    y = whole(hs, 2).reshape(b, s, d).to(x.dtype)
    # gated FFN
    up = y @ p["w_up"].to(x.dtype)
    d_ffn = up.shape[-1] // 2
    y = F.silu(up[..., :d_ffn]) * up[..., d_ffn:]
    out = y @ p["w_down"].to(x.dtype)
    return constrain(out, ("batch", "seq", "embed")), state


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class XLSTMModel:
    """The SSM family: ``n_layers // slstm_every`` segments, each
    ``slstm_every - 1`` mLSTM layers then one sLSTM layer. ``remat``
    checkpoints each mLSTM layer in training, as the JAX package's scan
    body."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 attention_impl: str = "chunked", *, remat: bool = False,
                 device: DeviceLike = "cuda"):
        del attention_impl  # no attention
        self.cfg = cfg
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        every = cfg.slstm_every
        if cfg.n_layers % every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"make segments of {every}")
        self.n_segments = cfg.n_layers // every
        self.m_per_seg = every - 1
        self.n_mlstm = self.n_segments * self.m_per_seg

    def init(self, seed: int = 0, *, draw_device: DeviceLike = "cpu",
             dtype: Optional[torch.dtype] = None) -> Params:
        """Parameters by their JAX-tree paths, drawn leaf by leaf from
        ``seed`` on ``draw_device`` (``TransformerLM.init``)."""
        cfg = self.cfg
        gen = LeafDraw.from_seed(seed, draw_device, self.device, dtype)
        p: Params = prefixed("embed", layers.embedding_init(gen, cfg))
        p.update(prefixed("mlstm", mlstm_init(gen, cfg, self.n_mlstm)))
        p.update(prefixed("slstm", slstm_init(gen, cfg, self.n_segments)))
        p.update(prefixed("final_norm", norm_init(cfg.norm, cfg.d_model)))
        p["head"] = common.dense(gen, cfg.d_model, cfg.vocab_size)
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
        a.update(prefixed("mlstm", mlstm_axes(cfg, self.n_mlstm)))
        a.update(prefixed("slstm", slstm_axes(cfg, self.n_segments)))
        a.update(prefixed("final_norm", common.norm_axes(cfg.norm)))
        a["head"] = ("embed", "vocab")
        return a

    def forward(self, p: Params, tokens: Tensor, *, mode: str = "train",
                cache: Optional[Params] = None, cache_index=None
                ) -> Tuple[Tensor, float, Optional[Params]]:
        """Returns (logits, 0.0, cache); the cache is written in place."""
        del cache_index  # the recurrent state is the position
        cfg = self.cfg
        x = layers.embed(sub_params(p, "embed"), tokens, self.compute_dtype)
        decode = mode == "decode"
        for seg in range(self.n_segments):
            for i in range(seg * self.m_per_seg, (seg + 1) * self.m_per_seg):
                conv_c = gla_c = None
                if cache is not None:
                    conv_c, gla_c = cache["conv"][i], cache["gla"][i]
                if self.remat and cache is None and torch.is_grad_enabled():
                    # the layer's weights read inside the checkpoint
                    out, nc, ns = common.checkpointed(
                        lambda p, i, *a: mlstm_apply(
                            sub_params(p, "mlstm", i), *a),
                        p, i, x, cfg, conv_c, gla_c, decode)
                else:
                    out, nc, ns = mlstm_apply(sub_params(p, "mlstm", i), x,
                                              cfg, conv_c, gla_c,
                                              decode=decode)
                x = x + out
                if cache is not None:
                    assign(cache["conv"][i], nc)
                    assign(cache["gla"][i], ns)
            s_state = None
            if cache is not None:
                s_state = {k: cache[f"slstm/{k}"][seg] for k in SLSTM_STATE}
            out, new_s = slstm_apply(sub_params(p, "slstm", seg), x, cfg,
                                     s_state, decode)
            x = x + out
            if cache is not None:
                for k in SLSTM_STATE:
                    assign(cache[f"slstm/{k}"][seg], new_s[k])
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
        del max_seq  # the state does not grow with the sequence
        cfg = self.cfg
        d_in, n_h, dh = _mlstm_dims(cfg)
        d_head = cfg.d_model // cfg.n_heads
        shapes = {
            "conv": ((self.n_mlstm, batch, CONV_W - 1, d_in),
                     ("layers", "batch", None, "inner"), dtype),
            "gla": ((self.n_mlstm, batch, n_h, dh + 1, dh),
                    ("layers", "batch", "heads", None, None), torch.float32),
        }
        for k in SLSTM_STATE:
            shapes[f"slstm/{k}"] = ((self.n_segments, batch, n_h, d_head),
                                    ("layers", "batch", "heads", None),
                                    torch.float32)
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
