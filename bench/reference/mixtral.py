"""Plain Mixtral decoder (arXiv:2401.04088; the layer equations of
hf mistralai/Mixtral-8x7B-v0.1): token embedding, per layer RMSNorm ->
grouped-query attention with RoPE and a sliding causal window -> residual
-> RMSNorm -> top-2 of 8 SwiGLU experts -> residual, then the final
RMSNorm and the untied head; token-mean cross entropy plus 0.01 x the
Switch load-balancing loss.

Written fresh in plain PyTorch and frozen against the port's
``models/transformer.py`` and ``models/layers.py``. What it shares with
the port by design: the parameter names and layouts (``sub0/attn/wq``
``(1, d, H, Dh)``, ``sub0/moe/w_up`` ``(1, E, d, ff)``, ``head`` ``(d,
V)``), bf16 products with f32 norms, softmaxes and loss, and the routing
of GShard's grouped capacity dispatch as the port implements it: tokens
cut into groups of ``moe_group`` in (row, position) order, a token's
choices taken by repeated argmax of the f32 router softmax, every first
choice of a group placed before any second choice, each expert keeping
the first ``max(4, int(group * k * capacity_factor / E))`` of them in
token order and dropping the rest, the kept gate the router probability.
Departures: the experts run on gathered rows (``index_select`` /
``index_add_``) where the port multiplies one-hot dispatch and combine
tensors; attention is the plain score matrix in float32 where the port
runs its flash kernel. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.common import Leaf, Precision, fan_in_leaf

BF16 = torch.bfloat16


def leaf_specs(model: Dict) -> List[Leaf]:
    d, h, kv, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    ff, e, v, n = (model["d_ff"], model["n_experts"], model["vocab_size"],
                   model["n_layers"])
    out = [Leaf("embed/table", (v, d), "normal", 0.02)]
    out += [Leaf("sub0/norm1/scale", (n, d), "ones"),
            fan_in_leaf("sub0/attn/wq", (n, d, h, dh), d),
            fan_in_leaf("sub0/attn/wk", (n, d, kv, dh), d),
            fan_in_leaf("sub0/attn/wv", (n, d, kv, dh), d),
            fan_in_leaf("sub0/attn/wo", (n, h, dh, d), h * dh),
            Leaf("sub0/norm2/scale", (n, d), "ones"),
            fan_in_leaf("sub0/moe/router", (n, d, e), d),
            fan_in_leaf("sub0/moe/w_gate", (n, e, d, ff), d),
            fan_in_leaf("sub0/moe/w_up", (n, e, d, ff), d),
            fan_in_leaf("sub0/moe/w_down", (n, e, ff, d), ff)]
    out += [Leaf("final_norm/scale", (d,), "ones"),
            fan_in_leaf("head", (d, v), d)]
    return out


def rmsnorm(x, scale, eps):
    """The f32 statistic, its inverse rounded to bf16 (the JAX model's
    order), the product rounded, times the bf16 scale."""
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * inv.to(BF16).float()).to(BF16) * scale.to(BF16)


def rope(x, theta: float):
    """Split-half rotary embedding of (B, S, H, Dh) at positions 0..S-1;
    cos and sin in x's dtype."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, layer: int, model: Dict, prec: Precision):
    b, s, d = x.shape
    h, kv, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]

    def proj(name, heads):
        w = p[f"sub0/attn/{name}"][layer].reshape(d, heads * dh)
        return (prec(x) @ prec(w)).reshape(b, s, heads, dh)

    q = rope(proj("wq", h), model["rope_theta"])
    k = rope(proj("wk", kv), model["rope_theta"])
    v = proj("wv", kv)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    qf, kf, vf = (prec(t).float().transpose(1, 2) for t in (q, k, v))
    scores = qf @ kf.transpose(-1, -2) / dh ** 0.5
    i = torch.arange(s, device=x.device)
    allowed = i[None, :] <= i[:, None]
    if model.get("sliding_window"):
        allowed &= i[None, :] > i[:, None] - model["sliding_window"]
    scores = scores.masked_fill(~allowed, float("-inf"))
    out = (torch.softmax(scores, dim=-1) @ vf).to(BF16)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    wo = p["sub0/attn/wo"][layer].reshape(h * dh, d)
    return prec(out) @ prec(wo)


def route(probs, k: int, cap: int):
    """Grouped capacity routing of ``probs`` (G, T, E): per choice, the
    expert (G, T), the gate (G, T) and whether it was kept (G, T)."""
    g, t, e = probs.shape
    filled = torch.zeros(g, e, dtype=torch.long, device=probs.device)
    remaining = probs
    out = []
    for _ in range(k):
        idx = remaining.argmax(-1)
        gate = probs.gather(-1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, e)
        slot = (onehot.cumsum(1) - 1).gather(-1, idx[..., None])[..., 0] \
            + filled.gather(1, idx)
        out.append((idx, gate, slot < cap))
        filled = filled + onehot.sum(1)
        remaining = remaining.masked_fill(onehot.bool(), 0.0)
    return out


def moe(p, x, layer: int, cfg: Dict, prec: Precision):
    """(output (B, S, d) bf16, Switch aux loss) of one MoE layer."""
    model = cfg["model"]
    b, s, d = x.shape
    e, k = model["n_experts"], model["experts_per_token"]
    size = min(cfg["moe_group"], b * s)
    xg = x.reshape(-1, size, d)
    n_groups = xg.shape[0]
    cap = max(4, int(size * k * cfg["capacity_factor"] / e))
    router = p["sub0/moe/router"][layer]
    probs = torch.softmax((prec(xg) @ prec(router)).float(), dim=-1)
    density = F.one_hot(probs.argmax(-1), e).float().mean(dim=1)
    aux = (density * probs.mean(dim=1)).mean() * (e * e)
    flat = xg.reshape(-1, d)
    y = torch.zeros(flat.shape[0], d, dtype=torch.float32, device=x.device)
    rows = torch.arange(n_groups * size, device=x.device).reshape(n_groups,
                                                                  size)
    choices = route(probs, k, cap)
    for ex in range(e):
        tok, gates = [], []
        for idx, gate, kept in choices:
            sel = (idx == ex) & kept
            tok.append(rows[sel])
            gates.append(gate[sel])
        tok, gates = torch.cat(tok), torch.cat(gates)
        if tok.numel() == 0:
            continue
        xe = prec(flat.index_select(0, tok))
        wg = prec(p["sub0/moe/w_gate"][layer, ex])
        wu = prec(p["sub0/moe/w_up"][layer, ex])
        wd = prec(p["sub0/moe/w_down"][layer, ex])
        hid = F.silu(xe @ wg) * (xe @ wu)
        ye = prec(hid) @ wd
        y = y.index_add(0, tok, ye.float() * gates.to(BF16).float()[:, None])
    return y.to(BF16).reshape(b, s, d), aux


def forward(p, tokens, targets, cfg: Dict, prec: Precision):
    """(cross entropy + aux weight x aux, cross entropy)."""
    model = cfg["model"]
    eps = model["norm_eps"]
    x = p["embed/table"][tokens.long()]
    aux_total = torch.zeros((), device=x.device)
    for layer in range(model["n_layers"]):
        hn = rmsnorm(x, p["sub0/norm1/scale"][layer], eps)
        x = x + attention(p, hn, layer, model, prec)
        hn = rmsnorm(x, p["sub0/norm2/scale"][layer], eps)
        out, aux = moe(p, hn, layer, cfg, prec)
        x = x + out
        aux_total = aux_total + aux
    x = rmsnorm(x, p["final_norm/scale"], eps)
    logits = (prec(x) @ prec(p["head"])).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.long().reshape(-1))
    return ce + cfg["moe_aux_weight"] * aux_total, ce


class Task:
    """The reference's view of one training cell of this family."""

    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self.model = cfg["model"]
        self.leaves = leaf_specs(self.model)

    def inputs(self, batch: Dict, step: int, device, seed: int):
        del step, seed
        return (torch.as_tensor(batch["tokens"]).to(device),
                torch.as_tensor(batch["targets"]).to(device))

    def loss(self, p, inputs, prec: Precision):
        total, ce = forward(p, inputs[0], inputs[1], self.cfg, prec)
        return total, ce.detach(), {}
