"""Chunked gated linear attention / SSD engine.

Mamba2's SSD and xLSTM's mLSTM are both gated linear-attention recurrences

    S_t = a_t * S_{t-1} + v_t k_t^T          (state: (H, Dv, Dk))
    y_t = S_t q_t                            (readout)

with per-(head, step) scalar decay ``a_t``. The port of the JAX package's
``models/ssd.py``: the same chunked formulation and the same arithmetic,
op for op on each chunk. The sequence is cut into chunks; within a chunk
the (chunk x chunk) decayed score matrix carries the outputs, and the
state is materialized once per chunk.

All math in f32; inputs and outputs in the compute dtype. Accumulation
is tightened as in the JAX package: the within-chunk log-decay prefix sum
is carried in doubled f32 (Kahan compensation), and the two long
reductions over the chunk axis (scores @ V and the K^T V state update)
are split into ``_SUB``-row sub-blocks summed pairwise.

The JAX package scans over chunks, each step computing its chunk's
prefix sum, intra-chunk outputs and outer products. None of those reads
the carried state, so the port computes them for every chunk at once
(the prefix sum as one loop over the ``chunk`` positions of all chunks)
and loops over chunks only for the state itself: ``S_c = exp(l_last) *
S_{c-1} + outer_c`` and the readout of ``S_{c-1}``. Each element is the
same sequence of f32 operations as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

NEG = -1e30

_SUB = 64  # pairwise-accumulation sub-block for the chunk-axis reductions


def _kahan_cumsum(x: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    """Compensated inclusive cumsum of f32 ``x`` along ``dim``.

    Returns ``(total, comp)`` with the running sum represented as the
    doubled-f32 value ``total - comp``, the JAX package's scan: IEEE adds
    in the same order, so the same bits."""
    xs = x.unbind(dim)
    total = comp = torch.zeros_like(xs[0])
    totals, comps = [], []
    for xi in xs:
        y = xi - comp
        t = total + y
        comp = (t - total) - y
        total = t
        totals.append(t)
        comps.append(comp)
    return torch.stack(totals, dim), torch.stack(comps, dim)


def _pairwise_sum(parts: Tensor) -> Tensor:
    """Tree-sum over the leading axis (error ~log n instead of ~n), in
    the JAX package's pairing."""
    while parts.shape[0] > 1:
        m = parts.shape[0] // 2
        head = parts[:m] + parts[m:2 * m]
        parts = (head if parts.shape[0] % 2 == 0
                 else torch.cat([head, parts[2 * m:]], dim=0))
    return parts[0]


def chunked_gla(
    q: Tensor,  # (B, S, H, Dk)
    k: Tensor,  # (B, S, H, Dk)
    v: Tensor,  # (B, S, H, Dv)
    log_a: Tensor,  # (B, S, H) per-step log decay (<= 0)
    *,
    chunk: int = 128,
    initial_state: Optional[Tensor] = None,  # (B, H, Dv, Dk)
) -> Tuple[Tensor, Tensor]:
    """Returns (y: (B,S,H,Dv) in q's dtype, final_state: (B,H,Dv,Dk) f32).
    ``S`` must be a multiple of ``min(chunk, S)``: nothing is padded."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    n = s // chunk
    assert s % chunk == 0, (s, chunk)
    f32 = torch.float32

    def chunk_of(x: Tensor) -> Tensor:  # (b, n, chunk, ...)
        return x.reshape(b, n, chunk, *x.shape[2:]).to(f32)

    qc, kc, vc = chunk_of(q), chunk_of(k), chunk_of(v)
    lc = chunk_of(log_a)  # (b, n, chunk, h)
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=q.device).tril()
    sub = _SUB if chunk % _SUB == 0 else chunk
    nsub = chunk // sub

    # inclusive within-chunk cum log decay, doubled f32 (hi, comp)
    lhi, lco = _kahan_cumsum(lc, 2)
    lcum = lhi - lco
    # intra-chunk: weight(t,τ) = exp(l_t - l_τ) for τ <= t, formed from
    # both Kahan halves
    rel = (lhi[:, :, :, None, :] - lhi[:, :, None, :, :]) \
        - (lco[:, :, :, None, :] - lco[:, :, None, :, :])  # (b, n, t, τ, h)
    rel = torch.where(tri[:, :, None], rel,
                      torch.full((), NEG, device=q.device))
    decay = torch.exp(rel)
    scores = torch.einsum("bnthd,bnshd->bntsh", qc, kc)
    # Σ_τ (scores·decay) v_τ, accumulated pairwise over sub-blocks
    w = (scores * decay).reshape(b, n, chunk, nsub, sub, h)
    vt = vc.reshape(b, n, nsub, sub, h, dv)
    y = _pairwise_sum(torch.einsum("bntjsh,bnjshv->jbnthv", w, vt))
    # the state update's terms: S = exp(l_Q) S_prev + Σ_τ exp(l_Q - l_τ)
    # v_τ k_τ^T
    tail = torch.exp(lcum[:, :, -1:, :] - lcum)  # (b, n, chunk, h)
    kt = (kc * tail[..., None]).reshape(b, n, nsub, sub, h, dk)
    outer = _pairwise_sum(torch.einsum("bnjshv,bnjshd->jbnhvd", vt, kt))
    last = torch.exp(lcum[:, :, -1, :])[..., None, None]  # (b, n, h, 1, 1)

    state = (torch.zeros((b, h, dv, dk), dtype=f32, device=q.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(n):
        prev.append(state)
        state = state * last[:, c] + outer[:, c]
    # inter-chunk: y += exp(l_t) * S_prev q_t
    qd = qc * torch.exp(lcum)[..., None]
    y = y + torch.einsum("bnthd,bnhvd->bnthv", qd, torch.stack(prev, 1))
    return y.reshape(b, s, h, dv).to(q.dtype), state


def gla_decode_step(
    q: Tensor,  # (B, H, Dk)
    k: Tensor,
    v: Tensor,  # (B, H, Dv)
    log_a: Tensor,  # (B, H)
    state: Tensor,  # (B, H, Dv, Dk)
) -> Tuple[Tensor, Tensor]:
    """Single-token recurrence step. Returns (y: (B,H,Dv), new_state)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    new_state = state.to(f32) * a + torch.einsum(
        "bhv,bhd->bhvd", v.to(f32), k.to(f32))
    y = torch.einsum("bhvd,bhd->bhv", new_state, q.to(f32))
    return y.to(q.dtype), new_state


def reference_gla(q: Tensor, k: Tensor, v: Tensor, log_a: Tensor,
                  initial_state: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """O(S) sequential oracle for tests (one decode step per position)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    state = (torch.zeros((b, h, dv, dk), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(s):
        y, state = gla_decode_step(q[:, t], k[:, t], v[:, t], log_a[:, t],
                                   state)
        ys.append(y)
    return torch.stack(ys, 1), state
