"""The cell's initial weights, made by the benchmark from ``--seed`` and
handed alike to the program and to the reference.

Every "normal" leaf (``reference.common.Leaf``) is a slice of one flat
float32 stream times the leaf's std; the stream is drawn on the device
in chunks of ``CHUNK`` elements, chunk ``i`` from its own
``torch.Generator`` seeded with ``(seed, i)``. So any chunk can be drawn
again alone: ``change_norms`` rebuilds the initial weights chunk by
chunk to measure how far the trained ones moved, without a second copy
of the model on the card.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

CHUNK = 1 << 26
_MASK63 = (1 << 63) - 1


def _chunk_seed(seed: int, i: int) -> int:
    return (seed * 1_000_003 + 7919 * i + 1) & _MASK63


def _layout(leaves) -> List:
    """(leaf, offset in the stream) of every normal leaf."""
    out, off = [], 0
    for leaf in leaves:
        if leaf.init == "normal":
            out.append((leaf, off))
            off += leaf.numel
    return out


def _chunks(total: int):
    for i, lo in enumerate(range(0, total, CHUNK)):
        yield i, lo, min(lo + CHUNK, total)


def _draw_chunk(seed: int, i: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(_chunk_seed(seed, i))
    return torch.empty(n, device=device).normal_(generator=gen)


def make(leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 initial weights by leaf name."""
    layout = _layout(leaves)
    total = sum(leaf.numel for leaf, _ in layout)
    flat = torch.empty(total, device=device)
    for i, lo, hi in _chunks(total):
        flat[lo:hi] = _draw_chunk(seed, i, hi - lo, device)
    out = {leaf.name: (flat[off:off + leaf.numel] * leaf.std).view(
        leaf.shape) for leaf, off in layout}
    del flat
    for leaf in leaves:
        if leaf.init == "ones":
            out[leaf.name] = torch.ones(leaf.shape, device=device)
        elif leaf.init == "zeros":
            out[leaf.name] = torch.zeros(leaf.shape, device=device)
    return out


@torch.no_grad()
def change_norms(leaves, seed: int, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """||params[leaf] - initial weights of leaf|| for every leaf, the
    initial weights drawn again chunk by chunk on the params' device."""
    sq = {leaf.name: torch.zeros((), dtype=torch.float64,
                                 device=params[leaf.name].device)
          for leaf in leaves}
    for leaf in leaves:
        p = params[leaf.name].float()
        if leaf.init == "ones":
            sq[leaf.name] += (p - 1.0).square().sum(dtype=torch.float64)
        elif leaf.init == "zeros":
            sq[leaf.name] += p.square().sum(dtype=torch.float64)
    layout = _layout(leaves)
    total = sum(leaf.numel for leaf, _ in layout)
    for i, lo, hi in _chunks(total):
        device = params[layout[0][0].name].device
        chunk = _draw_chunk(seed, i, hi - lo, device)
        for leaf, off in layout:
            a, b = max(lo, off), min(hi, off + leaf.numel)
            if a >= b:
                continue
            init = chunk[a - lo:b - lo] * leaf.std
            now = params[leaf.name].reshape(-1)[a - off:b - off].float()
            sq[leaf.name] += (now - init).square().sum(dtype=torch.float64)
        del chunk
    return {k: float(v.sqrt()) for k, v in sq.items()}


@torch.no_grad()
def leaf_sums(tree: Dict[str, torch.Tensor], names: Sequence[str]
              ) -> Dict[str, float]:
    """The sum of each named tensor's elements, in float64 a chunk at a
    time."""
    out = {}
    for k in names:
        flat = tree[k].reshape(-1)
        out[k] = sum(float(flat[lo:hi].float().sum(dtype=torch.float64))
                     for _, lo, hi in _chunks(flat.numel()))
    return out


@torch.no_grad()
def leaf_norms(tree: Dict[str, torch.Tensor], names: Sequence[str]
               ) -> Dict[str, float]:
    """The norm of each named tensor, summed in float64 a chunk at a
    time."""
    out = {}
    for k in names:
        flat = tree[k].reshape(-1)
        sq = sum(float(flat[lo:hi].float().square().sum(dtype=torch.float64))
                 for _, lo, hi in _chunks(flat.numel()))
        out[k] = sq ** 0.5
    return out
