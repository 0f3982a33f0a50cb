"""The one generator of the benchmark's traffic: reads a mix's parameter
file (``traffic/<name>.json``) and makes the cell's batches from the
seed, before the window.

``images``: after the port's ``data/synthetic.py`` ``SyntheticImageData``
(ImageNet-like classification: a smooth low-rank template per class,
normalized to unit std over all classes, plus Gaussian noise; NHWC
float32 pixels, int32 labels). Departure: it is drawn in bulk on the
device with ``torch.Generator``s keyed by ``(seed)`` for the templates
and ``(seed, batch, worker)`` for a worker's labels and noise, where the
port draws each sample on the host from its own numpy Philox stream, and
the pool is then copied to the host, where the program's feed takes it.
``tokens``: a copy of its ``SyntheticLMData`` (a noisy copy task: each
row repeats ``period`` random tokens, ``noise_share`` of the positions
replaced by random ones; the targets are the tokens shifted by one),
each sample from its own numpy Philox stream keyed by ``(seed, batch,
global sample index)``; departure: the seed is taken to 64 bits. Either
way a worker makes only its own rows, and the same seed gives the same
batches.

A cell's batches are a pool of ``pool_batches`` distinct batches drawn at
set-up and cycled (``PoolSource``): the window then measures the
training step and not the host's generator.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    """The parameters of traffic mix ``name``."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def _sample_rng(mix: int, seed: int, step: int, index: int):
    k = (seed * mix + step) & _MASK64
    return np.random.Generator(np.random.Philox(
        key=np.array([k, index & _MASK64], dtype=np.uint64)))


def _gen(device, *key: int):
    g = torch.Generator(device=device)
    h = 0
    for k in key:
        h = (h * 1_000_003 + k + 1) & ((1 << 63) - 1)
    g.manual_seed(h)
    return g


def image_pool(mix: Dict, seed: int, rank: int, count: int, device
               ) -> List[Dict[str, np.ndarray]]:
    """``count`` batches of worker ``rank``'s ``batch`` images."""
    c, s, r = mix["num_classes"], mix["image_size"], mix["template_rank"]
    g = _gen(device, seed, 0x7E3)
    u = torch.randn((c, s, r), generator=g, device=device)
    w = torch.randn((c, r, s * 3), generator=g, device=device)
    t = torch.bmm(u, w).reshape(c, s, s, 3)
    t /= t.std() + 1e-6
    del u, w
    out = []
    for i in range(count):
        g = _gen(device, seed, i, rank)
        labels = torch.randint(0, c, (mix["batch"],), generator=g,
                               device=device)
        noise = torch.randn((mix["batch"], s, s, 3), generator=g,
                            device=device)
        imgs = t[labels] + noise * mix["noise"]
        out.append({"images": imgs.cpu().numpy(),
                    "labels": labels.to(torch.int32).cpu().numpy()})
    return out


def token_batch(mix: Dict, vocab: int, seed: int, step: int, rows: int,
                offset: int) -> Dict[str, np.ndarray]:
    s = mix["seq_len"]
    toks = np.empty((rows, s + 1), np.int32)
    period = mix["period"]
    for j in range(rows):
        rng = _sample_rng(1_000_003, seed, step, offset + j)
        base = rng.integers(0, vocab, size=(period,))
        row = np.tile(base, -(-(s + 1) // period))[:s + 1]
        noise = rng.random(s + 1) < mix["noise_share"]
        toks[j] = np.where(noise, rng.integers(0, vocab, size=(s + 1,)), row)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "targets": np.ascontiguousarray(toks[:, 1:])}


def make_pool(mix: Dict, model: Dict, seed: int, rank: int = 0,
              device="cpu") -> List[Dict[str, np.ndarray]]:
    """Worker ``rank``'s rows of each of the mix's ``pool_batches``
    distinct global batches, as host arrays."""
    rows = mix["batch"]
    offset = rank * rows
    if mix["kind"] == "images":
        return image_pool(mix, seed, rank, mix["pool_batches"], device)
    if mix["kind"] == "tokens":
        return [token_batch(mix, model["vocab_size"], seed, i, rows, offset)
                for i in range(mix["pool_batches"])]
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")


def pinned(pool: List[Dict[str, np.ndarray]]) -> List[Dict]:
    """The pool in page-locked host memory, as an input pipeline with
    pinned buffers hands batches over: the feed's host-to-device copy
    then reads them where they lie (``Tensor.pin_memory`` of a pinned
    tensor is the tensor itself)."""
    return [{k: torch.from_numpy(v).pin_memory() for k, v in b.items()}
            for b in pool]


class PoolSource:
    """The pool as the program's pipeline reads it: ``batch_at(step)`` is
    pool batch ``step % len(pool)``, with the step number as the
    ``input_step`` stamp when ``stamp`` (the seed material of the fused
    input path's augmentation)."""

    def __init__(self, pool: List[Dict[str, np.ndarray]], stamp: bool):
        self.pool = pool
        self.stamp = stamp
        self.batch = len(next(iter(pool[0].values())))

    def batch_at(self, step: int) -> Dict:
        out = dict(self.pool[step % len(self.pool)])
        if self.stamp:
            out["input_step"] = np.int32(step)
        return out
