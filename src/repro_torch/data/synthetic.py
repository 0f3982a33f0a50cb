"""Deterministic synthetic data (images for the conv family, a token
stream for the LMs), bitwise equal to the JAX package.

Every *sample* depends only on ``(seed, split, step, global_index)``: it
draws from its own ``np.random.Generator(Philox(key=(mix(seed, split,
step), index)))``, so any host can regenerate any slice of any step's
batch, and a per-host shard is bitwise that slice of the full batch.
The train split draws from seed-space indices ``{step}``, the val split
from ``{-(step + 1)}``: the two never alias. Class templates depend only
on ``seed``, so both splits sample the same task.

The arrays stay numpy (the host side of the feed); the train step moves
them to the device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

SPLITS = ("train", "val")

_MASK64 = (1 << 64) - 1


def _split_index(split: str, step: int) -> int:
    """Disjoint seed-space offsets: train >= 0, val < 0."""
    return step if split == "train" else -(step + 1)


def _sample_rng(mix: int, seed: int, idx: int, index: int):
    """Counter-based per-sample generator: Philox keyed by
    ``(mix(seed, split, step), global sample index)``."""
    k = np.uint64((seed * mix + idx) & _MASK64)
    return np.random.Generator(
        np.random.Philox(key=np.array([k, index & _MASK64],
                                      dtype=np.uint64)))


def _check_shard(batch: int, sample_offset: int) -> None:
    if batch <= 0:
        raise ValueError(f"per-host batch must be positive, got {batch}")
    if sample_offset < 0:
        raise ValueError(f"sample_offset must be >= 0, got {sample_offset}")


class SyntheticLMData:
    """Language-model token stream with learnable structure (a noisy
    copy task: each row repeats 8 random tokens, 5% of positions
    replaced by random ones), so loss curves move. ``batch_at`` returns
    ``{"tokens", "targets"}`` (B, S) int32, the targets the tokens
    shifted by one, plus ``patches`` / ``frames`` float32 for configs
    with a vision / audio frontend. ``sample_offset`` is the index of
    this pipeline's first sample in the global batch."""

    _MIX = 1_000_003

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, structured: bool = True,
                 split: str = "train", sample_offset: int = 0):
        assert split in SPLITS, split
        _check_shard(batch, sample_offset)
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.structured = structured
        self.split = split
        self.sample_offset = sample_offset

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = _split_index(self.split, step)
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        patches = frames = None
        if self.cfg.vision is not None:
            vf = self.cfg.vision
            patches = np.empty((b, vf.num_patches, vf.patch_dim),
                               np.float32)
        if self.cfg.audio is not None:
            af = self.cfg.audio
            frames = np.empty((b, af.num_frames, af.frame_dim), np.float32)
        for j in range(b):
            rng = _sample_rng(self._MIX, self.seed, idx,
                              self.sample_offset + j)
            if self.structured:
                period = 8
                base = rng.integers(0, v, size=(period,))
                reps = int(np.ceil((s + 1) / period))
                row = np.tile(base, reps)[:s + 1]
                noise = rng.random(s + 1) < 0.05
                row = np.where(noise, rng.integers(0, v, size=(s + 1,)),
                               row)
            else:
                row = rng.integers(0, v, size=(s + 1,))
            toks[j] = row
            if patches is not None:
                patches[j] = rng.standard_normal(patches.shape[1:],
                                                 dtype=np.float32)
            if frames is not None:
                frames[j] = rng.standard_normal(frames.shape[1:],
                                                dtype=np.float32)
        out: Dict[str, Any] = {
            "tokens": np.ascontiguousarray(toks[:, :-1]),
            "targets": np.ascontiguousarray(toks[:, 1:]),
        }
        if patches is not None:
            out["patches"] = patches
        if frames is not None:
            out["frames"] = frames
        return out


# the last templates made, read-only: a train and a val source (or the
# next run in one process) of the same seed share them instead of
# drawing 0.6 GB again
_LAST_TEMPLATES: Dict[tuple, np.ndarray] = {}


def _templates(num_classes: int, image_size: int, seed: int,
               rank: int) -> np.ndarray:
    """Low-rank smooth class templates, ``(classes, size, size, 3)``
    float32 of unit std: a function of the seed alone (shared across
    splits)."""
    key = (num_classes, image_size, seed, rank)
    if key not in _LAST_TEMPLATES:
        _LAST_TEMPLATES.clear()
        rng = np.random.RandomState(seed)
        u = rng.randn(num_classes, image_size, rank).astype(np.float32)
        w = rng.randn(num_classes, rank, image_size * 3).astype(np.float32)
        t = np.einsum("cir,crj->cij", u, w).reshape(
            num_classes, image_size, image_size, 3)
        t /= (t.std() + 1e-6)
        t.setflags(write=False)
        _LAST_TEMPLATES[key] = t
    return _LAST_TEMPLATES[key]


class SyntheticImageData:
    """ImageNet-like classification: image = class template + noise.

    ``noise`` sets the difficulty. The templates are a full
    ``(classes, size, size, 3)`` float32 array (about 0.6 GB at 1000
    classes and 224 pixels). ``batch_at`` fills one preallocated float32
    buffer in place. ``sample_offset`` is the index of this pipeline's
    first sample in the global batch."""

    _MIX = 7_000_003

    def __init__(self, num_classes: int, image_size: int, batch: int,
                 seed: int = 0, noise: float = 0.5,
                 template_rank: int = 8, split: str = "train",
                 sample_offset: int = 0):
        assert split in SPLITS, split
        _check_shard(batch, sample_offset)
        self.num_classes = num_classes
        self.image_size = image_size
        self.batch = batch
        self.seed = seed
        self.noise = noise
        self.split = split
        self.sample_offset = sample_offset
        self.templates = _templates(num_classes, image_size, seed,
                                    template_rank)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = _split_index(self.split, step)
        b, s = self.batch, self.image_size
        labels = np.empty((b,), np.int32)
        imgs = np.empty((b, s, s, 3), np.float32)
        scale = np.float32(self.noise)
        for j in range(b):
            rng = _sample_rng(self._MIX, self.seed, idx,
                              self.sample_offset + j)
            lab = int(rng.integers(0, self.num_classes))
            labels[j] = lab
            out = imgs[j]
            out[...] = self.templates[lab]
            noise = rng.standard_normal((s, s, 3), dtype=np.float32)
            np.multiply(noise, scale, out=noise)
            np.add(out, noise, out=out)
        return {"images": imgs, "labels": labels}


def make_data(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
              split: str = "train", noise: Optional[float] = None,
              num_hosts: int = 1, host_id: int = 0):
    """This host's shard of the global batch: host ``h`` generates rows
    ``[h * B/N, (h+1) * B/N)``. Images for the conv family, the token
    stream (``shape.seq_len`` tokens a row) for every other."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    if shape.global_batch % num_hosts:
        raise ValueError(
            f"global batch {shape.global_batch} must divide evenly over "
            f"{num_hosts} hosts")
    per_host = shape.global_batch // num_hosts
    offset = host_id * per_host
    if cfg.family == "conv":
        kw = {} if noise is None else {"noise": noise}
        return SyntheticImageData(cfg.num_classes, cfg.image_size, per_host,
                                  seed, split=split, sample_offset=offset,
                                  **kw)
    return SyntheticLMData(cfg, per_host, shape.seq_len, seed, split=split,
                           sample_offset=offset)
