"""The traffic generator (``traffic/generate.py``): the same seed gives
the same batches, another seed others, and a worker's rows are its own."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from traffic import generate  # noqa: E402

IMAGES = {"kind": "images", "batch": 3, "image_size": 8, "num_classes": 5,
          "noise": 0.5, "template_rank": 2, "pool_batches": 2}
TOKENS = {"kind": "tokens", "batch": 2, "seq_len": 16, "period": 4,
          "noise_share": 0.05, "pool_batches": 3}
MODEL = {"vocab_size": 50}
SEEDS = (7, 2 ** 31 + 11)


def _same(a, b) -> bool:
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.mark.parametrize("mix", [IMAGES, TOKENS], ids=["images", "tokens"])
@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_per_seed(mix, seed):
    a = generate.make_pool(mix, MODEL, seed)
    b = generate.make_pool(mix, MODEL, seed)
    assert len(a) == mix["pool_batches"]
    assert _same(a, b)


@pytest.mark.parametrize("mix", [IMAGES, TOKENS], ids=["images", "tokens"])
def test_seeds_and_batches_differ(mix):
    a = generate.make_pool(mix, MODEL, SEEDS[0])
    b = generate.make_pool(mix, MODEL, SEEDS[1])
    assert not _same(a, b)
    key = "images" if mix["kind"] == "images" else "tokens"
    assert not np.array_equal(a[0][key], a[1][key])


@pytest.mark.parametrize("mix", [IMAGES, TOKENS], ids=["images", "tokens"])
def test_workers_make_their_own_rows(mix):
    r0 = generate.make_pool(mix, MODEL, SEEDS[0], rank=0)
    r1 = generate.make_pool(mix, MODEL, SEEDS[0], rank=1)
    assert not _same(r0, r1)


def test_shapes_and_ranges():
    imgs = generate.make_pool(IMAGES, MODEL, 3)[0]
    assert imgs["images"].shape == (3, 8, 8, 3)
    assert imgs["images"].dtype == np.float32
    assert imgs["labels"].dtype == np.int32
    assert ((0 <= imgs["labels"]) & (imgs["labels"] < 5)).all()
    toks = generate.make_pool(TOKENS, MODEL, 3)[0]
    assert toks["tokens"].shape == toks["targets"].shape == (2, 16)
    # the targets are the tokens shifted by one
    assert np.array_equal(toks["tokens"][:, 1:], toks["targets"][:, :-1])
    assert ((0 <= toks["tokens"]) & (toks["tokens"] < 50)).all()


def test_pool_source_cycles_and_stamps():
    pool = generate.make_pool(TOKENS, MODEL, 3)
    src = generate.PoolSource(pool, stamp=True)
    assert src.batch == 2
    b = src.batch_at(4)
    assert np.array_equal(b["tokens"], pool[1]["tokens"])
    assert int(b["input_step"]) == 4


@pytest.mark.parametrize("name", ["dp_b256", "dp_4x1024"])
def test_mix_files_load(name):
    mix = generate.load(name)
    assert mix["kind"] in ("images", "tokens")
    assert mix["warmup_steps"] >= 3 and mix["trace_steps"] >= 1
