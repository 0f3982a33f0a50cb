"""The port's fused input transform (``kernels/fused_input.py``, its plain
versions on the CPU) against the JAX package's Pallas kernels in
interpret mode and their oracle ``ref.input_forward``, on the same
numpy images and the same parameter table: bitwise in float32 and in
bfloat16 (a subtract, a multiply and a cast, each rounded once on both
sides). The JAX package draws its table with threefry, which the port
does not reproduce; the port draws its own (``input_augment_params``),
and its host path (``AugmentedSource``) equals the fused path bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.data.pipeline import AugmentedSource, StepStampSource
from repro_torch.data.synthetic import SyntheticImageData
from repro_torch.kernels import fused_input
from repro_torch.kernels.ops import (
    fused_input_eval,
    fused_input_train,
    input_augment_params,
)

MEAN = (0.1, -0.2, 0.3)
STD = (0.9, 1.1, 1.3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# flips on and off, shifts of +-4 in both axes, and none
TABLE = np.array([[0, 0, 0, 0], [1, 0, 0, 0], [0, 4, -4, 0],
                  [1, -4, 4, 0], [1, 3, -1, 0], [0, -2, 2, 0],
                  [1, 4, 4, 0], [0, -4, -4, 0]], np.int32)


def _images(b=8, h=12, w=10, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, h, w, 3)).astype(np.float32)


def _vec(v):
    return torch.tensor(v, dtype=torch.float32)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_matches_jax_kernel_and_ref_bitwise(train, dt):
    jdt, tdt = DTYPES[dt]
    x = _images()
    mean, std = jnp.asarray(MEAN, jnp.float32), jnp.asarray(STD, jnp.float32)
    inv = 1.0 / std
    if train:
        got = fused_input_train(torch.from_numpy(x),
                                torch.from_numpy(TABLE), _vec(MEAN),
                                1.0 / _vec(STD), out_dtype=tdt)
        jk = jops.fused_input_train(jnp.asarray(x), jnp.asarray(TABLE), mean,
                                    inv, out_dtype=jdt)
    else:
        got = fused_input_eval(torch.from_numpy(x), _vec(MEAN),
                               1.0 / _vec(STD), out_dtype=tdt)
        jk = jops.fused_input_eval(jnp.asarray(x), mean, inv, out_dtype=jdt)
    jr = jref.input_forward(jnp.asarray(x), jnp.asarray(TABLE), mean, std,
                            train=train, out_dtype=jdt)
    assert got.dtype == tdt and got.shape == x.shape
    for want in (jk, jr):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_roll_follows_torch_roll_after_the_flip():
    x = torch.from_numpy(_images(b=1, h=5, w=7))
    got = fused_input_train(x, torch.tensor([[1, -3, 2, 0]],
                                            dtype=torch.int32),
                            torch.zeros(3), torch.ones(3),
                            out_dtype=torch.float32)
    want = torch.roll(x.flip(2), shifts=(-3, 2), dims=(1, 2))
    assert torch.equal(got, want)


def test_augment_params_contract():
    p = input_augment_params(3, 5, 64, max_shift=4)
    assert p.shape == (64, 4) and p.dtype == np.int32
    assert set(np.unique(p[:, 0])) == {0, 1}
    assert p[:, 1:3].min() == -4 and p[:, 1:3].max() == 4
    assert (p[:, 3] == 0).all()
    np.testing.assert_array_equal(p, input_augment_params(3, 5, 64))
    assert not np.array_equal(p, input_augment_params(3, 6, 64))
    assert not np.array_equal(p, input_augment_params(4, 5, 64))
    # a rank's rows are its slice of the global draw
    np.testing.assert_array_equal(input_augment_params(3, 5, 64)[16:32],
                                  p[16:32])
    assert np.abs(input_augment_params(0, 0, 32, max_shift=1)[:, 1:3]
                  ).max() == 1


@pytest.mark.parametrize("hosts", [1, 2])
def test_host_source_equals_fused_path_bitwise(hosts):
    """The host AugmentedSource and the fused kernel's path (step stamp
    -> the global table -> this shard's rows) give the same float32
    pixels, shard by shard."""
    gb, seed = 8, 7
    for h in range(hosts):
        per = gb // hosts
        src = SyntheticImageData(5, 12, per, seed=1, sample_offset=h * per)
        host = AugmentedSource(src, seed=seed, mean=MEAN, std=STD,
                               global_batch=gb)
        stamp = StepStampSource(src)
        for step in (0, 3):
            want = host.batch_at(step)
            b = stamp.batch_at(step)
            table = input_augment_params(seed, int(b["input_step"]), gb)
            got = fused_input_train(
                torch.from_numpy(b["images"]),
                torch.from_numpy(table[h * per:(h + 1) * per]), _vec(MEAN),
                1.0 / _vec(STD), out_dtype=torch.float32)
            np.testing.assert_array_equal(got.numpy(), want["images"])
            np.testing.assert_array_equal(b["labels"], want["labels"])
    ev = AugmentedSource(src, seed=seed, mean=MEAN, std=STD, train=False)
    np.testing.assert_array_equal(
        ev.batch_at(2)["images"],
        fused_input_eval(torch.from_numpy(src.batch_at(2)["images"]),
                         _vec(MEAN), 1.0 / _vec(STD),
                         out_dtype=torch.float32).numpy())


def test_wrappers_check_inputs_and_count_nothing_on_cpu():
    fused_input.reset_launch_counts()
    x = torch.from_numpy(_images(b=2))
    fused_input_eval(x, _vec(MEAN), _vec(STD), out_dtype=torch.bfloat16)
    assert fused_input.LAUNCHES == {"input_train": 0, "input_eval": 0}
    with pytest.raises(ValueError, match="params"):
        fused_input_train(x, torch.zeros((3, 4), dtype=torch.int32),
                          _vec(MEAN), _vec(STD), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="NHWC float32"):
        fused_input_eval(x.double(), _vec(MEAN), _vec(STD),
                         out_dtype=torch.float32)
    with pytest.raises(TypeError):
        fused_input_eval(x, _vec(MEAN), _vec(STD), out_dtype=torch.int8)
