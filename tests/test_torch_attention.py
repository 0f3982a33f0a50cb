"""The port's flash attention and RMSNorm (``kernels/flash_attention.py``,
``kernels/rmsnorm.py``; their plain versions on the CPU) against the
JAX package: the Pallas kernels in interpret mode (``ops.attention``,
``ops.rmsnorm``, as ``tests/test_kernels.py`` runs them), the pure-jnp
``layers.chunked_attention(precision="f32")`` and ``ref.rmsnorm``, on
the same numpy inputs.

Tolerances: f32 rtol 1e-5 / atol 1e-6 for attention (the sums run in
another order: Pallas online over 64-row tiles, the port's plain version
one full softmax), rtol 1e-6 for RMSNorm; in bf16, beyond that f32
tolerance, attention within one bf16 ulp of the JAX result (the f32
values before the last rounding differ in their last bits; where an
output cancels to near zero, ~2e-6, the f32 difference is larger than
its own bf16 ulp) and RMSNorm within two (it rounds twice, ``x * inv``
and then the product with the scale, so a flip of the first rounding
moves the second product by up to ~2 ulps). S = 200 goes only to
``chunked_attention``: the Pallas wrapper asserts whole blocks. Head
dims: 32 everywhere, 96 and 112 (the registry's phi-3-vision and
zamba2-7b) against the Pallas kernel, and 80, which the card has no
instance for, on the CPU against ``chunked_attention``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn

F32_ATTN = dict(rtol=1e-5, atol=1e-6)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``x`` (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _assert_within_bf16_ulps(got: torch.Tensor, want, ulps=1, rtol=0.0,
                             atol=0.0) -> None:
    """|got - want| <= ``ulps`` bf16 ulps of want + atol + rtol * |want|."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    bound = ulps * _bf16_ulp(want) + atol + rtol * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def _qkv(seed, b, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, dh)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _to(arrs, dtype):
    return ([jnp.asarray(a, dtype[0]) for a in arrs],
            [torch.from_numpy(a).to(dtype[1]) for a in arrs])


DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


# every shape in f32; bf16 at one shape, each mask
PALLAS_CASES = [(s, hkv, causal, window, "f32") for s in (128, 256)
                for hkv in (1, 2, 4) for causal in (True, False)
                for window in (None, 32)] + [
    (128, 2, causal, window, "bf16") for causal in (True, False)
    for window in (None, 32)]


@pytest.mark.parametrize("s,hkv,causal,window,dt", PALLAS_CASES)
def test_flash_matches_pallas_interpret(s, hkv, causal, window, dt):
    arrs = _qkv(s + hkv, 2, s, 4, hkv, 32)
    (jq, jk, jv), (tq, tk, tv) = _to(arrs, DT[dt])
    want = jops.attention(jq, jk, jv, causal=causal, window=window,
                          block_q=64, block_k=64)
    got = tops.attention(tq, tk, tv, causal=causal, window=window)
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ATTN)
    else:
        _assert_within_bf16_ulps(got, want, **F32_ATTN)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [128, 200])
def test_flash_matches_chunked_attention(s, causal, window, dt):
    arrs = _qkv(7 * s, 2, s, 4, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _to(arrs, DT[dt])
    want = jlayers.chunked_attention(jq, jk, jv, causal=causal,
                                     window=window, q_chunk=64, kv_chunk=64,
                                     precision="f32")
    got = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DT[dt][1] and got.shape == tq.shape
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ATTN)
    else:
        _assert_within_bf16_ulps(got, want, **F32_ATTN)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [96, 112])
def test_flash_head_dims_match_pallas_interpret(dh, dt):
    arrs = _qkv(dh, 1, 128, 4, 2, dh)
    (jq, jk, jv), (tq, tk, tv) = _to(arrs, DT[dt])
    want = jops.attention(jq, jk, jv, causal=True, block_q=64, block_k=64)
    got = tops.attention(tq, tk, tv, causal=True)
    assert got.shape == tq.shape
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ATTN)
    else:
        _assert_within_bf16_ulps(got, want, **F32_ATTN)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_any_head_dim_on_cpu_matches_chunked_attention(dt):
    arrs = _qkv(80, 1, 200, 4, 2, 80)
    (jq, jk, jv), (tq, tk, tv) = _to(arrs, DT[dt])
    want = jlayers.chunked_attention(jq, jk, jv, causal=True, window=64,
                                     q_chunk=64, kv_chunk=64,
                                     precision="f32")
    got = tops.attention(tq, tk, tv, causal=True, window=64)
    assert 80 not in tfa.HEAD_DIMS and got.shape == tq.shape
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ATTN)
    else:
        _assert_within_bf16_ulps(got, want, **F32_ATTN)


def test_flash_wrapper_checks_and_counts_nothing_on_cpu():
    tfa.reset_launch_counts()
    q, k, v = (torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 3, 32),
               torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, v)
    # the plain version takes any head dim; only the card's kernel keeps
    # to HEAD_DIMS (the card tests check that it raises there)
    odd = torch.ones(1, 8, 4, 48)
    torch.testing.assert_close(tfa.flash_attention(odd, odd, odd), odd)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), q.half(), q.half())
    out = tfa.flash_attention(q, q, q, causal=True)
    assert out.shape == q.shape
    assert tfa.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(300, 128), (7, 2048), (1, 64)])
def test_rmsnorm_matches_pallas_and_ref(rows, d, dt):  # the Pallas order
    rng = np.random.default_rng(rows + d)
    x = (rng.standard_normal((rows, d)) * 2 + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt, tdt = DT[dt]
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    got = tops.rmsnorm(tx, torch.from_numpy(scale), eps=1e-5)
    assert got.dtype == tdt and got.shape == tx.shape
    for want in (jops.rmsnorm(jx, jnp.asarray(scale), eps=1e-5),
                 jref.rmsnorm(jx, jnp.asarray(scale), eps=1e-5)):
        if dt == "f32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
        else:
            _assert_within_bf16_ulps(got, want, ulps=2)


def test_rmsnorm_wrapper_keeps_shape_and_counts_nothing_on_cpu():
    trn.reset_launch_counts()
    x = torch.randn(2, 3, 64)
    assert tops.rmsnorm(x, torch.ones(64)).shape == (2, 3, 64)
    with pytest.raises(ValueError):
        tops.rmsnorm(x, torch.ones(32))
    with pytest.raises(TypeError):
        tops.rmsnorm(x.half(), torch.ones(64))
    assert trn.LAUNCHES == {"rmsnorm": 0}
