"""Gradients through the port's LM kernels and the model's bf16 norm
rounding, against the JAX package on the CPU.

``rmsnorm`` and ``flash_attention`` go through a ``torch.autograd.Function``
whenever an input requires grad (on the CPU as on the card): its
backward recomputes the kernel's plain version and differentiates it.
The JAX model differentiates its jnp ``apply_norm`` and
``chunked_attention``, so those are the references, under ``jax.grad``
of the jitted function, on the same numpy inputs and cotangents.

Tolerances (f32): RMSNorm gradients rtol 1e-5 / atol 1e-6 (the same ops;
the row sums of the backward run in another order); attention gradients
rtol / atol 1e-5 (the plain version's full softmax against the jnp
online-softmax loop, whose backward runs through the running max and
sum: f32 sums in other orders over 200 keys, ~2.6e-6 observed); the
reduced llama3.2-1b's parameter gradients of the summed logits within a
relative norm of 1e-4 per leaf (f32 products and sums in other orders
through four layers and the tied 512-row head, ~1.3e-6 observed).

bf16 ``apply_norm`` (the model's rounding, ``round_inv=True``) against
the jitted JAX ``apply_norm`` at 64 x 2,048: within one bf16 ulp, with at
most 1% of the elements differing. The jitted function is the reference
because it is what JAX's serving path runs; an eager call sums the
squares in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trn
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcommon

EPS = 1e-5


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _jax_norm(scale, x):
    return jcommon.apply_norm({"scale": scale}, x, "rmsnorm", EPS)


def test_apply_norm_bf16_rounds_as_jitted_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 2048)) * 2 + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(2048)).astype(np.float32)
    want = np.asarray(jax.jit(_jax_norm)(
        jnp.asarray(scale, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)),
        np.float32)
    tx = torch.from_numpy(x).bfloat16()
    ts = torch.from_numpy(scale).bfloat16()
    got = tcommon.apply_norm({"scale": ts}, tx, "rmsnorm", EPS).float()
    diff = np.abs(got.numpy() - want)
    assert np.all(diff <= _bf16_ulp(want)), diff.max()
    assert np.mean(diff > 0) <= 0.01, np.mean(diff > 0)
    # the Pallas order (round_inv=False) is a different function here
    pallas = trn.rmsnorm(tx, ts, eps=EPS).float().numpy()
    assert np.mean(pallas != want) > 0.05


@pytest.mark.parametrize("round_inv", [False, True])
def test_rmsnorm_grad_matches_jax(round_inv):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 128)) * 2 + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def loss(s, xx):
        return jnp.sum(_jax_norm(s, xx) * dy)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(scale),
                                                   jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    trn.reset_launch_counts()
    y = trn.rmsnorm(tx, ts, eps=EPS, round_inv=round_inv)
    assert y.grad_fn is not None
    (y * torch.from_numpy(dy)).sum().backward()
    for got, w in ((ts.grad, want[0]), (tx.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert trn.LAUNCHES == {"rmsnorm": 0}
    # with no input requiring grad the Function is bypassed
    assert trn.rmsnorm(tx.detach(), ts.detach()).grad_fn is None


@pytest.mark.parametrize("dh,window", [(32, None), (96, 64)])
def test_flash_grad_matches_jax(dh, window):
    rng = np.random.default_rng(dh)
    q, k, v = (rng.standard_normal((1, 200, h, dh)).astype(np.float32)
               for h in (4, 2, 2))
    dout = rng.standard_normal(q.shape).astype(np.float32)

    def loss(qq, kk, vv):
        out = jlayers.chunked_attention(qq, kk, vv, causal=True,
                                        window=window, q_chunk=64,
                                        kv_chunk=64, precision="f32")
        return jnp.sum(out * dout)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, window=window)
    (out * torch.from_numpy(dout)).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # only the inputs that require grad get one
    tk2 = torch.from_numpy(k).requires_grad_()
    tfa.flash_attention(torch.from_numpy(q), tk2, torch.from_numpy(v),
                        causal=True, window=window).sum().backward()
    assert tk2.grad is not None and bool(torch.isfinite(tk2.grad).all())


def test_reduced_llama_backward_reaches_every_parameter():
    """The reduced llama3.2-1b in f32 through the chunked (flash) path,
    JAX-initialized weights carried across: the summed logits'
    gradients of every parameter against ``jax.grad`` of JAX's
    forward."""
    arch = "llama3.2-1b"
    cfg_j, cfg_t = jreduced(jget(arch)), treduced(tget(arch))
    jm = jbuild(cfg_j, compute_dtype=jnp.float32, attention_impl="chunked",
                remat=False)
    params, _ = jm.init_params(jax.random.PRNGKey(0))
    toks = np.random.RandomState(2).randint(0, cfg_j.vocab_size, (2, 128))

    def loss(p):
        return jnp.sum(jm.forward(p, jnp.asarray(toks), mode="train")[0])

    want = jax.grad(loss)(params)
    want = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    tm = tbuild(cfg_t, torch.float32, attention_impl="chunked",
                device="cpu")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    for t in tp.values():
        t.requires_grad_()
    logits, _, _ = tm.forward(tp, torch.from_numpy(toks), mode="train")
    logits.sum().backward()
    assert set(tp) == set(want)
    for name, t in tp.items():
        assert t.grad is not None, name
        g = t.grad.double().numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        w = want[name].astype(np.float64)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (name, rel)
