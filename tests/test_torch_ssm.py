"""The chunked GLA engine (``models/ssd.py``) and the two families built on
it, zamba2-7b (Mamba2 + shared attention, ``models/mamba.py``) and
xlstm-350m (mLSTM / sLSTM, ``models/xlstm.py``), on the port against the
JAX package, on the CPU, f32. Inputs are made from a seed with numpy;
the model weights are drawn by the port from a seed and carried to the
JAX package with ``interop.params_to_jax`` (the leaves have one layout
in both), but for the train steps, which start from the JAX launcher's
weights carried to the port.

1. ``ssd``: the Kahan prefix sum's two halves bitwise JAX's;
   ``chunked_gla`` within rtol/atol 1e-5 of JAX's at chunk 16 / 64 / 128
   and S 128 / 256 with an initial state, and within the JAX package's
   own 1e-4 of the port's ``reference_gla`` (``tests/test_kernels.py``);
   ``gla_decode_step`` after a chunked prefix equals the oracle over S+1
   (``tests/test_properties.py``); the gradients finite and within a
   relative norm of 1e-4 of ``jax.grad``'s; a length that is not a
   multiple of the chunk raises.
2. The configs, full and reduced, field for field JAX's.
3. The reduced models: the forward against JAX's, logits within 5e-4;
   prefill and 4 greedy decode steps against JAX's with the same tokens;
   prefill + decode against the teacher-forced forward within 5e-4
   (``tests/test_decode_consistency.py``).
4. Training: 3 steps through the launchers against the JAX package's
   (losses within rtol 2e-5, parameters within a relative norm of 2e-4);
   the DP step at one worker (per-leaf and bucketed) bitwise the
   one-device step; ``overlap_comm`` raises the JAX package's error (no
   ``loss_segments``).
5. The converters: ``params_to_jax(lm_params_from_jax(tree))`` bitwise,
   and no leaf is taken for a conv weight (``is_conv_leaf``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.models import build_model as jbuild
from repro.models import ssd as jssd
from repro.models.mamba import Zamba2Model as JZamba
from repro.models.xlstm import XLSTMModel as JXLSTM
from repro_torch import interop
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import init_workers, shutdown
from repro_torch.models import build_model as tbuild
from repro_torch.models import ssd as tssd
from repro_torch.training import step as tstep
from torch_families import (LOGIT_TOL, assert_round_trip,  # noqa: F401
                            assert_three_steps_match, jax_param_shapes,
                            jax_train_from, one_thread, port_setup)

ARCHS = ["zamba2-7b", "xlstm-350m"]
JAX_CLASSES = {"zamba2-7b": JZamba, "xlstm-350m": JXLSTM}
GLA_TOL = dict(rtol=1e-5, atol=1e-5)


def _gla_inputs(s, seed=0, b=2, h=3, dk=8, dv=5):
    rng = np.random.RandomState(seed)
    q, k = (rng.randn(b, s, h, dk).astype(np.float32) for _ in range(2))
    v = rng.randn(b, s, h, dv).astype(np.float32)
    log_a = (-np.abs(rng.randn(b, s, h)) * 0.5).astype(np.float32)
    s0 = rng.randn(b, h, dv, dk).astype(np.float32)
    return q, k, v, log_a, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------ ssd


def test_kahan_halves_bitwise_jax():
    x = (-np.abs(np.random.RandomState(3).randn(4, 128, 3)) * 30).astype(
        np.float32)
    jt, jc = jax.jit(jssd._kahan_cumsum)(x)
    tt, tc = tssd._kahan_cumsum(torch.from_numpy(x), 1)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.abs(np.asarray(jc)).max() > 0  # the compensation is live


@pytest.mark.parametrize("chunk,s", [(16, 128), (64, 128), (128, 128),
                                     (64, 256), (128, 256)])
def test_chunked_gla_matches_jax(chunk, s):
    q, k, v, log_a, s0 = _gla_inputs(s, seed=chunk + s)
    jy, js = jax.jit(lambda *a: jssd.chunked_gla(
        *a[:4], chunk=chunk, initial_state=a[4]))(q, k, v, log_a, s0)
    tq, tk, tv, tl, ts0 = _t(q, k, v, log_a, s0)
    ty, ts = tssd.chunked_gla(tq, tk, tv, tl, chunk=chunk,
                              initial_state=ts0)
    assert ts.dtype == torch.float32 and ty.shape == tv.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **GLA_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **GLA_TOL)
    # the JAX package's own bound against the sequential oracle
    ry, rs = tssd.reference_gla(tq, tk, tv, tl, ts0)
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), rs.numpy(), atol=1e-4)


def test_decode_step_after_chunked_prefix_is_the_oracle():
    s = 32
    q, k, v, log_a, _ = _gla_inputs(s + 1, seed=7, b=1, h=2, dk=4, dv=4)
    log_a = log_a * 0.2
    tq, tk, tv, tl = _t(q, k, v, log_a)
    y_ref, _ = tssd.reference_gla(tq, tk, tv, tl)
    _, state = tssd.chunked_gla(tq[:, :s], tk[:, :s], tv[:, :s], tl[:, :s],
                                chunk=16)
    y_step, _ = tssd.gla_decode_step(tq[:, s], tk[:, s], tv[:, s], tl[:, s],
                                     state)
    np.testing.assert_allclose(y_step.numpy(), y_ref[:, s].numpy(),
                               atol=1e-4)


def test_chunked_gla_gradients_match_jax():
    q, k, v, log_a, _ = _gla_inputs(128, seed=11, b=1, h=2, dk=8, dv=8)
    w = np.random.RandomState(12).randn(1, 128, 2, 8).astype(np.float32)

    def jloss(q, k, v, log_a):
        y, st = jssd.chunked_gla(q, k, v, log_a, chunk=64)
        return (y * w).sum() + st.sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(q, k, v, log_a)
    ins = [t.requires_grad_() for t in _t(q, k, v, log_a)]
    y, st = tssd.chunked_gla(*ins, chunk=64)
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + st.sum(), ins)
    for name, a, b in zip("qkvl", tg, jg):
        b = np.asarray(b, np.float64)
        assert np.isfinite(a.numpy()).all(), name
        rel = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
        assert rel < 1e-4, (name, rel)


def test_chunked_gla_raises_on_a_ragged_length():
    q, k, v, log_a, _ = _gla_inputs(200)
    with pytest.raises(AssertionError):
        tssd.chunked_gla(*_t(q, k, v, log_a), chunk=128)


# --------------------------------------------------------------- configs


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches(arch, reduced):
    j, t = jget(arch), tget(arch)
    if reduced:
        j, t = jreduced(j), treduced(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


# ----------------------------------------------------------------- model

_MODELS = {}


def _models(arch):
    """(JAX model, its params, port model, the port's params) at the
    reduced config in f32, naive attention."""
    if arch not in _MODELS:
        jm = jbuild(jreduced(jget(arch)), compute_dtype=jnp.float32,
                    attention_impl="naive", remat=False)
        tm = tbuild(treduced(tget(arch)), torch.float32,
                    attention_impl="naive", device="cpu")
        tp = tm.init(3)
        jp = jax.tree.map(jnp.asarray, interop.params_to_jax(tp))
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    assert jax_param_shapes(jm) == {k: tuple(v.shape) for k, v in tp.items()}
    b, prompt, steps = 2, 64, 4
    toks = np.random.RandomState(4).randint(0, tm.cfg.vocab_size,
                                            (b, prompt))
    jl, _, _ = jax.jit(lambda p, t: jm.forward(p, t))(jp, jnp.asarray(toks))
    tl, _, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jc, _ = jm.cache_shape(b, prompt + steps, jnp.float32)
    tc, _ = tm.cache_shape(b, prompt + steps, torch.float32)
    assert {k: tuple(v.shape) for k, v in interop._flatten(jc).items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jc)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), tc)
    decode = jax.jit(jm.decode_step)
    for i in range(steps + 1):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL, err_msg=f"{arch} call {i}")
        jt = jnp.argmax(jlog[:, -1], -1)[:, None]
        tt = torch.argmax(tlog[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if i == steps:
            break
        jlog, jc = decode(jp, jc, jt, jnp.int32(prompt + i))
        tlog, tc = tm.decode_step(tp, tc, tt, prompt + i)
    for k, v in interop._flatten(jc).items():
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(v), **LOGIT_TOL,
                                   err_msg=f"cache {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced_forward(arch):
    _, _, tm, tp = _models(arch)
    b, prompt, total = 2, 8, 14
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tm.cfg.vocab_size, (b, total)))
    full, _, _ = tm.forward(tp, toks, mode="train")
    cache, _ = tm.cache_shape(b, total, torch.float32)
    last, cache = tm.prefill(tp, toks[:, :prompt], cache)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[:, prompt - 1].numpy(), **LOGIT_TOL)
    for t in range(prompt, total - 1):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   **LOGIT_TOL, err_msg=f"position {t}")


def test_zamba2_groups_shared_blocks_and_tail():
    _, _, tm, tp = _models("zamba2-7b")
    cfg = tm.cfg  # reduced: 7 layers, a shared block every 3, 2 blocks
    assert (tm.n_full_groups, tm.tail) == (2, 1)
    full = tbuild(tget("zamba2-7b"), device="cpu")
    assert (full.n_full_groups, full.tail) == (13, 3)
    assert {k.split("/")[0] for k in tp} == {
        "embed", "mamba", "final_norm", "head", "shared0", "shared1"}
    cache, _ = tm.cache_shape(2, 10000, torch.float32)
    assert cache["attn/k"].shape == (2, 2, 4096, cfg.n_kv_heads,
                                     cfg.head_dim)
    assert cache["ssm"].shape == (7, 2, 8, cfg.ssm_head_dim, cfg.ssm_state)


def test_xlstm_pattern():
    _, _, tm, tp = _models("xlstm-350m")
    full = tbuild(tget("xlstm-350m"), device="cpu")
    assert (full.n_segments, full.n_mlstm) == (3, 21)
    assert (tm.n_segments, tm.n_mlstm) == (2, 2)
    assert tp["slstm/r_gates"].shape == (2, 4, 4, 32, 32)


# ----------------------------------------------------------------- train


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, monkeypatch):
    _, ts, step, data, _, _ = port_setup(arch)
    js, jstep, jdata = jax_train_from(ts["params"], monkeypatch, arch,
                                      JAX_CLASSES[arch])
    assert_three_steps_match(js, jstep, jdata, ts, step, data)


@pytest.mark.parametrize("compression", ["bf16", "bf16+bucketed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_worker_equals_single_device_step_bitwise(arch, compression,
                                                      tmp_path):
    _, s1, step1, d1, _, _ = port_setup(arch, compression="bf16")
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        _, s2, step2, d2, put2, _ = port_setup(
            arch, dp_mode="shardmap", compression=compression)
        for i in range(2):
            s1, m1 = step1(s1, d1.batch_at(i))
            s2, m2 = step2(s2, put2(d2.batch_at(i)))
            assert float(m1["loss"]) == float(m2["loss"])
        for k, v in s1["params"].items():
            assert torch.equal(v, s2["params"][k]), k
            for f in ("delta", "m"):
                assert torch.equal(s1["opt"][f][k], s2["opt"][f][k]), (f, k)
    finally:
        shutdown()


@pytest.mark.parametrize("arch", ARCHS)
def test_overlap_comm_raises_without_loss_segments(arch, tmp_path):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        with pytest.raises(ValueError, match="has no loss_segments"):
            port_setup(arch, dp_mode="shardmap",
                       compression="bf16+bucketed", overlap_comm=True)
    finally:
        shutdown()
    # ZeRO + overlap lays its stream out in ready order first
    with pytest.raises(ValueError, match="has no loss_segments"):
        tstep._ready_stages(_models(arch)[2], {})


# ------------------------------------------------------------ converters


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_round_trip_bitwise(arch):
    _, jp, _, tp = _models(arch)
    assert_round_trip(jax.tree.map(np.asarray, jp), tp)
    conv = "mamba/conv_w" if arch == "zamba2-7b" else "mlstm/conv_w"
    assert tp[conv].dim() == 3  # (L, width, channels): not a conv leaf
