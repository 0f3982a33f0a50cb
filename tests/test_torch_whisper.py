"""whisper-tiny, the audio family (``models/whisper.py``: an encoder over
projected frames with sinusoid positions, a decoder with learned
positions, causal self-attention and cross-attention, a tied head), on
the port against the JAX package, on the CPU, at the reduced config (2
encoder and 4 decoder layers, 32 frames of 16), f32. Inputs are made from
a seed with numpy; the weights are drawn by the port from a seed and
carried to the JAX package with ``interop.params_to_jax``.

1. The config, full and reduced, field for field JAX's; the sinusoid
   table within 2^-13 of JAX's at 1,500 frames (an f32 ulp of the
   angle); the serving requests (prompts, then frames) bit for bit the
   JAX launcher's.
2. The forward (naive attention) against JAX's, logits within 5e-4;
   prefill and 4 greedy decode steps against JAX's with the same tokens,
   the decode steps reading the encoder output from the cache; prefill +
   decode against the teacher-forced forward within 5e-4
   (``tests/test_decode_consistency.py``).
3. The chunked path (the flash kernel's plain version here) at 160
   frames and a 128-token prompt, where the encoder (non-causal, 160 x
   160) and the prefill's cross-attention (non-causal, 128 x 160) take
   it: against JAX's chunked prefill within 5e-4.
4. Training: 3 steps through the launchers against the JAX package's
   (losses within rtol 2e-5, parameters within a relative norm of 2e-4);
   the DP step at one worker bitwise the one-device step;
   ``overlap_comm`` raises the JAX package's error (no
   ``loss_segments``); the converters round-trip bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.configs.base import AudioFrontend as JAudio
from repro.models import whisper as jwhisper
from repro.models.whisper import WhisperModel as JWhisper
from repro_torch import interop
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.configs.base import AudioFrontend as TAudio
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.serve import make_requests
from repro_torch.models import whisper as twhisper
from repro_torch.models.whisper import WhisperModel as TWhisper
from torch_families import (LOGIT_TOL, assert_round_trip,  # noqa: F401
                            assert_three_steps_match, jax_param_shapes,
                            jax_train_from, one_thread, port_setup)

ARCH = "whisper-tiny"

_PAIRS = {}


def _pair(impl="naive", frames=None):
    """(JAX model, its params, port model, the port's params) at the
    reduced config (``frames``: another frame count) in f32."""
    key = (impl, frames)
    if key not in _PAIRS:
        cj, ct = jreduced(jget(ARCH)), treduced(tget(ARCH))
        if frames is not None:
            cj = dataclasses.replace(cj, audio=JAudio(frames, 16))
            ct = dataclasses.replace(ct, audio=TAudio(frames, 16))
        jm = JWhisper(cj, compute_dtype=jnp.float32, attention_impl=impl,
                      remat=False)
        tm = TWhisper(ct, compute_dtype=torch.float32, attention_impl=impl,
                      device="cpu")
        tp = tm.init(6)
        _PAIRS[key] = (jm, jax.tree.map(jnp.asarray,
                                        interop.params_to_jax(tp)), tm, tp)
    return _PAIRS[key]


def _inputs(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s))
    af = cfg.audio
    return toks, rng.randn(b, af.num_frames, af.frame_dim).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches(reduced):
    j, t = jget(ARCH), tget(ARCH)
    if reduced:
        j, t = jreduced(j), treduced(t)
        assert (t.n_encoder_layers, t.audio.num_frames) == (2, 32)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_sinusoid_and_requests_match_jax():
    want = np.asarray(jwhisper._sinusoid(1500, 384))
    got = twhisper._sinusoid(1500, 384).numpy()
    # the two packages' f32 pow differ by an ulp at one of the 192
    # frequencies: its angles then differ by an ulp, at most 2^-13 below
    # 2,048 rad, and so may sin and cos
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -13)
    cfg = treduced(tget(ARCH))
    req = make_requests(cfg, 2, 10, seed=9)
    rng = np.random.RandomState(9)  # src/repro/launch/serve.py's draws
    assert np.array_equal(req["tokens"],
                          rng.randint(0, cfg.vocab_size, size=(2, 10)))
    assert np.array_equal(req["frames"], rng.randn(2, 32, 16))
    assert set(req) == {"tokens", "frames"}


def test_forward_prefill_decode_match_jax():
    jm, jp, tm, tp = _pair()
    assert jax_param_shapes(jm) == {k: tuple(v.shape) for k, v in tp.items()}
    b, prompt, steps = 2, 24, 4
    toks, frames = _inputs(tm.cfg, b, prompt, 4)
    jl, _, _ = jax.jit(lambda p, t, f: jm.forward(p, t, frames=f))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    tl, _, _ = tm.forward(tp, torch.from_numpy(toks),
                          frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jc, _ = jm.cache_shape(b, prompt + steps, jnp.float32)
    tc, _ = tm.cache_shape(b, prompt + steps, torch.float32)
    assert {k: tuple(v.shape) for k, v in interop._flatten(jc).items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jc,
                                   frames=jnp.asarray(frames))
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), tc,
                          frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tc["enc_out"].numpy(),
                               np.asarray(jc["enc_out"]), **LOGIT_TOL)
    decode = jax.jit(jm.decode_step)
    for i in range(steps + 1):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL, err_msg=f"call {i}")
        jt = jnp.argmax(jlog[:, -1], -1)[:, None]
        tt = torch.argmax(tlog[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if i == steps:
            break
        jlog, jc = decode(jp, jc, jt, jnp.int32(prompt + i))
        tlog, tc = tm.decode_step(tp, tc, tt, prompt + i)


def test_decode_matches_teacher_forced_forward():
    _, _, tm, tp = _pair()
    b, prompt, total = 2, 8, 14
    toks, frames = _inputs(tm.cfg, b, total, 0)
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    full, _, _ = tm.forward(tp, toks, frames=frames, mode="train")
    cache, _ = tm.cache_shape(b, total, torch.float32)
    last, cache = tm.prefill(tp, toks[:, :prompt], cache, frames=frames)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[:, prompt - 1].numpy(), **LOGIT_TOL)
    enc = cache["enc_out"].clone()
    for t in range(prompt, total - 1):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   **LOGIT_TOL, err_msg=f"position {t}")
    assert torch.equal(cache["enc_out"], enc)  # read, not encoded again


def test_chunked_prefill_non_causal_matches_jax():
    jm, jp, tm, tp = _pair("chunked", frames=160)
    b, prompt = 2, 128
    toks, frames = _inputs(tm.cfg, b, prompt, 5)
    jc, _ = jm.cache_shape(b, prompt + 1, jnp.float32)
    tc, _ = tm.cache_shape(b, prompt + 1, torch.float32)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jc,
                                   frames=jnp.asarray(frames))
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), tc,
                          frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_allclose(tc["enc_out"].numpy(),
                               np.asarray(jc["enc_out"]), **LOGIT_TOL)


# ----------------------------------------------------------------- train


def test_three_train_steps_match_jax(monkeypatch):
    _, ts, step, data, _, _ = port_setup(ARCH)
    assert data.batch_at(0)["frames"].shape == (2, 32, 16)
    js, jstep, jdata = jax_train_from(ts["params"], monkeypatch, ARCH,
                                      JWhisper)
    assert_three_steps_match(js, jstep, jdata, ts, step, data)


@pytest.mark.parametrize("compression", ["bf16", "bf16+bucketed"])
def test_one_worker_equals_single_device_step_bitwise(compression,
                                                      tmp_path):
    _, s1, step1, d1, _, _ = port_setup(ARCH, compression="bf16")
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        _, s2, step2, d2, put2, _ = port_setup(
            ARCH, dp_mode="shardmap", compression=compression)
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


def test_overlap_comm_raises_without_loss_segments(tmp_path):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        with pytest.raises(ValueError, match="has no loss_segments"):
            port_setup(ARCH, dp_mode="shardmap",
                       compression="bf16+bucketed", overlap_comm=True)
    finally:
        shutdown()


def test_converters_round_trip_bitwise():
    _, jp, _, tp = _pair()
    assert_round_trip(jax.tree.map(np.asarray, jp), tp)
    assert "frame_proj" in tp and "pos_dec" in tp
