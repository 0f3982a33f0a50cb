"""The port's serving path of the dense transformer (``models/layers.py``,
``models/transformer.py``, ``training/step.py`` serving steps,
``launch/serve.py``) against the JAX package, on the CPU: the
llama3.2-1b configs field for field, the parameter renaming, and the
reduced llama3.2-1b in f32 with JAX-initialized weights carried across
(full forward, prefill and decode, greedy tokens).

Tolerance rtol/atol 5e-4 on logits, the bound of the JAX package's own
``tests/test_decode_consistency.py`` (f32 products summed in another
order; observed ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.models import build_model as jbuild
from repro.training.step import make_decode_step as jdecode_step
from repro.training.step import make_prefill_step as jprefill_step
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.configs.base import VisionFrontend
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch.serve import make_prompts, serve
from repro_torch.models import build_model as tbuild
from repro_torch.training.step import make_decode_step, make_prefill_step

TOL = dict(rtol=5e-4, atol=5e-4)
ARCH = "llama3.2-1b"


@pytest.mark.parametrize("reduced", [False, True])
def test_llama_config_matches(reduced):
    j, t = jget(ARCH), tget(ARCH)
    if reduced:
        j, t = jreduced(j), treduced(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.fixture(scope="module")
def pair():
    """The reduced llama3.2-1b in f32: JAX params and the port's copy."""
    cfg_j, cfg_t = jreduced(jget(ARCH)), treduced(tget(ARCH))
    jm = jbuild(cfg_j, compute_dtype=jnp.float32, attention_impl="naive",
                remat=False)
    params, _ = jm.init_params(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    return cfg_j, cfg_t, params, params_np


def test_lm_params_round_trip(pair):
    cfg_j, cfg_t, _, params_np = pair
    tp = lm_params_from_jax(params_np, "cpu")
    flat = {"/".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params_np)[0]}
    assert set(tp) == set(flat)
    for k, v in flat.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v)
    # a checkpoint's arrays.npz keys load directly
    npz = {f"['params']" + "".join(f"['{p}']" for p in k.split("/")): v
           for k, v in flat.items()}
    npz["['step']"] = np.int32(3)
    tp2 = lm_params_from_jax(npz, "cpu")
    assert set(tp2) == set(flat)
    assert all(torch.equal(tp[k], tp2[k]) for k in flat)
    # and the names are the port's own init's
    model = tbuild(cfg_t, torch.float32, device="cpu")
    own = model.init(0)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}


@pytest.mark.parametrize("impl,s", [("naive", 64), ("chunked", 128)])
def test_forward_matches_jax(pair, impl, s):
    cfg_j, cfg_t, params, params_np = pair
    jm = jbuild(cfg_j, compute_dtype=jnp.float32, attention_impl=impl,
                remat=False)
    tm = tbuild(cfg_t, torch.float32, attention_impl=impl, device="cpu")
    tp = lm_params_from_jax(params_np, "cpu")
    toks = np.random.RandomState(1).randint(0, cfg_j.vocab_size, (2, s))
    want, _, _ = jm.forward(params, jnp.asarray(toks), mode="train")
    tfa.reset_launch_counts()
    trn.reset_launch_counts()
    got, aux, cache = tm.forward(tp, torch.from_numpy(toks), mode="train")
    assert cache is None and got.shape == (2, s, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # on CPU tensors the wrappers run their plain versions: no launches
    assert tfa.LAUNCHES["flash_attention"] == 0
    assert trn.LAUNCHES["rmsnorm"] == 0


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_prefill_and_decode_match_jax(pair, impl):
    """make_prefill_step + 6 make_decode_steps, fed each side's own
    greedy tokens, which must agree."""
    cfg_j, cfg_t, params, params_np = pair
    jm = jbuild(cfg_j, compute_dtype=jnp.float32, attention_impl=impl,
                remat=False)
    tm = tbuild(cfg_t, torch.float32, attention_impl=impl, device="cpu")
    tp = lm_params_from_jax(params_np, "cpu")
    b, prompt, steps = 2, 128, 6
    toks = make_prompts(cfg_t, b, prompt, seed=3)
    jcache, _ = jm.cache_shape(b, prompt + steps, jnp.float32)
    tcache, _ = tm.cache_shape(b, prompt + steps, torch.float32)
    jl, jcache = jprefill_step(jm)(params, jcache,
                                   {"tokens": jnp.asarray(toks)})
    tl, tcache = make_prefill_step(tm)(tp, tcache,
                                       {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(steps):
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jcache = jdecode_step(jm)(params, jcache, {
            "tokens": jt, "cache_index": jnp.int32(prompt + i)})
        tl, tcache = make_decode_step(tm)(tp, tcache, {
            "tokens": tt, "cache_index": prompt + i})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[f"sub0/{name}"].numpy(),
                                   np.asarray(jcache["sub0"][name]), **TOL)


def test_decode_matches_full_forward(pair):
    """The port's own prefill + decode against its full forward at every
    position (a mirror of the JAX package's
    ``test_decode_matches_full_forward``)."""
    _, cfg_t, _, params_np = pair
    tm = tbuild(cfg_t, torch.float32, attention_impl="naive", device="cpu")
    tp = lm_params_from_jax(params_np, "cpu")
    b, prompt, total = 2, 8, 14
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg_t.vocab_size, (b, total)))
    full, _, _ = tm.forward(tp, toks, mode="train")
    cache, _ = tm.cache_shape(b, total, torch.float32)
    last, cache = tm.prefill(tp, toks[:, :prompt], cache)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[:, prompt - 1].numpy(), **TOL)
    for t in range(prompt, total - 1):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   **TOL, err_msg=f"position {t}")


def test_serve_runs_on_cpu():
    """serve(device="cpu") on the reduced config: JAX's prompts and result
    keys; the same tokens through the flash and the naive attention; each
    generated token the greedy choice of the port's own full forward.
    (The weights are the port's generator's, not JAX's threefry draws,
    so the tokens are not JAX's serve()'s.)"""
    cfg_t = treduced(tget(ARCH))
    a = serve(cfg_t, 2, 128, 5, seed=0, attention_impl="chunked",
              device="cpu")
    b = serve(cfg_t, 2, 128, 5, seed=0, attention_impl="naive",
              device="cpu")
    assert set(a) == {"generated", "prefill_s", "decode_s",
                      "decode_tok_per_s"}
    assert a["generated"].shape == (2, 5)
    np.testing.assert_array_equal(a["generated"], b["generated"])
    prompts = make_prompts(cfg_t, 2, 128, seed=0)
    np.testing.assert_array_equal(
        prompts, np.random.RandomState(0).randint(0, cfg_t.vocab_size,
                                                  (2, 128)))
    tm = tbuild(cfg_t, torch.float32, attention_impl="naive", device="cpu")
    tp = tm.init(0)
    seq = np.concatenate([prompts, a["generated"][:, :-1]], axis=1)
    full, _, _ = tm.forward(tp, torch.from_numpy(seq), mode="train")
    greedy = torch.argmax(full[:, 127:], -1).numpy()
    np.testing.assert_array_equal(greedy, a["generated"])


def test_serve_needs_a_card_unless_told_cpu():
    cfg_t = treduced(tget(ARCH))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg_t, 1, 8, 2)
    from repro_torch.launch import serve as serve_mod
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--reduced", "--prompt-len", "8"])


@pytest.mark.parametrize("what", ["moe", "patches", "chunked_opt"])
def test_unported_lm_options_raise(pair, what):
    _, cfg_t, _, params_np = pair
    if what == "moe":
        # ported since (it raised before): MoE layers on the reduced
        # config build and run; test_torch_moe.py holds them against JAX
        moe = dataclasses.replace(cfg_t, n_experts=4, experts_per_token=2)
        tm = tbuild(moe, torch.float32, attention_impl="naive",
                    device="cpu")
        tp = tm.init(0)
        assert tp["sub0/moe/w_up"].shape == (moe.n_layers, 4, moe.d_model,
                                             moe.d_ff)
        logits, aux, _ = tm.forward(tp, torch.zeros(1, 16, dtype=torch.long))
        assert logits.shape == (1, 16, moe.vocab_size)
        assert float(aux) > 0 and bool(torch.isfinite(logits).all())
        return
    tm = tbuild(cfg_t, torch.float32,
                attention_impl="chunked_opt" if what == "chunked_opt"
                else "naive", device="cpu")
    tp = lm_params_from_jax(params_np, "cpu")
    toks = torch.zeros(1, 128, dtype=torch.long)
    if what == "chunked_opt":
        # ported since (it raised before): in f32 its loop equals the
        # naive attention's forward to f32 rounding
        # (tests/test_torch_lm_train.py holds it against the JAX package)
        naive = tbuild(cfg_t, torch.float32, attention_impl="naive",
                       device="cpu")
        got, _, _ = tm.forward(tp, toks)
        want, _, _ = naive.forward(tp, toks)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        return
    # "patches": ported since (it raised before): a VLM config (the
    # reduced model with a patch frontend) runs a patched forward whose
    # logits are the text positions'; tests/test_torch_vlm.py holds it
    # against the JAX package
    vlm = dataclasses.replace(cfg_t, vision=VisionFrontend(4, 8))
    tv = tbuild(vlm, torch.float32, attention_impl="naive", device="cpu")
    vp = dict(tp, vision_proj=torch.randn(8, vlm.d_model))
    patches = torch.randn(1, 4, 8)
    logits, _, _ = tv.forward(vp, toks, patches=patches)
    assert logits.shape == (1, 128, vlm.vocab_size)
    plain, _, _ = tv.forward(vp, toks)
    assert bool(torch.isfinite(logits).all())
    assert float((logits - plain).abs().max()) > 0
