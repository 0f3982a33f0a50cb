"""The MoE family on the port (mixtral-8x7b, llama4-maverick) against the
JAX package, on the CPU, at the reduced configs (4 experts; mixtral top
2 with a 64-token window, maverick top 1 with a shared expert and a
dense sub-layer before each MoE one), f32. Inputs are made from a seed
with numpy; the weights are drawn by the port from a seed and carried
to the JAX package with ``interop.params_to_jax`` (the LM leaves have
one layout in both), but for the train steps, which start from the
JAX launcher's weights carried to the port.

0. The configs, full and reduced (4 experts), field for field JAX's.
1. ``moe_apply`` against JAX's on the same inputs: the routing (the 0/1
   dispatch tensor, which holds each choice's expert, its slot and
   whether it was kept) equal, and at a tight capacity too, where tokens
   are dropped; the output and the aux loss within rtol 1e-5. The
   cases of ``tests/test_moe.py``: the top-k choice, capacity drops
   (dropped rows exactly 0), top-1 against a manual per-token expert,
   aux = 1 for a uniform router, the shared expert.
2. The model: forward, prefill and 4 greedy decode steps against JAX's,
   logits within 5e-4 and the same tokens; the 4-d expert leaves are not
   conv weights.
3. The sliding-window ring cache: a prompt shorter than the window
   decoded past it agrees with JAX's decode and with the teacher-forced
   forward (capacity lifted, so prefill and decode route alike, as in
   ``tests/test_decode_consistency.py``). A prompt longer than the
   window, not a multiple of it, pins a limit of the reference that the
   port keeps (ROADMAP queue 3): the first decode step overwrites the
   wrong ring slot, so the port agrees with JAX and both leave the
   teacher-forced forward.
4. Three training steps through the launchers (naive attention, the
   paper's rmsprop_warmup + slow_start, the bf16 wire cast) against the
   JAX package's: losses within rtol 2e-5, parameters within a relative
   norm of 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.launch.train import build_train_setup as jsetup
from repro.models import layers as jlayers
from repro.models.common import unbox
from repro.models.transformer import TransformerLM as JLM
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models.common import LeafDraw
from repro_torch.models.transformer import TransformerLM as TLM

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
LOGIT_TOL = 5e-4



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced model's small products run
    faster so, and the port's threads do not contend with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(tp):
    return jax.tree.map(jnp.asarray, interop.params_to_jax(tp))


def _moe_pair(arch, seed=0, **changes):
    cj = dataclasses.replace(jreduced(jget(arch)), **changes)
    ct = dataclasses.replace(treduced(tget(arch)), **changes)
    tp = tlayers.moe_init(
        LeafDraw(torch.Generator().manual_seed(seed)), ct)
    return cj, ct, _to_jax(tp), tp


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches(arch, reduced):
    j, t = jget(arch), tget(arch)
    if reduced:
        j, t = jreduced(j), treduced(t)
        assert t.n_experts == 4 and t.sliding_window in (None, 64)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


class _Capture:
    """Records the dispatch tensor of the first MoE einsum."""

    def __init__(self, einsum):
        self.einsum, self.dispatch = einsum, []

    def __call__(self, spec, *ops, **kw):
        if spec == "gsec,gsd->gecd":
            self.dispatch.append(np.asarray(ops[0]))
        return self.einsum(spec, *ops, **kw)


@pytest.mark.parametrize("arch,cf", [("mixtral-8x7b", 0.3),
                                     ("llama4-maverick-400b-a17b", 1.25)])
def test_moe_apply_routes_as_jax(arch, cf, monkeypatch):
    cj, ct, jp, tp = _moe_pair(arch)
    x = _x((2, 256, ct.d_model))  # 512 tokens: two groups of 256
    jcap = _Capture(jnp.einsum)
    monkeypatch.setattr(jlayers.jnp, "einsum", jcap)
    jy, jaux = jlayers.moe_apply(jp, jnp.asarray(x), cj, capacity_factor=cf)
    monkeypatch.undo()
    tcap = _Capture(torch.einsum)
    monkeypatch.setattr(tlayers.torch, "einsum", tcap)
    ty, taux = tlayers.moe_apply(tp, torch.from_numpy(x), ct,
                                 capacity_factor=cf)
    monkeypatch.undo()
    (jd,), (td,) = jcap.dispatch, tcap.dispatch
    assert jd.shape == td.shape and jd.shape[:2] == (2, 256)
    np.testing.assert_array_equal(td, jd)
    kept = jd.sum(axis=(2, 3))  # choices kept per token
    if cf < 1:
        assert (kept < ct.experts_per_token).any()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _small(arch, e, k, tokens, router_zero=False, seed=0):
    cj, ct, jp, tp = _moe_pair(arch, seed, d_model=16, d_ff=32,
                               n_experts=e, experts_per_token=k)
    if router_zero:
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    return ct, tp, torch.from_numpy(_x((2, tokens, 16)))


def test_topk_selects_highest_prob_experts():
    ct, tp, x = _small("mixtral-8x7b", 4, 2, 8)
    y, aux = tlayers.moe_apply(tp, x, ct, capacity_factor=100.0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) > 0


def test_capacity_drops_tokens():
    ct, tp, x = _small("mixtral-8x7b", 4, 1, 64)
    y_full, _ = tlayers.moe_apply(tp, x, ct, capacity_factor=100.0)
    y_tight, _ = tlayers.moe_apply(tp, x, ct, capacity_factor=0.1)
    norms = y_tight.norm(dim=-1).reshape(-1)
    dropped = norms == 0
    assert dropped.any() and (~dropped).any()
    assert (y_full.norm(dim=-1).reshape(-1)[~dropped] > 0).all()


def test_top1_equals_manual_expert_eval():
    ct, tp, x = _small("mixtral-8x7b", 4, 1, 4)
    y, _ = tlayers.moe_apply(tp, x, ct, capacity_factor=100.0)
    probs = torch.softmax(x @ tp["router"], -1)
    idx = probs.argmax(-1)
    gate = probs.gather(-1, idx[..., None])[..., 0]
    manual = torch.zeros_like(x)
    for b in range(2):
        for t in range(4):
            e = int(idx[b, t])
            h = torch.nn.functional.silu(x[b, t] @ tp["w_gate"][e]) * (
                x[b, t] @ tp["w_up"][e])
            manual[b, t] = gate[b, t] * (h @ tp["w_down"][e])
    np.testing.assert_allclose(y.numpy(), manual.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_aux_loss_uniform_router_is_one():
    ct, tp, x = _small("mixtral-8x7b", 4, 1, 256, router_zero=True)
    _, aux = tlayers.moe_apply(tp, x, ct, capacity_factor=100.0)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)


def test_shared_expert_added():
    ct, tp, x = _small("llama4-maverick-400b-a17b", 4, 1, 8)
    assert {k for k in tp if k.startswith("shared/")} == {
        "shared/w_gate", "shared/w_up", "shared/w_down"}
    y, _ = tlayers.moe_apply(tp, x, ct)
    no_shared = {k: v for k, v in tp.items() if not k.startswith("shared/")}
    y0, _ = tlayers.moe_apply(no_shared, x, ct)
    shared = {k[7:]: v for k, v in tp.items() if k.startswith("shared/")}
    np.testing.assert_allclose(
        y.numpy(), (y0 + tlayers.mlp_apply(shared, x, ct)).numpy(),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- model


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jm = JLM(jreduced(jget(arch)), compute_dtype=jnp.float32,
                 attention_impl="naive", remat=False)
        tm = TLM(treduced(tget(arch)), compute_dtype=torch.float32,
                 attention_impl="naive", device="cpu")
        tp = tm.init(3)
        _MODELS[arch] = (jm, _to_jax(tp), tm, tp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in interop.lm_params_from_jax(
        _np_tree(jax.tree.map(lambda b: np.zeros(b.value.shape, np.int8),
                              jshapes, is_leaf=lambda b: hasattr(
                                  b, "value"))), "cpu").items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    experts = [k for k in tp if k.endswith(("moe/w_up", "moe/w_down"))]
    assert experts and all(tp[k].dim() == 4 and not interop.is_conv_leaf(k)
                           for k in experts)
    b, prompt, steps = 2, 48, 4
    toks = np.random.RandomState(4).randint(0, tm.cfg.vocab_size,
                                            (b, prompt))
    jl, jaux, _ = jm.forward(jp, jnp.asarray(toks))
    tl, taux, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jc, _ = jm.cache_shape(b, prompt + steps, jnp.float32)
    tc, _ = tm.cache_shape(b, prompt + steps, torch.float32)
    assert sorted(tc) == sorted(f"sub{j}/{n}" for j in range(tm.group)
                                for n in ("k", "v"))
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jc)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), tc)
    decode = jax.jit(jm.decode_step)
    for i in range(steps + 1):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        jt = jnp.argmax(jlog[:, -1], -1)[:, None]
        tt = torch.argmax(tlog[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if i == steps:
            break
        jlog, jc = decode(jp, jc, jt, jnp.int32(prompt + i))
        tlog, tc = tm.decode_step(tp, tc, tt, prompt + i)


_RING_JIT = {}


def _ring(prompt, total, monkeypatch):
    """Logits of decode steps after a ``prompt``-token prefill into a
    window-sized ring, port and JAX, and the port's teacher-forced
    forward; capacity lifted so prefill and decode route alike (the JAX
    functions are traced under it, once for the module)."""
    jm, jp, tm, tp = _models("mixtral-8x7b")
    # e / k: every expert has a slot for every token of a group
    roomy = tm.cfg.n_experts / tm.cfg.experts_per_token
    monkeypatch.setattr(jlayers, "CAPACITY_FACTOR", roomy)
    monkeypatch.setattr(tlayers, "CAPACITY_FACTOR", roomy)
    if not _RING_JIT:
        _RING_JIT.update(prefill=jax.jit(jm.prefill),
                         decode=jax.jit(jm.decode_step))
    toks = np.random.RandomState(1).randint(0, tm.cfg.vocab_size,
                                            (1, total))
    full, _, _ = tm.forward(tp, torch.from_numpy(toks))
    jc, _ = jm.cache_shape(1, total, jnp.float32)
    tc, _ = tm.cache_shape(1, total, torch.float32)
    assert tc["sub0/k"].shape[2] == tm.cfg.sliding_window < total
    _, jc = _RING_JIT["prefill"](jp, jnp.asarray(toks[:, :prompt]), jc)
    _, tc = tm.prefill(tp, torch.from_numpy(toks[:, :prompt]), tc)
    decode = _RING_JIT["decode"]
    out = []
    for t in range(prompt, total - 1):
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]), t)
        out.append((t, tl[:, 0].numpy(), np.asarray(jl[:, 0]),
                    full[:, t].numpy()))
    return out


def test_sliding_window_ring_decode_matches_jax(monkeypatch):
    window = treduced(tget("mixtral-8x7b")).sliding_window
    for t, tl, jl, full in _ring(window - 8, window + 8, monkeypatch):
        np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"port vs JAX at {t}")
        np.testing.assert_allclose(tl, full, rtol=2e-3, atol=2e-3,
                                   err_msg=f"ring decode vs forward at {t}")


def test_ring_after_a_prompt_longer_than_the_window_is_the_reference(
        monkeypatch):
    """The reference's limit, pinned: the prefill keeps positions P-L ..
    P-1 in slots 0 .. L-1, and decode writes position P at slot P % L,
    which holds position P - L + P % L, not the oldest. The port agrees
    with the JAX package; both leave the teacher-forced forward."""
    window = treduced(tget("mixtral-8x7b")).sliding_window
    prompt = window + 24  # longer than the window, not a multiple of it
    rows = _ring(prompt, prompt + 4, monkeypatch)
    for t, tl, jl, _ in rows:
        np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"port vs JAX at {t}")
    assert max(float(np.abs(tl - full).max())
               for _, tl, _, full in rows) > 1e-2


# ---------------------------------------------------------------- train


def _opt():
    return dict(kind="rmsprop_warmup", schedule="slow_start",
                base_lr_per_256=3e-3, beta_center=1.0, beta_period=1.0,
                weight_decay=0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, monkeypatch):
    # JAX's eager init draws leaf by leaf (~6 s for a reduced MoE model);
    # jitted, it is one compile. The port starts from JAX's weights
    # either way.
    monkeypatch.setattr(JLM, "init_params",
                        lambda self, key: unbox(jax.jit(self.init)(key)))
    batch, seq, spe = 2, 32, 4
    _, js, jstep, jdata, _, _ = jsetup(
        jreduced(jget(arch)), global_batch=batch, seq_len=seq,
        opt_cfg=JOpt(**_opt()), steps_per_epoch=spe)
    _, ts, tstep, tdata, _, _ = tlaunch.build_train_setup(
        treduced(tget(arch)), global_batch=batch, seq_len=seq,
        opt_cfg=TOpt(**_opt()), steps_per_epoch=spe, device="cpu")
    p0 = interop.lm_params_from_jax(_np_tree(js["params"]), "cpu")
    with torch.no_grad():
        for k, v in ts["params"].items():
            v.copy_(p0[k])
    for i in range(3):
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in
                              jdata.batch_at(i).items()})
        ts, tmet = tstep(ts, tdata.batch_at(i))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tmet["moe_aux"]),
                                   float(jmet["moe_aux"]), rtol=2e-5)
    jflat = interop.lm_params_from_jax(_np_tree(js["params"]), "cpu")
    num = sum(float((ts["params"][k].double() - v.double()).square().sum())
              for k, v in jflat.items())
    den = sum(float(v.double().square().sum()) for v in jflat.values())
    assert (num / den) ** 0.5 < 2e-4
