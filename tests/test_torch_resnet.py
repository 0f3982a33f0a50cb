"""The port's ResNet-50 against the JAX package's, on the same weights
(moved over with ``repro_torch.interop``) and the same numpy images.

Mostly f32 (both sides' convolutions in full f32 on the CPU): the
logits, the loss, every gradient and the new BN state agree to rtol
1e-4 / atol 1e-5 (sums of a few thousand products taken in another
order), for the unfused path and the fused BN path (the port's plain
versions vs the JAX kernels in interpret mode). Eval reuses the BN
state of the train pass, as the paper's BN does. One test runs bf16
compute, with its own stated tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.models.resnet import ResNet50 as JResNet
from repro_torch import interop
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.models import build_model
from repro_torch.models.resnet import ResNet50 as TResNet, same_pads

TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(fused, stages=None, width=None):
    jc, tc = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    if stages is not None:
        import dataclasses
        jc = dataclasses.replace(jc, conv_stages=stages, conv_width=width)
        tc = dataclasses.replace(tc, conv_stages=stages, conv_width=width)
    jm = JResNet(jc, compute_dtype=jnp.float32, fused_bn=fused)
    tm = TResNet(tc, compute_dtype=torch.float32, fused_bn=fused,
                 device="cpu")
    jp, _ = jm.init_params(jax.random.PRNGKey(3))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp


def _batch(n=4, size=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, size, size, 3)).astype(
        np.float32), "labels": rng.integers(0, classes, n).astype(np.int32)}


def _tbatch(b):
    return {"images": torch.from_numpy(b["images"]),
            "labels": torch.from_numpy(b["labels"]).long()}


def _state_close(js, ts, tol=TOL):
    assert set(js) == set(ts)
    for site in js:
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(ts[site][k].numpy(),
                                       np.asarray(js[site][k]),
                                       err_msg=f"{site}/{k}", **tol)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_train_and_eval_match(fused):
    jm, tm, jp, tp = _pair(fused)
    b = _batch()
    jlog, jstate = jm.apply(jp, jm.init_state(), jnp.asarray(b["images"]),
                            train=True)
    tlog, tstate = tm.apply(tp, tm.init_state(),
                            torch.from_numpy(b["images"]), train=True)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               **TOL)
    _state_close(jstate, tstate)
    jev, _ = jm.apply(jp, jstate, jnp.asarray(b["images"]), train=False)
    with torch.no_grad():
        tev, _ = tm.apply(tp, tstate, torch.from_numpy(b["images"]),
                          train=False)
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_grads_match(fused):
    jm, tm, jp, tp = _pair(fused)
    b = _batch(seed=1)

    def jloss(p):
        return jm.loss_fn(p, jm.init_state(), {
            "images": jnp.asarray(b["images"]),
            "labels": jnp.asarray(b["labels"])}, 0.1)[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tl, _ = tm.loss_fn(tp, tm.init_state(), _tbatch(b), 0.1)
    tg = torch.autograd.grad(tl, list(tp.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jflat = interop.params_from_jax(jax.tree.map(np.asarray, jg),
                                    device="cpu")
    for (k, _), g in zip(tp.items(), tg):
        scale = float(jflat[k].abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale,
                                   jflat[k].numpy() / scale, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_forward_matches(fused):
    """bf16 compute on both sides (the main path's dtype). Every
    activation is rounded to bf16 on both sides from f32 values that may
    differ in their last bits, so an element can land one bf16 ulp
    (2^-8 relative) apart and carry that forward: logits within 1% of
    their largest magnitude, BN statistics within rtol 1e-2 / atol
    1e-3."""
    jc, tc = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    jm = JResNet(jc, compute_dtype=jnp.bfloat16, fused_bn=fused)
    tm = TResNet(tc, compute_dtype=torch.bfloat16, fused_bn=fused,
                 device="cpu")
    jp, _ = jm.init_params(jax.random.PRNGKey(2))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = _batch(seed=2)
    jlog, jstate = jm.apply(jp, jm.init_state(), jnp.asarray(b["images"]),
                            train=True)
    tlog, tstate = tm.apply(tp, tm.init_state(),
                            torch.from_numpy(b["images"]), train=True)
    assert tlog.dtype == torch.float32
    jl = np.asarray(jlog)
    np.testing.assert_allclose(tlog.detach().numpy(), jl, rtol=0,
                               atol=1e-2 * np.abs(jl).max())
    _state_close(jstate, tstate, dict(rtol=1e-2, atol=1e-3))


def test_full_depth_forward_matches():
    """All four stages at their real depths (3, 4, 6, 3), width 8: the
    stage wiring, every stride-2 projection and the 53 BN sites. Fifty
    f32 layers, each renormalized by BN over few rows (16 at stage 3),
    carry the reduction-order differences further: rtol/atol 1e-3."""
    jm, tm, jp, tp = _pair(False, stages=(3, 4, 6, 3), width=8)
    assert len(tm.init_state()) == 53
    b = _batch(n=4, size=64, seed=2)
    jlog, jstate = jm.apply(jp, jm.init_state(), jnp.asarray(b["images"]),
                            train=True)
    tlog, tstate = tm.apply(tp, tm.init_state(),
                            torch.from_numpy(b["images"]), train=True)
    tol = dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               **tol)
    _state_close(jstate, tstate, tol)


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
    (32, 7, 2, (2, 3))])
def test_same_pads_follow_xla(size, k, stride, want):
    assert same_pads(size, k, stride) == want


def test_interop_round_trip_and_checkpoint_keys():
    jm, tm, jp, tp = _pair(False)
    assert set(tp) == set(tm.params())
    for k, v in tm.params().items():
        assert tp[k].shape == v.shape, k
    back = interop.params_to_jax(tp)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for part in path:
            node = node[part.key]
        assert np.array_equal(node, np.asarray(leaf))
    # a checkpoint's arrays.npz is keyed by keystr paths of the state
    arrays = {jax.tree_util.keystr(path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  {"params": jp, "opt": {"step": jnp.int32(0)}})}
    loaded = interop.load_reference_arrays(arrays, device="cpu")
    assert set(loaded) == set(tp)
    assert all(torch.equal(loaded[k], tp[k]) for k in tp)
    jstate = jax.tree.map(np.asarray, jm.init_state())
    tstate = interop.state_from_jax(jstate, device="cpu")
    assert interop.state_to_jax(tstate).keys() == jstate.keys()


def test_model_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(treduced(tget("resnet50")))
    m = build_model(treduced(tget("resnet50")), device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
