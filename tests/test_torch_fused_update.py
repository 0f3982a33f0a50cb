"""The port's fused hybrid update (``kernels/fused_update.py``, its plain
version on the CPU), for one leaf and for every leaf at once, against
the JAX package's Pallas kernel in interpret mode
(``repro.kernels.ops.fused_hybrid_update``, leaf by leaf) and its oracle
``ref.hybrid_update``, on the same numpy inputs.

Tolerance rtol 2.4e-7 with atol 1e-8, the one ROADMAP queue 3 found for
the plain update against eager JAX: the Pallas kernel rounds
``(1 - mu2) * g * g`` as ``((1 - mu2) * g) * g`` where the port rounds
``(1 - mu2) * (g * g)``, and XLA rounds the scalar-over-tensor division
differently in the last bit for a few elements; where ``mu1 * delta``
and ``coef * g`` cancel, that bit is all the result has. The fused
optimizer against the port's own plain optimizer is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.optimizer import HybridHyper as JHyper
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import OptimizerConfig
from repro_torch.core.optimizer import HybridHyper as THyper
from repro_torch.kernels import fused_update
from repro_torch.kernels.ops import (fused_hybrid_update,
                                     fused_hybrid_update_leaves)
from repro_torch.optim import make_optimizer

TOL = dict(rtol=2.4e-7, atol=1e-8)
ETA = 0.05


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    d = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    m = (rng.random(n) * 1e-4).astype(np.float32)
    wd = np.where(rng.random(n) < 0.5, 1e-4, 0.0).astype(np.float32)
    return g, p, d, m, wd


@pytest.mark.parametrize("a_sgd", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("wd_kind", ["none", "scalar", "stream"])
@pytest.mark.parametrize("n", [1, 1000, 128 * 513 + 7])
def test_plain_fused_update_matches_jax(n, wd_kind, a_sgd):
    g, p, d, m, wd_s = _inputs(n, seed=n)
    a_sgd = float(np.float32(a_sgd))
    wd = {"none": 0.0, "scalar": 1e-4, "stream": wd_s}[wd_kind]
    th = THyper(eta=ETA, alpha_sgd=a_sgd)
    jh = JHyper(eta=ETA, alpha_sgd=a_sgd)
    tt = [torch.from_numpy(a.copy()) for a in (g, p, d, m)]
    twd = torch.from_numpy(wd) if wd_kind == "stream" else wd
    out = fused_hybrid_update(*tt, th, twd)
    assert all(o is t for o, t in zip(out, tt[1:]))  # in place
    jwd = jnp.asarray(wd) if wd_kind == "stream" else wd
    jk = jops.fused_hybrid_update(jnp.asarray(g), jnp.asarray(p),
                                  jnp.asarray(d), jnp.asarray(m), jh, jwd)
    for got, k in zip(out, jk):
        np.testing.assert_allclose(got.numpy(), np.asarray(k), **TOL)
    if wd_kind != "stream":  # the oracle takes a scalar decay only
        jr = jref.hybrid_update(jnp.asarray(g), jnp.asarray(p),
                                jnp.asarray(d), jnp.asarray(m), eta=ETA,
                                alpha_sgd=a_sgd, weight_decay=jwd)
        for got, r in zip(out, jr):
            np.testing.assert_allclose(got.numpy(), np.asarray(r), **TOL)


# leaf shapes of the multi-leaf update: one element, a BN vector, an odd
# length, a conv kernel, and more rows than one Pallas block
LEAF_SHAPES = [(1,), (64,), (1000,), (4, 3, 3, 3), (128 * 513 + 7,)]
LEAF_DECAYS = [1e-4, 0.0, 1e-4, 1e-4, 0.0]


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("a_sgd", [0.0, 0.37, 1.0])
def test_plain_leaves_update_matches_jax(a_sgd, offset):
    """The multi-leaf wrapper (its plain path, leaf by leaf) against the
    Pallas kernel per leaf, with mixed decays and the gradients given as
    views into one flat stream at an odd offset, as ``unpack`` gives
    them."""
    rng = np.random.default_rng(offset)
    sizes = [int(np.prod(s)) for s in LEAF_SHAPES]
    flat = (rng.standard_normal(offset + sum(sizes)) * 1e-2).astype(
        np.float32)
    a_sgd = float(np.float32(a_sgd))
    th = THyper(eta=ETA, alpha_sgd=a_sgd)
    jh = JHyper(eta=ETA, alpha_sgd=a_sgd)
    stream = torch.from_numpy(flat.copy())
    gs, states, lo = [], [], offset
    for shape, n in zip(LEAF_SHAPES, sizes):
        gs.append(stream[lo:lo + n].view(shape))
        lo += n
        states.append([a.reshape(shape) for a in _inputs(n, seed=n)[1:4]])
    ps, ds, ms = ([torch.from_numpy(s[i].copy()) for s in states]
                  for i in range(3))
    out = fused_hybrid_update_leaves(gs, ps, ds, ms, th, LEAF_DECAYS)
    assert all(o is t for o, t in zip(out, (ps, ds, ms)))  # in place
    for i, (g, (p, d, m), wd) in enumerate(zip(gs, states, LEAF_DECAYS)):
        jk = jops.fused_hybrid_update(jnp.asarray(g.numpy()), jnp.asarray(p),
                                      jnp.asarray(d), jnp.asarray(m), jh, wd)
        for got, k in zip((ps[i], ds[i], ms[i]), jk):
            assert got.shape == LEAF_SHAPES[i]
            np.testing.assert_allclose(got.numpy(), np.asarray(k), **TOL)


def test_leaves_wrapper_checks_counts_and_counts_nothing_on_cpu():
    g, p, d, m, _ = _inputs(6, seed=0)
    tt = [[torch.from_numpy(a.copy())] for a in (g, p, d, m)]
    fused_update.reset_launch_counts()
    with pytest.raises(ValueError, match="1 g, 1 p, 1 delta, 1 m and 2"):
        fused_hybrid_update_leaves(*tt, THyper(eta=ETA, alpha_sgd=0.5),
                                   [0.0, 1e-4])
    fused_hybrid_update_leaves(*tt, THyper(eta=ETA, alpha_sgd=0.5), [1e-4])
    assert fused_update.LAUNCHES == {"hybrid_update": 0,
                                     "seg_sq_partials": 0, "lars_update": 0}


def test_wrapper_keeps_leaf_shape_and_counts_nothing_on_cpu():
    g, p, d, m, _ = _inputs(6 * 35, seed=0)
    tt = [torch.from_numpy(a.reshape(6, 35).copy()) for a in (g, p, d, m)]
    fused_update.reset_launch_counts()
    fused_hybrid_update(*tt, THyper(eta=ETA, alpha_sgd=0.5), 1e-4)
    assert tt[1].shape == (6, 35)
    assert fused_update.LAUNCHES == {"hybrid_update": 0,
                                     "seg_sq_partials": 0, "lars_update": 0}
    with pytest.raises(ValueError, match="lie on the CPU or on one"):
        fused_hybrid_update(tt[0], tt[1], tt[2], tt[3].to("meta"),
                            THyper(eta=ETA, alpha_sgd=0.5))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_fused_optimizer_matches_plain_bitwise(state_dtype):
    """Three steps of rmsprop_warmup through the fused leaf update and
    through the plain one: the same parameters and state, bitwise."""
    cfg = OptimizerConfig(state_dtype=state_dtype)
    rng = np.random.default_rng(0)
    shapes = {"conv": (4, 3, 3, 3), "bn/scale": (4,), "bn/bias": (4,),
              "fc/w": (4, 10), "fc/b": (10,)}
    base = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    runs = []
    for fused in (False, True):
        opt = make_optimizer(cfg, 4, 256, use_fused=fused)
        params = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
        state = opt.init(params)
        grng = np.random.default_rng(1)
        for _ in range(3):
            grads = {k: torch.from_numpy(grng.standard_normal(s).astype(
                np.float32) * 1e-2) for k, s in shapes.items()}
            params, state, metrics = opt.update(params, grads, state)
        runs.append((params, state, metrics))
    (pp, ps, pm), (fp, fs, fm) = runs
    assert pm == fm and ps["step"] == fs["step"] == 3
    for k in shapes:
        assert torch.equal(pp[k], fp[k]), k
        for f in ("delta", "m"):
            assert fs[f][k].dtype == getattr(torch, state_dtype)
            assert torch.equal(ps[f][k], fs[f][k]), (f, k)
