"""The port's configs, synthetic data and paper math against the JAX
package, on the same inputs.

Bitwise where both sides run the same f32 ops in the same order: the
data (numpy Philox on both sides), the piecewise schedules, the
momentum update, the wire cast. ``exp`` and ``sigmoid`` are computed by
different libraries (XLA's CPU code vs PyTorch's), so the ELU and
sigmoid transitions are held to 2 f32 ulp (rtol 2.4e-7). The hybrid
update is held against op-by-op (eager) JAX: bitwise for most inputs,
but XLA rounds the scalar-over-tensor division differently in the last
bit for a few elements, and where mu1*delta and coef*g cancel that bit
is all the result has, so rtol 2.4e-7 with atol 1e-8 (about one ulp
of the operands; jitted JAX differs from eager JAX far more, by fusing
into FMAs). BN statistics sum in another order: rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.core import batchnorm as jbn
from repro.core import compression as jcomp
from repro.core import optimizer as jopt
from repro.core import schedules as jsch
from repro.data import synthetic as jsyn
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.core import batchnorm as tbn
from repro_torch.core import compression as tcomp
from repro_torch.core import optimizer as topt
from repro_torch.core import schedules as tsch
from repro_torch.data import synthetic as tsyn

EPOCHS = [0.0, 0.5, 3.25, 4.999, 5.0, 7.5, 9.99, 10.0, 11.3, 12.5, 14.0,
          29.9, 30.0, 45.0, 69.0, 75.0, 84.9, 85.0, 89.0, 95.0]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["ModelConfig", "ShapeConfig",
                                  "OptimizerConfig", "ParallelConfig",
                                  "InputConfig", "TrainConfig"])
def test_config_fields_match(name):
    jf = dataclasses.fields(getattr(jbase, name))
    tf = dataclasses.fields(getattr(tbase, name))
    assert [(f.name, f.type) for f in jf] == [(f.name, f.type) for f in tf]
    if name not in ("ModelConfig", "ShapeConfig"):
        assert dataclasses.asdict(getattr(jbase, name)()) == \
            dataclasses.asdict(getattr(tbase, name)())


@pytest.mark.parametrize("reduced", [False, True])
def test_resnet50_config_matches(reduced):
    j, t = jget("resnet50"), tget("resnet50")
    if reduced:
        j, t = jreduced(j), treduced(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tget("llama3.2-1b")


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("step", [0, 3])
def test_image_batches_bitwise(split, step):
    cfg_j, cfg_t = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    shp_j = jbase.ShapeConfig("t", 0, 8, "train")
    shp_t = tbase.ShapeConfig("t", 0, 8, "train")
    jd = jsyn.make_data(cfg_j, shp_j, seed=5, split=split)
    td = tsyn.make_data(cfg_t, shp_t, seed=5, split=split)
    assert np.array_equal(jd.templates, td.templates)
    jb, tb = jd.batch_at(step), td.batch_at(step)
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype
        assert np.array_equal(jb[k], tb[k]), k


@pytest.mark.parametrize("host_id", [0, 1, 2, 3])
def test_host_shards_bitwise(host_id):
    cfg_j, cfg_t = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    shp_j = jbase.ShapeConfig("t", 0, 8, "train")
    shp_t = tbase.ShapeConfig("t", 0, 8, "train")
    jd = jsyn.make_data(cfg_j, shp_j, seed=1, num_hosts=4, host_id=host_id,
                        noise=0.9)
    td = tsyn.make_data(cfg_t, shp_t, seed=1, num_hosts=4, host_id=host_id,
                        noise=0.9)
    assert td.sample_offset == jd.sample_offset == 2 * host_id
    for k in ("images", "labels"):
        assert np.array_equal(jd.batch_at(2)[k], td.batch_at(2)[k])


def test_train_and_val_are_disjoint_and_lm_data_raises():
    d_tr = tsyn.SyntheticImageData(10, 8, 4, split="train")
    d_va = tsyn.SyntheticImageData(10, 8, 4, split="val")
    assert not np.array_equal(d_tr.batch_at(0)["images"],
                              d_va.batch_at(0)["images"])
    with pytest.raises(NotImplementedError):
        tsyn.make_data(tbase.ModelConfig("lm", "dense", 2, 8, 2, 2, 16, 32),
                       tbase.ShapeConfig("t", 16, 2, "train"))


# -------------------------------------------------------------- schedules


@pytest.mark.parametrize("kind", ["elu", "sudden", "linear", "sigmoid"])
def test_alpha_sgd_schedule(kind):
    j = np.array([jsch.alpha_sgd_schedule(e, kind=kind) for e in EPOCHS])
    t = np.array([tsch.alpha_sgd_schedule(e, kind=kind).item()
                  for e in EPOCHS], np.float32)
    if kind in ("elu", "sigmoid"):
        np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=0)
    else:
        assert np.array_equal(_bits(j), _bits(t))


@pytest.mark.parametrize("kind", ["slow_start", "goyal", "poly",
                                  "constant"])
def test_lr_schedules_bitwise(kind):
    jf = jsch.make_lr_schedule(kind, 8192)
    tf = tsch.make_lr_schedule(kind, 8192)
    j = np.array([jf(e) for e in EPOCHS], np.float32)
    t = np.array([tf(e).item() for e in EPOCHS], np.float32)
    assert t.dtype == np.float32
    assert np.array_equal(_bits(j), _bits(t))


# -------------------------------------------------------------- optimizer


def _leaf(seed, shape=(257, 3)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * s
            for s in (1.0, 1.0, 0.1, 0.01)]


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("eta,alpha", [(0.05, 0.0), (1.6, 0.03),
                                       (0.25, 0.5), (3.2, 1.0)])
def test_hybrid_update(eta, alpha, wd):
    g, p, d, m = _leaf(0)
    m = np.abs(m)
    eta32, a32 = np.float32(eta), np.float32(alpha)
    jh = jopt.HybridHyper(eta=jnp.float32(eta32), alpha_sgd=jnp.float32(a32))
    th = topt.HybridHyper(eta=float(eta32), alpha_sgd=float(a32))
    assert topt.alpha_rmsprop(th) == float(jopt.alpha_rmsprop(jh))
    jout = jopt.hybrid_update(jnp.asarray(g), jnp.asarray(p),
                              jnp.asarray(d), jnp.asarray(m), jh, wd)
    tout = topt.hybrid_update(*(torch.from_numpy(a) for a in (g, p, d, m)),
                              th, wd)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), a, rtol=2.4e-7, atol=1e-8)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_momentum_update_bitwise(wd):
    g, p, d, _ = _leaf(1)
    jh = jopt.HybridHyper(eta=jnp.float32(0.4), alpha_sgd=jnp.float32(1.0))
    th = topt.HybridHyper(eta=float(np.float32(0.4)), alpha_sgd=1.0)
    jout = jopt.momentum_sgd_update(jnp.asarray(g), jnp.asarray(p),
                                    jnp.asarray(d), jh, wd)
    tout = topt.momentum_sgd_update(
        *(torch.from_numpy(a) for a in (g, p, d)), th, wd)
    for a, b in zip(jout, tout):
        assert np.array_equal(_bits(a), _bits(b.numpy()))


# ------------------------------------------------------------ compression


@pytest.mark.parametrize("spec", [None, "none", "bf16", "f16",
                                  "bf16+bucketed", "bucketed"])
def test_parse_compression(spec):
    assert tcomp.parse_compression(spec) == jcomp.parse_compression(spec)


@pytest.mark.parametrize("bad", ["fp8", "bf16+f16", "bucketed+bucketed"])
def test_parse_compression_rejects(bad):
    with pytest.raises(ValueError):
        tcomp.parse_compression(bad)


@pytest.mark.parametrize("wire", [None, "bf16", "f16"])
def test_wire_cast_bitwise(wire):
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((64, 33)) * np.logspace(-6, 3, 33)).astype(
        np.float32)
    j = jcomp.simulate_wire_cast({"w": jnp.asarray(g)}, wire)["w"]
    t = tcomp.simulate_wire_cast({"w": torch.from_numpy(g)}, wire)["w"]
    assert t.dtype == torch.float32
    assert np.array_equal(_bits(j), _bits(t.numpy()))


# -------------------------------------------------------------- batchnorm


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bn_stats_and_apply(dt):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 5, 5, 16)) * 3 + 2).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jm, jv = jbn.bn_batch_stats(jx)
    tm, tv = tbn.bn_batch_stats(tx)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6)
    jy = jbn.bn_apply_stats(jx, jm, jv, jnp.asarray(scale), jnp.asarray(bias))
    ty = tbn.bn_apply_stats(tx, tm, tv, torch.from_numpy(scale),
                            torch.from_numpy(bias))
    assert ty.dtype == tdt
    # bf16: both sides round x*inv and the sum to bf16; one ulp apart at
    # most where the f32 inv differs in its last bits
    tol = dict(rtol=1e-5, atol=1e-5) if dt == "f32" else \
        dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), **tol)
