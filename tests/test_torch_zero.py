"""The port's ZeRO pieces against the JAX package, on the CPU, with no
worker processes: the shard layout of the packed stream, the stream
``rmsprop_warmup`` and ``momentum_sgd`` updates, the checkpoint
converters between the per-leaf and the shard layout, and the
validation errors of ``--zero``. Inputs are made from a seed with numpy.

Tolerances. The layout helpers and the converters are bitwise equal to
the JAX package's. A stream update agrees with JAX's within rtol 2.4e-7
/ atol 1e-8, the tolerance of the hybrid update (ROADMAP queue 3:
scalar-over-tensor division). The port's stream update is bitwise its
own per-leaf update, element by element (the counterpart of
``tests/test_zero.py::test_stream_optimizer_matches_tree_optimizer_elementwise``):
the decay rides along as a stream, and ``g + 0.0 * p`` is ``g``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.distributed import bucketing as jb
from repro.optim import stream as jstream
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt, TrainConfig as TTrain
from repro_torch.configs import ParallelConfig as TPar
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import bucketing as tb
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch
from repro_torch.optim import make_optimizer as tmake_opt
from repro_torch.optim import stream as tstream
from repro_torch.training.step import make_dp_shardmap_train_step

UPDATE_TOL = dict(rtol=2.4e-7, atol=1e-8)
# port shapes (the conv leaf OIHW; the JAX package holds it HWIO)
SHAPES = {"stem/conv": (4, 3, 3, 3), "blk/w": (7, 3), "blk/bias": (3,),
          "norm/scale": (4,), "head/w": (3, 5), "head/b": (5,)}
SPE, GB = 5, 32


def _trees(rng):
    """The same parameters as the port's flat tensors and the JAX
    package's nested numpy (conv HWIO)."""
    flat = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    return tparams, interop.params_to_jax(tparams)


def _plans(bucket_bytes, align, wire="bf16"):
    tparams, jt = _trees(np.random.default_rng(0))
    jtree = jax.tree.map(jnp.asarray, jt)
    return (tb.plan_buckets(tparams, bucket_bytes, wire, align=align),
            jb.plan_buckets(jtree, bucket_bytes, wire, align=align),
            tparams, jtree)


# ---------------------------------------------------------------------------
# the shard layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align", [2, 4, 8])
def test_shard_layout_helpers_equal_jax(align):
    tplan, jplan, _, _ = _plans(64, align)
    assert tplan.n_buckets > 2
    assert [tplan.bucket_bounds(b) for b in range(tplan.n_buckets)] == \
        [jplan.bucket_bounds(b) for b in range(jplan.n_buckets)]
    assert tplan.padded_total == jplan.padded_total
    n = align
    perm = tb.shard_perm(tplan, n)
    np.testing.assert_array_equal(perm, jb.shard_perm(jplan, n))
    arr = np.random.default_rng(1).standard_normal(
        tplan.padded_total).astype(np.float32)
    lay = tb.stream_to_shard_layout(arr, tplan, n)
    np.testing.assert_array_equal(lay, np.asarray(
        jb.stream_to_shard_layout(arr, jplan, n)))
    np.testing.assert_array_equal(
        tb.shard_layout_to_stream(lay, tplan, n),
        np.asarray(jb.shard_layout_to_stream(lay, jplan, n)))
    np.testing.assert_array_equal(tb.shard_layout_to_stream(lay, tplan, n),
                                  arr)
    # on tensors, and worker w's block of the layout is its local_shard
    t = torch.from_numpy(arr)
    tlay = tb.stream_to_shard_layout(t, tplan, n)
    assert torch.equal(tlay, torch.from_numpy(lay))
    assert torch.equal(tb.shard_layout_to_stream(tlay, tplan, n), t)
    size = tb.shard_size(tplan, n)
    for w in range(n):
        shard = tb.local_shard(t, tplan, n, w)
        assert torch.equal(shard, tlay[w * size:(w + 1) * size])
        jparts = jb.split_shard(jnp.asarray(shard.numpy()), jplan, n)
        tparts = tb.split_shard(shard, tplan, n)
        assert len(tparts) == len(jparts) == tplan.n_buckets
        for a, b in zip(tparts, jparts):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the stream updates
# ---------------------------------------------------------------------------


def _shard(rng, n=1000):
    """A seeded stream shard: (p, g, delta, m, wd) at the scales of
    ``tests/test_torch_fused_update.py`` (a training run's: gradients
    ~1e-2, delta ~1e-3, m ~1e-4), wd 0 on a third of the elements (the
    no-decay leaves and the pad)."""
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    d = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    m = (rng.random(n) * 1e-4).astype(np.float32)
    wd = np.where(rng.random(n) < 1 / 3, 0.0, 5e-5).astype(np.float32)
    return p, g, d, m, wd


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["rmsprop_warmup", "momentum_sgd"])
@pytest.mark.parametrize("step", [0, 7])
def test_stream_update_shard_matches_jax(kind, fused, step):
    p, g, d, m, wd = _shard(np.random.default_rng(step + 3))
    jopt = jstream.make_stream_optimizer(JOpt(kind=kind), SPE, GB,
                                         use_fused=fused)
    topt = tstream.make_stream_optimizer(TOpt(kind=kind), SPE, GB,
                                         use_fused=fused)
    assert topt.state_fields == jopt.state_fields == ("delta", "m")
    jp, jd, jm, jmet = jopt.update_shard(
        *(jnp.asarray(a) for a in (p, g, d, m)), jnp.int32(step),
        jnp.asarray(wd))
    tp, td, tm = (torch.from_numpy(a.copy()) for a in (p, d, m))
    out = topt.update_shard(tp, torch.from_numpy(g), td, tm, step,
                            torch.from_numpy(wd))
    assert out[0] is tp and out[1] is td and out[2] is tm  # in place
    for got, want in ((tp, jp), (td, jd), (tm, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **UPDATE_TOL)
    assert out[3]["lr"] == float(jmet["lr"])
    if kind == "momentum_sgd":  # m rides along untouched
        np.testing.assert_array_equal(tm.numpy(), m)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["rmsprop_warmup", "momentum_sgd"])
def test_stream_update_is_bitwise_the_tree_update(kind, fused):
    """One update on the packed stream == the per-leaf update packed
    afterwards, bit for bit, over decayed and no-decay leaves and the
    alignment pad (which stays 0)."""
    rng = np.random.default_rng(1)
    params, _ = _trees(rng)
    grads = {k: torch.from_numpy(rng.standard_normal(v.shape)
                                 .astype(np.float32)) for k, v in
             params.items()}
    plan = tb.plan_buckets(params, bucket_bytes=16, wire=None, align=8)
    assert plan.pad_elems

    def to_stream(tree):
        return torch.cat([tree[k].reshape(-1) for k in plan.names]
                         + [torch.zeros(plan.pad_elems)])

    sopt = tstream.make_stream_optimizer(TOpt(kind=kind), SPE, GB,
                                         use_fused=fused)
    zst = sopt.init(plan.padded_total, "cpu")
    ps, gs = to_stream(params), to_stream(grads)
    wd = torch.from_numpy(sopt.wd_stream(params, plan))
    tree_opt = tmake_opt(TOpt(kind=kind), SPE, GB, use_fused=fused)
    st = tree_opt.init(params)
    for step in range(3):  # the state carries across steps
        tree_opt.update(params, grads, st)
        sopt.update_shard(ps, gs, zst["delta"], zst["m"], step, wd)
        zst["step"] += 1
    n = plan.total_elems
    assert torch.equal(ps[:n], to_stream(params)[:n])
    assert torch.equal(zst["delta"][:n], to_stream(st["delta"])[:n])
    if kind == "rmsprop_warmup":
        assert torch.equal(zst["m"][:n], to_stream(st["m"])[:n])
    for f in ("delta", "m"):
        assert not zst[f][n:].any()
    assert not ps[n:].any()


# ---------------------------------------------------------------------------
# the checkpoint converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_converters_bitwise_equal_jax(n):
    tplan, jplan, tparams, jtree = _plans(64, n)
    tkeys, jkeys = tstream.param_key_tree(tparams), \
        jstream.param_key_tree(jtree)
    assert sorted(tkeys.values()) == sorted(jax.tree.leaves(jkeys))
    rng = np.random.default_rng(n)
    zero = {f"['opt']['{f}']": rng.standard_normal(tplan.padded_total)
            .astype(np.float32) for f in ("delta", "m")}
    zero["['params']['blk']['w']"] = np.ones((7, 3), np.float32)

    def check(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == np.asarray(b[k]).shape, k
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k

    tree_t = tstream.zero_state_to_tree_arrays(zero, tplan, tkeys, n)
    tree_j = jstream.zero_state_to_tree_arrays(zero, jplan, jkeys, n)
    check(tree_t, tree_j)
    assert tree_t["['opt']['delta']['stem']['conv']"].shape == (3, 3, 3, 4)
    back_t = tstream.tree_arrays_to_zero_state(tree_t, tplan, tkeys, n)
    check(back_t, jstream.tree_arrays_to_zero_state(tree_j, jplan, jkeys, n))
    # the pad of the round trip is zeros; every real element comes back
    for f in ("delta", "m"):
        key = f"['opt']['{f}']"
        stream = tb.shard_layout_to_stream(back_t[key], tplan, n)
        want = tb.shard_layout_to_stream(zero[key], tplan, n)
        np.testing.assert_array_equal(stream[:tplan.total_elems],
                                      want[:tplan.total_elems])
        assert not stream[tplan.total_elems:].any()
    # the restore hooks, LARS's one field
    hook = tstream.make_zero_restore_transform(tplan, tkeys, n,
                                               to_zero=False,
                                               fields=("delta",))
    out = hook(zero, {})
    assert "['opt']['m']" in out and "['opt']['delta']" not in out
    check(out, jstream.make_zero_restore_transform(
        jplan, jkeys, n, to_zero=False, fields=("delta",))(zero, {}))
    with pytest.raises(KeyError, match="ZeRO checkpoint"):
        tstream.zero_state_to_tree_arrays(tree_t, tplan, tkeys, n)
    with pytest.raises(KeyError, match="per-leaf"):
        tstream.tree_arrays_to_zero_state(zero, tplan, tkeys, n)


# ---------------------------------------------------------------------------
# validation (the counterparts of tests/test_zero.py's)
# ---------------------------------------------------------------------------


def _zero_cfg(**kw):
    return TTrain(optimizer=TOpt(), parallel=TPar(zero_dp=True, **kw))


def test_zero_requires_bucketed_compression():
    with pytest.raises(ValueError, match="bucketed"):
        make_dp_shardmap_train_step(object(), object(),
                                    _zero_cfg(compression="bf16"))


def test_zero_requires_stream_optimizer():
    opt = tmake_opt(TOpt(), SPE, GB)
    with pytest.raises(ValueError, match="stream optimizer"):
        make_dp_shardmap_train_step(
            object(), opt, _zero_cfg(compression="bf16+bucketed"))


def test_zero_needs_two_workers(tmp_path):
    from repro_torch.models.resnet import ResNet50
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        model = ResNet50(treduced(tget("resnet50")), device="cpu")
        sopt = tstream.make_stream_optimizer(TOpt(), SPE, GB)
        for overlap in (False, True):
            with pytest.raises(ValueError, match="DP degree >= 2"):
                make_dp_shardmap_train_step(
                    model, sopt, _zero_cfg(compression="bf16+bucketed",
                                           overlap_comm=overlap))
    finally:
        shutdown()


def test_zero_rejected_outside_shardmap():
    with pytest.raises(ValueError, match="shard_map"):
        tlaunch.build_train_setup(
            treduced(tget("resnet50")), global_batch=8, seq_len=0,
            opt_cfg=TOpt(), steps_per_epoch=SPE, dp_mode="none",
            zero_dp=True, compression="bf16+bucketed", device="cpu")


def test_zero_with_a_hierarchy_still_raises():
    """ZeRO runs hierarchically (``test_torch_hierarchical.py``) over a
    DP layout of two stages; on the default one-axis layout the split
    still raises, as ``make_hierarchy`` does in the JAX package."""
    from repro_torch.models.resnet import ResNet50
    model = ResNet50(treduced(tget("resnet50")), device="cpu")
    sopt = tstream.make_stream_optimizer(TOpt(), SPE, GB)
    for overlap in (False, True):
        with pytest.raises(ValueError, match="hier_split must be in"):
            make_dp_shardmap_train_step(
                model, sopt, _zero_cfg(compression="bf16+bucketed",
                                       overlap_comm=overlap, hier_split=1),
                mesh_shape={"data": 2})


def test_stream_rmsprop_needs_zero():
    sopt = tstream.make_stream_optimizer(TOpt(), SPE, GB)
    cfg = TTrain(optimizer=TOpt(),
                 parallel=TPar(compression="bf16+bucketed"))
    with pytest.raises(ValueError, match="kind='lars' only"):
        make_dp_shardmap_train_step(object(), sopt, cfg)


@pytest.mark.parametrize("kind,fields", [("rmsprop_warmup", ("delta", "m")),
                                         ("momentum_sgd", ("delta", "m")),
                                         ("lars", ("delta",))])
def test_stream_optimizer_state_fields(kind, fields):
    sopt = tstream.make_stream_optimizer(TOpt(kind=kind, state_dtype="bfloat16"),
                                         SPE, GB)
    assert sopt.kind == kind and sopt.state_fields == fields
    st = sopt.init(12, "cpu")
    assert st["step"] == 0 and set(st) == {"step", *fields}
    assert all(st[f].shape == (12,) and st[f].dtype == torch.bfloat16
               for f in fields)
