"""The port's stream-LARS pieces against the JAX package, on the CPU:
the stream's leaf segments and worker shards, the per-segment norms and
the trust-scaled update (the plain versions of the ``seg_sq_partials``
and ``lars_update`` kernels, against ``segment_sum`` and the Pallas
kernels in interpret mode), the tree and stream LARS, and error
feedback. Inputs are made from a seed with numpy.

Tolerances. The layout helpers and error feedback are bitwise. The
segment norms agree to rtol 1e-6: ``segment_sum`` adds each segment in
element order, the port sums each segment's slice with ``torch.sum``
(another fold), and the Pallas kernel through a one-hot dot. The LARS
update agrees to rtol 1e-6 / atol 1e-7, the tolerance of the JAX
package's own kernel test (``tests/test_lars_stream.py``). The tree
LARS over 3 steps lies within rtol 1e-6 / atol 1e-7 of JAX's (trust
ratios from norms one rounding apart). The port's stream LARS with one
worker is bitwise equal to its tree LARS: both take each leaf's norm as
one contiguous slice through the same ``segment_sq_partials``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.core import compression as jcomp
from repro.distributed import bucketing as jb
from repro.kernels import ops as jops
from repro.optim import make_optimizer as jmake_opt
from repro.optim import stream as jstream
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt, TrainConfig as TTrain
from repro_torch.configs import ParallelConfig as TPar
from repro_torch.core import compression as tcomp
from repro_torch.distributed import bucketing as tb
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels.ops import fused_lars_update, fused_segment_sq_partials
from repro_torch.optim import make_optimizer as tmake_opt
from repro_torch.optim import stream as tstream
from repro_torch.training.step import make_dp_shardmap_train_step

SEG_TOL = dict(rtol=1e-6)
UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"blk/w": (7, 3), "blk/bias": (3,), "norm/scale": (4,),
          "head/w": (3, 5), "head/b": (5,)}


def _trees(rng):
    """The same mixed tree (decayed weights and no-decay bias/scale
    leaves) as the JAX package's nested numpy and the port's flat
    tensors."""
    flat = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    return interop._unflatten(flat), {k: torch.from_numpy(v.copy())
                                      for k, v in flat.items()}


def _plans(bucket_bytes, align):
    jt, tt = _trees(np.random.default_rng(0))
    jtree = jax.tree.map(jnp.asarray, jt)
    return (jtree, jb.plan_buckets(jtree, bucket_bytes, None, align=align),
            tt, tb.plan_buckets(tt, bucket_bytes, None, align=align))


# ---------------------------------------------------------------------------
# the stream's layout: bitwise equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket_bytes,align", [(1 << 20, 1), (48, 1),
                                                (64, 2), (64, 4)])
def test_stream_layout_matches_jax(bucket_bytes, align):
    jtree, jplan, tt, tplan = _plans(bucket_bytes, align)
    assert (tplan.n_buckets, tplan.padded_total) == (jplan.n_buckets,
                                                    jplan.padded_total)
    seg = tb.segment_ids_stream(tplan)
    np.testing.assert_array_equal(seg, jb.segment_ids_stream(jplan))
    np.testing.assert_array_equal(
        tstream.decay_wd_stream(tt, tplan, 1e-4),
        jstream.decay_wd_stream(jtree, jplan, 1e-4))
    np.testing.assert_array_equal(tstream.trust_mask_segments(tt, tplan),
                                  jstream.trust_mask_segments(jtree, jplan))
    x = np.arange(tplan.padded_total, dtype=np.float32) * 0.5 - 3.0
    for n in {1, align}:
        assert tb.shard_chunks(tplan, n) == jb.shard_chunks(jplan, n)
        assert tb.shard_size(tplan, n) == jb.shard_size(jplan, n)
        for w in range(n):
            np.testing.assert_array_equal(
                tb.local_shard(torch.from_numpy(x), tplan, n, w).numpy(),
                np.asarray(jb.local_shard(jnp.asarray(x), jplan, n, w)))
            local_seg = tb.local_shard(torch.from_numpy(seg), tplan, n, w)
            assert bool((local_seg[1:] >= local_seg[:-1]).all())
    for compression in ("bf16+bucketed", "bucketed"):
        assert tstream.zero_padded_total(tt, compression, bucket_bytes,
                                         align) == \
            jstream.zero_padded_total(jtree, compression, bucket_bytes,
                                      align)


def test_shard_chunks_refuses_an_unaligned_plan():
    _, _, _, tplan = _plans(64, 1)
    with pytest.raises(ValueError, match="align=3"):
        tb.shard_chunks(tplan, 3)


# ---------------------------------------------------------------------------
# the two kernels' plain versions against segment_sum and the Pallas
# kernels in interpret mode
# ---------------------------------------------------------------------------


def _segments(kind, rng):
    """(ids, num_segments) of each id pattern the kernels must take."""
    if kind == "sorted_with_empty":  # segment 2 holds no element
        return np.repeat(np.arange(5), [100, 80, 0, 1, 119]), 5
    if kind == "one_element":
        return np.zeros(1, np.int64), 1
    if kind == "unsorted":
        return rng.integers(0, 7, 517), 7
    return np.repeat(np.arange(163), rng.integers(1, 40, 163)), 163


@pytest.mark.parametrize("kind", ["sorted_with_empty", "one_element",
                                  "unsorted", "many"])
def test_segment_norms_match_segment_sum_and_pallas(kind):
    rng = np.random.default_rng(7)
    ids, n_seg = _segments(kind, rng)
    ids = ids.astype(np.int32)
    n = ids.size
    g, p = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    wd = np.where(rng.random(n) < 0.5, 1e-4, 0.0).astype(np.float32)
    tt = [torch.from_numpy(a.copy()) for a in (p, g, wd, ids)]
    tfu.reset_launch_counts()
    got = fused_segment_sq_partials(*tt, n_seg)
    assert got.shape == (2, n_seg) and got.dtype == torch.float32
    assert tfu.LAUNCHES["seg_sq_partials"] == 0  # the CPU runs the plain one
    np.testing.assert_array_equal(
        got[0].numpy(), tb.segment_sq_partials(tt[0], tt[3], n_seg).numpy())
    jp, jg, jwd, jseg = (jnp.asarray(a) for a in (p, g, wd, ids))
    want = np.stack([np.asarray(jb.segment_sq_partials(jp, jseg, n_seg)),
                     np.asarray(jb.segment_sq_partials(jg + jwd * jp, jseg,
                                                       n_seg))])
    np.testing.assert_allclose(got.numpy(), want, **SEG_TOL)
    pallas = jops.fused_segment_sq_partials(jp, jg, jwd, jseg, n_seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **SEG_TOL)
    if kind == "sorted_with_empty":
        assert got[:, 2].tolist() == [0.0, 0.0]


def test_segment_norms_drop_ids_out_of_range():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    ids = torch.tensor([-1, 0, 0, 2], dtype=torch.int32)
    assert tb.segment_sq_partials(x, ids, 2).tolist() == [13.0, 0.0]


@pytest.mark.parametrize("n", [1, 300, 128 * 9 + 5])
def test_lars_update_matches_pallas(n):
    rng = np.random.default_rng(n)
    n_seg = 3
    ids = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    g, p, d = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    wd = rng.uniform(0, 1e-3, n).astype(np.float32)
    trust = np.asarray([1.0, 0.5, 2.0], np.float32)
    eta, mu1 = 0.3, 0.9
    tt = [torch.from_numpy(a.copy()) for a in (g, p, d, wd, ids, trust)]
    out = fused_lars_update(*tt, eta, mu1)
    assert out[0] is tt[1] and out[1] is tt[2]  # in place
    jp, jd = jops.fused_lars_update(*(jnp.asarray(a) for a in
                                      (g, p, d, wd, ids, trust)),
                                    jnp.float32(eta), mu1)
    np.testing.assert_allclose(tt[1].numpy(), np.asarray(jp), **UPDATE_TOL)
    np.testing.assert_allclose(tt[2].numpy(), np.asarray(jd), **UPDATE_TOL)


def test_kernel_wrappers_refuse_mixed_devices():
    x = torch.zeros(4)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="lie on the CPU or on one"):
        fused_segment_sq_partials(x, x, x.to("meta"), ids, 1)
    with pytest.raises(ValueError, match="lie on the CPU or on one"):
        fused_lars_update(x, x, x, x, ids, torch.ones(1, device="meta"),
                          0.1, 0.9)


# ---------------------------------------------------------------------------
# tree LARS against the JAX package; stream LARS against the tree
# ---------------------------------------------------------------------------

LARS = dict(kind="lars", schedule="poly", warmup_epochs=1.0,
            total_epochs=4.0, base_lr_per_256=0.4)


def _grads(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def test_tree_lars_matches_jax_over_three_steps():
    rng = np.random.default_rng(6)
    jt, tparams = _trees(rng)
    jopt = jmake_opt(JOpt(**LARS), steps_per_epoch=5, global_batch=32)
    topt = tmake_opt(TOpt(**LARS), steps_per_epoch=5, global_batch=32)
    jparams = jax.tree.map(jnp.asarray, jt)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(3):
        g = _grads(rng)
        jparams, jstate, jm = jopt.update(
            jparams, jax.tree.map(jnp.asarray, interop._unflatten(g)),
            jstate)
        tparams, tstate, tm = topt.update(
            tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        assert tm["lr"] == float(jm["lr"])
    jflat = interop._flatten(jax.tree.map(np.asarray, jparams))
    jdelta = interop._flatten(jax.tree.map(np.asarray, jstate["delta"]))
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].numpy(), jflat[k],
                                   err_msg=k, **UPDATE_TOL)
        np.testing.assert_allclose(tstate["delta"][k].numpy(), jdelta[k],
                                   err_msg=k, **UPDATE_TOL)
    # bias/BN leaves take no trust ratio: plain momentum
    assert tstate["step"] == 3


@pytest.mark.parametrize("use_fused", [False, True])
def test_stream_lars_equals_tree_lars_bitwise_single_process(use_fused):
    rng = np.random.default_rng(6)
    _, tree_params = _trees(rng)
    stream_params = {k: v.clone() for k, v in tree_params.items()}
    cfg = TOpt(**LARS)
    ref = tmake_opt(cfg, steps_per_epoch=5, global_batch=32)
    sopt = tstream.make_stream_optimizer(cfg, 5, 32, use_fused=use_fused)
    plan = tb.plan_buckets(stream_params, bucket_bytes=48, wire=None)
    seg = torch.from_numpy(tb.segment_ids_stream(plan))
    wd = torch.from_numpy(sopt.wd_stream(stream_params, plan))
    tmask = torch.from_numpy(tstream.trust_mask_segments(stream_params,
                                                         plan))
    ref_state = ref.init(tree_params)
    sstate = sopt.init(plan.padded_total, "cpu")
    for _ in range(3):
        g = {k: torch.from_numpy(v) for k, v in _grads(rng).items()}
        ref.update(tree_params, g, ref_state)
        p_stream = torch.cat([stream_params[k].reshape(-1)
                              for k in plan.names])
        g_stream = torch.cat([g[k].reshape(-1) for k in plan.names])
        partials = sopt.segment_partials(p_stream, g_stream, wd, seg,
                                         len(plan.slots) + 1)
        trust = sopt.trust_ratios(partials, tmask)
        assert bool((trust[~tmask] == 1.0).all())
        assert bool((trust[tmask] < 1.0).all())
        sopt.update_shard(p_stream, g_stream, sstate["delta"],
                          sstate["step"], wd, seg, trust)
        sstate["step"] += 1
        for k, s in zip(plan.names, plan.slots):
            stream_params[k].copy_(
                p_stream[s.offset:s.offset + s.size].view(s.shape))
    for k, s in zip(plan.names, plan.slots):
        assert torch.equal(stream_params[k], tree_params[k]), k
        assert torch.equal(sstate["delta"][s.offset:s.offset + s.size],
                           ref_state["delta"][k].reshape(-1)), k


def test_stream_optimizer_kinds():
    sopt = tstream.make_stream_optimizer(TOpt(kind="lars"), 5, 32)
    assert sopt.kind == "lars"
    st = sopt.init(16, "cpu")
    assert st["step"] == 0 and st["delta"].shape == (16,)
    for kind in ("rmsprop_warmup", "momentum_sgd"):  # ZeRO's kinds
        assert tstream.make_stream_optimizer(TOpt(kind=kind), 5,
                                             32).kind == kind
    with pytest.raises(ValueError, match="rmsprop_warmup"):
        tstream.make_stream_optimizer(TOpt(kind="adamw"), 5, 32)
    with pytest.raises(ValueError, match="bucketed"):
        tstream.zero_padded_total({"w": torch.zeros(3)}, "bf16", 64, 2)
    # the DP step updates the stream only when it is packed in buckets
    cfg = TTrain(optimizer=TOpt(kind="lars"),
                 parallel=TPar(compression="bf16"))
    with pytest.raises(ValueError, match="bucketed"):
        make_dp_shardmap_train_step(object(), sopt, cfg)


# ---------------------------------------------------------------------------
# error feedback and the state crossing over from JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["bf16", "f16"])
def test_error_feedback_bitwise_equal_to_jax(wire):
    rng = np.random.default_rng(11)
    g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 2)
             ).astype(np.float32) for k, s in SHAPES.items()}
    r = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
         for k, s in SHAPES.items()}
    tq, tr = tcomp.apply_error_feedback(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()}, wire)
    jq, jr = jcomp.apply_error_feedback(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()}, wire)
    for k in SHAPES:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    zeros = tcomp.init_error_feedback({k: torch.from_numpy(v)
                                       for k, v in g.items()})
    assert all(not z.any() and z.dtype == torch.float32
               for z in zeros.values())


def test_stream_state_and_residual_cross_over_from_jax():
    rng = np.random.default_rng(12)
    params = {"conv/w": torch.zeros(4, 3, 2, 2), "fc/b": torch.zeros(5),
              "fc/w": torch.zeros(6, 5)}
    total = sum(p.numel() for p in params.values())
    # the JAX stream in its own layout: conv HWIO, flattened; pad of 2
    hwio = rng.standard_normal((2, 2, 3, 4)).astype(np.float32)
    b, w = (rng.standard_normal(s).astype(np.float32) for s in ((5,), (6, 5)))
    jdelta = np.concatenate([hwio.reshape(-1), b, w.reshape(-1),
                             np.zeros(2, np.float32)])
    st = interop.stream_opt_state_from_jax({"step": np.int32(4),
                                            "delta": jdelta}, params,
                                           device="cpu")
    assert st["step"] == 4 and st["delta"].shape == (total + 2,)
    np.testing.assert_array_equal(st["delta"][:48].view(4, 3, 2, 2).numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    back = interop.stream_opt_state_to_jax(st, params)
    np.testing.assert_array_equal(back["delta"], jdelta)
    assert back["step"] == 4
    jres = {"conv": {"w": np.stack([hwio, 2 * hwio])},
            "fc": {"b": np.stack([b, -b]), "w": np.stack([w, w])}}
    ranks = [interop.ef_residual_from_jax(jres, r, device="cpu")
             for r in (0, 1)]
    np.testing.assert_array_equal(ranks[1]["conv/w"].numpy(),
                                  2 * hwio.transpose(3, 2, 0, 1))
    stacked = interop.stack_ef_residuals(ranks)
    for k in ("b", "w"):
        np.testing.assert_array_equal(stacked["fc"][k], jres["fc"][k])
    np.testing.assert_array_equal(stacked["conv"]["w"], jres["conv"]["w"])
