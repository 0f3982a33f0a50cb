"""The port's wire cast (``kernels/bucket_ops.py``) and bucket layout
(``distributed/bucketing.py``) against the JAX package.

All bitwise: a cast rounds each element to nearest even on both sides,
and packing only moves where an element sits. The plans agree field by
field (the leaves in ``jax.tree.flatten`` order, the offsets, the bucket
arithmetic). Conv leaves are OIHW in the port and HWIO in the JAX
package, so a ResNet's packed stream is compared leaf by leaf, and a
layout-free tree of plain arrays bucket by bucket. The squared norm of
the stream sums in another order: rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.distributed import bucketing as jb
from repro.kernels import ops as jops
from repro.models.resnet import ResNet50 as JResNet
from repro_torch import interop
from repro_torch.distributed import bucketing as tb
from repro_torch.kernels import bucket_ops

WIRES = {"bf16": (jnp.bfloat16, torch.bfloat16),
         "f16": (jnp.float16, torch.float16)}


def _resnet_grads(seed=0):
    """A reduced ResNet's parameter tree filled with random gradients:
    (JAX nested numpy, the port's flat tensors)."""
    jp, _ = JResNet(jreduced(jget("resnet50")),
                    compute_dtype=jnp.float32).init_params(
                        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    jg = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-2)
                      .astype(np.float32), jp)
    return jg, interop.params_from_jax(jg, device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.int32)


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("n", [1, 127, 128 * 1024 + 3, "resnet"])
def test_pack_unpack_cast_bitwise(wire, n):
    jdt, tdt = WIRES[wire]
    if n == "resnet":
        jg, _ = _resnet_grads()
        x = np.concatenate([np.ravel(v) for v in jax.tree.leaves(jg)])
    else:
        x = (np.random.default_rng(n).standard_normal(n) * 3).astype(
            np.float32)
    x[:1] = 1 + 2 ** -9  # a tie for bf16: rounds to even
    got = bucket_ops.pack_cast(torch.from_numpy(x), tdt)
    want = jops.pack_cast(jnp.asarray(x), jdt)
    assert got.dtype == tdt and got.shape == (x.size,)
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(want, np.float32).view(np.int32))
    back = bucket_ops.unpack_cast(got)
    jback = jops.unpack_cast(want, jnp.float32)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_cast_copy_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        bucket_ops.pack_cast(torch.zeros(4, dtype=torch.bfloat16),
                             torch.float16)
    with pytest.raises(ValueError):
        bucket_ops.pack_cast(torch.zeros(2, 2), torch.bfloat16)
    with pytest.raises(TypeError):  # the leaves are float32
        bucket_ops.pack_leaves([torch.zeros(3, dtype=torch.bfloat16)],
                               torch.bfloat16)
    with pytest.raises(TypeError):  # to a half-precision wire
        bucket_ops.pack_leaves([torch.zeros(3)], torch.float32)
    with pytest.raises(TypeError):  # back from one half-precision wire
        bucket_ops.unpack_buckets([torch.zeros(3)], 3)
    with pytest.raises(TypeError):
        bucket_ops.unpack_buckets([torch.zeros(3, dtype=torch.bfloat16),
                                   torch.zeros(3, dtype=torch.float16)], 6)
    with pytest.raises(ValueError):  # more elements than the buckets hold
        bucket_ops.unpack_buckets([torch.zeros(3, dtype=torch.bfloat16)], 4)
    bucket_ops.reset_launch_counts()
    bucket_ops.pack_cast(torch.zeros(5), torch.bfloat16)
    bucket_ops.pack_leaves([torch.zeros(5), torch.zeros(2, 2)],
                           torch.bfloat16, 3)
    bucket_ops.unpack_buckets([torch.zeros(5, dtype=torch.float16)], 4,
                              denom=2, with_sq_norm=True)
    assert bucket_ops.LAUNCHES == {"cast_copy": 0}  # the CPU runs plain
    assert bucket_ops.ENTRY_LAUNCHES == {"cast_copy": 0, "pack_leaves": 0,
                                         "unpack_buckets": 0}


def _small_tree(seed=4):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(shape) * 3)
                                .astype(np.float32))
            for k, shape in (("w", (33, 7)), ("b/x", (5,)),
                             ("b/y", (2, 3, 4)))}


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("denom", [None, 1, 2, 3])
def test_one_pass_entries_are_the_sequence_they_replace(wire, denom):
    """``pack_leaves`` and ``unpack_buckets`` (their plain versions on
    the CPU) bitwise the sequence the sync ran before them: ``torch.cat``
    of the leaves, ``Tensor.to``, the zero pad; ``torch.cat`` of the
    buckets, ``Tensor.to``, ``/ denom``, ``.square().sum()``. Several
    buckets that are not one stream, a pad tail (align 3)."""
    tdt = WIRES[wire][1]
    tree = _small_tree()
    plan = tb.plan_buckets(tree, 64, wire, align=3)
    assert plan.n_buckets > 1 and plan.pad_elems > 0
    leaves = [tree[k] for k in plan.names]
    want = torch.cat([t.reshape(-1) for t in leaves]).to(tdt)
    want = torch.cat([want, want.new_zeros(plan.pad_elems)])
    got = bucket_ops.pack_leaves(leaves, tdt, plan.pad_elems)
    assert got.dtype == tdt and torch.equal(got, want)
    buckets = [b.clone() for b in tb.pack(tree, plan)]
    assert torch.equal(torch.cat(buckets), want)
    stream, sq = bucket_ops.unpack_buckets(buckets, plan.total_elems, denom,
                                           with_sq_norm=True)
    ref = torch.cat(buckets)[:plan.total_elems].to(torch.float32)
    if denom is not None:
        ref = ref / denom
    assert torch.equal(stream, ref)
    assert torch.equal(sq, ref.float().square().sum())
    np.testing.assert_allclose(float(sq), float(ref.double().square().sum()),
                               rtol=1e-6)
    assert bucket_ops.unpack_buckets(buckets, plan.total_elems, denom)[1] \
        is None
    grads, sq2 = tb.unpack(buckets, plan, denom=denom, with_sq_norm=True)
    assert torch.equal(sq2, sq)
    for k, s in zip(plan.names, plan.slots):
        assert torch.equal(grads[k], ref[s.offset:s.offset + s.size]
                           .view(s.shape)), k


def test_unpack_norm_carries_nan_and_the_meta_path_gives_shapes():
    """A NaN leaf makes the squared norm NaN (the sentinel reads it); on
    ``meta`` tensors (``launch/dryrun.py``) both entries give shapes."""
    tree = _small_tree()
    tree["b/x"][2] = float("nan")
    plan = tb.plan_buckets(tree, 64, "bf16", align=3)
    grads, sq = tb.unpack(tb.pack(tree, plan), plan, denom=2,
                          with_sq_norm=True)
    assert torch.isnan(sq) and torch.isnan(grads["b/x"][2])
    meta = {k: v.to("meta") for k, v in tree.items()}
    buckets = tb.pack(meta, plan)
    assert [b.device.type for b in buckets] == ["meta"] * plan.n_buckets
    assert sum(b.numel() for b in buckets) == plan.padded_total
    grads, sq = tb.unpack(buckets, plan, denom=2, with_sq_norm=True)
    assert sq.device.type == "meta" and sq.shape == ()
    assert {k: tuple(v.shape) for k, v in grads.items()} == \
        {k: tuple(v.shape) for k, v in tree.items()}
    assert all(v.dtype == torch.float32 for v in grads.values())


@pytest.mark.parametrize("bucket_bytes", [1024, 100_000, 64 << 20])
@pytest.mark.parametrize("align", [1, 4])
def test_plan_matches_jax_field_by_field(bucket_bytes, align):
    jg, tg = _resnet_grads()
    jplan = jb.plan_buckets(jg, bucket_bytes, "bf16", align=align)
    tplan = tb.plan_buckets(tg, bucket_bytes, "bf16", align=align)
    paths = ["/".join(p.key for p in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(jg)]
    assert list(tplan.names) == paths
    for js, ts, name in zip(jplan.slots, tplan.slots, paths):
        assert (ts.offset, ts.size) == (js.offset, js.size), name
        want = js.shape if len(js.shape) != 4 else tuple(
            js.shape[i] for i in (3, 2, 0, 1))  # HWIO -> OIHW
        assert ts.shape == want, name
    for f in ("total_elems", "bucket_elems", "n_buckets", "pad_elems",
              "align", "padded_total", "bucket_bytes"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.describe() == jplan.describe()


@pytest.mark.parametrize("wire", ["bf16", "f16", None])
@pytest.mark.parametrize("denom", [None, 1, 2])
def test_pack_unpack_match_jax(wire, denom):
    # a layout-free tree: the buckets themselves agree bitwise
    rng = np.random.default_rng(1)
    jtree = {"w": rng.standard_normal((33, 7)).astype(np.float32),
             "b": {"x": rng.standard_normal((5,)).astype(np.float32),
                   "y": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    ttree = {"w": torch.from_numpy(jtree["w"]),
             "b/x": torch.from_numpy(jtree["b"]["x"]),
             "b/y": torch.from_numpy(jtree["b"]["y"])}
    jplan = jb.plan_buckets(jtree, 64, wire, align=3)
    tplan = tb.plan_buckets(ttree, 64, wire, align=3)
    jbk = jb.pack(jtree, jplan, use_kernel=True)
    tbk = tb.pack(ttree, tplan)
    assert len(tbk) == len(jbk) == jplan.n_buckets > 1
    for a, b in zip(tbk, jbk):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    jout, jsq = jb.unpack(jbk, jplan, use_kernel=True, denom=denom,
                          with_sq_norm=True)
    tout, tsq = tb.unpack(tbk, tplan, denom=denom, with_sq_norm=True)
    for k, v in ttree.items():
        want = jout["w"] if k == "w" else jout["b"][k[2:]]
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(want))
        assert tout[k].shape == v.shape
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-6)


def test_resnet_stream_round_trip_matches_jax_leaf_by_leaf():
    jg, tg = _resnet_grads(seed=2)
    jplan = jb.plan_buckets(jg, 4096, "bf16")
    tplan = tb.plan_buckets(tg, 4096, "bf16")
    jout, jsq = jb.unpack(jb.pack(jg, jplan, use_kernel=True), jplan,
                          use_kernel=True, denom=2, with_sq_norm=True)
    tout, tsq = tb.unpack(tb.pack(tg, tplan), tplan, denom=2,
                          with_sq_norm=True)
    want = interop.params_from_jax(jax.tree.map(np.asarray, jout),
                                   device="cpu")
    for k in tg:
        assert torch.equal(tout[k], want[k]), k
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-6)
