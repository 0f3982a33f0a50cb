"""The LM's staged loss (``TransformerLM.loss_segments``) and the stream
layouts built on it, against the port's own ``loss_fn`` and the JAX
package, on the CPU, at the reduced llama3.2-1b (tied embeddings, one
layer a group) and the reduced llama4-maverick (groups of a dense and a
MoE sub-layer, an untied head), f32, label smoothing 0.1. Inputs are
made from a seed with numpy; the weights are drawn by the port from a
seed and carried to the JAX package with ``interop.params_to_jax`` (the
LM leaves have one layout in both).

1. Staged against the port's ``loss_fn``: the loss bitwise, every
   gradient bitwise, but the tied ``embed/table``, held to abs 2.4e-7:
   its two contributions (the lookup and the head) may sum in another
   order (the JAX package's own pair differs by 1.19e-7 there).
2. Staged against JAX's ``staged_value_and_grad(loss_segments(...))``:
   the loss within rtol 2e-5, each gradient within a relative norm of
   2e-4.
3. The ready-order plan of the overlapped step (``_ready_stages``, the
   layer slices keyed by ``slice_key``) against JAX's
   ``plan_ready_buckets`` over its tuple of stage trees: the same leaf
   names and slots, bucket bounds, pad, ready stages, stage ends and
   wire bytes, at align 1 and 2; ``overlap_stream_order`` is that order.
4. The checkpoint converters of an LM's ZeRO state (plain and
   overlapped, 2 workers): the port's shards written in the JAX layout
   are bitwise the JAX package's global shard-layout array of the same
   per-leaf values under its own plan, and read back bitwise; a
   stream-LARS ``delta`` crosses from the port's leaf order to JAX's
   ready order and back bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.distributed import bucketing as jb
from repro.models.common import staged_value_and_grad as jstaged
from repro.models.transformer import TransformerLM as JLM
from repro_torch import interop
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import bucketing as tb
from repro_torch.models.common import merge_slices, slice_key, split_slice_key
from repro_torch.models.common import staged_value_and_grad
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.training import step as tstep

ARCHS = ["llama3.2-1b", "llama4-maverick-400b-a17b"]
B, S, SMOOTH = 2, 32, 0.1
TABLE_ATOL = 2.4e-7

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced model's small products run
    faster so, and the port's threads do not contend with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_PAIRS = {}


def _pair(arch):
    """(JAX model, its params, port model, the port's params, batch)."""
    if arch not in _PAIRS:
        jm = JLM(jreduced(jget(arch)), compute_dtype=jnp.float32,
                 attention_impl="naive", remat=False)
        tm = TLM(treduced(tget(arch)), compute_dtype=torch.float32,
                 attention_impl="naive", device="cpu")
        tp = tm.init(5)
        jp = jax.tree.map(jnp.asarray, interop.params_to_jax(tp))
        rng = np.random.RandomState(2)
        toks = rng.randint(0, tm.cfg.vocab_size, (B, S + 1))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        _PAIRS[arch] = (jm, jp, tm, tp, batch)
    return _PAIRS[arch]


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tp):
    return {k: v.clone().requires_grad_(True) for k, v in tp.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_loss_is_bitwise_loss_fn(arch):
    _, _, tm, tp, batch = _pair(arch)
    assert tm.segment_names() == ("embed",) + tuple(
        f"layers{i}_{i + 1}" for i in range(tm.n_groups)) + ("head",)
    pc = _leaves(tp)
    total, (_, met1) = tm.loss_fn(pc, {}, _tbatch(batch), SMOOTH)
    g1 = dict(zip(pc, torch.autograd.grad(total, list(pc.values()))))
    loss, (_, met2), g2 = staged_value_and_grad(
        tm.loss_segments(_leaves(tp), {}, _tbatch(batch), SMOOTH))
    assert float(total.detach()) == float(loss.detach())
    assert set(met1) == set(met2) == {"loss", "moe_aux", "tokens"}
    for k in met1:
        assert float(met1[k]) == float(met2[k]), k
    assert tm.cfg.n_experts == 0 or float(met2["moe_aux"]) > 0
    assert g1.keys() == g2.keys()
    for k in g1:
        if k == "embed/table" and tm.cfg.tie_embeddings:
            assert float((g1[k] - g2[k]).abs().max()) <= TABLE_ATOL
        else:
            assert torch.equal(g1[k], g2[k]), k


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_loss_matches_jax_staged(arch):
    jm, jp, tm, tp, batch = _pair(arch)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, (_, jmet), jg = jax.jit(lambda p: jstaged(jm.loss_segments(
        p, {}, jb_, SMOOTH)))(jp)
    assert jm.loss_segments(jp, {}, jb_, SMOOTH).names == \
        tm.segment_names()
    tl, (_, tmet), tg = staged_value_and_grad(
        tm.loss_segments(_leaves(tp), {}, _tbatch(batch), SMOOTH))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    np.testing.assert_allclose(float(tmet["moe_aux"]),
                               float(jmet["moe_aux"]), rtol=2e-5)
    jflat = _flat(jg)
    assert jflat.keys() == tg.keys()
    for k, g in tg.items():
        assert _rel(g.numpy(), jflat[k]) < 2e-4, k


def _jax_ready(jm, jp, batch, bucket, align):
    staged = jm.loss_segments(jp, {}, batch, SMOOTH)
    stages = list(reversed(staged.seg_params))
    names = []
    for seg, t in zip(reversed(staged.names), stages):
        for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]:
            name = "/".join(str(k.key) for k in path)
            names.append(name if seg in ("embed", "head")
                         else f"{seg}/{name}")
    return jb.plan_ready_buckets(stages, bucket, "bf16", align=align), names


@pytest.mark.parametrize("align", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_ready_plan_equals_jax(arch, align):
    jm, jp, tm, tp, batch = _pair(arch)
    bucket = 96 * 1024  # a few dozen buckets, some inside one segment
    jplan, jnames = _jax_ready(jm, jp, batch, bucket, align)
    shapes = {k: torch.empty(v.shape, device="meta") for k, v in tp.items()}
    stages = tstep._ready_stages(tm, shapes)
    tplan = tb.plan_ready_buckets(stages, bucket, "bf16", align=align)
    assert list(tplan.base.names) == jnames
    assert list(tstep.overlap_stream_order(tm, tp)) == jnames
    for f in ("total_elems", "bucket_elems", "n_buckets", "pad_elems",
              "bucket_bytes"):
        assert getattr(tplan.base, f) == getattr(jplan.base, f), f
    assert tplan.n_buckets > len(stages)
    assert tplan.ready_stage == jplan.ready_stage
    assert tplan.stage_ends == jplan.stage_ends
    assert [(s.offset, s.size, tuple(s.shape)) for s in tplan.base.slots] \
        == [(s.offset, s.size, tuple(s.shape)) for s in jplan.base.slots]
    for b in range(tplan.n_buckets):
        assert tplan.base.bucket_bounds(b) == jplan.base.bucket_bounds(b)
    # every leaf once, as whole leaves or row slices that tile it
    merged = merge_slices({k: v for t in stages for k, v in t.items()})
    assert {k: tuple(v.shape) for k, v in merged.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}


def test_slice_keys_round_trip():
    assert split_slice_key(slice_key(2, 5, "sub1/moe/w_up")) == \
        ("sub1/moe/w_up", 2, 5)
    assert split_slice_key("embed/table") == ("embed/table", None, None)
    t = torch.arange(12.).reshape(4, 3)
    parts = {slice_key(2, 4, "w"): t[2:], slice_key(0, 2, "w"): t[:2],
             "b": torch.ones(2)}
    got = merge_slices(parts)
    assert torch.equal(got["w"], t) and torch.equal(got["b"], torch.ones(2))


def _values(tp, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in tp.items()}


def _jax_stream(values, names, plan):
    """The JAX package's flat stream of per-leaf ``values`` under its own
    plan, its entries ``names`` (layer slices as ``slice_key``s)."""
    out = np.zeros(plan.padded_total, np.float32)
    for k, s in zip(names, plan.slots):
        name, lo, hi = split_slice_key(k)
        v = values[name] if lo is None else values[name][lo:hi]
        out[s.offset:s.offset + s.size] = v.reshape(-1)
    return out


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero_converters_cross_packages(arch, overlap):
    jm, jp, tm, tp, batch = _pair(arch)
    n, bucket = 2, 64 * 1024
    shapes = {k: torch.empty(v.shape, device="meta") for k, v in tp.items()}
    if overlap:
        tplan = tb.plan_ready_buckets(tstep._ready_stages(tm, shapes),
                                      bucket, "bf16", n).base
        jplan, jnames = _jax_ready(jm, jp, batch, bucket, n)
        jplan = jplan.base
        order = jnames
    else:
        tplan = tb.plan_buckets(shapes, bucket, "bf16", align=n)
        jplan = jb.plan_buckets(jp, bucket, "bf16", align=n)
        jnames = order = None
    values = _values(tp, 7)
    jstream = _jax_stream(values, jnames or tb.leaf_order(tp), jplan)
    jarr = jb.stream_to_shard_layout(jnp.asarray(jstream), jplan, n)
    # the port's shards of the same values (its own plan's layout)
    tstream_ = _jax_stream(values, tplan.names, tplan)
    rows = tb.stream_to_shard_layout(torch.from_numpy(tstream_), tplan, n
                                     ).reshape(n, -1)
    got = interop._zero_field_to_jax(rows, tp, order, tplan)
    assert got.tobytes() == np.asarray(jarr).tobytes()
    for w in range(n):
        back = interop._zero_field_from_jax(np.asarray(jarr), tp, order,
                                            tplan, n, w)
        assert back.tobytes() == rows[w].numpy().tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_lars_delta_crosses_to_ready_order(arch):
    """Under overlap_comm the port keeps stream-LARS's ``delta`` in leaf
    order and the JAX package in ready order over its layer slices."""
    jm, jp, tm, tp, batch = _pair(arch)
    jplan, jnames = _jax_ready(jm, jp, batch, 64 * 1024, 2)
    values = _values(tp, 8)
    port = np.concatenate([values[k].reshape(-1) for k in tb.leaf_order(tp)]
                          + [np.zeros(jplan.base.pad_elems, np.float32)])
    want = _jax_stream(values, jnames, jplan.base)
    order = tstep.overlap_stream_order(tm, tp)
    got = interop._restream(port, tp, to_port=False, order=order)
    assert got.tobytes() == want.tobytes()
    assert interop._restream(want, tp, to_port=True,
                             order=order).tobytes() == port.tobytes()
    with pytest.raises(ValueError, match="every parameter once"):
        interop._restream(port, tp, to_port=False, order=order[1:])
