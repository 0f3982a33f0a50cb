"""The port's backward-overlapped bucketed all-reduce
(``make_dp_overlap_train_step``) and its pieces, against the JAX
package's and against the port's own bucketed step.

1. Staged apply: ``staged_value_and_grad`` of ``ResNet50.loss_segments``
   is bitwise equal to the monolithic ``_grads_of`` (loss, every
   gradient, the new BN state), fused and unfused, f32 and bf16; and
   within ``test_torch_resnet.py``'s gradient tolerance (loss rtol 1e-6,
   each gradient within 2e-5 of its largest magnitude) of JAX's
   ``staged_value_and_grad`` on the same weights and batch, f32.
2. Ready-order plans: ``plan_ready_buckets`` / ``pack_bucket`` against
   the JAX functions on the same stage trees (random trees, the reduced
   ResNet's segments), bf16 / f16 / no wire, align 1, 2 and 4 (the
   shard-aligned zero tail): the same bucket bounds, pad, ready stages
   and stage ends, the same buckets closed at each stage with the same
   wire bytes, and the same carry lengths; incremental packing equals
   ``pack`` of the whole stream.
3. The overlapped step against the bucketed step from the same seed,
   three steps at one and two gloo workers, plain, with error feedback
   and with stream-LARS: the state (parameters, optimizer state with
   the ``delta`` stream, BN state, residual) and the losses are bitwise
   equal. (The overlapped stream-LARS step puts the synced stream back
   in the bucketed step's leaf order before its update, so its trust
   norms add in that step's order; the JAX package updates in ready
   order and holds its own pair to a tolerance.) The plain gradient
   norm is a sum over the stream in another order: rtol 1e-6.
5. Checkpoints of the overlapped stream-LARS state cross between the
   packages: the port's ``delta`` written in the JAX layout is the JAX
   package's own overlapped ``delta`` after the same two steps, leaf by
   leaf (each cut by the JAX package's own ready plan) within the
   stream-LARS DP tolerances, a JAX file loads into the port's leaf
   order bitwise leaf by leaf, and a port file loads in JAX bitwise.
4. A recorded trace of ``dist.all_reduce`` calls and segment backwards:
   the first bucket is launched (async) before the stem segment's
   backward, each bucket right after the backward that completes it,
   and waited for at most two segments later.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.distributed import bucketing as jb
from repro.models.common import staged_value_and_grad as jstaged
from repro.models.resnet import ResNet50 as JResNet
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt, TrainConfig
from repro_torch.configs import ParallelConfig
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import bucketing as tb
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import staged_value_and_grad
from repro_torch.models.resnet import ResNet50 as TResNet
from repro_torch.training import step as tstep

BATCH, SPE, STEPS = 8, 4, 3
BUCKET = 8192  # a few dozen buckets of the reduced ResNet's stream
MODES = {"plain": {}, "ef": dict(error_feedback=True), "lars": {}}
LARS = TOpt(kind="lars", schedule="poly", warmup_epochs=1.0,
            total_epochs=4.0)


def _batch(seed=1, n=8, classes=10):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, 32, 32, 3)).astype(
        np.float32), "labels": rng.integers(0, classes, n).astype(np.int32)}


def _tbatch(b):
    return {"images": torch.from_numpy(b["images"]),
            "labels": torch.from_numpy(b["labels"]).long()}


# ---------------------------------------------------------------------------
# 1. staged apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [True, False])
def test_staged_grads_bitwise_equal_monolithic(fused, dt):
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    model = TResNet(treduced(tget("resnet50")), compute_dtype=dtype,
                    fused_bn=fused, seed=3, device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    state, batch = model.init_state(), _tbatch(_batch())
    cfg = TrainConfig(optimizer=TOpt(), label_smoothing=0.1)
    ns1, met1, g1 = tstep._grads_of(model, cfg, params, state, batch)
    pc = {k: v.to(dtype).requires_grad_(True) for k, v in params.items()}
    loss, (ns2, met2), g2 = staged_value_and_grad(
        model.loss_segments(pc, state, batch, 0.1))
    assert float(met1["loss"]) == float(loss.detach())
    assert float(met1["accuracy"]) == float(met2["accuracy"])
    assert g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k].float()), k
    assert list(ns1) == list(ns2)
    for site, rec in ns1.items():
        for f, v in rec.items():
            assert torch.equal(v, ns2[site][f]), (site, f)


@pytest.mark.parametrize("fused", [True, False])
def test_staged_grads_match_jax_staged(fused):
    jm = JResNet(jreduced(jget("resnet50")), compute_dtype=jnp.float32,
                 fused_bn=fused)
    tm = TResNet(treduced(tget("resnet50")), compute_dtype=torch.float32,
                 fused_bn=fused, device="cpu")
    jp, _ = jm.init_params(jax.random.PRNGKey(3))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = _batch(seed=2)
    jl, (_, _), jg = jstaged(jm.loss_segments(
        jp, jm.init_state(), {k: jnp.asarray(v) for k, v in b.items()},
        0.1))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tl, _, tg = staged_value_and_grad(tm.loss_segments(
        tp, tm.init_state(), _tbatch(b), 0.1))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jflat = interop.params_from_jax(jax.tree.map(np.asarray, jg),
                                    device="cpu")
    assert jflat.keys() == tg.keys()
    for k, g in tg.items():
        scale = float(jflat[k].abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale,
                                   jflat[k].numpy() / scale, atol=2e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 2. ready-order plans
# ---------------------------------------------------------------------------


def _random_stages(seed):
    rng = np.random.default_rng(seed)
    stages = []
    for s in range(int(rng.integers(1, 6))):
        n = int(rng.integers(0 if s else 1, 5))
        stages.append({f"l{i}": rng.standard_normal(
            int(rng.integers(1, 60))).astype(np.float32) for i in range(n)})
    return stages


def _resnet_stages():
    model = TResNet(treduced(tget("resnet50")), compute_dtype=torch.float32,
                    device="cpu")
    params = {k: p.detach().numpy() for k, p in model.named_parameters()}
    staged = model.loss_segments(params, {}, {"images": None})
    out = []
    for name, t in zip(staged.names, staged.seg_params):
        out.append({k[len(name) + 1:]: v for k, v in t.items()})
    return out[::-1]


def _jax_tree(flat):
    """``{"a/b": v}`` -> ``{"a": {"b": v}}``."""
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _tbits(t) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.element_size() == 2 else t.view(torch.int32).numpy().view(
            np.uint32)


PLAN_CASES = [("random", seed, wire, bb, align)
              for seed, (wire, bb, align) in enumerate(
                  [("bf16", 64, 1), ("bf16", 100, 2), ("f16", 256, 4),
                   (None, 64, 1), (None, 200, 4), ("bf16", 4096, 1),
                   ("bf16", 30, 4), ("f16", 8, 2)])] + [
    ("resnet", 0, "bf16", 8192, 1), ("resnet", 0, "bf16", 65536, 4),
    ("resnet", 0, None, 2 ** 26, 2)]


@pytest.mark.parametrize("kind,seed,wire,bucket_bytes,align", PLAN_CASES)
def test_ready_plan_matches_jax(kind, seed, wire, bucket_bytes, align):
    stages = _random_stages(seed) if kind == "random" else _resnet_stages()
    tstages = [{f"s{i}/{k}": torch.from_numpy(v) for k, v in t.items()}
               for i, t in enumerate(stages)]
    jstages = [_jax_tree(t) for t in stages]
    tp = tb.plan_ready_buckets(tstages, bucket_bytes, wire, align=align)
    jp = jb.plan_ready_buckets(jstages, bucket_bytes, wire, align=align)
    for f in ("total_elems", "bucket_elems", "n_buckets", "pad_elems"):
        assert getattr(tp.base, f) == getattr(jp.base, f), f
    assert tp.ready_stage == jp.ready_stage
    assert tp.stage_ends == jp.stage_ends
    assert [tp.base.bucket_bounds(b) for b in range(tp.n_buckets)] == \
        [jp.base.bucket_bounds(b) for b in range(jp.n_buckets)]
    assert [s.offset for s in tp.base.slots] == \
        [s.offset for s in jp.base.slots]
    tcarry = jcarry = None
    seen = {}
    for i, (ts, js) in enumerate(zip(tstages, jstages)):
        tready, tcarry = tb.pack_bucket(tp, i, ts, tcarry)
        jready, jcarry = jb.pack_bucket(jp, i, js, jcarry, use_kernel=False)
        assert [b for b, _ in tready] == [b for b, _ in jready]
        for (b, t), (_, j) in zip(tready, jready):
            np.testing.assert_array_equal(_tbits(t), _bits(j))
            seen[b] = t
        assert tcarry.numel() == jcarry.shape[0]
    assert tcarry.numel() == 0 and sorted(seen) == list(range(tp.n_buckets))
    # incremental packing is the whole stream's pack, bucket by bucket
    merged = {k: v for t in tstages for k, v in t.items()}
    flat = torch.cat([merged[k].reshape(-1) for k in tp.base.names])
    flat = flat.to(tp.base.stream_dtype)
    if tp.base.pad_elems:
        flat = torch.cat([flat, flat.new_zeros(tp.base.pad_elems)])
    for b in range(tp.n_buckets):
        lo, hi = tp.base.bucket_bounds(b)
        assert torch.equal(seen[b], flat[lo:hi]), b


def test_ready_buckets_close_before_the_full_backward():
    stages = [{f"s{i}/a": torch.ones(100)} for i in range(3)]
    plan = tb.plan_ready_buckets(stages, bucket_bytes=400, wire=None)
    assert plan.n_buckets == 3 and plan.ready_stage == (0, 1, 2)
    ready, _ = tb.pack_bucket(plan, 0, stages[0])
    assert [b for b, _ in ready] == [0]


def test_ready_plan_refuses_a_leaf_in_two_stages():
    with pytest.raises(ValueError, match="more than one stage"):
        tb.plan_ready_buckets([{"a": torch.ones(2)}, {"a": torch.ones(2)}])


# ---------------------------------------------------------------------------
# 3. the overlapped step against the bucketed step
# ---------------------------------------------------------------------------


def _setup(mode, overlap):
    lars = mode == "lars"
    return tlaunch.build_train_setup(
        treduced(tget("resnet50")), global_batch=BATCH * dist.get_world_size()
        if dist.is_initialized() else BATCH, seq_len=0,
        opt_cfg=LARS if lars else TOpt(), steps_per_epoch=SPE,
        dp_mode="shardmap", compute_dtype=torch.float32, fused_bn=True,
        use_fused_kernel=True, compression="bf16+bucketed",
        bucket_bytes=BUCKET, overlap_comm=overlap,
        label_smoothing=0.1 if lars else 0.0, device="cpu", **MODES[mode])


def _run_pair(mode):
    """(bucketed, overlapped): each (losses, grad norms, flat state) after
    STEPS steps from the same seed."""
    out = []
    for overlap in (False, True):
        model, s, step, data, put, _ = _setup(mode, overlap)
        losses, norms = [], []
        for i in range(STEPS):
            s, met = step(s, put(data.batch_at(i)))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        flat = {"p/" + k: v.clone() for k, v in s["params"].items()}
        for site, rec in s["model_state"].items():
            for k, v in rec.items():
                flat[f"bn/{site}/{k}"] = v.clone()
        for k, v in s.get("ef_residual", {}).items():
            flat["ef/" + k] = v.clone()
        for f, leaves in s["opt"].items():
            if isinstance(leaves, dict):
                flat.update({f"{f}/{k}": v.clone()
                             for k, v in leaves.items()})
            else:
                flat[f"opt/{f}"] = torch.as_tensor(leaves).clone()
        out.append((losses, norms, flat))
    return out


def _assert_pair(pair):
    (l0, n0, s0), (l1, n1, s1) = pair
    np.testing.assert_allclose(n1, n0, rtol=1e-6)
    assert l0 == l1
    assert s0.keys() == s1.keys()
    bad = [k for k in s0 if not torch.equal(s0[k], s1[k])]
    assert not bad, bad[:5]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_overlap_step_bitwise_equals_bucketed_one_worker(tmp_path, mode):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        _assert_pair(_run_pair(mode))
    finally:
        shutdown()


def _two_worker(rank, out_dir):
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=2)
    try:
        for mode in MODES:
            pair = _run_pair(mode)
            torch.save(pair, os.path.join(out_dir, f"{mode}_{rank}.pt"))
    finally:
        shutdown()


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    mp.spawn(_two_worker, args=(str(tmp),), nprocs=2)
    return {(mode, r): torch.load(tmp / f"{mode}_{r}.pt")
            for mode in MODES for r in (0, 1)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_overlap_step_equals_bucketed_two_workers(two_workers, mode):
    for r in (0, 1):
        _assert_pair(two_workers[(mode, r)])
    # the replicas agree with each other bit for bit
    s0, s1 = two_workers[(mode, 0)][1][2], two_workers[(mode, 1)][1][2]
    for k, v in s0.items():
        if k.startswith(("p/", "opt/delta")):
            assert torch.equal(v, s1[k]), k


# ---------------------------------------------------------------------------
# 4. when the buckets are launched
# ---------------------------------------------------------------------------


def test_first_bucket_launches_before_the_stem_backward(tmp_path,
                                                        monkeypatch):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    trace = []
    real_all_reduce, real_forward = dist.all_reduce, tstep.staged_forward

    class Work:
        def __init__(self, work, i):
            self.work, self.i = work, i

        def wait(self):
            trace.append(("wait", self.i))
            return self.work.wait()

    def all_reduce(t, *a, async_op=False, **kw):
        work = real_all_reduce(t, *a, async_op=async_op, **kw)
        if not async_op:
            return work
        trace.append(("launch", len([e for e in trace
                                     if e[0] == "launch"])))
        return Work(work, trace[-1][1])

    def staged_forward(staged):
        loss, vjps, auxes = real_forward(staged)

        def traced(i, vjp):
            def run(ct):
                trace.append(("backward", staged.names[i]))
                return vjp(ct)
            return run

        return loss, [traced(i, v) for i, v in enumerate(vjps)], auxes

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(tstep, "staged_forward", staged_forward)
    try:
        model, s, step, data, put, _ = _setup("plain", True)
        s, _ = step(s, put(data.batch_at(0)))
    finally:
        shutdown()
    stages = len(treduced(tget("resnet50")).conv_stages)
    names = ["stem"] + [f"stage{i}" for i in range(stages)] + ["fc"]
    backwards = [e[1] for e in trace if e[0] == "backward"]
    assert backwards == list(reversed(names))
    launches = [i for i, e in enumerate(trace) if e[0] == "launch"]
    assert len(launches) > 1
    assert launches[0] < trace.index(("backward", "stem"))
    # each bucket is waited for once, after its launch, and before the
    # second backward after it starts
    for b in range(len(launches)):
        li, wi = trace.index(("launch", b)), trace.index(("wait", b))
        assert li < wi
        later = [i for i, e in enumerate(trace)
                 if e[0] == "backward" and i > li]
        assert len(later) < 2 or wi < later[1], (b, trace)


def test_overlap_step_rejects_an_unstaged_model():
    class NoSegments:
        device = torch.device("cpu")

    cfg = TrainConfig(optimizer=TOpt(),
                      parallel=ParallelConfig(compression="bf16+bucketed",
                                              overlap_comm=True))
    with pytest.raises(ValueError, match="loss_segments"):
        tstep.make_dp_overlap_train_step(NoSegments(), None, cfg)
