"""The hierarchical collective schedules of the port's data-parallel step
(``Hierarchy``, ``hierarchical_psum`` / ``_psum_scatter`` /
``_all_gather`` and ``hier_split`` through every bucketed path) with
gloo workers on the CPU (a ``file://`` store), against the JAX package.

Each comparison, as the tests below state it:
- ``make_hierarchy``'s split and its errors, and ``inner_major_perm`` /
  ``_unperm``: the JAX package's, bitwise, on numpy inputs.
- The three primitives at 2x2 (4 workers) on normal bf16 and f16 data:
  **bitwise** the JAX package's on 4 virtual devices (both accumulate in
  f32 and round once). On exact data (small integers: every partial sum
  is exact in the wire dtype) the hierarchical all-reduce and
  reduce-scatter are bitwise the port's flat ones; the two-level
  all-gather is bitwise the flat one on any data, and the hierarchical
  all-reduce's chunk is bitwise the double scatter's.
- **A divergence by design.** The port's flat bf16 bucketed all-reduce
  (gloo rounds to the wire dtype after each add) at 4 workers differs
  from JAX's flat ``psum`` (XLA on the CPU rounds bf16 once) in 1,316 of
  4,096 elements, each within two bf16 ulps taken at the sum of the
  four magnitudes (gloo's three roundings and XLA's one, each at most
  half such an ulp; one element of the 4,096 needs the second ulp); at
  2 workers (one add) it is bitwise.
- The step at 2x2 under ``hier_split=1`` (reduced ResNet, f32, 8 images
  a worker): overlap against bucketed, plain and with error feedback,
  and ZeRO against bucketed: **bitwise** (losses, parameters, BN state,
  residuals, ``opt.step``, ``delta`` / ``m`` as the worker's shard);
  ZeRO + overlap against overlap, ZeRO stream-LARS and ZeRO
  ``momentum_sgd`` against their bucketed steps: the state bitwise, the
  logged losses within 2.4e-7 (a ZeRO step stacks one more metric, and
  gloo's ring then adds the 4 workers' losses in another order, as in
  ``test_torch_zero_dp.py``); ZeRO + overlap stream-LARS against
  overlapped stream-LARS within rtol 1e-2 / atol 1e-4 (the JAX
  package's pair tolerance). The collectives of a step, per group.
- Flat bucketed at 4 workers against the hierarchical step over 8
  steps: not bitwise (the flat sum rounds after each add, and training
  grows the difference): the first loss bitwise, the loss after the
  first update within rtol 1e-3 (what ``chip_smoke.py`` phase 14 holds
  its full-width pair to), every loss within rtol 1e-2 and the
  parameters within a relative norm of 5e-2.
- A ZeRO + hier run resumed by the ``Trainer`` is bitwise the unbroken
  run, and its checkpoint goes through ``make_zero_restore_transform``
  into the per-leaf hierarchical run as a flat ZeRO one does (one more
  step, bitwise). The CLI: ``--comm-plan hier:1`` without ``--mesh``
  raises ``make_hierarchy``'s error, ``--mesh 2x2`` without a
  hierarchical plan raises, and a 4-worker run with ``--mesh 2x2
  --comm-plan hier:1 --zero`` prints its plan and tags its checkpoint
  ``zero_stream``.
- ``slow``: against the JAX package's shard_map step on a (2, 2) mesh
  with ``hier_split=1`` (bf16 wire: rmsprop_warmup, momentum_sgd and
  ZeRO): losses within rtol 2e-5 and parameters within a relative norm
  of 2e-4, the DP tolerances.
"""
import contextlib
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.distributed import bucketing as jb
from repro_torch.checkpoint import restore, save
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import bucketing as tb
from repro_torch.distributed import init_workers, shutdown
from repro_torch.distributed.bucketing import (leaf_order,
                                               shard_layout_to_stream)
from repro_torch import interop
from repro_torch.launch import train as tlaunch
from repro_torch.optim import stream as tstream
from repro_torch.training import LoopConfig, run_training

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, MESH = 4, (2, 2)
PER_WORKER, SPE, STEPS = 8, 4, 3
SMALL_BUCKET = 16384  # several ready-order buckets of the reduced stream
LARS = dict(kind="lars", schedule="poly", warmup_epochs=1.0,
            total_epochs=1.0)
# intra-op threads a worker process: the suite runs files side by side
WORKER_THREADS = 2
PAIR_TOL = dict(rtol=1e-2, atol=1e-4)
# ZeRO's metrics stack has one more entry: gloo's ring at 4 workers may
# add the losses in another order (see test_torch_zero_dp.py)
LOSS_RTOL_ZERO = 2.4e-7
# flat at 4 workers against hierarchical over FLAT_STEPS steps (the run
# length of chip_smoke.py's phase 14); measured on the reduced model: the
# loss after the first update 1.1e-4 apart (f32 compute; 9.1e-5 in bf16),
# held to FLAT_FIRST_RTOL, as phase 14 holds its full-width pair; over
# the 8 steps the losses 4.3e-3 apart at most (2.3e-3), the parameters
# 1.1e-2 in relative norm (1.5e-2): the rounding differences of the first
# steps grow as training moves on
FLAT_STEPS, FLAT_LOSS_RTOL, FLAT_PARAM_REL = 8, 1e-2, 5e-2
FLAT_FIRST_RTOL = 1e-3
HIER = dict(hier_split=1, dp_axes=tlaunch.MESH_AXES, mesh_shape=MESH)
CASES = {
    "bucketed": dict(HIER),
    "zero": dict(HIER, zero_dp=True),
    "overlap": dict(HIER, overlap_comm=True, bucket_bytes=SMALL_BUCKET),
    "bucketed_ef": dict(HIER, error_feedback=True),
    "overlap_ef": dict(HIER, error_feedback=True, overlap_comm=True,
                       bucket_bytes=SMALL_BUCKET),
    "zero_overlap_ef": dict(HIER, error_feedback=True, overlap_comm=True,
                            bucket_bytes=SMALL_BUCKET, zero_dp=True),
    "lars": dict(HIER, opt=LARS, label_smoothing=0.1),
    "zero_lars": dict(HIER, opt=LARS, label_smoothing=0.1, zero_dp=True),
    "momentum": dict(HIER, opt=dict(kind="momentum_sgd")),
    "zero_momentum": dict(HIER, opt=dict(kind="momentum_sgd"),
                          zero_dp=True),
    "overlap_lars": dict(HIER, opt=LARS, label_smoothing=0.1,
                         overlap_comm=True, bucket_bytes=SMALL_BUCKET),
    "zero_overlap_lars": dict(HIER, opt=LARS, label_smoothing=0.1,
                              overlap_comm=True, bucket_bytes=SMALL_BUCKET,
                              zero_dp=True),
    "flat": dict(),
    "hier_long": dict(HIER),
}
STEPS_OF = {"flat": FLAT_STEPS, "hier_long": FLAT_STEPS}
# (case, reference, loss rtol or None for bitwise losses)
BITWISE_PAIRS = {
    "overlap_plain": ("overlap", "bucketed", None),
    "overlap_ef": ("overlap_ef", "bucketed_ef", None),
    "zero": ("zero", "bucketed", LOSS_RTOL_ZERO),
    "zero_overlap_ef": ("zero_overlap_ef", "overlap_ef", LOSS_RTOL_ZERO),
    "zero_lars": ("zero_lars", "lars", LOSS_RTOL_ZERO),
    "zero_momentum": ("zero_momentum", "momentum", LOSS_RTOL_ZERO),
}


# ---------------------------------------------------------------------------
# the hierarchy's layout against the JAX package (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp_axes,sizes,split", [
    (("data", "model"), {"data": 2, "model": 4}, 1),
    (("data", "model"), {"data": 2, "model": 2}, 1),
    (("a", "b", "c"), {"a": 2, "b": 2, "c": 2}, 2),
    (("a", "b", "c"), {"a": 3, "b": 2, "c": 2}, 1),
])
def test_make_hierarchy_matches_jax(dp_axes, sizes, split):
    got = tb.make_hierarchy(dp_axes, sizes, split)
    want = jb.make_hierarchy(dp_axes, sizes, split)
    assert (got.outer, got.inner, got.outer_size, got.inner_size) == (
        want.outer, want.inner, want.outer_size, want.inner_size)
    assert got.n_workers == want.n_workers
    assert got.describe() == want.describe()


@pytest.mark.parametrize("sizes,split", [
    ({"data": 2, "model": 4}, 0), ({"data": 2, "model": 4}, 2),
    ({"data": 2, "model": 4}, -1), ({"data": 1, "model": 8}, 1),
    ({"data": 8, "model": 1}, 1)])
def test_make_hierarchy_raises_as_jax(sizes, split):
    with pytest.raises(ValueError) as want:
        jb.make_hierarchy(("data", "model"), sizes, split)
    with pytest.raises(ValueError) as got:
        tb.make_hierarchy(("data", "model"), sizes, split)
    assert str(got.value) == str(want.value)
    assert ("hier_split" in str(got.value)
            or "stages >= 2" in str(got.value))


@pytest.mark.parametrize("outer,inner,chunk", [(2, 2, 5), (2, 4, 3),
                                               (4, 2, 1), (3, 2, 7)])
def test_inner_major_perm_is_jax_bitwise(outer, inner, chunk):
    x = np.random.default_rng(0).standard_normal(outer * inner * chunk)
    x = x.astype(np.float32)
    want = jb.inner_major_perm(x, outer, inner)
    np.testing.assert_array_equal(tb.inner_major_perm(x, outer, inner), want)
    np.testing.assert_array_equal(
        tb.inner_major_perm(torch.from_numpy(x), outer, inner).numpy(), want)
    np.testing.assert_array_equal(
        tb.inner_major_unperm(want, outer, inner),
        jb.inner_major_unperm(want, outer, inner))
    np.testing.assert_array_equal(tb.inner_major_unperm(want, outer, inner),
                                  x)


def test_collectives_refuse_a_hierarchy_without_groups():
    hier = tb.make_hierarchy(("data", "model"), {"data": 2, "model": 2}, 1)
    with pytest.raises(ValueError, match="hierarchy_groups"):
        tb.hierarchical_psum(torch.zeros(8), hier)


# ---------------------------------------------------------------------------
# the primitives at 2x2 against JAX on 4 virtual devices
# ---------------------------------------------------------------------------

PRIM_LEN = 4096  # elements a worker
WIRES = ("bfloat16", "float16")

_JAX_PRIMS = """
    import functools
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.distributed.bucketing import (
        make_hierarchy, hierarchical_psum, hierarchical_psum_scatter,
        hierarchical_all_gather, bucketed_psum)
    data = np.load("{inp}")
    dp = ("data", "model")
    mesh = jax.make_mesh((2, 2), dp)
    hier = make_hierarchy(dp, dict(data=2, model=2), 1)
    out = {{}}

    @functools.partial(shard_map, mesh=mesh, in_specs=P(dp),
                       out_specs=P(dp), check_rep=False)
    def prims(x):
        b = x.reshape(-1)
        sc = hierarchical_psum_scatter(b, hier)
        return (hierarchical_psum(b, hier)[None], sc[None],
                hierarchical_all_gather(sc, hier)[None])

    for wire in {wires!r}:
        x = jnp.asarray(data["fuzzy"]).astype(wire)
        for name, v in zip(("psum", "scatter", "gather"), jax.jit(prims)(x)):
            out[f"{{wire}}/{{name}}"] = np.asarray(v).view(np.uint16)
    # the flat bucketed all-reduce, bf16 wire, at 4 and at 2 workers
    grads = jnp.asarray(data["fuzzy"])
    for n in (4, 2):
        m = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])

        @functools.partial(shard_map, mesh=m, in_specs=P("data"),
                           out_specs=P("data"), check_rep=False)
        def flat(g):
            return bucketed_psum({{"g": g.reshape(-1)}}, ("data",),
                                 wire="bf16", mean=False)["g"][None]

        out[f"flat{{n}}"] = np.asarray(jax.jit(flat)(grads[:n]))
    np.savez("{out}", **out)
"""


def _prims_worker(rank, out_dir):
    """One of 4 gloo workers: the primitives on this worker's row of the
    fuzzy and exact inputs, flat and hierarchical, and the flat bf16
    bucketed all-reduce over all 4 workers and over workers 0-1."""
    import torch.distributed as dist
    torch.set_num_threads(WORKER_THREADS)
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=N)
    try:
        data = np.load(os.path.join(out_dir, "inputs.npz"))
        hier = tb.hierarchy_groups(tb.make_hierarchy(
            ("data", "model"), dict(zip(("data", "model"), MESH)), 1))
        pair = dist.new_group([0, 1])
        out = {}
        for wire in WIRES:
            dt = getattr(torch, wire)
            for kind in ("fuzzy", "exact"):
                x = torch.from_numpy(data[kind][rank]).to(dt)
                h = x.clone()
                tb.hierarchical_psum(h, hier)
                flat = x.clone()
                dist.all_reduce(flat)
                sc_h = x.new_empty(x.numel() // N)
                tb.hierarchical_psum_scatter(sc_h, x, hier)
                sc_flat = x.new_empty(x.numel() // N)
                dist.reduce_scatter_tensor(sc_flat, x)
                ag_h = x.new_empty(x.numel())
                tb.hierarchical_all_gather(ag_h, sc_h, hier)
                ag_flat = x.new_empty(x.numel())
                dist.all_gather_into_tensor(ag_flat, sc_h)
                # the async form: launched, then waited for
                h_async = x.clone()
                tb.hierarchical_psum(h_async, hier, async_op=True).wait()
                sc_async = x.new_empty(x.numel() // N)
                tb.hierarchical_psum_scatter(sc_async, x, hier,
                                             async_op=True).wait()
                for name, v in (("psum", h), ("flat_psum", flat),
                                ("scatter", sc_h), ("flat_scatter", sc_flat),
                                ("gather", ag_h), ("flat_gather", ag_flat),
                                ("psum_async", h_async),
                                ("scatter_async", sc_async)):
                    out[f"{wire}/{kind}/{name}"] = v.view(torch.int16).numpy()
        g = {"g": torch.from_numpy(data["fuzzy"][rank])}
        out["flat4"] = tb.bucketed_psum(g, "bf16", mean=False)["g"].numpy()
        if rank < 2:
            out["flat2"] = tb.bucketed_psum(g, "bf16", mean=False,
                                            group=pair)["g"].numpy()
        np.savez(os.path.join(out_dir, f"prims{rank}.npz"), **out)
    finally:
        shutdown()


@pytest.fixture(scope="module")
def prims(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("hier_prims")
    rng = np.random.default_rng(0)
    np.savez(out_dir / "inputs.npz",
             fuzzy=rng.standard_normal((N, PRIM_LEN)).astype(np.float32),
             exact=rng.integers(-64, 65, (N, PRIM_LEN)).astype(np.float32))
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    body = textwrap.dedent(_JAX_PRIMS.format(
        inp=out_dir / "inputs.npz", out=out_dir / "jax.npz", wires=WIRES))
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    mp.spawn(_prims_worker, args=(str(out_dir),), nprocs=N)
    return (dict(np.load(out_dir / "jax.npz")),
            [dict(np.load(out_dir / f"prims{r}.npz")) for r in range(N)],
            dict(np.load(out_dir / "inputs.npz")))


@pytest.mark.parametrize("name", ["psum", "scatter", "gather"])
@pytest.mark.parametrize("wire", WIRES)
def test_primitives_are_jax_bitwise(prims, wire, name):
    """Normal data, 2x2: every worker's result is the bits of JAX's on
    its device; the async form gives the same bits."""
    jax_out, ranks, _ = prims
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(
            rec[f"{wire}/fuzzy/{name}"].view(np.uint16),
            jax_out[f"{wire}/{name}"][r], err_msg=f"worker {r}")
        if name != "gather":
            np.testing.assert_array_equal(rec[f"{wire}/fuzzy/{name}"],
                                          rec[f"{wire}/fuzzy/{name}_async"])


@pytest.mark.parametrize("wire", WIRES)
def test_primitives_are_the_flat_collectives_on_exact_data(prims, wire):
    _, ranks, _ = prims
    for rec in ranks:
        for name in ("psum", "scatter", "gather"):
            np.testing.assert_array_equal(rec[f"{wire}/exact/{name}"],
                                          rec[f"{wire}/exact/flat_{name}"])
        # the all-gather only moves data: bitwise on any data
        np.testing.assert_array_equal(rec[f"{wire}/fuzzy/gather"],
                                      rec[f"{wire}/fuzzy/flat_gather"])


@pytest.mark.parametrize("wire", WIRES)
def test_double_scatter_is_the_hierarchical_psum_chunk(prims, wire):
    """ZeRO's double scatter hands worker w chunk w of the two-level
    all-reduce, bit for bit, on normal data."""
    _, ranks, _ = prims
    c = PRIM_LEN // N
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(
            rec[f"{wire}/fuzzy/scatter"],
            rec[f"{wire}/fuzzy/psum"][r * c:(r + 1) * c])


def _bf16_ulp(x):
    """One bf16 ulp at magnitude ``x`` (as float64)."""
    e = np.floor(np.log2(np.maximum(np.abs(np.float64(x)), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_flat_bf16_sum_diverges_from_jax_by_design(prims):
    """The flat bf16 bucketed all-reduce: gloo rounds to bf16 after each
    add, XLA on the CPU rounds once. At 2 workers (one add) the two are
    bitwise; at 4 the results differ, each element within two bf16 ulps
    of JAX's, the ulp taken at the sum of the four magnitudes: each of
    the four roundings (three partial sums in gloo, the sum in XLA) is
    at most half an ulp of a value no larger than that sum."""
    jax_out, ranks, inputs = prims
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["flat2"],
                                      jax_out["flat2"][r])
    wire = torch.from_numpy(inputs["fuzzy"]).bfloat16().double().numpy()
    bound = _bf16_ulp(np.abs(wire).sum(0))
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["flat4"], ranks[0]["flat4"])
        diff = np.abs(np.float64(rec["flat4"]) - jax_out["flat4"][r])
        assert (diff <= 2 * bound).all(), float((diff / bound).max())
    assert not np.array_equal(ranks[0]["flat4"], jax_out["flat4"][0])


# ---------------------------------------------------------------------------
# the step at 2x2: pairs, collectives, checkpoints, the CLI
# ---------------------------------------------------------------------------


def _setup(zero_dp=False, opt=None, **kw):
    return tlaunch.build_train_setup(
        treduced(tget("resnet50")), global_batch=PER_WORKER * N, seq_len=0,
        opt_cfg=TOpt(**(opt or {})), steps_per_epoch=SPE,
        dp_mode="shardmap", use_fused_kernel=True, fused_bn=True,
        compression=kw.pop("compression", "bf16+bucketed"), zero_dp=zero_dp,
        device="cpu", **kw)


def _opt_stream(field, params, plan):
    """A run's optimizer field as one leaf-order f32 stream: a per-leaf
    dict or a leaf-order stream as it is; a ZeRO worker's shard
    (``plan`` is its run's) gathered from every worker, out of the shard
    layout and cut into leaves."""
    import torch.distributed as dist
    if isinstance(field, dict):
        leaves = field
    elif plan is not None:
        full = field.new_empty(plan.padded_total)
        dist.all_gather_into_tensor(full, field.contiguous())
        stream = shard_layout_to_stream(full, plan, N)
        leaves = {k: stream[s.offset:s.offset + s.size]
                  for k, s in zip(plan.names, plan.slots)}
    else:
        leaves, off = {}, 0
        for k in leaf_order(params):
            leaves[k] = field[off:off + params[k].numel()]
            off += params[k].numel()
    return torch.cat([leaves[k].reshape(-1).float()
                      for k in leaf_order(params)])


def _record(out, prefix, state, losses, plan):
    """A run's losses and state; ``plan`` is a ZeRO run's stream plan
    (None otherwise)."""
    out[prefix + "loss"] = np.asarray(losses, np.float64)
    out[prefix + "step"] = np.int64(state["opt"]["step"])
    for k, v in state["params"].items():
        out[prefix + "p/" + k] = v.numpy().copy()
    for site, rec in state["model_state"].items():
        for f, v in rec.items():
            out[f"{prefix}bn/{site}/{f}"] = v.numpy().copy()
    for k, v in state.get("ef_residual", {}).items():
        out[prefix + "ef/" + k] = v.numpy().copy()
    for f, v in state["opt"].items():
        if f != "step":
            out[prefix + "opt/" + f] = _opt_stream(
                v, state["params"], plan).numpy().copy()


def _run(step, state, data, put, first, count):
    losses = []
    for i in range(first, first + count):
        state, met = step(state, put(data.batch_at(i)))
        losses.append(float(met["loss"]))
    return state, losses


def _counted_step(step, state, data, put, hier):
    """One more step with the collectives counted per group: a dict
    (collective, group) -> calls, the groups named inner / outer /
    world."""
    import torch.distributed as dist
    names = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")
    real = {k: getattr(dist, k) for k in names}
    calls = {}

    def counted(name):
        def call(*a, **kw):
            g = kw.get("group")
            where = ("inner" if g is hier.inner_group else
                     "outer" if g is hier.outer_group else "world")
            calls[f"{name}/{where}"] = calls.get(f"{name}/{where}", 0) + 1
            return real[name](*a, **kw)
        return call

    for k in names:
        setattr(dist, k, counted(k))
    try:
        _run(step, state, data, put, 100, 1)
    finally:
        for k in names:
            setattr(dist, k, real[k])
    return calls


def _steps_worker(rank, out_dir):
    """One of 4 gloo workers: every case's run, three steps from one
    seed; the collectives of a bucketed and a ZeRO step; a ZeRO + hier
    checkpoint into the per-leaf run, the Trainer's resume, and the
    CLI."""
    torch.set_num_threads(WORKER_THREADS)
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=N)
    keep_group = False
    try:
        out = {}
        hier = tb.hierarchy_groups(tb.make_hierarchy(
            tlaunch.MESH_AXES, dict(zip(tlaunch.MESH_AXES, MESH)), 1))
        for case, kw in CASES.items():
            _, s, step, data, put, sh = _setup(**kw)
            s, losses = _run(step, s, data, put, 0,
                             STEPS_OF.get(case, STEPS))
            _record(out, case + "/", s, losses, sh.zero_plan)
            if case in ("bucketed", "zero"):
                for k, v in _counted_step(step, s, data, put, hier).items():
                    out[f"calls/{case}/{k}"] = np.int64(v)
                out[f"calls/{case}/n_buckets"] = np.int64(
                    tb.plan_buckets(s["params"], 64 << 20, "bf16",
                                    N).n_buckets)
        _checkpoint_runs(rank, out_dir, out)
        keep_group = True
        _cli_run(out_dir, out)  # shuts the group down itself
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        if not keep_group:
            shutdown()


def _checkpoint_runs(rank, out_dir, out):
    """A ZeRO + hier checkpoint restored into the per-leaf hierarchical
    run through the restore transform, then one more step of each; the
    Trainer's resume of a ZeRO + hier run."""
    import torch.distributed as dist
    kw = dict(HIER, error_feedback=True)
    directory = os.path.join(out_dir, "to_tree")
    _, src, step, data, put, sh = _setup(zero_dp=True, **kw)
    src, _ = _run(step, src, data, put, 0, 2)
    tree = interop.train_state_to_jax(src, sh)
    if rank == 0:
        save(directory, 2, tree, metadata={"opt_layout": "zero_stream"})
    dist.barrier()
    _, dst, dstep, ddata, dput, dsh = _setup(**kw)
    plan = sh.zero_plan
    hook = tstream.make_zero_restore_transform(
        plan, tstream.param_key_tree(dst["params"]), N, to_zero=False,
        fields=tstream.make_stream_optimizer(TOpt(), SPE, 16).state_fields)
    arrays, _ = restore(directory, transform=hook)
    interop.train_state_from_jax(arrays, dst, dsh)
    src, ls = _run(step, src, data, put, 2, 1)
    dst, ld = _run(dstep, dst, ddata, dput, 2, 1)
    _record(out, "to_tree/src/", src, ls, plan)
    _record(out, "to_tree/dst/", dst, ld, None)
    ck_dir = os.path.join(out_dir, "resume")
    results = []
    for total, d, every in ((4, None, 2), (2, ck_dir, 2), (4, ck_dir, 100)):
        _, s, step, data, put, sh = _setup(zero_dp=True, **kw)
        results.append(run_training(
            step, s, data, LoopConfig(total_steps=total,
                                      checkpoint_every=every,
                                      checkpoint_dir=d, log_every=1),
            put_batch=put, state_shardings=sh))
    ref, _, res = results
    out["resume/resumed_from"] = np.int64(res.resumed_from)
    _record(out, "resume/ref/", ref.state,
            [h["loss"] for h in ref.history[2:]], sh.zero_plan)
    _record(out, "resume/got/", res.state, [h["loss"] for h in res.history],
            sh.zero_plan)


def _cli_run(out_dir, out):
    """The CLI with ``--mesh 2x2 --comm-plan hier:1 --zero`` on the
    group this worker already joined (``main`` shuts it down)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tlaunch.main([
            "--reduced", "--dp-mode", "shardmap", "--compression",
            "bf16+bucketed", "--mesh", "2x2", "--comm-plan", "hier:1",
            "--zero", "--use-fused-kernel", "--fused-bn", "--epochs", "1",
            "--steps-per-epoch", "2", "--global-batch", str(PER_WORKER * N),
            "--val-batches", "1", "--ckpt-dir", os.path.join(out_dir, "cli"),
            "--ckpt-every", "2", "--device", "cpu"])
    out["cli/stdout"] = np.asarray(buf.getvalue())
    out["cli/losses"] = np.asarray([h["loss"] for h in res.history])
    out["cli/delta_numel"] = np.int64(res.state["opt"]["delta"].numel())


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("hier_steps"))
    mp.spawn(_steps_worker, args=(out_dir,), nprocs=N)
    return out_dir, [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                     for r in range(N)]


def _entries(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def _assert_bitwise(ranks, a, b, loss_rtol=None):
    """Every entry of run ``a`` bitwise run ``b``'s on every worker (the
    losses within ``loss_rtol`` when given), and every worker ends with
    the same parameters."""
    for rec in ranks:
        ea, eb = _entries(rec, a + "/"), _entries(rec, b + "/")
        if "opt/m" in ea and "opt/m" not in eb:
            # momentum_sgd's per-leaf state has no m: ZeRO's stays zeros
            assert not ea.pop("opt/m").any()
        assert ea.keys() == eb.keys(), sorted(set(ea) ^ set(eb))
        if loss_rtol is not None:
            np.testing.assert_allclose(ea.pop("loss"), eb.pop("loss"),
                                       rtol=loss_rtol)
        differ = [k for k in ea if not np.array_equal(ea[k], eb[k])]
        assert not differ, differ[:5]
    p0 = _entries(ranks[0], a + "/p/")
    for rec in ranks[1:]:
        for k, v in _entries(rec, a + "/p/").items():
            np.testing.assert_array_equal(v, p0[k])


@pytest.mark.parametrize("pair", list(BITWISE_PAIRS))
def test_hierarchical_pairs_are_bitwise(steps, pair):
    case, ref, loss_rtol = BITWISE_PAIRS[pair]
    _assert_bitwise(steps[1], case, ref, loss_rtol)


def test_zero_overlap_stream_lars_within_the_pair_tolerance(steps):
    for rec in steps[1]:
        zero = _entries(rec, "zero_overlap_lars/")
        ref = _entries(rec, "overlap_lars/")
        assert zero.keys() == ref.keys()
        np.testing.assert_allclose(zero["loss"], ref["loss"], **PAIR_TOL)
        assert zero["step"] == ref["step"] == STEPS
        for k in zero:
            if k.startswith(("p/", "opt/")):
                np.testing.assert_allclose(zero[k], ref[k], err_msg=k,
                                           **PAIR_TOL)


def test_flat_at_four_workers_is_close_to_the_hierarchical_step(steps):
    """Not bitwise: the flat bf16 sum rounds after each add. The first
    loss (no update yet) is bitwise and the loss after the first update
    within ``FLAT_FIRST_RTOL``, the check phase 14 of ``chip_smoke.py``
    holds its full-width pair to."""
    for rec in steps[1]:
        flat, hier = _entries(rec, "flat/"), _entries(rec, "hier_long/")
        assert len(flat["loss"]) == FLAT_STEPS
        assert flat["loss"][0] == hier["loss"][0]
        np.testing.assert_allclose(flat["loss"][1], hier["loss"][1],
                                   rtol=FLAT_FIRST_RTOL)
        np.testing.assert_allclose(flat["loss"], hier["loss"],
                                   rtol=FLAT_LOSS_RTOL)
        keys = [k for k in hier if k.startswith("p/")]
        num = sum(np.square(np.float64(flat[k]) - hier[k]).sum()
                  for k in keys)
        den = sum(np.square(np.float64(hier[k])).sum() for k in keys)
        assert (num / den) ** 0.5 < FLAT_PARAM_REL
        assert any(not np.array_equal(flat[k], hier[k]) for k in keys)


@pytest.mark.parametrize("case", ["bucketed", "zero"])
def test_collectives_a_step_per_group(steps, case):
    """A bucket's two-level all-reduce is 1 inner reduce-scatter, 1 outer
    all-reduce and 1 inner all-gather; ZeRO's double scatter 2
    reduce-scatters and its gather 2 all-gathers; plus the one flat
    all-reduce of the stacked metrics."""
    for rec in steps[1]:
        calls = {k[len(f"calls/{case}/"):]: int(v) for k, v in rec.items()
                 if k.startswith(f"calls/{case}/")}
        nb = calls.pop("n_buckets")
        if case == "bucketed":
            want = {"reduce_scatter_tensor/inner": nb,
                    "all_reduce/outer": nb,
                    "all_gather_into_tensor/inner": nb,
                    "all_reduce/world": 1}
        else:
            want = {"reduce_scatter_tensor/inner": nb,
                    "reduce_scatter_tensor/outer": nb,
                    "all_gather_into_tensor/outer": nb,
                    "all_gather_into_tensor/inner": nb,
                    "all_reduce/world": 1}
        assert calls == want


def test_zero_hier_checkpoint_goes_into_the_per_leaf_run(steps):
    _assert_bitwise(steps[1], "to_tree/src", "to_tree/dst")


def test_trainer_resumes_a_zero_hier_run_bitwise(steps):
    for rec in steps[1]:
        assert rec["resume/resumed_from"] == 2
    _assert_bitwise(steps[1], "resume/ref", "resume/got")


def test_cli_runs_mesh_and_hier_plan_with_zero(steps):
    out_dir, ranks = steps
    assert "comm plan: bucketed bf16 0KiB hier:1 on 2x2" in str(
        ranks[0]["cli/stdout"])
    for rec in ranks:
        assert len(rec["cli/losses"]) == 2
        assert np.isfinite(rec["cli/losses"]).all()
        assert rec["cli/delta_numel"] == -(-rec["zero/opt/delta"].size
                                           // N)  # the worker's shard
    arrays, manifest = restore(os.path.join(out_dir, "cli"))
    assert manifest["metadata"]["opt_layout"] == "zero_stream"
    assert arrays["['opt']['delta']"].size == N * ranks[0]["cli/delta_numel"]


# ---------------------------------------------------------------------------
# against the JAX package's shard_map step on a (2, 2) mesh, hier_split=1
# ---------------------------------------------------------------------------

JAX_CASES = {"rmsprop_warmup": {}, "momentum_sgd": dict(
    opt=dict(kind="momentum_sgd")), "zero": dict(zero_dp=True)}

_JAX_FOUR_DEVICES = """
    import jax, numpy as np
    from repro.configs import OptimizerConfig, get_config, reduced_config
    from repro.launch.train import build_train_setup
    from repro_torch import interop
    cfg = reduced_config(get_config("resnet50"))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    for name, kw in {cases!r}.items():
        kw = dict(kw)
        opt = OptimizerConfig(**kw.pop("opt", {{}}))
        _, s, step, data, put, _ = build_train_setup(
            cfg, global_batch={batch}, seq_len=0, opt_cfg=opt,
            steps_per_epoch={spe}, mesh=mesh, dp_mode="shardmap",
            compression="bf16+bucketed", use_fused_kernel=True,
            fused_bn=True, dp_axes=("data", "model"), hier_split=1, **kw)
        out = {{"p0/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}}
        for i in range({steps}):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{{i}}"] = np.float32(met["loss"])
        out.update({{"p/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}})
        np.savez(f"{out}/jax_{{name}}.npz", **out)
"""


def _jax_worker(rank, out_dir):
    """One of 4 gloo workers: each JAX case from JAX's initial parameters
    on the same 2x2 layout."""
    torch.set_num_threads(WORKER_THREADS)
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=N)
    try:
        for name, kw in JAX_CASES.items():
            ref = np.load(os.path.join(out_dir, f"jax_{name}.npz"))
            _, s, step, data, put, _ = _setup(**dict(HIER, **kw))
            with torch.no_grad():
                for k, v in s["params"].items():
                    v.copy_(torch.from_numpy(ref["p0/" + k]))
            s, losses = _run(step, s, data, put, 0, STEPS)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"port_{name}.npz"),
                         loss=np.asarray(losses),
                         **{"p/" + k: v.numpy()
                            for k, v in s["params"].items()})
    finally:
        shutdown()


@pytest.mark.slow
def test_hierarchical_step_matches_jax_shard_map_on_a_2x2_mesh(tmp_path):
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    body = textwrap.dedent(_JAX_FOUR_DEVICES.format(
        cases=JAX_CASES, batch=N * PER_WORKER, spe=SPE, steps=STEPS,
        out=tmp_path))
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    mp.spawn(_jax_worker, args=(str(tmp_path),), nprocs=N)
    for name in JAX_CASES:
        ref = np.load(tmp_path / f"jax_{name}.npz")
        got = np.load(tmp_path / f"port_{name}.npz")
        np.testing.assert_allclose(
            got["loss"], [ref[f"loss{i}"] for i in range(STEPS)], rtol=2e-5,
            err_msg=name)
        keys = [k for k in ref.files if k.startswith("p/")]
        num = sum(np.square(np.float64(got[k]) - ref[k]).sum() for k in keys)
        den = sum(np.square(np.float64(ref[k])).sum() for k in keys)
        assert (num / den) ** 0.5 < 2e-4, (name, (num / den) ** 0.5)
