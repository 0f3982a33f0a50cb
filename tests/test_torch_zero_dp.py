"""ZeRO on the port's data-parallel step (``--zero``) with gloo workers on
the CPU (a ``file://`` store), on the reduced ResNet in f32.

Each comparison, as the tests below state it:
- ZeRO against the port's bucketed step at 2 workers, over wire bf16 and
  f16 with error feedback off and on: **bitwise** (losses, parameters,
  BN state, residuals, ``opt.step``, and ``delta`` / ``m``: the bucketed
  run's per-leaf state packed into the leaf-order stream, of which the
  ZeRO worker holds block w of the shard layout).
- ZeRO + overlap against overlap (error feedback, 16 KiB buckets),
  stream-LARS under ZeRO against bucketed stream-LARS, and ZeRO
  ``momentum_sgd`` against bucketed ``momentum_sgd``: bitwise.
- ZeRO + overlap stream-LARS against overlapped stream-LARS: within
  rtol 1e-2 / atol 1e-4, the JAX package's own tolerance for this pair.
  A ZeRO worker holds only its ready-order shard, so the trust norms
  are summed over other shards (a divergence by design, ROADMAP queue
  3).
- The same pair at 4 workers (bf16, error feedback): bitwise.
- Checkpoints across the ZeRO boundary in the port, through
  ``make_zero_restore_transform``, then one more step: bitwise. The
  ``Trainer``'s resume under ZeRO: bitwise the unbroken run. The
  sentinel's rollback under ZeRO completes; the CLI runs ``--zero``.
- ``slow``: against the JAX package's shard_map ZeRO on 2 virtual
  devices (plain, and ZeRO + overlap stream-LARS): losses within rtol
  2e-5, parameters within a relative norm of 2e-4 (the DP tolerances),
  ``delta`` / ``m`` through ``interop`` within 2e-4; a JAX ZeRO
  checkpoint restored by the port's two workers and saved back is the
  JAX file (keys, dtypes, crc32s), which JAX restores bitwise.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.checkpoint import checkpointer as jck
from repro_torch import interop
from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import init_workers, shutdown
from repro_torch.distributed.bucketing import (leaf_order, shard_size,
                                               stream_to_shard_layout)
from repro_torch.launch import train as tlaunch
from repro_torch.optim import stream as tstream
from repro_torch.resilience import ResilienceConfig, parse_chaos
from repro_torch.training import LoopConfig, Trainer, TrainerConfig
from repro_torch.training import run_training

ROOT = os.path.join(os.path.dirname(__file__), "..")
PER_WORKER, SPE, STEPS = 8, 4, 3
SMALL_BUCKET = 16384  # several ready-order buckets of the reduced stream
LARS = dict(kind="lars", schedule="poly", warmup_epochs=1.0,
            total_epochs=1.0)
CASES = {
    "bf16": dict(compression="bf16+bucketed"),
    "bf16_ef": dict(compression="bf16+bucketed", error_feedback=True),
    "f16": dict(compression="f16+bucketed"),
    "f16_ef": dict(compression="f16+bucketed", error_feedback=True),
    "overlap_ef": dict(compression="bf16+bucketed", error_feedback=True,
                       overlap_comm=True, bucket_bytes=SMALL_BUCKET),
    "lars": dict(compression="bf16+bucketed", opt=LARS,
                 label_smoothing=0.1),
    "momentum": dict(compression="bf16+bucketed",
                     opt=dict(kind="momentum_sgd")),
    "lars_overlap": dict(compression="bf16+bucketed", opt=LARS,
                         label_smoothing=0.1, overlap_comm=True,
                         bucket_bytes=SMALL_BUCKET),
}
PAIR_TOL = dict(rtol=1e-2, atol=1e-4)
# intra-op threads a worker process: the suite runs files side by side
WORKER_THREADS = 2


def _setup(n, zero_dp, opt=None, sentinel=False, **kw):
    return tlaunch.build_train_setup(
        treduced(tget("resnet50")), global_batch=PER_WORKER * n, seq_len=0,
        opt_cfg=TOpt(**(opt or {})), steps_per_epoch=SPE,
        dp_mode="shardmap", use_fused_kernel=True, fused_bn=True,
        zero_dp=zero_dp, sentinel=sentinel, device="cpu", **kw)


def _leaves(field, params):
    """A per-leaf optimizer field, or a flat leaf-order stream cut into
    leaves."""
    if isinstance(field, dict):
        return field
    out, off = {}, 0
    for k in leaf_order(params):
        n = params[k].numel()
        out[k] = field[off:off + n]
        off += n
    return out


def _as_zero_shard(field, params, plan, n, w):
    """A run's optimizer field in ZeRO's layout: its leaves packed into
    the stream of ``plan`` (+ the zero pad), block ``w`` of its shard
    layout."""
    leaves = _leaves(field, params)
    stream = torch.cat([leaves[k].reshape(-1).float() for k in plan.names]
                       + [torch.zeros(plan.pad_elems)])
    size = shard_size(plan, n)
    return stream_to_shard_layout(stream, plan, n)[w * size:(w + 1) * size]


def _record(out, prefix, state, losses, plan, n, w):
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
        if f == "step":
            continue
        shard = (v if torch.is_tensor(v) and v.numel() == shard_size(plan, n)
                 else _as_zero_shard(v, state["params"], plan, n, w))
        out[prefix + "opt/" + f] = shard.float().numpy().copy()


def _run(step, state, data, put, first, count):
    losses = []
    for i in range(first, first + count):
        state, met = step(state, put(data.batch_at(i)))
        losses.append(float(met["loss"]))
    return state, losses


def _pairs_worker(rank, out_dir, n, cases):
    """One gloo worker: each case's run without and with ZeRO, three
    steps from the same seed; at 2 workers also the checkpoint, resume,
    rollback and CLI runs."""
    torch.set_num_threads(WORKER_THREADS)
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=n)
    keep_group = False
    try:
        out = {}
        for case in cases:
            kw = CASES[case]
            plan = None
            for zero in (True, False):
                _, s, step, data, put, sh = _setup(n, zero, **kw)
                plan = sh.zero_plan if zero else plan
                s, losses = _run(step, s, data, put, 0, STEPS)
                _record(out, f"{case}/{'zero' if zero else 'ref'}/", s,
                        losses, plan, n, rank)
        if n == 2:
            _checkpoint_runs(rank, out_dir, out)
            keep_group = True
            _cli_run(out_dir, out)  # shuts the group down itself
        np.savez(os.path.join(out_dir, f"n{n}_rank{rank}.npz"), **out)
    finally:
        if not keep_group:
            shutdown()


def _checkpoint_runs(rank, out_dir, out):
    """Tree <-> ZeRO checkpoints through the restore transform, then one
    more step; the Trainer's resume and the sentinel's rollback under
    ZeRO."""
    import torch.distributed as dist
    kw = CASES["bf16_ef"]
    for to_zero in (True, False):
        name = "to_zero" if to_zero else "to_tree"
        directory = os.path.join(out_dir, name)
        _, src, step, data, put, sh = _setup(2, not to_zero, **kw)
        src, _ = _run(step, src, data, put, 0, 2)
        tree = interop.train_state_to_jax(src, sh)
        if rank == 0:
            save(directory, 2, tree, metadata={"opt_layout": "zero_stream"
                                               if not to_zero else "tree"})
        dist.barrier()
        _, dst, dstep, ddata, dput, dsh = _setup(2, to_zero, **kw)
        zsh = dsh if to_zero else sh
        plan = zsh.zero_plan
        sopt = tstream.make_stream_optimizer(TOpt(), SPE, 16)
        hook = tstream.make_zero_restore_transform(
            plan, tstream.param_key_tree(dst["params"]), 2, to_zero=to_zero,
            fields=sopt.state_fields)
        arrays, _ = restore(directory, transform=hook)
        interop.train_state_from_jax(arrays, dst, dsh)
        src, ls = _run(step, src, data, put, 2, 1)
        dst, ld = _run(dstep, dst, ddata, dput, 2, 1)
        _record(out, f"{name}/src/", src, ls, plan, 2, rank)
        _record(out, f"{name}/dst/", dst, ld, plan, 2, rank)
    # the Trainer's resume: an unbroken run of 4 steps, then 2 steps
    # saved and a fresh run resumed from them to 4
    ck_dir = os.path.join(out_dir, "resume")
    results = []
    for total, directory, every in ((4, None, 2), (2, ck_dir, 2),
                                    (4, ck_dir, 100)):
        _, s, step, data, put, sh = _setup(2, True, **kw)
        res = run_training(step, s, data,
                           LoopConfig(total_steps=total,
                                      checkpoint_every=every,
                                      checkpoint_dir=directory, log_every=1),
                           put_batch=put, state_shardings=sh)
        results.append(res)
    ref, _, res = results
    out["resume/resumed_from"] = np.int64(res.resumed_from)
    _record(out, "resume/ref/", ref.state, [h["loss"] for h in
                                            ref.history[2:]],
            sh.zero_plan, 2, rank)
    _record(out, "resume/got/", res.state, [h["loss"] for h in res.history],
            sh.zero_plan, 2, rank)
    # the sentinel's rollback: saves at 2 and 4, NaN batches at steps 4
    # and 5 roll back to the step-4 checkpoint, and the run goes on
    _, s, step, data, put, sh = _setup(2, True, sentinel=True, **kw)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=6, eval_every_epochs=0,
                         val_batches=0, checkpoint_every=2,
                         checkpoint_dir=os.path.join(out_dir, "rollback"),
                         log_every=1)
    res = Trainer(step, s, data, tcfg, put_batch=put, state_shardings=sh,
                  resilience=ResilienceConfig(max_consecutive_bad=2),
                  chaos=parse_chaos("nan_grad@4-5")).run()
    rb = [r for r in res.events if r["kind"] == "rollback"]
    out["rollback/to_step"] = np.int64(rb[0]["to_step"] if rb else -1)
    out["rollback/count"] = np.int64(len(rb))
    out["rollback/last_step"] = np.int64(res.history[-1]["step"])
    out["rollback/last_loss"] = np.float64(res.history[-1]["loss"])
    out["rollback/opt_step"] = np.int64(res.state["opt"]["step"])


def _cli_run(out_dir, out):
    """The CLI with ``--zero`` on the group this worker already joined
    (``main`` shuts it down at the end)."""
    directory = os.path.join(out_dir, "cli")
    res = tlaunch.main([
        "--reduced", "--dp-mode", "shardmap", "--compression",
        "bf16+bucketed", "--zero", "--use-fused-kernel", "--fused-bn",
        "--epochs", "1", "--steps-per-epoch", "2", "--global-batch", "16",
        "--val-batches", "1", "--ckpt-dir", directory, "--ckpt-every", "2",
        "--device", "cpu"])
    out["cli/losses"] = np.asarray([h["loss"] for h in res.history])
    out["cli/delta_numel"] = np.int64(res.state["opt"]["delta"].numel())


def _spawn(tmp_path_factory, n, cases):
    out_dir = str(tmp_path_factory.mktemp(f"zero{n}"))
    mp.spawn(_pairs_worker, args=(out_dir, n, cases), nprocs=n)
    return out_dir, [dict(np.load(os.path.join(out_dir, f"n{n}_rank{r}.npz")))
                     for r in range(n)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory, 2, list(CASES))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory, 4, ["bf16_ef"])


def _entries(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def _assert_bitwise(rec, a, b):
    """Every entry under prefix ``a`` is bitwise the same under ``b``
    (``m`` only where both runs keep it)."""
    ea, eb = _entries(rec, a), _entries(rec, b)
    assert ea.keys() == eb.keys(), sorted(set(ea) ^ set(eb))
    differ = [k for k in ea if not np.array_equal(ea[k], eb[k])]
    assert not differ, differ[:5]
    assert any(k.startswith("opt/delta") for k in ea)


def _assert_pair_bitwise(ranks, case, loss_rtol=None):
    """Every entry of the two runs' states bitwise equal, and their
    losses too unless ``loss_rtol`` is given."""
    for rec in ranks:
        zero = _entries(rec, f"{case}/zero/")
        ref = _entries(rec, f"{case}/ref/")
        if "opt/m" in zero and "opt/m" not in ref:
            # momentum_sgd's per-leaf state has no m: ZeRO's stays zeros
            assert not zero.pop("opt/m").any()
        assert zero.keys() == ref.keys()
        if loss_rtol is not None:
            np.testing.assert_allclose(zero.pop("loss"), ref.pop("loss"),
                                       rtol=loss_rtol)
        differ = [k for k in zero if not np.array_equal(zero[k], ref[k])]
        assert not differ, differ[:5]
    # every worker ends with the same parameters
    p0 = _entries(ranks[0], f"{case}/zero/p/")
    for rec in ranks[1:]:
        for k, v in _entries(rec, f"{case}/zero/p/").items():
            np.testing.assert_array_equal(v, p0[k])


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("wire", ["bf16", "f16"])
def test_zero_is_bitwise_the_bucketed_step(two, wire, ef):
    _assert_pair_bitwise(two[1], wire + ("_ef" if ef else ""))


@pytest.mark.parametrize("case", ["overlap_ef", "lars", "momentum"])
def test_zero_variants_are_bitwise_their_all_reduce_paths(two, case):
    """ZeRO + overlap against overlap, stream-LARS and momentum_sgd under
    ZeRO against their bucketed steps."""
    _assert_pair_bitwise(two[1], case)


def test_zero_overlap_stream_lars_within_the_pair_tolerance(two):
    for rec in two[1]:
        zero = _entries(rec, "lars_overlap/zero/")
        ref = _entries(rec, "lars_overlap/ref/")
        assert zero.keys() == ref.keys()
        np.testing.assert_allclose(zero["loss"], ref["loss"], **PAIR_TOL)
        assert zero["step"] == ref["step"] == STEPS
        for k in zero:
            if k.startswith(("p/", "opt/")):
                np.testing.assert_allclose(zero[k], ref[k], err_msg=k,
                                           **PAIR_TOL)


def test_zero_is_bitwise_the_bucketed_step_at_four_workers(four):
    """The state bitwise. The logged loss is the workers' mean from one
    all-reduce of the stacked scalar metrics, and ZeRO's stack has one
    more entry (the shard's squared gradient norm): gloo's ring at 4
    workers then adds each entry in another order, so the loss may
    differ in its last bit (at 2 workers a sum of two is exact in any
    order)."""
    _assert_pair_bitwise(four[1], "bf16_ef", loss_rtol=2.4e-7)


@pytest.mark.parametrize("direction", ["to_zero", "to_tree"])
def test_checkpoints_cross_the_zero_boundary(two, direction):
    """A per-leaf checkpoint restored into a ZeRO run, and a ZeRO
    checkpoint into a per-leaf run, through the restore transform: one
    more step is bitwise the run that saved it."""
    for rec in two[1]:
        _assert_bitwise(rec, f"{direction}/src/", f"{direction}/dst/")


def test_trainer_resumes_a_zero_run_bitwise(two):
    for rec in two[1]:
        assert rec["resume/resumed_from"] == 2
        _assert_bitwise(rec, "resume/ref/", "resume/got/")


def test_sentinel_rolls_back_a_zero_run(two):
    for rec in two[1]:
        assert rec["rollback/count"] == 1 and rec["rollback/to_step"] == 4
        assert rec["rollback/last_step"] == 5
        assert rec["rollback/opt_step"] == 6
        assert np.isfinite(rec["rollback/last_loss"])


def test_cli_runs_zero_and_tags_its_checkpoints(two):
    out_dir, ranks = two
    for rec in ranks:
        assert len(rec["cli/losses"]) == 2
        assert np.isfinite(rec["cli/losses"]).all()
        assert rec["cli/delta_numel"] == \
            rec["bf16/zero/opt/delta"].size  # the worker's shard
    arrays, manifest = restore(os.path.join(out_dir, "cli"))
    assert manifest["metadata"]["opt_layout"] == "zero_stream"
    # the global shard-layout stream, one array per field
    assert arrays["['opt']['delta']"].size == \
        2 * ranks[0]["cli/delta_numel"]


# ---------------------------------------------------------------------------
# against the JAX package's shard_map ZeRO on 2 virtual devices
# ---------------------------------------------------------------------------

JAX_CASES = {"plain": {}, "overlap_lars": dict(
    opt=LARS, label_smoothing=0.1, overlap_comm=True,
    bucket_bytes=SMALL_BUCKET)}

_JAX_TWO_DEVICES = """
    import jax, numpy as np
    from repro.checkpoint import save
    from repro.configs import OptimizerConfig, get_config, reduced_config
    from repro.launch.train import build_train_setup
    from repro_torch import interop
    cfg = reduced_config(get_config("resnet50"))
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    for name, kw in {cases!r}.items():
        kw = dict(kw)
        opt = OptimizerConfig(**kw.pop("opt", {{}}))
        _, s, step, data, put, _ = build_train_setup(
            cfg, global_batch={batch}, seq_len=0, opt_cfg=opt,
            steps_per_epoch={spe}, mesh=mesh, dp_mode="shardmap",
            compression="bf16+bucketed", zero_dp=True,
            use_fused_kernel=True, fused_bn=True, **kw)
        out = {{"p0/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}}
        for i in range({steps}):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{{i}}"] = np.float32(met["loss"])
            # through the host: the overlapped ZeRO step's aux builder
            # cannot slice its own sharded per-worker BN state output
            # (ShardingTypeError on the second call, this JAX version)
            s = jax.tree.map(np.asarray, s)
        out.update({{"p/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}})
        for f in ("delta", "m"):
            if f in s["opt"]:
                out["opt/" + f] = np.asarray(s["opt"][f])
        np.savez(f"{out}/jax_{{name}}.npz", **out)
        save(f"{out}/ck_{{name}}", {steps}, s, metadata={{"from": "jax"}})
"""


def _jax_worker(rank, out_dir):
    """A gloo worker: each JAX case from JAX's initial parameters, the
    port's ZeRO state in the JAX layout (rank 0), and JAX's checkpoint
    restored into the port's shards and saved back (rank 0 writes)."""
    torch.set_num_threads(WORKER_THREADS)
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=2)
    try:
        for name, kw in JAX_CASES.items():
            ref = np.load(os.path.join(out_dir, f"jax_{name}.npz"))
            _, s, step, data, put, sh = _setup(
                2, True, compression="bf16+bucketed", **kw)
            with torch.no_grad():
                for k, v in s["params"].items():
                    v.copy_(torch.from_numpy(ref["p0/" + k]))
            s, losses = _run(step, s, data, put, 0, STEPS)
            tree = interop.train_state_to_jax(s, sh)
            if rank == 0:
                out = {"loss": np.asarray(losses)}
                out.update({"p/" + k: v.numpy() for k, v in
                            s["params"].items()})
                out.update({"opt/" + f: tree["opt"][f] for f in ("delta", "m")
                            if f in tree["opt"]})
                np.savez(os.path.join(out_dir, f"port_{name}.npz"), **out)
            _, fresh, _, _, _, sh = _setup(
                2, True, compression="bf16+bucketed", **kw)
            arrays, manifest = restore(os.path.join(out_dir, f"ck_{name}"))
            interop.train_state_from_jax(arrays, fresh, sh)
            tree = interop.train_state_to_jax(fresh, sh)
            if rank == 0:
                save(os.path.join(out_dir, f"port_ck_{name}"),
                     manifest["step"], tree, metadata=manifest["metadata"])
    finally:
        shutdown()


def _rel(a, b) -> float:
    a, b = np.float64(a), np.float64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.slow
def test_zero_matches_jax_shard_map_zero_on_two_devices(tmp_path):
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    body = textwrap.dedent(_JAX_TWO_DEVICES.format(
        cases=JAX_CASES, batch=2 * PER_WORKER, spe=SPE, steps=STEPS,
        out=tmp_path))
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    mp.spawn(_jax_worker, args=(str(tmp_path),), nprocs=2)
    for name in JAX_CASES:
        ref = np.load(tmp_path / f"jax_{name}.npz")
        got = np.load(tmp_path / f"port_{name}.npz")
        np.testing.assert_allclose(
            got["loss"], [ref[f"loss{i}"] for i in range(STEPS)], rtol=2e-5)
        keys = [k for k in ref.files if k.startswith("p/")]
        num = sum(np.square(np.float64(got[k]) - ref[k]).sum() for k in keys)
        den = sum(np.square(np.float64(ref[k])).sum() for k in keys)
        assert (num / den) ** 0.5 < 2e-4, name
        fields = [k for k in ref.files if k.startswith("opt/")]
        assert fields == [k for k in got.files if k.startswith("opt/")]
        for f in fields:  # the JAX layout: global shard-layout arrays
            assert got[f].shape == ref[f].shape
            assert _rel(got[f], ref[f]) < 2e-4, (name, f)
        # JAX's checkpoint through the port's shards and back: the same
        # file, which JAX restores bitwise
        jdir, pdir = tmp_path / f"ck_{name}", tmp_path / f"port_ck_{name}"
        jarrays, _ = jck.restore(str(jdir))
        parrays, _ = ck.restore(str(pdir))
        assert jarrays.keys() == parrays.keys()
        for k in jarrays:
            assert jarrays[k].dtype == parrays[k].dtype, k
            assert jarrays[k].tobytes() == parrays[k].tobytes(), k
        got_tree, _ = jck.restore(str(pdir), target=_nest(jarrays))
        for k, v in jck._flatten(got_tree).items():
            assert v.tobytes() == jarrays[k].tobytes(), k


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        parts = interop._KEY.findall(key)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
