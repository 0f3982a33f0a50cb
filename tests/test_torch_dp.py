"""The port's data-parallel step (``make_dp_shardmap_train_step`` over
``torch.distributed``, gloo on the CPU) against its own single-device
step and against the JAX package's shard_map step.

1. One worker against slice 1's single-device step: bitwise (an
   all-reduce over one worker and a division by 1 change no bit).
2. One worker against JAX shard_map on a one-device mesh, with fused BN,
   the fused update, the bucketed bf16 all-reduce and the fused input:
   losses within rtol 2e-5 and parameters within a relative norm of
   2e-4 (the tolerances of ``test_torch_slice.py``; the Pallas update
   rounds ``(1 - mu2) * g * g`` in another order), ``grad_norm`` within
   rtol 1e-4. BN statistics of the first step (taken with the same
   parameters) within rtol 1e-3 / atol 1e-5 (sums in another order);
   later ones follow parameters that the RMSprop warm-up has moved
   apart by a relative norm of about 1e-5 (each sign flip of a tiny
   gradient moves an element by about 3e-3), so means of order 1 land
   up to 4e-4 apart: rtol / atol 1e-3.
3. Two gloo workers (``torch.multiprocessing.spawn``) against JAX
   shard_map on two virtual devices (a subprocess), per-leaf bf16 and
   bucketed bf16, global batch 16 so each worker normalizes the 8
   samples of test 2 (at 4 samples per worker the first step flips the
   sign of a near-zero stem BN bias gradient, and after two steps the
   parameters lie 3.5e-4 apart in relative norm; at 8 they lie 4e-7
   apart): the same tolerances, each worker's BN state after the
   second step against
   JAX's slice of that worker, and the finalized statistics against
   ``combine_worker_bn_stats``; the two workers' parameters are bitwise
   equal, and their finalized statistics equal the port's own host
   combine bitwise (a sum of two, halved).
4. The options: cross-replica BN and the overlapped sync build and step
   through ``build_train_setup`` and the CLI, apart and together; ZeRO
   at one worker raises, also under the overlapped sync, and so does a
   hierarchical split of a one-axis DP layout, and ``--comm-plan``
   outside the DP step. ``test_torch_sync_bn.py`` and
   ``test_torch_overlap.py`` hold the two against JAX;
   ``test_torch_hierarchical.py`` the hierarchical schedules.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import InputConfig as JInput, OptimizerConfig as JOpt
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.launch.train import build_eval_setup as jeval_setup
from repro.launch.train import build_train_setup as jsetup
from repro_torch import interop
from repro_torch.configs import InputConfig as TInput, OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.core.batchnorm import combine_worker_bn_stats
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch

ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH, SPE = 8, 4
STATE_TOL = dict(rtol=1e-3, atol=1e-5)
DRIFT_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture
def one_worker(tmp_path):
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    yield
    shutdown()


def _load(tparams, flat):
    with torch.no_grad():
        for k, v in tparams.items():
            v.copy_(torch.as_tensor(flat[k]))


def _rel_norm(a, b) -> float:
    num = sum(float((torch.as_tensor(a[k]).double()
                     - torch.as_tensor(b[k]).double()).square().sum())
              for k in b)
    den = sum(float(torch.as_tensor(b[k]).double().square().sum())
              for k in b)
    return (num / den) ** 0.5


def _state_close(tstate, jstate, tol=STATE_TOL):
    for site, rec in tstate.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                np.asarray(rec[k]), np.asarray(jstate[site][k]),
                err_msg=f"{site}/{k}", **tol)


@pytest.mark.parametrize("compression", ["bf16", "bf16+bucketed"])
def test_one_worker_equals_single_device_step_bitwise(one_worker,
                                                      compression):
    cfg = treduced(tget("resnet50"))
    kw = dict(global_batch=BATCH, seq_len=0, opt_cfg=TOpt(),
              steps_per_epoch=SPE, fused_bn=True, device="cpu")
    _, s1, step1, d1, put1, _ = tlaunch.build_train_setup(
        cfg, compression="bf16", **kw)
    _, s2, step2, d2, put2, _ = tlaunch.build_train_setup(
        cfg, dp_mode="shardmap", compression=compression, **kw)
    assert put1 is None and put2 is not None
    for i in range(3):
        s1, m1 = step1(s1, d1.batch_at(i))
        s2, m2 = step2(s2, put2(d2.batch_at(i)))
        assert float(m1["loss"]) == float(m2["loss"])
        assert float(m2["grad_norm"]) > 0
    for k, v in s1["params"].items():
        assert torch.equal(v, s2["params"][k]), k
        for f in ("delta", "m"):
            assert torch.equal(s1["opt"][f][k], s2["opt"][f][k]), (f, k)
    for site, rec in s1["model_state"].items():
        for k, v in rec.items():
            assert torch.equal(v, s2["model_state"][site][k]), (site, k)


def test_one_worker_matches_jax_shardmap(one_worker):
    jc, tc = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    kw = dict(global_batch=BATCH, seq_len=0, steps_per_epoch=SPE,
              dp_mode="shardmap", fused_bn=True, use_fused_kernel=True,
              compression="bf16+bucketed")
    jm, js, jstep, jdata, jput, _ = jsetup(
        jc, opt_cfg=JOpt(), mesh=mesh,
        input_cfg=JInput(fused=True, augment=False), **kw)
    tm, ts, tstep, tdata, tput, _ = tlaunch.build_train_setup(
        tc, opt_cfg=TOpt(), input_cfg=TInput(fused=True, augment=False),
        device="cpu", **kw)
    _load(ts["params"], interop.params_from_jax(
        jax.tree.map(np.asarray, js["params"]), device="cpu"))
    for i in range(3):
        js, jmet = jstep(js, jput(jdata.batch_at(i)))
        ts, tmet = tstep(ts, tput(tdata.batch_at(i)))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        jp = interop.params_from_jax(jax.tree.map(np.asarray, js["params"]),
                                     device="cpu")
        assert _rel_norm(ts["params"], jp) < 2e-4
        jstate = jax.tree.map(np.asarray, js["model_state"])
        _state_close(ts["model_state"], interop.worker_state_from_jax(
            jstate, 0, device="cpu"), STATE_TOL if i == 0 else DRIFT_TOL)
    jev, jvd, jfin = jeval_setup(jm, jc, global_batch=BATCH, seq_len=0,
                                 dp_mode="shardmap", mesh=mesh,
                                 input_cfg=JInput(fused=True, augment=False))
    tev, tvd, tfin = tlaunch.build_eval_setup(
        tm, tc, global_batch=BATCH, seq_len=0, dp_mode="shardmap",
        input_cfg=TInput(fused=True, augment=False))
    jfinal, tfinal = jfin(js["model_state"]), tfin(ts["model_state"])
    _state_close(tfinal, jax.tree.map(np.asarray, jfinal), DRIFT_TOL)
    # host copies: the eval program runs unsharded
    jr = jev(jax.tree.map(np.asarray, js["params"]),
             jax.tree.map(np.asarray, jfinal), jvd.batch_at(0))
    tr = tev(ts["params"], tfinal, tvd.batch_at(0))
    assert float(tr["top1"]) == float(jr["top1"])
    np.testing.assert_allclose(float(tr["loss"]), float(jr["loss"]),
                               rtol=1e-4)


def test_worker_states_split_from_and_stack_to_jax_layout():
    """The JAX package keeps every worker's BN state under a leading
    worker dim; the port keeps one state per rank. Splitting and
    stacking are inverse, bitwise."""
    rng = np.random.default_rng(0)
    jstate = {site: {"mean": rng.standard_normal((3, c), np.float32),
                     "var": rng.random((3, c), np.float32),
                     "count": np.full((3,), 8.0, np.float32)}
              for site, c in (("stem/bn", 4), ("stage0/block0/bn1", 2))}
    ranks = [interop.worker_state_from_jax(jstate, r, device="cpu")
             for r in range(3)]
    assert torch.equal(ranks[2]["stem/bn"]["mean"],
                       torch.from_numpy(jstate["stem/bn"]["mean"][2]))
    back = interop.stack_worker_states(ranks)
    for site, rec in jstate.items():
        for k, v in rec.items():
            np.testing.assert_array_equal(back[site][k], v)


# ---------------------------------------------------------------------------
# two workers
# ---------------------------------------------------------------------------

COMPRESSIONS = ("bf16", "bf16+bucketed")
STEPS = 2
TWO_BATCH = 16  # 8 samples per worker, as the one-worker tests

_JAX_TWO_DEVICES = """
    import jax, numpy as np
    from repro.configs import OptimizerConfig, get_config, reduced_config
    from repro.core.batchnorm import combine_worker_bn_stats
    from repro.launch.train import build_train_setup
    from repro_torch import interop
    cfg = reduced_config(get_config("resnet50"))
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    for comp in {comps!r}:
        _, s, step, data, put, _ = build_train_setup(
            cfg, global_batch={batch}, seq_len=0, opt_cfg=OptimizerConfig(),
            steps_per_epoch={spe}, mesh=mesh, dp_mode="shardmap",
            compression=comp)
        out = {{"p0/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}}
        for i in range({steps}):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{{i}}"] = np.float32(met["loss"])
        out.update({{"p/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}})
        ms = jax.tree.map(np.asarray, s["model_state"])
        fin = jax.tree.map(np.asarray, combine_worker_bn_stats(ms))
        for site, rec in ms.items():
            for k in ("mean", "var"):
                out[f"bn/{{site}}/{{k}}"] = rec[k]
                out[f"fin/{{site}}/{{k}}"] = fin[site][k]
        np.savez("{out}/jax_" + comp.replace("+", "_") + ".npz", **out)
"""


def _port_worker(rank, out_dir, comp):
    tag = comp.replace("+", "_")
    init_workers("cpu", init_method=f"file://{out_dir}/store_{tag}",
                 rank=rank, world_size=2)
    try:
        ref = np.load(os.path.join(out_dir, f"jax_{tag}.npz"))
        cfg = treduced(tget("resnet50"))
        _, s, step, data, put, _ = tlaunch.build_train_setup(
            cfg, global_batch=TWO_BATCH, seq_len=0, opt_cfg=TOpt(),
            steps_per_epoch=SPE, dp_mode="shardmap", compression=comp,
            device="cpu")
        _load(s["params"], {k[3:]: ref[k] for k in ref.files
                            if k.startswith("p0/")})
        out = {}
        for i in range(STEPS):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{i}"] = float(met["loss"])
        fin = tlaunch.finalize_worker_bn_stats(s["model_state"])
        out.update({"p/" + k: v.numpy() for k, v in s["params"].items()})
        for site, rec in s["model_state"].items():
            for k in ("mean", "var"):
                out[f"bn/{site}/{k}"] = rec[k].numpy()
                out[f"fin/{site}/{k}"] = fin[site][k].numpy()
        np.savez(os.path.join(out_dir, f"port_{rank}_{tag}.npz"), **out)
    finally:
        shutdown()


@pytest.mark.slow
def test_two_workers_match_jax_shardmap_on_two_devices(tmp_path):
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    body = textwrap.dedent(_JAX_TWO_DEVICES.format(
        comps=COMPRESSIONS, batch=TWO_BATCH, spe=SPE, steps=STEPS,
        out=tmp_path))
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    for comp in COMPRESSIONS:
        tag = comp.replace("+", "_")
        mp.spawn(_port_worker, args=(str(tmp_path), comp), nprocs=2)
        ref = np.load(tmp_path / f"jax_{tag}.npz")
        ranks = [np.load(tmp_path / f"port_{r}_{tag}.npz") for r in (0, 1)]
        for i in range(STEPS):
            for got in ranks:
                np.testing.assert_allclose(got[f"loss{i}"], ref[f"loss{i}"],
                                           rtol=2e-5)
        p = {k[2:]: ranks[0][k] for k in ranks[0].files
             if k.startswith("p/")}
        for k, v in p.items():
            np.testing.assert_array_equal(v, ranks[1]["p/" + k])
        assert _rel_norm(p, {k[2:]: ref[k] for k in ref.files
                             if k.startswith("p/")}) < 2e-4
        sites = sorted({k.split("/", 1)[1].rsplit("/", 1)[0]
                        for k in ref.files if k.startswith("bn/")})
        for r, got in enumerate(ranks):
            _state_close({s: {k: got[f"bn/{s}/{k}"] for k in ("mean", "var")}
                          for s in sites},
                         {s: {k: ref[f"bn/{s}/{k}"][r]
                              for k in ("mean", "var")} for s in sites},
                         DRIFT_TOL)
        stacked = {s: {k: torch.stack([torch.from_numpy(g[f"bn/{s}/{k}"])
                                       for g in ranks])
                       for k in ("mean", "var")} for s in sites}
        host = combine_worker_bn_stats(
            {s: {**rec, "count": torch.ones(2)} for s, rec in stacked.items()})
        for got in ranks:
            for s in sites:
                for k in ("mean", "var"):
                    np.testing.assert_array_equal(got[f"fin/{s}/{k}"],
                                                  host[s][k].numpy())
                    np.testing.assert_allclose(
                        got[f"fin/{s}/{k}"], ref[f"fin/{s}/{k}"],
                        err_msg=f"{s}/{k}", **DRIFT_TOL)


def test_cli_runs_the_dp_path_on_cpu(capsys):
    res = tlaunch.main([
        "--reduced", "--dp-mode", "shardmap", "--compression",
        "bf16+bucketed", "--use-fused-kernel", "--fused-input", "--fused-bn",
        "--data-workers", "2", "--epochs", "1", "--steps-per-epoch", "2",
        "--global-batch", "8", "--val-batches", "1", "--device", "cpu"])
    assert len(res.history) == 2 and len(res.epoch_history) == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert "dp_mode=shardmap, 1 worker(s)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw,exc,match", [
    # error feedback is ported; without a wire dtype it has nothing to
    # correct, and raises as the JAX package does
    (dict(error_feedback=True, compression="none"), ValueError,
     "requires a wire dtype"),
    # ZeRO is ported; with one worker it has nothing to shard, and its
    # step raises as the JAX package's does
    (dict(zero_dp=True, compression="bf16+bucketed"), ValueError,
     "DP degree >= 2"),
    (dict(zero_dp=True, overlap_comm=True, compression="bf16+bucketed"),
     ValueError, "DP degree >= 2")])
def test_unported_dp_options_raise(kw, exc, match):
    try:
        with pytest.raises(exc, match=match):
            tlaunch.build_train_setup(
                treduced(tget("resnet50")), global_batch=BATCH, seq_len=0,
                opt_cfg=TOpt(), steps_per_epoch=SPE, dp_mode="shardmap",
                device="cpu", **kw)
    finally:
        shutdown()
    # a comm plan reschedules the DP step's collectives: without the DP
    # step the CLI refuses it
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--comm-plan", "auto", "--device", "cpu"])


@pytest.mark.parametrize("kw", [dict(sync_bn=True), dict(overlap_comm=True),
                                dict(sync_bn=True, overlap_comm=True)],
                         ids=["sync_bn", "overlap_comm", "both"])
def test_sync_bn_and_overlap_build_and_step(kw):
    try:
        model, s, step, data, put, _ = tlaunch.build_train_setup(
            treduced(tget("resnet50")), global_batch=BATCH, seq_len=0,
            opt_cfg=TOpt(), steps_per_epoch=SPE, dp_mode="shardmap",
            compression="bf16+bucketed", fused_bn=True, device="cpu", **kw)
        assert (model.bn_group is not None) == bool(kw.get("sync_bn"))
        assert (step.__qualname__.startswith("make_dp_overlap_train_step")
                == bool(kw.get("overlap_comm")))
        p0 = {k: v.clone() for k, v in s["params"].items()}
        for i in range(2):
            s, met = step(s, put(data.batch_at(i)))
            assert np.isfinite(float(met["loss"]))
        assert all(not torch.equal(p0[k], v) for k, v in s["params"].items())
    finally:
        shutdown()


@pytest.mark.parametrize("kw,exc,match", [
    # ZeRO under overlap is ported: it validates its optimizer as the
    # JAX package does (a per-leaf one is refused)
    (dict(zero_dp=True), ValueError, "packed-stream optimizer"),
    # the hierarchical schedule is ported: it needs a DP layout of two
    # stages, and the default dp_axes ("data",) has one
    (dict(hier_split=1), ValueError, "hier_split must be in")],
    ids=["zero", "hierarchical"])
def test_overlap_with_zero_or_hierarchical_sync_raises(kw, exc, match):
    from repro_torch.configs import ParallelConfig, TrainConfig
    from repro_torch.models.resnet import ResNet50
    from repro_torch.training.step import make_dp_shardmap_train_step
    cfg = TrainConfig(optimizer=TOpt(), parallel=ParallelConfig(
        compression="bf16+bucketed", overlap_comm=True, **kw))
    model = ResNet50(treduced(tget("resnet50")), device="cpu")
    with pytest.raises(exc, match=match):
        make_dp_shardmap_train_step(model, None, cfg,
                                    mesh_shape={"data": 2})


def test_overlap_needs_the_data_parallel_step():
    with pytest.raises(ValueError, match="dp_mode='shardmap'"):
        tlaunch.build_train_setup(
            treduced(tget("resnet50")), global_batch=BATCH, seq_len=0,
            opt_cfg=TOpt(), steps_per_epoch=SPE, overlap_comm=True,
            device="cpu")


def test_cli_runs_sync_bn_with_overlap_on_cpu(capsys):
    res = tlaunch.main([
        "--reduced", "--dp-mode", "shardmap", "--compression",
        "bf16+bucketed", "--sync-bn", "--overlap-comm", "--fused-bn",
        "--error-feedback", "--bucket-mib", "1", "--epochs", "1",
        "--steps-per-epoch", "2", "--global-batch", "8", "--val-batches",
        "1", "--device", "cpu"])
    assert len(res.history) == 2 and len(res.epoch_history) == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert "dp_mode=shardmap, 1 worker(s)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
