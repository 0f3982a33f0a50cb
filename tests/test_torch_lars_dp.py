"""The port's stream-LARS data-parallel step (``make_dp_shardmap_train_step``
with the packed-stream LARS optimizer, over ``torch.distributed``, gloo on
the CPU) against the JAX package's shard_map step, with and without
error feedback, and error feedback on the per-leaf and bucketed paths.

The recipe is ``lars_ls_poly`` of the JAX package's
``examples/large_batch_sweep.py``: LARS, the poly schedule with one
warm-up epoch, label smoothing 0.1.

Tolerances, those of ``test_torch_dp.py``: losses rtol 2e-5,
``grad_norm`` rtol 1e-4, the parameters and the flat ``delta`` within a
relative norm of 2e-4 (the segment norms are summed in another order, and
a gradient of the size of a rounding error may change sign). The
error-feedback residual is the wire rounding error of gradients that
differ in their last bits, so where a rounding flips, an element moves
by one bf16 ulp of its gradient: after three steps the residuals lie
about 5e-2 apart in relative norm, while their norms agree to 4e-5.
They are held by their norms, rtol 1e-3. At one
worker the per-leaf and bucketed error-feedback paths are bitwise equal,
and so are the tree LARS of the per-leaf path and the stream LARS of the
bucketed path.
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
from repro.launch.train import build_train_setup as jsetup
from repro_torch import interop
from repro_torch.configs import InputConfig as TInput, OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch

ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH, SPE, STEPS = 8, 4, 3
LARS = dict(kind="lars", schedule="poly", warmup_epochs=1.0,
            total_epochs=max(1.0, STEPS / SPE))
SMOOTH = 0.1


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


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(x)).double() for x in (a, b))
    return float((a - b).norm() / b.norm())


def _norm(tree) -> float:
    return sum(float(torch.as_tensor(v).double().square().sum())
               for v in tree.values()) ** 0.5


def _rel_norm(a, b) -> float:
    num = sum(float((torch.as_tensor(a[k]).double()
                     - torch.as_tensor(b[k]).double()).square().sum())
              for k in b)
    den = sum(float(torch.as_tensor(b[k]).double().square().sum())
              for k in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("ef", [False, True])
def test_one_worker_stream_lars_matches_jax_shardmap(one_worker, ef):
    jc, tc = jreduced(jget("resnet50")), treduced(tget("resnet50"))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    kw = dict(global_batch=BATCH, seq_len=0, steps_per_epoch=SPE,
              dp_mode="shardmap", fused_bn=True, use_fused_kernel=True,
              compression="bf16+bucketed", error_feedback=ef,
              label_smoothing=SMOOTH)
    _, js, jstep, jdata, jput, _ = jsetup(
        jc, opt_cfg=JOpt(**LARS), mesh=mesh,
        input_cfg=JInput(fused=True, augment=False), **kw)
    _, ts, tstep, tdata, tput, _ = tlaunch.build_train_setup(
        tc, opt_cfg=TOpt(**LARS), input_cfg=TInput(fused=True, augment=False),
        device="cpu", **kw)
    assert set(ts["opt"]) == {"step", "delta"}
    assert ts["opt"]["delta"].shape == js["opt"]["delta"].shape
    assert ("ef_residual" in ts) == ef
    _load(ts["params"], interop.params_from_jax(
        jax.tree.map(np.asarray, js["params"]), device="cpu"))
    for i in range(STEPS):
        js, jmet = jstep(js, jput(jdata.batch_at(i)))
        ts, tmet = tstep(ts, tput(tdata.batch_at(i)))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        assert tmet["lr"] == float(jmet["lr"])
        jp = interop.params_from_jax(jax.tree.map(np.asarray, js["params"]),
                                     device="cpu")
        assert _rel_norm(ts["params"], jp) < 2e-4
        jopt = interop.stream_opt_state_from_jax(
            jax.tree.map(np.asarray, js["opt"]), ts["params"], device="cpu")
        assert ts["opt"]["step"] == jopt["step"] == i + 1
        assert _rel(ts["opt"]["delta"], jopt["delta"]) < 2e-4
    if ef:
        jres = interop.ef_residual_from_jax(
            jax.tree.map(np.asarray, js["ef_residual"]), 0, device="cpu")
        np.testing.assert_allclose(_norm(ts["ef_residual"]), _norm(jres),
                                   rtol=1e-3)


@pytest.mark.parametrize("kind", ["rmsprop_warmup", "lars"])
def test_error_feedback_per_leaf_equals_bucketed_bitwise(one_worker, kind):
    """At one worker the per-leaf and the bucketed sync hand the update
    the same gradients and keep the same residuals. With LARS the
    per-leaf path runs the tree LARS and the bucketed one the stream
    LARS, and those are bitwise equal too."""
    cfg = treduced(tget("resnet50"))
    opt = TOpt(**LARS) if kind == "lars" else TOpt()
    kw = dict(global_batch=BATCH, seq_len=0, opt_cfg=opt, steps_per_epoch=SPE,
              dp_mode="shardmap", fused_bn=True, use_fused_kernel=True,
              error_feedback=True, device="cpu")
    _, s1, step1, d1, put1, _ = tlaunch.build_train_setup(
        cfg, compression="bf16", **kw)
    _, s2, step2, d2, put2, _ = tlaunch.build_train_setup(
        cfg, compression="bf16+bucketed", **kw)
    for i in range(3):
        s1, m1 = step1(s1, put1(d1.batch_at(i)))
        s2, m2 = step2(s2, put2(d2.batch_at(i)))
        assert float(m1["loss"]) == float(m2["loss"])
    offsets, off = {}, 0
    for k in sorted(s1["params"], key=lambda k: tuple(k.split("/"))):
        offsets[k] = off
        off += s1["params"][k].numel()
    for k, v in s1["params"].items():
        assert torch.equal(v, s2["params"][k]), k
        assert torch.equal(s1["ef_residual"][k], s2["ef_residual"][k]), k
        assert s1["ef_residual"][k].any(), k
        d2 = (s2["opt"]["delta"][offsets[k]:offsets[k] + v.numel()]
              .view(v.shape) if kind == "lars" else s2["opt"]["delta"][k])
        assert torch.equal(s1["opt"]["delta"][k], d2), k


# ---------------------------------------------------------------------------
# two workers
# ---------------------------------------------------------------------------

TWO_BATCH = 16  # 8 samples per worker, as test_torch_dp.py
EFS = (False, True)

_JAX_TWO_DEVICES = """
    import jax, numpy as np
    from repro.configs import OptimizerConfig, get_config, reduced_config
    from repro.launch.train import build_train_setup
    from repro_torch import interop
    cfg = reduced_config(get_config("resnet50"))
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    for ef in {efs!r}:
        _, s, step, data, put, _ = build_train_setup(
            cfg, global_batch={batch}, seq_len=0,
            opt_cfg=OptimizerConfig(**{lars!r}), steps_per_epoch={spe},
            mesh=mesh, dp_mode="shardmap", compression="bf16+bucketed",
            error_feedback=ef, label_smoothing={smooth})
        out = {{"p0/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}}
        for i in range({steps}):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{{i}}"] = np.float32(met["loss"])
            out[f"gn{{i}}"] = np.float32(met["grad_norm"])
        params = interop.params_from_jax(jax.tree.map(np.asarray,
                                                      s["params"]),
                                         device="cpu")
        out.update({{"p/" + k: v.numpy() for k, v in params.items()}})
        out["delta"] = interop.stream_opt_state_from_jax(
            jax.tree.map(np.asarray, s["opt"]), params,
            device="cpu")["delta"].numpy()
        if ef:
            for r in range(2):
                res = interop.ef_residual_from_jax(
                    jax.tree.map(np.asarray, s["ef_residual"]), r,
                    device="cpu")
                out.update({{f"r{{r}}/" + k: v.numpy()
                             for k, v in res.items()}})
        np.savez(f"{out}/jax_{{int(ef)}}.npz", **out)
"""


def _port_worker(rank, out_dir, ef):
    init_workers("cpu", init_method=f"file://{out_dir}/store_{int(ef)}",
                 rank=rank, world_size=2)
    try:
        ref = np.load(os.path.join(out_dir, f"jax_{int(ef)}.npz"))
        cfg = treduced(tget("resnet50"))
        _, s, step, data, put, _ = tlaunch.build_train_setup(
            cfg, global_batch=TWO_BATCH, seq_len=0, opt_cfg=TOpt(**LARS),
            steps_per_epoch=SPE, dp_mode="shardmap",
            compression="bf16+bucketed", error_feedback=ef,
            use_fused_kernel=True, label_smoothing=SMOOTH, device="cpu")
        _load(s["params"], {k[3:]: ref[k] for k in ref.files
                            if k.startswith("p0/")})
        out = {}
        for i in range(STEPS):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{i}"] = float(met["loss"])
            out[f"gn{i}"] = float(met["grad_norm"])
        out.update({"p/" + k: v.numpy() for k, v in s["params"].items()})
        out["delta"] = s["opt"]["delta"].numpy()
        if ef:
            out.update({"r/" + k: v.numpy()
                        for k, v in s["ef_residual"].items()})
        np.savez(os.path.join(out_dir, f"port_{rank}_{int(ef)}.npz"), **out)
    finally:
        shutdown()


def _sub(npz, prefix):
    return {k[len(prefix):]: npz[k] for k in npz.files if k.startswith(prefix)}


@pytest.mark.slow
def test_two_workers_stream_lars_match_jax_on_two_devices(tmp_path):
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    body = textwrap.dedent(_JAX_TWO_DEVICES.format(
        efs=EFS, batch=TWO_BATCH, lars=LARS, spe=SPE, smooth=SMOOTH,
        steps=STEPS, out=tmp_path))
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    for ef in EFS:
        mp.spawn(_port_worker, args=(str(tmp_path), ef), nprocs=2)
        ref = np.load(tmp_path / f"jax_{int(ef)}.npz")
        ranks = [np.load(tmp_path / f"port_{r}_{int(ef)}.npz") for r in (0, 1)]
        for i in range(STEPS):
            for got in ranks:
                np.testing.assert_allclose(got[f"loss{i}"], ref[f"loss{i}"],
                                           rtol=2e-5)
                np.testing.assert_allclose(got[f"gn{i}"], ref[f"gn{i}"],
                                           rtol=1e-4)
        p = _sub(ranks[0], "p/")
        for k, v in p.items():  # every worker applies the same update
            np.testing.assert_array_equal(v, ranks[1]["p/" + k])
        np.testing.assert_array_equal(ranks[0]["delta"], ranks[1]["delta"])
        assert _rel_norm(p, _sub(ref, "p/")) < 2e-4
        assert _rel(ranks[0]["delta"], ref["delta"]) < 2e-4
        if ef:  # each worker keeps its own residual
            for r, got in enumerate(ranks):
                np.testing.assert_allclose(_norm(_sub(got, "r/")),
                                           _norm(_sub(ref, f"r{r}/")),
                                           rtol=1e-3)


def test_cli_runs_the_lars_dp_path_on_cpu(capsys):
    res = tlaunch.main([
        "--reduced", "--optimizer", "lars", "--schedule", "poly",
        "--label-smoothing", "0.1", "--dp-mode", "shardmap",
        "--compression", "bf16+bucketed", "--use-fused-kernel",
        "--error-feedback", "--fused-bn", "--epochs", "1",
        "--steps-per-epoch", "2", "--global-batch", "8", "--val-batches",
        "1", "--device", "cpu"])
    assert len(res.history) == 2 and len(res.epoch_history) == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert set(res.state["opt"]) == {"step", "delta"}
    assert res.state["ef_residual"]["fc/w"].any()
    assert "dp_mode=shardmap, 1 worker(s)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
