"""The paper's recipe harnesses on the port and the launcher's flags,
against the JAX package, on the CPU:

1. ``--host-shard H/N``: the data of ``build_train_setup`` with host
   shard 1/4 is bitwise the JAX package's ``make_data(num_hosts=4,
   host_id=1)``, rows [B/4, B/2) of the full batch (the LM token
   stream, and the conv family's images), on one device and on the
   data-parallel path at one worker. For the conv family the flag turns
   on the host augmentation, as in the JAX launcher; the augmented
   shard is bitwise those rows of the port's own augmented full batch
   (its augmentation table is the port's numpy Philox draw, not JAX's
   threefry one). The CLI takes the flag and refuses a malformed one.
2. ``--log-json``: the JSON's keys and JSON types equal those the JAX
   launcher writes for the same run, on the step-driven branch
   (history, wall, resumed_from) and the epoch-driven one (also
   epoch_history, best, events), for the reduced llama3.2-1b.
3. ``examples/torch_quickstart.py`` at 2 epochs x 3 steps from the JAX
   package's initial weights against the JAX ``Trainer`` with the
   quickstart's settings: train losses within rtol 2e-5 (the ResNet
   tolerance of ``test_torch_slice.py``; observed 1.5e-5 at step 5),
   validation losses within rtol 1e-3, the same top-1 and best epoch.
   The validation loss is taken after the last update of each epoch,
   while the loss falls from 2.65 to 0.83 in 6 steps: the two sides'
   drift (elements whose tiny gradient flips sign in the RMSprop
   warm-up, ``test_torch_slice.py``) grows with it, observed 4.9e-5
   after 3 steps and 5.1e-4 after 6.
4. ``examples/torch_large_batch_sweep.py``: ``train_once`` of each of
   the 3 recipes at batch 32 x 3 steps from JAX's initial weights
   against the JAX script's ``train_once`` (loaded by path): losses
   within rtol 2e-5; and a quick sweep's JSON passes the checks that
   ``tests/test_bench_schema.py`` applies to ``BENCH_scaling.json``.
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.data import synthetic as jsyn
from repro.launch.train import build_eval_setup as jeval_setup
from repro.launch.train import build_train_setup as jsetup
from repro.models import build_model as jbuild
from repro.training import Trainer as JTrainer, TrainerConfig as JTCfg
from repro_torch import interop
from repro_torch.configs import InputConfig as TInput
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.data import synthetic as tsyn
from repro_torch.data.pipeline import AugmentedSource as TAugmented
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, *name.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_resnet_params():
    """The reduced ResNet-50's initial weights as the JAX package's
    build_train_setup draws them (seed 0), in the port's layout."""
    params, _ = jbuild(jreduced(jget("resnet50")),
                       compute_dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0))
    return interop.params_from_jax(jax.tree.map(np.asarray, params), "cpu")


# -------------------------------------------------------------- host shard


@pytest.mark.parametrize("arch", ["llama3.2-1b", "resnet50"])
@pytest.mark.parametrize("dp_mode", ["none", "shardmap"])
def test_host_shard_reads_jax_rows(arch, dp_mode, tmp_path):
    b, seq = 16, 8
    cj, ct = jreduced(jget(arch)), treduced(tget(arch))
    full = jsyn.make_data(cj, JShape("t", seq, b, "train"), seed=0)
    want = jsyn.make_data(cj, JShape("t", seq, b, "train"), seed=0,
                          num_hosts=4, host_id=1)
    if dp_mode == "shardmap":
        init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1)
    try:
        _, _, _, data, _, _ = tlaunch.build_train_setup(
            ct, global_batch=b, seq_len=seq, opt_cfg=TOpt(),
            steps_per_epoch=4, dp_mode=dp_mode, device="cpu",
            input_cfg=TInput(num_hosts=4, host_id=1))
    finally:
        shutdown()
    raw = data
    if arch == "resnet50":  # the flag turns on the host augmentation
        assert isinstance(data, TAugmented) and data.train
        raw = data.source
        aug_full = TAugmented(tsyn.make_data(ct, TShape("t", seq, b,
                                                        "train")),
                              seed=0, mean=TInput().mean, std=TInput().std,
                              global_batch=b)
    for step in (0, 3):
        got, w, f = raw.batch_at(step), want.batch_at(step), \
            full.batch_at(step)
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
            np.testing.assert_array_equal(got[k], f[k][b // 4:b // 2])
        if arch == "resnet50":
            for k, v in data.batch_at(step).items():
                np.testing.assert_array_equal(
                    v, aug_full.batch_at(step)[k][b // 4:b // 2])


def test_host_shard_cli():
    res = tlaunch.main(["--arch", "llama3.2-1b", "--reduced", "--seq-len",
                        "16", "--global-batch", "8", "--steps", "2",
                        "--host-shard", "1/4", "--device", "cpu"])
    assert len(res.history) == 2
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--host-shard", "one", "--device", "cpu"])


# ---------------------------------------------------------------- log-json


def _schema(obj):
    """Keys and JSON types, recursively (a list by its first entry)."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_schema(obj[0])] if obj else []
    return type(obj).__name__


@pytest.mark.parametrize("branch", ["steps", "epochs"])
def test_log_json_keys_and_types_equal_jax(branch, tmp_path, monkeypatch):
    from repro.launch import train as jlaunch
    args = ["--arch", "llama3.2-1b", "--reduced", "--seq-len", "16",
            "--global-batch", "4"]
    args += (["--steps", "2"] if branch == "steps" else
             ["--epochs", "2", "--steps-per-epoch", "2", "--val-batches",
              "1"])
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv",
                        ["train"] + args + ["--log-json", str(jpath)])
    jlaunch.main()
    tlaunch.main(args + ["--log-json", str(tpath), "--device", "cpu"])
    want, got = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    assert _schema(got) == _schema(want)
    assert len(got["history"]) == len(want["history"])
    np.testing.assert_allclose([h["loss"] for h in got["history"]][:1],
                               [h["loss"] for h in want["history"]][:1],
                               rtol=0.2)  # other weights, same task
    if branch == "epochs":
        assert set(want) == {"history", "epoch_history", "best", "wall",
                             "resumed_from", "events"}
        assert got["best"] is None  # an LM has no top-1


# ---------------------------------------------------------------- harnesses


def test_quickstart_matches_jax_trainer(tmp_path, jax_resnet_params):
    epochs, spe = 2, 3
    cfg = jreduced(jget("resnet50"))
    opt = JOpt(kind="rmsprop_warmup", schedule="slow_start",
               beta_center=2.0, beta_period=1.0)
    jm, js, jstep, jdata, jput, _ = jsetup(
        cfg, global_batch=64, seq_len=16, opt_cfg=opt, steps_per_epoch=spe)
    jev, jval, jfin = jeval_setup(jm, cfg, global_batch=64, seq_len=16)
    want = JTrainer(jstep, js, jdata, JTCfg(
        epochs=epochs, steps_per_epoch=spe, eval_every_epochs=1,
        val_batches=2, checkpoint_every=30,
        checkpoint_dir=str(tmp_path / "jax"), log_every=10),
        eval_step=jev, val_data=jval, finalize_state=jfin,
        put_batch=jput).run()
    got, ckpt = _load_script("examples/torch_quickstart.py").run(
        epochs, spe, device="cpu", ckpt_dir=str(tmp_path / "port"),
        init_params=jax_resnet_params)
    assert [h["step"] for h in got.history] == \
        [h["step"] for h in want.history]
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history], rtol=2e-5)
    assert len(got.epoch_history) == len(want.epoch_history) == epochs
    for g, w in zip(got.epoch_history, want.epoch_history):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-3)
        assert g["top1"] == w["top1"]
    assert got.best["epoch"] == want.best["epoch"]
    assert os.path.isdir(os.path.join(ckpt, "best"))


@pytest.mark.parametrize("recipe", ["paper_baseline", "lars",
                                    "lars_ls_poly"])
def test_sweep_train_once_matches_jax_script(recipe, jax_resnet_params):
    jsweep = _load_script("examples/large_batch_sweep.py")
    tsweep = _load_script("examples/torch_large_batch_sweep.py")
    assert tsweep.RECIPES == jsweep.RECIPES
    assert tsweep.POINTS_FULL == jsweep.POINTS_FULL
    assert tsweep.POINTS_QUICK == jsweep.POINTS_QUICK
    kind, schedule, ls = tsweep.RECIPES[recipe]
    args = (kind, schedule, ls, 32, 2.0, 3, 10)
    jl, ja = jsweep.train_once(*args)
    tl, ta = tsweep.train_once(*args, device="cpu",
                               init_params=jax_resnet_params)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    np.testing.assert_allclose(ta, ja, atol=1 / 32 + 1e-6)
    assert tsweep._tail(tl, tl) == pytest.approx(jsweep._tail(jl, jl),
                                                 rel=2e-5)


def test_sweep_json_passes_the_bench_schema_checks(tmp_path, monkeypatch):
    tsweep = _load_script("examples/torch_large_batch_sweep.py")
    assert tsweep.DEFAULT_OUT == os.path.join("results",
                                              "BENCH_scaling_torch.json")
    out = tmp_path / "BENCH_scaling_torch.json"
    bench = os.path.join(ROOT, "BENCH_scaling.json")
    with open(bench, "rb") as f:
        before = f.read()
    tsweep.main(["--quick", "--steps", "2", "--device", "cpu", "--out",
                 str(out)])
    data = json.loads(out.read_text())
    assert data["backend"] == "cpu" and data["devices"] == 1
    schema = _load_script("tests/test_bench_schema.py")
    monkeypatch.setattr(schema, "_load_scaling", lambda: data)
    schema.test_bench_scaling_json_schema()
    schema.test_bench_scaling_json_points_and_divergence_contract()
    schema.test_bench_scaling_covers_lars_and_baseline()
    with open(bench, "rb") as f:
        assert f.read() == before
