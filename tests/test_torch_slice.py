"""The port's single-device training slice against the JAX package:
``build_train_setup`` -> ``train_step`` from the same parameters (moved
over with ``repro_torch.interop``) on the same synthetic batches, with
the paper's recipe (rmsprop_warmup + slow_start), fused BN, f32.

Tolerances. The losses agree to rtol 2e-5. Parameters are compared by
the relative norm of their difference (2e-4), never elementwise: in the
first RMSprop warm-up steps coef*g is about 10*a_rms*sign(g), so an
element whose tiny gradient flips sign with the reduction order moves by
about 3e-3 on one side and not the other.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt, TrainConfig as JTrain
from repro.configs import ParallelConfig as JPar
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.launch.train import build_eval_setup as jeval_setup
from repro.launch.train import build_train_setup as jsetup
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.training import Trainer as JTrainer, TrainerConfig as JTCfg
from repro.training.step import make_train_step as jmake_step
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt, TrainConfig as TTrain
from repro_torch.configs import ParallelConfig as TPar
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model as tbuild
from repro_torch.optim import make_optimizer as tmake_opt
from repro_torch.training import Trainer as TTrainer, TrainerConfig as TTCfg
from repro_torch.training.step import make_train_step as tmake_step

ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH, SPE = 8, 4


def _cfgs():
    return jreduced(jget("resnet50")), treduced(tget("resnet50"))


def _load(tparams, jparams):
    """Overwrite the port's parameters (in place) with the JAX ones."""
    src = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    with torch.no_grad():
        for k, v in tparams.items():
            v.copy_(src[k])


def _rel_norm(jparams, tparams) -> float:
    jp = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    num = sum(float((jp[k] - tparams[k]).square().sum()) for k in jp)
    den = sum(float(jp[k].square().sum()) for k in jp)
    return (num / den) ** 0.5


@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_three_steps_and_eval_match(compression):
    jc, tc = _cfgs()
    kw = dict(global_batch=BATCH, seq_len=0, steps_per_epoch=SPE,
              fused_bn=True, compression=compression)
    jm, js, jstep, jdata, _, _ = jsetup(jc, opt_cfg=JOpt(), **kw)
    tm, ts, tstep, tdata, _, _ = tlaunch.build_train_setup(
        tc, opt_cfg=TOpt(), device="cpu", **kw)
    _load(ts["params"], js["params"])
    p0 = {k: v.clone() for k, v in ts["params"].items()}
    for i in range(3):
        js, jmet = jstep(js, jdata.batch_at(i))
        ts, tmet = tstep(ts, tdata.batch_at(i))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
        for k in ("lr", "epoch"):
            assert np.float32(tmet[k]) == np.float32(jmet[k]), k
        # exp differs between XLA and PyTorch in the last bit
        np.testing.assert_allclose(tmet["alpha_sgd"],
                                   float(jmet["alpha_sgd"]), rtol=2.4e-7)
        assert _rel_norm(js["params"], ts["params"]) < 2e-4
    assert ts["opt"]["step"] == 3
    # the optimizer updated the model's own parameters in place
    assert all(torch.equal(v, ts["params"][k])
               for k, v in tm.params().items())
    assert any(not torch.equal(p0[k], v) for k, v in ts["params"].items())
    for site, rec in ts["model_state"].items():
        np.testing.assert_allclose(
            rec["var"].numpy(), np.asarray(js["model_state"][site]["var"]),
            rtol=1e-3, atol=1e-5, err_msg=site)
    jev, jvd, _ = jeval_setup(jm, jc, global_batch=BATCH, seq_len=0)
    tev, tvd, _ = tlaunch.build_eval_setup(tm, tc, global_batch=BATCH,
                                           seq_len=0)
    jr = jev(js["params"], js["model_state"], jvd.batch_at(0))
    tr = tev(ts["params"], ts["model_state"], tvd.batch_at(0))
    assert float(tr["top1"]) == float(jr["top1"])
    np.testing.assert_allclose(float(tr["loss"]), float(jr["loss"]),
                               rtol=1e-4)


def test_microbatched_step_matches():
    """Two microbatches: gradients are the mean of the microbatch
    gradients and the BN state threads through, as in the JAX step."""
    jc, tc = _cfgs()
    jmodel = jbuild(jc, compute_dtype=jnp.float32)
    tmodel = tbuild(tc, compute_dtype=torch.float32, device="cpu")
    jopt = jmake_opt(JOpt(kind="momentum_sgd"), SPE, BATCH)
    topt = tmake_opt(TOpt(kind="momentum_sgd"), SPE, BATCH)
    jstep = jax.jit(jmake_step(jmodel, jopt, JTrain(
        parallel=JPar(compression="bf16")), microbatches=2))
    tstep = tmake_step(tmodel, topt, TTrain(
        parallel=TPar(compression="bf16")), microbatches=2)
    jp, _ = jmodel.init_params(jax.random.PRNGKey(1))
    js = {"params": jp, "opt": jopt.init(jp),
          "model_state": jmodel.init_state()}
    tparams = {k: v.detach() for k, v in tmodel.named_parameters()}
    _load(tparams, jp)
    ts = {"params": tparams, "opt": topt.init(tparams),
          "model_state": tmodel.init_state()}
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {"images": rng.standard_normal((BATCH, 32, 32, 3)).astype(
            np.float32), "labels": rng.integers(0, 10, BATCH).astype(
                np.int32)}
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tmet["accuracy"]),
                                   float(jmet["accuracy"]))
    assert _rel_norm(js["params"], ts["params"]) < 2e-5


def test_trainer_epochs_match():
    """Two epochs of two steps with held-out eval after each: the same
    loss history, top-1 and best epoch as the JAX Trainer."""
    jc, tc = _cfgs()
    kw = dict(global_batch=BATCH, seq_len=0, steps_per_epoch=2)
    jm, js, jstep, jdata, jput, _ = jsetup(jc, opt_cfg=JOpt(), **kw)
    tm, ts, tstep, tdata, _, _ = tlaunch.build_train_setup(
        tc, opt_cfg=TOpt(), device="cpu", **kw)
    _load(ts["params"], js["params"])
    jev, jvd, jfin = jeval_setup(jm, jc, global_batch=BATCH, seq_len=0)
    tev, tvd, tfin = tlaunch.build_eval_setup(tm, tc, global_batch=BATCH,
                                              seq_len=0)
    jres = JTrainer(jstep, js, jdata, JTCfg(
        epochs=2, steps_per_epoch=2, val_batches=2, log_every=1,
        checkpoint_every=0), eval_step=jev, val_data=jvd,
        finalize_state=jfin, put_batch=jput).run()
    tres = TTrainer(tstep, ts, tdata, TTCfg(
        epochs=2, steps_per_epoch=2, val_batches=2, log_every=1),
        eval_step=tev, val_data=tvd, finalize_state=tfin).run()
    np.testing.assert_allclose([h["loss"] for h in tres.history],
                               [h["loss"] for h in jres.history], rtol=2e-5)
    assert [(r["epoch"], r["step"], r["top1"]) for r in tres.epoch_history] \
        == [(r["epoch"], r["step"], r["top1"]) for r in jres.epoch_history]
    np.testing.assert_allclose([r["loss"] for r in tres.epoch_history],
                               [r["loss"] for r in jres.epoch_history],
                               rtol=1e-4)
    assert tres.best == jres.best
    assert all(0 <= h["data_wait"] <= h["time"] for h in tres.history)


def test_cli_runs_on_cpu(capsys):
    res = tlaunch.main(["--reduced", "--epochs", "1", "--steps-per-epoch",
                        "2", "--global-batch", "4", "--val-batches", "1",
                        "--fused-bn", "--compute-dtype", "bfloat16",
                        "--device", "cpu"])
    assert len(res.history) == 2 and len(res.epoch_history) == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert "val top1" in capsys.readouterr().out


def test_unported_options_raise():
    _, tc = _cfgs()
    kw = dict(global_batch=BATCH, seq_len=0, opt_cfg=TOpt(),
              steps_per_epoch=SPE, device="cpu")
    # error feedback corrects worker-local gradients: the DP step only,
    # as in the JAX package
    with pytest.raises(ValueError, match="error_feedback is only "
                                         "implemented"):
        tlaunch.build_train_setup(tc, error_feedback=True, **kw)
    # bucketed sync needs the data-parallel step, as in the JAX package
    with pytest.raises(ValueError, match="dp_mode='shardmap'"):
        tlaunch.build_train_setup(tc, compression="bf16+bucketed", **kw)
    # LARS is ported: on one device it is the per-leaf optimizer
    _, st, *_ = tlaunch.build_train_setup(
        tc, **{**kw, "opt_cfg": TOpt(kind="lars")})
    assert set(st["opt"]) == {"step", "delta"}
    assert st["opt"]["delta"].keys() == st["params"].keys()
    # checkpointing and the resilience machinery are ported: the
    # Trainer takes them
    _, state, step, data, _, _ = tlaunch.build_train_setup(tc, **kw)
    TTrainer(step, state, data, TTCfg(checkpoint_dir="ck"),
             resilience=object(), chaos=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.build_train_setup(tc, **{**kw, "device": "cuda"})


def test_import_boundary():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package: checked in a fresh interpreter and in the sources."""
    pkg = os.path.join(ROOT, "src", "repro_torch")
    mods = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    body = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len({mods!r}))
    """)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip()) == len(mods) >= 20
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        for bad in ("import jax", "from jax", "from repro.", "import repro\n",
                    "from repro import"):
            assert bad not in text, (path, bad)
