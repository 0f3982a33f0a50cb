"""The port's fault-tolerance layer (``repro_torch.resilience`` and the
``Trainer``'s checkpoint, resume and recovery paths) against the JAX
package's, on the reduced ResNet in f32 on the CPU.

- Chaos: the same spec grammar (the same triggers for valid specs, a
  ``ValueError`` for the same malformed ones), and one spec and seed
  poison the same batch element and flip the same checkpoint byte in
  both packages.
- ``RecoveryManager``: the same ``Action`` sequence and events as the JAX
  package's for one scripted metric sequence.
- The sentinel: off and on bitwise equal over good steps; a NaN batch or
  a spike leaves the state bitwise unchanged, ``opt.step`` included (on
  the single-device step and on the DP step with error feedback); LR
  backoff damps the parameter step.
- The ``Trainer``, after the JAX package's ``test_resilience.py`` and
  ``test_training_loop.py``: skip, rollback, rollback past a corrupt
  newest checkpoint, abort after the budget, rollback without a
  checkpoint directory raises, a data crash recovers, a prefetcher crash
  propagates without resilience, misalignment raises, the event log on
  disk, straggler events, no duplicate final save; and one chaos spec
  gives the same events from the JAX ``Trainer`` and the port's.
"""
import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.launch.train import build_train_setup as jsetup
from repro.resilience import EventLog as JEventLog
from repro.resilience import RecoveryManager as JRecoveryManager
from repro.resilience import ResilienceConfig as JResilienceConfig
from repro.resilience import parse_chaos as jparse_chaos
from repro.training import Trainer as JTrainer, TrainerConfig as JTCfg
from repro_torch import interop
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch import train as tlaunch
from repro_torch.resilience import (
    Action,
    ChaosError,
    EventLog,
    RecoveryManager,
    ResilienceConfig,
    parse_chaos,
    sentinel_controls,
)
from repro_torch.training import LoopConfig, Trainer, TrainerConfig
from repro_torch.training import loop as loop_mod
from repro_torch.training import run_training

BATCH, SPE = 8, 4
SGD = dict(kind="momentum_sgd", schedule="constant")


# ---------------------------------------------------------------------------
# chaos, events, recovery: the same behaviour as the JAX package's
# ---------------------------------------------------------------------------

VALID = ["nan_grad@3,data_stall@5-7:0.25,seed=9,straggler@2",
         "ckpt_truncate@6, ckpt_bitflip@8 ,", "data_crash@0", ""]
MALFORMED = ["bogus@3", "nan_grad", "nan_grad@7-3", "nan_grad@x",
             "straggler@2:abc"]


@pytest.mark.parametrize("spec", VALID + MALFORMED)
def test_chaos_grammar_matches_jax(spec):
    try:
        want = jparse_chaos(spec, seed=4)
    except ValueError:
        with pytest.raises(ValueError):
            parse_chaos(spec, seed=4)
        return
    got = parse_chaos(spec, seed=4)
    assert got.seed == want.seed
    assert [(t.kind, t.step, t.arg) for t in got.triggers] == \
        [(t.kind, t.step, t.arg) for t in want.triggers]


@pytest.mark.parametrize("seed", [0, 5, 1234])
def test_chaos_poisons_and_flips_what_jax_does(tmp_path, seed):
    rng = np.random.default_rng(seed)
    batch = {"images": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
             "labels": np.zeros((4,), np.int32)}
    spec = "nan_grad@2,ckpt_bitflip@1"
    ours, theirs = parse_chaos(spec, seed=seed), jparse_chaos(spec, seed=seed)
    a, b = ours.inject_batch(2, dict(batch)), theirs.inject_batch(2,
                                                                  dict(batch))
    assert np.array_equal(np.isnan(a["images"]), np.isnan(b["images"]))
    assert np.isnan(a["images"]).sum() == 1
    assert not np.isnan(batch["images"]).any()  # the source is untouched
    # one-shot: a replay of the same step is clean
    assert not np.isnan(ours.inject_batch(2, dict(batch))["images"]).any()
    for name, eng in (("port", ours), ("jax", theirs)):
        ck.save(str(tmp_path / name), 1, {"w": batch["images"]})
        eng.after_save(str(tmp_path / name), 1)
    payloads = [tmp_path / n / "step_0000000001" / ck.ARRAYS
                for n in ("port", "jax")]
    assert os.path.getsize(payloads[0]) == os.path.getsize(payloads[1])
    assert ours.injected[-1]["flipped_byte"] == \
        theirs.injected[-1]["flipped_byte"]


def test_chaos_data_crash_raises_once():
    class Source:
        def batch_at(self, step):
            return {"images": np.full((2, 2), float(step), np.float32)}

    src = parse_chaos("data_crash@2").wrap_source(Source())
    src.batch_at(1)
    with pytest.raises(ChaosError):
        src.batch_at(2)
    src.batch_at(2)  # one-shot: the retry succeeds


def test_event_log_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with EventLog(path) as log:
        log.emit("rollback", to_step=4, wasted=np.int64(3),
                 loss=torch.tensor(1.5))
        log.emit("abort", step=9)
    lines = [json.loads(x) for x in open(path)]
    assert [r["kind"] for r in lines] == ["rollback", "abort"]
    assert lines[0]["wasted"] == 3 and lines[0]["loss"] == 1.5
    assert log.of_kind("abort")[0]["step"] == 9
    assert [r["seq"] for r in lines] == [0, 1]


def _script():
    """A metric sequence through warm-up, a spike, a bad streak, a
    rollback and a second streak (numpy seed 0 for the norms)."""
    norms = np.random.default_rng(0).uniform(1.0, 2.0, 12)
    seq = [("obs", s, {"bad_step": 0.0, "grad_norm": float(norms[s]),
                       "loss": 2.0}) for s in range(6)]
    seq += [("obs", 6, {"bad_step": 1.0, "grad_spike": 1.0,
                        "grad_norm": 50.0, "loss": 2.0}),
            ("obs", 7, {"bad_step": 1.0, "nonfinite_step": 1.0,
                        "grad_norm": float("nan"), "loss": float("nan")}),
            ("obs", 8, {"bad_step": 1.0, "nonfinite_step": 1.0}),
            ("rollback", 8, 4)]
    seq += [("obs", s, {"bad_step": 0.0, "grad_norm": float(norms[s])})
            for s in range(4, 7)]
    seq += [("obs", s, {"bad_step": 1.0}) for s in range(7, 10)]
    return seq


def test_recovery_manager_matches_jax():
    kw = dict(max_consecutive_bad=3, max_rollbacks=1, spike_factor=3.0,
              warmup_steps=3, ema_decay=0.5, lr_backoff=0.5,
              backoff_steps=4)
    ours = RecoveryManager(ResilienceConfig(**kw), EventLog())
    theirs = JRecoveryManager(JResilienceConfig(**kw), JEventLog())
    trace = []
    for what, a, b in _script():
        for mgr in (ours, theirs):
            if what == "rollback":
                mgr.on_rollback(from_step=a, to_step=b)
            else:
                act = mgr.observe(a, b)
                trace.append((mgr is ours, a, act.value,
                              mgr.spike_threshold(), mgr.lr_scale(a),
                              float(mgr.controls(a)["spike_threshold"]),
                              float(mgr.controls(a)["lr_scale"])))
    assert trace[0::2] == [(True,) + t[1:] for t in trace[1::2]]
    assert trace[-1][2] == Action.ABORT.value
    strip = [{k: v for k, v in r.items() if k != "time"}
             for r in ours.events.records]
    assert strip == [{k: v for k, v in r.items() if k != "time"}
                     for r in theirs.events.records]


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------


def _setup(sentinel: bool, **kw):
    return tlaunch.build_train_setup(
        treduced(tget("resnet50")), global_batch=BATCH, seq_len=0,
        opt_cfg=TOpt(**SGD), steps_per_epoch=SPE, seed=0, sentinel=sentinel,
        device="cpu", **kw)


@pytest.fixture(scope="module")
def sent():
    """The sentinel-wrapped single-device step and a copy of its initial
    state; ``fresh()`` hands every test its own copy."""
    _, state, step, data, _, _ = _setup(sentinel=True)
    return {"step": step, "state0": copy.deepcopy(state), "data": data,
            "fresh": lambda: copy.deepcopy(state)}


def _flat(state, shardings=None):
    return ck._flatten(interop.train_state_to_jax(state, shardings))


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), k


def test_sentinel_off_and_on_bitwise_on_good_steps(sent):
    _, plain, step, data, _, _ = _setup(sentinel=False)
    wrapped = sent["fresh"]()
    for s in range(3):
        batch = data.batch_at(s)
        plain, _ = step(plain, batch)
        wrapped, metrics = sent["step"](wrapped, batch, sentinel_controls())
        assert not metrics["bad_step"] and "grad_norm" in metrics
    _assert_bitwise(plain, wrapped)
    assert plain["opt"]["step"] == wrapped["opt"]["step"] == 3


def _nan_batch(data, step=0, pos=7):
    batch = dict(data.batch_at(step))
    images = np.array(batch["images"])
    images.reshape(-1)[pos] = np.nan
    batch["images"] = images
    return batch


@pytest.mark.parametrize("path", ["single", "dp_ef"])
def test_nan_batch_leaves_the_state_bitwise_unchanged(sent, tmp_path, path):
    if path == "single":
        step, data, state = sent["step"], sent["data"], sent["fresh"]()
        put = None
    else:  # BN state and EF residuals are per worker: kept too
        init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1)
        _, state, step, data, put, _ = _setup(
            sentinel=True, dp_mode="shardmap", compression="bf16+bucketed",
            error_feedback=True)
    try:
        good = data.batch_at(1)
        state, _ = step(state, put(good) if put else good,
                        sentinel_controls())
        before = copy.deepcopy(state)
        bad = _nan_batch(data, 2)
        state, metrics = step(state, put(bad) if put else bad,
                              sentinel_controls())
        assert metrics["bad_step"] and metrics["nonfinite_step"]
        assert state["opt"]["step"] == before["opt"]["step"] == 1
        _assert_bitwise(state, before)
    finally:
        if path == "dp_ef":
            shutdown()


def test_spike_gate_skips_but_flags_finite(sent):
    state, metrics = sent["step"](sent["fresh"](), sent["data"].batch_at(0),
                                  sentinel_controls(spike_threshold=1e-12))
    assert metrics["grad_spike"] and metrics["bad_step"]
    assert not metrics["nonfinite_step"]
    _assert_bitwise(state, sent["state0"])


def test_lr_backoff_damps_the_parameter_step(sent):
    batch = sent["data"].batch_at(0)
    full, _ = sent["step"](sent["fresh"](), batch, sentinel_controls())
    half, m = sent["step"](sent["fresh"](), batch,
                           sentinel_controls(lr_scale=0.5))
    assert not m["bad_step"] and half["opt"]["step"] == 1
    for k, p0 in sent["state0"]["params"].items():
        want = p0 + 0.5 * (full["params"][k] - p0)
        assert torch.equal(half["params"][k], want), k
    for k, d in full["opt"]["delta"].items():  # the optimizer advances
        assert torch.equal(half["opt"]["delta"][k], d), k


# ---------------------------------------------------------------------------
# the Trainer's recovery paths, after the JAX package's tests
# ---------------------------------------------------------------------------


def _run_trainer(sent, tmp_path, chaos_spec=None, resilience=None,
                 epochs=2, ckpt_every=2, **res_kw):
    tcfg = TrainerConfig(epochs=epochs, steps_per_epoch=SPE,
                         eval_every_epochs=0, val_batches=0,
                         checkpoint_every=ckpt_every,
                         checkpoint_dir=str(tmp_path) if ckpt_every
                         else None, log_every=1)
    if resilience is None:
        resilience = ResilienceConfig(**res_kw)
    chaos = parse_chaos(chaos_spec) if chaos_spec else None
    return Trainer(sent["step"], sent["fresh"](), sent["data"], tcfg,
                   resilience=resilience, chaos=chaos).run()


def test_trainer_skips_nan_step_and_completes(sent, tmp_path):
    res = _run_trainer(sent, tmp_path, chaos_spec="nan_grad@3")
    kinds = [r["kind"] for r in res.events]
    assert kinds.count("step_skipped") == 1 and "rollback" not in kinds
    skipped = [r for r in res.events if r["kind"] == "step_skipped"][0]
    assert skipped["step"] == 3 and skipped["nonfinite"]
    assert res.history[-1]["step"] == 7


def test_trainer_rollback_restores_last_good(sent, tmp_path):
    res = _run_trainer(sent, tmp_path, chaos_spec="nan_grad@4-6",
                       max_consecutive_bad=3)
    rb = [r for r in res.events if r["kind"] == "rollback"]
    assert len(rb) == 1
    # saves at 2 and 4; the bad streak 4-6 restores the step-4 save
    assert rb[0] == {**rb[0], "from_step": 6, "to_step": 4,
                     "wasted_steps": 2}
    assert res.history[-1]["step"] == 7
    assert np.isfinite(res.history[-1]["loss"])


def test_trainer_rollback_falls_back_past_corrupt_newest(sent, tmp_path):
    res = _run_trainer(sent, tmp_path, epochs=3,
                       chaos_spec="ckpt_truncate@7,nan_grad@8-9",
                       max_consecutive_bad=2)
    assert "corrupt_checkpoint_skipped" in [r["kind"] for r in res.events]
    rb = [r for r in res.events if r["kind"] == "rollback"][0]
    assert rb["to_step"] == 6  # the newest (8) was torn
    assert res.history[-1]["step"] == 11


def test_trainer_abort_after_rollback_budget(sent, tmp_path):
    with pytest.raises(RuntimeError, match="aborted"):
        _run_trainer(sent, tmp_path, chaos_spec="nan_grad@3-5",
                     max_consecutive_bad=3, max_rollbacks=0)


def test_trainer_rollback_without_ckpt_dir_raises(sent, tmp_path):
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        _run_trainer(sent, tmp_path, chaos_spec="nan_grad@2-4",
                     ckpt_every=0, max_consecutive_bad=3)


def test_trainer_data_crash_recovers_with_resilience(sent, tmp_path):
    res = _run_trainer(sent, tmp_path, chaos_spec="data_crash@5")
    restarts = [r for r in res.events if r["kind"] == "data_restart"]
    assert len(restarts) == 1 and restarts[0]["step"] == 5
    assert res.history[-1]["step"] == 7


def test_prefetcher_crash_propagates_without_resilience():
    _, state, step, data, _, _ = _setup(sentinel=False)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=8, eval_every_epochs=0,
                         val_batches=0, checkpoint_every=0, log_every=1)
    chaos = parse_chaos("data_crash@3")
    with pytest.raises(ChaosError):
        Trainer(step, state, chaos.wrap_source(data), tcfg).run()


def test_step_misalignment_raises_runtime_error(sent, monkeypatch):
    class Skewed:
        def __init__(self, source, start_step=0, **kw):
            self._step = start_step
            self.last_wait_s = 0.0

        def __next__(self):
            return self._step + 1, None  # off by one

        def close(self):
            pass

    monkeypatch.setattr(loop_mod, "DataPipeline", Skewed)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=4, eval_every_epochs=0,
                         val_batches=0, checkpoint_every=0, log_every=1)
    with pytest.raises(RuntimeError, match="misalignment"):
        Trainer(sent["step"], sent["fresh"](), sent["data"], tcfg,
                resilience=ResilienceConfig()).run()


def test_event_log_written_to_disk(sent, tmp_path):
    path = str(tmp_path / "events.jsonl")
    res = _run_trainer(sent, tmp_path / "ckpt", chaos_spec="nan_grad@3",
                       resilience=ResilienceConfig(event_log=path))
    lines = [json.loads(x) for x in open(path)]
    assert [r["kind"] for r in lines] == [r["kind"] for r in res.events]
    assert any(r["kind"] == "step_skipped" for r in lines)


def test_straggler_event_detection():
    """A batch that takes six steps' time to make shows as a straggler
    step (the deadline is three). The producer claims one step ahead, so it cannot hide the stall
    behind earlier steps; the stall is timed from the steps before it, so
    a slow host does not hide it either."""
    _, state, step, data, _, _ = _setup(sentinel=False)
    made = []

    class SlowData:
        def batch_at(self, s):
            if s == 9:  # a straggling host
                time.sleep(6 * float(np.median(np.diff(made))))
            made.append(time.perf_counter())
            return data.batch_at(s)

    res = Trainer(step, state, SlowData(), TrainerConfig(
        epochs=1, steps_per_epoch=10, eval_every_epochs=0, val_batches=0,
        log_every=1, deadline_factor=3.0, prefetch_depth=1)).run()
    assert 9 in [e["step"] for e in res.straggler_events]


def test_no_duplicate_final_checkpoint_save(tmp_path, monkeypatch):
    saved = []
    real_write = ck._write_checkpoint

    def counting_write(directory, step, arrays, metadata=None):
        saved.append(step)
        return real_write(directory, step, arrays, metadata)

    monkeypatch.setattr(ck, "_write_checkpoint", counting_write)
    _, state, step, data, _, _ = _setup(sentinel=False)
    run_training(step, state, data,
                 LoopConfig(total_steps=4, checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "ck")))
    assert sorted(saved) == [2, 4], saved
    assert ck.list_checkpoints(str(tmp_path / "ck")) == [2, 4]


def test_eval_history_and_best_resume_from_the_manifest(tmp_path):
    """The best checkpoint is kept on a better top-1, and a resume takes
    the eval history and the best epoch from the manifest."""
    model, state, step, data, _, _ = _setup(sentinel=False)
    ev, vd, fin = tlaunch.build_eval_setup(model, treduced(tget("resnet50")),
                                           global_batch=BATCH, seq_len=0)
    kw = dict(eval_step=ev, val_data=vd, finalize_state=fin)
    cfg = dict(steps_per_epoch=2, val_batches=1, checkpoint_every=2,
               checkpoint_dir=str(tmp_path), log_every=1)
    first = Trainer(step, state, data, TrainerConfig(epochs=2, **cfg),
                    **kw).run()
    assert ck.list_checkpoints(str(tmp_path / ck.BEST_DIR)) == \
        [first.best["step"]]
    _, state2, step2, data2, _, _ = _setup(sentinel=False)
    res = Trainer(step2, state2, data2, TrainerConfig(epochs=3, **cfg),
                  **kw).run()
    assert res.resumed_from == 4
    assert res.epoch_history[:2] == first.epoch_history
    assert len(res.epoch_history) == 3


# ---------------------------------------------------------------------------
# one chaos spec through both packages' Trainers
# ---------------------------------------------------------------------------

# one NaN batch rolls back at once (max_consecutive_bad=1); the newest
# checkpoint is torn after the save at 6, so the second rollback falls
# back past it. One producer that claims one step ahead, so every event
# lands in the same order in both packages.
CROSS_SPEC = "nan_grad@3,ckpt_truncate@5,nan_grad@7"
CROSS_KW = dict(epochs=1, steps_per_epoch=10, eval_every_epochs=0,
                val_batches=0, checkpoint_every=2, log_every=1,
                deadline_factor=1e9, data_workers=1, prefetch_depth=1)


def _events(res):
    keep = ("kind", "step", "fault", "from_step", "to_step", "target_step")
    return [{k: r[k] for k in keep if k in r} for r in res.events]


def test_same_chaos_spec_same_events_in_both_trainers(sent, tmp_path):
    res_kw = dict(max_consecutive_bad=1)
    ours = Trainer(sent["step"], sent["fresh"](), sent["data"],
                   TrainerConfig(checkpoint_dir=str(tmp_path / "port"),
                                 **CROSS_KW),
                   resilience=ResilienceConfig(**res_kw),
                   chaos=parse_chaos(CROSS_SPEC)).run()
    _, js, jstep, jdata, _, _ = jsetup(
        jreduced(jget("resnet50")), global_batch=BATCH, seq_len=0,
        opt_cfg=JOpt(**SGD), steps_per_epoch=SPE, seed=0, sentinel=True)
    theirs = JTrainer(jstep, js, jdata,
                      JTCfg(checkpoint_dir=str(tmp_path / "jax"), **CROSS_KW),
                      resilience=JResilienceConfig(**res_kw),
                      chaos=jparse_chaos(CROSS_SPEC)).run()
    assert _events(ours) == _events(theirs)
    assert [r["kind"] for r in ours.events] == [
        "chaos_injected", "step_skipped", "rollback", "chaos_injected",
        "chaos_injected", "step_skipped", "corrupt_checkpoint_skipped",
        "rollback"]
    assert ours.history[-1]["step"] == theirs.history[-1]["step"] == 9
    assert ck.list_checkpoints(str(tmp_path / "port")) == \
        ck.list_checkpoints(str(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------


def test_cli_sentinel_chaos_and_checkpoints_on_cpu(tmp_path, capsys):
    events = tmp_path / "events.jsonl"
    res = tlaunch.main([
        "--reduced", "--device", "cpu", "--epochs", "3",
        "--steps-per-epoch", "5", "--global-batch", "8", "--sentinel",
        "--chaos", "nan_grad@7-9", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "5", "--event-log", str(events), "--val-batches",
        "1"])
    kinds = [json.loads(line)["kind"] for line in open(events)]
    assert kinds.count("chaos_injected") == 3 and "step_skipped" in kinds
    assert "rollback" in kinds and res.history[-1]["step"] == 14
    assert ck.list_checkpoints(str(tmp_path / "ck")) == [5, 10, 15]
    manifest = json.load(open(tmp_path / "ck" / "step_0000000015"
                              / ck.MANIFEST))
    assert {k: manifest["metadata"][k] for k in ("arch", "optimizer",
                                                 "opt_layout")} == {
        "arch": "resnet50", "optimizer": "rmsprop_warmup",
        "opt_layout": "tree"}
    assert "resilience events:" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # the sentinel needs the epoch loop
        tlaunch.main(["--reduced", "--device", "cpu", "--sentinel"])


def test_cli_step_driven_run_resumes(tmp_path):
    argv = ["--reduced", "--device", "cpu", "--global-batch", "4",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = tlaunch.main(argv + ["--steps", "2"])
    assert first.resumed_from is None and len(first.history) == 2
    res = tlaunch.main(argv + ["--steps", "4"])
    assert res.resumed_from == 2 and [h["step"] for h in res.history] == \
        [2, 3]
    assert ck.list_checkpoints(str(tmp_path)) == [2, 4]
