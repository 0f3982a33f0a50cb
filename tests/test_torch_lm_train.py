"""LM training on the port (the dense family) against the JAX package,
on the CPU, at the reduced llama3.2-1b:

1. ``cross_entropy_loss`` (with ``ignore_id`` and label smoothing) and
   ``count_params``: the loss within rtol 2e-6 (f32 logsumexp summed in
   another order), the count equal.
2. ``SyntheticLMData`` / ``make_data``: bitwise the JAX package's
   tokens, targets and patches, train and val, the full batch and each
   of 4 host shards (bitwise that slice of the full batch).
3. ``chunked_attention(precision="bf16", inner_checkpoint=True)`` (the
   ``chunked_opt`` path) against JAX's, forward and the gradients of q,
   k and v, causal and windowed, over several padded chunks: f32 inputs
   within rtol / atol 1e-5; bf16 inputs (bf16 tiles and p) within 2
   bf16 ulps of the output's magnitude (each side rounds p and the
   output once; an exp that rounds the other way moves a sum by an ulp),
   gradients within a relative norm of 1e-2.
4. Three single-device train steps of the reduced LM from JAX's weights
   (f32, naive attention, the paper's rmsprop_warmup + slow_start, the
   bf16 wire cast): losses within rtol 2e-5, parameters within a
   relative norm of 2e-4 (the ResNet tolerances of
   ``test_torch_slice.py``); the eval step's metric keys equal JAX's.
5. The data-parallel step at one gloo worker, per-leaf and bucketed
   bf16, bitwise the single-device step; two gloo workers against one
   process on the whole batch, the two workers' parameters bitwise
   equal: with an f32 wire (``bucketed``) losses within rtol 2e-5 and
   parameters within a relative norm of 2e-4 (observed 8e-8 and 5e-7);
   with the bf16 wire (``bf16+bucketed``, with and without error
   feedback) losses within rtol 1e-4 and parameters within 1e-2
   (observed 3.9e-5 and 2.1e-3): two workers round their halves of the
   gradient to bf16 before the sum where one process rounds the whole
   once, and the RMSprop warm-up's first steps (m near 0) move each
   element by about lr x sign(g), so an element near 0 whose rounding
   differs moves the other way.
6. An LM checkpoint in the JAX package's layout (the stacked 4-d
   attention weights are not conv weights); sync-BN refused for an LM,
   and the overlapped sync, ZeRO and the hierarchical schedule taking a
   step (``test_torch_lm_dp.py`` holds them against the bucketed step).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.configs.base import VisionFrontend as JVision
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.data import synthetic as jsyn
from repro.launch.train import build_eval_setup as jeval_setup
from repro.launch.train import build_train_setup as jsetup
from repro.models import common as jcommon
from repro.models.layers import chunked_attention as jchunked
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import VisionFrontend as TVision
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed import init_workers, shutdown
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models.layers import chunked_attention as tchunked

ARCH = "llama3.2-1b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH, SEQ, SPE, STEPS = 4, 32, 4, 3


def _rel_norm(a, b) -> float:
    num = sum(float((torch.as_tensor(np.array(a[k])).double()
                     - torch.as_tensor(np.array(b[k])).double())
                    .square().sum()) for k in b)
    den = sum(float(torch.as_tensor(np.array(b[k])).double().square()
                    .sum()) for k in b)
    return (num / den) ** 0.5


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("ignore_id,smoothing", [(-1, 0.0), (-1, 0.1),
                                                 (5, 0.0), (5, 0.1)])
def test_cross_entropy_loss_matches_jax(ignore_id, smoothing):
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 7, 33) * 3).astype(np.float32)
    targets = rng.randint(0, 33, (2, 7)).astype(np.int32)
    targets[0, :3] = ignore_id
    want, wn = jcommon.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets), ignore_id=ignore_id,
        label_smoothing=smoothing)
    got, gn = tcommon.cross_entropy_loss(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets),
        ignore_id=ignore_id, label_smoothing=smoothing)
    want_bf, _ = jcommon.cross_entropy_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(targets),
        ignore_id=ignore_id, label_smoothing=smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want_bf), rtol=2e-6)
    got32, _ = tcommon.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        ignore_id=ignore_id, label_smoothing=smoothing)
    np.testing.assert_allclose(got32.item(), float(want), rtol=2e-6)
    assert gn.item() == float(wn)


def test_count_params_matches_jax(jax_run):
    p0 = jax_run[0]
    tp = lm_params_from_jax(p0, "cpu")
    assert tcommon.count_params(tp) == jcommon.count_params(p0)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("vision", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_lm_data_bitwise_jax_with_host_shards(split, vision):
    cj, ct = jreduced(jget(ARCH)), treduced(tget(ARCH))
    if vision:
        cj = dataclasses.replace(cj, vision=JVision(num_patches=4,
                                                    patch_dim=6))
        ct = dataclasses.replace(ct, vision=TVision(num_patches=4,
                                                    patch_dim=6))
    sj, st = JShape("t", 24, 8, "train"), TShape("t", 24, 8, "train")
    full_j = jsyn.make_data(cj, sj, seed=3, split=split).batch_at(5)
    full_t = tsyn.make_data(ct, st, seed=3, split=split).batch_at(5)
    assert set(full_t) == set(full_j) == (
        {"tokens", "targets", "patches"} if vision
        else {"tokens", "targets"})
    for k in full_j:
        assert full_t[k].dtype == full_j[k].dtype
        np.testing.assert_array_equal(full_t[k], full_j[k])
    for h in range(4):
        dj = jsyn.make_data(cj, sj, seed=3, split=split, num_hosts=4,
                            host_id=h)
        dt = tsyn.make_data(ct, st, seed=3, split=split, num_hosts=4,
                            host_id=h)
        assert dt.sample_offset == dj.sample_offset == 2 * h
        for k, v in dt.batch_at(5).items():
            np.testing.assert_array_equal(v, dj.batch_at(5)[k])
            np.testing.assert_array_equal(v, full_t[k][2 * h:2 * h + 2])


# ------------------------------------------------------------ chunked_opt


# (dtype, causal, window)
CHUNK_CASES = [("float32", True, None), ("float32", True, 48),
               ("bfloat16", True, None), ("bfloat16", False, None)]


@pytest.mark.parametrize("dtype,causal,window", CHUNK_CASES)
def test_chunked_opt_matches_jax_forward_and_grads(dtype, causal, window):
    b, sq, h, kv, dh = 2, 150, 4, 2, 16
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(b, sq, n, dh).astype(np.float32)
               for n in (h, kv, kv))
    ct = rng.randn(b, sq, h, dh).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=64, kv_chunk=32,
              precision="bf16", inner_checkpoint=True)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def jloss(q, k, v):
        out = jchunked(q, k, v, **kw)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tout = tchunked(tq, tk, tv, **kw)
    (tout.float() * torch.from_numpy(ct)).sum().backward()
    got = tout.detach().float().numpy()
    want = np.asarray(jout.astype(jnp.float32))
    assert tout.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for t, g in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-5, atol=1e-5)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= 2 * ulp + 1e-6).all(), \
        np.abs(got - want).max()
    for t, g in zip((tq, tk, tv), jgrads):
        gt = {"g": t.grad.float().numpy()}
        gj = {"g": np.asarray(g.astype(jnp.float32))}
        assert _rel_norm(gt, gj) < 1e-2


# ----------------------------------------------------------- train steps


def _opt():
    return dict(kind="rmsprop_warmup", schedule="slow_start",
                base_lr_per_256=3e-3, beta_center=1.0, beta_period=1.0,
                weight_decay=0.0)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's reduced LM: its initial params, 3 steps'
    losses, the params after them and its eval metrics' keys."""
    cfg = jreduced(jget(ARCH))
    jm, js, jstep, jdata, _, _ = jsetup(
        cfg, global_batch=BATCH, seq_len=SEQ, opt_cfg=JOpt(**_opt()),
        steps_per_epoch=SPE)
    p0 = _flat(jax.device_get(js["params"]))
    losses = []
    for i in range(STEPS):
        js, met = jstep(js, {k: jnp.asarray(v) for k, v in
                             jdata.batch_at(i).items()})
        losses.append(float(met["loss"]))
    jev, jval, _ = jeval_setup(jm, cfg, global_batch=BATCH, seq_len=SEQ)
    ev = jev(js["params"], js["model_state"],
             {k: jnp.asarray(v) for k, v in jval.batch_at(0).items()})
    return p0, losses, _flat(jax.device_get(js["params"])), ev


def _port_setup(**kw):
    cfg = treduced(tget(ARCH))
    return tlaunch.build_train_setup(
        cfg, global_batch=kw.pop("global_batch", BATCH), seq_len=SEQ,
        opt_cfg=TOpt(**_opt()), steps_per_epoch=SPE, device="cpu", **kw)


def _load(params, flat):
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(torch.as_tensor(flat[k]))


def test_three_train_steps_match_jax(jax_run):
    p0, jlosses, jp, jev = jax_run
    model, s, step, data, _, _ = _port_setup()
    assert model.attention_impl == "naive"  # the JAX launcher's default
    _load(s["params"], p0)
    for i in range(STEPS):
        s, met = step(s, data.batch_at(i))
        np.testing.assert_allclose(float(met["loss"]), jlosses[i],
                                   rtol=2e-5)
        assert set(met) >= {"loss", "moe_aux", "tokens", "lr"}
    assert _rel_norm(s["params"], jp) < 2e-4
    ev_step, val, fin = tlaunch.build_eval_setup(
        model, treduced(tget(ARCH)), global_batch=BATCH, seq_len=SEQ)
    assert fin is None
    ev = ev_step(s["params"], s["model_state"], val.batch_at(0))
    assert set(ev) == set(jev) == {"loss", "moe_aux", "tokens"}
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]),
                               rtol=1e-4)


@pytest.mark.parametrize("compression", ["bf16", "bf16+bucketed"])
def test_one_worker_equals_single_device_step_bitwise(tmp_path,
                                                      compression):
    _, s1, step1, d1, _, _ = _port_setup(compression="bf16")
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        _, s2, step2, d2, put2, _ = _port_setup(
            dp_mode="shardmap", compression=compression)
        for i in range(STEPS):
            s1, m1 = step1(s1, d1.batch_at(i))
            s2, m2 = step2(s2, put2(d2.batch_at(i)))
            assert float(m1["loss"]) == float(m2["loss"])
        for k, v in s1["params"].items():
            assert torch.equal(v, s2["params"][k]), k
            for f in ("delta", "m"):
                assert torch.equal(s1["opt"][f][k], s2["opt"][f][k]), (f, k)
    finally:
        shutdown()


# tag -> (build options, loss rtol, parameter relative norm)
TWO_RUNS = {
    "f32": (dict(compression="bucketed"), 2e-5, 2e-4),
    "bf16": (dict(compression="bf16+bucketed"), 1e-4, 1e-2),
    "bf16_ef": (dict(compression="bf16+bucketed", error_feedback=True),
                1e-4, 1e-2)}

# one gloo worker of two, in a process that imports only the port
_TWO_WORKER = """
import os, sys
import numpy as np
from repro_torch.configs import OptimizerConfig, get_config, reduced_config
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.train import build_train_setup
rank, out_dir = int(sys.argv[1]), sys.argv[2]
init_workers("cpu", init_method=f"file://{{out_dir}}/store", rank=rank,
             world_size=2)
out = {{}}
for tag, kw in {runs!r}.items():
    _, s, step, data, put, _ = build_train_setup(
        reduced_config(get_config({arch!r})), global_batch={batch},
        seq_len={seq}, opt_cfg=OptimizerConfig(**{opt!r}),
        steps_per_epoch={spe}, device="cpu", dp_mode="shardmap", **kw)
    for i in range({steps}):
        s, met = step(s, put(data.batch_at(i)))
        out[f"{{tag}}/loss{{i}}"] = float(met["loss"])
    out.update({{f"{{tag}}/p/{{k}}": v.numpy()
                for k, v in s["params"].items()}})
np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"), **out)
shutdown()
"""


def test_two_workers_match_one_process_on_the_whole_batch(tmp_path):
    body = _TWO_WORKER.format(
        runs={t: kw for t, (kw, _, _) in TWO_RUNS.items()}, arch=ARCH,
        batch=BATCH, seq=SEQ, opt=_opt(), spe=SPE, steps=STEPS)
    # one thread each: two processes spinning on every core for the
    # small products of the reduced model take ~2 s a step instead of
    # ~30 ms
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r),
                               str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for tag, (kw, loss_rtol, param_tol) in TWO_RUNS.items():
        init_workers("cpu", init_method=f"file://{tmp_path}/one_{tag}",
                     rank=0, world_size=1)
        try:
            _, s, step, data, put, _ = _port_setup(dp_mode="shardmap", **kw)
            for i in range(STEPS):
                s, met = step(s, put(data.batch_at(i)))
                for got in ranks:
                    np.testing.assert_allclose(got[f"{tag}/loss{i}"],
                                               float(met["loss"]),
                                               rtol=loss_rtol)
        finally:
            shutdown()
        p = {k: ranks[0][f"{tag}/p/{k}"] for k in s["params"]}
        for k, v in p.items():
            np.testing.assert_array_equal(v, ranks[1][f"{tag}/p/{k}"])
        assert _rel_norm(p, s["params"]) < param_tol, tag


# ------------------------------------------------ checkpoints and limits


def test_lm_checkpoint_has_the_jax_layout_and_resumes(tmp_path, jax_run):
    from repro_torch.training import LoopConfig, run_training
    p0 = jax_run[0]
    ck = str(tmp_path / "ck")
    _, s, step, data, _, _ = _port_setup()
    res = run_training(step, s, data, LoopConfig(
        total_steps=2, checkpoint_every=1, checkpoint_dir=ck))
    arrays = np.load(os.path.join(ck, "step_0000000002", "arrays.npz"))
    for name, v in p0.items():
        key = "['params']" + "".join(f"['{p}']" for p in name.split("/"))
        assert arrays[key].shape == v.shape, key
        np.testing.assert_array_equal(arrays[key], s["params"][name].numpy())
    # a fresh run resumes from it and takes the same third step
    _, s2, step2, data2, _, _ = _port_setup()
    res2 = run_training(step2, s2, data2, LoopConfig(
        total_steps=3, checkpoint_every=1, checkpoint_dir=ck))
    assert res2.resumed_from == 2 and res.resumed_from is None
    _, s3, step3, data3, _, _ = _port_setup()
    for i in range(3):
        s3, _ = step3(s3, data3.batch_at(i))
    for k, v in s3["params"].items():
        assert torch.equal(v, s2["params"][k]), k


# one gloo worker of 4 taking a step of each LM DP variant that needs
# more than one worker: ZeRO, and the hierarchical schedule over 2x2
_STEP_WORKER = """
import os, sys
import numpy as np
from repro_torch.configs import OptimizerConfig, get_config, reduced_config
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.train import build_train_setup
rank, out_dir = int(sys.argv[1]), sys.argv[2]
init_workers("cpu", init_method=f"file://{{out_dir}}/store", rank=rank,
             world_size=4)
losses = {{}}
for i, kw in enumerate({runs!r}):
    _, s, step, data, put, _ = build_train_setup(
        reduced_config(get_config({arch!r})), global_batch=8,
        seq_len={seq}, opt_cfg=OptimizerConfig(**{opt!r}),
        steps_per_epoch={spe}, device="cpu", dp_mode="shardmap",
        compression="bf16+bucketed", **kw)
    s, met = step(s, put(data.batch_at(0)))
    losses[f"run{{i}}"] = float(met["loss"])
np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"), **losses)
shutdown()
"""

_VARIANTS = [dict(overlap_comm=True), dict(zero_dp=True),
             dict(hier_split=1, dp_axes=("data", "model"),
                  mesh_shape=(2, 2))]


@pytest.fixture(scope="module")
def four_worker_steps(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("lm_variants")
    body = _STEP_WORKER.format(runs=_VARIANTS[1:], arch=ARCH, seq=SEQ,
                               opt=_opt(), spe=SPE)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r),
                               str(out_dir)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("kw,match", [
    (_VARIANTS[0], None), (_VARIANTS[1], None), (_VARIANTS[2], None),
    (dict(sync_bn=True), "has no BN")])
def test_unported_lm_steps_raise(request, tmp_path, kw, match):
    """sync_bn still raises for an LM (it has no BN); the overlapped
    step, ZeRO and the hierarchical schedule, which raised until the
    staged LM loss was ported, now build and take a step: the overlapped
    one on one worker here, the other two on four gloo workers (one
    spawn for both). tests/test_torch_lm_dp.py holds them bitwise
    against the bucketed step."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            _port_setup(dp_mode="shardmap", compression="bf16+bucketed",
                        **kw)
        shutdown()
        return
    if "overlap_comm" not in kw:
        ranks = request.getfixturevalue("four_worker_steps")
        run = f"run{_VARIANTS.index(kw) - 1}"
        assert len({float(r[run]) for r in ranks}) == 1
        assert np.isfinite(float(ranks[0][run]))
        return
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        _, s, step, data, put, _ = _port_setup(
            dp_mode="shardmap", compression="bf16+bucketed", **kw)
        s, met = step(s, put(data.batch_at(0)))
        assert np.isfinite(float(met["loss"]))
    finally:
        shutdown()


def test_train_llm_100m_script_config_is_jax_scripts():
    mods = []
    for name in ("train_llm_100m.py", "torch_train_llm_100m.py"):
        spec = importlib.util.spec_from_file_location(
            name[:-3], os.path.join(ROOT, "examples", name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    assert dataclasses.asdict(mods[0].lm_100m()) == \
        dataclasses.asdict(mods[1].lm_100m())
