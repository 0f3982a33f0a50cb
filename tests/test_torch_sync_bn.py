"""The port's cross-replica BN (sync-BN) against the JAX package's and
against its own single process.

1. One BN site, fused (``fused_bn_train(group=...)``, the plain versions
   here) and unfused (``bn_batch_stats(group=...)`` and the apply),
   with no ReLU, a ReLU, and a residual and a ReLU, with and without
   mean / var cotangents: two gloo workers against JAX's
   ``fused_bn_train(cross_replica=...)`` / ``bn_batch_stats`` under
   ``shard_map`` on two virtual devices (a subprocess), each device's
   VJP taken inside the body. y, mean, var, dx, dscale, dbias and dres
   of each worker, f32, within rtol / atol 1e-5 (the tolerance of
   ``test_torch_fused_bn.py``: the same math, sums in another order).
2. The sync-BN model at two gloo workers against the port's single
   process on the concatenated batch, fused and unfused, f32: the BN
   statistics of every site within rtol 1e-6 (atol 1e-6 of the site's
   largest magnitude, for means near zero), the averaged gradients
   within a relative norm of 2e-4 (ROADMAP's DP tolerance) of the
   full-batch gradients, and two DP steps (per-leaf f32 all-reduce)
   against two single-process steps: losses within rtol 2e-5,
   parameters within a relative norm of 2e-4.
3. At one worker sync-BN is an all-reduce of one: the step's state is
   bitwise that of the plain model, fused and unfused.
4. ``slow``: the whole DP step with sync-BN (bucketed bf16), and with
   sync-BN, the overlapped sync and error feedback, at two gloo workers
   against JAX's shard_map step on two virtual devices from the same
   weights, two steps: losses within rtol 2e-5, parameters within a
   relative norm of 2e-4, each worker's BN state within rtol / atol
   1e-3 (``test_torch_dp.py``'s drift tolerance).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import OptimizerConfig as TOpt, TrainConfig
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.core.batchnorm import bn_apply_stats, bn_batch_stats
from repro_torch.core.compression import compressed_psum
from repro_torch.distributed import init_workers, shutdown
from repro_torch.kernels import fused_bn as tfb
from repro_torch.launch import train as tlaunch
from repro_torch.training.step import _grads_of, to_device

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPE = (6, 5, 7, 24)  # 3 images a worker: 105 rows each
EPILOGUES = {"identity": (False, False), "relu": (True, False),
             "res_relu": (True, True)}
SITE_CASES = [(fused, epi, cot) for fused in (True, False)
              for epi in sorted(EPILOGUES) for cot in (True, False)]
SITE_OUTS = ("y", "mean", "var", "dx", "dscale", "dbias", "dres")
SITE_TOL = dict(rtol=1e-5, atol=1e-5)
DP_BATCH, SPE, STEPS = 16, 4, 2  # 8 samples a worker (test_torch_dp.py)


def _site_inputs(path):
    rng = np.random.default_rng(0)
    c = SHAPE[-1]
    d = {"x": rng.standard_normal(SHAPE).astype(np.float32) * 2 + 0.5,
         "res": rng.standard_normal(SHAPE).astype(np.float32),
         "dy": rng.standard_normal(SHAPE).astype(np.float32),
         "scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
         # each worker's own cotangents of the (global) statistics
         "dmean": rng.standard_normal((2, c)).astype(np.float32),
         "dvar": rng.standard_normal((2, c)).astype(np.float32)}
    np.savez(path, **d)
    return d


_JAX_SITE = """
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core.batchnorm import bn_apply_stats, bn_batch_stats
    from repro.kernels import ops
    d = dict(np.load("{inp}"))
    mesh = jax.make_mesh((2,), ("data",))
    out = {{}}
    for fused, epi, cot in {cases!r}:
        relu, has_res = {epis!r}[epi]

        def body(x, scale, bias, res, dy, dm, dv):
            scale, bias, dm, dv = scale[0], bias[0], dm[0], dv[0]

            def fn(x, scale, bias, res):
                r = res if has_res else None
                if fused:
                    return ops.fused_bn_train(x, scale, bias, residual=r,
                                              relu=relu,
                                              cross_replica=("data",))
                mean, var = bn_batch_stats(x, cross_replica=("data",))
                y = bn_apply_stats(x, mean, var, scale, bias)
                if has_res:
                    y = y + r
                return (jax.nn.relu(y) if relu else y), mean, var

            (y, mean, var), vjp = jax.vjp(fn, x, scale, bias, res)
            if not cot:
                dm, dv = jnp.zeros_like(dm), jnp.zeros_like(dv)
            dx, ds, db, dr = vjp((dy, dm, dv))
            return (y, mean[None], var[None], dx, ds[None], db[None],
                    dr if has_res else jnp.zeros_like(dr))

        f = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 7,
                      out_specs=(P("data"),) * 7, check_rep=False)
        two = lambda v: np.stack([v, v])
        res = jax.jit(f)(d["x"], two(d["scale"]), two(d["bias"]), d["res"],
                         d["dy"], d["dmean"], d["dvar"])
        tag = f"{{int(fused)}}_{{epi}}_{{int(cot)}}"
        for name, v in zip({outs!r}, res):
            out[f"{{tag}}/{{name}}"] = np.asarray(v)
    np.savez("{out}", **out)
"""


def _port_site(rank, d, group):
    """This worker's outputs of every site case: ``{tag/name: array}``,
    batch-sharded outputs as this worker's rows, (C,) ones as (1, C)."""
    b = SHAPE[0] // 2
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for fused, epi, cot in SITE_CASES:
        relu, has_res = EPILOGUES[epi]
        x = torch.from_numpy(d["x"][rows]).requires_grad_(True)
        res = torch.from_numpy(d["res"][rows]).requires_grad_(True) \
            if has_res else None
        scale = torch.from_numpy(d["scale"]).requires_grad_(True)
        bias = torch.from_numpy(d["bias"]).requires_grad_(True)
        if fused:
            y, mean, var = tfb.fused_bn_train(x, scale, bias, residual=res,
                                              relu=relu, group=group)
        else:
            mean, var = bn_batch_stats(x, group=group)
            y = bn_apply_stats(x, mean, var, scale, bias)
            if has_res:
                y = y + res
            if relu:
                y = torch.relu(y)
        outs, cts = [y], [torch.from_numpy(d["dy"][rows])]
        if cot:
            outs += [mean, var]
            cts += [torch.from_numpy(d["dmean"][rank]),
                    torch.from_numpy(d["dvar"][rank])]
        ins = [x, scale, bias] + ([res] if has_res else [])
        gs = list(torch.autograd.grad(outs, ins, cts)) + [None]
        tag = f"{int(fused)}_{epi}_{int(cot)}"
        vals = [y, mean[None], var[None], gs[0], gs[1][None], gs[2][None],
                gs[3] if has_res else torch.zeros_like(x)]
        for name, v in zip(SITE_OUTS, vals):
            out[f"{tag}/{name}"] = v.detach().numpy()
    return out


def _dp_setup(fused, sync, dp, comp="none", **kw):
    return tlaunch.build_train_setup(
        treduced(tget("resnet50")), global_batch=DP_BATCH, seq_len=0,
        opt_cfg=TOpt(), steps_per_epoch=SPE,
        dp_mode="shardmap" if dp else "none", compute_dtype=torch.float32,
        sync_bn=sync, compression=comp, fused_bn=fused, device="cpu", **kw)


def _grads_and_state(model, state, data):
    batch = to_device(data.batch_at(0), torch.device("cpu"))
    cfg = TrainConfig(optimizer=TOpt())
    mstate, metrics, grads = _grads_of(model, cfg, state["params"],
                                       state["model_state"], batch)
    return mstate, metrics, grads


def _port_dp(fused):
    """This worker's half of test 2: BN state and averaged gradients of
    one batch, then the losses and parameters of two DP steps."""
    model, state, step, data, put, _ = _dp_setup(fused, True, True)
    mstate, metrics, grads = _grads_and_state(model, state, data)
    grads = compressed_psum(grads, None, mean=True)
    loss = metrics["loss"].clone()
    torch.distributed.all_reduce(loss)
    tag = f"dp{int(fused)}"
    out = {f"{tag}/loss": (loss / 2).numpy()}
    out.update({f"{tag}/g/{k}": v.numpy() for k, v in grads.items()})
    for site, rec in mstate.items():
        for k in ("mean", "var"):
            out[f"{tag}/bn/{site}/{k}"] = rec[k].numpy()
    for i in range(STEPS):
        state, met = step(state, put(data.batch_at(i)))
        out[f"{tag}/loss{i}"] = np.float32(met["loss"])
    out.update({f"{tag}/p/{k}": v.numpy() for k, v in state["params"].items()})
    return out


def _worker(rank, out_dir):
    init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
                 world_size=2)
    try:
        d = dict(np.load(os.path.join(out_dir, "site_in.npz")))
        out = _port_site(rank, d, torch.distributed.group.WORLD)
        for fused in (True, False):
            out.update(_port_dp(fused))
        np.savez(os.path.join(out_dir, f"port_{rank}.npz"), **out)
    finally:
        shutdown()


def _jax_env():
    return {**os.environ,
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "PYTHONPATH": os.path.join(ROOT, "src")}


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    """Runs the JAX site programs (a subprocess on two virtual devices)
    and the port's two gloo workers once; returns (jax, [rank 0, rank
    1]) result dicts."""
    tmp = tmp_path_factory.mktemp("sync_bn")
    _site_inputs(tmp / "site_in.npz")
    body = textwrap.dedent(_JAX_SITE.format(
        inp=tmp / "site_in.npz", cases=SITE_CASES, epis=EPILOGUES,
        outs=SITE_OUTS, out=tmp / "jax_site.npz"))
    jax_run = subprocess.Popen([sys.executable, "-c", body], env=_jax_env(),
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
    mp.spawn(_worker, args=(str(tmp),), nprocs=2)
    _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-4000:]
    return (dict(np.load(tmp / "jax_site.npz")),
            [dict(np.load(tmp / f"port_{r}.npz")) for r in (0, 1)])


@pytest.mark.parametrize("fused,epi,cot", SITE_CASES)
def test_one_site_matches_jax_shard_map(two_workers, fused, epi, cot):
    ref, ranks = two_workers
    tag = f"{int(fused)}_{epi}_{int(cot)}"
    for name in SITE_OUTS:
        want = ref[f"{tag}/{name}"]
        got = np.concatenate([r[f"{tag}/{name}"] for r in ranks])
        np.testing.assert_allclose(got, want, err_msg=f"{tag}/{name}",
                                   **SITE_TOL)
    # the statistics are the global ones, equal on both workers
    for name in ("mean", "var"):
        np.testing.assert_array_equal(ranks[0][f"{tag}/{name}"],
                                      ranks[1][f"{tag}/{name}"])


def _rel_norm(a, b) -> float:
    num = sum(float(np.square(np.float64(a[k]) - np.float64(b[k])).sum())
              for k in b)
    den = sum(float(np.square(np.float64(b[k])).sum()) for k in b)
    return (num / den) ** 0.5


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("fused", [True, False])
def test_two_workers_equal_one_process_on_the_whole_batch(two_workers,
                                                          fused):
    _, ranks = two_workers
    model, state, step, data, _, _ = _dp_setup(fused, False, False)
    mstate, metrics, grads = _grads_and_state(model, state, data)
    tag = f"dp{int(fused)}"
    for got in ranks:
        np.testing.assert_allclose(got[f"{tag}/loss"],
                                   float(metrics["loss"]), rtol=2e-5)
        for site, rec in mstate.items():
            for k in ("mean", "var"):
                want = rec[k].numpy()
                np.testing.assert_allclose(
                    got[f"{tag}/bn/{site}/{k}"], want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()),
                    err_msg=f"{site}/{k}")
        g = _sub(got, f"{tag}/g/")
        assert g.keys() == grads.keys()
        rel = _rel_norm(g, {k: v.numpy() for k, v in grads.items()})
        assert rel < 2e-4, rel
    for i in range(STEPS):
        state, met = step(state, data.batch_at(i))
        for got in ranks:
            np.testing.assert_allclose(got[f"{tag}/loss{i}"],
                                       float(met["loss"]), rtol=2e-5)
    p0, p1 = _sub(ranks[0], f"{tag}/p/"), _sub(ranks[1], f"{tag}/p/")
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
    assert _rel_norm(p0, {k: v.numpy() for k, v in
                          state["params"].items()}) < 2e-4


@pytest.mark.parametrize("fused", [True, False])
def test_one_worker_sync_bn_is_bitwise_the_plain_model(fused):
    runs = []
    for sync in (True, False):
        _, state, step, data, put, _ = _dp_setup(fused, sync, True,
                                                 comp="bf16+bucketed")
        for i in range(2):
            state, met = step(state, put(data.batch_at(i)))
        runs.append((float(met["loss"]), state))
        shutdown()
    (l1, s1), (l2, s2) = runs
    assert l1 == l2
    for k, v in s1["params"].items():
        assert torch.equal(v, s2["params"][k]), k
    for site, rec in s1["model_state"].items():
        for k, v in rec.items():
            assert torch.equal(v, s2["model_state"][site][k]), (site, k)


def test_bn_bwd_dx_count_defaults_to_the_rows():
    g = torch.Generator().manual_seed(0)
    rows, c = 37, 24
    x, dy = torch.randn(rows, c, generator=g), torch.randn(rows, c,
                                                          generator=g)
    v = [torch.rand(c, generator=g) + 0.5 for _ in range(7)]
    args = (dy, x, x, *v, 1.0 / rows, True, True)
    a = tfb.bn_bwd_dx(*args)
    b = tfb.bn_bwd_dx(*args, count=rows)
    c2 = tfb.bn_bwd_dx(*args, count=2 * rows)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the count enters only the dvar term
    assert not torch.equal(a[0], c2[0]) and torch.equal(a[1], c2[1])


# ---------------------------------------------------------------------------
# slow: the whole DP step against JAX's shard_map step
# ---------------------------------------------------------------------------

STEP_CONFIGS = {"sync_bucketed": dict(compression="bf16+bucketed"),
                "sync_overlap_ef": dict(compression="bf16+bucketed",
                                        overlap_comm=True,
                                        error_feedback=True,
                                        bucket_bytes=16384)}

_JAX_STEPS = """
    import jax, numpy as np
    from repro.configs import OptimizerConfig, get_config, reduced_config
    from repro.launch.train import build_train_setup
    from repro_torch import interop
    cfg = reduced_config(get_config("resnet50"))
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    for name, kw in {configs!r}.items():
        _, s, step, data, put, _ = build_train_setup(
            cfg, global_batch={batch}, seq_len=0, opt_cfg=OptimizerConfig(),
            steps_per_epoch={spe}, mesh=mesh, dp_mode="shardmap",
            sync_bn=True, **kw)
        out = {{"p0/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}}
        for i in range({steps}):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{{i}}"] = np.float32(met["loss"])
        out.update({{"p/" + k: v.numpy() for k, v in interop.params_from_jax(
            jax.tree.map(np.asarray, s["params"]), device="cpu").items()}})
        for site, rec in jax.tree.map(np.asarray, s["model_state"]).items():
            for k in ("mean", "var"):
                out[f"bn/{{site}}/{{k}}"] = rec[k]
        np.savez("{out}/jax_" + name + ".npz", **out)
"""


def _step_worker(rank, out_dir, name):
    init_workers("cpu", init_method=f"file://{out_dir}/store_{name}",
                 rank=rank, world_size=2)
    try:
        ref = np.load(os.path.join(out_dir, f"jax_{name}.npz"))
        _, s, step, data, put, _ = tlaunch.build_train_setup(
            treduced(tget("resnet50")), global_batch=DP_BATCH, seq_len=0,
            opt_cfg=TOpt(), steps_per_epoch=SPE, dp_mode="shardmap",
            sync_bn=True, device="cpu", **STEP_CONFIGS[name])
        with torch.no_grad():
            for k, v in s["params"].items():
                v.copy_(torch.from_numpy(ref["p0/" + k]))
        out = {}
        for i in range(STEPS):
            s, met = step(s, put(data.batch_at(i)))
            out[f"loss{i}"] = float(met["loss"])
        out.update({"p/" + k: v.numpy() for k, v in s["params"].items()})
        for site, rec in s["model_state"].items():
            for k in ("mean", "var"):
                out[f"bn/{site}/{k}"] = rec[k].numpy()
        np.savez(os.path.join(out_dir, f"port_{name}_{rank}.npz"), **out)
    finally:
        shutdown()


@pytest.mark.slow
def test_two_workers_match_jax_sync_bn_steps(tmp_path):
    body = textwrap.dedent(_JAX_STEPS.format(
        configs=STEP_CONFIGS, batch=DP_BATCH, spe=SPE, steps=STEPS,
        out=tmp_path))
    res = subprocess.run([sys.executable, "-c", body], env=_jax_env(),
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    for name in STEP_CONFIGS:
        mp.spawn(_step_worker, args=(str(tmp_path), name), nprocs=2)
        ref = dict(np.load(tmp_path / f"jax_{name}.npz"))
        ranks = [dict(np.load(tmp_path / f"port_{name}_{r}.npz"))
                 for r in (0, 1)]
        for got in ranks:
            for i in range(STEPS):
                np.testing.assert_allclose(got[f"loss{i}"], ref[f"loss{i}"],
                                           rtol=2e-5, err_msg=name)
        p = _sub(ranks[0], "p/")
        for k, v in p.items():
            np.testing.assert_array_equal(v, ranks[1]["p/" + k])
        assert _rel_norm(p, _sub(ref, "p/")) < 2e-4, name
        # sync-BN: every worker holds the global statistics
        for r, got in enumerate(ranks):
            for k, v in _sub(got, "bn/").items():
                np.testing.assert_allclose(v, ref["bn/" + k][r], rtol=1e-3,
                                           atol=1e-3, err_msg=f"{name} {k}")
