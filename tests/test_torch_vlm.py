"""phi-3-vision-4.2b, the VLM family (``TransformerLM`` with its patch
frontend), on the port against the JAX package, on the CPU, at the
reduced config (16 patches of 64), f32, naive attention. Inputs are made
from a seed with numpy; the weights are drawn by the port from a seed and
carried to the JAX package with ``interop.params_to_jax``.

1. The config, full and reduced, field for field JAX's; the serving
   requests (prompts, then patches from the same ``RandomState``) bit for
   bit the JAX launcher's.
2. The forward with patches against JAX's (``vision_proj`` drawn after
   ``embed``, the patch positions dropped after the final norm): logits
   within 5e-4, the text positions only.
3. Prefill with patches and 4 greedy decode steps against JAX's, logits
   within 5e-4 and the same tokens. The cache is sized prompt + decode
   steps, as the JAX launcher sizes it, so the prefill keeps only its last
   positions and decode writes and rotates at the text position: a limit
   of the reference that the port keeps (ROADMAP queue 3), pinned by
   ``test_decode_after_patches_keeps_the_reference_cache_limit``.
4. The staged loss (``loss_segments``: ``vision_proj`` in the embed
   segment, the head dropping the patch positions): loss and gradients
   bitwise ``loss_fn``'s; its segment names and the overlapped step's
   ready-order plan equal the JAX package's.
5. Training: 3 steps through the launchers against the JAX package's
   (losses within rtol 2e-5, parameters within a relative norm of 2e-4);
   the DP step at one worker bitwise the one-device step; the overlapped
   step bitwise the bucketed step; ``serve()`` on the CPU.
6. ZeRO for all four families (phi-3-vision, zamba2-7b, xlstm-350m,
   whisper-tiny) on two gloo workers (one spawn, processes that import
   only the port): losses and parameters after 2 steps bitwise the
   bucketed step's, phi-3-vision's ZeRO + overlap too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced_config as jreduced
from repro.distributed import bucketing as jb
from repro.models.transformer import TransformerLM as JLM
from repro_torch import interop
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.distributed import bucketing as tb
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.serve import make_requests, serve
from repro_torch.models.common import staged_value_and_grad
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.training import step as tstep

from torch_families import (LOGIT_TOL, assert_round_trip,  # noqa: F401
                            assert_three_steps_match, jax_train_from,
                            one_thread, port_setup)

ARCH = "phi-3-vision-4.2b"
B, S, SMOOTH = 2, 32, 0.1

_PAIR = {}


def _pair():
    """(JAX model, its params, port model, the port's params)."""
    if not _PAIR:
        jm = JLM(jreduced(jget(ARCH)), compute_dtype=jnp.float32,
                 attention_impl="naive", remat=False)
        tm = TLM(treduced(tget(ARCH)), compute_dtype=torch.float32,
                 attention_impl="naive", device="cpu")
        tp = tm.init(5)
        _PAIR["v"] = (jm, jax.tree.map(jnp.asarray,
                                       interop.params_to_jax(tp)), tm, tp)
    return _PAIR["v"]


def _inputs(tm, b, s, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, tm.cfg.vocab_size, (b, s))
    vf = tm.cfg.vision
    patches = rng.randn(b, vf.num_patches, vf.patch_dim).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches(reduced):
    j, t = jget(ARCH), tget(ARCH)
    if reduced:
        j, t = jreduced(j), treduced(t)
        assert t.vision.num_patches == 16 and t.vision.patch_dim == 64
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_requests_are_the_jax_launchers():
    cfg = treduced(tget(ARCH))
    got = make_requests(cfg, 3, 20, seed=4)
    rng = np.random.RandomState(4)  # src/repro/launch/serve.py's draws
    want = {"tokens": rng.randint(0, cfg.vocab_size, size=(3, 20)),
            "patches": rng.randn(3, 16, 64)}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


def test_forward_with_patches_matches_jax():
    jm, jp, tm, tp = _pair()
    assert tp["vision_proj"].shape == (64, tm.cfg.d_model)
    toks, patches = _inputs(tm, 2, 48, 1)
    jl, _, _ = jax.jit(lambda p, t, pa: jm.forward(p, t, patches=pa))(
        jp, jnp.asarray(toks), jnp.asarray(patches))
    tl, _, _ = tm.forward(tp, torch.from_numpy(toks),
                          patches=torch.from_numpy(patches))
    assert tl.shape == (2, 48, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    plain, _, _ = tm.forward(tp, torch.from_numpy(toks))
    assert float((plain - tl).abs().max()) > 1e-3  # the patches count


def _serve_both(prompt, steps):
    """Prefill with patches, then ``steps`` greedy decode steps, port and
    JAX, each fed its own tokens; returns the port's and JAX's logits of
    every call, the port's tokens and the cache length."""
    jm, jp, tm, tp = _pair()
    toks, patches = _inputs(tm, 2, prompt, 3)
    jc, _ = jm.cache_shape(2, prompt + steps, jnp.float32)
    tc, _ = tm.cache_shape(2, prompt + steps, torch.float32)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jc,
                                   patches=jnp.asarray(patches))
    tlog, tc = tstep.make_prefill_step(tm)(tp, tc, {
        "tokens": torch.from_numpy(toks),
        "patches": torch.from_numpy(patches)})
    decode = jax.jit(jm.decode_step)
    out, seq = [(tlog.numpy(), np.asarray(jlog))], [toks]
    for i in range(steps):
        jt = jnp.argmax(jlog[:, -1], -1)[:, None]
        tt = torch.argmax(tlog[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        seq.append(tt.numpy())
        jlog, jc = decode(jp, jc, jt, jnp.int32(prompt + i))
        tlog, tc = tm.decode_step(tp, tc, tt, prompt + i)
        out.append((tlog.numpy(), np.asarray(jlog)))
    return out, np.concatenate(seq, 1), patches, tc["sub0/k"].shape[2]


def test_decode_after_patches_keeps_the_reference_cache_limit():
    """The reference's limit, pinned: the cache holds prompt + decode
    steps positions, the prefill writes patches + prompt of them (the
    last ones kept), and decode writes and rotates position ``prompt +
    i``, not ``patches + prompt + i``. The port agrees with the JAX
    package at every call; both leave the teacher-forced forward."""
    _, _, tm, tp = _pair()
    prompt, steps = 48, 4
    calls, seq, patches, cache_len = _serve_both(prompt, steps)
    assert cache_len == prompt + steps < tm.cfg.vision.num_patches + prompt
    for i, (t, j) in enumerate(calls):
        np.testing.assert_allclose(t, j, **LOGIT_TOL, err_msg=f"call {i}")
    full, _, _ = tm.forward(tp, torch.from_numpy(seq),
                            patches=torch.from_numpy(patches))
    np.testing.assert_allclose(calls[0][0][:, 0], full[:, prompt - 1].numpy(),
                               **LOGIT_TOL)  # the prefill is right
    gap = max(float(np.abs(calls[i + 1][0][:, 0]
                           - full[:, prompt + i].numpy()).max())
              for i in range(steps - 1))
    assert gap > 1e-2, gap


# ---------------------------------------------------------------- staged


def _batch(tm, seed=2):
    toks, patches = _inputs(tm, B, S + 1, seed)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "patches": patches}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tp):
    return {k: v.clone().requires_grad_(True) for k, v in tp.items()}


def test_staged_loss_is_bitwise_loss_fn():
    _, _, tm, tp = _pair()
    batch = _batch(tm)
    segs = tm.segment_trees(tp)
    assert set(segs[0]) == {"embed/table", "vision_proj"}
    assert set(segs[-1]) == {"final_norm/scale", "head"}
    pc = _leaves(tp)
    total, (_, met1) = tm.loss_fn(pc, {}, _tbatch(batch), SMOOTH)
    g1 = dict(zip(pc, torch.autograd.grad(total, list(pc.values()))))
    loss, (_, met2), g2 = staged_value_and_grad(
        tm.loss_segments(_leaves(tp), {}, _tbatch(batch), SMOOTH))
    assert float(total.detach()) == float(loss.detach())
    for k in met1:
        assert float(met1[k]) == float(met2[k]), k
    assert g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    assert float(g2["vision_proj"].abs().max()) > 0


def test_segments_and_ready_plan_equal_jax():
    jm, jp, tm, tp = _pair()
    batch = {k: jnp.asarray(v) for k, v in _batch(tm).items()}
    staged = jm.loss_segments(jp, {}, batch, SMOOTH)
    assert staged.names == tm.segment_names()
    bucket = 96 * 1024
    stages = list(reversed(staged.seg_params))
    jnames = []
    for seg, t in zip(reversed(staged.names), stages):
        for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]:
            name = "/".join(str(k.key) for k in path)
            jnames.append(name if seg in ("embed", "head")
                          else f"{seg}/{name}")
    jplan = jb.plan_ready_buckets(stages, bucket, "bf16", align=2)
    shapes = {k: torch.empty(v.shape, device="meta") for k, v in tp.items()}
    tplan = tb.plan_ready_buckets(tstep._ready_stages(tm, shapes), bucket,
                                  "bf16", align=2)
    assert list(tplan.base.names) == jnames
    assert "vision_proj" in jnames
    assert list(tstep.overlap_stream_order(tm, tp)) == jnames
    for f in ("total_elems", "bucket_elems", "n_buckets", "pad_elems"):
        assert getattr(tplan.base, f) == getattr(jplan.base, f), f
    assert tplan.ready_stage == jplan.ready_stage
    assert tplan.stage_ends == jplan.stage_ends


# ----------------------------------------------------------------- train


def test_three_train_steps_match_jax(monkeypatch):
    _, ts, step, data, _, _ = port_setup(ARCH)
    assert "patches" in data.batch_at(0)
    js, jstep, jdata = jax_train_from(ts["params"], monkeypatch, ARCH, JLM)
    assert_three_steps_match(js, jstep, jdata, ts, step, data)


def test_dp_steps_at_one_worker_are_bitwise(tmp_path):
    """The DP step (bucketed) at one worker is bitwise the one-device
    step, and the overlapped step (embed with vision_proj, 4 layer
    segments, head; small buckets) bitwise the bucketed one."""
    _, s1, step1, d1, _, _ = port_setup(ARCH, compression="bf16")
    init_workers("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                 world_size=1)
    try:
        runs = {}
        for name, kw in (("bucketed", {}), ("overlap",
                                             dict(overlap_comm=True))):
            model, s, step, data, put, _ = port_setup(
                ARCH, dp_mode="shardmap", compression="bf16+bucketed",
                bucket_bytes=64 * 1024, **kw)
            losses = []
            for i in range(2):
                s, m = step(s, put(data.batch_at(i)))
                losses.append(float(m["loss"]))
            runs[name] = (s, losses)
        assert len(model.segment_names()) == 6
        one = []
        for i in range(2):
            s1, m1 = step1(s1, d1.batch_at(i))
            one.append(float(m1["loss"]))
        for name, (s, losses) in runs.items():
            ref = s1 if name == "bucketed" else runs["bucketed"][0]
            assert losses == one, name
            for k, v in ref["params"].items():
                assert torch.equal(v, s["params"][k]), (name, k)
                for f in ("delta", "m"):
                    assert torch.equal(ref["opt"][f][k], s["opt"][f][k]), \
                        (name, f, k)
    finally:
        shutdown()


def test_serve_on_cpu_with_patches():
    cfg = treduced(tget(ARCH))
    res = serve(cfg, 2, 24, 3, attention_impl="chunked", device="cpu")
    assert res["generated"].shape == (2, 3)
    assert ((res["generated"] >= 0) & (res["generated"] < 512)).all()


def test_converters_round_trip_bitwise():
    _, jp, _, tp = _pair()
    assert_round_trip(jax.tree.map(np.asarray, jp), tp)


# ------------------------------------------------- ZeRO at two workers

# one gloo worker of two, in a process that imports only the port: each
# of the four families on the bucketed DP step, then under ZeRO (and
# phi-3-vision under ZeRO + overlap), 2 steps each from the same seed
_TWO_WORKERS = """
import os, sys
import numpy as np
from repro_torch.configs import OptimizerConfig, get_config, reduced_config
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.train import build_train_setup
rank, out_dir = int(sys.argv[1]), sys.argv[2]
init_workers("cpu", init_method=f"file://{out_dir}/store", rank=rank,
             world_size=2)
out = {}
for arch, cases in %(cases)r.items():
    for tag, kw in cases.items():
        _, s, step, data, put, _ = build_train_setup(
            reduced_config(get_config(arch)), global_batch=4, seq_len=32,
            opt_cfg=OptimizerConfig(**%(opt)r), steps_per_epoch=4,
            dp_mode="shardmap", compression="bf16+bucketed",
            bucket_bytes=64 * 1024, use_fused_kernel=True, device="cpu",
            **kw)
        losses = []
        for i in range(2):
            s, met = step(s, put(data.batch_at(i)))
            losses.append(float(met["loss"]))
        out[f"{arch}/{tag}/loss"] = np.asarray(losses)
        out.update({f"{arch}/{tag}/p/{k}": v.numpy().copy()
                    for k, v in s["params"].items()})
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
shutdown()
"""
FAMILIES = ["phi-3-vision-4.2b", "zamba2-7b", "xlstm-350m", "whisper-tiny"]
ZERO_CASES = {a: {"bucketed": {}, "zero": dict(zero_dp=True)}
              for a in FAMILIES}
ZERO_CASES[ARCH]["zero_overlap"] = dict(zero_dp=True, overlap_comm=True)


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    import os
    import subprocess
    import sys

    from torch_families import opt
    out_dir = tmp_path_factory.mktemp("families_zero")
    body = _TWO_WORKERS % {"cases": ZERO_CASES, "opt": opt()}
    root = os.path.join(os.path.dirname(__file__), "..")
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r),
                               str(out_dir)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_zero_at_two_workers_is_bitwise_bucketed(two_workers, arch):
    """ZeRO (reduce-scatter, the sharded stream update, all-gather) on
    two gloo workers against the bucketed step: losses and parameters
    bitwise on both workers; phi-3-vision's ZeRO + overlap too."""
    for rec in two_workers:
        want = {k[len(f"{arch}/bucketed/"):]: v for k, v in rec.items()
                if k.startswith(f"{arch}/bucketed/")}
        for tag in ZERO_CASES[arch]:
            got = {k[len(f"{arch}/{tag}/"):]: v for k, v in rec.items()
                   if k.startswith(f"{arch}/{tag}/")}
            assert got.keys() == want.keys() and len(got) > 2
            differ = [k for k in want if not np.array_equal(got[k], want[k])]
            assert not differ, (tag, differ[:5])
    for k, v in two_workers[0].items():
        assert np.array_equal(v, two_workers[1][k]), k
