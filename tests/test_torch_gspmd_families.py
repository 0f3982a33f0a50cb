"""The GSPMD mode under a model axis for every family but the conv and
dense ones: MoE expert parallelism (reduced mixtral-8x7b, 4 experts, 2 a
worker) and tensor parallelism inside the experts (the same with 3
experts, which do not divide the axis, so "ffn" carries it),
llama4-maverick (EP, a shared expert), phi-3-vision (the patch
frontend), zamba2 (Mamba2's packed projections, the shared attention
blocks), xLSTM (mLSTM / sLSTM on each worker's heads) and whisper with
an odd vocabulary of 511 (the replicated "vocab" route of the cross
entropy, as whisper-tiny's 51,865). All at (1, 2), on the CPU, f32
compute, from the same weights (the port's draw, carried into JAX with
``interop.params_to_jax``).

JAX's side runs in one subprocess on 2 virtual devices, on meshes built
with ``AxisType.Auto`` axes (in this JAX ``jax.make_mesh`` builds
Explicit ones, on which the JAX package's GSPMD step raises); its
launcher's ``init_params`` is stood in for by the port's weights (no
eager draw). The port's side is one spawn of 2 gloo workers that import
only the port.

1. 3 GSPMD train steps against JAX's GSPMD step and against the port's
   one-device step on the whole batch: losses within rtol 2e-5, each
   parameter leaf within 2e-4 relative norm; the MoE dispatch tensor
   of the first forward (each choice's expert, slot and kept flag: the
   routing the port runs on each worker, ``layers._route``) equal to
   JAX's, and the aux loss within rtol 1e-5 of JAX's. The steps carry
   the gradients in f32 (``compression="none"``): zamba2's ``A_log`` /
   ``dt_bias`` / ``conv_b`` and the sLSTM's ``b_gates`` start at 0, and
   the bf16 wire's one rounding of a sum taken in another order is a
   flip of a bf16 ulp, which the RMSprop warm-up carries into those
   leaves (``test_torch_gspmd.py`` holds the bf16 wire itself). One
   leaf is held to a measured bound, ``SLSTM_BIAS_TOL``: the sLSTM's
   ``b_gates``, whose input-gate gradients cancel through the
   exponential gate's stabilizer (``m``), so they are rounding noise
   that the RMSprop warm-up turns into steps of +-lr. A sum taken in
   another order moves them: the JAX package's own GSPMD step is 7.5e-4
   from its one-device step on that leaf (47 elements of the first
   layer's input gate), the port's 7.3e-4 from JAX's GSPMD step and
   8.6e-4 from its own one-device step. The whole tree is held to 2e-4.
2. A GSPMD prefill of 32 tokens and 4 greedy decode steps
   (``make_gspmd_prefill_step`` / ``make_gspmd_decode_step``, the cache
   placed by ``place_cache``) against JAX's ``make_prefill_step`` /
   ``make_decode_step`` with the mesh, the cache placed as its dry-run
   places it: logits within 5e-4, the same greedy tokens. zamba2's and
   xLSTM's ``out_norm`` is an RMSNorm over the sharded ``d_in``: a row
   normalised per shard moves these logits far past the bound.
3. The placements: ``build_train_setup`` builds all eleven archs under
   ``mesh_shape=(1, 2)``; the expert weights are split over "model" for
   mixtral (EP), their ``ffn`` for the 3-expert variant, the vocabulary
   stays whole for the vocab-511 whisper, the packed "inner" leaves are
   split.
4. A GSPMD checkpoint of mixtral under EP restores at (2, 1) into the
   same parameters and optimizer state, bitwise.
5. The steps and the serve steps change placements by all-reduces,
   list all-gathers (``dist.all_gather``) and local slices
   (``sharding.redistribute``): DTensor's own all-gather,
   reduce-scatter and all-to-all are counted and must not run (gloo
   crashes on DTensor's all-gather of a CUDA tensor, and the card's
   paths run two gloo processes); the all-reduces and all-gathers of
   one mamba, mLSTM and sLSTM block are counted. zamba2 with each mamba
   layer checkpointed (``remat``) is bitwise the run without.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import build_model as tbuild

ROOT = os.path.join(os.path.dirname(__file__), "..")
STEPS, SEQ, BATCH, SPE, DECODE = 3, 32, 2, 4, 4
LOSS_RTOL, PARAM_TOL, AUX_RTOL, LOGIT_TOL = 2e-5, 2e-4, 1e-5, 5e-4
# the sLSTM's gate biases, a measured bound (module docstring, 1.): the
# JAX package's own GSPMD step is 7.5e-4 from its one-device step there
SLSTM_BIAS, SLSTM_BIAS_TOL = "slstm/b_gates", 2e-3
# tag: (arch, config changes)
CASES = {"mixtral": ("mixtral-8x7b", {}),
         "mixtral_e3": ("mixtral-8x7b", {"n_experts": 3}),
         "maverick": ("llama4-maverick-400b-a17b", {}),
         "phi": ("phi-3-vision-4.2b", {}),
         "zamba2": ("zamba2-7b", {}),
         "xlstm": ("xlstm-350m", {}),
         "whisper511": ("whisper-tiny", {"vocab_size": 511})}
MOE = ("mixtral", "mixtral_e3", "maverick")
ALL_ARCHS = ["resnet50", "llama3.2-1b", "yi-9b", "granite-34b", "qwen2-72b",
             "mixtral-8x7b", "llama4-maverick-400b-a17b",
             "phi-3-vision-4.2b", "zamba2-7b", "xlstm-350m", "whisper-tiny"]

_JAX = """
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro.configs import OptimizerConfig, get_config, reduced_config
from repro.configs.base import ParallelConfig
from repro.distributed.sharding import make_rules, prune_spec, tree_shardings
from repro.launch.train import build_train_setup
from repro.models import build_model, layers
from repro.models.common import unbox
from repro.training.step import make_decode_step, make_prefill_step
out_dir = sys.argv[1]
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {{}}

def nest(flat):
    tree = {{}}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = jnp.asarray(v)
    return tree

def flat(tree, pre=""):
    if isinstance(tree, dict):
        res = {{}}
        for k, v in tree.items():
            res.update(flat(v, pre + k + "/"))
        return res
    return {{pre[:-1]: np.asarray(tree)}}

# the dispatch one-hots of each MoE layer, as the step runs them
seen = []
constrain = layers.constrain

def capture(x, axes):
    if tuple(axes) == ("batch", None, "experts", None) and not seen[-1]:
        jax.debug.callback(lambda d: taken.append(np.asarray(d)), x)
    if tuple(axes) == ("batch", None, "experts", None):
        seen[-1] = not seen[-1]  # dispatch, then combine
    return constrain(x, axes)

layers.constrain = capture
for tag, (arch, changes) in {cases!r}.items():
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    init = nest(dict(np.load(f"{{out_dir}}/init_{{tag}}.npz")))
    cls = type(build_model(cfg))
    cls.init_params = lambda self, key: (
        init, unbox(jax.eval_shape(self.init, key))[1])
    model, state, step, data, put, sh = build_train_setup(
        cfg, global_batch={batch}, seq_len={seq},
        opt_cfg=OptimizerConfig(), steps_per_epoch={spe}, mesh=mesh,
        dp_mode="gspmd", compression="none")
    p0 = jax.device_put(nest(dict(np.load(f"{{out_dir}}/init_{{tag}}.npz"))),
                        sh["params"])
    taken, seen[:] = [], [False]
    losses, aux = [], []
    for i in range({steps}):
        state, met = step(state, put(data.batch_at(i)))
        losses.append(float(met["loss"]))
        aux.append(float(met.get("moe_aux", 0.0)))
        jax.effects_barrier()
        if i == 0:
            for j, d in enumerate(taken):
                out[f"{{tag}}/dispatch{{j}}"] = d
    out[tag + "/loss"] = np.asarray(losses)
    out[tag + "/aux"] = np.asarray(aux)
    out.update({{f"{{tag}}/p/{{k}}": v
                for k, v in flat(state["params"]).items()}})
    # serve from the starting weights, the cache placed as the dry-run
    rules = make_rules(cfg, mesh, ParallelConfig(dp_axes=("data",),
                                                 tp_axis="model"))
    cache, axes = model.cache_shape({batch}, {seq} + {decode}, jnp.float32)
    csh = tree_shardings(axes, mesh, rules)
    csh = jax.tree.map(
        lambda v, s: NamedSharding(mesh, prune_spec(v.shape, s.spec, mesh)),
        cache, csh, is_leaf=lambda x: isinstance(x, NamedSharding))
    cache = jax.device_put(cache, csh)
    prefill = jax.jit(make_prefill_step(model, mesh, rules),
                      out_shardings=(None, csh))
    decode = jax.jit(make_decode_step(model, mesh, rules),
                     out_shardings=(None, csh))
    b = data.batch_at(0)
    logits, cache = prefill(p0, cache, {{k: jnp.asarray(v) for k, v in
                                        b.items() if k != "targets"}})
    out[f"{{tag}}/serve0"] = np.asarray(logits)
    for i in range({decode}):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        logits, cache = decode(p0, cache, {{"tokens": tok,
                                           "cache_index": {seq} + i}})
        out[f"{{tag}}/serve{{i + 1}}"] = np.asarray(logits)
np.savez(f"{{out_dir}}/jax.npz", **out)
"""

# one of the two gloo workers: every run of the spawn; then worker 0
# runs the one-device steps
_WORKER = """
import dataclasses, os, sys
import numpy as np
import torch
from repro_torch import interop
from repro_torch.checkpoint import restore, save
from repro_torch.configs import OptimizerConfig, get_config, reduced_config
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.train import build_train_setup
from repro_torch.models import layers
from repro_torch.training.gspmd import gather_tree, place_cache
from repro_torch.training.step import make_decode_step, make_prefill_step
rank, out_dir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
init_workers("cpu", init_method=f"file://{{out_dir}}/store", rank=rank,
             world_size=2)
cases = {cases!r}
out = {{}}

def config(arch, changes):
    return dataclasses.replace(reduced_config(get_config(arch)), **changes)

def setup(tag, **kw):
    arch, changes = cases[tag]
    return build_train_setup(
        config(arch, changes), global_batch={batch}, seq_len={seq},
        opt_cfg=OptimizerConfig(), steps_per_epoch={spe},
        compression="none", device="cpu", **kw)

# DTensor's own all-gathers, reduce-scatters and all-to-alls, counted
# while the steps run (gloo crashes on them with CUDA tensors)
import torch.distributed._functional_collectives as funcol
from repro_torch.distributed.sharding import count_dtensor_collectives
calls = count_dtensor_collectives()

class Tape:  # records the dispatch one-hots of each _route call
    def __init__(self, route):
        self.route, self.calls = route, []
    def __call__(self, *a):
        dispatch, gates = self.route(*a)
        self.calls.append(dispatch.numpy().copy())
        return dispatch, gates

def run(key, tag, **kw):
    model, s, step, data, put, sh = setup(tag, **kw)
    p0 = {{k: v.detach().clone() for k, v in s["params"].items()}}
    tape = Tape(layers._route)
    losses, aux = [], []
    calls.update(n=0, on=True)
    for i in range({steps}):
        layers._route = tape if i == 0 else tape.route
        b = data.batch_at(i)
        s, met = step(s, put(b) if put else b)
        layers._route = tape.route
        losses.append(float(met["loss"]))
        aux.append(float(met.get("moe_aux", 0.0)))
    if key == "zamba2_remat":  # no serving
        calls["on"] = False
    else:
        serve(key, model, p0, data, sh)
    gathers, calls["on"] = calls["n"], False
    params = gather_tree(s["params"]) if sh is not None else s["params"]
    if rank == 0:
        out[key + "/loss"] = np.asarray(losses)
        out[key + "/aux"] = np.asarray(aux)
        for j, d in enumerate(tape.calls):
            out[f"{{key}}/dispatch{{j}}"] = d
        for k, v in params.items():
            out[f"{{key}}/p/{{k}}"] = v.numpy().copy()
        out[key + "/dtensor_gathers"] = np.asarray(gathers)
    return s, sh

def serve(key, model, params, data, sh):
    mesh = rules = None
    if sh is not None:
        mesh, rules = sh.mesh, sh.rules
    cache, axes = model.cache_shape({batch}, {seq} + {decode},
                                    torch.float32)
    if mesh is not None:
        cache = place_cache(cache, axes, mesh, rules)
    prefill = make_prefill_step(model, mesh, rules)
    decode = make_decode_step(model, mesh, rules)
    b = {{k: torch.as_tensor(np.asarray(v)) for k, v in
         data.batch_at(0).items() if k != "targets"}}
    with torch.no_grad():
        logits, cache = prefill(params, cache, b)
        got = [logits]
        for i in range({decode}):
            tok = logits[:, -1].argmax(-1)[:, None].int()
            logits, cache = decode(params, cache, {{"tokens": tok,
                                                   "cache_index": {seq} + i}})
            got.append(logits)
    if rank == 0:
        for i, lg in enumerate(got):
            out[f"{{key}}/serve{{i}}"] = lg.numpy().copy()

for tag in cases:
    s, sh = run(tag, tag, dp_mode="gspmd", mesh_shape=(1, 2))
    if rank == 0:
        for k, p in s["params"].items():
            out[f"{{tag}}/pl/{{k}}"] = np.asarray(
                [str(q) for q in p.placements])
    if tag == "mixtral":  # the checkpoint, restored at (2, 1)
        tree = interop.train_state_to_jax(s, sh)
        if rank == 0:
            save(os.path.join(out_dir, "ck"), {steps}, tree)
        torch.distributed.barrier()
        _, s2, _, _, _, sh2 = setup(tag, dp_mode="gspmd", mesh_shape=(2, 1))
        arrays, _ = restore(os.path.join(out_dir, "ck"))
        interop.train_state_from_jax(arrays, s2, sh2)
        back = interop.train_state_to_jax(s2, sh2)
        if rank == 0:
            for key in ("params", "opt"):
                for k, v in interop._flatten(tree[key]).items():
                    out[f"saved/{{key}}/{{k}}"] = np.asarray(v)
                for k, v in interop._flatten(back[key]).items():
                    out[f"restored/{{key}}/{{k}}"] = np.asarray(v)
# the all-reduces (DTensor's Partial sums) and list all-gathers of one
# SSM block's forward and backward under TP
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed.sharding import (activation_sharding,
                                              distribute_local)
from repro_torch.models import mamba, xlstm
from repro_torch.models.common import sub_params
reduces = {{"n": 0, "gathers": 0}}

def counting(fn, what="n"):
    def call(*a, **k):
        reduces[what] += 1
        return fn(*a, **k)
    return call

dist.all_reduce = counting(dist.all_reduce)
funcol.all_reduce = counting(funcol.all_reduce)
dist.all_gather = counting(dist.all_gather, "gathers")
for block, tag, fn in (("mamba", "zamba2", mamba.mamba2_apply),
                       ("mlstm", "xlstm", xlstm.mlstm_apply),
                       ("slstm", "xlstm", xlstm.slstm_apply)):
    model, s, _, _, _, sh = setup(tag, dp_mode="gspmd", mesh_shape=(1, 2))
    p = {{k: v.detach().requires_grad_(True) for k, v in
         sub_params(s["params"], block, 0).items()}}
    x = distribute_local(torch.randn({batch}, {seq}, model.cfg.d_model),
                         sh.mesh, (Shard(0), Replicate())
                         ).requires_grad_(True)
    with activation_sharding(sh.mesh, sh.rules):
        reduces.update(n=0, gathers=0)
        y = fn(p, x, model.cfg)[0]
        fwd, fwd_g = reduces["n"], reduces["gathers"]
        torch.autograd.grad(y.to_local().sum(), [x] + list(p.values()))
    if rank == 0:
        out[f"reduces/{{block}}"] = np.asarray([fwd, reduces["n"] - fwd])
        out[f"gathers/{{block}}"] = np.asarray(
            [fwd_g, reduces["gathers"] - fwd_g])
# zamba2 with each mamba layer checkpointed (the launcher's n_layers > 8)
run("zamba2_remat", "zamba2", dp_mode="gspmd", mesh_shape=(1, 2),
    remat=True)
# every arch builds under the model axis
for arch in {all_archs!r}:
    _, s, _, _, _, _ = build_train_setup(
        reduced_config(get_config(arch)), global_batch={batch},
        seq_len={seq}, opt_cfg=OptimizerConfig(), steps_per_epoch={spe},
        device="cpu", dp_mode="gspmd", mesh_shape=(1, 2))
    if rank == 0:
        out["built/" + arch] = np.asarray(len(s["params"]))
shutdown()
if rank == 0:  # the one-device steps on the whole batches
    for tag in cases:
        run("one_" + tag, tag, dp_mode="none")
    np.savez(os.path.join(out_dir, "port.npz"), **out)
"""


def _env(**extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "OMP_NUM_THREADS": "1", **extra}


def _wait(procs, timeout=600):
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's numbers: JAX's (one subprocess) and the port's (one
    spawn of two workers, then worker 0's one-device steps)."""
    out_dir = tmp_path_factory.mktemp("gspmd_families")
    for tag, (arch, changes) in CASES.items():
        cfg = dataclasses.replace(treduced(tget(arch)), **changes)
        model = tbuild(cfg, compute_dtype=torch.float32, device="cpu")
        params, _ = model.init_params(0)
        np.savez(out_dir / f"init_{tag}.npz",
                 **interop._flatten(interop.params_to_jax(params)))
    fmt = dict(cases=CASES, seq=SEQ, batch=BATCH, spe=SPE, steps=STEPS,
               decode=DECODE, all_archs=ALL_ARCHS)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX.format(**fmt), str(out_dir)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    body = _WORKER.format(**fmt)
    workers = [subprocess.Popen([sys.executable, "-c", body, str(r),
                                 str(out_dir)], env=_env(),
                                stderr=subprocess.PIPE, text=True)
               for r in range(2)]
    _wait(workers)
    _wait([jax_proc])
    return {"jax": dict(np.load(out_dir / "jax.npz")),
            **np.load(out_dir / "port.npz")}


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


def _assert_leaves(got, want):
    """Each leaf within ``PARAM_TOL``, the sLSTM's gate biases within
    their measured bound, and the whole tree within ``PARAM_TOL``."""
    assert got.keys() == want.keys() and got
    rel = {k: float(np.linalg.norm((got[k] - want[k]).ravel())
                    / max(np.linalg.norm(want[k].ravel()), 1e-30))
           for k in want}
    loose = {k: rel.pop(k) for k in [SLSTM_BIAS] if k in rel}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= PARAM_TOL, (worst, rel[worst])
    assert all(v <= SLSTM_BIAS_TOL for v in loose.values()), loose
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    assert (num / den) ** 0.5 <= PARAM_TOL, (num / den) ** 0.5


@pytest.mark.parametrize("tag", sorted(CASES))
def test_gspmd_steps_match_jax_gspmd(runs, tag):
    np.testing.assert_allclose(runs[f"{tag}/loss"],
                               runs["jax"][f"{tag}/loss"], rtol=LOSS_RTOL)
    _assert_leaves(_sub(runs, f"{tag}/p/"), _sub(runs["jax"], f"{tag}/p/"))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_gspmd_steps_match_the_one_device_step(runs, tag):
    np.testing.assert_allclose(runs[f"{tag}/loss"], runs[f"one_{tag}/loss"],
                               rtol=LOSS_RTOL)
    _assert_leaves(_sub(runs, f"{tag}/p/"), _sub(runs, f"one_{tag}/p/"))


@pytest.mark.parametrize("tag", MOE)
def test_moe_routing_and_aux_match_jax(runs, tag):
    got = _sub(runs, f"{tag}/dispatch")
    want = _sub(runs["jax"], f"{tag}/dispatch")
    assert got.keys() == want.keys() and got
    for j in want:
        np.testing.assert_array_equal(got[j], want[j])
    np.testing.assert_allclose(runs[f"{tag}/aux"], runs["jax"][f"{tag}/aux"],
                               rtol=AUX_RTOL)
    # the one-device step routes alike
    one = _sub(runs, f"one_{tag}/dispatch")
    assert all(np.array_equal(one[j], got[j]) for j in got)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_gspmd_prefill_and_decode_match_jax(runs, tag):
    for i in range(DECODE + 1):
        got, want = runs[f"{tag}/serve{i}"], runs["jax"][f"{tag}/serve{i}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        assert np.array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_steps_redistribute_by_all_reduces_only(runs, tag):
    """DTensor's all-gather of a CUDA tensor crashes gloo (the card's
    two-process paths): the steps gather by list all-gathers
    (``sharding.redistribute``) and never call DTensor's all-gather,
    reduce-scatter or all-to-all."""
    assert int(runs[f"{tag}/dtensor_gathers"]) == 0


def test_zamba2_remat_under_tp_is_bitwise(runs):
    np.testing.assert_array_equal(runs["zamba2_remat/loss"],
                                  runs["zamba2/loss"])
    got, want = _sub(runs, "zamba2_remat/p/"), _sub(runs, "zamba2/p/")
    assert got.keys() == want.keys() and got
    assert all(np.array_equal(got[k], want[k]) for k in want)


# all-reduces of one block's forward and backward a worker at (1, 2):
# mamba: the row-parallel output reduced; back: the Partial gradients of
# z, dt, x, B, C, out_norm's input and the input norm's output. mLSTM:
# the gates' row-parallel product and the output reduced; back: six
# Partial gradients. sLSTM: back, two (its FFN is replicated)
REDUCES = {"mamba": (1, 7), "mlstm": (2, 6), "slstm": (0, 2)}
# list all-gathers of the same (a gather's gradient is a local slice):
# mamba: the packed projection, conv_w and conv_b, and the gated output
# for out_norm; mLSTM: the up-projection, b_if and the output for
# out_norm; sLSTM: the gates' projection and the hidden states
GATHERS = {"mamba": (4, 0), "mlstm": (3, 0), "slstm": (2, 0)}


@pytest.mark.parametrize("block", sorted(REDUCES))
def test_all_reduces_a_block(runs, block):
    assert tuple(runs[f"reduces/{block}"]) == REDUCES[block]


@pytest.mark.parametrize("block", sorted(GATHERS))
def test_all_gathers_a_block(runs, block):
    assert tuple(runs[f"gathers/{block}"]) == GATHERS[block]


@pytest.mark.parametrize("tag", ["zamba2", "xlstm"])
def test_whole_row_out_norm_serves_as_one_device(runs, tag):
    for i in range(DECODE + 1):
        np.testing.assert_allclose(runs[f"{tag}/serve{i}"],
                                   runs[f"one_{tag}/serve{i}"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_builds_under_a_model_axis(runs, arch):
    assert int(runs["built/" + arch]) > 0


# (tag, leaf): its placements on the ("data", "model") mesh
PLACED = [
    ("mixtral", "sub0/moe/w_up", ("R", "S(1)")),
    ("mixtral", "sub0/moe/w_down", ("R", "S(1)")),
    ("mixtral", "sub0/moe/router", ("R", "R")),
    ("mixtral_e3", "sub0/moe/w_up", ("R", "S(3)")),
    ("mixtral_e3", "sub0/moe/w_down", ("R", "S(2)")),
    ("maverick", "sub1/moe/shared/w_up", ("R", "S(2)")),
    ("phi", "vision_proj", ("R", "R")),
    ("phi", "embed/table", ("R", "S(0)")),
    ("zamba2", "mamba/w_in", ("R", "S(2)")),
    ("zamba2", "mamba/out_norm/scale", ("R", "R")),
    ("zamba2", "shared0/concat_proj", ("R", "R")),
    ("xlstm", "mlstm/w_up", ("R", "S(2)")),
    ("xlstm", "slstm/r_gates", ("R", "S(2)")),
    ("whisper511", "embed/table", ("R", "R")),
    ("whisper511", "dec/cross_attn/wq", ("R", "S(2)")),
]


@pytest.mark.parametrize("tag,leaf,want", PLACED)
def test_placements_under_a_model_axis(runs, tag, leaf, want):
    assert tuple(runs[f"{tag}/pl/{leaf}"]) == want


def test_moe_checkpoint_restores_at_another_mesh(runs):
    got, want = _sub(runs, "restored/"), _sub(runs, "saved/")
    assert got.keys() == want.keys() and any("moe" in k for k in got)
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not differ, differ[:5]


def test_activation_context_reaches_other_threads():
    """A CUDA device's backward runs on an autograd thread, where a
    checkpointed layer is recomputed: the activation constraints must be
    active there too, or the recompute places (and shapes) its
    activations otherwise than the forward did."""
    import threading

    from repro_torch.distributed import sharding
    rules = {"batch": ("data",)}
    seen = []
    with sharding.activation_sharding({"data": 1, "model": 2}, rules):
        t = threading.Thread(target=lambda: seen.append(
            sharding.current_rules()))
        t.start()
        t.join()
    assert seen == [rules] and sharding.current_rules() is None
