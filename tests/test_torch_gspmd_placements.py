"""Every placement the JAX package's policy (``launch/mesh.py``
``cell_parallel``) can choose, executed by the port's GSPMD steps on the
CPU (f32 compute, gloo), held against the JAX package's GSPMD steps
with the same ``ParallelConfig`` and against the port's one-device
steps, from the same weights (the port's draw, carried into JAX with
``interop.params_to_jax``).

JAX's side runs in one subprocess on 4 virtual devices, on meshes built
with ``AxisType.Auto`` axes (its train step is the JAX package's
``make_train_step(model, optimizer, train_cfg, mesh, rules,
grad_constraint, param_shardings, microbatches)`` with ZeRO-1's
gradient shardings, as ``launch/dryrun.py:lower_cell`` builds it). The
port's side is one spawn of 4 gloo workers and one of 2, both with
``OMP_NUM_THREADS=1``, through ``build_train_setup(parallel=...)`` and
``build_gspmd_serve_setup(parallel=...)``.

1. Training, 3 steps (``TRAIN``): FSDP ("embed" over "data") at (2, 1)
   and FSDP x TP x ZeRO-1 at (2, 2) for the reduced llama3.2-1b (the
   latter also with the bf16 wire), the reduced mixtral under FSDP x EP
   x ZeRO-1 at (2, 2), the reduced ResNet-50 under ``fsdp_params``
   ("conv_out" over "data") at (2, 1), llama4's fallback ("embed" on
   "model": 3 heads on 1 kv head, which do not divide 2) at (1, 2),
   ``microbatches=2`` at (2, 1) and (1, 2), and LARS under TP (the LM at
   (1, 2)), under FSDP and under ZeRO-1 (ResNet-50 at (2, 1)) and under
   FSDP x TP x ZeRO-1 (the LM at (2, 2)). Losses within rtol 2e-5 of
   JAX's GSPMD step and of the port's one-device step, each leaf within
   2e-4 relative norm; a microbatched run's metrics (the mean of its
   microbatches') within rtol 1e-5 of the whole batch's; LARS's trust
   ratios (whole-leaf norms, summed over the shards) within rtol 1e-5
   of the one-device step's. Three measured bounds: ResNet-50's of
   ``test_torch_gspmd.py`` (``CONV_TREE_TOL``, ``CONV_LEAF_TOL``),
   mixtral's token table against the one-device step
   (``MOE_TABLE_TOL``: JAX's own GSPMD step is 3.5e-4 from it), and
   LARS's, each leaf against its own steps (``LARS_STEP_TOL``).
2. Each worker's FSDP parameter shards: a quarter of every leaf whose
   dims divide at (2, 2), and the master parameters stay sharded.
3. Serving (``SERVE``): a prefill of 32 tokens and 4 greedy decode
   steps under sequence parallelism ("seq" on "model", batch 1) with
   the cache's positions on "model" ("kv_seq": one kv head) for the
   reduced granite-34b (``cell_parallel`` of the full config), zamba2
   and whisper (1 kv head), and llama4-maverick under its
   ``serve_fsdp`` at (2, 2): logits within 5e-4 of JAX's with the mesh,
   the same greedy tokens; each worker's cache holds half of the
   positions.
4. A GSPMD checkpoint saved under FSDP x TP x ZeRO-1 at (2, 2) restores
   at (1, 2) bitwise, and the JAX package's ``restore`` reads the same
   arrays.
5. DTensor's own all-gather, reduce-scatter and all-to-all are counted
   while the steps run and must not run (every placement change goes
   through ``sharding.redistribute``: gloo crashes on DTensor's
   all-gather of a CUDA tensor). A token lookup of a table whose
   "embed" columns split (FSDP) equals the plain lookup.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from repro.checkpoint import restore as jrestore

from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import build_model as tbuild

ROOT = os.path.join(os.path.dirname(__file__), "..")
STEPS, SEQ, SPE, DECODE = 3, 32, 4, 4
LOSS_RTOL, PARAM_TOL, METRIC_RTOL, TRUST_RTOL, LOGIT_TOL = (
    2e-5, 2e-4, 1e-5, 1e-5, 5e-4)
# ResNet-50's measured bounds of tests/test_torch_gspmd.py (the whole
# tree, its worst leaf): its BN biases start at 0, and the RMSprop
# warm-up carries a flip of a tiny gradient into them (its one-device
# step is 2.9e-2 from JAX's on stem/bn/bias)
CONV_TREE_TOL, CONV_LEAF_TOL = 1e-3, 1e-1
# mixtral's token table against the one-device step: the JAX package's
# own GSPMD step is 3.5e-4 from it there (the rows of tokens the batch
# barely reaches, which the RMSprop warm-up moves by ~lr where their
# gradient's sign flips), the port's 2.4e-4; the whole tree and every
# other leaf are held to 2e-4
MOE_TABLE, MOE_TABLE_TOL = "embed/table", 5e-4
# LARS moves a leaf by about eta x trust_coef of its norm a step (2.7e-6
# to 5.6e-5 of it over these 3 steps), under PARAM_TOL and the conv
# bounds, which would pass an update never applied. So a LARS case holds
# each leaf's distance from its reference to LARS_STEP_TOL of the
# reference's own distance from the initial weights (an update not
# applied reads 1, one of the wrong sign 2). Measured: 8.8e-4 at worst
# (lars_tp12 and lars_fsdp_tp_zero22 against JAX's step), 1.2e-4
# against the one-device step
LARS_STEP_TOL = 1e-2
DENSE = "llama3.2-1b"
P_FSDP = dict(dp_axes=("data",), tp_axis="model", zero_1=False,
              fsdp_params=True, compression="none")
P_TP = dict(dp_axes=("data",), tp_axis="model", zero_1=False,
            compression="none")
P_ZERO = dict(P_FSDP, zero_1=True)
# tag: (arch, config changes, mesh, global batch, ParallelConfig fields,
# microbatches, optimizer kind)
TRAIN = {
    "fsdp21": (DENSE, {}, (2, 1), 4, P_FSDP, 1, "rmsprop_warmup"),
    "fsdp_tp_zero22": (DENSE, {}, (2, 2), 4, P_ZERO, 1, "rmsprop_warmup"),
    "fsdp_tp_zero22_bf16": (DENSE, {}, (2, 2), 4,
                            dict(P_ZERO, compression="bf16"), 1,
                            "rmsprop_warmup"),
    "mixtral22": ("mixtral-8x7b", {}, (2, 2), 4, P_ZERO, 1,
                  "rmsprop_warmup"),
    "resnet_fsdp21": ("resnet50", {}, (2, 1), 8, P_FSDP, 1,
                      "rmsprop_warmup"),
    "fallback12": (DENSE, {"n_heads": 3, "n_kv_heads": 1}, (1, 2), 4, P_TP,
                   1, "rmsprop_warmup"),
    "mb21": (DENSE, {}, (2, 1), 4, P_ZERO, 2, "rmsprop_warmup"),
    "mb12": (DENSE, {}, (1, 2), 4, P_TP, 2, "rmsprop_warmup"),
    "lars_tp12": (DENSE, {}, (1, 2), 4, P_TP, 1, "lars"),
    "lars_fsdp21": ("resnet50", {}, (2, 1), 8, P_FSDP, 1, "lars"),
    "lars_zero21": ("resnet50", {}, (2, 1), 8,
                    dict(P_TP, zero_1=True), 1, "lars"),
    "lars_fsdp_tp_zero22": (DENSE, {}, (2, 2), 4, P_ZERO, 1, "lars"),
}
LARS = sorted(tag for tag, case in TRAIN.items() if case[6] == "lars")
# a microbatched run and the run on the whole batch it is held to
MICRO = {"mb21": "fsdp21_zero", "mb12": "tp12"}
P_SP = dict(dp_axes=("data",), tp_axis="model", zero_1=False,
            compression=None, remat="none", sequence_sharding=True,
            kv_seq_sharding=True)
# tag: (arch, config changes, mesh, batch, ParallelConfig fields or
# None: cell_parallel of the full config at a prefill of the batch)
SERVE = {
    "sp_granite": ("granite-34b", {}, (1, 2), 1, None),
    "sp_zamba2": ("zamba2-7b", {"n_kv_heads": 1}, (1, 2), 1, P_SP),
    "sp_whisper": ("whisper-tiny", {"n_kv_heads": 1}, (1, 2), 1, P_SP),
    "maverick22": ("llama4-maverick-400b-a17b", {}, (2, 2), 2, None),
}
# each (arch, config changes) of the cases, its weights drawn once
CONFIGS = list({(c[0], tuple(sorted(c[1].items()))): (c[0], c[1])
                for c in list(TRAIN.values()) + list(SERVE.values())
                }.values())


def _config_key(arch, changes):
    return arch + "".join(f"_{k}{v}" for k, v in sorted(changes.items()))


_COMMON = """
import dataclasses, os, sys
import numpy as np
out_dir = sys.argv[1]
TRAIN, SERVE, DENSE = {train!r}, {serve!r}, {dense!r}
out = {{}}

def config_key(arch, changes):
    return arch + "".join(f"_{{k}}{{v}}" for k, v in sorted(changes.items()))

def config(arch, changes):
    return dataclasses.replace(reduced_config(get_config(arch)), **changes)

def parallel(arch, batch, fields):
    if fields is None:  # the policy of the full config's prefill
        return cell_parallel(get_config(arch),
                             ShapeConfig("prefill", {seq}, batch, "prefill"))
    return ParallelConfig(**fields)

def opt_config(kind):
    return OptimizerConfig(kind=kind)
"""

_JAX = _COMMON + """
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import (OptimizerConfig, ParallelConfig, ShapeConfig,
                           TrainConfig, get_config, reduced_config)
from repro.data import make_data
from repro.distributed.sharding import make_rules, prune_spec, tree_shardings
from repro.launch.mesh import cell_parallel
from repro.models import build_model, init_model_state
from repro.models.common import unbox
from repro.optim import make_optimizer
from repro.optim.zero import zero_shardings
from repro.training.step import (make_decode_step, make_prefill_step,
                                 make_train_step)

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

def make_mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])

def setup(arch, changes):
    cfg = config(arch, changes)
    model = build_model(cfg, compute_dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    if cfg.family == "conv":
        _, axes = model.init_params(key)
    else:
        axes = unbox(jax.eval_shape(model.init, key))[1]
    init = nest(dict(np.load(f"{{out_dir}}/init_{{config_key(arch, changes)}}"
                            ".npz")))
    return cfg, model, init, axes

def train(tag, arch, changes, shape, batch, fields, mb, kind):
    cfg, model, params, axes = setup(arch, changes)
    mesh, par = make_mesh(shape), ParallelConfig(**fields)
    rules = make_rules(cfg, mesh, par)
    p_shard = tree_shardings(axes, mesh, rules)
    opt_cfg = opt_config(kind)
    optimizer = make_optimizer(opt_cfg, {spe}, batch)
    specs = jax.tree.map(lambda s: s.spec, p_shard,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    repl = NamedSharding(mesh, P())
    grad_constraint = None
    fields_shard = p_shard
    if par.zero_1:
        fields_shard = zero_shardings(params, specs, mesh, par.dp_axes)
        grad_constraint = lambda g: jax.lax.with_sharding_constraint(
            g, fields_shard)
    opt = optimizer.init(params)
    state = {{"params": params, "opt": opt,
              "model_state": init_model_state(model)}}
    shard = {{"params": p_shard,
              "opt": {{f: (fields_shard if isinstance(v, dict) else repl)
                      for f, v in opt.items()}},
              "model_state": jax.tree.map(lambda _: repl,
                                          state["model_state"])}}
    state = jax.device_put(state, shard)
    step = jax.jit(make_train_step(
        model, optimizer, TrainConfig(optimizer=opt_cfg, parallel=par),
        mesh, rules, grad_constraint, param_shardings=p_shard,
        microbatches=mb))
    data = make_data(cfg, ShapeConfig("train", {seq}, batch, "train"))
    rows = NamedSharding(mesh, P(par.dp_axes))
    losses = []
    for i in range({steps}):
        b = {{k: jax.device_put(v, rows if np.ndim(v) else None)
             for k, v in data.batch_at(i).items()}}
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    out[tag + "/loss"] = np.asarray(losses)
    out.update({{f"{{tag}}/p/{{k}}": v
                for k, v in flat(state["params"]).items()}})

def serve(tag, arch, changes, shape, batch, fields):
    cfg, model, params, axes = setup(arch, changes)
    mesh, par = make_mesh(shape), parallel(arch, batch, fields)
    rules = make_rules(cfg, mesh, par)
    p0 = jax.device_put(params, tree_shardings(axes, mesh, rules))
    cache, c_axes = model.cache_shape(batch, {seq} + {decode}, jnp.float32)
    csh = jax.tree.map(
        lambda v, s: NamedSharding(mesh, prune_spec(v.shape, s.spec, mesh)),
        cache, tree_shardings(c_axes, mesh, rules),
        is_leaf=lambda x: isinstance(x, NamedSharding))
    cache = jax.device_put(cache, csh)
    prefill = jax.jit(make_prefill_step(model, mesh, rules),
                      out_shardings=(None, csh))
    decode = jax.jit(make_decode_step(model, mesh, rules),
                     out_shardings=(None, csh))
    b = make_data(cfg, ShapeConfig("train", {seq}, batch, "train")
                  ).batch_at(0)
    logits, cache = prefill(p0, cache, {{k: jnp.asarray(v) for k, v in
                                        b.items() if k != "targets"}})
    out[f"{{tag}}/serve0"] = np.asarray(logits)
    for i in range({decode}):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        logits, cache = decode(p0, cache, {{"tokens": tok,
                                           "cache_index": {seq} + i}})
        out[f"{{tag}}/serve{{i + 1}}"] = np.asarray(logits)

for tag, case in TRAIN.items():
    try:
        train(tag, *case)
    except Exception as e:  # a limit of the reference: held elsewhere
        out[tag + "/raised"] = np.asarray(repr(e)[:200])
for tag, case in SERVE.items():
    try:
        serve(tag, *case)
    except Exception as e:
        out[tag + "/raised"] = np.asarray(repr(e)[:200])
np.savez(f"{{out_dir}}/jax.npz", **out)
"""

# one gloo worker of n: its runs, then (worker 0, after the group is
# shut down) the one-device steps of the same cases
_WORKER = _COMMON + """
import torch
import torch.distributed as dist
from repro_torch import interop
from repro_torch.checkpoint import restore, save
from repro_torch.configs import (OptimizerConfig, ParallelConfig,
                                 ShapeConfig, get_config, reduced_config)
from repro_torch.data import make_data
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.mesh import cell_parallel
from repro_torch.launch.serve import (build_gspmd_serve_setup,
                                      build_serve_setup)
from repro_torch.launch.train import build_train_setup
from repro_torch.training.gspmd import gather_tree, place_cache
from repro_torch.training.step import make_decode_step, make_prefill_step
rank, n = int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
init_workers("cpu", init_method=f"file://{{out_dir}}/store{{n}}", rank=rank,
             world_size=n)

# DTensor's own all-gathers, reduce-scatters and all-to-alls, counted
# while the steps run (gloo crashes on them with CUDA tensors)
from repro_torch.distributed.sharding import count_dtensor_collectives
from repro_torch.optim.lars import tape_trust_ratios
calls = count_dtensor_collectives()

def train(key, arch, changes, shape, batch, fields, mb, kind, **kw):
    cfg = config(arch, changes)
    build = dict(global_batch=batch, seq_len={seq},
                 opt_cfg=opt_config(kind), steps_per_epoch={spe},
                 microbatches=mb, device="cpu", **kw)
    if shape is None:
        build["compression"] = fields["compression"]
    else:
        build.update(dp_mode="gspmd", mesh_shape=shape,
                     parallel=ParallelConfig(**fields))
    _, s, step, data, _, sh = build_train_setup(cfg, **build)
    losses, metrics = [], []
    calls.update(n=0, on=True)
    with tape_trust_ratios() as trusts:  # LARS's, leaf by leaf
        for i in range({steps}):
            s, met = step(s, data.batch_at(i))
            losses.append(float(met["loss"]))
            metrics.append([float(met[k]) for k in sorted(met)
                            if k in ("loss", "moe_aux")])
    calls["on"] = False
    if sh is not None:
        params = gather_tree(s["params"])
        local = {{k: p.to_local().numel() for k, p in s["params"].items()}}
        local = {{interop.flat_name(k): v for k, v in local.items()}}
    else:
        params, local = s["params"], {{}}
    if rank == 0:
        out[key + "/loss"] = np.asarray(losses)
        out[key + "/metrics"] = np.asarray(metrics)
        out[key + "/dtensor_collectives"] = np.asarray(calls["n"])
        out[key + "/trust"] = np.asarray(trusts)
        tree = interop._flatten(interop.params_to_jax(  # JAX's layouts
            {{k: v.detach() for k, v in params.items()}}))
        for k, v in tree.items():
            out[f"{{key}}/p/{{k}}"] = np.asarray(v).copy()
        for k, v in local.items():
            out[f"{{key}}/local/{{k}}"] = np.asarray(v)
    return s, sh

def serve(key, arch, changes, shape, batch, fields):
    cfg = config(arch, changes)
    if shape is None:
        model, params = build_serve_setup(cfg, compute_dtype=torch.float32,
                                          device="cpu")
        mesh = rules = None
    else:
        model, params, mesh, rules = build_gspmd_serve_setup(
            cfg, shape, compute_dtype=torch.float32, device="cpu",
            parallel=parallel(arch, batch, fields))
    cache, axes = model.cache_shape(batch, {seq} + {decode}, torch.float32)
    if mesh is not None:
        cache = place_cache(cache, axes, mesh, rules)
        if rank == 0:
            for k, v in cache.items():
                if "k" in k.split("/")[-1]:
                    out[f"{{key}}/positions/{{k}}"] = np.asarray(
                        [v.to_local().shape[2], v.shape[2]])
    prefill = make_prefill_step(model, mesh, rules)
    decode = make_decode_step(model, mesh, rules)
    b = {{k: torch.as_tensor(np.asarray(v)) for k, v in make_data(
        cfg, ShapeConfig("train", {seq}, batch, "train")).batch_at(
        0).items() if k != "targets"}}
    calls.update(n=0, on=True)
    with torch.no_grad():
        logits, cache = prefill(params, cache, b)
        got = [logits]
        for i in range({decode}):
            tok = logits[:, -1].argmax(-1)[:, None].int()
            logits, cache = decode(params, cache, {{"tokens": tok,
                                                   "cache_index": {seq} + i}})
            got.append(logits)
    calls["on"] = False
    if rank == 0:
        out[key + "/dtensor_collectives"] = np.asarray(calls["n"])
        for i, lg in enumerate(got):
            out[f"{{key}}/serve{{i}}"] = lg.numpy().copy()

def mine(case):
    return case[2][0] * case[2][1] == n

for tag, case in TRAIN.items():
    if not mine(case):
        continue
    s, sh = train(tag, *case)
    if tag == "fsdp_tp_zero22":  # the checkpoint, restored at (1, 2)
        tree = interop.train_state_to_jax(s, sh)
        if rank == 0:
            save(os.path.join(out_dir, "ck"), {steps}, tree)
            for key in ("params", "opt"):
                for k, v in interop._flatten(tree[key]).items():
                    out[f"saved/{{key}}/{{k}}"] = np.asarray(v)
        dist.barrier()
        if rank == 0:
            open(os.path.join(out_dir, "ck_done"), "w").close()
for tag, case in SERVE.items():
    if mine(case):
        serve(tag, *case)
if n == 2:
    # the whole-batch runs of the microbatched ones (and of their
    # placements at the other mesh), and an FSDP table's token lookup
    train("fsdp21_zero", DENSE, {{}}, (2, 1), 4,
          dict(TRAIN["fsdp21"][4], zero_1=True), 1, "rmsprop_warmup")
    train("tp12", DENSE, {{}}, (1, 2), 4, TRAIN["mb12"][4], 1,
          "rmsprop_warmup")
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.process_group import device_mesh
    from repro_torch.distributed.sharding import distribute_local
    from repro_torch.models import layers
    mesh = device_mesh((2, 1), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    table = torch.randn(64, 16, generator=g)
    tokens = torch.randint(0, 64, (4, 8), generator=g)
    x = layers._sharded_lookup(
        distribute_local(table, mesh, (Shard(1), Replicate())),
        distribute_local(tokens, mesh, (Shard(0), Replicate())))
    x = gather_tree({{"x": x}})["x"]
    if rank == 0:
        out["lookup"] = np.asarray(float((x - table[tokens]).abs().max()))
    # the (2, 2) FSDP checkpoint restored at (1, 2)
    import time
    while not os.path.exists(os.path.join(out_dir, "ck_done")):
        time.sleep(0.2)
    _, s, _, _, _, sh = build_train_setup(
        config(DENSE, {{}}), global_batch=4, seq_len={seq},
        opt_cfg=OptimizerConfig(), steps_per_epoch={spe}, device="cpu",
        dp_mode="gspmd", mesh_shape=(1, 2),
        parallel=ParallelConfig(**TRAIN["fsdp_tp_zero22"][4]))
    arrays, _ = restore(os.path.join(out_dir, "ck"))
    interop.train_state_from_jax(arrays, s, sh)
    back = interop.train_state_to_jax(s, sh)
    if rank == 0:
        for key in ("params", "opt"):
            for k, v in interop._flatten(back[key]).items():
                out[f"restored/{{key}}/{{k}}"] = np.asarray(v)
shutdown()
if rank == 0:
    for tag, case in TRAIN.items():
        if mine(case):
            arch, changes, _, batch, fields, mb, kind = case
            train("one_" + tag, arch, changes, None, batch, fields, mb,
                  kind, dp_mode="none")
    for tag, case in SERVE.items():
        if mine(case):
            serve("one_" + tag, case[0], case[1], None, case[3], case[4])
    np.savez(os.path.join(out_dir, f"port{{n}}.npz"), **out)
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
    """Every run's numbers: JAX's (one subprocess) and the port's (a
    spawn of 4 workers and one of 2, at the same time)."""
    out_dir = tmp_path_factory.mktemp("gspmd_placements")
    for arch, changes in CONFIGS:
        cfg = dataclasses.replace(treduced(tget(arch)), **changes)
        model = tbuild(cfg, compute_dtype=torch.float32, device="cpu")
        params, _ = (model.init_params() if cfg.family == "conv"
                     else model.init_params(0))
        np.savez(out_dir / f"init_{_config_key(arch, changes)}.npz",
                 **interop._flatten(interop.params_to_jax(params)))
    fmt = dict(train=TRAIN, serve=SERVE, dense=DENSE, seq=SEQ, spe=SPE,
               steps=STEPS, decode=DECODE)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX.format(**fmt), str(out_dir)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    body = _WORKER.format(**fmt)
    workers = [subprocess.Popen([sys.executable, "-c", body, str(out_dir),
                                 str(r), str(n)], env=_env(),
                                stderr=subprocess.PIPE, text=True)
               for n in (4, 2) for r in range(n)]
    _wait(workers)
    _wait([jax_proc])
    out = {"jax": dict(np.load(out_dir / "jax.npz")), "dir": out_dir}
    for n in (4, 2):
        out.update(np.load(out_dir / f"port{n}.npz"))
    return out


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


def _start(runs, tag):
    """The initial weights of a LARS case (JAX's layouts), else None."""
    arch, changes = TRAIN[tag][:2]
    if TRAIN[tag][6] != "lars":
        return None
    return dict(np.load(runs["dir"] / f"init_{_config_key(arch, changes)}"
                                      ".npz"))


def _assert_leaves(tag, got, want, loose=(), start=None):
    """Each leaf within ``PARAM_TOL`` relative norm (the ``loose`` ones
    within ``MOE_TABLE_TOL``); ResNet-50's within its measured bounds;
    with ``start`` (LARS) each leaf within ``LARS_STEP_TOL`` of its own
    steps from ``start``."""
    assert got.keys() == want.keys() and got
    if start is not None:
        step = {k: float(np.linalg.norm((got[k].astype(np.float64)
                                         - want[k]).ravel())
                         / np.linalg.norm((want[k].astype(np.float64)
                                           - start[k]).ravel()))
                for k in want}
        worst = max(step, key=step.get)
        assert step[worst] <= LARS_STEP_TOL, (worst, step[worst])
        return
    rel = {k: float(np.linalg.norm((got[k] - want[k]).ravel())
                    / max(np.linalg.norm(want[k].ravel()), 1e-30))
           for k in want}
    if TRAIN[tag][0] == "resnet50":
        num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
                  for k in want)
        den = sum(float(np.sum(want[k].astype(np.float64) ** 2))
                  for k in want)
        assert (num / den) ** 0.5 <= CONV_TREE_TOL, (num / den) ** 0.5
        assert max(rel.values()) <= CONV_LEAF_TOL, max(rel.values())
        return
    held = {k: rel.pop(k) for k in loose}
    assert all(v <= MOE_TABLE_TOL for v in held.values()), held
    worst = max(rel, key=rel.get)
    assert rel[worst] <= PARAM_TOL, (worst, rel[worst])


@pytest.mark.parametrize("tag", sorted(TRAIN))
def test_gspmd_step_matches_jax_gspmd(runs, tag):
    jax_out = runs["jax"]
    assert f"{tag}/raised" not in jax_out, jax_out.get(f"{tag}/raised")
    np.testing.assert_allclose(runs[f"{tag}/loss"], jax_out[f"{tag}/loss"],
                               rtol=LOSS_RTOL)
    _assert_leaves(tag, _sub(runs, f"{tag}/p/"), _sub(jax_out, f"{tag}/p/"),
                   start=_start(runs, tag))


@pytest.mark.parametrize("tag", sorted(TRAIN))
def test_gspmd_step_matches_the_one_device_step(runs, tag):
    np.testing.assert_allclose(runs[f"{tag}/loss"], runs[f"one_{tag}/loss"],
                               rtol=LOSS_RTOL)
    loose = [MOE_TABLE] if TRAIN[tag][0] == "mixtral-8x7b" else []
    _assert_leaves(tag, _sub(runs, f"{tag}/p/"), _sub(runs, f"one_{tag}/p/"),
                   loose, _start(runs, tag))


@pytest.mark.parametrize("tag", sorted(TRAIN) + sorted(SERVE))
def test_steps_call_no_dtensor_collective(runs, tag):
    """DTensor's all-gather of a CUDA tensor crashes gloo (the card's
    multi-process paths): the steps move placements by all-reduces,
    list all-gathers and local slices (``sharding.redistribute``)."""
    assert int(runs[f"{tag}/dtensor_collectives"]) == 0


@pytest.mark.parametrize("tag", sorted(MICRO))
def test_microbatch_metrics_are_the_whole_batch_mean(runs, tag):
    np.testing.assert_allclose(runs[f"{tag}/metrics"],
                               runs[f"{MICRO[tag]}/metrics"],
                               rtol=METRIC_RTOL)
    _assert_leaves(tag, _sub(runs, f"{tag}/p/"),
                   _sub(runs, f"{MICRO[tag]}/p/"))


@pytest.mark.parametrize("tag", LARS)
def test_lars_trust_ratios_are_whole_leaf(runs, tag):
    got, want = runs[f"{tag}/trust"], runs[f"one_{tag}/trust"]
    assert got.shape == want.shape and got.size
    assert not np.allclose(got, 1.0)
    np.testing.assert_allclose(got, want, rtol=TRUST_RTOL)


# at (2, 2) a leaf with no dim on the model axis (a norm's scale, the
# MoE router's columns) is split over "data" alone
HALVED = ("norm", "router")


@pytest.mark.parametrize("tag", ["fsdp_tp_zero22", "mixtral22"])
def test_fsdp_keeps_a_quarter_of_each_leaf(runs, tag):
    """At (2, 2) the master parameters stay sharded between the steps:
    a worker holds a quarter of every leaf split over both axes (FSDP's
    "embed" over "data" beside TP / EP over "model"), half of those with
    no dim on "model"."""
    local = _sub(runs, f"{tag}/local/")
    whole = _sub(runs, f"{tag}/p/")
    assert local.keys() == whole.keys() and local
    for k in whole:
        split = 2 if any(h in k for h in HALVED) else 4
        assert int(local[k]) * split == whole[k].size, (k, int(local[k]))


def test_resnet_fsdp_halves_each_conv_leaf(runs):
    """ResNet-50's "conv_out" over "data" at (2, 1): every conv kernel
    holds half its output channels on a worker."""
    local = _sub(runs, "resnet_fsdp21/local/")
    whole = _sub(runs, "resnet_fsdp21/p/")
    convs = [k for k in whole if whole[k].ndim == 4]
    assert convs
    for k in convs:
        assert int(local[k]) * 2 == whole[k].size, (k, int(local[k]))


@pytest.mark.parametrize("tag", sorted(SERVE))
def test_gspmd_serve_matches_jax(runs, tag):
    jax_out = runs["jax"]
    assert f"{tag}/raised" not in jax_out, jax_out.get(f"{tag}/raised")
    for i in range(DECODE + 1):
        got, want = runs[f"{tag}/serve{i}"], jax_out[f"{tag}/serve{i}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert np.array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))


@pytest.mark.parametrize("tag", sorted(SERVE))
def test_gspmd_serve_matches_one_device(runs, tag):
    for i in range(DECODE + 1):
        np.testing.assert_allclose(runs[f"{tag}/serve{i}"],
                                   runs[f"one_{tag}/serve{i}"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("tag", ["sp_granite", "sp_zamba2", "sp_whisper"])
def test_kv_seq_cache_holds_half_the_positions(runs, tag):
    held = _sub(runs, f"{tag}/positions/")
    assert held
    for k, (local, whole) in held.items():
        assert local * 2 == whole, (k, local, whole)


def test_fsdp_checkpoint_restores_at_another_mesh(runs):
    got, want = _sub(runs, "restored/"), _sub(runs, "saved/")
    assert got.keys() == want.keys() and got
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not differ, differ[:5]
    arrays, manifest = jrestore(str(runs["dir"] / "ck"))
    assert manifest["step"] == STEPS
    flat = {interop.flat_name(k): v for k, v in arrays.items()}
    for k, v in _sub(want, "params/").items():
        np.testing.assert_array_equal(np.asarray(flat["params/" + k]), v)


def test_lookup_of_an_embed_sharded_table(runs):
    assert float(runs["lookup"]) == 0.0
