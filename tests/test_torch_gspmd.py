"""The GSPMD step (``--dp-mode gspmd --mesh DxM``) against the JAX
package's GSPMD step and against the port's own one-device step, on the
CPU, 3 steps from the same weights (the port's draw, carried into JAX
with ``interop.params_to_jax``), f32 compute, the bf16 wire.

JAX's side runs in one subprocess on 8 virtual devices, on meshes built
with ``AxisType.Auto`` axes (in this JAX ``jax.make_mesh`` builds
Explicit ones, on which the JAX package's GSPMD step raises). The
port's workers are gloo processes that import only the port: one spawn
of 4 (the (2, 2) mesh, which saves a checkpoint), then one of 2 (every
other run, and the restore of that checkpoint at (1, 2)).

1. Reduced ResNet-50 at (2, 1), BN over the global batch, and reduced
   llama3.2-1b at (1, 2) (TP) and (2, 2) (DP x TP): losses within rtol
   2e-5 of JAX's GSPMD step, each parameter leaf within 2e-4 relative
   norm (``PARAM_TOL``); the same against the port's one-device step on
   the whole batch, where ResNet-50's BN statistics of the first step
   agree within rtol 1e-6 (of each site's largest magnitude). ResNet's
   parameters are held to the measured bounds ``CONV_TREE_TOL`` (the
   whole tree) and ``CONV_LEAF_TOL`` (its worst leaf): its BN biases
   start at 0, and after 3 steps a bf16 wire-rounding flip of one
   gradient element, moved by the RMSprop warm-up, is large beside their
   norm (measured: the tree 2.5e-4 from JAX's, the worst leaf,
   ``stem/bn/bias``, 2.8e-2; the port's one-device step is 2.9e-2 from
   JAX's on that leaf too). The summed gradients themselves agree with
   the one-device step's to 5e-6.
2. ZeRO-1 (``zero_1``: the gradients reduce-scattered to the optimizer
   state's placements, the update on the shards, the parameters
   gathered back) is bitwise the plain GSPMD step at 2 workers, for the
   LM and for ResNet-50.
3. Elastic restore: the (2, 2) run's checkpoint restores at (1, 2) into
   the same parameters and optimizer state, bitwise, and the JAX
   package's ``restore`` reads the same files.
4. The refusals of the GSPMD mode, and ``--dp-mode gspmd`` without a
   mesh is bitwise the one-device step. (The other families under a
   model axis: ``test_torch_gspmd_families.py``.)
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from repro.checkpoint import restore as jrestore

from repro_torch import interop
from repro_torch.configs import InputConfig
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model as tbuild

ROOT = os.path.join(os.path.dirname(__file__), "..")
STEPS, SEQ, SPE = 3, 32, 4
LOSS_RTOL, PARAM_TOL = 2e-5, 2e-4
CONV_TREE_TOL, CONV_LEAF_TOL = 1e-3, 1e-1
# the first step's BN statistics (test_torch_sync_bn.py's bound)
BN_RTOL = 1e-6
# tag: (arch, mesh, global batch)
CASES = {"conv21": ("resnet50", (2, 1), 8),
         "lm12": ("llama3.2-1b", (1, 2), 4),
         "lm22": ("llama3.2-1b", (2, 2), 4)}

_JAX = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, get_config, reduced_config
from repro.launch.train import build_train_setup
out_dir = sys.argv[1]
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

for tag, (arch, shape, batch) in {cases!r}.items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    _, state, step, data, put, sh = build_train_setup(
        reduced_config(get_config(arch)), global_batch=batch, seq_len={seq},
        opt_cfg=OptimizerConfig(), steps_per_epoch={spe}, mesh=mesh,
        dp_mode="gspmd", compression="bf16")
    init = dict(np.load(f"{{out_dir}}/init_{{arch}}.npz"))
    state["params"] = jax.device_put(nest(init), sh["params"])
    losses = []
    for i in range({steps}):
        state, met = step(state, put(data.batch_at(i)))
        losses.append(float(met["loss"]))
    out[tag + "/loss"] = np.asarray(losses)
    out.update({{f"{{tag}}/p/{{k}}": v
                for k, v in flat(state["params"]).items()}})
np.savez(f"{{out_dir}}/jax.npz", **out)
"""

# one gloo worker of n: every run of its spawn; params in the JAX
# package's layout (the gathered tree)
_WORKER = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import interop
from repro_torch.checkpoint import restore, save
from repro_torch.configs import OptimizerConfig, get_config, reduced_config
from repro_torch.distributed import init_workers, shutdown
from repro_torch.launch.train import build_train_setup
rank, out_dir, n = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
torch.set_num_threads(1)
init_workers("cpu", init_method=f"file://{{out_dir}}/store{{n}}", rank=rank,
             world_size=n)
cases = {cases!r}
out = {{}}

def setup(arch, batch, **kw):
    return build_train_setup(
        reduced_config(get_config(arch)), global_batch=batch,
        seq_len={seq}, opt_cfg=OptimizerConfig(), steps_per_epoch={spe},
        compression="bf16", device="cpu", **kw)

def run(tag, arch, batch, **kw):
    _, s, step, data, put, sh = setup(arch, batch, **kw)
    losses = []
    for i in range({steps}):
        batch = data.batch_at(i)
        s, met = step(s, put(batch) if put else batch)
        losses.append(float(met["loss"]))
        if i == 0 and rank == 0:  # the statistics of the first batch
            for site, rec in s["model_state"].items():
                for k in ("mean", "var"):
                    out[f"{{tag}}/bn1/{{site}}/{{k}}"] = rec[k].numpy().copy()
    tree = interop.train_state_to_jax(s, sh)
    if rank == 0:
        out[tag + "/loss"] = np.asarray(losses)
        for key in ("params", "opt"):
            for k, v in interop._flatten(tree[key]).items():
                out[f"{{tag}}/{{key}}/{{k}}"] = np.asarray(v)
    return s, sh

if n == 4:
    s, sh = run("lm22", *cases["lm22"][::2], dp_mode="gspmd",
                mesh_shape=cases["lm22"][1])
    tree = interop.train_state_to_jax(s, sh)
    if rank == 0:
        save(os.path.join(out_dir, "ck22"), {steps}, tree)
    dist.barrier()
else:
    run("conv21", *cases["conv21"][::2], dp_mode="gspmd",
        mesh_shape=cases["conv21"][1])
    run("lm12", *cases["lm12"][::2], dp_mode="gspmd",
        mesh_shape=cases["lm12"][1])
    for arch in ("llama3.2-1b", "resnet50"):
        for z in (False, True):
            run(f"zero{{int(z)}}_{{arch}}", arch, 4, dp_mode="gspmd",
                mesh_shape=(2, 1), zero_1=z)
    # the (2, 2) run's checkpoint, restored at (1, 2)
    _, s, _, _, _, sh = setup("llama3.2-1b", 4, dp_mode="gspmd",
                              mesh_shape=(1, 2))
    arrays, _ = restore(os.path.join(out_dir, "ck22"))
    interop.train_state_from_jax(arrays, s, sh)
    tree = interop.train_state_to_jax(s, sh)
    if rank == 0:
        for key in ("params", "opt"):
            for k, v in interop._flatten(tree[key]).items():
                out[f"restored/{{key}}/{{k}}"] = np.asarray(v)
    shutdown()
    if rank == 0:  # the one-device steps on the whole batches
        for tag in ("conv21", "lm12"):
            arch, _, batch = cases[tag]
            run("one_" + arch, arch, batch, dp_mode="none")
np.savez(os.path.join(out_dir, f"rank{{rank}}_{{n}}.npz"), **out)
shutdown()
"""


def _env(**extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "OMP_NUM_THREADS": "1", **extra}


def _spawn(out_dir, n):
    body = _WORKER.format(cases=CASES, seq=SEQ, spe=SPE, steps=STEPS)
    return [subprocess.Popen([sys.executable, "-c", body, str(r),
                              str(out_dir), str(n)], env=_env(),
                             stderr=subprocess.PIPE, text=True)
            for r in range(n)]


def _wait(procs, timeout=400):
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's losses and state, in the JAX layout: JAX's (one
    subprocess), the port's 4-worker spawn, then its 2-worker spawn."""
    out_dir = tmp_path_factory.mktemp("gspmd")
    for arch in ("resnet50", "llama3.2-1b"):
        cfg = treduced(tget(arch))
        model = tbuild(cfg, compute_dtype=torch.float32, device="cpu")
        params, _ = (model.init_params() if cfg.family == "conv"
                     else model.init_params(0))
        np.savez(out_dir / f"init_{arch}.npz",
                 **interop._flatten(interop.params_to_jax(params)))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX.format(cases=CASES, seq=SEQ, spe=SPE,
                                           steps=STEPS), str(out_dir)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _wait(_spawn(out_dir, 4))
    _wait(_spawn(out_dir, 2))
    _wait([jax_proc])
    out = {"jax": dict(np.load(out_dir / "jax.npz")), "dir": out_dir}
    for n in (4, 2):
        out.update(np.load(out_dir / f"rank0_{n}.npz"))
    return out


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


def _worst_leaf(got, want):
    assert got.keys() == want.keys() and got
    return max(float(np.linalg.norm((got[k] - want[k]).ravel())
                     / max(np.linalg.norm(want[k].ravel()), 1e-30))
               for k in want)


def _assert_params(arch, got, want):
    """Each leaf within ``PARAM_TOL``; ResNet-50's within its measured
    bounds (the module docstring)."""
    worst = _worst_leaf(got, want)
    if arch != "resnet50":
        assert worst <= PARAM_TOL, worst
        return
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    assert (num / den) ** 0.5 <= CONV_TREE_TOL, (num / den) ** 0.5
    assert worst <= CONV_LEAF_TOL, worst


@pytest.mark.parametrize("tag", sorted(CASES))
def test_gspmd_step_matches_jax_gspmd(runs, tag):
    np.testing.assert_allclose(runs[f"{tag}/loss"],
                               runs["jax"][f"{tag}/loss"], rtol=LOSS_RTOL)
    _assert_params(CASES[tag][0], _sub(runs, f"{tag}/params/"),
                   _sub(runs["jax"], f"{tag}/p/"))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_gspmd_step_matches_the_one_device_step(runs, tag):
    arch = CASES[tag][0]
    np.testing.assert_allclose(runs[f"{tag}/loss"],
                               runs[f"one_{arch}/loss"], rtol=LOSS_RTOL)
    _assert_params(arch, _sub(runs, f"{tag}/params/"),
                   _sub(runs, f"one_{arch}/params/"))
    if arch == "resnet50":  # BN over the global batch, the first step's
        bn = _sub(runs, f"{tag}/bn1/")
        want = _sub(runs, f"one_{arch}/bn1/")
        assert bn.keys() == want.keys() and bn
        for k, v in want.items():
            np.testing.assert_allclose(bn[k], v, rtol=BN_RTOL,
                                       atol=BN_RTOL * np.abs(v).max())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "resnet50"])
def test_zero_1_is_bitwise_the_gspmd_step(runs, arch):
    a, b = _sub(runs, f"zero1_{arch}/"), _sub(runs, f"zero0_{arch}/")
    assert a.keys() == b.keys() and any("delta" in k for k in a)
    differ = [k for k in b if not np.array_equal(a[k], b[k])]
    assert not differ, differ[:5]


def test_checkpoint_restores_at_another_mesh(runs):
    got, want = _sub(runs, "restored/"), _sub(runs, "lm22/")
    want = {k: v for k, v in want.items() if k.startswith(("params",
                                                           "opt"))}
    assert got.keys() == want.keys() and any("delta" in k for k in got)
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not differ, differ[:5]


def test_jax_package_restores_the_gspmd_checkpoint(runs):
    arrays, manifest = jrestore(str(runs["dir"] / "ck22"))
    assert manifest["step"] == STEPS
    flat = {interop.flat_name(k): v for k, v in arrays.items()}
    want = _sub(runs, "lm22/params/")
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(flat["params/" + k]), v)


def _build(arch="llama3.2-1b", **kw):
    return tlaunch.build_train_setup(
        treduced(tget(arch)), global_batch=4, seq_len=SEQ,
        opt_cfg=TOpt(), steps_per_epoch=SPE, device="cpu", **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(overlap_comm=True), "overlap_comm"),
    (dict(zero_dp=True), "--zero"),
    (dict(error_feedback=True), "error_feedback"),
    (dict(hier_split=1, mesh_shape=(2, 2)), "hier_split"),
    (dict(input_cfg=InputConfig(fused=True), arch="resnet50"),
     "fused input"),
])
def test_gspmd_refuses_the_explicit_dp_options(kw, match):
    with pytest.raises(ValueError, match=match):
        _build(dp_mode="gspmd", **kw)


def test_zero_1_needs_the_gspmd_mode_on_a_mesh():
    with pytest.raises(ValueError, match="zero_1"):
        _build(dp_mode="gspmd", zero_1=True)
    with pytest.raises(ValueError, match="zero_1"):
        _build(dp_mode="none", zero_1=True)


def test_shardmap_refuses_a_model_axis_without_a_hierarchy():
    with pytest.raises(NotImplementedError, match="dp-mode gspmd"):
        _build(dp_mode="shardmap", mesh_shape=(1, 2))


def test_gspmd_without_a_mesh_is_the_one_device_step():
    got = {}
    for mode in ("gspmd", "none"):
        _, s, step, data, put, sh = _build(dp_mode=mode)
        assert sh is None
        losses = []
        for i in range(2):
            s, met = step(s, data.batch_at(i))
            losses.append(float(met["loss"]))
        got[mode] = (losses, {k: v.clone() for k, v in s["params"].items()})
    assert got["gspmd"][0] == got["none"][0]
    assert all(torch.equal(v, got["none"][1][k])
               for k, v in got["gspmd"][1].items())
