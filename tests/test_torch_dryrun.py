"""The port's dry run (``repro_torch.launch.dryrun``) and its meta-device
specs (``repro_torch.training.specs``) against the JAX package's.

1. The config helpers the dry run reads (``ASSIGNED_ARCHS``,
   ``list_archs``, ``shapes_for`` and its skip reasons) are the JAX
   package's.
2. ``input_specs``, ``param_specs`` (shapes, dtypes, logical axes; a
   conv weight in the port's OIHW against JAX's HWIO) and
   ``cache_specs`` equal the JAX package's ``eval_shape`` trees for
   every arch at full size (JAX's abstract init takes well under 2 s for
   each), with nothing allocated on the port's side.
3. One subprocess that imports only the port runs three cells on the
   meta device under torch's fake group: the reduced llama3.2-1b
   ``train_4k`` at (4, 2) (registered as ``test-tiny``, as
   ``test_distributed.py`` registers it), ResNet-50 ``train_32k`` and
   llama3.2-1b ``decode_32k`` at (16, 16); beside it a JAX subprocess
   computes ``bytes_per_device`` over the JAX package's own
   ``tree_shardings`` on an ``AxisType.Auto`` mesh, without compiling.
   The resident bytes per device are equal, ``model_flops_global`` is
   the JAX formula's exactly, and the (16, 16) cells stay on the meta
   device: the process's peak resident memory stays under 3 GiB (torch
   itself and the synthetic data's 0.6 GB of class templates, which the
   train setup builds), where one real ResNet-50 step at 128 images a
   worker holds over 10 GB of activations.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import pytest
import torch

from repro.configs import (
    ASSIGNED_ARCHS as J_ASSIGNED,
    get_config as jget,
    list_archs as jlist,
    shapes_for as jshapes,
)
from repro.configs import base as jbase
from repro.models import build_model as jbuild
from repro.training import specs as jspecs
from repro_torch.configs import (
    ASSIGNED_ARCHS as T_ASSIGNED,
    get_config as tget,
    list_archs as tlist,
    shapes_for as tshapes,
)
from repro_torch.configs import base as tbase
from repro_torch.interop import is_conv_leaf
from repro_torch.models import build_model as tbuild
from repro_torch.training import specs as tspecs

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = jlist()


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


def _hwio(k, t):
    """The port's OIHW conv leaf (shape or axes) as JAX's HWIO."""
    t = tuple(t)
    return (t[2], t[3], t[1], t[0]) if len(t) == 4 and is_conv_leaf(k) \
        else t


def test_config_helpers_are_jax_s():
    assert T_ASSIGNED == J_ASSIGNED
    assert tlist() == jlist()
    assert tbase.FULL_ATTENTION_SKIP == jbase.FULL_ATTENTION_SKIP
    for t, j in ((tbase.LM_SHAPES, jbase.LM_SHAPES),
                 (tbase.RESNET_SHAPES, jbase.RESNET_SHAPES)):
        assert [vars(s) for s in t] == [vars(s) for s in j]


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_for_is_jax_s(arch):
    got = [vars(s) for s in tshapes(tget(arch))]
    want = [vars(s) for s in jshapes(jget(arch))]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_jax_s(arch):
    for shp in tshapes(tget(arch)):
        got = tspecs.input_specs(tget(arch), shp, torch.bfloat16)
        want = jspecs.input_specs(jget(arch), shp, jnp.bfloat16)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (shp.name, k)
            assert str(v.dtype).split(".")[1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_are_jax_s(arch):
    jm = jbuild(jget(arch), compute_dtype=jnp.bfloat16)
    tm = tbuild(tget(arch), device="meta")
    jshape, jaxes = jspecs.param_specs(jm, jnp.float32)
    tshape, taxes = tspecs.param_specs(tm, torch.float32)
    jshape, jaxes = _flat(jshape), _flat(jaxes)
    assert set(tshape) == set(jshape) == set(taxes)
    for k, v in tshape.items():
        assert v.device.type == "meta" and v.dtype == torch.float32
        assert _hwio(k, v.shape) == tuple(jshape[k].shape), k
        assert _hwio(k, taxes[k]) == tuple(jaxes[k]), k
    if tget(arch).family == "conv":
        return
    jv, ja = jspecs.cache_specs(jm, 2, 64, jnp.bfloat16)
    tv, ta = tspecs.cache_specs(tm, 2, 64, torch.bfloat16)
    jv, ja = _flat(jv), _flat(ja)
    assert set(tv) == set(jv) and ta == {k: tuple(a) for k, a in ja.items()}
    for k, v in tv.items():
        assert v.device.type == "meta"
        assert str(v.dtype).split(".")[1] == str(jv[k].dtype), k
        assert tuple(v.shape) == tuple(jv[k].shape), k


def test_specs_refuse_a_model_off_the_meta_device():
    with pytest.raises(ValueError, match="meta device"):
        tspecs.param_specs(tbuild(tget("llama3.2-1b"), device="cpu"))


_REGISTER_TINY = """
import dataclasses
from {pkg}.configs import get_config, reduced_config
import {pkg}.configs.base as base
cfg = reduced_config(get_config('llama3.2-1b'))
base._REGISTRY['test-tiny'] = lambda: dataclasses.replace(cfg, name='test-tiny')
"""

CELLS = (("test-tiny", "train_4k", (4, 2)),
         ("resnet50", "train_32k", (16, 16)),
         ("llama3.2-1b", "decode_32k", (16, 16)))

_PORT = _REGISTER_TINY.format(pkg="repro_torch") + """
import json, resource, sys, torch
from repro_torch.launch.dryrun import lower_cell
torch.set_num_threads(2)
out = {}
for arch, shape, mesh in %r:
    rec, trace = lower_cell(arch, shape, mesh)
    out[arch] = {k: rec[k] for k in (
        "status", "resident_bytes_per_device", "roofline", "comm_report",
        "collective_total_bytes", "n_ops", "audit", "fits_h100_80g",
        "hlo_flops_per_device", "batch_rows_per_device")}
    out[arch]["devices"] = sorted({o.device for o in trace.ops})
out["maxrss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
out["cuda_initialized"] = torch.cuda.is_initialized()
print("RESULT" + json.dumps(out))
""" % (CELLS,)

_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
""" + _REGISTER_TINY.format(pkg="repro") + """
import json
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import OptimizerConfig, get_config, shapes_for
from repro.distributed.sharding import make_rules, prune_spec, tree_shardings
from repro.launch.dryrun import bytes_per_device
from repro.launch.mesh import cell_parallel
from repro.models import build_model, init_model_state
from repro.optim import make_optimizer
from repro.optim.zero import zero_shardings
from repro.training.specs import cache_specs, param_specs

isn = lambda x: isinstance(x, NamedSharding)

def cell(arch, shape_name, mesh_shape):
    # lower_cell's state and shardings, built as it builds them
    cfg = get_config(arch)
    shp = {s.name: s for s in shapes_for(cfg)}[shape_name]
    mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    parallel = cell_parallel(cfg, shp)
    rules = make_rules(cfg, mesh, parallel)
    if shp.kind != "train":
        model = build_model(cfg, compute_dtype=jnp.bfloat16, remat=False)
        p_shapes, p_axes = param_specs(model, jnp.bfloat16)
        p_shard = tree_shardings(p_axes, mesh, rules)
        cv, ca = cache_specs(model, shp.global_batch, shp.seq_len,
                             jnp.bfloat16)
        cs = jax.tree.map(
            lambda v, s: NamedSharding(mesh, prune_spec(v.shape, s.spec,
                                                        mesh)),
            cv, tree_shardings(ca, mesh, rules), is_leaf=isn)
        resident = {"params": bytes_per_device(p_shapes, p_shard, mesh),
                    "cache": bytes_per_device(cv, cs, mesh)}
    else:
        model = build_model(cfg, compute_dtype=jnp.bfloat16,
                            remat=parallel.remat == "block")
        p_shapes, p_axes = param_specs(model, jnp.float32)
        p_shard = tree_shardings(p_axes, mesh, rules)
        optimizer = make_optimizer(OptimizerConfig(), steps_per_epoch=1000,
                                   global_batch=shp.global_batch)
        opt = jax.eval_shape(optimizer.init, p_shapes)
        specs = jax.tree.map(lambda s: s.spec, p_shard, is_leaf=isn)
        fields = {f: zero_shardings(opt[f], specs, mesh, parallel.dp_axes)
                  if parallel.zero_1 else p_shard
                  for f in optimizer.state_fields}
        ms = jax.eval_shape(lambda: init_model_state(model))
        state = {"params": p_shapes, "opt": opt, "model_state": ms}
        shard = {"params": p_shard,
                 "opt": {"step": NamedSharding(mesh, P()), **fields},
                 "model_state": jax.tree.map(
                     lambda _: NamedSharding(mesh, P()), ms)}
        resident = {"state": bytes_per_device(state, shard, mesh)}
    # analyze_compiled's MODEL_FLOPS
    if cfg.family == "conv":
        model_flops = (3.0 if shp.kind == "train" else 1.0) * (
            2 * 4.089e9 / 2) * shp.global_batch
    else:
        tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode"
                                     else 1)
        model_flops = (6.0 if shp.kind == "train" else 2.0) * \\
            cfg.active_param_count() * tokens
    return {"resident": resident, "model_flops_global": model_flops}

print("RESULT" + json.dumps({a: cell(a, s, m) for a, s, m in %r}))
""" % (CELLS,)


def _result(proc):
    out, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def cells():
    src = os.path.join(ROOT, "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "2"}
    port = subprocess.Popen([sys.executable, "-c", _PORT], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    jax_ = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX)], cwd=ROOT,
        env={**env, "JAX_PLATFORMS": "cpu"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return _result(port), _result(jax_)


@pytest.mark.parametrize("arch", [c[0] for c in CELLS])
def test_resident_bytes_are_jax_s(cells, arch):
    port, jax_ = cells
    rec = port[arch]
    assert rec["status"] == "ok"
    assert rec["resident_bytes_per_device"] == jax_[arch]["resident"]
    assert rec["roofline"]["model_flops_global"] == \
        jax_[arch]["model_flops_global"]
    assert rec["roofline"]["bound_s"] > 0
    assert rec["devices"] == ["meta"]


def test_the_tiny_train_cell_syncs_its_gradients(cells):
    rec = cells[0]["test-tiny"]
    assert rec["collective_total_bytes"] > 0
    assert rec["comm_report"]["gradient_sync"] == "all_reduce"
    # 8 batch rows of 256 sequences: 32 a worker
    assert rec["batch_rows_per_device"]["tokens"] == [32, 4096]
    # the step updates its whole state in place
    assert rec["audit"]["donation"]["ok"]


def test_a_16x16_cell_allocates_nothing(cells):
    port, _ = cells
    assert not port["cuda_initialized"]
    assert port["maxrss_kb"] < 3 * 2 ** 20, port["maxrss_kb"]
    res = port["resnet50"]
    assert res["batch_rows_per_device"]["images"] == [128, 224, 224, 3]
    assert res["fits_h100_80g"] and res["hlo_flops_per_device"] > 0
