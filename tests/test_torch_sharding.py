"""The GSPMD mode's pure functions and logical axes against the JAX
package, on the CPU, with no devices: JAX's ``make_rules``,
``prune_spec`` and ``zero_spec_for`` read only ``mesh.shape``, so both
packages get the same stub mesh (a ``{axis: size}`` mapping).

1. ``make_rules``, ``spec_for`` of every parameter, ``prune_spec`` of
   every parameter's shape and ``zero_spec_for`` of every parameter,
   for every registered arch at full size, at the meshes (8, 1), (4, 2),
   (2, 4), (16, 16), (32, 8) and (2, 16, 16), under the launcher's
   ``ParallelConfig`` and ``cell_parallel``'s for a training and a
   long-context serving cell; ``cell_parallel`` itself equal.
2. ``preferred_mesh``'s shape and axis names for every arch, single- and
   multi-pod: JAX's builds a real mesh of 256 or 512 devices, so its
   side runs in one subprocess on 512 virtual devices.
3. Every arch's logical-axes tree (``model.axes()``, returned by
   ``init_params``) equals the JAX package's ``Boxed`` tags, taken from
   an abstract ``jax.eval_shape`` of its init; a conv weight's axes in
   the port's OIHW order are JAX's HWIO ones permuted. At reduced size
   the tree's keys are the drawn parameters' keys too.
4. The placements: a spec becomes ``Shard(d)`` on the mesh dims it
   names (two mesh axes on one dim split it major to minor).
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from repro.configs import ParallelConfig as JPar
from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild
from repro.models.common import unbox
from repro.optim.zero import zero_spec_for as jzero

from repro_torch.configs import ParallelConfig as TPar
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.configs.base import _REGISTRY
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as tbuild
from repro_torch.optim.zero import zero_spec_for as tzero

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = sorted(_REGISTRY)
MESHES = [(8, 1), (4, 2), (2, 4), (16, 16), (32, 8), (2, 16, 16)]
# the launcher's (tp "model", pure DP over "data"), and cell_parallel's
# for a training cell and a batch-1 serving cell
POLICIES = ("launcher", "cell_train", "cell_serve")


class StubMesh:
    """Only what the rule functions read: ``shape``."""

    def __init__(self, shape):
        names = (("pod", "data", "model") if len(shape) == 3
                 else ("data", "model"))
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


_JAX_TREES = {}


def _jax_tree(arch, reduced=False):
    """(axes, shapes) of the JAX package's params, flattened to "/"
    paths, from an abstract init."""
    key = (arch, reduced)
    if key not in _JAX_TREES:
        cfg = jget(arch)
        cfg = jreduced(cfg) if reduced else cfg
        m = jbuild(cfg)
        values, axes = unbox(jax.eval_shape(m.init, jax.random.PRNGKey(0)))
        _JAX_TREES[key] = (_flat(axes), {k: tuple(v.shape) for k, v in
                                         _flat(values).items()})
    return _JAX_TREES[key]


def _parallels(arch, policy):
    """(JAX ParallelConfig, port ParallelConfig) of a policy."""
    if policy == "launcher":
        kw = dict(dp_axes=("data",), tp_axis="model", compression="bf16",
                  zero_1=False)
        return JPar(**kw), TPar(**kw)
    kind, batch = ("train", 256) if policy == "cell_train" else ("decode", 1)
    jp = jmesh.cell_parallel(jget(arch), JShape("c", 4096, batch, kind))
    tp = tmesh.cell_parallel(tget(arch), TShape("c", 4096, batch, kind))
    return jp, tp


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_specs_prune_and_zero_match_jax(arch, mesh, policy):
    jp, tp = _parallels(arch, policy)
    assert tp == TPar(**{f: getattr(jp, f) for f in
                         jp.__dataclass_fields__})
    stub = StubMesh(mesh)
    jr = jsh.make_rules(jget(arch), stub, jp)
    tr = tsh.make_rules(tget(arch), stub.shape, tp)
    assert tr == jr
    axes, shapes = _jax_tree(arch)
    dp = tuple(a for a in tp.dp_axes if a in stub.shape)
    for name, a in axes.items():
        js = jsh.spec_for(a, jr)
        ts = tsh.spec_for(a, tr)
        assert ts == _spec(js), name
        shape = shapes[name]
        assert tsh.prune_spec(shape, ts, stub) == _spec(
            jsh.prune_spec(shape, js, stub)), name
        assert tzero(shape, ts, stub, dp) == _spec(
            jzero(shape, js, stub, dp)), name


@pytest.fixture(scope="module")
def jax_preferred():
    """JAX's ``preferred_mesh`` shape and axis names per arch, single-
    and multi-pod, from a subprocess on 512 virtual devices."""
    body = (
        "import json, sys\n"
        "from repro.configs import get_config\n"
        "from repro.launch.mesh import preferred_mesh\n"
        "out = {}\n"
        f"for arch in {ARCHS!r}:\n"
        "    for pod in (False, True):\n"
        "        m = preferred_mesh(get_config(arch), multi_pod=pod)\n"
        "        out[f'{arch}/{pod}'] = [[int(m.shape[a]) for a in "
        "m.axis_names], list(m.axis_names)]\n"
        "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    res = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_preferred_mesh_matches_jax(jax_preferred, arch, pod):
    shape, axes = tmesh.preferred_mesh(tget(arch), multi_pod=pod)
    assert [list(shape), list(axes)] == jax_preferred[f"{arch}/{pod}"]


def _port_axes(model):
    """The port's axes in the JAX layout: a conv weight's OIHW axes as
    HWIO."""
    from repro_torch.interop import is_conv_leaf
    return {k: (a[2], a[3], a[1], a[0]) if len(a) == 4 and is_conv_leaf(k)
            else a for k, a in model.axes().items()}


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_matches_jax(arch, reduced):
    cfg = treduced(tget(arch)) if reduced else tget(arch)
    model = tbuild(cfg, device="cpu")  # ResNet-50 draws its weights here
    axes = _port_axes(model)
    assert axes == _jax_tree(arch, reduced)[0]
    if reduced:
        params, tree = model.init_params(0) if cfg.family != "conv" \
            else model.init_params()
        assert set(params) == set(tree) == set(model.axes())
        assert all(len(tree[k]) == params[k].dim() for k in params)


@pytest.mark.parametrize("spec,want", [
    ((), ("R", "R")),
    (("data",), ("S0", "R")),
    ((None, "model"), ("R", "S1")),
    ((("data", "model"), None), ("S0", "S0")),
    (("model", "data"), ("S1", "S0")),
])
def test_placements_of_a_spec(spec, want):
    class Mesh:
        mesh_dim_names = ("data", "model")
    got = tsh.placements(spec, Mesh())
    names = tuple("R" if p.is_replicate() else f"S{p.dim}" for p in got)
    assert names == want


def test_constrain_is_the_identity_outside_a_context_and_on_plain():
    x = torch.randn(2, 3)
    assert tsh.constrain(x, ("batch", "embed")) is x
    with tsh.activation_sharding({"data": 2, "model": 1},
                                 {"batch": ("data",)}):
        assert tsh.constrain(x, ("batch", "embed")) is x
        assert tsh.current_rules() == {"batch": ("data",)}
    assert tsh.current_rules() is None
