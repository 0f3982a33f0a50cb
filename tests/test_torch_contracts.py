"""The port's audit contracts against the JAX package's, with no step run
and nothing compiled: the contract table of every (mode, optimizer)
cell field by field, ``resolve`` / ``lookup`` / ``evaluate`` on the JAX
package's own contract-test records (``test_analysis_passes.py``), and
the audit's expectation arithmetic (``_cell_expectations``) from the
same ``info``, its parameter counts the JAX package's own
(``param_specs``, ``zero_padded_total``) and the port's meta specs
(``training/specs.py``) giving the same counts."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest

from repro.analysis import audit as jaudit
from repro.analysis import contracts as jc
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.models import build_model as jbuild
from repro.optim.stream import zero_padded_total as jpadded
from repro.training.specs import param_specs as jparam_specs
from repro_torch.analysis import audit as taudit
from repro_torch.analysis import contracts as tc
from repro_torch.configs import get_config as tget, reduced_config as treduced
from repro_torch.models import build_model as tbuild
from repro_torch.optim.stream import zero_padded_total as tpadded
from repro_torch.training.specs import param_specs as tparam_specs

from test_analysis_passes import _fake_record

CELLS = [(m, o) for m in jaudit.MODES for o in jaudit.OPTIMIZERS]
BUCKET = 8 * 2 ** 10


def test_mode_and_optimizer_tables_are_jax_s():
    assert taudit.MODES == jaudit.MODES
    assert taudit.OPTIMIZERS == jaudit.OPTIMIZERS
    assert taudit.AUDIT_PASSES == jaudit.AUDIT_PASSES
    assert taudit.HIER_MESH_SHAPE == jaudit.HIER_MESH_SHAPE
    assert taudit.hier_mesh_shape(8) == jaudit.HIER_MESH_SHAPE
    assert tc.ALL_PASSES == jc.ALL_PASSES
    assert tc.BASE_FORBID == jc.BASE_FORBID


@pytest.mark.parametrize("mode,opt", CELLS)
def test_contract_for_is_jax_s(mode, opt):
    got = dataclasses.asdict(tc.contract_for("resnet50", mode, opt))
    want = dataclasses.asdict(jc.contract_for("resnet50", mode, opt))
    assert got == want


def test_unknown_mode_raises_alike():
    for mod in (tc, jc):
        with pytest.raises(ValueError, match="no contract for mode"):
            mod.contract_for("resnet50", "nope", "sgd")


@pytest.mark.parametrize("value,exp", [
    (7, {}), ("$n", {"n": 9}), ("$missing", {"n": 9})])
def test_resolve_is_jax_s(value, exp):
    """The same value, or a KeyError naming the same key and the same
    computed keys (the wording names the port's audit)."""
    def run(mod):
        try:
            return mod.resolve(value, exp)
        except KeyError as e:
            msg = str(e)
            return ("KeyError", msg[msg.index("$"):].split()[0],
                    msg[msg.index("have"):])
    assert run(tc) == run(jc)


@pytest.mark.parametrize("field", [
    "collectives.per_op.all-reduce.execs", "memory.peak_bytes",
    "collectives.per_op.all-gather.execs", "collectives.gradient_sync"])
def test_lookup_is_jax_s(field):
    rec = _fake_record()

    def run(mod):
        try:
            return mod.lookup(rec, field)
        except KeyError as e:
            return ("KeyError", str(e))
    assert run(tc) == run(jc)


def _contracts(mod):
    """The contracts of ``test_analysis_passes.py``'s evaluate tests, and
    the zero contract without its pass gates."""
    zero = mod.contract_for("resnet50", "zero", "sgd")
    return {
        "clean": mod.Contract(name="t", forbid_errors=("collectives",),
                              checks=(
            mod.Check("collectives.per_op.all-reduce.execs", "==",
                      "$n_buckets"),
            mod.Check("collectives.gradient_sync", "==", "all_reduce"))),
        "labelled": mod.Contract(name="t", forbid_errors=(), checks=(
            mod.Check("collectives.per_op.all-reduce.execs", "==",
                      "$n_buckets", label="one all-reduce per bucket"),)),
        "forbid": mod.Contract(name="t",
                               forbid_errors=("collectives", "memory"),
                               checks=()),
        "bad_field": mod.Contract(name="t", forbid_errors=(), checks=(
            mod.Check("collectives.per_op.reduce-scatter.execs", ">=", 1),)),
        "is_true": mod.Contract(name="t", forbid_errors=(), checks=(
            mod.Check("interleave.interleaved", "is_true"),)),
        "zero": mod.Contract(name=zero.name, passes=zero.passes,
                             expectations=zero.expectations,
                             checks=zero.checks, forbid_errors=()),
    }


_EXP = {"n_buckets": 8, "metric_bytes_floor": 2048, "collective_budget": 10}
_RECORDS = {
    "clean": _fake_record(),
    "nine": _fake_record(execs=9),
    "error": _fake_record(with_error=True),
    "interleaved_no": {"interleave": {"summary": {"interleaved": False},
                                      "findings": []}},
    "interleaved_yes": {"interleave": {"summary": {"interleaved": True},
                                       "findings": []}},
}


@pytest.mark.parametrize("contract", sorted(_contracts(jc)))
@pytest.mark.parametrize("rec", sorted(_RECORDS))
def test_evaluate_gives_jax_s_violations(contract, rec):
    got = tc.evaluate(_contracts(tc)[contract], _RECORDS[rec], _EXP)
    want = jc.evaluate(_contracts(jc)[contract], _RECORDS[rec], _EXP)
    assert got == want


def _jax_info(n: int):
    """The JAX audit's parameter facts of the reduced ResNet-50."""
    cfg = jreduced(jget("resnet50"))
    p_shapes, _ = jparam_specs(jbuild(cfg, compute_dtype=jnp.float32),
                               jnp.float32)
    leaves = jax.tree.leaves(p_shapes)
    return p_shapes, {
        "total_param_elems": sum(math.prod(v.shape) for v in leaves),
        "n_param_leaves": len(leaves), "n_workers": n,
        "n_state_leaves": 86, "n_batch_params": 2}


@pytest.mark.parametrize("n", [4, 8])
def test_param_counts_and_padding_are_jax_s(n):
    p_shapes, info = _jax_info(n)
    shapes, _ = tparam_specs(tbuild(treduced(tget("resnet50")),
                                    device="meta"))
    assert sum(v.numel() for v in shapes.values()) == \
        info["total_param_elems"]
    assert len(shapes) == info["n_param_leaves"]
    assert tpadded(shapes, "f16+bucketed", BUCKET, n) == \
        jpadded(p_shapes, "f16+bucketed", BUCKET, n)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("mode,opt", CELLS)
def test_cell_expectations_are_jax_s(mode, opt, n):
    _, info = _jax_info(n)
    if jaudit.MODES[mode].get("hier") is not None:
        info["hier_outer"], info["hier_inner"] = taudit.hier_mesh_shape(n)
    for bucket in (BUCKET, 4 * 2 ** 20):
        assert taudit._cell_expectations(info, mode, opt, bucket) == \
            jaudit._cell_expectations(info, mode, opt, bucket)
