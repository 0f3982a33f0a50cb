"""The port's audit (``repro_torch.analysis``) on the CPU.

1. One spawn of 4 gloo workers (one thread each, a process that imports
   only the port) runs every one of the 20 cells (10 sync modes x {sgd,
   lars}) at the reduced ResNet-50: the real step of each mode, its
   second step recorded (the first in the gspmd and perleaf cells,
   which plan nothing: their first step makes the second's ops, checked
   here), flat cells at 4 x 1 and the hierarchical ones at 2 x 2. Every
   cell meets the JAX package's contract unchanged on every worker, and
   both ZeRO relations hold.
2. The passes flag seeded faults in small recorded steps (collectives
   on torch's fake group): a per-leaf sync against the bucketed
   contract, a bf16 sum over a large tensor, a random op, a state copied
   instead of updated in place, and gradient collectives clustered after
   the backward where interleaving is required.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import quick_audit
from repro_torch.analysis.audit import (
    FIRST_STEP_STEADY,
    MODES,
    OPTIMIZERS,
    _snapshot,
    audit_trace,
    build_cell,
    state_leaves,
)
from repro_torch.analysis.cost import analyze_trace, gradient_sync_mode
from repro_torch.analysis.op_trace import Op, OpTrace, record
from repro_torch.analysis.passes.fusion import fusion_report
from repro_torch.analysis.passes import AuditContext, run_pass
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed.bucketing import plan_buckets
from repro_torch.kernels._launch import on_cpu
from repro_torch.launch.dryrun import fake_group
from repro_torch.models import build_model
from repro_torch.optim.stream import trust_mask_segments
from repro_torch.training.specs import param_specs

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = [(m, o) for m in MODES for o in OPTIMIZERS]
BUCKET = 8 * 2 ** 10


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "torch_audit.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--workers",
         "4", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def test_every_worker_holds_every_contract(report):
    assert report["ranks_ok"] == [True] * 4 and report["ok"]
    assert report["mesh"] == [4, 1] and report["hier_mesh"] == [2, 2]
    assert [(c["mode"], c["optimizer"]) for c in report["cells"]] == CELLS


@pytest.mark.parametrize("mode,opt", CELLS)
def test_cell_meets_its_contract(report, mode, opt):
    cell = {(c["mode"], c["optimizer"]): c for c in report["cells"]}[
        (mode, opt)]
    assert cell["ok"] and not cell["violations"], cell["violations"]
    # the recorded step is the whole step: the reduced ResNet-50's 9
    # convolutions each have their backward, inside the backward
    assert cell["convolution_backward"] == 9
    assert cell["n_backward_ops"] > 0
    coll = cell["passes"]["collectives"]["summary"]
    exp = cell["expectations"]
    if mode in ("bucketed", "overlap"):
        assert coll["per_op"]["all-reduce"]["execs"] == exp["n_buckets"]
    if mode in ("zero", "zero_overlap"):
        assert coll["per_op"]["reduce-scatter"]["execs"] == \
            coll["per_op"]["all-gather"]["execs"] == exp["n_buckets"]
    state = cell["passes"]["donation"]["summary"]
    assert state["n_aliased"] == state["n_state_params"] == \
        exp["n_state_params"]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_zero_shrinks_optimizer_residency(report, opt):
    rel = {r["optimizer"]: r for r in report["relations"]}[opt]
    assert rel["ok"]
    # the port's state holds exactly the optimizer's bytes less
    assert rel["actual_shrink_bytes"] == rel["expected_shrink_bytes"] > 0


# the JAX package's own audit of full ResNet-50's stream-LARS ZeRO cell
# on 8 virtual CPU devices, as written by
#   PYTHONPATH=src python -m repro.analysis.audit --full --modes zero \
#       --optimizers lars --out tests/data/jax_audit_full_zero_lars.json
JAX_FULL_ZERO_LARS = os.path.join(ROOT, "tests", "data",
                                  "jax_audit_full_zero_lars.json")


def test_full_zero_lars_reads_hierarchical_in_both_packages():
    """At full ResNet-50 on 8 workers the stream-LARS ZeRO cell fails one
    check of the shared contract in the JAX package and in the port
    alike: LARS's trust-ratio sum is one all-reduce of a metric-sized
    buffer whose ring bytes pass the 2,048-byte floor, so
    ``gradient_sync`` reads "hierarchical" where the contract wants
    "reduce_scatter+all_gather"."""
    with open(JAX_FULL_ZERO_LARS) as f:
        rec = json.load(f)
    (cell,) = rec["cells"]
    assert (rec["config"], rec["mesh"], rec["bucket_bytes"]) == (
        "full", [8, 1], 4 * 2 ** 20)
    assert (cell["mode"], cell["optimizer"]) == ("zero", "lars")
    assert [(v["field"], v["expected"], v["actual"])
            for v in cell["violations"]] == [
        ("collectives.gradient_sync", "reduce_scatter+all_gather",
         "hierarchical")]
    floor = cell["expectations"]["metric_bytes_floor"]
    jax_ar = cell["passes"]["collectives"]["summary"]["allreduce_max_bytes"]
    assert jax_ar < floor < 2 * jax_ar * 7 / 8
    # the port's trust-ratio sum at that size: (2, segments) f32
    model = build_model(get_config("resnet50"), device="meta")
    params = dict(model.named_parameters())
    plan = plan_buckets(params, 4 * 2 ** 20, "f16", align=8)
    ratios = torch.zeros(2, len(trust_mask_segments(params, plan)))
    assert ratios.numel() * 4 < floor < 2 * ratios.numel() * 4 * 7 / 8
    with fake_group(8), record() as trace:
        shard = torch.zeros(1024, dtype=torch.float16)
        whole = torch.zeros(8 * 1024, dtype=torch.float16)
        dist.reduce_scatter_tensor(shard, whole)
        dist.all_reduce(ratios)
        dist.all_gather_into_tensor(whole, shard)
    assert gradient_sync_mode(analyze_trace(trace, 8), floor) == \
        "hierarchical"


@pytest.mark.parametrize("mode,opt", [(m, o) for m in FIRST_STEP_STEADY
                                      for o in OPTIMIZERS])
def test_first_step_is_the_steady_one(mode, opt):
    """The cells the audit records at their first step make the same ops,
    shapes and collectives in their first step as in their second."""
    cfg = reduced_config(get_config("resnet50"))
    traces = []
    with fake_group(4):
        state, step, data = build_cell(cfg, mode, opt, 4, global_batch=16,
                                       bucket_bytes=BUCKET, device="cpu")
        for i in range(2):
            with record("cpu") as trace:
                state, _ = step(state, data.batch_at(i))
            traces.append([(o.name, o.in_shapes, o.out_shapes, o.collective,
                            o.group_size, o.backward) for o in trace.ops])
    assert len(traces[0]) > 100 and traces[0] == traces[1]


# ---------------------------------------------------------------------------
# seeded faults
# ---------------------------------------------------------------------------


def _reduced_info(n):
    shapes, _ = param_specs(build_model(reduced_config(
        get_config("resnet50")), device="meta"))
    return shapes, {"total_param_elems": sum(v.numel()
                                             for v in shapes.values()),
                    "n_param_leaves": len(shapes), "n_workers": n,
                    "n_state_leaves": 1, "n_batch_params": 2,
                    "opt_bytes_per_device": 0}


def test_a_per_leaf_sync_fails_the_bucketed_contract():
    shapes, info = _reduced_info(4)
    state = {"w": torch.zeros(8)}
    before = _snapshot(state)
    with fake_group(4), record() as trace:
        for v in shapes.values():  # one f16 all-reduce a leaf
            dist.all_reduce(torch.zeros(v.numel(), dtype=torch.float16))
    cell = audit_trace(trace, "resnet50", "bucketed", "sgd", info,
                       bucket_bytes=BUCKET,
                       state=state_leaves(before, state))
    assert not cell["ok"]
    failed = {v["field"]: v for v in cell["violations"]
              if v["kind"] == "check_failed"}
    execs = failed["collectives.per_op.all-reduce.execs"]
    # the leaves of 2 KiB or more on the wire against 8 buckets
    big = sum(2 * v.numel() >= 2048 for v in shapes.values())
    assert execs["actual"] == big != execs["expected"] == 8


@pytest.mark.parametrize("dtype,bad", [(torch.bfloat16, True),
                                       (torch.float32, False)])
def test_a_narrow_sum_over_a_large_tensor_is_an_error(dtype, bad):
    with record() as trace:
        torch.ones(64, 64, dtype=dtype).sum(dim=0)
        torch.ones(16, dtype=torch.bfloat16).sum()  # small: not checked
    res = run_pass("precision", AuditContext(trace=trace))
    assert bool(res.errors) == bad
    assert res.summary["big_reductions_checked"] == 1


def test_a_narrow_round_trip_is_a_warning():
    x = torch.randn(4096)
    with record() as trace:
        x.to(torch.float16).to(torch.float32)
    res = run_pass("precision", AuditContext(trace=trace))
    assert not res.errors and res.summary["roundtrips"] == 1


def test_a_random_op_is_an_error():
    with record() as trace:
        torch.rand(8)
        torch.zeros(8).index_add_(0, torch.tensor([0, 0]), torch.ones(2))
    res = run_pass("determinism", AuditContext(trace=trace))
    assert [f.severity for f in res.findings] == ["error", "warn"]
    assert res.summary["op_counts"] == {"index_add_": 1, "rand": 1}
    allowed = run_pass("determinism", AuditContext(
        trace=trace, expectations={"allow_rng": True, "forbid_scatter": True}))
    assert [f.severity for f in allowed.findings] == ["error"]


@pytest.mark.parametrize("in_place", [True, False])
def test_a_state_copied_instead_of_updated_in_place(in_place):
    state = {"params": {"w": torch.zeros(2048)}, "opt": {"step": 0}}
    before = _snapshot(state)
    with record() as trace:
        w = state["params"]["w"]
        new = {"params": {"w": w.add_(1) if in_place else w + 1},
               "opt": {"step": 1}}
    leaves = state_leaves(before, new)
    rec = quick_audit(trace, state=leaves, n_state_params=1)
    assert rec["donation"]["ok"] == in_place == rec["ok"]
    assert rec["donation"]["summary"]["wasted_bytes"] == \
        (0 if in_place else 8192)


def _linear_stack():
    torch.manual_seed(0)
    return torch.nn.Sequential(*[torch.nn.Linear(64, 64)
                                 for _ in range(4)])


@pytest.mark.parametrize("overlapped", [True, False])
def test_collectives_clustered_after_the_backward(overlapped):
    net = _linear_stack()
    x = torch.randn(8, 64)
    with fake_group(2):
        if overlapped:  # each gradient synced as soon as it is ready
            for p in net.parameters():
                p.register_post_accumulate_grad_hook(
                    lambda p: dist.all_reduce(p.grad))
        with record() as trace:
            net(x).sum().backward()
            if not overlapped:
                for p in net.parameters():
                    dist.all_reduce(p.grad)
    res = run_pass("interleave", AuditContext(
        trace=trace, expectations={"require_interleaved": True}))
    assert res.summary["interleaved"] == overlapped
    assert bool(res.errors) != overlapped
    assert res.summary["n_collectives"] == 4  # the weights; biases < 512 B


def test_the_trace_records_collectives_and_kernels():
    with fake_group(4), record() as trace:
        t = torch.zeros(1024, dtype=torch.float16)
        dist.all_reduce(t)
        out = torch.empty(4 * 1024, dtype=torch.float16)
        dist.all_gather_into_tensor(out, t)
        dist.reduce_scatter_tensor(t, out)
    kinds = [(o.collective, o.group_size, o.in_bytes, o.out_bytes, o.dtype)
             for o in trace.collectives()]
    assert kinds == [("all-reduce", 4, 2048, 2048, "float16"),
                     ("all-gather", 4, 2048, 8192, "float16"),
                     ("reduce-scatter", 4, 8192, 2048, "float16")]
    assert trace.launches == {}  # the plain versions count nothing


def test_on_cpu_routes_meta_and_refuses_a_mix():
    m = torch.empty(4, device="meta")
    assert on_cpu("t", m, m) and on_cpu("t", torch.zeros(2))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        on_cpu("t", m, torch.zeros(2))


def test_the_fusion_report_counts_the_kernels_passes():
    """One BN site's forward and backward: unfused (``core/batchnorm.py``)
    as recorded, fused as the card records it (its four kernels'
    launches; on the CPU the plain versions run as many ops)."""
    from repro_torch.core.batchnorm import bn_apply_stats, bn_batch_stats
    x = torch.randn(8, 16, 16, 32, requires_grad=True)
    scale = torch.ones(32, requires_grad=True)
    bias = torch.zeros(32, requires_grad=True)
    with record("cpu") as unfused:
        mean, var = bn_batch_stats(x)
        torch.relu(bn_apply_stats(x, mean, var, scale, bias)).sum().backward()
    fused = OpTrace([Op(i, f"kernel.{k}", launches=1) for i, k in
                     enumerate(("bn_stats", "bn_apply", "bn_bwd_sums",
                                "bn_bwd_dx"))])
    rep = fusion_report(fused, unfused, x.numel())
    assert rep["fused"] == {"reduction_ops": 2, "activation_writes": 2}
    assert rep["unfused"]["reduction_ops"] > 2 and rep["collapsed"]
    assert not fusion_report(unfused, unfused, x.numel())["collapsed"]
