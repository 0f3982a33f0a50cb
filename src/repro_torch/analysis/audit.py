"""The audit: run the real train step in every sync mode on the worker
group, record it, and gate the per-(model, mode) contracts (the JAX
package's ``analysis/audit.py``, DESIGN.md §12).

    PYTHONPATH=src python -m repro_torch.analysis.audit --workers 4 \\
        --device cpu                          # reduced config, ~1 min
    PYTHONPATH=src python -m repro_torch.analysis.audit --workers 8 \\
        --device cuda --full                  # 8 processes on one card

For each cell of {gspmd, perleaf, bucketed, overlap, zero, zero_overlap,
hier, hier_overlap, hier_zero, hier_zero_overlap} x {sgd, lars} every
worker builds the port's step for that mode (``launch/train.py``
``build_train_setup``; flat cells on all N workers, the hierarchical
cells as a (2, N/2) layout with ``hier_split=1``, JAX's ``(2, 4)`` at 8
workers), runs it once (the overlapped steps plan their ready order
there, the stream and ZeRO steps build their decay and segment streams),
and records the second step (``analysis/op_trace.py``); a gspmd or
perleaf cell plans nothing, so its first step is the one recorded. Every
audit pass runs on that trace and the step's state (which tensors kept
their storage), and the mode's contract (``analysis/contracts.py``,
unchanged) is evaluated. Facts the trace cannot know (how many state
tensors there are, how many buckets the plan cuts, the wire itemsize)
come from the same planning code the step uses
(``distributed/bucketing.py:stream_layout``) as ``$``-expectations.

The JAX audit lowers and compiles instead; the port has no compiled
program of its eager step, so its audit runs the step.

The result (``--out``, by default ``results/torch_audit.json``):
per-cell pass records + violations, the cross-cell relations (ZeRO
must shrink each worker's resident optimizer state by ~(N-1)/N against
the bucketed cell), and a top-level ``ok`` (exit code 1 on any
violation on any worker).

Cells use f32 compute and an f16 wire, as the JAX audit's, and the
fused kernels (``use_fused_kernel``: stream-LARS's on the card; the
wire cast is ``cast_copy`` there). Bucket bytes default small enough
that the reduced config still cuts >= 2 buckets per step.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import contract_for, evaluate, resolve
from repro_torch.analysis.op_trace import OpTrace, record
from repro_torch.analysis.passes import AuditContext, StateLeaf, run_pass
from repro_torch.configs import (
    OptimizerConfig,
    get_config,
    reduced_config,
)
from repro_torch.distributed.bucketing import stream_layout

MODES: Dict[str, Dict[str, Any]] = {
    "gspmd": dict(dp_mode="gspmd", compression="f16",
                  overlap=False, zero=False),
    "perleaf": dict(dp_mode="shardmap", compression="f16",
                    overlap=False, zero=False),
    "bucketed": dict(dp_mode="shardmap", compression="f16+bucketed",
                     overlap=False, zero=False),
    "overlap": dict(dp_mode="shardmap", compression="f16+bucketed",
                    overlap=True, zero=False),
    "zero": dict(dp_mode="shardmap", compression="f16+bucketed",
                 overlap=False, zero=True),
    "zero_overlap": dict(dp_mode="shardmap", compression="f16+bucketed",
                         overlap=True, zero=True),
    # hierarchical schedules (DESIGN.md §14) on a 2-axis DP layout
    # (2, N/2) with hier_split=1: outer = "data" of 2, inner = "model"
    # of N/2
    "hier": dict(dp_mode="shardmap", compression="f16+bucketed",
                 overlap=False, zero=False, hier=1),
    "hier_overlap": dict(dp_mode="shardmap", compression="f16+bucketed",
                         overlap=True, zero=False, hier=1),
    "hier_zero": dict(dp_mode="shardmap", compression="f16+bucketed",
                      overlap=False, zero=True, hier=1),
    "hier_zero_overlap": dict(dp_mode="shardmap",
                              compression="f16+bucketed",
                              overlap=True, zero=True, hier=1),
}

#: the JAX audit's layout of the hierarchical cells at 8 workers; at N
#: workers the port's is (2, N // 2)
HIER_MESH_SHAPE = (2, 4)

OPTIMIZERS = {"sgd": "momentum_sgd", "lars": "lars"}

AUDIT_PASSES = ("comm", "interleave", "precision", "donation", "memory",
                "collectives", "determinism")

STEPS_PER_EPOCH = 40

#: the modes whose first step is already the steady one (the tree update
#: plans nothing: the same ops as the second step, which
#: tests/test_torch_audit.py checks), so it is the one recorded
FIRST_STEP_STEADY = ("gspmd", "perleaf")


def hier_mesh_shape(n: int) -> Tuple[int, int]:
    if n < 4 or n % 2:
        raise ValueError(f"the hierarchical cells lay {n} workers out as "
                         f"(2, n/2): take an even n >= 4")
    return 2, n // 2


def _tensors(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a (nested dict) state by its path; a DTensor as
    this worker's local shard."""
    out: List[Tuple[str, torch.Tensor]] = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += _tensors(v, f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        local = tree.to_local() if hasattr(tree, "to_local") else tree
        out.append((prefix[:-1], local))
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def state_leaves(before: Dict[str, Tuple[int, int]], after) -> List[StateLeaf]:
    """The step's state leaf by leaf: bytes, and whether the leaf of the
    new state lies in the storage its old self had (``before``: path ->
    (storage, bytes), taken before the step)."""
    now = dict(_tensors(after))
    return [StateLeaf(name, nbytes, name in now and
                      _storage(now[name]) == key)
            for name, (key, nbytes) in before.items()]


def _snapshot(state) -> Dict[str, Tuple[int, int]]:
    return {name: (_storage(t), t.numel() * t.element_size())
            for name, t in _tensors(state)}


def build_cell(cfg, mode: str, opt_kind: str, n: int, *, global_batch: int,
               bucket_bytes: int, device: str):
    """``(state, step, data)`` of one (mode, optimizer) cell on this
    worker of ``n``: the port's step for the mode, f32, the f16 wire."""
    from repro_torch.launch.train import build_train_setup
    spec = MODES[mode]
    hier = spec.get("hier")
    _, state, step, data, _, _ = build_train_setup(
        cfg, global_batch=global_batch, seq_len=cfg.image_size,
        opt_cfg=OptimizerConfig(kind=OPTIMIZERS[opt_kind]),
        steps_per_epoch=STEPS_PER_EPOCH, dp_mode=spec["dp_mode"],
        compute_dtype=torch.float32, compression=spec["compression"],
        bucket_bytes=bucket_bytes, overlap_comm=spec["overlap"],
        zero_dp=spec["zero"], hier_split=hier,
        mesh_shape=(hier_mesh_shape(n) if hier is not None else
                    (n, 1) if spec["dp_mode"] == "gspmd" else None),
        dp_axes=("data", "model") if hier is not None else ("data",),
        use_fused_kernel=True, device=device)
    return state, step, data


def run_cell(cfg, mode: str, opt_kind: str, n: int, *, global_batch: int,
             bucket_bytes: int, device: str
             ) -> Tuple[OpTrace, Dict[str, Any], List[StateLeaf],
                        Optional[float]]:
    """Build and run one (mode, optimizer) cell on this worker: its
    first step, then its second recorded (the first recorded in the
    ``FIRST_STEP_STEADY`` modes). Returns ``(trace, info,
    state leaves, card peak bytes or None)``; ``info`` carries the facts
    the contracts need, named as the JAX audit names them."""
    from repro_torch.optim.stream import zero_padded_total
    spec = MODES[mode]
    hier = spec.get("hier")
    cuda = torch.device(device).type == "cuda"
    marks = [time.perf_counter()]

    def mark() -> None:
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    state, step, data = build_cell(cfg, mode, opt_kind, n,
                                   global_batch=global_batch,
                                   bucket_bytes=bucket_bytes, device=device)
    mark()
    if mode not in FIRST_STEP_STEADY:
        # the host batch itself: a step called outside the Trainer moves it
        state, _ = step(state, data.batch_at(0))
    batch = data.batch_at(1)
    before = _snapshot(state)
    mark()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with record(torch.device(device).type) as trace:
        new_state, metrics = step(state, batch)
    mark()
    peak = float(torch.cuda.max_memory_allocated()) if cuda else None
    if not bool(torch.isfinite(metrics["loss"]).all()):
        raise FloatingPointError(f"{mode}/{opt_kind}: loss {metrics['loss']}")
    params = _tensors(state["params"])
    info: Dict[str, Any] = {
        "total_param_elems": sum(t.numel() for _, t in params),
        "n_param_leaves": len(params),
        "n_workers": n,
        "n_state_leaves": len(before),
        "n_batch_params": sum(hasattr(v, "shape") for v in batch.values()),
        "opt_bytes_per_device": sum(
            t.numel() * t.element_size()
            for _, t in _tensors(state["opt"])),
        # wall seconds of the set-up, the first step (0 where the first
        # is the recorded one), the recorded one
        "seconds": [b - a for a, b in zip(marks, marks[1:])],
    }
    if hier is not None:
        info["hier_outer"], info["hier_inner"] = hier_mesh_shape(n)
    use_stream = spec["zero"] or (
        opt_kind == "lars" and "bucketed" in spec["compression"])
    if use_stream:
        info["padded_total"] = zero_padded_total(
            dict(params), spec["compression"], bucket_bytes, n)
    return trace, info, state_leaves(before, new_state), peak


def _cell_expectations(info: Dict[str, Any], mode: str, opt_kind: str,
                       bucket_bytes: int) -> Dict[str, Any]:
    """The ``$``-facts the contracts resolve against, computed from the
    same bucket arithmetic the training step uses (the JAX audit's,
    verbatim)."""
    spec = MODES[mode]
    hier = spec.get("hier")
    wire_itemsize = 2  # f16 wire in every audit cell
    n = info["n_workers"]
    # shard-aligned under zero; the stream-LARS non-zero paths align too;
    # hierarchical schedules always align to the full DP size; plain
    # bucketed/overlap sgd uses the tree update with align=1
    if hier is not None or spec["zero"] or (
            opt_kind == "lars" and
            "bucketed" in (spec["compression"] or "")):
        align = n
    else:
        align = 1
    bucket_elems, n_buckets, pad = stream_layout(
        info["total_param_elems"], bucket_bytes, wire_itemsize, align)
    # the tail bucket can be tiny (the stream is cut at fixed offsets);
    # contracts count *qualifying* collectives, so drop it from the
    # expected count when it falls under the schedule byte floor
    tail_elems = (info["total_param_elems"] + pad -
                  (n_buckets - 1) * bucket_elems)
    schedule_min_bytes = 2048
    n_qualifying = (n_buckets - 1) + int(
        tail_elems * wire_itemsize >= schedule_min_bytes)
    exp: Dict[str, Any] = {
        "n_state_params": info["n_state_leaves"],
        "n_batch_params": info["n_batch_params"],
        "n_buckets_planned": n_buckets,
        "n_buckets": n_qualifying,
        # slack: the metrics all-reduce and (LARS) trust sum also run,
        # under schedule_min_bytes; +2 headroom. zero runs TWO
        # collectives per bucket (reduce-scatter in, all-gather out)
        "collective_budget":
            (2 * n_qualifying if spec["zero"] else n_qualifying) + 2,
        "metric_bytes_floor": 2048,
        "schedule_min_bytes": schedule_min_bytes,
        # per-leaf wire floor: every big leaf crosses the ring once
        "min_gradient_wire_bytes":
            2 * (info["total_param_elems"] * wire_itemsize) *
            (n - 1) / n * 0.9,
    }
    if hier is not None:
        # per-op qualifying counts + byte ceilings for the hierarchical
        # pipeline: buckets travel as f32 between the inner
        # reduce-scatter and the final cast, so intermediates are
        # 4 B/elem; only the non-zero modes' final all-gather is
        # wire-dtype (2 B/elem)
        inner = info["hier_inner"]
        sizes = [bucket_elems] * (n_buckets - 1) + [tail_elems]
        fl = schedule_min_bytes
        if spec["zero"]:
            rs_b = [b for e in sizes for b in (4 * e, 4 * e // inner)]
            ag_b = [b for e in sizes for b in (4 * e // inner, 4 * e)]
            n_rs = sum(b >= fl for b in rs_b)
            n_ar = 0
            n_ag = sum(b >= fl for b in ag_b)
            rs_ceil, ag_ceil = max(rs_b), max(ag_b)
            ar_ceil = exp["metric_bytes_floor"]
        else:
            n_rs = sum(4 * e >= fl for e in sizes)
            n_ar = sum(4 * e // inner >= fl for e in sizes)
            n_ag = sum(2 * e >= fl for e in sizes)
            rs_ceil = 4 * max(sizes)
            ar_ceil = 4 * max(sizes) // inner
            ag_ceil = 2 * max(sizes)
        exp.update({
            "n_rs": n_rs, "n_ar": n_ar, "n_ag": n_ag,
            "rs_bytes_ceiling": rs_ceil,
            "ar_bytes_ceiling": ar_ceil,
            "ag_bytes_ceiling": ag_ceil,
            "collective_budget": n_rs + n_ar + n_ag + 2,
        })
    return exp


def audit_trace(trace: OpTrace, model: str, mode: str, opt_kind: str,
                info: Dict[str, Any], *, bucket_bytes: int,
                state: Optional[List[StateLeaf]] = None,
                device_peak_bytes: Optional[float] = None
                ) -> Dict[str, Any]:
    """The passes and the contract of one recorded cell; its record."""
    expectations = _cell_expectations(info, mode, opt_kind, bucket_bytes)
    contract = contract_for(model, mode, opt_kind)
    gates = {k: resolve(v, expectations)
             for k, v in contract.expectations.items()}
    ctx = AuditContext(trace=trace, total_devices=info["n_workers"],
                       expectations={**expectations, **gates},
                       state=state, device_peak_bytes=device_peak_bytes)
    passes = {name: run_pass(name, ctx).as_dict()
              for name in contract.passes}
    violations = evaluate(contract, passes, expectations)
    return {
        "mode": mode,
        "optimizer": opt_kind,
        "contract": contract.name,
        "ok": not violations,
        "violations": violations,
        "expectations": expectations,
        "info": info,
        "passes": passes,
        "kernel_launches": dict(trace.launches),
        "n_ops": len(trace.ops),
        "n_backward_ops": sum(o.backward for o in trace.ops),
        "convolution_backward": trace.count("convolution_backward"),
        # seen inside the backward: the recorder reached autograd's
        # thread (a card runs the backward on a device thread)
        "convolution_backward_in_backward": trace.count(
            "convolution_backward", backward=True),
    }


def audit_cell(cfg, model: str, mode: str, opt_kind: str, n: int, *,
               global_batch: int, bucket_bytes: int,
               device: str) -> Dict[str, Any]:
    """Run + record + audit one cell on this worker; returns its record."""
    trace, info, leaves, peak = run_cell(
        cfg, mode, opt_kind, n, global_batch=global_batch,
        bucket_bytes=bucket_bytes, device=device)
    return audit_trace(trace, model, mode, opt_kind, info,
                       bucket_bytes=bucket_bytes, state=leaves,
                       device_peak_bytes=peak)


def _zero_relations(cells: List[Dict[str, Any]],
                    n_workers: int) -> List[Dict[str, Any]]:
    """Cross-cell memory relation: for each optimizer with both a
    ``bucketed`` and a ``zero`` cell, each worker's resident state bytes
    must drop by ~the sharded slice of the optimizer state,
    ``opt_bytes(bucketed) - opt_bytes(zero)``, i.e. ~(N-1)/N of the
    stream state (DESIGN.md §9). Params and model state are the same in
    both cells, so the state delta isolates the optimizer's."""
    by_key = {(c["mode"], c["optimizer"]): c for c in cells}
    relations = []
    for opt in sorted({c["optimizer"] for c in cells}):
        a = by_key.get(("bucketed", opt))
        b = by_key.get(("zero", opt))
        if a is None or b is None:
            continue
        try:
            mem_a = a["passes"]["memory"]["summary"]["entry_param_bytes"]
            mem_b = b["passes"]["memory"]["summary"]["entry_param_bytes"]
        except KeyError:
            continue
        expected = (a["info"]["opt_bytes_per_device"] -
                    b["info"]["opt_bytes_per_device"])
        actual = mem_a - mem_b
        ok = expected > 0 and 0.5 * expected <= actual <= 1.5 * expected
        relations.append({
            "relation": "zero_shrinks_optimizer_residency",
            "optimizer": opt,
            "n_workers": n_workers,
            "entry_param_bytes": {"bucketed": mem_a, "zero": mem_b},
            "actual_shrink_bytes": actual,
            "expected_shrink_bytes": expected,
            "ok": ok,
        })
    return relations


def run_audit(model: str = "resnet50", modes: Optional[List[str]] = None,
              optimizers: Optional[List[str]] = None, full: bool = False,
              global_batch: int = 16,
              bucket_bytes: Optional[int] = None, device: str = "cpu",
              verbose: bool = True) -> Dict[str, Any]:
    """Audit every (mode, optimizer) cell on the worker group this
    process belongs to (every worker calls it; each records its own
    step). The report is this worker's; ``ok`` holds only if every
    worker's cells and relations hold (``ranks_ok``)."""
    modes = list(modes or MODES)
    optimizers = list(optimizers or OPTIMIZERS)
    n, me = dist.get_world_size(), dist.get_rank()
    cfg = get_config(model)
    if not full:
        cfg = reduced_config(cfg)
    if bucket_bytes is None:
        # small enough that even the reduced param stream cuts >1 bucket
        bucket_bytes = 4 * 2 ** 20 if full else 8 * 2 ** 10

    cells = []
    for mode in modes:
        for opt in optimizers:
            if verbose and me == 0:
                print(f"[audit] {model}/{mode}/{opt} ...", flush=True)
            try:
                cell = audit_cell(cfg, model, mode, opt, n,
                                  global_batch=global_batch,
                                  bucket_bytes=bucket_bytes, device=device)
            except Exception as e:  # the step itself failed the cell
                cell = {"mode": mode, "optimizer": opt, "ok": False,
                        "violations": [{
                            "kind": "step_failed",
                            "message": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-3000:]}],
                        "passes": {}}
            if verbose and me == 0:
                status = "ok" if cell["ok"] else "FAIL"
                print(f"[audit] {model}/{mode}/{opt}: {status}",
                      flush=True)
                for v in cell["violations"]:
                    print(f"  violation: {v}", flush=True)
            cells.append(cell)

    relations = _zero_relations(cells, n)
    mine = (all(c["ok"] for c in cells) and
            all(r["ok"] for r in relations))
    ranks_ok: List[Any] = [None] * n
    dist.all_gather_object(ranks_ok, mine)
    # every worker's verdicts: cell -> the fields of its violations
    verdicts = {f"{c['mode']}/{c['optimizer']}": sorted(
        v.get("field", v["kind"]) for v in c["violations"]) for c in cells}
    ranks_verdicts: List[Any] = [None] * n
    dist.all_gather_object(ranks_verdicts, verdicts)
    return {
        "model": model,
        "config": "full" if full else "reduced",
        "mesh": [n, 1],
        "hier_mesh": list(hier_mesh_shape(n)) if n >= 4 and n % 2 == 0
        else None,
        "global_batch": global_batch,
        "bucket_bytes": bucket_bytes,
        "device": device,
        "rank": me,
        "modes": modes,
        "optimizers": optimizers,
        "cells": cells,
        "relations": relations,
        "ranks_ok": ranks_ok,
        "ranks_verdicts": ranks_verdicts,
        "ok": all(ranks_ok),
    }


def _worker(rank: int, n: int, store: str, device: str,
            kwargs: Dict[str, Any], out: Optional[str]) -> None:
    """One spawned worker of ``main``: join the group over gloo (workers
    that share one card too), audit, rank 0 writes the report."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        report = run_audit(device=device, **kwargs)
        if rank == 0 and out:
            _write(report, out)
    finally:
        from repro_torch.distributed import shutdown
        shutdown()


def _write(report: Dict[str, Any], out: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")


def spawn_audit(n: int, device: str, out: str, **kwargs) -> Dict[str, Any]:
    """Run ``run_audit`` in ``n`` spawned gloo workers (one thread each;
    on the card all of them share it) and return rank 0's report, which
    is written to ``out``."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_audit_") as d:
        mp.spawn(_worker, args=(n, os.path.join(d, "store"), device, kwargs,
                                out), nprocs=n)
    with open(out) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Audit of the recorded train step across sync modes "
                    "(DESIGN.md §12), on a gloo worker group")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--modes", default="all",
                    help=f"comma list of {sorted(MODES)} or 'all'")
    ap.add_argument("--optimizers", default="all",
                    help=f"comma list of {sorted(OPTIMIZERS)} or 'all'")
    ap.add_argument("--full", action="store_true",
                    help="full model config")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--bucket-bytes", type=int, default=None)
    ap.add_argument("--workers", type=int, default=8,
                    help="gloo workers to spawn")
    ap.add_argument("--device", default="cuda",
                    help="cuda (every worker on the one card) or cpu")
    ap.add_argument("--out", default="results/torch_audit.json")
    args = ap.parse_args(argv)

    modes = list(MODES) if args.modes == "all" else [
        m.strip() for m in args.modes.split(",") if m.strip()]
    for m in modes:
        if m not in MODES:
            ap.error(f"unknown mode {m!r}; pick from {sorted(MODES)}")
    opts = list(OPTIMIZERS) if args.optimizers == "all" else [
        o.strip() for o in args.optimizers.split(",") if o.strip()]
    for o in opts:
        if o not in OPTIMIZERS:
            ap.error(f"unknown optimizer {o!r}; pick from "
                     f"{sorted(OPTIMIZERS)}")
    kwargs = dict(model=args.model, modes=modes, optimizers=opts,
                  full=args.full, global_batch=args.global_batch,
                  bucket_bytes=args.bucket_bytes)
    report = spawn_audit(args.workers, args.device, args.out, **kwargs)
    n_bad = sum(not c["ok"] for c in report["cells"]) + \
        sum(not r["ok"] for r in report["relations"])
    print(f"[audit] wrote {args.out}: "
          f"{len(report['cells'])} cells, "
          f"{len(report['relations'])} relations, "
          f"{n_bad} failing on rank 0, every rank ok: {report['ok']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
