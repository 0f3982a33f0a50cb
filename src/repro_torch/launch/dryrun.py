"""Dry run: one worker's step of every (arch x shape x mesh) cell on the
``meta`` device under a fake process group of the mesh's size, recorded
(``analysis/op_trace.py``) for the memory, cost and collective analyses
of the roofline (the JAX package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh 1x1 --global-batch 4 --seq-len 1024

The JAX dry run lowers and compiles each cell on 512 virtual devices.
The port runs rank 0's step instead, on tensors without storage: the
setups are the port's own (``launch/train.py`` ``build_train_setup``,
``launch/serve.py`` ``build_gspmd_serve_setup``) with the cell's
``cell_parallel`` layout, every collective goes to torch's fake group
(it returns at once), and the kernels' plain versions compute shapes
only. Nothing is allocated on a card and nothing is drawn. Results are
cached per cell as JSON; reruns skip completed cells unless --force.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import quick_audit
from repro_torch.analysis.cost import Analysis, analyze_trace
from repro_torch.analysis.op_trace import OpTrace, record
from repro_torch.analysis.passes.comm import comm_report
from repro_torch.configs import (
    ASSIGNED_ARCHS,
    OptimizerConfig,
    ShapeConfig,
    get_config,
    shapes_for,
)
from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    LINK_BW,
    PEAK_FLOPS_BF16,
    cell_parallel,
    make_production_mesh,
)
from repro_torch.training.specs import cache_specs, input_specs

META = torch.device("meta")
MeshSizes = Dict[str, int]
# the step counter is a host int in the port and an int32 scalar in the
# JAX package's state: counted at that width so the two records compare
STEP_COUNTER_BYTES = 4


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """Torch's fake process group of ``world`` workers, this process rank
    0, for the span of a cell: every collective returns at once. Made
    here and never at import (the group is process-global)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import shutdown
    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process without a worker "
                           "group: it makes a fake one per cell")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        shutdown()


def batch_shardings(batch_specs: Dict[str, torch.Tensor], mesh: MeshSizes,
                    rules) -> Dict[str, Tuple]:
    """Each batch leaf's spec: its leading dim over the rules' batch axes,
    dropping axes from the right until the rows divide (batch 128 on 256
    workers splits over "data" only; a batch of 1 stays whole)."""
    from repro_torch.distributed.sharding import spec_for

    def shard(leaf):
        if leaf.dim() == 0:
            return ()
        spec = spec_for(("batch",), rules)
        entry = spec[0] if len(spec) else None
        axes = (() if entry is None else
                ((entry,) if isinstance(entry, str) else tuple(entry)))
        while axes:
            size = 1
            for a in axes:
                size *= mesh[a]
            if leaf.shape[0] % size == 0:
                break
            axes = axes[:-1]
        if not axes:
            return ()
        return (axes if len(axes) > 1 else axes[0],)

    return {k: shard(v) for k, v in batch_specs.items()}


def local_bytes(tree) -> float:
    """This worker's bytes of a (nested) state: each DTensor's local
    shard, each plain tensor whole, a host int step counter at
    ``STEP_COUNTER_BYTES``. (The JAX package's ``bytes_per_device``
    divides each leaf by its spec's workers; the port reads the shards
    its placements made.)"""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return float(t.numel() * t.element_size())
    if isinstance(tree, int) and not isinstance(tree, bool):
        return float(STEP_COUNTER_BYTES)
    return 0.0


def _rows(batch: Dict[str, torch.Tensor], specs: Dict[str, Tuple],
          mesh: MeshSizes) -> Dict:
    """This worker's rows of a meta batch by its specs (the first of
    the rows' groups)."""
    out = {}
    for k, v in batch.items():
        n = 1
        for entry in specs[k]:
            for a in ((entry,) if isinstance(entry, str) else entry):
                n *= mesh[a]
        out[k] = v[: v.shape[0] // n] if v.dim() else v
    return out


def lower_cell(arch: str, shape_name: str, mesh_shape: Tuple[int, ...], *,
               attention_impl: str = "chunked",
               dp_mode: str = "gspmd",
               opt_cfg: Optional[OptimizerConfig] = None,
               compression: Optional[str] = "__default__",
               overlap_comm: bool = False,
               zero_dp: bool = False,
               fused_bn: bool = False,
               optimizer_kind: str = "rmsprop_warmup",
               hier_split: Optional[int] = None,
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None
               ) -> Tuple[Dict[str, Any], Optional[OpTrace]]:
    """Set up and run rank 0's step of one cell on the meta device under
    a fake group of ``prod(mesh_shape)`` workers laid out over ("data",
    "model"), inside the recorder and ``FlopCounterMode``; returns
    ``(record, trace)`` (the JAX package's ``(record, compiled)``).
    ``global_batch`` / ``seq_len`` run the shape's kind at another size
    (a chip run's, to set the dry run's prediction beside it); the
    layout stays the registry shape's ``cell_parallel``."""
    cfg = get_config(arch)
    if fused_bn:
        if cfg.family != "conv":
            raise ValueError(
                "--fused-bn fuses the ResNet BN sites; arch family "
                f"{cfg.family!r} has no BN")
        cfg = dataclasses.replace(cfg, fused_bn=True)
    shp = {s.name: s for s in shapes_for(cfg)}[shape_name]
    if shp.skip_reason:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": shp.skip_reason}, None
    parallel = cell_parallel(cfg, shp)
    if global_batch is not None or seq_len is not None:
        shp = dataclasses.replace(
            shp, global_batch=global_batch or shp.global_batch,
            seq_len=seq_len or shp.seq_len)
    if compression != "__default__":
        parallel = dataclasses.replace(parallel, compression=compression)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != 2:
        raise ValueError(f"mesh {mesh_shape}: the port lays its workers "
                         "out over ('data', 'model'); fold a pod axis "
                         "into 'data'")
    mesh = dict(zip(("data", "model"), mesh_shape))
    world = mesh_shape[0] * mesh_shape[1]
    with fake_group(world):
        t0 = time.time()
        run, resident, batch, leaves = _setup(
            cfg, shp, mesh_shape, parallel, attention_impl=attention_impl,
            dp_mode=dp_mode, opt_cfg=opt_cfg,
            overlap_comm=overlap_comm, zero_dp=zero_dp,
            optimizer_kind=optimizer_kind, hier_split=hier_split)
        t_setup = time.time() - t0
        from torch.utils.flop_counter import FlopCounterMode
        t0 = time.time()
        flop_mode = FlopCounterMode(display=False)
        with flop_mode, record("meta") as trace:
            run()
        t_run = time.time() - t0
        state = leaves()
    record_ = analyze_cell(arch, shp, cfg, mesh, trace, resident,
                           state=state)
    record_.update({
        "lower_s": round(t_setup, 1),
        "compile_s": round(t_run, 1),
        "cost_analysis_raw": {"flops": float(flop_mode.get_total_flops())},
        "parallel": dataclasses.asdict(parallel),
        "attention_impl": attention_impl,
        "dp_mode": dp_mode,
        "batch_rows_per_device": {k: list(v.shape)
                                  for k, v in batch.items()
                                  if torch.is_tensor(v)},
    })
    return record_, trace


def _setup(cfg, shp: ShapeConfig, mesh_shape, parallel, *, attention_impl,
           dp_mode, opt_cfg, overlap_comm, zero_dp,
           optimizer_kind, hier_split):
    """``(run, resident bytes, batch, leaves)`` of one cell: ``run()`` is
    one step on this worker's meta inputs, ``leaves()`` after it the
    step's state leaf by leaf (``analysis/audit.py`` ``state_leaves``;
    None for a serve cell)."""
    from repro_torch.analysis.audit import _snapshot, state_leaves
    from repro_torch.core.compression import parse_compression
    compute_dtype = torch.bfloat16
    if shp.kind == "train":
        from repro_torch.launch.train import build_train_setup
        kw: Dict[str, Any] = dict(
            global_batch=shp.global_batch, seq_len=shp.seq_len,
            opt_cfg=opt_cfg or OptimizerConfig(kind=optimizer_kind),
            steps_per_epoch=1000, compute_dtype=compute_dtype,
            attention_impl=attention_impl, draw_device=META, device=META)
        mesh = dict(zip(("data", "model"), mesh_shape))
        if dp_mode == "shardmap":
            kw.update(dp_mode="shardmap",
                      compression=parallel.compression or "none",
                      bucket_bytes=parallel.bucket_bytes,
                      overlap_comm=overlap_comm, zero_dp=zero_dp,
                      hier_split=hier_split, dp_axes=parallel.dp_axes,
                      mesh_shape=mesh_shape,
                      remat=parallel.remat == "block")
        else:
            kw.update(dp_mode="gspmd", mesh_shape=mesh_shape,
                      parallel=parallel)
        _, state, step, _, _, shardings = build_train_setup(cfg, **kw)
        batch = input_specs(cfg, shp, compute_dtype)
        specs = ({k: (tuple(parallel.dp_axes),) for k in batch}
                 if dp_mode == "shardmap" else
                 batch_shardings(batch, mesh, shardings.rules))
        batch = _rows(batch, specs, mesh)
        holder = [state]
        before = _snapshot(state)

        def run():
            holder[0], _ = step(holder[0], batch)
        return run, {"state": local_bytes(state)}, batch, \
            lambda: state_leaves(before, holder[0])
    from repro_torch.launch.serve import build_gspmd_serve_setup
    from repro_torch.training.gspmd import place_cache
    from repro_torch.training.step import make_decode_step, make_prefill_step
    if parse_compression(parallel.compression)[1]:
        raise ValueError("bucketed compression is a training sync")
    model, params, mesh, rules = build_gspmd_serve_setup(
        cfg, mesh_shape, compute_dtype=compute_dtype,
        attention_impl=attention_impl, device=META, draw_device=META,
        parallel=parallel)
    cache, axes = cache_specs(model, shp.global_batch, shp.seq_len,
                              compute_dtype)
    cache = place_cache(cache, axes, mesh, rules)
    batch = input_specs(cfg, shp, compute_dtype)
    if shp.kind == "decode":  # the port's write position is a host int:
        # the last one, a decode step over the whole cache
        batch["cache_index"] = shp.seq_len - 1
    step = (make_prefill_step if shp.kind == "prefill" else
            make_decode_step)(model, mesh, rules)

    def run():
        step(params, cache, batch)
    resident = {"params": local_bytes(params), "cache": local_bytes(cache)}
    return run, resident, batch, lambda: None


def analyze_cell(arch: str, shp: ShapeConfig, cfg, mesh: MeshSizes,
                 trace: OpTrace, resident: Dict[str, float], *,
                 state=None) -> Dict[str, Any]:
    """The JAX package's per-cell record, from one worker's trace: FLOPs,
    bytes and collectives per device, the audit passes, the resident
    bytes and the roofline against the card (``launch/mesh.py``)."""
    n_dev = 1
    for s in mesh.values():
        n_dev *= s
    a: Analysis = analyze_trace(trace, total_devices=n_dev,
                                parameter_bytes=sum(resident.values()))

    # analytic MODEL_FLOPS (the "useful compute" yardstick)
    n_active = cfg.active_param_count()
    if cfg.family == "conv":
        # ResNet-50: ~4.09 GFLOP/image fwd (He et al.); x3 for train
        per_image = 2 * 4.089e9 / 2  # fwd MACs*2
        factor = 3.0 if shp.kind == "train" else 1.0
        model_flops = factor * per_image * shp.global_batch
    else:
        tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode"
                                     else 1)
        factor = 6.0 if shp.kind == "train" else 2.0
        model_flops = factor * n_active * tokens

    compute_s = a.flops / PEAK_FLOPS_BF16
    memory_s = a.memory_bytes / HBM_BW
    collective_s = a.total_collective_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    step_tokens_or_images = (shp.global_batch if cfg.family == "conv"
                             else shp.global_batch * (
                                 1 if shp.kind == "decode" else shp.seq_len))
    from repro_torch.analysis.passes import AuditContext, run_pass
    mem = run_pass("memory", AuditContext(trace=trace)).summary
    return {
        "arch": arch,
        "shape": shp.name,
        "kind": shp.kind,
        "mesh": dict(mesh),
        "status": "ok",
        "hlo_flops_per_device": a.flops,
        "hlo_dot_flops": a.dot_flops,
        "hlo_conv_flops": a.conv_flops,
        "hlo_memory_bytes_per_device": a.memory_bytes,
        "hlo_parameter_bytes_per_device": a.parameter_bytes,
        "collective_bytes_per_device": a.collective_bytes,
        "collective_dtypes": a.collective_dtypes,
        "collective_total_bytes": a.total_collective_bytes,
        "comm_report": comm_report(a, trace=trace),
        # a train cell updates its state in place: its leaves arm the
        # in-place coverage gate
        "audit": quick_audit(
            trace, total_devices=n_dev, state=state,
            n_state_params=None if state is None else len(state)),
        "trip_counts_found": 0,
        "n_ops": len(trace.ops),
        "n_state_tensors": None if state is None else len(state),
        "resident_bytes_per_device": resident,
        "fits_h100_80g": sum(resident.values()) < HBM_BYTES,
        "memory_analysis": {
            "temp_peak_bytes": mem["temp_peak_bytes"],
            "peak_source": "liveness over the trace",
        },
        "roofline": {
            **{k: round(v, 6) for k, v in terms.items()},
            "dominant": dominant,
            "bound_s": round(bound_s, 6),
            "model_flops_global": model_flops,
            "hlo_flops_global": a.flops * n_dev,
            "useful_fraction": round(
                model_flops / max(a.flops * n_dev, 1.0), 4),
            "achievable_mfu": round(
                (model_flops / n_dev / PEAK_FLOPS_BF16) / max(bound_s, 1e-12),
                4),
            "tokens_or_images_per_step": step_tokens_or_images,
        },
    }


def run_cells(archs, shapes, *, multi_pod=False, out_dir="results/dryrun_torch",
              force=False, attention_impl="chunked", dp_mode="gspmd",
              compression="__default__", overlap_comm=False,
              zero_dp=False, fused_bn=False,
              optimizer_kind="rmsprop_warmup", hier_split=None):
    """Every (arch, shape) cell on the production mesh (a pod axis folded
    into "data": (32, 16) for two pods of (16, 16)), cached per cell."""
    mesh_shape, _ = make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        mesh_shape = (mesh_shape[0] * mesh_shape[1], mesh_shape[2])
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    if dp_mode != "gspmd":
        mesh_tag += f"__{dp_mode}"
    if compression != "__default__":
        mesh_tag += f"__{compression or 'nowire'}"
    if overlap_comm:
        mesh_tag += "__overlap"
    if zero_dp:
        mesh_tag += "__zero"
    if hier_split is not None:
        mesh_tag += f"__hier{hier_split}"
    if fused_bn:
        mesh_tag += "__fusedbn"
    if optimizer_kind != "rmsprop_warmup":
        mesh_tag += f"__{optimizer_kind}"
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        cfg = get_config(arch)
        all_shapes = {s.name: s for s in shapes_for(cfg)}
        for shape_name in (shapes or all_shapes):
            if shape_name not in all_shapes:
                continue
            path = os.path.join(out_dir,
                                f"{arch}__{shape_name}__{mesh_tag}.json")
            if os.path.exists(path) and not force:
                with open(path) as f:
                    results.append(json.load(f))
                print(f"[cached] {arch} {shape_name} {mesh_tag}")
                continue
            print(f"[lower]  {arch} {shape_name} {mesh_tag} ...",
                  flush=True)
            try:
                rec, _ = lower_cell(arch, shape_name, mesh_shape,
                                    attention_impl=attention_impl,
                                    dp_mode=dp_mode,
                                    compression=compression,
                                    overlap_comm=overlap_comm,
                                    zero_dp=zero_dp, fused_bn=fused_bn,
                                    optimizer_kind=optimizer_kind,
                                    hier_split=hier_split)
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
            rec["mesh_tag"] = mesh_tag
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            status = rec.get("status")
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f"dom={r['dominant']} bound={r['bound_s']:.4f}s "
                         f"step={rec['compile_s']}s")
                cr = rec["comm_report"]
                print("  comm: %.0f collectives/step, "
                      "%.2f MiB/collective mean, sync=%s" % (
                          cr["total_executions_per_step"],
                          cr["mean_bytes_per_collective"] / 2**20,
                          cr.get("gradient_sync", "?")))
            print(f"[done]   {arch} {shape_name} {mesh_tag}: {status} "
                  f"{extra}", flush=True)
            results.append(rec)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default=None,
                    help="shape name or comma list (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--attention-impl", default="chunked")
    ap.add_argument("--dp-mode", default="gspmd",
                    choices=["gspmd", "shardmap"])
    ap.add_argument("--compression", default="__default__",
                    help="override gradient sync: none|bf16|f16|"
                         "bf16+bucketed|f16+bucketed")
    ap.add_argument("--overlap-comm", action="store_true")
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--fused-bn", action="store_true")
    ap.add_argument("--optimizer", default="rmsprop_warmup",
                    choices=["rmsprop_warmup", "momentum_sgd", "lars"])
    ap.add_argument("--hier-split", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="DxM worker layout of one cell (with one --arch "
                         "and --shape), printed instead of the sweep")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="with --mesh: the shape's kind at this batch")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="with --mesh: the shape's kind at this length")
    args = ap.parse_args(argv)
    if args.mesh:
        rec, _ = lower_cell(
            args.arch, args.shape,
            tuple(int(x) for x in args.mesh.split("x")),
            attention_impl=args.attention_impl, dp_mode=args.dp_mode,
            compression=args.compression, overlap_comm=args.overlap_comm,
            zero_dp=args.zero, fused_bn=args.fused_bn,
            optimizer_kind=args.optimizer, hier_split=args.hier_split,
            global_batch=args.global_batch, seq_len=args.seq_len)
        print(json.dumps({k: rec[k] for k in (
            "arch", "shape", "mesh", "resident_bytes_per_device",
            "hlo_flops_per_device", "hlo_memory_bytes_per_device",
            "collective_total_bytes", "roofline", "memory_analysis",
            "fits_h100_80g", "batch_rows_per_device")}, indent=1))
        return
    archs = (list(ASSIGNED_ARCHS) + ["resnet50"] if args.arch == "all"
             else args.arch.split(","))
    shapes = args.shape.split(",") if args.shape else None
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        run_cells(archs, shapes, multi_pod=mp, out_dir=args.out,
                  force=args.force, attention_impl=args.attention_impl,
                  dp_mode=args.dp_mode, compression=args.compression,
                  overlap_comm=args.overlap_comm, zero_dp=args.zero,
                  fused_bn=args.fused_bn, optimizer_kind=args.optimizer,
                  hier_split=args.hier_split)


if __name__ == "__main__":
    main()
