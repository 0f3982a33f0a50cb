"""End-to-end training program: the paper's recipe for ResNet-50
(hybrid RMSprop warm-up, slow-start LR, the bf16 gradient wire format,
BN without moving averages, optionally the fused BN, update and input
kernels) on synthetic data, with held-out validation at epoch
boundaries (``--epochs``; without it, ``--steps`` steps of the
step-driven ``run_training``, no eval). On one device (``--dp-mode
none``, or the default ``--dp-mode gspmd`` without ``--mesh``),
data-parallel with one process per worker (``--dp-mode shardmap``, the
paper's own run), or under ``--dp-mode gspmd --mesh DxM``: the GSPMD
step on a DTensor mesh, its "model" axis tensor parallel for every
LM family (Megatron TP, MoE expert parallelism or TP inside the
experts, the SSM families on each worker's heads;
``training/gspmd.py``).
``--optimizer lars`` on the bucketed DP path runs LARS on the packed
gradient stream (the stream-LARS kernels with ``--use-fused-kernel``).
``--sync-bn`` makes every BN site cross-replica over the workers, and
``--overlap-comm`` starts the bucketed gradient all-reduces during the
backward pass, and ``--zero`` reduce-scatters the buckets and shards
the optimizer update and state over the workers (all three ``--dp-mode
shardmap``; ``--zero`` needs two workers or more). ``--mesh DxM`` lays
the workers out over ("data", "model") and ``--comm-plan hier:1`` runs
every bucket's collective in two levels over it: a reduce-scatter
inside each group of M workers (a node), an all-reduce of the 1/M shard
across the D groups, an all-gather inside the group
(``distributed/comm_plan.py`` has the grammar: flat | hier[:k] | auto
| <path>).
``--ckpt-dir`` checkpoints in the JAX package's format and resumes from
the newest intact checkpoint; ``--sentinel`` adds the divergence
sentinel and the recovery state machine, ``--chaos`` deterministic
fault injection. ``--arch`` an LM (the dense llama3.2-1b, yi-9b,
granite-34b, qwen2-72b; the MoE mixtral-8x7b, llama4-maverick-400b-a17b;
phi-3-vision-4.2b, zamba2-7b, xlstm-350m, whisper-tiny) trains it on the
synthetic token stream (``--seq-len`` tokens a row, with random patches
or frames for the VLM and the audio model, the naive attention as in
the JAX launcher), on one device or on any of the DP steps above but
``--sync-bn``; ``--overlap-comm`` needs a staged loss, which zamba2-7b,
xlstm-350m and whisper-tiny do not have (it raises, as in the JAX
package).
``--host-shard H/N`` reads only host H's rows of every global batch,
``--log-json PATH`` writes the run's history as the JAX launcher does:

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
        --reduced --epochs 2 --steps-per-epoch 5 --global-batch 16 \\
        --fused-bn --device cuda
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --dp-mode shardmap --compression bf16+bucketed --use-fused-kernel \\
        --fused-input --fused-bn --data-workers 4 --compute-dtype bfloat16 \\
        --epochs 1 --ckpt-dir /tmp/ck --ckpt-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --dp-mode shardmap --compression bf16+bucketed --optimizer lars \\
        --schedule poly --label-smoothing 0.1 --use-fused-kernel \\
        --error-feedback --device cuda
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --reduced --dp-mode shardmap --compression bf16+bucketed \\
        --sync-bn --overlap-comm --fused-bn --epochs 1 --steps-per-epoch 2 \\
        --global-batch 16 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --reduced --dp-mode shardmap --compression bf16+bucketed --zero \\
        --use-fused-kernel --epochs 1 --steps-per-epoch 2 --global-batch 16 \\
        --ckpt-dir /tmp/ck_zero --ckpt-every 2 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --dp-mode shardmap --compression bf16+bucketed \\
        --mesh 2x2 --comm-plan hier:1 --zero --epochs 1 --steps-per-epoch 2 \\
        --global-batch 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --epochs 3 --steps-per-epoch 5 --global-batch 16 --sentinel \\
        --chaos "nan_grad@7-9" --ckpt-dir /tmp/ck --ckpt-every 5 \\
        --event-log /tmp/events.jsonl --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --seq-len 128 --global-batch 8 --epochs 2 \\
        --steps-per-epoch 3 --host-shard 0/2 --log-json /tmp/run.json \\
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch llama3.2-1b --reduced --seq-len 64 --dp-mode gspmd \\
        --mesh 1x2 --global-batch 4 --steps 2 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch mixtral-8x7b --reduced --seq-len 64 --global-batch 8 \\
        --dp-mode shardmap --compression bf16+bucketed --zero \\
        --overlap-comm --bucket-mib 1 --steps 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (
    InputConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    reduced_config,
)
from repro_torch.core.compression import init_error_feedback, parse_compression
from repro_torch.data import make_data
from repro_torch.data.pipeline import (
    AugmentedSource,
    StepStampSource,
    make_put_batch,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import init_workers, rank, shutdown, world_size
from repro_torch.interop import WorkerSharding
from repro_torch.kernels.ops import fused_input_eval
from repro_torch.models import build_model, init_model_state
from repro_torch.optim import make_optimizer
from repro_torch.distributed.bucketing import shard_size
from repro_torch.optim.stream import make_stream_optimizer, zero_padded_total
from repro_torch.resilience import (ResilienceConfig, parse_chaos,
                                    wrap_step_with_sentinel)
from repro_torch.spans import span
from repro_torch.training import (LoopConfig, Trainer, TrainerConfig,
                                  run_training)
from repro_torch.training.step import (
    finalize_worker_bn_stats,
    make_batch_input_transform,
    make_dp_shardmap_train_step,
    make_eval_step,
    make_train_step,
    overlap_stream_order,
    to_device,
    zero_stream_plan,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DP_MODES = ("none", "shardmap", "gspmd")
# the axes of a --mesh DxM worker layout, as the JAX launcher names them
MESH_AXES = ("data", "model")


def build_train_setup(cfg, *, global_batch: int, seq_len: int,
                      opt_cfg: OptimizerConfig, steps_per_epoch: int,
                      dp_mode: str = "none",
                      compute_dtype=torch.float32, seed: int = 0,
                      use_fused_kernel: bool = False,
                      sync_bn: bool = False,
                      compression: Optional[str] = None,
                      bucket_bytes: int = 64 * 1024 * 1024,
                      error_feedback: bool = False,
                      overlap_comm: bool = False, zero_dp: bool = False,
                      fused_bn: bool = False,
                      label_smoothing: float = 0.0,
                      input_cfg: Optional[InputConfig] = None,
                      sentinel: bool = False,
                      dp_axes: Optional[Tuple[str, ...]] = None,
                      hier_split: Optional[int] = None,
                      mesh_shape: Optional[Tuple[int, ...]] = None,
                      attention_impl: str = "naive",
                      remat: Optional[bool] = None,
                      zero_1: Optional[bool] = None,
                      parallel: Optional[ParallelConfig] = None,
                      microbatches: int = 1,
                      draw_device: DeviceLike = "cpu",
                      device: DeviceLike = "cuda"):
    """Returns (model, state, train_step, data, put_batch,
    state_shardings).

    ``dp_mode="none"`` is the JAX package's no-mesh path on one device.
    ``dp_mode="shardmap"`` is its explicit data-parallel step, one
    process per worker: this joins the worker group
    (``distributed.init_workers``: NCCL on ``cuda:{LOCAL_RANK}``, gloo
    on the CPU), builds this worker's replica, its own BN state and
    ``make_dp_shardmap_train_step``, and reads only this worker's shard
    of every global batch (``make_data(num_hosts=world,
    host_id=rank)``). ``put_batch`` is then the pipeline's device stage
    (pinned memory and a side stream on a card). ``state`` is
    ``{"params", "opt", "model_state"}``; its params are the model's
    own parameters, updated in place. ``state_shardings`` is
    ``interop.WorkerSharding()`` on the data-parallel path (each worker
    keeps its own BN state and EF residual; the checkpoints stack them
    as the JAX package does) and None on one device.

    An LM (every family but the conv one) trains on the synthetic token
    stream of ``seq_len`` tokens a row (with the VLM's patches, the audio
    model's frames) with its token-mean cross entropy (plus 0.01 x the
    MoE aux loss), its attention ``attention_impl``
    ("naive", as the JAX package's default; "chunked": the flash kernel;
    "chunked_opt": the bf16-tile loop with each q block recomputed in
    the backward), on one device or on every data-parallel step the
    conv family takes: per-leaf or bucketed sync, error feedback,
    stream-LARS, the overlapped sync (its staged loss,
    ``TransformerLM.loss_segments``: the hybrid, SSM and audio models
    have none, and it raises for them), ZeRO and the hierarchical
    schedules. ``sync_bn`` raises for it (it has no BN). Its weights are
    drawn from ``seed`` on ``draw_device`` (``TransformerLM.init``: the
    CPU gives the same weights on every device, the card draws a
    billion in milliseconds). ``seq_len`` is unused by the conv family.

    ``sentinel`` wraps the step with the divergence sentinel
    (``resilience.wrap_step_with_sentinel``): it becomes the
    ``(state, batch, controls)`` step the ``Trainer``'s recovery state
    machine drives. On one device this turns on the step's
    ``grad_norm`` (one extra reduction); the data-parallel step reports
    it already.

    LARS on the bucketed DP path is the packed-stream optimizer
    (``optim/stream.py``; its state is one flat padded ``delta``), as in
    the JAX package; elsewhere it is the per-leaf LARS. ``zero_dp``
    (``--zero``, the DP path with bucketed compression and two workers
    or more) takes the packed-stream optimizer for every kind, and each
    worker's state is its shard of the stream (``shard_size`` elements
    a field); the ``WorkerSharding`` says so, so checkpoints gather the
    shards into the JAX package's global shard-layout arrays.
    ``error_feedback`` (DP path only, with a wire dtype) adds each
    worker's residual to the state as ``ef_residual``.

    ``sync_bn`` on the data-parallel path of the conv family builds the
    ResNet with cross-replica BN over the worker group (as the JAX
    package, it changes nothing elsewhere: one device's statistics are
    already the whole batch's). ``overlap_comm`` (data-parallel path
    only) takes ``make_dp_overlap_train_step``, which starts each
    bucket's all-reduce during the backward pass.

    ``input_cfg`` turns on per-sample augmentation of the conv family's
    images; with ``fused=True`` augment + normalize + cast run on the
    device in the fused input kernel inside the DP step
    (``dp_mode="shardmap"`` only, as in the JAX package), else on the
    host feed (``AugmentedSource``). Its ``num_hosts`` / ``host_id``
    (``--host-shard H/N``) make this run read host H's rows ``[H * B/N,
    (H+1) * B/N)`` of every global batch of B, the optimizer still
    scaled for B, as the JAX package does; on the DP path those rows are
    split over the workers in rank order, as the JAX package's mesh
    splits them over its devices: worker r of W reads shard ``H * W +
    r`` of ``N * W``.

    ``mesh_shape`` lays the workers out over ``MESH_AXES`` (the JAX
    package's ``mesh``; None: all of them on "data"), rank ``w`` at row
    ``w // M``, column ``w % M``. ``hier_split`` (the DP path with
    bucketed compression) splits ``dp_axes`` into the two stages of the
    hierarchical schedule, ``dp_axes[:hier_split]`` across nodes and the
    rest inside them; with ``dp_axes=MESH_AXES`` the workers are data
    parallel over the whole mesh. The shard_map DP step takes no mesh
    axis outside ``dp_axes`` of more than one worker, as in the JAX
    package.

    ``dp_mode="gspmd"`` is the JAX launcher's default mode. With no
    ``mesh_shape`` it is the one-device step. With one, the workers form
    a ``DeviceMesh`` over ``MESH_AXES`` (``process_group.device_mesh``),
    "model" is the tensor-parallel axis unless ``dp_axes`` takes it, and
    this builds the logical-axis rules (``distributed/sharding.py``),
    places the parameters by them and the optimizer fields by their
    parameters' placements (DTensors), keeps the model state replicated
    (ResNet-50's BN statistics over the global batch: the mesh's batch
    group is its ``bn_group``), reads this worker's rows of every batch
    (its coordinate on the batch axes; the others get the same rows) and
    returns ``interop.MeshSharding()`` as ``state_shardings``; the step
    is ``make_train_step(..., mesh, rules)`` (``training/gspmd.py``).
    Under a model axis of more than one worker the conv family keeps its
    weights replicated (its rules) and every other family is tensor
    parallel by its rules: Megatron TP, the MoE experts over the axis
    (EP) or their ``ffn`` (TP inside the experts), the SSM families'
    "inner" dims. As in the JAX package it refuses ``overlap_comm``,
    ``zero_dp``, ``error_feedback``, ``hier_split`` and fused input, and
    ignores "+bucketed" (its wire dtype applies). ``zero_1`` (GSPMD on
    a mesh only; the JAX launcher leaves it off) places the optimizer
    fields by ZeRO-1's specs (``optim/zero.py``) and gives the step
    their ``grad_constraint``.

    ``parallel`` (GSPMD on a mesh; None: the launcher's policy above)
    is a whole ``ParallelConfig``, as the JAX package's
    ``lower_cell(parallel=...)`` takes one, e.g. ``cell_parallel(cfg,
    ShapeConfig("train", 1024, 4, "train"))``: its ``dp_axes``,
    ``tp_axis``, ``zero_1`` (its fields placed by ZeRO-1's specs over
    the parameters' own, FSDP's included), ``compression``, ``remat``
    ("block": each layer checkpointed, unless ``remat`` says otherwise)
    and ``fsdp_params`` (the parameters' "embed" / "conv_out" dims over
    the data axes, each leaf gathered where the forward reads it) are
    then the layout's one source: it raises if ``dp_axes``, ``zero_1``
    or ``compression`` is passed beside it (None: "bf16", ("data",) and
    False without it).
    ``microbatches`` > 1 accumulates the gradients of that many equal
    microbatches a step (one device, or each worker's rows under
    GSPMD).

    ``remat`` (None: the JAX launcher's ``n_layers > 8``) checkpoints an
    LM's layers in training."""
    if dp_mode not in DP_MODES:
        raise ValueError(f"dp_mode must be one of {DP_MODES}, got "
                         f"{dp_mode!r}")
    if parallel is not None:
        beside = [name for name, v in (("compression", compression),
                                       ("dp_axes", dp_axes),
                                       ("zero_1", zero_1)) if v is not None]
        if beside:
            raise ValueError(f"parallel holds the GSPMD layout: pass "
                             f"{', '.join(beside)} in it, not beside it")
        compression, dp_axes, zero_1 = (parallel.compression or "none",
                                        parallel.dp_axes, parallel.zero_1)
    compression = "bf16" if compression is None else compression
    dp_axes = ("data",) if dp_axes is None else tuple(dp_axes)
    zero_1 = bool(zero_1)
    if (zero_1 or parallel is not None) and (dp_mode != "gspmd" or
                                             mesh_shape is None):
        raise ValueError("zero_1 (and a ParallelConfig) place the GSPMD "
                         "step's state over a mesh: pass dp_mode='gspmd' "
                         "and a mesh_shape (the DP step's ZeRO is "
                         "zero_dp)")
    if microbatches > 1 and dp_mode == "shardmap":
        raise ValueError("microbatches accumulate in the one-device and "
                         "GSPMD steps; the data-parallel step takes one "
                         "batch a step")
    if dp_mode == "gspmd":
        _gspmd_checks(overlap_comm, zero_dp, error_feedback, hier_split,
                      input_cfg)
        if mesh_shape is None:  # the one-device step
            dp_mode = "none"
            compression = parse_compression(compression)[0] or "none"
    if hier_split is not None and dp_mode != "shardmap":
        raise ValueError(
            "hier_split reschedules explicit per-bucket collectives, "
            "which only exist in the shard_map DP mode "
            "(dp_mode='shardmap')")
    mesh = None
    if mesh_shape is not None:
        if dp_mode == "none":
            raise ValueError("a worker mesh lays out the data-parallel "
                             "workers: pass dp_mode='shardmap' or "
                             "'gspmd'")
        if len(mesh_shape) != len(MESH_AXES):
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} must give "
                             f"a size for each of {MESH_AXES}")
        mesh = dict(zip(MESH_AXES, (int(s) for s in mesh_shape)))
        tp = [a for a, s in mesh.items() if a not in dp_axes and s > 1]
        if tp and dp_mode == "shardmap":
            raise NotImplementedError(
                f"mesh axis {tp[0]!r} of {mesh[tp[0]]} workers outside "
                f"dp_axes {tuple(dp_axes)} is tensor parallelism, which "
                "the shard_map DP step does not take (pure DP only, as "
                "in the JAX package): pass --dp-mode gspmd (ROADMAP "
                "queue 1, item 15.6) or a hierarchical --comm-plan")
    if error_feedback and dp_mode != "shardmap":
        raise ValueError(
            "error_feedback is only implemented for the explicit DP step "
            "(dp_mode='shardmap'); the one-device path has no "
            "worker-local gradients to correct")
    wire, bucketed = parse_compression(compression)
    if error_feedback and wire is None:
        raise ValueError("error_feedback requires a wire dtype "
                         f"(compression={compression!r})")
    if overlap_comm and dp_mode != "shardmap":
        raise ValueError(
            "overlap_comm launches explicit per-bucket collectives inside "
            "the backward pass, which only the data-parallel step has: "
            "pass dp_mode='shardmap'")
    if zero_dp and dp_mode != "shardmap":
        raise ValueError(
            "--zero reduce-scatters explicit per-bucket collectives, "
            "which only exist in the shard_map DP mode "
            "(dp_mode='shardmap'; GSPMD has zero_1 sharding constraints "
            "instead, DESIGN.md §9)")
    if bucketed and dp_mode == "none":
        raise ValueError(
            "bucketed gradient sync all-reduces explicit buckets, which "
            "only the data-parallel step has: pass dp_mode='shardmap'")
    if fused_bn:
        if cfg.family != "conv":
            raise ValueError(
                "--fused-bn fuses the ResNet BN sites; arch family "
                f"{cfg.family!r} has no BN")
        cfg = dataclasses.replace(cfg, fused_bn=True)
    if cfg.family != "conv" and sync_bn:
        raise ValueError(f"sync_bn makes BN cross-replica; arch family "
                         f"{cfg.family!r} has no BN")
    if input_cfg is not None and input_cfg.fused:
        if cfg.family != "conv":
            raise ValueError(
                "fused input transforms image batches; arch family "
                f"{cfg.family!r} has none")
        if dp_mode != "shardmap":
            raise ValueError(
                "fused input slices each worker's augmentation "
                "parameters inside the data-parallel step "
                "(dp_mode='shardmap'); use the host AugmentedSource "
                "path (fused=False) elsewhere")
    num_hosts = input_cfg.num_hosts if input_cfg else 1
    host_id = input_cfg.host_id if input_cfg else 0
    if remat is None:
        remat = (cfg.n_layers > 8 if parallel is None  # the JAX launcher's
                 else parallel.remat == "block")  # lower_cell's
    if dp_mode == "gspmd":
        if parallel is None:  # pure DP spans every mesh axis in dp_axes;
            # "model" is the TP axis otherwise (the JAX launcher's choice)
            parallel = ParallelConfig(
                dp_axes=tuple(dp_axes),
                tp_axis=None if "model" in dp_axes else "model",
                compression=parse_compression(compression)[0] or "none",
                zero_1=zero_1)
        return _build_gspmd(cfg, mesh, global_batch, seq_len, opt_cfg,
                            steps_per_epoch, compute_dtype, seed,
                            use_fused_kernel, label_smoothing, input_cfg,
                            sentinel, attention_impl, remat, parallel,
                            microbatches, draw_device, device)
    if dp_mode == "shardmap":
        dev = init_workers(device)
        world, me = world_size(), rank()
        if mesh is not None and math.prod(mesh.values()) != world:
            raise ValueError(
                f"mesh {'x'.join(map(str, mesh.values()))} lays out "
                f"{math.prod(mesh.values())} workers, this run has {world}")
        if global_batch % (world * num_hosts):
            raise ValueError(f"global batch {global_batch} must divide "
                             f"evenly over {num_hosts} host(s) x {world} "
                             f"workers")
    else:
        dev = resolve_device(device)
        world, me = 1, 0
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    train_cfg = TrainConfig(
        optimizer=opt_cfg,
        parallel=ParallelConfig(dp_axes=tuple(dp_axes),
                                compression=compression,
                                bucket_bytes=bucket_bytes, zero_1=False,
                                error_feedback=error_feedback,
                                overlap_comm=overlap_comm, zero_dp=zero_dp,
                                hier_split=hier_split),
        input=input_cfg, label_smoothing=label_smoothing,
        # the sentinel's whole-gradient health flag; the DP step
        # reports the norm of the synced gradient anyway
        log_grad_norm=sentinel and dp_mode != "shardmap")
    sync = cfg.family == "conv" and dp_mode == "shardmap" and sync_bn
    model = build_model(cfg, compute_dtype=compute_dtype,
                        attention_impl=attention_impl, remat=remat,
                        seed=seed, device=dev,
                        bn_group=dist.group.WORLD if sync else None)
    if cfg.family == "conv":  # drawn from seed when it was built
        params = {k: p.detach() for k, p in model.named_parameters()}
    else:
        params, _ = model.init_params(seed, draw_device=draw_device)
    # the packed-stream layout: always under --zero, and LARS on the
    # bucketed DP path
    stream = zero_dp or (opt_cfg.kind == "lars" and dp_mode == "shardmap"
                         and bucketed)
    zero_plan = None
    if stream:
        optimizer = make_stream_optimizer(opt_cfg, steps_per_epoch,
                                          global_batch,
                                          use_fused=use_fused_kernel)
        if zero_dp:  # this worker's shard of the stream
            zero_plan = zero_stream_plan(model, params, train_cfg, world)
            opt_state = optimizer.init(shard_size(zero_plan, world), dev)
        else:
            opt_state = optimizer.init(zero_padded_total(
                params, compression, bucket_bytes, world), dev)
    else:
        optimizer = make_optimizer(opt_cfg, steps_per_epoch, global_batch,
                                   use_fused=use_fused_kernel)
        opt_state = optimizer.init(params)
    state = {"params": params, "opt": opt_state,
             "model_state": init_model_state(model)}
    if error_feedback:
        state["ef_residual"] = init_error_feedback(params)
    put_batch = shardings = None
    if dp_mode == "shardmap":
        transform = make_batch_input_transform(input_cfg, seed, model, me,
                                               world)
        train_step = make_dp_shardmap_train_step(
            model, optimizer, train_cfg, input_transform=transform,
            mesh_shape=mesh)
        put_batch = make_put_batch(dev)
        # the JAX package's stream state is in ready order under
        # overlap_comm: its checkpoints are read and written so
        shardings = WorkerSharding(
            stream_order=overlap_stream_order(model, params)
            if stream and overlap_comm else None, zero_plan=zero_plan)
        # this host's rows, split over its workers in rank order
        data = make_data(cfg, shape, seed=seed, num_hosts=num_hosts * world,
                         host_id=host_id * world + me)
    else:
        train_step = make_train_step(model, optimizer, train_cfg,
                                     microbatches=microbatches)
        data = make_data(cfg, shape, seed=seed, num_hosts=num_hosts,
                         host_id=host_id)
    if sentinel:
        train_step = wrap_step_with_sentinel(train_step)
    data = _wrap_train_source(data, input_cfg, seed=seed,
                              global_batch=global_batch,
                              is_conv=cfg.family == "conv")
    return (model, state, _in_step_span(train_step), data, put_batch,
            shardings)


def _in_step_span(train_step):
    """``train_step`` (either signature, the sentinel's too) inside the
    ``step`` span (``repro_torch.spans``)."""
    @functools.wraps(train_step)
    def step(*args):
        with span("step"):
            return train_step(*args)
    return step


def _gspmd_checks(overlap_comm: bool, zero_dp: bool, error_feedback: bool,
                  hier_split, input_cfg) -> None:
    """The JAX launcher's refusals of the GSPMD mode, in its words."""
    if hier_split is not None:
        raise ValueError(
            "hier_split reschedules explicit per-bucket collectives, "
            "which only exist in the shard_map DP mode "
            "(dp_mode='shardmap', DESIGN.md §14)")
    if overlap_comm:
        raise ValueError(
            "overlap_comm launches explicit per-bucket collectives inside "
            "the backward pass, which only exists in the shard_map DP "
            "mode (dp_mode='shardmap', DESIGN.md §8)")
    if zero_dp:
        raise ValueError(
            "--zero reduce-scatters explicit per-bucket collectives, "
            "which only exist in the shard_map DP mode "
            "(dp_mode='shardmap'; GSPMD has zero_1 sharding constraints "
            "instead, DESIGN.md §9)")
    if input_cfg is not None and input_cfg.fused:
        raise ValueError(
            "fused input slices per-worker augmentation parameters "
            "with the worker's index, which only exists inside the "
            "shard_map DP step (dp_mode='shardmap', DESIGN.md §15); "
            "use the host AugmentedSource path (fused=False) elsewhere")
    if error_feedback:
        raise ValueError(
            "error_feedback is only implemented for the explicit "
            "shard_map DP mode on a mesh (dp_mode='shardmap'); the "
            "GSPMD path has no worker-local gradients to correct")


def _build_gspmd(cfg, mesh_sizes, global_batch, seq_len, opt_cfg,
                 steps_per_epoch, compute_dtype, seed, use_fused_kernel,
                 label_smoothing, input_cfg, sentinel, attention_impl, remat,
                 parallel, microbatches, draw_device, device):
    """``build_train_setup`` of ``dp_mode="gspmd"`` on a mesh, placed by
    ``parallel``."""
    from repro_torch.distributed.process_group import device_mesh
    from repro_torch.distributed.sharding import (make_rules, tree_shardings,
                                                  tree_specs)
    from repro_torch.interop import MeshSharding
    from repro_torch.optim.zero import zero_constraint, zero_shardings
    from repro_torch.training.gspmd import init_placed_opt, place_params
    dev = init_workers(device)
    mesh = device_mesh(tuple(mesh_sizes.values()), MESH_AXES,
                       device_type=dev.type)
    parallel = dataclasses.replace(
        parallel, compression=parse_compression(parallel.compression)[0]
        or "none")
    rules = make_rules(cfg, mesh, parallel)
    batch_dims = [i for i, a in enumerate(MESH_AXES)
                  if a in (rules["batch"] or ())]
    n_rows = math.prod(mesh.size(i) for i in batch_dims)
    row = 0
    for i in batch_dims:
        row = row * mesh.size(i) + mesh.get_local_rank(i)
    num_hosts = input_cfg.num_hosts if input_cfg else 1
    host_id = input_cfg.host_id if input_cfg else 0
    if global_batch % (n_rows * num_hosts):
        raise ValueError(f"global batch {global_batch} must divide evenly "
                         f"over {num_hosts} host(s) x {n_rows} rows of "
                         "workers")
    train_cfg = TrainConfig(optimizer=opt_cfg, parallel=parallel,
                            input=input_cfg, label_smoothing=label_smoothing,
                            log_grad_norm=sentinel)
    bn_group = None
    if cfg.family == "conv" and n_rows > 1:  # BN over the global batch
        bn_group = (mesh.get_group(batch_dims[0]) if len(batch_dims) == 1
                    else dist.group.WORLD if n_rows == world_size() else None)
        if bn_group is None:
            raise NotImplementedError(
                "global-batch BN over a batch split on several mesh axes "
                "of a mesh with a model axis")
    model = build_model(cfg, compute_dtype=compute_dtype,
                        attention_impl=attention_impl, remat=remat,
                        seed=seed, device=dev, bn_group=bn_group)
    params, axes = (model.init_params() if cfg.family == "conv" else
                    model.init_params(seed, draw_device=draw_device))
    placed = place_params(params, tree_shardings(axes, mesh, rules), mesh)
    del params
    optimizer = make_optimizer(opt_cfg, steps_per_epoch, global_batch,
                               use_fused=use_fused_kernel)
    fields = grad_constraint = None
    if parallel.zero_1:  # over the parameters' own specs (FSDP's too)
        fields = zero_shardings(placed, tree_specs(axes, rules), mesh,
                                parallel.dp_axes)
        grad_constraint = zero_constraint(fields)
    state = {"params": placed,
             "opt": init_placed_opt(optimizer, placed, fields),
             "model_state": init_model_state(model)}
    train_step = make_train_step(model, optimizer, train_cfg, mesh, rules,
                                 grad_constraint=grad_constraint,
                                 microbatches=microbatches)
    if sentinel:
        train_step = wrap_step_with_sentinel(train_step)
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    data = make_data(cfg, shape, seed=seed, num_hosts=num_hosts * n_rows,
                     host_id=host_id * n_rows + row)
    data = _wrap_train_source(data, input_cfg, seed=seed,
                              global_batch=global_batch,
                              is_conv=cfg.family == "conv")
    return (model, state, _in_step_span(train_step), data,
            make_put_batch(dev),
            MeshSharding(mesh=mesh, rules=rules, n_rows=n_rows, row=row))


def _wrap_train_source(data, input_cfg, *, seed, global_batch, is_conv):
    """The input pipeline's host-side wrappers of the conv family's
    images: fused -> stamp each batch with its step (the kernel's seed
    material); host augmentation -> the numpy mirror of the fused
    transform."""
    if input_cfg is None or not is_conv:
        return data
    if input_cfg.fused:
        return StepStampSource(data)
    return AugmentedSource(data, seed=seed, mean=input_cfg.mean,
                           std=input_cfg.std, max_shift=input_cfg.max_shift,
                           train=input_cfg.augment,
                           global_batch=global_batch)


def build_eval_setup(model, cfg, *, global_batch: int, seq_len: int,
                     dp_mode: str = "none", seed: int = 0,
                     input_cfg: Optional[InputConfig] = None,
                     shardings=None):
    """Validation pieces for ``Trainer``: (eval_step, val_data,
    finalize). Every worker evaluates the same held-out batches with the
    same statistics: on the data-parallel path ``finalize`` is the
    paper's pre-validation all-reduce of the workers' BN statistics
    (``finalize_worker_bn_stats``); on one device it is None (the
    identity). With ``input_cfg``, validation of the conv family applies
    the eval input variant (normalize + cast, no augmentation): the
    fused kernel when ``fused=True``, else on the host feed. An LM's
    validation batches are ``seq_len`` tokens a row, and its metrics its
    loss (no top-1), as in the JAX package. On the GSPMD path
    (``shardings`` the ``interop.MeshSharding`` of ``build_train_setup``)
    each worker evaluates its rows of every batch on the placed state,
    the metrics global, and ``finalize`` is None: the BN statistics are
    the global batch's already."""
    from repro_torch.interop import MeshSharding
    shape = ShapeConfig("val", seq_len, global_batch, "train")
    mesh = isinstance(shardings, MeshSharding)
    val_data = make_data(cfg, shape, seed=seed, split="val",
                         num_hosts=shardings.n_rows if mesh else 1,
                         host_id=shardings.row if mesh else 0)
    conv = cfg.family == "conv"
    fused_input = input_cfg is not None and input_cfg.fused and conv
    if input_cfg is not None and conv and not fused_input:
        val_data = AugmentedSource(val_data, seed=seed,
                                   mean=input_cfg.mean, std=input_cfg.std,
                                   train=False, global_batch=global_batch)
    finalize = finalize_worker_bn_stats if dp_mode == "shardmap" else None
    eval_step = (make_eval_step(model, mesh=shardings.mesh,
                                rules=shardings.rules) if mesh
                 else make_eval_step(model))
    if fused_input:
        base_eval = eval_step
        mean = torch.tensor(input_cfg.mean, dtype=torch.float32,
                            device=model.device)
        inv_std = 1.0 / torch.tensor(input_cfg.std, dtype=torch.float32,
                                     device=model.device)

        def eval_step(params, model_state, batch):
            batch = to_device(batch, model.device)
            batch["images"] = fused_input_eval(
                batch["images"], mean, inv_std,
                out_dtype=model.compute_dtype)
            return base_eval(params, model_state, batch)

    return eval_step, val_data, finalize


def _print_history(history) -> None:
    for h in history:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
              f"({h['time'] * 1e3:.0f} ms, data wait "
              f"{h['data_wait'] * 1e3:.1f} ms)")


def _write_json(path: str, record: Dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50,
                    help="step-driven run (no validation); ignored when "
                         "--epochs is given")
    ap.add_argument("--epochs", type=int, default=None,
                    help="epoch-driven run: epochs*steps-per-epoch steps "
                         "with held-out validation at epoch boundaries")
    ap.add_argument("--steps-per-epoch", type=int, default=20)
    ap.add_argument("--eval-every-epochs", type=int, default=1)
    ap.add_argument("--val-batches", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="tokens a row of an LM's batches")
    ap.add_argument("--optimizer", default="rmsprop_warmup",
                    choices=["rmsprop_warmup", "momentum_sgd", "lars"])
    ap.add_argument("--schedule", default="slow_start",
                    choices=["slow_start", "goyal", "poly", "constant"])
    ap.add_argument("--dp-mode", default="gspmd", choices=DP_MODES,
                    help="gspmd (the JAX launcher's default): one device "
                         "without --mesh, the GSPMD step on a DTensor "
                         "mesh with it (model axis: tensor parallel); "
                         "none: one device; shardmap: the paper's "
                         "data-parallel step, one process per worker "
                         "(run several with torchrun)")
    ap.add_argument("--compression", default="bf16",
                    choices=["none", "bf16", "f16", "bucketed",
                             "bf16+bucketed", "f16+bucketed"],
                    help="gradient wire format (paper §3); +bucketed: one "
                         "all-reduce per bucket (shardmap only)")
    ap.add_argument("--bucket-mib", type=int, default=64,
                    help="bucket size in MiB for the +bucketed modes")
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="the fused update kernels (hybrid update; "
                         "stream-LARS norms and update)")
    ap.add_argument("--fused-bn", action="store_true",
                    help="fused BN kernels at every ResNet BN site")
    ap.add_argument("--fused-input", action="store_true",
                    help="augment + normalize + cast in one kernel on "
                         "the device (shardmap only)")
    ap.add_argument("--data-workers", type=int, default=1,
                    help="host input-producer threads")
    ap.add_argument("--host-shard", default=None, metavar="H/N",
                    help="per-host input sharding: this run reads only "
                         "shard H of N of every global batch, e.g. 0/4 "
                         "(on the DP path split over its workers)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry each worker's wire rounding residual into "
                         "its next step (shardmap only)")
    ap.add_argument("--overlap-comm", action="store_true")
    ap.add_argument("--zero", action="store_true",
                    help="reduce-scatter the buckets and shard the "
                         "optimizer update and state over the workers "
                         "(shardmap, bucketed compression, >= 2 workers)")
    ap.add_argument("--sync-bn", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="the workers laid out over (data, model), D x M "
                         "of them (gspmd: M-way tensor parallel; "
                         "shardmap: pure DP, a hierarchical --comm-plan "
                         "when M > 1)")
    ap.add_argument("--comm-plan", default="flat",
                    help="collective schedule: flat | hier[:k] | auto | "
                         "<path>. 'hier:k' splits the mesh's axes at k "
                         "into an intra-node reduce-scatter -> "
                         "inter-node all-reduce -> intra-node all-gather "
                         "per bucket; 'auto' loads "
                         "results/comm_plan_{arch}_{DxM}.json and a plan "
                         "file applies its whole wire configuration")
    ap.add_argument("--label-smoothing", type=float, default=0.0,
                    help="label smoothing epsilon (large-batch recipes "
                         "pair it with --schedule poly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(DTYPES))
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the JAX package's format); "
                         "a run resumes from its newest intact checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sentinel", action="store_true",
                    help="divergence sentinel + recovery state machine: "
                         "skip non-finite/spiking steps, roll back to the "
                         "last good checkpoint after repeated bad steps "
                         "(needs --epochs and, for rollback, --ckpt-dir)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'nan_grad@6,ckpt_truncate@10,seed=3' "
                         "(resilience/chaos.py grammar; implies "
                         "--sentinel)")
    ap.add_argument("--event-log", default=None,
                    help="JSONL path for resilience events")
    ap.add_argument("--log-json", default=None, metavar="PATH",
                    help="write the run's history (and, epoch-driven, its "
                         "eval history, best, events) as JSON, the JAX "
                         "launcher's keys; rank 0 writes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.chaos:
        args.sentinel = True
    if args.sentinel and args.epochs is None:
        ap.error("--sentinel/--chaos need the epoch-driven loop: "
                 "pass --epochs")
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
        except ValueError:
            ap.error("--mesh expects DxM, e.g. 2x2")
        if len(mesh_shape) != 2:
            ap.error("--mesh expects DxM, e.g. 2x2")
    # --comm-plan: the grammar forms (flat / hier[:k]) only reschedule;
    # a plan loaded from disk (auto / path) carries its wire config
    dp_axes, hier_split, plan = ("data",), None, None
    compression = args.compression
    bucket_bytes = args.bucket_mib * 1024 * 1024
    overlap_comm, zero_dp = args.overlap_comm, args.zero
    if args.comm_plan != "flat":
        if args.dp_mode != "shardmap":
            ap.error("--comm-plan reschedules explicit per-bucket "
                     "collectives: pass --dp-mode shardmap")
        from repro_torch.distributed.comm_plan import resolve_comm_plan
        world = (world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        plan = resolve_comm_plan(args.comm_plan, arch=args.arch,
                                 mesh_shape=mesh_shape or (world, 1),
                                 dp_axes=MESH_AXES)
        if plan is not None:
            hier_split = plan.hier_split
            if hier_split is not None:
                dp_axes = plan.dp_axes  # pure DP over the whole mesh
            if plan.bucket_bytes:  # a loaded plan: its wire config
                compression = plan.compression
                bucket_bytes = plan.bucket_bytes
                overlap_comm = plan.sync_mode in ("overlap", "zero_overlap")
                zero_dp = plan.sync_mode in ("zero", "zero_overlap")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    opt_cfg = OptimizerConfig(kind=args.optimizer, schedule=args.schedule)
    input_cfg = None
    if args.fused_input or args.host_shard:
        num_hosts, host_id = 1, 0
        if args.host_shard:
            try:
                host_id, num_hosts = (int(x)
                                      for x in args.host_shard.split("/"))
            except ValueError:
                ap.error("--host-shard expects H/N, e.g. 0/4")
        input_cfg = InputConfig(fused=args.fused_input,
                                num_workers=args.data_workers,
                                num_hosts=num_hosts, host_id=host_id)
    try:
        model, state, train_step, data, put_batch, shardings = \
            build_train_setup(
                cfg, global_batch=args.global_batch, seq_len=args.seq_len,
                opt_cfg=opt_cfg, steps_per_epoch=args.steps_per_epoch,
                dp_mode=args.dp_mode,
                compute_dtype=DTYPES[args.compute_dtype], seed=args.seed,
                use_fused_kernel=args.use_fused_kernel,
                sync_bn=args.sync_bn, compression=compression,
                bucket_bytes=bucket_bytes,
                error_feedback=args.error_feedback,
                overlap_comm=overlap_comm, zero_dp=zero_dp,
                fused_bn=args.fused_bn,
                label_smoothing=args.label_smoothing, input_cfg=input_cfg,
                sentinel=args.sentinel, dp_axes=dp_axes,
                hier_split=hier_split, mesh_shape=mesh_shape,
                device=args.device)
        if plan is not None and rank() == 0:
            print(f"comm plan: {plan.describe()}")
        metadata = {"arch": args.arch, "optimizer": args.optimizer,
                    "opt_layout": "zero_stream" if zero_dp else "tree"}
        t0 = time.time()
        if args.epochs is None:  # the step-driven run, no validation
            result = run_training(
                train_step, state, data,
                LoopConfig(total_steps=args.steps,
                           checkpoint_every=args.ckpt_every,
                           checkpoint_dir=args.ckpt_dir,
                           data_workers=args.data_workers,
                           log_every=max(1, args.steps // 20)),
                put_batch=put_batch, metadata=metadata,
                state_shardings=shardings)
            wall = time.time() - t0
            if rank() == 0:
                print(f"trained {args.steps} steps in {wall:.1f}s on "
                      f"{model.device} (dp_mode={args.dp_mode}, "
                      f"{world_size()} worker(s), "
                      f"resumed_from={result.resumed_from})")
                _print_history(result.history)
                if args.log_json:
                    _write_json(args.log_json, {
                        "history": result.history, "wall": wall,
                        "resumed_from": result.resumed_from})
            return result
        eval_step, val_data, finalize = build_eval_setup(
            model, cfg, global_batch=args.global_batch, seq_len=args.seq_len,
            dp_mode=args.dp_mode, seed=args.seed, input_cfg=input_cfg,
            shardings=shardings)
        tcfg = TrainerConfig(
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            eval_every_epochs=args.eval_every_epochs,
            val_batches=args.val_batches,
            checkpoint_every=args.ckpt_every if args.ckpt_dir else 0,
            checkpoint_dir=args.ckpt_dir,
            log_every=max(1, args.epochs * args.steps_per_epoch // 20),
            data_workers=args.data_workers)
        resilience = chaos = None
        if args.sentinel:
            resilience = ResilienceConfig(event_log=args.event_log)
            if args.chaos:
                chaos = parse_chaos(args.chaos, seed=args.seed)
        result = Trainer(train_step, state, data, tcfg, eval_step=eval_step,
                         val_data=val_data, finalize_state=finalize,
                         put_batch=put_batch, metadata=metadata,
                         state_shardings=shardings, resilience=resilience,
                         chaos=chaos).run()
        wall = time.time() - t0
        if rank() == 0:
            print(f"trained {args.epochs} epochs x {args.steps_per_epoch} "
                  f"steps in {wall:.1f}s on {model.device} "
                  f"(dp_mode={args.dp_mode}, {world_size()} worker(s), "
                  f"resumed_from={result.resumed_from})")
            if result.events:
                kinds: Dict[str, int] = {}
                for r in result.events:
                    kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
                print("resilience events: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(kinds.items())))
            _print_history(result.history)
            for r in result.epoch_history:
                top1 = r.get("top1")  # an LM evaluates its loss only
                t = f"val top1 {top1:.4f} " if top1 is not None else ""
                print(f"  epoch {r['epoch']:3d} {t}val loss {r['loss']:.4f}")
            if result.best:
                print(f"best: top1 {result.best['top1']:.4f} at epoch "
                      f"{result.best['epoch']}")
            if args.log_json:
                _write_json(args.log_json, {
                    "history": result.history,
                    "epoch_history": result.epoch_history,
                    "best": result.best, "wall": wall,
                    "resumed_from": result.resumed_from,
                    "events": result.events})
        return result
    finally:
        shutdown()


if __name__ == "__main__":
    main()
