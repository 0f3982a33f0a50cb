"""End-to-end training program: the paper's recipe for ResNet-50
(hybrid RMSprop warm-up, slow-start LR, the bf16 gradient wire format,
BN without moving averages, optionally the fused BN, update and input
kernels) on synthetic data, with held-out validation at epoch
boundaries (``--epochs``; without it, ``--steps`` steps of the
step-driven ``run_training``, no eval). On one device (``--dp-mode
none``), or data-parallel with one process per worker (``--dp-mode
shardmap``, the paper's own run).
``--optimizer lars`` on the bucketed DP path runs LARS on the packed
gradient stream (the stream-LARS kernels with ``--use-fused-kernel``).
``--ckpt-dir`` checkpoints in the JAX package's format and resumes from
the newest intact checkpoint; ``--sentinel`` adds the divergence
sentinel and the recovery state machine, ``--chaos`` deterministic
fault injection:

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
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --epochs 3 --steps-per-epoch 5 --global-batch 16 --sentinel \\
        --chaos "nan_grad@7-9" --ckpt-dir /tmp/ck --ckpt-every 5 \\
        --event-log /tmp/events.jsonl --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

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
from repro_torch.optim.stream import make_stream_optimizer, zero_padded_total
from repro_torch.resilience import (ResilienceConfig, parse_chaos,
                                    wrap_step_with_sentinel)
from repro_torch.training import (LoopConfig, Trainer, TrainerConfig,
                                  run_training)
from repro_torch.training.step import (
    finalize_worker_bn_stats,
    make_batch_input_transform,
    make_dp_shardmap_train_step,
    make_eval_step,
    make_train_step,
    to_device,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DP_MODES = ("none", "shardmap")


def _unported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def build_train_setup(cfg, *, global_batch: int, seq_len: int,
                      opt_cfg: OptimizerConfig, steps_per_epoch: int,
                      dp_mode: str = "none",
                      compute_dtype=torch.float32, seed: int = 0,
                      use_fused_kernel: bool = False,
                      sync_bn: bool = False, compression: str = "bf16",
                      bucket_bytes: int = 64 * 1024 * 1024,
                      error_feedback: bool = False,
                      overlap_comm: bool = False, zero_dp: bool = False,
                      fused_bn: bool = False,
                      label_smoothing: float = 0.0,
                      input_cfg: Optional[InputConfig] = None,
                      sentinel: bool = False,
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
    as the JAX package does) and None on one device. ``seq_len`` is
    unused by the conv family.

    ``sentinel`` wraps the step with the divergence sentinel
    (``resilience.wrap_step_with_sentinel``): it becomes the
    ``(state, batch, controls)`` step the ``Trainer``'s recovery state
    machine drives. On one device this turns on the step's
    ``grad_norm`` (one extra reduction); the data-parallel step reports
    it already.

    LARS on the bucketed DP path is the packed-stream optimizer
    (``optim/stream.py``; its state is one flat padded ``delta``), as in
    the JAX package; elsewhere it is the per-leaf LARS.
    ``error_feedback`` (DP path only, with a wire dtype) adds each
    worker's residual to the state as ``ef_residual``.

    ``input_cfg`` turns on per-sample augmentation; with ``fused=True``
    augment + normalize + cast run on the device in the fused input
    kernel inside the DP step (``dp_mode="shardmap"`` and the conv
    family only, as in the JAX package), else on the host feed
    (``AugmentedSource``)."""
    del seq_len
    if dp_mode not in DP_MODES:
        raise ValueError(f"dp_mode must be one of {DP_MODES}, got "
                         f"{dp_mode!r}")
    if error_feedback and dp_mode != "shardmap":
        raise ValueError(
            "error_feedback is only implemented for the explicit DP step "
            "(dp_mode='shardmap'); the one-device path has no "
            "worker-local gradients to correct")
    wire, bucketed = parse_compression(compression)
    if error_feedback and wire is None:
        raise ValueError("error_feedback requires a wire dtype "
                         f"(compression={compression!r})")
    if sync_bn:
        raise _unported("cross-replica BN (sync-BN)", 6)
    if overlap_comm:
        raise _unported("overlapped gradient sync (--overlap-comm)", 10)
    if zero_dp:
        raise _unported("ZeRO sync (--zero)", 11)
    if bucketed and dp_mode != "shardmap":
        raise ValueError(
            "bucketed gradient sync all-reduces explicit buckets, which "
            "only the data-parallel step has: pass dp_mode='shardmap'")
    if fused_bn:
        if cfg.family != "conv":
            raise ValueError(
                "--fused-bn fuses the ResNet BN sites; arch family "
                f"{cfg.family!r} has no BN")
        cfg = dataclasses.replace(cfg, fused_bn=True)
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
    if dp_mode == "shardmap":
        if input_cfg is not None and input_cfg.num_hosts != 1:
            raise ValueError("the data-parallel path shards every batch "
                             "over its workers; input_cfg.num_hosts must "
                             "be 1")
        dev = init_workers(device)
        world, me = world_size(), rank()
        if global_batch % world:
            raise ValueError(f"global batch {global_batch} must divide "
                             f"evenly over {world} workers")
    else:
        dev = resolve_device(device)
        world, me = 1, 0
    shape = ShapeConfig("train", 0, global_batch, "train")
    train_cfg = TrainConfig(
        optimizer=opt_cfg,
        parallel=ParallelConfig(compression=compression,
                                bucket_bytes=bucket_bytes, zero_1=False,
                                error_feedback=error_feedback),
        input=input_cfg, label_smoothing=label_smoothing,
        # the sentinel's whole-gradient health flag; the DP step
        # reports the norm of the synced gradient anyway
        log_grad_norm=sentinel and dp_mode != "shardmap")
    model = build_model(cfg, compute_dtype=compute_dtype, seed=seed,
                        device=dev)
    params = {k: p.detach() for k, p in model.named_parameters()}
    # the packed-stream layout: LARS on the bucketed DP path
    if opt_cfg.kind == "lars" and dp_mode == "shardmap" and bucketed:
        optimizer = make_stream_optimizer(opt_cfg, steps_per_epoch,
                                          global_batch,
                                          use_fused=use_fused_kernel)
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
            model, optimizer, train_cfg, input_transform=transform)
        put_batch = make_put_batch(dev)
        shardings = WorkerSharding()
        data = make_data(cfg, shape, seed=seed, num_hosts=world,
                         host_id=me)
    else:
        train_step = make_train_step(model, optimizer, train_cfg)
        data = make_data(
            cfg, shape, seed=seed,
            num_hosts=input_cfg.num_hosts if input_cfg else 1,
            host_id=input_cfg.host_id if input_cfg else 0)
    if sentinel:
        train_step = wrap_step_with_sentinel(train_step)
    data = _wrap_train_source(data, input_cfg, seed=seed,
                              global_batch=global_batch)
    return model, state, train_step, data, put_batch, shardings


def _wrap_train_source(data, input_cfg, *, seed, global_batch):
    """The input pipeline's host-side wrappers: fused -> stamp each
    batch with its step (the kernel's seed material); host augmentation
    -> the numpy mirror of the fused transform."""
    if input_cfg is None:
        return data
    if input_cfg.fused:
        return StepStampSource(data)
    return AugmentedSource(data, seed=seed, mean=input_cfg.mean,
                           std=input_cfg.std, max_shift=input_cfg.max_shift,
                           train=input_cfg.augment,
                           global_batch=global_batch)


def build_eval_setup(model, cfg, *, global_batch: int, seq_len: int,
                     dp_mode: str = "none", seed: int = 0,
                     input_cfg: Optional[InputConfig] = None):
    """Validation pieces for ``Trainer``: (eval_step, val_data,
    finalize). Every worker evaluates the same held-out batches with the
    same statistics: on the data-parallel path ``finalize`` is the
    paper's pre-validation all-reduce of the workers' BN statistics
    (``finalize_worker_bn_stats``); on one device it is None (the
    identity). With ``input_cfg``, validation applies the eval input
    variant (normalize + cast, no augmentation): the fused kernel when
    ``fused=True``, else on the host feed."""
    del seq_len
    shape = ShapeConfig("val", 0, global_batch, "train")
    val_data = make_data(cfg, shape, seed=seed, split="val")
    fused_input = input_cfg is not None and input_cfg.fused
    if input_cfg is not None and not fused_input:
        val_data = AugmentedSource(val_data, seed=seed,
                                   mean=input_cfg.mean, std=input_cfg.std,
                                   train=False, global_batch=global_batch)
    finalize = finalize_worker_bn_stats if dp_mode == "shardmap" else None
    eval_step = make_eval_step(model)
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
    ap.add_argument("--optimizer", default="rmsprop_warmup",
                    choices=["rmsprop_warmup", "momentum_sgd", "lars"])
    ap.add_argument("--schedule", default="slow_start",
                    choices=["slow_start", "goyal", "poly", "constant"])
    ap.add_argument("--dp-mode", default="none", choices=DP_MODES,
                    help="none: one device; shardmap: the paper's "
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
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry each worker's wire rounding residual into "
                         "its next step (shardmap only)")
    ap.add_argument("--overlap-comm", action="store_true")
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--sync-bn", action="store_true")
    ap.add_argument("--comm-plan", default="flat")
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.chaos:
        args.sentinel = True
    if args.sentinel and args.epochs is None:
        ap.error("--sentinel/--chaos need the epoch-driven loop: "
                 "pass --epochs")
    if args.comm_plan != "flat":
        raise _unported("hierarchical collective plans (--comm-plan)", 13)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    opt_cfg = OptimizerConfig(kind=args.optimizer, schedule=args.schedule)
    input_cfg = (InputConfig(fused=True, num_workers=args.data_workers)
                 if args.fused_input else None)
    try:
        model, state, train_step, data, put_batch, shardings = \
            build_train_setup(
                cfg, global_batch=args.global_batch, seq_len=0,
                opt_cfg=opt_cfg, steps_per_epoch=args.steps_per_epoch,
                dp_mode=args.dp_mode,
                compute_dtype=DTYPES[args.compute_dtype], seed=args.seed,
                use_fused_kernel=args.use_fused_kernel,
                sync_bn=args.sync_bn, compression=args.compression,
                bucket_bytes=args.bucket_mib * 1024 * 1024,
                error_feedback=args.error_feedback,
                overlap_comm=args.overlap_comm, zero_dp=args.zero,
                fused_bn=args.fused_bn,
                label_smoothing=args.label_smoothing, input_cfg=input_cfg,
                sentinel=args.sentinel, device=args.device)
        metadata = {"arch": args.arch, "optimizer": args.optimizer,
                    "opt_layout": "tree"}
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
            if rank() == 0:
                print(f"trained {args.steps} steps in "
                      f"{time.time() - t0:.1f}s on {model.device} "
                      f"(dp_mode={args.dp_mode}, {world_size()} worker(s), "
                      f"resumed_from={result.resumed_from})")
                _print_history(result.history)
            return result
        eval_step, val_data, finalize = build_eval_setup(
            model, cfg, global_batch=args.global_batch, seq_len=0,
            dp_mode=args.dp_mode, seed=args.seed, input_cfg=input_cfg)
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
                print(f"  epoch {r['epoch']:3d} val top1 {r['top1']:.4f} "
                      f"val loss {r['loss']:.4f}")
            if result.best:
                print(f"best: top1 {result.best['top1']:.4f} at epoch "
                      f"{result.best['epoch']}")
        return result
    finally:
        shutdown()


if __name__ == "__main__":
    main()
