"""End-to-end training program on one device: the paper's recipe for
ResNet-50 (hybrid RMSprop warm-up, slow-start LR, the bf16 wire cast of
the gradients, BN without moving averages, optionally fused BN kernels),
on synthetic data, with held-out validation at epoch boundaries.

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
        --reduced --epochs 2 --steps-per-epoch 5 --global-batch 16 \\
        --fused-bn --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import torch

from repro_torch.configs import (
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    reduced_config,
)
from repro_torch.core.compression import parse_compression
from repro_torch.data import make_data
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model, init_model_state
from repro_torch.optim import make_optimizer
from repro_torch.training import Trainer, TrainerConfig
from repro_torch.training.step import make_eval_step, make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_train_setup(cfg, *, global_batch: int, seq_len: int,
                      opt_cfg: OptimizerConfig, steps_per_epoch: int,
                      compute_dtype=torch.float32, seed: int = 0,
                      compression: str = "bf16", fused_bn: bool = False,
                      label_smoothing: float = 0.0,
                      device: DeviceLike = "cuda"):
    """Returns (model, state, train_step, data, put_batch,
    state_shardings) for one device, as the JAX package's no-mesh path.

    ``state`` is ``{"params", "opt", "model_state"}``; its params are the
    model's own parameters (updated in place by the optimizer).
    ``put_batch`` and ``state_shardings`` are None: the train step moves
    each host batch to the device itself, and nothing is sharded.
    ``seq_len`` is unused by the conv family and kept for the JAX
    signature. The multi-device setups are ROADMAP queue 1, item 6."""
    del seq_len
    _, bucketed = parse_compression(compression)
    if bucketed:
        raise NotImplementedError(
            "bucketed gradient sync needs more than one worker (ROADMAP "
            "queue 1, item 6)")
    dev = resolve_device(device)
    if fused_bn:
        if cfg.family != "conv":
            raise ValueError(
                "--fused-bn fuses the ResNet BN sites; arch family "
                f"{cfg.family!r} has no BN")
        cfg = dataclasses.replace(cfg, fused_bn=True)
    shape = ShapeConfig("train", 0, global_batch, "train")
    train_cfg = TrainConfig(
        optimizer=opt_cfg,
        parallel=ParallelConfig(compression=compression, zero_1=False),
        label_smoothing=label_smoothing)
    model = build_model(cfg, compute_dtype=compute_dtype, seed=seed,
                        device=dev)
    optimizer = make_optimizer(opt_cfg, steps_per_epoch, global_batch)
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = {"params": params, "opt": optimizer.init(params),
             "model_state": init_model_state(model)}
    train_step = make_train_step(model, optimizer, train_cfg)
    data = make_data(cfg, shape, seed=seed)
    return model, state, train_step, data, None, None


def build_eval_setup(model, cfg, *, global_batch: int, seq_len: int,
                     seed: int = 0):
    """Validation pieces for ``Trainer``: (eval_step, val_data,
    finalize). On one device the BN statistics need no all-reduce before
    eval, so ``finalize`` is None (the identity). The eval step runs on
    the model's device."""
    del seq_len
    shape = ShapeConfig("val", 0, global_batch, "train")
    val_data = make_data(cfg, shape, seed=seed, split="val")
    return make_eval_step(model), val_data, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=20)
    ap.add_argument("--eval-every-epochs", type=int, default=1)
    ap.add_argument("--val-batches", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--optimizer", default="rmsprop_warmup",
                    choices=["rmsprop_warmup", "momentum_sgd"])
    ap.add_argument("--schedule", default="slow_start",
                    choices=["slow_start", "goyal", "poly", "constant"])
    ap.add_argument("--compression", default="bf16",
                    choices=["none", "bf16", "f16"],
                    help="gradient wire format (paper §3)")
    ap.add_argument("--fused-bn", action="store_true",
                    help="fused BN kernels at every ResNet BN site")
    ap.add_argument("--label-smoothing", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    opt_cfg = OptimizerConfig(kind=args.optimizer, schedule=args.schedule)
    model, state, train_step, data, _, _ = build_train_setup(
        cfg, global_batch=args.global_batch, seq_len=0, opt_cfg=opt_cfg,
        steps_per_epoch=args.steps_per_epoch,
        compute_dtype=DTYPES[args.compute_dtype], seed=args.seed,
        compression=args.compression, fused_bn=args.fused_bn,
        label_smoothing=args.label_smoothing, device=args.device)
    eval_step, val_data, finalize = build_eval_setup(
        model, cfg, global_batch=args.global_batch, seq_len=0,
        seed=args.seed)
    tcfg = TrainerConfig(
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        eval_every_epochs=args.eval_every_epochs,
        val_batches=args.val_batches,
        log_every=max(1, args.epochs * args.steps_per_epoch // 20))
    t0 = time.time()
    result = Trainer(train_step, state, data, tcfg, eval_step=eval_step,
                     val_data=val_data, finalize_state=finalize).run()
    wall = time.time() - t0
    print(f"trained {args.epochs} epochs x {args.steps_per_epoch} steps "
          f"in {wall:.1f}s on {resolve_device(args.device)}")
    for h in result.history:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
              f"({h['time'] * 1e3:.0f} ms)")
    for r in result.epoch_history:
        print(f"  epoch {r['epoch']:3d} val top1 {r['top1']:.4f} "
              f"val loss {r['loss']:.4f}")
    if result.best:
        print(f"best: top1 {result.best['top1']:.4f} at epoch "
              f"{result.best['epoch']}")
    return result


if __name__ == "__main__":
    main()
