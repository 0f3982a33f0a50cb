"""Quickstart on the PyTorch port: train a reduced ResNet-50 with the
paper's full recipe (RMSprop warm-up + slow-start LR + BN without moving
averages) on the synthetic ImageNet-like task, with held-out validation
every epoch and the best checkpoint kept, as ``examples/quickstart.py``
does with the JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import OptimizerConfig, get_config, reduced_config  # noqa: E402
from repro_torch.launch.train import build_eval_setup, build_train_setup  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402

GLOBAL_BATCH = 64


def run(epochs: int = 6, steps_per_epoch: int = 10, device: str = "cuda",
        ckpt_dir=None, init_params=None):
    """Train ``epochs`` x ``steps_per_epoch`` steps at batch 64, validate
    on 2 held-out batches every epoch and keep the best checkpoint in
    ``ckpt_dir`` (a fresh temporary directory when None). ``init_params``
    (the port's parameter names -> arrays) replaces the initial weights,
    e.g. with the JAX package's. Returns the ``TrainResult`` and the
    checkpoint directory."""
    cfg = reduced_config(get_config("resnet50"))
    opt_cfg = OptimizerConfig(
        kind="rmsprop_warmup",  # the paper's hybrid optimizer (A.1)
        schedule="slow_start",  # the paper's LR schedule (A.2)
        beta_center=2.0, beta_period=1.0,  # scaled to this tiny run
    )
    model, state, train_step, data, put_batch, shardings = \
        build_train_setup(cfg, global_batch=GLOBAL_BATCH, seq_len=16,
                          opt_cfg=opt_cfg, steps_per_epoch=steps_per_epoch,
                          device=device)
    if init_params is not None:
        with torch.no_grad():
            for k, p in state["params"].items():
                p.copy_(torch.as_tensor(init_params[k]))
    # the held-out split (disjoint from train by construction)
    eval_step, val_data, finalize = build_eval_setup(
        model, cfg, global_batch=GLOBAL_BATCH, seq_len=16)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="quickstart_ckpt_")
    result = Trainer(
        train_step, state, data,
        TrainerConfig(epochs=epochs, steps_per_epoch=steps_per_epoch,
                      eval_every_epochs=1, val_batches=2,
                      checkpoint_every=30, checkpoint_dir=ckpt_dir,
                      log_every=10),
        eval_step=eval_step, val_data=val_data, finalize_state=finalize,
        put_batch=put_batch).run()
    return result, ckpt_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result, ckpt_dir = run(args.epochs, args.steps_per_epoch, args.device)
    print("held-out accuracy per epoch:")
    for r in result.epoch_history:
        print(f"  epoch {r['epoch']:2d}  top1 {r['top1']:.3f}  "
              f"val loss {r['loss']:.4f}")
    print(f"best: top1 {result.best['top1']:.3f} at epoch "
          f"{result.best['epoch']} (retained in {ckpt_dir}/best)")
    return result


if __name__ == "__main__":
    main()
