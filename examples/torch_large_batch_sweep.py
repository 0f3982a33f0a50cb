"""Batch-scaling sweep on the PyTorch port: the paper's central claim as
a measurement harness, as ``examples/large_batch_sweep.py`` runs it with
the JAX package. Scale the global batch with the linear LR rule and
compare the recipes per batch size:

  * ``paper_baseline`` — the paper's hybrid RMSprop warm-up +
    slow-start LR (arXiv:1711.04325 §2);
  * ``lars`` — layer-wise trust ratios (You et al., the paper's Table 1
    competitor [10] at B=16k);
  * ``lars_ls_poly`` — LARS + label smoothing + polynomial LR decay,
    the standard >=32k-batch recipe.

Each (recipe, batch) cell trains a reduced ResNet-50 on one device on
the synthetic class-template task and records the tail loss/accuracy,
in the JSON schema of the JAX script's ``BENCH_scaling.json`` (``backend``
is the torch device type, ``devices`` the device count). It writes
``results/BENCH_scaling_torch.json`` by default; ``--quick`` runs the
CI-sized grid.

    PYTHONPATH=src python examples/torch_large_batch_sweep.py [--quick] \
        [--device cpu] [--out results/BENCH_scaling_torch.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import OptimizerConfig, get_config, reduced_config  # noqa: E402
from repro_torch.launch.train import build_train_setup  # noqa: E402

# recipe -> (optimizer kind, LR schedule, label smoothing). The batch
# points below proxy the paper's 256 -> 32k scaling range: lr_scale is
# the linear-rule multiplier on base_lr_per_256, so lr_scale ~ B/256 of
# the full-size run each point stands in for.
RECIPES = {
    "paper_baseline": ("rmsprop_warmup", "slow_start", 0.0),
    "lars": ("lars", "slow_start", 0.0),
    "lars_ls_poly": ("lars", "poly", 0.1),
}

# (global_batch, lr_scale): reduced-config proxies for 256 -> 32k
POINTS_FULL = ((32, 1.0), (64, 2.0), (128, 8.0), (256, 24.0))
POINTS_QUICK = ((32, 1.0), (64, 2.0), (128, 8.0))

DEFAULT_OUT = os.path.join("results", "BENCH_scaling_torch.json")


def train_once(kind, schedule, label_smoothing, global_batch, lr_scale,
               steps, steps_per_epoch, device="cuda", init_params=None):
    """``steps`` steps of one cell; returns (losses, accuracies).
    ``init_params`` (the port's parameter names -> arrays) replaces the
    initial weights, e.g. with the JAX package's."""
    cfg = reduced_config(get_config("resnet50"))
    opt_cfg = OptimizerConfig(kind=kind, schedule=schedule,
                              base_lr_per_256=0.1 * lr_scale,
                              beta_center=1.0, beta_period=1.0,
                              warmup_epochs=1.0,
                              total_epochs=max(1.0,
                                               steps / steps_per_epoch))
    model, state, step_fn, data, _, _ = build_train_setup(
        cfg, global_batch=global_batch, seq_len=16, opt_cfg=opt_cfg,
        steps_per_epoch=steps_per_epoch,
        label_smoothing=label_smoothing, device=device)
    if init_params is not None:
        with torch.no_grad():
            for k, p in state["params"].items():
                p.copy_(torch.as_tensor(init_params[k]))
    losses, accs = [], []
    for s in range(steps):
        state, metrics = step_fn(state, data.batch_at(s))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["accuracy"]))
    return losses, accs


def _tail(values, losses):
    """Mean over the last-5 finite-loss steps; None once diverged."""
    tail = [v for v, l in zip(values[-5:], losses[-5:]) if np.isfinite(l)]
    return float(np.mean(tail)) if tail else None


def run_sweep(quick: bool, steps: int, steps_per_epoch: int,
              device: str = "cuda"):
    points = POINTS_QUICK if quick else POINTS_FULL
    recipes = []
    print(f"{'recipe':>14s} {'batch':>6s} {'lr_scale':>9s} "
          f"{'final loss':>11s} {'final top1':>11s}")
    for name, (kind, schedule, ls_eps) in RECIPES.items():
        rows = []
        for batch, lr_scale in points:
            losses, accs = train_once(kind, schedule, ls_eps, batch,
                                      lr_scale, steps, steps_per_epoch,
                                      device)
            final_loss = _tail(losses, losses)
            final_acc = _tail(accs, losses)
            diverged = final_loss is None
            rows.append({"global_batch": batch, "lr_scale": lr_scale,
                         "final_loss": final_loss,
                         "final_accuracy": final_acc,
                         "diverged": diverged})
            fl = "diverged" if diverged else f"{final_loss:.3f}"
            fa = "-" if final_acc is None else f"{final_acc:.3f}"
            print(f"{name:>14s} {batch:6d} {lr_scale:9.1f} {fl:>11s} "
                  f"{fa:>11s}", flush=True)
        recipes.append({"recipe": name, "optimizer": kind,
                        "schedule": schedule,
                        "label_smoothing": ls_eps, "points": rows})
    dev = torch.device(device)
    return {
        "bench": "scaling_sweep",
        "arch": "resnet50-reduced",
        "backend": dev.type,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "quick": quick,
        "steps": steps,
        "steps_per_epoch": steps_per_epoch,
        "batches": [b for b, _ in points],
        "recipes": recipes,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized grid: fewer points, fewer steps")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per cell (default: 30, or 10 w/ --quick)")
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    steps = args.steps or (10 if args.quick else 30)

    result = run_sweep(args.quick, steps, args.steps_per_epoch, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"\nwrote {args.out}")
    print("expected: at high lr_scale the trust-ratio recipes stay "
          "stable/lower while the warm-up-only baseline degrades first.")
    return result


if __name__ == "__main__":
    main()
