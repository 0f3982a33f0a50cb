"""Step builders for one device.

``make_train_step`` is the single-device step of the JAX package's
``make_train_step`` with no mesh: cast every float parameter to the
compute dtype, take the loss and its gradients (accumulated over
``microbatches`` if asked), round-trip the gradients through the wire
dtype of ``compression`` (paper §3), and apply the optimizer. The
multi-device sync modes are later slices (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.compression import parse_compression, simulate_wire_cast
from repro_torch.optim.interface import Optimizer

Tree = Dict[str, Any]


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch (numpy or tensors) -> tensors on ``device``; labels
    become int64 (the index type of ``gather``)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        if k == "labels":
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(model, optimizer: Optimizer, train_cfg: TrainConfig,
                    microbatches: int = 1):
    """Train step: (state, batch) -> (state', metrics), with
    state = {"params", "opt", "model_state"}. ``microbatches`` > 1 splits
    the batch's leading dim and accumulates the mean of the microbatch
    gradients (equal to the full-batch gradient for a mean loss); the BN
    state threads through the microbatches and the last one's is kept."""
    wire, _ = parse_compression(train_cfg.parallel.compression)
    compute_dtype = model.compute_dtype
    device = model.device

    def grads_of(params, mstate, mbatch):
        names = list(params)
        # the cast to the compute dtype: gradients reach the fp32 masters
        # through it (cast back to fp32 below)
        pc = {k: params[k].detach().to(compute_dtype).requires_grad_(True)
              for k in names}
        loss, (new_mstate, metrics) = model.loss_fn(
            pc, mstate, mbatch, train_cfg.label_smoothing)
        gs = torch.autograd.grad(loss, [pc[k] for k in names])
        return new_mstate, metrics, {k: g.float() for k, g in zip(names, gs)}

    def train_step(state: Tree, batch: Tree):
        batch = to_device(batch, device)
        params = state["params"]
        if microbatches <= 1:
            new_mstate, metrics, grads = grads_of(
                params, state["model_state"], batch)
        else:
            b = batch["images"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mstate = state["model_state"]
            grads = None
            seq = []
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
                mstate, metrics, g = grads_of(params, mstate, mb)
                g = {k: v / microbatches for k, v in g.items()}
                grads = g if grads is None else {
                    k: grads[k] + g[k] for k in grads}
                seq.append(metrics)
            new_mstate = mstate
            metrics = {k: torch.stack([m[k].float() for m in seq]).mean()
                       for k in seq[0]}
        grads = simulate_wire_cast(grads, wire)
        new_params, new_opt, opt_metrics = optimizer.update(
            params, grads, state["opt"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        new_state = {"params": new_params, "opt": new_opt,
                     "model_state": new_mstate}
        return new_state, metrics

    return train_step


def make_eval_step(model, train_cfg: Optional[TrainConfig] = None):
    """Validation step: (params, model_state, batch) -> metrics. The
    parameters stay fp32 masters (only conv and fc weights are cast to
    the activation dtype inside the model), as in the JAX package."""
    del train_cfg  # schedules don't enter the eval path

    @torch.no_grad()
    def eval_step(params, model_state, batch) -> Dict:
        return model.eval_fn(params, model_state,
                             to_device(batch, model.device))

    return eval_step
