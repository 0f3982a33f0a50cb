"""The reference's training steps: the family's plain forward and
backward on each worker's batch, the bf16 wire mean over the workers (a
float32 sum of each worker's bf16-rounded gradient, rounded to bf16
again and divided: the ring's own order of additions is not reproduced;
at one worker the two are the same), and the hybrid update, from the
benchmark's initial weights. Returns the readings that
``harness/judge.py`` compares with the program's: each step's loss, the
norm of each leaf's first gradient as the optimizer gets it (worked out
from its second moment after one step), each leaf's change after the
steps, the norm of its momentum ``Delta`` then, and the BN statistics
of the first worker's first step.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from reference.common import (Precision, decays, hybrid_update,
                              set_reference_math, step_hyper)

FAMILIES = {"conv": "reference.resnet50", "moe": "reference.mixtral"}


def task_for(cfg: Dict):
    """The reference task of a configuration's model family."""
    return importlib.import_module(FAMILIES[cfg["model"]["family"]]).Task(cfg)


def grad_norms_from_m(m: Dict[str, torch.Tensor], mu2: float
                      ) -> Dict[str, float]:
    """||g|| of every leaf from the second moment after one step from
    zero, m = (1 - mu2) g^2."""
    return {k: float(v.float().sum(dtype=torch.float64) / (1.0 - mu2)) ** 0.5
            for k, v in m.items()}


def follow(cfg: Dict, weights: Dict[str, torch.Tensor],
           steps_batches: List[List[Dict]], seed: int, device,
           prec: Precision = Precision(), fault: Optional[str] = None
           ) -> Dict:
    """Train ``len(steps_batches)`` steps; ``steps_batches[t]`` holds each
    worker's batch of step t. ``fault`` plants one: "half", each worker
    takes the mean over the first half of its rows only; "unchanged",
    every step returns its state as it found it."""
    set_reference_math()
    task = task_for(cfg)
    opt = cfg["optimizer"]
    world = len(steps_batches[0])
    global_batch = steps_batches[0][0]["global_rows"]
    theta = {k: v.clone() for k, v in weights.items()}
    delta = {k: torch.zeros_like(v) for k, v in theta.items()}
    m = {k: torch.zeros_like(v) for k, v in theta.items()}
    wd = {k: opt["weight_decay"] if decays(k) else 0.0 for k in theta}
    out: Dict = {"losses": []}
    names = list(theta)
    for t, batches in enumerate(steps_batches):
        total = {k: None for k in names}
        losses = []
        for w, batch in enumerate(batches):
            inputs = task.inputs(batch, t, device, seed)
            if fault == "half":
                inputs = tuple(t[:t.shape[0] // 2] for t in inputs)
            p = {k: v.to(torch.bfloat16).requires_grad_(True)
                 for k, v in theta.items()}
            loss, reported, stats = task.loss(p, inputs, prec)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            losses.append(float(reported))
            if t == 0 and w == 0:
                out["bn"] = {f"{site}/{which}": float(v.double().norm())
                             for site, (mu, var) in stats.items()
                             for which, v in (("mean", mu), ("var", var))}
            for k, g in zip(names, grads):
                g = g.float().to(torch.bfloat16).float()
                total[k] = g if total[k] is None else total[k] + g
            del p, loss, grads, stats
        out["losses"].append(sum(losses) / world)
        h = step_hyper(opt, t, cfg["steps_per_epoch"], global_batch)
        if fault != "unchanged":
            for k in names:
                g = total[k] if world == 1 else \
                    total[k].to(torch.bfloat16).float() / world
                hybrid_update(theta[k], delta[k], m[k], g, h, wd[k])
        del total
        if t == 0:
            out["grad1"] = grad_norms_from_m(m, opt["mu2"])
    out["change"] = {k: float((theta[k] - weights[k]).double().norm())
                     for k in names}
    out["delta"] = {k: float(delta[k].double().norm()) for k in names}
    return out
