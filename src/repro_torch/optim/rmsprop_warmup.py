"""The paper's optimizer: hybrid RMSprop->SGD with the ELU transition
schedule and slow-start LR. With ``use_fused`` each leaf goes through
the fused update kernel (``kernels/fused_update.py``), one launch per
leaf as the JAX package's ``tree.map``; without, through the plain
per-leaf math of ``core/optimizer.py``. The two are bitwise equal."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.optimizer import HybridHyper, hybrid_update
from repro_torch.core.schedules import alpha_sgd_schedule, make_lr_schedule
from repro_torch.kernels.ops import fused_hybrid_update
from repro_torch.optim.interface import Optimizer, epoch_of, tree_zeros_like

# path fragments that get no weight decay (norms, biases — standard
# large-batch practice, Goyal et al.). Matched against each "/"-separated
# fragment of a parameter's name by EXACT equality, never substring: the
# fc bias is named "b", so it IS decayed, as in the JAX package.
NO_DECAY = ("scale", "bias", "b_if", "b_gates", "A_log", "dt_bias", "D",
            "conv_b", "bq", "bk", "bv")


def decays(name: str) -> bool:
    return not any(frag in NO_DECAY for frag in name.split("/"))


def decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {k: decays(k) for k in params}


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rmsprop_warmup(cfg: OptimizerConfig, steps_per_epoch: int,
                   global_batch: int, use_fused: bool = False) -> Optimizer:
    lr_fn = make_lr_schedule(cfg.schedule, global_batch,
                             base_lr_per_256=cfg.base_lr_per_256,
                             warmup_epochs=cfg.warmup_epochs,
                             total_epochs=cfg.total_epochs,
                             poly_power=cfg.poly_power)
    state_dtype = _STATE_DTYPES[cfg.state_dtype]

    def init(params):
        return {"step": 0,
                "delta": tree_zeros_like(params, state_dtype),
                "m": tree_zeros_like(params, state_dtype)}

    @torch.no_grad()
    def update(params, grads, state) -> Tuple:
        step = state["step"]
        epoch = epoch_of(step, steps_per_epoch)
        eta = lr_fn(epoch)
        a_sgd = alpha_sgd_schedule(epoch, cfg.beta_center, cfg.beta_period,
                                   kind=cfg.transition)
        h = HybridHyper(eta=float(eta), alpha_sgd=float(a_sgd),
                        mu1=cfg.mu1, mu2=cfg.mu2, eps=cfg.eps,
                        eta_rmsprop=cfg.eta_rmsprop)
        for k, p in params.items():
            d, m = state["delta"][k], state["m"][k]
            wd = cfg.weight_decay if decays(k) else 0.0
            if use_fused:
                # the kernel takes f32 state: a bf16 state is cast in
                # and out, as the JAX package's fused leaf does
                d32, m32 = d.float(), m.float()
                fused_hybrid_update(grads[k].float().contiguous(), p, d32,
                                    m32, h, wd)
                if d32 is not d:
                    d.copy_(d32)
                    m.copy_(m32)
                continue
            p2, d2, m2 = hybrid_update(grads[k], p, d.float(), m.float(),
                                       h, wd)
            p.copy_(p2)
            d.copy_(d2)
            m.copy_(m2)
        state["step"] = step + 1
        metrics = {"lr": float(eta), "alpha_sgd": float(a_sgd),
                   "epoch": float(epoch)}
        return params, state, metrics

    return Optimizer(init=init, update=update)
