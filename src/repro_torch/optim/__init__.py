"""Optimizers: the paper's rmsprop_warmup, the momentum-SGD baseline and
LARS (per leaf here; on the packed stream in ``optim/stream.py``)."""
from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.interface import Optimizer  # noqa: F401
from repro_torch.optim.lars import lars
from repro_torch.optim.rmsprop_warmup import rmsprop_warmup
from repro_torch.optim.sgd import momentum_sgd

_FACTORIES = {
    "rmsprop_warmup": rmsprop_warmup,
    "momentum_sgd": momentum_sgd,
    "lars": lars,
}


def make_optimizer(cfg: OptimizerConfig, steps_per_epoch: int,
                   global_batch: int, use_fused: bool = False) -> Optimizer:
    """The per-leaf optimizer; ``use_fused`` (``--use-fused-kernel``)
    runs rmsprop_warmup's update through the fused kernel, and momentum
    SGD and the tree LARS ignore it, as in the JAX package."""
    if cfg.kind not in _FACTORIES:
        raise KeyError(f"unknown optimizer {cfg.kind!r}")
    return _FACTORIES[cfg.kind](cfg, steps_per_epoch, global_batch,
                                use_fused=use_fused)
