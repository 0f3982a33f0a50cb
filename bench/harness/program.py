"""The system under test as the benchmark drives it: the port's
data-parallel train step (``repro_torch``), built by its launcher's
``build_train_setup`` and fed through its ``DataPipeline`` with the
device stage ``put_batch``, as ``training/loop.py``'s ``Trainer`` feeds
it. The one module of the harness that imports the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of a configuration file: its registered
    architecture with every key of the file's ``model`` set."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    model = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg["model"].items()}
    unknown = sorted(set(model) - fields)
    if unknown:
        raise KeyError(f"{cfg['name']}: keys {unknown} are not fields of "
                       "the program's ModelConfig")
    return dataclasses.replace(base, **model)


def check_constants(cfg: Dict) -> None:
    """The MoE routing constants the port reads at call time must be the
    configuration's, which the reference follows."""
    if "moe_group" not in cfg:
        return
    from repro_torch.models import layers
    have = (layers.MOE_GROUP, layers.CAPACITY_FACTOR)
    want = (cfg["moe_group"], cfg["capacity_factor"])
    if have != want:
        raise ValueError(f"{cfg['name']}: the program routes with (group, "
                         f"capacity factor) {have}, the configuration "
                         f"states {want}")


class Program:
    """One worker's train step, its state and its input pipeline."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: str,
                 world: int):
        from repro_torch.configs import InputConfig, OptimizerConfig
        from repro_torch.launch.train import build_train_setup
        check_constants(cfg)
        pcfg = model_config(cfg)
        sync = cfg["sync"]
        inp = cfg.get("input")
        input_cfg = None
        if inp is not None:
            input_cfg = InputConfig(
                fused=inp["fused"], augment=inp["augment"],
                max_shift=inp["max_shift"], mean=tuple(inp["mean"]),
                std=tuple(inp["std"]))
        model, state, train_step, _, put_batch, _ = build_train_setup(
            pcfg, global_batch=mix["batch"] * world,
            seq_len=mix.get("seq_len", 0),
            opt_cfg=OptimizerConfig(**cfg["optimizer"]),
            steps_per_epoch=cfg["steps_per_epoch"],
            dp_mode=sync["dp_mode"],
            compute_dtype=DTYPES[cfg["compute_dtype"]], seed=seed,
            use_fused_kernel=sync["use_fused_kernel"],
            compression=sync["compression"],
            bucket_bytes=sync["bucket_bytes"],
            fused_bn=cfg["model"].get("fused_bn", False),
            input_cfg=input_cfg,
            attention_impl=cfg.get("attention_impl", "naive"),
            remat=cfg.get("remat", False), draw_device=device,
            device=device)
        self.model, self.state = model, state
        self.train_step, self.put_batch = train_step, put_batch
        self.device = torch.device(model.device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.state["params"]

    def opt_field(self, name: str) -> Dict[str, torch.Tensor]:
        return self.state["opt"][name]

    def bn_stats(self) -> Dict[str, torch.Tensor]:
        """The BN statistics of the last step, by ``site/mean|var``."""
        return {f"{site}/{which}": rec[which]
                for site, rec in self.state["model_state"].items()
                for which in ("mean", "var")}

    @torch.no_grad()
    def load_weights(self, weights: Dict[str, torch.Tensor]) -> None:
        """Write the benchmark's initial weights into the program's
        parameters (the same names and shapes, or it raises)."""
        have, want = set(self.params), set(weights)
        if have != want:
            raise KeyError(f"the program's parameters "
                           f"{sorted(have ^ want)[:8]} differ from the "
                           "reference's")
        for k, w in weights.items():
            p = self.params[k]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{k}: program {tuple(p.shape)}, "
                                 f"reference {tuple(w.shape)}")
            p.copy_(w)

    def pipeline(self, source, workers: int, depth: int):
        """The ``Trainer``'s input pipeline over ``source`` from step 0."""
        from repro_torch.data.pipeline import DataPipeline
        return DataPipeline(source, start_step=0, depth=depth,
                            num_workers=workers, put=self.put_batch,
                            device_ahead=1)

    def _reduce(self, value: float, op: str) -> float:
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        return float(t) / (dist.get_world_size() if op == "SUM" else 1)

    def group_max(self, value: float) -> float:
        """The largest ``value`` over the worker group."""
        return self._reduce(value, "MAX")

    def group_mean(self, value: float) -> float:
        """The mean of ``value`` over the worker group."""
        return self._reduce(value, "SUM")

    def close(self) -> None:
        from repro_torch.distributed import shutdown
        shutdown()
