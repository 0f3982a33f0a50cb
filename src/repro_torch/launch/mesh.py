"""Worker meshes: the port of the JAX package's ``launch/mesh.py``.

``make_small_mesh`` builds a ``DeviceMesh`` over the worker group (one
process per device; ``distributed/process_group.py``).
``make_production_mesh`` and ``preferred_mesh`` return the shape and
axis names of the JAX package's production meshes (a 256- or
512-worker ``DeviceMesh`` is not built here), and ``cell_parallel`` is
its parallelism policy for one (arch, shape) cell, verbatim. The
roofline constants are the card's (``launch/dryrun.py`` divides by
them).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig

MeshLayout = Tuple[Tuple[int, ...], Tuple[str, ...]]

# roofline constants of one card, NVIDIA H100 80GB HBM3 (700.00 W limit,
# as nvidia-smi names it): dense bf16 tensor-core peak, HBM rate, one
# collective link (NVLink's rate per direction) and HBM capacity. A
# mesh that spans nodes runs its collectives slower than LINK_BW, so the
# collective term of a roofline is a lower bound.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
LINK_BW = 450e9  # B/s per direction
HBM_BYTES = 80e9  # B


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_small_mesh(data: int = 4, model: int = 2):
    """A ``DeviceMesh`` of ``data`` x ``model`` workers over the worker
    group (``process_group.device_mesh``)."""
    from repro_torch.distributed.process_group import device_mesh
    return device_mesh((data, model), ("data", "model"))


def preferred_mesh(cfg: ModelConfig, *, multi_pod: bool = False
                   ) -> MeshLayout:
    """Per-arch mesh shape over the same chips: 40 heads % 16 != 0 makes
    attention replicate on a (16, 16) mesh, so such an arch above 3 B
    parameters takes (data=32, model=8); the others keep the standard
    production mesh."""
    if cfg.n_heads and cfg.n_heads % 16 != 0 and cfg.n_heads % 8 == 0 \
            and cfg.param_count() > 3e9:
        shape = (2, 32, 8) if multi_pod else (32, 8)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return shape, axes
    return make_production_mesh(multi_pod=multi_pod)


def cell_parallel(cfg: ModelConfig, shape: ShapeConfig) -> ParallelConfig:
    """Default parallelism policy for one (arch, shape) cell.

    conv (ResNet-50)   : pure DP over every mesh axis (the paper's
                         regime), f16 wire, replicated optimizer.
    LM train           : DP over data(+pod), Megatron TP over model,
                         ZeRO-1 (+FSDP for >= 6B params), bf16 wire.
    LM prefill/decode  : TP over model, batch over data, bf16 params, and
                         sequence sharding when the batch can't shard.
    """
    if cfg.family == "conv":
        return ParallelConfig(
            dp_axes=("data", "model"), tp_axis=None, zero_1=False,
            fsdp_params=False, compression="f16", remat="none")
    n = cfg.param_count()
    tiny = n < 3e9  # pure DP below Megatron-worthwhile size
    big = n > 6e9
    if shape.kind == "train":
        if tiny:
            return ParallelConfig(
                dp_axes=("data", "model"), tp_axis=None, zero_1=True,
                fsdp_params=False, compression="bf16", remat="block")
        return ParallelConfig(
            dp_axes=("data",), tp_axis="model", zero_1=True,
            fsdp_params=big, compression="bf16", remat="block")
    if tiny:
        return ParallelConfig(
            dp_axes=("data", "model"), tp_axis=None, zero_1=False,
            fsdp_params=False, compression=None, remat="none",
            kv_seq_sharding=True)
    # serve of very large models: bf16 params exceed TP-sharded memory
    # (llama4 400B: 795 GB / 16 = 50 GB a worker) => weight-gather FSDP
    serve_fsdp = n * 2 / 16 > 12e9
    return ParallelConfig(
        dp_axes=("data",), tp_axis="model", zero_1=False,
        fsdp_params=serve_fsdp, compression=None, remat="none",
        sequence_sharding=shape.global_batch == 1,
        kv_seq_sharding=True)
