"""Stand-ins for every model input on the ``meta`` device (the dry-run,
``launch/dryrun.py``): tensors with the shapes and dtypes of a real
cell and no storage, the port's counterpart of the JAX package's
``ShapeDtypeStruct`` trees. Nothing is allocated and nothing is drawn.

``input_specs`` builds the batch inputs of one (arch, shape) cell;
``param_specs`` and ``cache_specs`` read a model built on the meta
device (``build_model(cfg, device="meta")``), whose initializers skip
their draws (``models/common.py`` ``LeafDraw``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

META = torch.device("meta")
Tensor = torch.Tensor


def _sds(shape, dtype) -> Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                compute_dtype=torch.bfloat16) -> Dict[str, Tensor]:
    """Batch inputs for the step this shape's kind runs: images (NHWC,
    as the JAX package's and the port's data feed) and labels for the
    conv family; tokens (+ targets in training, + the VLM's patches or
    the audio model's frames) for an LM; one token and the cache index
    in decode."""
    b = shape.global_batch
    if cfg.family == "conv":
        r = cfg.image_size
        return {"images": _sds((b, r, r, 3), compute_dtype),
                "labels": _sds((b,), torch.int32)}

    s = shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Tensor] = {"tokens": _sds((b, s), torch.int32)}
        if shape.kind == "train":
            batch["targets"] = _sds((b, s), torch.int32)
        if cfg.vision is not None:
            batch["patches"] = _sds(
                (b, cfg.vision.num_patches, cfg.vision.patch_dim),
                compute_dtype)
        if cfg.audio is not None:
            batch["frames"] = _sds(
                (b, cfg.audio.num_frames, cfg.audio.frame_dim),
                compute_dtype)
        return batch
    if shape.kind == "decode":
        return {"tokens": _sds((b, 1), torch.int32),
                "cache_index": _sds((), torch.int32)}
    raise ValueError(shape.kind)


def _require_meta(model) -> None:
    if model.device.type != "meta":
        raise ValueError(f"specs read a model built on the meta device "
                         f"(build_model(cfg, device='meta')); this one is "
                         f"on {model.device}")


def param_specs(model, param_dtype=torch.float32
                ) -> Tuple[Dict[str, Tensor], Dict[str, Tuple]]:
    """(meta tensor per parameter, logical-axes tree) of a model built
    on the meta device; floating leaves take ``param_dtype``."""
    _require_meta(model)
    with torch.device(META):
        if model.cfg.family == "conv":
            params, axes = model.init_params()
        else:
            params, axes = model.init_params(0, draw_device=META)
    shapes = {k: _sds(v.shape, param_dtype if v.is_floating_point()
                      else v.dtype) for k, v in params.items()}
    return shapes, axes


def cache_specs(model, batch: int, max_seq: int, dtype=torch.bfloat16
                ) -> Tuple[Dict[str, Tensor], Dict[str, Tuple]]:
    """(meta tensor per cache leaf, logical-axes tree) for the KV / SSM
    cache of ``batch`` rows of ``max_seq`` positions."""
    _require_meta(model)
    with torch.device(META):
        return model.cache_shape(batch, max_seq, dtype)
