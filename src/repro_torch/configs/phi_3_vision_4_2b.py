"""Phi-3-vision-4.2B — phi3-mini backbone + CLIP patch frontend (STUB).

The modality frontend is a stub: the batch supplies precomputed patch
embeddings (``patches``); the projector + LM backbone are real.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig, VisionFrontend, register


@register("phi-3-vision-4.2b")
def phi_3_vision() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,  # MHA
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        norm="rmsnorm",
        rope_theta=10000.0,
        vision=VisionFrontend(num_patches=576, patch_dim=1024),
        source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
    )
