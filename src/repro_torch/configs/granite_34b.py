"""Granite-34B-Code — llama-arch MQA (kv=1) [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("granite-34b")
def granite_34b() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        norm="layernorm",
        mlp_variant="gelu",  # GPT-BigCode style 2-matrix MLP
        rope_theta=10000.0,
        source="arXiv:2405.04324; hf",
    )
