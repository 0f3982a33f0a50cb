"""Mixtral-8x7B — 8 experts top-2 MoE, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("mixtral-8x7b")
def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        sliding_window=4096,
        n_experts=8,
        experts_per_token=2,
        moe_layer_every=1,
        source="arXiv:2401.04088; hf",
    )
