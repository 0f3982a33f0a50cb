"""Yi-9B — llama-architecture dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("yi-9b")
def yi_9b() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        norm="rmsnorm",
        rope_theta=10000.0,
        source="arXiv:2403.04652; hf",
    )
