"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 blocks; two distinct shared (attention+MLP) blocks are cycled and
applied every 6 backbone layers, each taking concat(hidden, residual) via a
learned down-projection (the Zamba2 "shared transformer" pattern).
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        norm="rmsnorm",
        ssm_state=64,
        ssm_conv_width=4,
        ssm_expand=2,
        ssm_head_dim=64,
        shared_attn_every=6,
        n_shared_attn_blocks=2,
        source="arXiv:2411.15242; unverified",
    )
