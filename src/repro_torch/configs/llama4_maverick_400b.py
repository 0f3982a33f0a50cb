"""Llama-4-Maverick-400B-A17B — MoE 128 experts top-1, early fusion.

MoE layers alternate with dense layers (interleave step 2, matching the
400B-total / 17B-active budget) and each MoE layer adds a shared expert,
per the Llama-4 architecture. [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama4-maverick-400b-a17b")
def llama4_maverick() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        norm="rmsnorm",
        rope_theta=500000.0,
        n_experts=128,
        experts_per_token=1,
        moe_layer_every=2,
        n_shared_experts=1,
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )
