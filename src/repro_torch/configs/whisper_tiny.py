"""Whisper-tiny — enc-dec audio backbone; conv frontend is a STUB.

The batch supplies precomputed frame embeddings (``frames``, post-conv).
4 encoder + 4 decoder layers. Decoder uses learned positional embeddings
and cross-attention. [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import AudioFrontend, ModelConfig, register


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder layers
        n_encoder_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        norm="layernorm",
        mlp_variant="gelu",
        pos_embedding="learned",
        audio=AudioFrontend(num_frames=1500, frame_dim=80),
        source="arXiv:2212.04356; unverified",
    )
