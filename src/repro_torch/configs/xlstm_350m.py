"""xLSTM-350M — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517].

d_ff=0 per spec: xLSTM blocks carry their own up/down projections
(mLSTM proj factor 2, sLSTM gated-FFN factor 4/3); there is no separate
transformer FFN.
"""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        norm="layernorm",
        pos_embedding="none",
        slstm_every=8,  # ~7:1 mLSTM:sLSTM
        mlstm_proj_factor=2.0,
        slstm_proj_factor=4.0 / 3.0,
        source="arXiv:2405.04517; unverified",
    )
