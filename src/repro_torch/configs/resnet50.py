"""ResNet-50 — the paper's own benchmark architecture (He et al. 2016).

Bottleneck stages [3,4,6,3], width 64, BatchNorm (the paper's
no-moving-average variant with cross-replica sync), 1000 classes,
224x224 input. Trained at global minibatch 32,768 per the paper.
"""
from repro_torch.configs.base import ModelConfig, register


@register("resnet50")
def resnet50() -> ModelConfig:
    return ModelConfig(
        name="resnet50",
        family="conv",
        n_layers=50,
        d_model=0,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=0,
        conv_stages=(3, 4, 6, 3),
        conv_width=64,
        num_classes=1000,
        image_size=224,
        source="CVPR16 He et al.; paper's own benchmark",
    )
