"""Arch config registry. Importing this package registers every config
of the JAX package: ResNet-50, the paper's own architecture; the dense
LM family (llama3.2-1b, yi-9b, granite-34b, qwen2-72b); the MoE family
(mixtral-8x7b, llama4-maverick-400b-a17b); the VLM phi-3-vision-4.2b;
the hybrid zamba2-7b; the SSM xlstm-350m; the audio whisper-tiny."""
from repro_torch.configs.base import (  # noqa: F401
    InputConfig,
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    list_archs,
    reduced_config,
    shapes_for,
)

from repro_torch.configs import (  # noqa: F401,E402
    granite_34b,
    llama3_2_1b,
    llama4_maverick_400b,
    mixtral_8x7b,
    phi_3_vision_4_2b,
    qwen2_72b,
    resnet50,
    whisper_tiny,
    xlstm_350m,
    yi_9b,
    zamba2_7b,
)

ASSIGNED_ARCHS = (
    "qwen2-72b",
    "yi-9b",
    "llama3.2-1b",
    "granite-34b",
    "phi-3-vision-4.2b",
    "zamba2-7b",
    "whisper-tiny",
    "llama4-maverick-400b-a17b",
    "mixtral-8x7b",
    "xlstm-350m",
)
