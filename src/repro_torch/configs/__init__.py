"""Arch config registry. Importing this package registers every config
the port supports (ResNet-50, the paper's own architecture; the dense
LM family: llama3.2-1b, yi-9b, granite-34b and qwen2-72b; the MoE
family: mixtral-8x7b and llama4-maverick-400b-a17b)."""
from repro_torch.configs.base import (  # noqa: F401
    InputConfig,
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    reduced_config,
)

from repro_torch.configs import (  # noqa: F401,E402
    granite_34b,
    llama3_2_1b,
    llama4_maverick_400b,
    mixtral_8x7b,
    qwen2_72b,
    resnet50,
    yi_9b,
)
