"""Arch config registry. Importing this package registers every config
the port supports (ResNet-50, the paper's own architecture, and
llama3.2-1b, the dense LM the serving path runs)."""
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

from repro_torch.configs import llama3_2_1b, resnet50  # noqa: F401,E402
