"""Train/eval steps and the epoch loop."""
from repro_torch.training.loop import (  # noqa: F401
    LoopConfig,
    LoopResult,
    Trainer,
    TrainerConfig,
    TrainResult,
    run_training,
)
