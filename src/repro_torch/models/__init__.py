"""Models of the port (the conv family: ResNet-50)."""
from repro_torch.models.registry import (  # noqa: F401
    build_model,
    init_model_state,
)
