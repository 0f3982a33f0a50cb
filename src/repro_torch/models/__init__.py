"""Models of the port: every family of the JAX package (``registry``)."""
from repro_torch.models.registry import (  # noqa: F401
    build_model,
    init_model_state,
)
