"""Deterministic synthetic data (numpy Philox, bitwise equal to the JAX
package's pipelines)."""
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImageData,
    make_data,
)
