"""Initializers shared by the port's models (fan-in scaled normals drawn
from an explicit ``torch.Generator`` on the CPU, so a seed gives the
same weights on every device)."""
from __future__ import annotations

import math
from typing import Sequence

import torch


def he_init(gen: torch.Generator, shape: Sequence[int],
            fan_in: int) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen) * math.sqrt(2.0 / fan_in)


def fan_in_init(gen: torch.Generator, shape: Sequence[int],
                fan_in: int) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen) / math.sqrt(
        max(fan_in, 1))
