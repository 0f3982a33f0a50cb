"""Data parallelism over ``torch.distributed``: one process per worker
(the paper's one worker per device), and the bucketed gradient
all-reduce."""
from repro_torch.distributed.process_group import (  # noqa: F401
    init_workers,
    rank,
    shutdown,
    world_size,
)
