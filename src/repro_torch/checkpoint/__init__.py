"""Checkpoints in the JAX package's on-disk format (``checkpointer.py``)."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    BEST_DIR,
    AsyncCheckpointer,
    CheckpointCorruptError,
    gc_stale_tmpdirs,
    list_checkpoints,
    restore,
    restore_best,
    save,
    save_best,
)
