"""The worker group of the data-parallel path: one process per worker.

The JAX package lays its workers out as a device mesh (``launch/
mesh.py``) and runs one shard_map program over it. PyTorch has no
shard_map: every worker is its own process, and the collectives go
through ``torch.distributed`` (NCCL between cards, gloo on the CPU).
Pure data parallelism only, as the paper runs ResNet-50: no mesh axes
and no tensor parallelism.

``init_workers`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (as
``torchrun`` sets them; defaults 0, 1 and 0). With ``MASTER_ADDR`` set
it joins through ``env://``; a single worker without it gets a
``file://`` store in a fresh temporary directory, so a one-process run
needs no port. Call ``shutdown`` at the end of every run.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

_STORE_DIR: Optional[str] = None


def init_workers(device: DeviceLike = "cuda", *,
                 init_method: Optional[str] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> torch.device:
    """Join the worker group (NCCL for a CUDA device, gloo for the CPU)
    unless this process already has; returns this worker's device:
    ``cuda:{LOCAL_RANK}`` for ``"cuda"``, the CPU for ``"cpu"``."""
    global _STORE_DIR
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    if init_method is None:
        if os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        elif world == 1:
            _STORE_DIR = tempfile.mkdtemp(prefix="repro_torch_workers_")
            init_method = "file://" + os.path.join(_STORE_DIR, "store")
        else:
            raise RuntimeError(
                f"{world} workers need a rendezvous: set MASTER_ADDR and "
                "MASTER_PORT (torchrun does) or pass init_method")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the worker group (and the subgroups of a hierarchical
    schedule) and remove the single worker's store."""
    global _STORE_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    # the subgroups die here, not when the interpreter exits (a gloo
    # group destroyed then may abort the process)
    from repro_torch.distributed.bucketing import forget_hierarchy_groups
    forget_hierarchy_groups()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None
