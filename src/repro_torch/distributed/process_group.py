"""The worker group of the data-parallel path: one process per worker.

The JAX package lays its workers out as a device mesh (``launch/
mesh.py``) and runs one shard_map or GSPMD program over it. PyTorch
has neither: every worker is its own process, and the collectives go
through ``torch.distributed`` (NCCL between cards; gloo on the CPU and
for several processes that share one card). The data-parallel steps
use the group as it is (optionally laid out as a two-level hierarchy,
``distributed/bucketing.py``). The GSPMD step lays it out as a
``DeviceMesh`` (``device_mesh``): named axes such as ``("data",
"model")``, a subgroup per axis, DTensor placements over them, and
tensor parallelism over "model".

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
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

_STORE_DIR: Optional[str] = None
_MESHES: dict = {}


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


def device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the worker group, its dims named
    ``names``: rank ``w`` at the row-major position ``w`` (with ("data",
    "model"), row ``w // M``, column ``w % M``, as ``--mesh DxM`` lays
    the workers out). Its per-axis subgroups take the group's backend.
    Made once per (shape, names) and worker group, on ``device_type``
    (None: ``cuda`` under NCCL, else ``cpu``; gloo workers that share a
    card pass ``cuda``; a dry run's ``meta`` takes ``cpu`` over its
    fake group, ``launch/dryrun.py``); ``shutdown`` drops it."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = tuple(int(s) for s in shape), tuple(names)
    n = 1
    for s in shape:
        n *= s
    if n != world_size():
        raise ValueError(f"mesh {'x'.join(map(str, shape))} lays out {n} "
                         f"workers, this run has {world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device_type == "meta":  # DTensor's cost model has no meta mesh:
        device_type = "cpu"    # a dry run's runs on the CPU's, fake group
    key = (shape, names, device_type)
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh(device_type,
                                  torch.arange(n).reshape(shape),
                                  mesh_dim_names=names)
    return _MESHES[key]


def shutdown() -> None:
    """Leave the worker group (and the subgroups of a hierarchical
    schedule) and remove the single worker's store."""
    global _STORE_DIR
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    # the subgroups die here, not when the interpreter exits (a gloo
    # group destroyed then may abort the process)
    from repro_torch.distributed.bucketing import forget_hierarchy_groups
    forget_hierarchy_groups()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None
