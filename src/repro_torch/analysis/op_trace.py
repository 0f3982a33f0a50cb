"""One step as the dispatcher sees it: the port's counterpart of the JAX
package's ``analysis/hlo_ir.py``.

The JAX audit reads the compiled HLO of its train step. An eager
PyTorch step has no compiled program; what it has is its op stream,
which a ``TorchDispatchMode`` sees in call order, the collectives
included (``dist.all_reduce`` arrives as ``c10d.allreduce_.default``,
DTensor's redistributions as ``_c10d_functional.*`` between the aten
ops). ``record()`` turns that stream into a list of ``Op`` records:

- the op's name (``aten.convolution.default``, ``c10d.allreduce_.default``)
  and the shapes, dtypes and bytes of its inputs and outputs;
- for a collective, its kind (``COLLECTIVES``), its group's size and
  ranks, its dtype and its input and output bytes;
- whether it ran inside the backward (autograd's graph task id);
- the indices of the ops that made its inputs (``src``), so a pass can
  follow a value from op to op (a round trip through a narrow dtype, a
  buffer's last use);
- its FLOPs, from ``torch.utils.flop_counter``'s own formulas.

The hand-written kernels are launched through ctypes, not the
dispatcher (``kernels/_launch.py``): each launch made between two ops
becomes a ``kernel.<name>`` record in its place in the stream, and
``OpTrace.launches`` is every kernel's launch count over the step.

Ops on DTensors are recorded as the local ops that DTensor runs on this
worker (the mode declines the DTensor-level op, so DTensor's own
dispatch runs under it), which makes a GSPMD trace per-device like a
data-parallel one; DTensor's sharding propagation on fake tensors is
not recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _launch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "broadcast", "scatter")

# (namespace, op name) -> collective kind
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "scatter_": "scatter",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


@dataclasses.dataclass
class Op:
    """One dispatched op (or a kernel launch, ``name`` "kernel.<k>")."""
    index: int
    name: str
    in_shapes: Tuple[Tuple[int, ...], ...] = ()
    in_dtypes: Tuple[str, ...] = ()
    in_bytes: int = 0
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_dtypes: Tuple[str, ...] = ()
    out_bytes: int = 0
    # bytes of the outputs that are new buffers (not views / in-place)
    new_bytes: int = 0
    backward: bool = False
    src: Tuple[int, ...] = ()  # producer index of each input (-1: none)
    # the op whose new buffer this op's output lives in: itself for a
    # new buffer, its input's owner for a view or an in-place write
    owner: int = -1
    view: bool = False  # a view of its input: no bytes touched
    flops: float = 0.0
    device: str = ""
    # collectives
    collective: Optional[str] = None
    group_size: int = 0
    group_ranks: Tuple[int, ...] = ()
    dtype: str = ""
    # kernel records: launches of this kernel at this point
    launches: int = 0

    @property
    def short(self) -> str:
        """``convolution_backward`` of ``aten.convolution_backward.default``."""
        parts = self.name.split(".")
        return parts[1] if len(parts) > 1 else self.name

    @property
    def coll_bytes(self) -> int:
        """A collective's size as the schedule linter counts it: the
        larger of its input and output bytes."""
        return max(self.in_bytes, self.out_bytes)

    @property
    def is_kernel(self) -> bool:
        return self.name.startswith("kernel.")


@dataclasses.dataclass
class OpTrace:
    ops: List[Op] = dataclasses.field(default_factory=list)
    # kernel -> launches over the recorded span
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def collectives(self) -> List[Op]:
        return [o for o in self.ops if o.collective is not None]

    def count(self, short: str, backward: Optional[bool] = None) -> int:
        """Ops named ``short`` (``"convolution_backward"``), in the
        backward only (True), outside it (False) or anywhere (None)."""
        return sum(1 for o in self.ops if o.short == short and
                   (backward is None or o.backward == backward))

    def consumers(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for o in self.ops:
            for s in o.src:
                if s >= 0:
                    out.setdefault(s, []).append(o.index)
        return out


def _tensors(x) -> List[torch.Tensor]:
    flat, _ = tree_flatten(x)
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _nbytes(ts: List[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _group_of(func, args, kwargs) -> Optional[Any]:
    """The process group a collective runs on."""
    flat, _ = tree_flatten((args, kwargs))
    for a in flat:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except Exception:  # noqa: BLE001 - not a process group
                continue
    names = [a.name for a in func._schema.arguments]
    if "group_name" in names:
        i = names.index("group_name")
        name = args[i] if i < len(args) else kwargs.get("group_name")
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(name)
    return None


def _collective_io(func, args, kwargs, out) -> Tuple[List, List]:
    """(input tensors, output tensors) of a collective, by its schema:
    c10d's ``output*`` arguments are written, its ``tensors`` both read
    and written (in place); a functional collective returns its
    output."""
    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    for i, a in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if v is None:
            continue
        ts = _tensors(v)
        if a.name.startswith("output"):
            outs += ts
        elif a.name in ("tensors", "tensor"):
            ins += ts
            outs += ts
        elif a.name.startswith("input"):
            ins += ts
    if func.namespace == "_c10d_functional":
        outs = _tensors(out)
    return ins, outs


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: OpTrace, device: Optional[str]):
        super().__init__()
        self.trace, self.device = trace, device
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakTensorKeyDictionary
        self.flops = flop_registry
        self.producer = WeakTensorKeyDictionary()
        self.seen_launches = _launch.LAUNCHES[0]
        self.counts = self._counts()

    @staticmethod
    def _counts() -> Dict[str, int]:
        return {k: v for lib in _launch.LIBRARIES
                for k, v in lib.launches.items()}

    def flush_kernels(self) -> None:
        """Kernel records for the launches made since the last op."""
        if _launch.LAUNCHES[0] == self.seen_launches:
            return
        self.seen_launches = _launch.LAUNCHES[0]
        now = self._counts()
        bwd = torch._C._current_graph_task_id() != -1
        for k, v in now.items():
            d = v - self.counts.get(k, 0)
            if d > 0:
                self.trace.ops.append(Op(len(self.trace.ops), f"kernel.{k}",
                                         backward=bwd, launches=d))
                self.trace.launches[k] = self.trace.launches.get(k, 0) + d
        self.counts = now

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _tensors((args, kwargs))
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(isinstance(t, DTensor) for t in flat):
            return NotImplemented  # DTensor runs its local ops under us
        if any(isinstance(t, FakeTensor) for t in flat):
            return func(*args, **kwargs)  # DTensor's sharding propagation
        self.flush_kernels()
        out = func(*args, **kwargs)
        self.flush_kernels()
        self._record(func, args, kwargs, flat, out)
        return out

    def _record(self, func, args, kwargs, ins, out) -> None:
        outs = _tensors(out)
        index = len(self.trace.ops)
        op = Op(index, str(func),
                backward=torch._C._current_graph_task_id() != -1)
        op.src = tuple(self.producer.get(t, -1) for t in ins)
        dev = outs[0].device if outs else ins[0].device if ins else None
        op.device = "" if dev is None else dev.type
        if self.device is not None and op.device != self.device:
            return  # host scalars; a dry run's DTensor bookkeeping
        kind = (_KINDS.get(func._opname)
                if func.namespace in _COLLECTIVE_NAMESPACES else None)
        if kind is not None:
            c_in, c_out = _collective_io(func, args, kwargs, out)
            op.collective = kind
            pg = _group_of(func, args, kwargs)
            if pg is not None:
                op.group_size = pg.size()
                op.group_ranks = tuple(dist.get_process_group_ranks(pg))
            ins, outs = c_in, c_out
            op.dtype = _dtype(ins[0]) if ins else (
                _dtype(outs[0]) if outs else "")
            op.new_bytes = _nbytes(outs) if func.namespace == \
                "_c10d_functional" else 0
        else:
            aliased = [r.alias_info is not None
                       for r in func._schema.returns]
            op.new_bytes = sum(t.numel() * t.element_size()
                               for t, a in zip(outs, aliased + [False] *
                                               len(outs)) if not a)
            packet = func.overloadpacket
            if packet in self.flops:
                try:
                    op.flops = float(self.flops[packet](
                        *args, **kwargs, out_val=out))
                except Exception:  # noqa: BLE001 - a formula's corner
                    op.flops = 0.0
        op.in_shapes = tuple(tuple(t.shape) for t in ins)
        op.in_dtypes = tuple(_dtype(t) for t in ins)
        op.in_bytes = _nbytes(ins)
        op.out_shapes = tuple(tuple(t.shape) for t in outs)
        op.out_dtypes = tuple(_dtype(t) for t in outs)
        op.out_bytes = _nbytes(outs)
        # a view keeps its base's producer (same values); an in-place
        # write or a collective's output is now this op's value, in its
        # input's buffer; anything else is a new buffer
        returns = func._schema.returns
        view = kind is None and bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in returns)
        inplace = kind is not None or any(
            r.alias_info is not None and r.alias_info.is_write
            for r in returns)
        base = op.src[0] if op.src else -1
        base_owner = self.trace.ops[base].owner if base >= 0 else -1
        op.owner = index if not (view or inplace) or base < 0 \
            else base_owner
        if kind is not None and func.namespace == "_c10d_functional":
            op.owner = index
        op.view = view
        self.trace.ops.append(op)
        for t in outs:
            self.producer[t] = base if view and base >= 0 else index


@contextlib.contextmanager
def record(device: Optional[str] = None) -> Iterator[OpTrace]:
    """Record every op dispatched (on this thread and in the backward it
    starts) while the block runs::

        with record("cuda") as trace:
            state, metrics = step(state, batch)

    ``device`` (a device type) keeps only the ops whose result lies
    there: the step's work, without the host's scalar arithmetic (the
    learning-rate schedule) or, in a dry run on the meta device, the
    empty host buffers DTensor's bookkeeping makes on the CPU mesh."""
    trace = OpTrace()
    rec = _Recorder(trace, device)
    with rec:
        yield trace
    rec.flush_kernels()
