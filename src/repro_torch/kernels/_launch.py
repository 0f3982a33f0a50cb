"""Launch plumbing shared by the kernel wrappers: binding a library's C
entry points, the device rule (plain version on the CPU, kernel on one
CUDA device, anything else raises), the current stream, and the
gradient of a plain version for kernels whose backward recomputes it."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float


class Library:
    """The C entry points of ``csrc/<name>.cu``, bound with their
    argument types at first use (the source is built then), one launch
    count per kernel (``launches``) and one per entry point
    (``entry_launches``)."""

    def __init__(self, name: str, signatures: Dict[str, Sequence],
                 counts_as: Optional[Dict[str, str]] = None):
        """``counts_as`` maps an entry point to the kernel whose count its
        launches add to (another entry of the same kernel)."""
        self.name = name
        self.signatures = signatures
        self.counts_as = counts_as or {}
        self.launches: Dict[str, int] = {
            k: 0 for k in signatures if k not in self.counts_as}
        self.entry_launches: Dict[str, int] = {k: 0 for k in signatures}
        self._fns: Dict[str, object] = {}

    def _fn(self, sym: str):
        if not self._fns:
            from repro_torch.kernels import _build
            lib = _build.load(self.name)
            for s, argtypes in self.signatures.items():
                f = getattr(lib, s)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
                self._fns[s] = f
        return self._fns[sym]

    def launch(self, sym: str, *args) -> None:
        """Call ``sym``; raise on the CUDA error it returns, else count
        one launch."""
        err = self._fn(sym)(*args)
        if err != 0:
            raise RuntimeError(f"{sym} kernel launch failed: CUDA error "
                               f"{err}")
        self.launches[self.counts_as.get(sym, sym)] += 1
        self.entry_launches[sym] += 1

    def reset(self) -> None:
        for counts in (self.launches, self.entry_launches):
            for k in counts:
                counts[k] = 0


def on_cpu(what: str, *ts: Optional[torch.Tensor]) -> bool:
    """True when the inputs lie on the CPU (plain version); False on one
    CUDA device (kernel). Anything else raises."""
    devs = {t.device for t in ts if t is not None}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    got = sorted(str(t.device) for t in ts if t is not None)
    raise ValueError(f"{what} inputs must all lie on the CPU or on one "
                     f"CUDA device; got {got}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def plain_grads(plain: Callable[..., torch.Tensor],
                inputs: Sequence[torch.Tensor], needs: Sequence[bool],
                dy: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients of ``plain(*inputs)`` under cotangent ``dy`` for the
    inputs flagged in ``needs``, None for the others: the backward of a
    kernel whose forward computes the same function."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        got = iter(torch.autograd.grad(
            plain(*leaves), [t for t in leaves if t.requires_grad], dy))
    return tuple(next(got) if n else None for n in needs)
