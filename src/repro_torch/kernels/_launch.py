"""Launch plumbing shared by the kernel wrappers: binding a library's C
entry points, the device rule (plain version on the CPU, kernel on one
CUDA device, anything else raises) and the current stream."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float


class Library:
    """The C entry points of ``csrc/<name>.cu``, bound with their
    argument types at first use (the source is built then), and one
    launch count per entry point."""

    def __init__(self, name: str, signatures: Dict[str, Sequence]):
        self.name = name
        self.signatures = signatures
        self.launches: Dict[str, int] = {k: 0 for k in signatures}
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
        self.launches[sym] += 1

    def reset(self) -> None:
        for k in self.launches:
            self.launches[k] = 0


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
