"""Pass framework for the audit of a recorded step (the JAX package's
``analysis/passes/__init__.py``, with a trace in place of HLO text).

A pass is a function ``(AuditContext) -> PassResult`` registered under a
short name. Passes are pure: they read the recorded trace
(``analysis/op_trace.py``), its cost analysis (computed once and
cached), the step's state record and any expectations the audit supplies,
and return findings + a JSON-able summary. They never raise on ugly
input: a surprise becomes an ``error`` finding so the audit can
gate on it.

Adding a pass:

    from repro_torch.analysis.passes import AuditContext, PassResult, \\
        register_pass

    @register_pass("my_pass")
    def my_pass(ctx: AuditContext) -> PassResult:
        res = PassResult(name="my_pass")
        for op in ctx.trace.ops:
            ...
            res.add("error", "what is wrong", op=op.name)
        res.summary["whatever"] = 42
        return res

then drive it from a contract (``analysis/contracts.py``) or directly
via ``run_pass("my_pass", ctx)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.analysis.cost import Analysis, analyze_trace
from repro_torch.analysis.op_trace import OpTrace

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass
class Finding:
    """One thing a pass noticed about the step."""
    severity: str            # "error" | "warn" | "info"
    message: str
    op: str = ""             # op name or index, when localizable
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        d = {"severity": self.severity, "message": self.message}
        if self.op:
            d["op"] = self.op
        if self.data:
            d["data"] = self.data
        return d


@dataclasses.dataclass
class PassResult:
    name: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def add(self, severity: str, message: str, op: str = "",
            **data: Any) -> None:
        assert severity in SEVERITIES, severity
        self.findings.append(Finding(severity, message, op, dict(data)))

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "pass": self.name,
            "ok": not self.errors,
            "findings": [f.as_dict() for f in self.findings],
            "summary": self.summary,
        }


@dataclasses.dataclass
class StateLeaf:
    """One tensor of the step's state: its bytes on this worker and
    whether the step left it in its own storage (updated in place)."""
    name: str
    bytes: int
    kept: bool


@dataclasses.dataclass
class AuditContext:
    """Everything a pass may look at for one recorded step.

    ``state`` is the step's state, leaf by leaf (``audit.state_leaves``;
    None without one); ``device_peak_bytes`` the card's
    peak allocation over the step (``torch.cuda.max_memory_allocated``;
    None on the CPU, where the memory pass estimates it from the
    trace). ``expectations`` carries facts computed beside the trace
    alone cannot know (number of state leaves, expected bucket count,
    ...) - passes and contracts reference them by key.
    """
    trace: OpTrace
    total_devices: int = 1
    expectations: Dict[str, Any] = dataclasses.field(default_factory=dict)
    state: Optional[List[StateLeaf]] = None
    device_peak_bytes: Optional[float] = None
    _analysis: Optional[Analysis] = dataclasses.field(
        default=None, repr=False)

    @property
    def analysis(self) -> Analysis:
        if self._analysis is None:
            self._analysis = analyze_trace(
                self.trace, total_devices=self.total_devices,
                parameter_bytes=float(sum(
                    s.bytes for s in self.state or ())))
        return self._analysis


_REGISTRY: Dict[str, Callable[[AuditContext], PassResult]] = {}


def register_pass(name: str):
    def deco(fn: Callable[[AuditContext], PassResult]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_pass(name: str) -> Callable[[AuditContext], PassResult]:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown audit pass {name!r}; available: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_passes() -> List[str]:
    return sorted(_REGISTRY)


def run_pass(name: str, ctx: AuditContext) -> PassResult:
    """Run one pass; an unexpected exception becomes an error finding
    rather than killing the audit."""
    fn = get_pass(name)
    try:
        return fn(ctx)
    except Exception as e:  # noqa: BLE001 - audit must not die mid-run
        res = PassResult(name=name)
        res.add("error", f"pass crashed: {type(e).__name__}: {e}")
        return res


# Register the built-in passes (import side effect, bottom of module to
# avoid circularity: pass modules import the framework names above).
from repro_torch.analysis.passes import comm  # noqa: E402,F401
from repro_torch.analysis.passes import determinism  # noqa: E402,F401
from repro_torch.analysis.passes import donation  # noqa: E402,F401
from repro_torch.analysis.passes import fusion  # noqa: E402,F401
from repro_torch.analysis.passes import interleave  # noqa: E402,F401
from repro_torch.analysis.passes import memory  # noqa: E402,F401
from repro_torch.analysis.passes import precision  # noqa: E402,F401
from repro_torch.analysis.passes import schedule  # noqa: E402,F401
