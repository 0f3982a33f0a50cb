"""Audit of the recorded train step (the JAX package's compiled-program
audit, DESIGN.md §12).

The JAX package reads the compiled HLO of its step; the port records
the op stream of one eager step instead:

- ``op_trace``    the recorder: every dispatched op and collective in
                  call order, the kernels' launches between them
- ``cost``        FLOPs / bytes touched / collective accounting
- ``passes``      the pass framework + the audit passes (comm,
                  interleave, precision, donation, memory, collectives,
                  determinism) and the fusion comparison report
- ``contracts``   the JAX package's per-(model, sync-mode) contracts
- ``audit``       the runner: runs the real train step in every sync
                  mode on the worker group and gates the contracts
                  (``python -m repro_torch.analysis.audit``)

The JAX package's HLO parser, renderer and trip-count multipliers have
no counterpart: an eager step has no program text and no loops to
weight.
"""
from typing import List, Optional

from repro_torch.analysis.cost import (  # noqa: F401
    Analysis,
    analyze_trace,
    gradient_sync_mode,
)
from repro_torch.analysis.op_trace import (  # noqa: F401
    COLLECTIVES,
    Op,
    OpTrace,
    record,
)
from repro_torch.analysis.passes import (  # noqa: F401
    AuditContext,
    Finding,
    PassResult,
    StateLeaf,
    available_passes,
    run_pass,
)


def quick_audit(trace: OpTrace, total_devices: int = 1,
                n_state_params: Optional[int] = None,
                state: Optional[List[StateLeaf]] = None):
    """Run the context-free audit passes on one recorded step and return
    a JSON-able record, what ``launch/dryrun.py`` embeds in its per-cell
    records. ``n_state_params`` (the number of the step's state
    tensors) and ``state`` (which of them kept their storage) arm the
    in-place coverage gate; without them the pass only reports."""
    ctx = AuditContext(trace=trace, total_devices=total_devices,
                       state=state)
    if n_state_params is not None:
        ctx.expectations["n_state_params"] = int(n_state_params)
    record = {}
    errors = 0
    for name in ("precision", "donation", "determinism", "collectives"):
        res = run_pass(name, ctx)
        record[name] = res.as_dict()
        errors += len(res.errors)
    record["ok"] = errors == 0
    return record
