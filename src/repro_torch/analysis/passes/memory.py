"""Live-range peak-memory estimator (``memory`` pass).

The step's state (params, optimizer state, model state) is resident for
the whole step; its bytes on this worker are ``entry_param_bytes``,
what the audit's ZeRO relation checks shrinks by ~(N-1)/N of the
optimizer state (DESIGN.md §9). The temporaries' peak is
``torch.cuda.max_memory_allocated`` over the step on the card
(``AuditContext.device_peak_bytes``); on the CPU it is estimated from
the trace by a linear scan in call order: each new buffer is live from
the op that made it to its last use (a view's or an in-place write's
use counts for its buffer), and the peak is the largest live sum.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis.passes import AuditContext, PassResult, register_pass


@register_pass("memory")
def memory_pass(ctx: AuditContext) -> PassResult:
    res = PassResult(name="memory")
    ops = ctx.trace.ops
    n = len(ops)
    last_use: Dict[int, int] = {}
    for i, op in enumerate(ops):
        for s in op.src:
            if s >= 0:
                owner = ops[s].owner
                last_use[owner if owner >= 0 else s] = i
    events = [0.0] * (n + 1)
    buffers = []
    for i, op in enumerate(ops):
        b = float(op.new_bytes)
        if b <= 0 or op.owner != i:
            continue
        end = max(last_use.get(i, i), i)
        events[i] += b
        events[end + 1] -= b
        buffers.append((b, op.short, i))
    live = temp_peak = 0.0
    peak_at = 0
    for i in range(n):
        live += events[i]
        if live > temp_peak:
            temp_peak, peak_at = live, i
    param_bytes = float(sum(s.bytes for s in ctx.state or ()))
    peak = (float(ctx.device_peak_bytes) if ctx.device_peak_bytes
            is not None else param_bytes + temp_peak)
    buffers.sort(reverse=True)
    res.summary.update({
        "entry_param_bytes": param_bytes,
        "temp_peak_bytes": temp_peak,
        "peak_bytes": peak,
        "peak_source": ("device" if ctx.device_peak_bytes is not None
                        else "liveness"),
        "peak_at_op_index": peak_at,
        "n_buffers": len(buffers),
        "top_buffers": [{"bytes": b, "opcode": oc, "op": i}
                        for b, oc, i in buffers[:10]],
    })
    cap = ctx.expectations.get("max_peak_bytes")
    if cap is not None and peak > float(cap):
        res.add("error",
                f"per-device peak {peak:.0f} B exceeds contract cap "
                f"{float(cap):.0f} B", peak_bytes=peak, cap=float(cap))
    return res
