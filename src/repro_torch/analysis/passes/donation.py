"""In-place state audit (``donation`` pass): the port's counterpart of
XLA's donation / ``input_output_alias``.

The JAX package donates the step's state so XLA updates it in place; a
lost alias makes every step pay a full extra copy of the state. An
eager step updates its state tensors in place instead: every state
tensor must keep its storage across the step (``StateLeaf.kept``, the
storage before against the storage after). A tensor that comes back in
new storage costs its bytes again while both live.

The coverage gate is ``expectations["n_state_params"]``: with it, the
state the audit handed over must hold that many tensors, and a bulk of
them (>= 95 %, < 4 KiB wasted, as the JAX pass allows a scalar's
re-allocation) must be kept. Without it the pass only reports.
"""
from __future__ import annotations

from repro_torch.analysis.passes import AuditContext, PassResult, register_pass


@register_pass("donation")
def donation_pass(ctx: AuditContext) -> PassResult:
    res = PassResult(name="donation")
    state = ctx.state or []
    expected = ctx.expectations.get("n_state_params")
    gated = expected is not None
    kept = [s for s in state if s.kept]
    lost = [s for s in state if not s.kept]
    wasted = float(sum(s.bytes for s in lost))
    frac = len(kept) / len(state) if state else 1.0
    res.summary.update({
        "n_state_params": len(state),
        "n_state_leaves_declared": expected,
        "n_aliased": len(kept),
        "state_alias_fraction": round(frac, 4),
        "state_bytes": float(sum(s.bytes for s in state)),
        "wasted_bytes": wasted,
        "not_kept": [s.name for s in lost[:10]],
    })
    if not gated:
        res.add("info", f"{len(kept)}/{len(state)} state tensors kept "
                f"their storage (no n_state_params expectation; coverage "
                f"not gated)")
        return res
    for s in lost:
        if s.bytes >= 1024:
            res.add("warn", f"state tensor {s.name} ({s.bytes} B) came "
                    f"back in new storage", op=s.name, bytes=s.bytes)
    if len(state) != int(expected):
        res.add("error", f"the step's state holds {len(state)} tensors, "
                f"the audit declared {int(expected)}")
    if wasted >= 4096 or frac < 0.95:
        res.add("error",
                f"in-place update lost: only {len(kept)}/{len(state)} "
                f"state tensors kept their storage ({wasted:.0f} bytes a "
                f"worker copied each step)",
                wasted_bytes=wasted, state_alias_fraction=round(frac, 4))
    return res
