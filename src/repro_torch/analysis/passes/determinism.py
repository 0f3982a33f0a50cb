"""Determinism lint (``determinism`` pass).

The repo's parity rails (the bitwise-equality tests of the bucketed,
overlapped and ZeRO steps) assume the step is a pure function of its
inputs. Two op families can silently break that:

- random ops (``rand*``, ``bernoulli``, ``normal``, dropout, ...):
  hidden generator state -> **error** unless the audit sets
  ``expectations["allow_rng"]`` (a model with dropout would).
- ops a card runs with atomic adds (``index_add_``, ``scatter_add_``,
  ``index_put_`` accumulating, the embedding backward, ...): their
  summation order is unspecified -> **warn** by default, **error** when
  the contract sets ``expectations["forbid_scatter"]``.

Max-pool's backward is not in the second family: the JAX package
excludes its counterpart (``select-and-scatter``) as deterministic.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

from repro_torch.analysis.passes import AuditContext, PassResult, register_pass

RNG_OPS = {"rand", "rand_like", "randn", "randn_like", "randint",
           "randint_like", "randperm", "bernoulli", "bernoulli_", "normal",
           "normal_", "uniform_", "exponential_", "geometric_",
           "log_normal_", "cauchy_", "random_", "multinomial",
           "native_dropout", "_fused_dropout", "poisson",
           "rrelu_with_noise"}
ATOMIC_OPS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
              "scatter_reduce", "scatter_reduce_", "index_reduce",
              "index_reduce_", "put_", "embedding_dense_backward",
              "_embedding_bag_backward", "_embedding_bag_dense_backward",
              "index_put_", "_index_put_impl_", "index_put"}


@register_pass("determinism")
def determinism_pass(ctx: AuditContext) -> PassResult:
    res = PassResult(name="determinism")
    counts: Dict[str, float] = defaultdict(float)
    for op in ctx.trace.ops:
        name = op.short
        if name in RNG_OPS:
            counts[name] += 1
            if not ctx.expectations.get("allow_rng"):
                res.add("error",
                        f"{name} breaks bitwise parity (hidden generator "
                        f"state in the step)", op=f"{op.index}:{name}")
        elif name in ATOMIC_OPS:
            counts[name] += 1
            sev = "error" if ctx.expectations.get("forbid_scatter") \
                else "warn"
            res.add(sev,
                    f"{name} adds in an unspecified order on the card "
                    f"(atomics); bitwise parity is device-dependent",
                    op=f"{op.index}:{name}")
    res.summary.update({
        "op_counts": {k: round(v, 2) for k, v in sorted(counts.items())},
        "clean": not counts,
    })
    return res
