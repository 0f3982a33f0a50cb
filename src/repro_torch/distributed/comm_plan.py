"""Persisted communication plans: the JAX package's
``distributed/comm_plan.py``, the same grammar, schema and fallbacks, so
a plan file written by either package loads in the other.

The training CLI takes one with ``--comm-plan``:

    --comm-plan flat        the flat single-stage schedule
    --comm-plan hier[:k]    the hierarchical schedule, dp_axes split at k
                            (default 1), without reading any file
    --comm-plan auto        load results/comm_plan_{arch}_{AxB}.json for
                            the current mesh; fall back to flat (with a
                            warning) when the plan is missing, stale, or
                            was tuned for another mesh
    --comm-plan <path>      load that plan file; the same fallback

A loaded plan carries the whole wire configuration (sync mode, wire
dtype, bucket size, hierarchy split), which the CLI applies. The grammar
forms ``flat`` / ``hier[:k]`` only reschedule the collectives and leave
the other flags as they are. The JAX package's comm autotuner
(``benchmarks/comm_bench.py --plan-out``) writes such plans.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Optional, Tuple

PLAN_VERSION = 1

#: sync modes a plan may name: the CLI's --overlap-comm / --zero flags
SYNC_MODES = ("bucketed", "overlap", "zero", "zero_overlap")


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One persisted gradient-sync configuration for one mesh."""

    mesh_shape: Tuple[int, ...]  # workers per mesh axis
    dp_axes: Tuple[str, ...]  # DP axis names, mesh order
    sync_mode: str  # one of SYNC_MODES
    wire: str  # wire dtype short name: bf16 | f16
    bucket_bytes: int
    hier_split: Optional[int]  # None = flat schedule
    source: str = "manual"  # "autotuner" | "manual"
    version: int = PLAN_VERSION

    def __post_init__(self):
        if self.sync_mode not in SYNC_MODES:
            raise ValueError(
                f"sync_mode {self.sync_mode!r} not in {SYNC_MODES}")
        if self.hier_split is not None:
            if not 1 <= self.hier_split < len(self.dp_axes):
                raise ValueError(
                    f"hier_split={self.hier_split} must split "
                    f"dp_axes={self.dp_axes} into two non-empty stages")

    @property
    def compression(self) -> str:
        """The --compression string this plan implies."""
        return self.wire + "+bucketed"

    def describe(self) -> str:
        mesh = "x".join(str(s) for s in self.mesh_shape)
        sched = ("flat" if self.hier_split is None
                 else f"hier:{self.hier_split}")
        return (f"{self.sync_mode} {self.wire} "
                f"{self.bucket_bytes // 1024}KiB {sched} on {mesh}")


def plan_path(arch: str, mesh_shape: Tuple[int, ...],
              out_dir: str = "results") -> str:
    """Where ``auto`` looks: results/comm_plan_{arch}_{AxB}.json."""
    mesh = "x".join(str(s) for s in mesh_shape)
    return os.path.join(out_dir, f"comm_plan_{arch}_{mesh}.json")


def save_plan(plan: CommPlan, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(plan), f, indent=1)
    return path


def load_plan(path: str) -> CommPlan:
    with open(path) as f:
        raw = json.load(f)
    version = raw.get("version")
    if version != PLAN_VERSION:
        raise StaleCommPlan(
            f"comm plan {path} has version {version!r}, "
            f"expected {PLAN_VERSION}")
    try:
        return CommPlan(
            mesh_shape=tuple(raw["mesh_shape"]),
            dp_axes=tuple(raw["dp_axes"]),
            sync_mode=raw["sync_mode"],
            wire=raw["wire"],
            bucket_bytes=int(raw["bucket_bytes"]),
            hier_split=raw["hier_split"],
            source=raw.get("source", "manual"),
            version=version,
        )
    except (KeyError, TypeError, ValueError) as e:
        raise StaleCommPlan(f"comm plan {path} is malformed: {e}") from e


class StaleCommPlan(Exception):
    """A plan file exists but cannot be used (old schema, malformed)."""


class CommPlanWarning(UserWarning):
    """A comm plan was asked for but could not be applied; the run fell
    back to the flat schedule."""


def _check_mesh(plan: CommPlan, mesh_shape: Tuple[int, ...],
                dp_axes: Tuple[str, ...]) -> Optional[str]:
    """None if the plan matches this run's layout, else the reason."""
    if tuple(plan.mesh_shape) != tuple(mesh_shape):
        return (f"plan was tuned for mesh "
                f"{'x'.join(map(str, plan.mesh_shape))}, this run has "
                f"{'x'.join(map(str, mesh_shape))}")
    if tuple(plan.dp_axes) != tuple(dp_axes):
        return f"plan DP axes {plan.dp_axes} != run DP axes {dp_axes}"
    return None


def resolve_comm_plan(spec: str, *, arch: str,
                      mesh_shape: Tuple[int, ...],
                      dp_axes: Tuple[str, ...],
                      out_dir: str = "results") -> Optional[CommPlan]:
    """A --comm-plan spec as a plan (None = flat).

    Grammar: ``flat`` | ``hier[:k]`` | ``auto`` | ``<path>``.

    ``auto`` and ``<path>`` fall back to flat with a ``CommPlanWarning``
    when the plan is missing, stale (old schema) or malformed, or was
    tuned for another mesh: a wrong plan applied silently would reshape
    every collective of the step. ``hier[:k]`` raises instead: the user
    asked for that schedule.
    """
    spec = spec.strip()
    if spec == "flat":
        return None
    if spec == "hier" or spec.startswith("hier:"):
        split = int(spec.split(":", 1)[1]) if ":" in spec else 1
        # make_hierarchy validates the split for real when the step is
        # built; the dataclass catches a split out of range early
        return CommPlan(mesh_shape=tuple(mesh_shape),
                        dp_axes=tuple(dp_axes), sync_mode="bucketed",
                        wire="bf16", bucket_bytes=0, hier_split=split,
                        source="manual")
    path = (plan_path(arch, mesh_shape, out_dir) if spec == "auto"
            else spec)
    try:
        plan = load_plan(path)
    except FileNotFoundError:
        warnings.warn(
            f"--comm-plan {spec}: no plan at {path}; using the flat "
            "schedule (the JAX package's benchmarks/comm_bench.py "
            "--plan-out tunes one)", CommPlanWarning, stacklevel=2)
        return None
    except StaleCommPlan as e:
        warnings.warn(f"--comm-plan {spec}: {e}; using the flat "
                      "schedule", CommPlanWarning, stacklevel=2)
        return None
    reason = _check_mesh(plan, mesh_shape, dp_axes)
    if reason is not None:
        warnings.warn(
            f"--comm-plan {spec}: {reason}; using the flat schedule",
            CommPlanWarning, stacklevel=2)
        return None
    return plan
