"""Deterministic chaos harness: seed-driven fault injection (the JAX
package's ``resilience/chaos.py``, with the same grammar, triggers and
per-trigger rng, so one spec and seed poison the same element and
corrupt the same byte in both packages).

Testing a recovery path that only triggers on 1000-node hardware faults
needs faults on demand: this module injects them *deterministically*,
keyed by (spec, seed, step), so a failing soak reproduces bit-for-bit.
Faults are injected at the system's real boundaries — the batch the
data pipeline hands over, the checkpoint bytes on disk, the host-side
step dispatch — never by patching the step, so the detection path being
exercised is exactly the production one.

Spec grammar (``--chaos`` in launch/train.py)::

    spec    := clause (',' clause)*
    clause  := 'seed=' INT
             | KIND '@' STEP ['-' STEP] [':' FLOAT]
    KIND    := nan_grad | data_crash | data_stall | straggler
             | ckpt_truncate | ckpt_bitflip

Fault classes (every trigger fires **once** — a transient fault, so a
post-rollback replay of the same step is clean):

* ``nan_grad@S[-E]``    — poison one seed-chosen element of the batch's
                          first float leaf with NaN at step S (..E).
                          The NaN flows through loss and backward into
                          every gradient bucket — the real
                          NaN-poisoned-bucket failure mode, detected by
                          the packed-stream sentinel flags.
* ``data_crash@S``      — ``batch_at(S)`` raises ``ChaosError`` once:
                          a dead input worker. Propagates through the
                          pipeline's error contract; the Trainer's
                          bounded data-retry path restarts the
                          pipeline.
* ``data_stall@S[:sec]``— ``batch_at(S)`` sleeps (default 1.0 s): a
                          stalled input worker, surfacing as a
                          straggler step.
* ``straggler@S[:sec]`` — host-side sleep before dispatching step S
                          (default 0.5 s): a slow worker.
* ``ckpt_truncate@S``   — after the first checkpoint save completing at
                          step >= S, truncate the newest checkpoint's
                          ``arrays.npz`` to half: a torn write. The
                          integrity-checked restore must fall back to
                          the next-newest checkpoint.
* ``ckpt_bitflip@S``    — flip one seed-chosen byte instead: silent
                          media corruption, caught by the zip/crc32
                          validation on restore.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.checkpointer import ARRAYS, list_checkpoints


KINDS = ("nan_grad", "data_crash", "data_stall", "straggler",
         "ckpt_truncate", "ckpt_bitflip")
_DATA_KINDS = ("nan_grad", "data_crash", "data_stall")
_CKPT_KINDS = ("ckpt_truncate", "ckpt_bitflip")

_CLAUSE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<lo>\d+)(?:-(?P<hi>\d+))?(?::(?P<arg>[\d.]+))?$")

_DEFAULT_ARG = {"data_stall": 1.0, "straggler": 0.5}


class ChaosError(RuntimeError):
    """The injected data-pipeline fault (a 'dead input worker')."""


@dataclasses.dataclass
class Trigger:
    kind: str
    step: int
    arg: Optional[float] = None
    fired: bool = False


def parse_chaos(spec: str, seed: int = 0,
                events=None) -> "ChaosEngine":
    """Parse a ``--chaos`` spec string into an engine. Raises
    ``ValueError`` on unknown kinds or malformed clauses."""
    triggers: List[Trigger] = []
    for raw in spec.split(","):
        clause = raw.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[len("seed="):])
            continue
        m = _CLAUSE.match(clause)
        if not m:
            raise ValueError(
                f"bad chaos clause {clause!r}: expected "
                "kind@step[-end][:arg] or seed=<int> "
                f"(kinds: {', '.join(KINDS)})")
        kind = m.group("kind")
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r} in {clause!r} "
                             f"(kinds: {', '.join(KINDS)})")
        lo = int(m.group("lo"))
        hi = int(m.group("hi")) if m.group("hi") else lo
        if hi < lo:
            raise ValueError(f"bad chaos range in {clause!r}: {hi} < {lo}")
        arg = (float(m.group("arg")) if m.group("arg")
               else _DEFAULT_ARG.get(kind))
        for s in range(lo, hi + 1):
            triggers.append(Trigger(kind=kind, step=s, arg=arg))
    return ChaosEngine(triggers, seed=seed, events=events)


class ChaosEngine:
    """Holds the trigger table and injects at the three hook points the
    Trainer exposes: the data source (``wrap_source``), the host step
    dispatch (``on_step_start``), and completed checkpoint saves
    (``after_save``)."""

    def __init__(self, triggers: List[Trigger], seed: int = 0,
                 events=None):
        self.triggers = list(triggers)
        self.seed = seed
        self.events = events
        self.injected: List[Dict] = []

    # ------------------------------------------------------------ util
    def _fire(self, trig: Trigger, **fields):
        trig.fired = True
        rec = {"kind": trig.kind, "step": trig.step, **fields}
        self.injected.append(rec)
        if self.events is not None:
            # the event's own kind is "chaos_injected"; the fault class
            # rides along as the `fault` field
            self.events.emit("chaos_injected", fault=trig.kind,
                             step=trig.step, **fields)

    def _pending(self, kinds, step=None):
        return [t for t in self.triggers
                if t.kind in kinds and not t.fired
                and (step is None or t.step == step)]

    def _rng(self, trig: Trigger) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 9_999_991 + trig.step * 101
             + KINDS.index(trig.kind)) % (2 ** 31 - 1))

    # ------------------------------------------------------ data hooks
    def wrap_source(self, source):
        """Wrap a ``batch_at(step)`` data source with the data-class
        faults (nan_grad / data_crash / data_stall)."""
        return _ChaosSource(self, source)

    def inject_batch(self, step: int, batch: Dict[str, np.ndarray]):
        for trig in self._pending(("data_crash",), step):
            self._fire(trig)
            raise ChaosError(
                f"chaos: injected input-worker crash at step {step}")
        for trig in self._pending(("data_stall",), step):
            self._fire(trig, seconds=trig.arg)
            time.sleep(trig.arg)
        for trig in self._pending(("nan_grad",), step):
            key = next((k for k in sorted(batch)
                        if np.issubdtype(np.asarray(batch[k]).dtype,
                                         np.floating)), None)
            if key is None:
                raise ValueError(
                    "chaos nan_grad needs a float batch leaf to poison; "
                    f"batch has only {sorted(batch)} "
                    "(integer token pipelines are not supported)")
            arr = np.array(batch[key])  # poison a copy, never the source
            flat = arr.reshape(-1)
            pos = int(self._rng(trig).randint(flat.size))
            flat[pos] = np.nan
            batch = dict(batch)
            batch[key] = arr
            self._fire(trig, leaf=key, position=pos)
        return batch

    # ------------------------------------------------------ host hooks
    def on_step_start(self, step: int):
        for trig in self._pending(("straggler",), step):
            self._fire(trig, seconds=trig.arg)
            time.sleep(trig.arg)

    def has_pending_ckpt_fault(self, step: int) -> bool:
        return any(t.step <= step
                   for t in self._pending(_CKPT_KINDS))

    def after_save(self, directory: str, step: int):
        """Corrupt the newest checkpoint for every armed ckpt trigger
        whose step has passed. The caller must have flushed any async
        save first (the Trainer does ``ckpt.wait()``)."""
        for trig in [t for t in self._pending(_CKPT_KINDS)
                     if t.step <= step]:
            steps = list_checkpoints(directory)
            if not steps:
                continue  # stays armed for the next save
            newest = steps[-1]
            path = os.path.join(directory, f"step_{newest:010d}", ARRAYS)
            size = os.path.getsize(path)
            if trig.kind == "ckpt_truncate":
                with open(path, "r+b") as f:
                    f.truncate(size // 2)
                self._fire(trig, target_step=newest, truncated_to=size // 2)
            else:
                pos = int(self._rng(trig).randint(size))
                with open(path, "r+b") as f:
                    f.seek(pos)
                    byte = f.read(1)
                    f.seek(pos)
                    f.write(bytes([byte[0] ^ 0xFF]))
                self._fire(trig, target_step=newest, flipped_byte=pos)

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.injected:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return out


class _ChaosSource:
    """A ``batch_at`` source with the engine's data faults applied."""

    def __init__(self, engine: ChaosEngine, source):
        self._engine = engine
        self._source = source

    def __getattr__(self, name):
        return getattr(self._source, name)

    def batch_at(self, step: int):
        return self._engine.inject_batch(step, self._source.batch_at(step))
