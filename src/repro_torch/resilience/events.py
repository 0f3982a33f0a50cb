"""Structured JSON-lines event log for recovery actions (the JAX
package's ``resilience/events.py``).

Every action the resilience layer takes — a skipped step, a rollback, a
corrupt checkpoint skipped during restore, a chaos injection — is
emitted as one JSON object per line, so a post-mortem of a 1000-node run
is a ``jq`` query, not a grep over interleaved stdout. The log is
append-only and flushed per record (a crash loses at most the record
being written); records are also kept in memory so tests can assert on them without re-parsing the file.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional


class EventLog:
    """Append-only recovery event log.

    ``path=None`` keeps records in memory only (the default for tests
    and library use); with a path every record is also written as one
    JSON line and flushed immediately.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[Dict[str, Any]] = []
        self._fh = open(path, "a") if path else None
        self._seq = 0

    def emit(self, kind: str, **fields) -> Dict[str, Any]:
        rec = {"seq": self._seq, "time": time.time(), "kind": kind}
        rec.update(fields)
        self._seq += 1
        self.records.append(rec)
        if self._fh is not None:
            json.dump(rec, self._fh, default=_json_default)
            self._fh.write("\n")
            self._fh.flush()
        return rec

    def kinds(self) -> List[str]:
        return [r["kind"] for r in self.records]

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _json_default(obj):
    """Numpy scalars and 0-d tensors arrive in metrics dicts; log them as
    plain python numbers rather than crashing the event path
    mid-recovery."""
    for attr in ("item",):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                pass
    return repr(obj)
