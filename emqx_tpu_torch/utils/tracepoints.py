"""Structured trace points for concurrency tests: the port's copy of
`emqx_tpu/utils/tracepoints.py`, trimmed to what the port uses.
`BatchIngest` emits `ingest.launch` / `ingest.settle` through `tp` (the
channel and the channel manager their CONNECT, takeover and resume
points), and tests collect them with a `TraceCollector` to assert the
pipeline's schedule. The reference's nemesis (`atp`, the injections) and its causal
assertions are not ported: no port module emits an `atp` point.

`tp(kind, **fields)` emits a structured event into the active collector
— a single module-level flag check when tracing is off, so production
paths pay one branch. Only tests activate collection; kinds are
free-form strings named at the emission site.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

_active: Optional["TraceCollector"] = None


def tp(kind: str, **fields) -> None:
    if _active is not None:
        _active._emit(kind, fields)


class TraceCollector:
    def __init__(self):
        self.events: List[Dict] = []

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("a TraceCollector is already active")
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None

    def _emit(self, kind: str, fields: Dict) -> None:
        self.events.append(
            {"kind": kind, "at": time.monotonic(), **fields}
        )
