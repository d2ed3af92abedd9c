"""Graceful-degradation controller: per-path circuit breakers. The port's
copy of `emqx_tpu/broker/degrade.py` (`IngestShed`, `STATE_CODE`,
`Breaker` :56, `DegradeController` :207).

The device path gets a breaker walking the ladder

    closed ──(retries exhausted x failure_threshold)──▶ open/degraded
      ▲                                                    │
      │  probe_successes consecutive                       │ open_secs
      └──────── successful probes ◀── half-open ◀──────────┘

driving real fallbacks rather than errors: an open device breaker serves
whole batches from the broker's authoritative CPU path
(`Broker.adispatch_begin` / `dispatch_batch_folded` ->
`_dispatch_cpu_batch`: the trie and the host fan-out, never a kernel's
plain twin), and the ingest window sheds enqueues past its queue bound
while the breaker is open (broker/ingest.py). A half-open probe sends one
real batch down the device path, and its success closes the breaker.

Every transition sets the `degrade.state.*` gauge (0 closed, 1 half-open,
2 open) and counts `degrade.trips.*` / `degrade.probe.ok` /
`degrade.probe.fail`; `retry_delays` counts `degrade.retries`. With a span
recorder (`spans`, duck-typed: `start(name, attrs=)` / `finish(span)`)
each transition is also a `degrade.transition` span event; the port has
no recorder yet (ROADMAP item 10.3c), so `spans` is None there.

`cluster_breaker` keeps the reference's per-destination breakers so a
reference `snapshot()` restores whole; the port has no cluster bus that
would consult them.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional

log = logging.getLogger("emqx_tpu_torch.degrade")

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"


class IngestShed(RuntimeError):
    """The ingest gate refused an enqueue (overload / open breaker past
    the queue bound). Backpressure, not loss: the publisher's PUBACK
    fails and a QoS>=1 client retries — the queue never grows unbounded
    behind a broken device path."""


# gauge encoding for degrade.state.* (alert on > 0)
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class Breaker:
    """One path's breaker. Thread-safe: the device path records results
    from the loop and from pool threads.

    `allow()` is the gate callers consult before taking the fast path;
    it returns True in closed state, admits exactly one probe at a time
    in half-open, and flips open -> half-open when the dwell elapses.
    """

    def __init__(
        self,
        name: str,
        state_series: str = "",
        trips_series: str = "",
        *,
        metrics=None,
        spans=None,
        failure_threshold: int = 1,
        open_secs: float = 5.0,
        probe_successes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.state_series = state_series
        self.trips_series = trips_series
        self.metrics = metrics
        self.spans = spans
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_secs = float(open_secs)
        self.probe_successes = max(1, int(probe_successes))
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._failures = 0  # guarded-by: _lock (consecutive)
        self._open_until = 0.0  # guarded-by: _lock
        self._probe_inflight = False  # guarded-by: _lock
        self._probe_ok = 0  # guarded-by: _lock
        self.trips = 0  # total open transitions

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:  # holds-lock: _lock
        # an elapsed open dwell is observable without a transition call:
        # a state read never reports "open" past the probe due time
        if self._state == OPEN and self.clock() >= self._open_until:
            return HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """May the caller take the fast path right now?"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self.clock() >= self._open_until:
                self._transition(HALF_OPEN, reason="probe_due")
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == CLOSED:
                self._failures = 0
                return
            self._probe_inflight = False
            self._probe_ok += 1
            if self.metrics is not None:
                self.metrics.inc("degrade.probe.ok")
            if self._probe_ok >= self.probe_successes:
                self._failures = 0
                self._transition(CLOSED, reason="probe_recovered")

    def record_failure(self, reason: str = "failure") -> None:
        with self._lock:
            if self._state in (HALF_OPEN, OPEN):
                # a failed probe (or a straggler failing while open)
                # restarts the dwell — no threshold accounting
                self._probe_inflight = False
                if self._state == HALF_OPEN and self.metrics is not None:
                    self.metrics.inc("degrade.probe.fail")
                self._open_until = self.clock() + self.open_secs
                self._transition(OPEN, reason=f"probe_{reason}")
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._open_until = self.clock() + self.open_secs
                self.trips += 1
                if self.metrics is not None and self.trips_series:
                    self.metrics.inc(self.trips_series)
                self._transition(OPEN, reason=reason)

    def _transition(self, new: str, reason: str) -> None:  # holds-lock: _lock
        old, self._state = self._state, new
        if new != OPEN:
            self._probe_ok = 0 if new == HALF_OPEN else self._probe_ok
        if new == CLOSED:
            self._probe_ok = 0
        if old == new:
            return
        log.warning("degrade[%s]: %s -> %s (%s)", self.name, old, new, reason)
        if self.metrics is not None and self.state_series:
            self.metrics.gauge_set(self.state_series, STATE_CODE[new])
        rec = self.spans
        if rec is not None:
            sp = rec.start(
                "degrade.transition",
                attrs={"path": self.name, "from": old, "to": new, "reason": reason},
            )
            rec.finish(sp)

    def force(self, state: str, open_remaining_s: float = 0.0) -> None:
        """Restore-time entry: re-enter a persisted state without
        replaying the failures that caused it."""
        with self._lock:
            if state == OPEN:
                self._open_until = self.clock() + max(0.0, open_remaining_s)
                self._transition(OPEN, reason="restored")
            elif state == HALF_OPEN:
                # resume as open-with-elapsed-dwell: the next allow()
                # probes immediately (no probe token leaks across)
                self._open_until = self.clock()
                self._transition(OPEN, reason="restored")
            else:
                self._failures = 0
                self._transition(CLOSED, reason="restored")

    def to_json(self) -> Dict:
        with self._lock:
            return {
                "state": self._effective_state(),
                "trips": self.trips,
                "open_remaining_s": max(0.0, self._open_until - self.clock())
                if self._state == OPEN
                else 0.0,
            }


class DegradeController:
    """The broker's breaker set + shared retry policy.

    Paths:
    - ``device``: route/launch/readback/sync failures. Open = whole
      batches serve from the CPU path; ingest sheds past its queue bound.
    - ``cluster_send``: per destination (`cluster_breaker()`), all
      sharing the cluster_send series.

    `seed` seeds the retry jitter's own `random.Random`, so two
    controllers with the same seed draw the same delays.
    """

    def __init__(
        self,
        metrics=None,
        spans=None,
        *,
        max_retries: int = 2,
        backoff_base_s: float = 0.02,
        backoff_max_s: float = 2.0,
        jitter: float = 0.5,
        failure_threshold: int = 1,
        open_secs: float = 5.0,
        probe_successes: int = 1,
        shed_queue_batches: int = 8,
        clock: Callable[[], float] = time.monotonic,
        seed: int = 0,
    ):
        self.metrics = metrics
        self.spans = spans
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.shed_queue_batches = max(1, int(shed_queue_batches))
        self._rng = random.Random(seed)
        self._mk = dict(
            metrics=metrics,
            spans=spans,
            failure_threshold=failure_threshold,
            open_secs=open_secs,
            probe_successes=probe_successes,
            clock=clock,
        )
        self.device = Breaker(
            "device",
            state_series="degrade.state.device",
            trips_series="degrade.trips.device",
            **self._mk,
        )
        self._cluster_lock = threading.Lock()
        self._cluster: Dict[str, Breaker] = {}  # guarded-by: _cluster_lock

    # -- retry policy -------------------------------------------------------
    def retry_delays(self) -> Iterator[float]:
        """Bounded exponential backoff + jitter: one delay per retry
        attempt (max_retries total). Each yield counts degrade.retries."""
        d = self.backoff_base_s
        for _ in range(self.max_retries):
            if self.metrics is not None:
                self.metrics.inc("degrade.retries")
            yield min(self.backoff_max_s, d) * (1.0 + self.jitter * self._rng.random())
            d *= 2.0

    # -- cluster breakers ---------------------------------------------------
    def cluster_breaker(self, dst: str) -> Breaker:
        """Per-destination breaker (lazily created)."""
        with self._cluster_lock:
            br = self._cluster.get(dst)
            if br is None:
                br = Breaker(
                    f"cluster_send:{dst}",
                    state_series="degrade.state.cluster_send",
                    trips_series="degrade.trips.cluster_send",
                    **self._mk,
                )
                self._cluster[dst] = br
            return br

    # -- persistence ---------------------------------------------------------
    def snapshot(self) -> Dict:
        """Serializable breaker states: a broker resuming mid-degradation
        re-enters them instead of re-learning them from live failures. The
        reference's format, so either package restores the other's."""
        with self._cluster_lock:
            cluster = {d: b.to_json() for d, b in self._cluster.items()}
        return {"device": self.device.to_json(), "cluster": cluster}

    def restore(self, data: Optional[Dict]) -> None:
        if not data:
            return
        dev = data.get("device") or {}
        if dev.get("state") in (OPEN, HALF_OPEN):
            self.device.force(dev["state"], float(dev.get("open_remaining_s", 0.0)))
        self.device.trips = int(dev.get("trips", self.device.trips))
        for dst, b in (data.get("cluster") or {}).items():
            if b.get("state") in (OPEN, HALF_OPEN):
                self.cluster_breaker(dst).force(
                    b["state"], float(b.get("open_remaining_s", 0.0))
                )

    def to_json(self) -> Dict:
        return self.snapshot()
