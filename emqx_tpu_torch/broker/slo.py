"""SLO-driven adaptive batching: tail latency as a controlled variable.
The port's copy of `emqx_tpu/broker/slo.py` (pure Python): the priority
lanes and ladder rungs `BatchIngest` reads, `delta_percentile` and
`SloController`. Its feedback signal is the port's `Metrics` histogram
`ingest.settle.seconds` (`Histogram.snapshot`); the `spans` recorder
(observe/spans.py) and the `SloViolationWatch` alarm come with the host
observability (ROADMAP item 10.3c), so `spans` stays None there.

The ingest window used to be a fixed policy (`window_us=1000`) with one
binary escape hatch — shed everything past `shed_queue_batches *
max_batch` while overloaded. Production traffic is not fixed:
"Benchmarking Message Brokers for IoT Edge Computing" (PAPERS.md) shows
brokers differentiate on the latency-vs-throughput *frontier*, not peak
RPS. This module is the continuous-batching controller (the
inference-server idiom) that turns the window into a controlled
variable:

- **feedback signal**: the `ingest.settle.seconds` histogram —
  each evaluation window diffs the cumulative buckets and computes the
  p99 of ONLY the publishes that settled since the last look;
- **control law**: hold the configured p99 target with hysteresis.
  Idle traffic decays the window toward `min_window_us` (immediate
  partial launches); sustained violations widen it toward
  `max_window_us` (deep batches amortize launches AND slow intake —
  graded backpressure the publisher feels as latency, not loss);
  readings inside the hysteresis band change nothing (no oscillation
  between flush cycles);
- **backpressure ladder** (docs/robustness.md): violations escalate
  `normal -> widen -> defer -> shed` with `ladder_patience` consecutive
  readings per rung, and de-escalate the same way. `widen` deepens
  batches; `defer` parks the low-priority lane (QoS0 firehose,
  retained-storm replays) so control traffic launches first; `shed`
  refuses new low-priority enqueues past the queue bound — the old
  binary `IngestShed` cliff is now the LAST rung, not the only one;
- **degrade integration**: an open device breaker (broker/degrade.py)
  forces the ladder to at least `widen` — the CPU fallback path wants
  deep batches and slowed intake — but shedding still requires walking
  the remaining rungs. Breaker-open never jumps straight to drops.

Priority lanes (broker/ingest.py): `control` (QoS2 control flow, $SYS,
session-critical traffic) > `normal` (QoS1) > `low` (QoS0 firehose,
retained-storm replays). The flusher assembles batches in lane order
with an anti-starvation reserve, so a storm can delay the low lane but
never a PUBREL behind it — and the low lane is never starved outright.

Controller state rides `slo.*` gauges/counters and batch-span attrs;
`SloViolationWatch` (observe/alarm.py) raises the level-triggered
`slo_p99_violation` alarm on sustained target misses.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("emqx_tpu_torch.slo")

# priority lanes (broker/ingest.py BatchIngest)
LANE_CONTROL = 0
LANE_NORMAL = 1
LANE_LOW = 2
LANE_NAMES = ("control", "normal", "low")

# backpressure ladder rungs, in escalation order (docs/robustness.md)
RUNG_NORMAL = 0
RUNG_WIDEN = 1
RUNG_DEFER = 2
RUNG_SHED = 3
RUNG_NAMES = ("normal", "widen", "defer", "shed")


def delta_percentile(
    prev: Optional[Dict], cur: Optional[Dict], q: float
) -> Tuple[float, int]:
    """Percentile of the observations BETWEEN two cumulative histogram
    snapshots (`Histogram.snapshot()` shape). Returns (value, samples);
    (0.0, 0) when nothing landed. Interpolates inside the landing bucket
    like `Histogram.percentile`; a quantile in the +Inf overflow bucket
    reports the last finite bound."""
    if cur is None:
        return 0.0, 0
    cur_b = cur["buckets"]
    prev_b = prev["buckets"] if prev is not None else None
    n = cur["count"] - (prev["count"] if prev is not None else 0)
    if n <= 0:
        return 0.0, 0
    rank = q * n
    cum = 0
    lo = 0.0
    for i, (le, c_cum) in enumerate(cur_b):
        p_cum = prev_b[i][1] if prev_b is not None else 0
        d_cum = c_cum - p_cum
        if d_cum > cum:
            bucket = d_cum - cum
            prev_cum = cum
            cum = d_cum
            if cum >= rank:
                if le == float("inf"):
                    return lo, n
                frac = (rank - prev_cum) / bucket if bucket else 1.0
                return lo + (le - lo) * min(max(frac, 0.0), 1.0), n
        if le != float("inf"):
            lo = le
    return lo, n


class SloController:
    """Adapts `BatchIngest`'s window each flush cycle to hold a p99
    target, and owns the graded backpressure ladder.

    Single-writer: loop (BatchIngest._run drives `tick`; lane/shed
    queries run on the loop too). All knobs map 1:1 to `slo.*` config
    keys (config/schema.py SloConfig)."""

    def __init__(
        self,
        metrics=None,
        *,
        target_p99_ms: float = 5.0,
        min_window_us: int = 0,
        max_window_us: int = 20_000,
        initial_window_us: int = 1000,
        eval_interval_s: float = 0.05,
        min_samples: int = 32,
        gain: float = 0.25,
        hysteresis: float = 0.7,
        ladder_patience: int = 3,
        defer_max_s: float = 0.25,
        starvation_s: float = 0.05,
        shed_hard_mult: float = 4.0,
        series: str = "ingest.settle.seconds",
        olp=None,
        spans=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.metrics = metrics
        self.target_p99_ms = float(target_p99_ms)
        self.min_window_s = max(0.0, min_window_us / 1e6)
        self.max_window_s = max(self.min_window_s, max_window_us / 1e6)
        self.eval_interval_s = max(0.001, float(eval_interval_s))
        self.min_samples = max(1, int(min_samples))
        self.gain = min(0.9, max(0.01, float(gain)))
        self.hysteresis = min(1.0, max(0.0, float(hysteresis)))
        self.ladder_patience = max(1, int(ladder_patience))
        self.defer_max_s = max(0.0, float(defer_max_s))
        self.starvation_s = max(0.0, float(starvation_s))
        self.shed_hard_mult = max(1.0, float(shed_hard_mult))
        self.series = series
        self.olp = olp
        self.spans = spans
        self.clock = clock
        self.window_s = min(
            self.max_window_s, max(self.min_window_s, initial_window_us / 1e6)
        )
        self.rung = RUNG_NORMAL
        self.last_p99_ms: Optional[float] = None
        self.last_samples = 0
        self._viol = 0  # consecutive violating evaluations
        self._clear = 0  # consecutive clear evaluations
        self._last_eval: Optional[float] = None
        self._snap: Optional[Dict] = None
        if metrics is not None:
            metrics.gauge_set("slo.p99.target_ms", self.target_p99_ms)
            metrics.gauge_set("slo.window_us", round(self.window_s * 1e6, 1))
            metrics.gauge_set("slo.ladder.rung", self.rung)

    # -- control loop -------------------------------------------------------
    def tick(
        self,
        backlog: int = 0,
        breaker_open: bool = False,
        now: Optional[float] = None,
    ) -> float:
        """One flusher-cycle look: returns the window (seconds) to use
        for THIS cycle. Internally rate-limited to `eval_interval_s` —
        calling it every loop iteration is the intended shape."""
        now = self.clock() if now is None else now
        if breaker_open and self.rung < RUNG_WIDEN:
            # degrade-ladder integration: an open breaker widens the
            # window BEFORE anything sheds — the CPU fallback wants deep
            # batches, and slowed intake is backpressure without loss
            self._set_rung(RUNG_WIDEN, "breaker_open")
            self._widen()
        if self._last_eval is None:
            self._last_eval = now
            self._snap = self._snapshot()
            return self.window_s
        if now - self._last_eval < self.eval_interval_s:
            return self.window_s
        self._last_eval = now
        cur = self._snapshot()
        p99_s, n = delta_percentile(self._snap, cur, 0.99)
        self._snap = cur
        p99_ms = p99_s * 1e3
        self.last_p99_ms = p99_ms if n else None
        self.last_samples = n
        m = self.metrics
        if m is not None:
            m.inc("slo.eval.windows")
            if n:
                m.gauge_set("slo.p99.observed_ms", round(p99_ms, 3))
        overloaded = self.olp is not None and self.olp.is_overloaded()
        if n < self.min_samples and not (overloaded or breaker_open):
            # too little settled traffic to judge the tail: relax toward
            # immediate launches (a lone publisher must not pay a storm-
            # deep window) and walk the ladder back down
            self._relax(idle=backlog == 0)
        elif (n >= self.min_samples and p99_ms > self.target_p99_ms) or (
            overloaded or breaker_open
        ):
            if n >= self.min_samples and p99_ms > self.target_p99_ms:
                reason = "p99_miss"
            elif breaker_open:
                reason = "breaker_open"
            else:
                reason = "olp_overload"
            self._violation(reason)
        elif p99_ms <= self.target_p99_ms * self.hysteresis:
            self._cleared()
        # else: inside the hysteresis band — hold everything (the
        # no-oscillation guarantee between flush cycles)
        if m is not None:
            m.gauge_set("slo.window_us", round(self.window_s * 1e6, 1))
        return self.window_s

    def _snapshot(self) -> Optional[Dict]:
        if self.metrics is None:
            return None
        h = self.metrics.histogram(self.series)
        return h.snapshot() if h is not None else None

    def _violation(self, reason: str) -> None:
        self._viol += 1
        self._clear = 0
        if self.metrics is not None:
            self.metrics.inc("slo.violations")
        if self.rung == RUNG_NORMAL:
            self._set_rung(RUNG_WIDEN, reason)
        elif self._viol >= self.ladder_patience and self.rung < RUNG_SHED:
            self._set_rung(self.rung + 1, reason)
            self._viol = 0
        self._widen()

    def _cleared(self) -> None:
        self._clear += 1
        self._viol = 0
        if self._clear >= self.ladder_patience:
            self._clear = 0
            if self.rung > RUNG_NORMAL:
                self._set_rung(self.rung - 1, "recovered")
        self._narrow()

    def _relax(self, idle: bool) -> None:
        if idle:
            self._set_window(self.min_window_s)
        else:
            self._narrow()
        self._viol = 0
        self._clear += 1
        if self._clear >= self.ladder_patience and self.rung > RUNG_NORMAL:
            self._clear = 0
            self._set_rung(self.rung - 1, "drained")

    def _widen(self) -> None:
        base = self.window_s if self.window_s > 0 else max(
            self.min_window_s, 1e-4
        )
        self._set_window(min(self.max_window_s, base * (1.0 + self.gain)))

    def _narrow(self) -> None:
        self._set_window(
            max(self.min_window_s, self.window_s * (1.0 - self.gain))
        )

    def _set_window(self, w: float) -> None:
        if abs(w - self.window_s) < 1e-9:
            return
        self.window_s = w
        if self.metrics is not None:
            self.metrics.inc("slo.adjustments")

    def _set_rung(self, rung: int, reason: str) -> None:
        old, self.rung = self.rung, rung
        if old == rung:
            return
        self._viol = 0
        self._clear = 0
        log.warning(
            "slo ladder: %s -> %s (%s)",
            RUNG_NAMES[old], RUNG_NAMES[rung], reason,
        )
        if self.metrics is not None:
            self.metrics.gauge_set("slo.ladder.rung", rung)
        rec = self.spans
        if rec is not None:
            # the causal record of WHY subsequent batches deepened,
            # deferred, or shed (sibling of degrade.transition)
            sp = rec.start(
                "slo.transition",
                attrs={
                    "from": RUNG_NAMES[old],
                    "to": RUNG_NAMES[rung],
                    "reason": reason,
                },
            )
            rec.finish(sp)

    # -- ladder queries (BatchIngest / RetainedStormFeed) -------------------
    def defer_low(self, head_age_s: float) -> bool:
        """Should the low-priority lane sit this launch out? True on the
        `defer` rung and above — but never past `defer_max_s`, the
        anti-starvation bound (deferred is delayed, not dropped)."""
        return self.rung >= RUNG_DEFER and head_age_s < self.defer_max_s

    def shed(self, lane: int, backlog: int, bound: int) -> bool:
        """Graded admission (the last rung). Control traffic NEVER
        sheds; low sheds at the queue bound on the `shed` rung, normal
        only at twice the bound; `shed_hard_mult * bound` is the
        absolute safety valve at any rung (a wedged flusher must not
        queue unbounded)."""
        if lane == LANE_CONTROL:
            return False
        if backlog >= bound * self.shed_hard_mult:
            return True
        if self.rung < RUNG_SHED:
            return False
        return backlog >= (bound if lane == LANE_LOW else 2 * bound)

    # -- observability ------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "window_us": round(self.window_s * 1e6, 1),
            "min_window_us": round(self.min_window_s * 1e6, 1),
            "max_window_us": round(self.max_window_s * 1e6, 1),
            "target_p99_ms": self.target_p99_ms,
            "observed_p99_ms": (
                round(self.last_p99_ms, 3)
                if self.last_p99_ms is not None
                else None
            ),
            "observed_samples": self.last_samples,
            "rung": self.rung,
            "rung_name": RUNG_NAMES[self.rung],
        }


__all__: List[str] = [
    "LANE_CONTROL",
    "LANE_NORMAL",
    "LANE_LOW",
    "LANE_NAMES",
    "RUNG_NORMAL",
    "RUNG_WIDEN",
    "RUNG_DEFER",
    "RUNG_SHED",
    "RUNG_NAMES",
    "SloController",
    "delta_percentile",
]
