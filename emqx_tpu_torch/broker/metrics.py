"""Broker metrics: counters, gauges and fixed-bucket histograms.

The port's copy of `emqx_tpu/broker/metrics.py`, trimmed to what the
port's broker, `BatchIngest`, `SloController`, `Router`, `TpuMatcher` and
`DeviceRouter` call: `inc`, `get`, `gauge_set`, `observe`, `observe_many`
and `histogram`, and `Histogram` with its percentiles and `snapshot` (the
SLO controller's windowed p99 reads it). The registry declares
only the histograms these callers record, because a histogram's buckets
come from its declaration: `dispatch.fanout` keeps the reference's
`FANOUT_BUCKETS`, whose p99 sizes the compact-slot cap (`DeviceRouter.
_fanout_kslot`), so both packages pick the same kslot for the same
traffic. Undeclared histograms take `LATENCY_BUCKETS`, as in the
reference; counters and gauges need no declaration here (the reference's
registry also feeds its exporters and a lint, neither of which is ported).
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# shared bucket ladders (upper bounds; +Inf is implicit)
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
SIZE_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
)
RATIO_BUCKETS: Tuple[float, ...] = (
    0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0,
)
FANOUT_BUCKETS: Tuple[float, ...] = (
    0, 1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096,
)

# histogram name -> its bucket bounds (the reference's declarations)
HISTOGRAM_BUCKETS: Dict[str, Tuple[float, ...]] = {
    "dispatch.fanout": FANOUT_BUCKETS,
    "ingest.batch.size": SIZE_BUCKETS,
    "ingest.batch.occupancy": RATIO_BUCKETS,
    "matcher.batch.size": SIZE_BUCKETS,
    "matcher.device.seconds": LATENCY_BUCKETS,
    "matcher.sync.seconds": LATENCY_BUCKETS,
}


class Histogram:
    """Fixed-bucket histogram: counts per upper bound, sum and count;
    percentiles interpolate linearly inside the landing bucket. Lock-safe."""

    __slots__ = ("bounds", "_counts", "sum", "count", "_lock")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Batch observe under one lock acquisition."""
        if not len(values):
            return
        idxs = [bisect.bisect_left(self.bounds, v) for v in values]
        with self._lock:
            for i in idxs:
                self._counts[i] += 1
            self.sum += float(sum(values))
            self.count += len(values)

    def percentile(self, q: float) -> float:
        """q in [0, 1]. 0.0 when empty; the last finite bound when the
        quantile lands in the +Inf overflow bucket."""
        with self._lock:
            counts = list(self._counts)
            total = self.count
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(self.bounds):  # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - prev_cum) / c if c else 1.0
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    def snapshot(self) -> Dict:
        """-> {"count", "sum", "buckets": [(le, cumulative_count), ...]}
        with a final (inf, count) entry — exactly the exposition shape."""
        with self._lock:
            counts = list(self._counts)
            total = self.count
            s = self.sum
        out: List[Tuple[float, int]] = []
        cum = 0
        for le, c in zip(self.bounds, counts):
            cum += c
            out.append((le, cum))
        out.append((float("inf"), total))
        return {"count": total, "sum": s, "buckets": out}


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}  # guarded-by: _lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def get(self, name: str) -> int:
        return self._counters.get(name, 0)

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def _histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = self._histograms[name] = Histogram(
                        HISTOGRAM_BUCKETS.get(name, LATENCY_BUCKETS))
        return h

    def observe(self, name: str, value: float) -> None:
        self._histogram(name).observe(value)

    def observe_many(self, name: str, values: Sequence[float]) -> None:
        self._histogram(name).observe_many(values)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._histograms.get(name)


default_metrics = Metrics()
