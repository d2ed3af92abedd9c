"""Per-connection write-buffer congestion alarms + forced GC.

Reference: apps/emqx/src/emqx_congestion.erl (TCP send-queue congestion
alarms with a min-alarm-interval) and emqx_gc.erl (force a collection after
N delivered messages / bytes per connection). SURVEY.md §2.1.

Congestion here watches the asyncio transport's write buffer: a connection
whose peer stops reading accumulates bytes in `transport.get_write_buffer_size()`;
above `high_watermark` an alarm `conn_congestion/<clientid>` raises, and it
clears once the buffer drains below `low_watermark`.

ForcedGC is the CPython translation of emqx_gc: gen-0 collections are cheap
and bound per-connection garbage growth on busy brokers where the automatic
threshold would otherwise let cycles pile up.

The port's copy of `emqx_tpu/transport/congestion.py`, its code unchanged.
"""

from __future__ import annotations

import gc
import time


class Congestion:
    def __init__(
        self,
        alarms=None,
        high_watermark: int = 1024 * 1024,
        low_watermark: int = 64 * 1024,
        min_alarm_interval: float = 60.0,
    ):
        self.alarms = alarms
        self.high = high_watermark
        self.low = low_watermark
        self.min_alarm_interval = min_alarm_interval
        self._alarmed = False
        self._last_alarm = 0.0

    def check(self, transport, client_id: str) -> None:
        if self.alarms is None or transport is None:
            return
        try:
            size = transport.get_write_buffer_size()
        except Exception:
            return
        now = time.monotonic()
        name = f"conn_congestion/{client_id}"
        if not self._alarmed and size > self.high:
            if now - self._last_alarm >= self.min_alarm_interval:
                self.alarms.activate(
                    name,
                    {"buffer_bytes": size, "high_watermark": self.high},
                    "connection send buffer congested",
                )
                self._alarmed = True
                self._last_alarm = now
        elif self._alarmed and size < self.low:
            self.alarms.deactivate(name)
            self._alarmed = False

    def on_close(self, client_id: str) -> None:
        if self._alarmed and self.alarms is not None:
            self.alarms.deactivate(f"conn_congestion/{client_id}")
            self._alarmed = False


class ForcedGC:
    """Count-triggered gen-0 collection (emqx_gc.erl state machine)."""

    def __init__(self, count: int = 16000, bytes_: int = 16 * 1024 * 1024):
        self.count_limit = count
        self.bytes_limit = bytes_
        self._count = 0
        self._bytes = 0
        self.collections = 0

    def inc(self, msgs: int, nbytes: int) -> bool:
        """Returns True when a collection was forced."""
        if self.count_limit <= 0 and self.bytes_limit <= 0:
            return False
        self._count += msgs
        self._bytes += nbytes
        if (self.count_limit > 0 and self._count >= self.count_limit) or (
            self.bytes_limit > 0 and self._bytes >= self.bytes_limit
        ):
            self._count = 0
            self._bytes = 0
            gc.collect(0)
            self.collections += 1
            return True
        return False
