"""Overload protection (reference: apps/emqx/src/emqx_olp.erl + the `lc`
dependency's load_ctl, SURVEY.md §2.1).

The reference gates expensive work on `load_ctl:is_overloaded()` (BEAM
runqueue pressure) and backs off GC/hibernation/new connections. The
asyncio analog of runqueue pressure is event-loop lag: a sampler task
measures how late its own timer fires; sustained lag above the watermark
flips `is_overloaded()`, and the listener refuses new connections while it
holds (priority_connection semantics). The ingest gate additionally sheds
enqueues while overloaded (broker/ingest.py, docs/robustness.md).

The sampler is supervised: a raising sampler task restarts (with its
exception logged) instead of silently dying and leaving the broker
permanently blind to overload — `asyncio.ensure_future` alone would
swallow the traceback into a never-awaited task.

The port's copy of `emqx_tpu/broker/olp.py`, its code unchanged.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

log = logging.getLogger("emqx_tpu_torch.olp")


class Olp:
    def __init__(
        self,
        enable: bool = True,
        lag_watermark_ms: float = 500.0,
        sample_interval: float = 0.1,
        cooldown: float = 5.0,
        metrics=None,
    ):
        self.enable = enable
        self.lag_watermark_ms = lag_watermark_ms
        self.sample_interval = sample_interval
        self.cooldown = cooldown
        self.metrics = metrics
        self.last_lag_ms = 0.0
        self._overloaded_until = 0.0
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        # stats for $SYS / REST
        self.trip_count = 0

    def is_overloaded(self) -> bool:
        return self.enable and time.monotonic() < self._overloaded_until

    def pressure(self) -> float:
        """Graded overload signal: last sampled loop lag as a fraction
        of the watermark (1.0 = at the trip point). The SLO controller
        and the hotpath REST read this — `is_overloaded()` is the binary
        trip, this is the dial behind it."""
        if not self.enable or self.lag_watermark_ms <= 0:
            return 0.0
        return self.last_lag_ms / self.lag_watermark_ms

    def note_lag(self, lag_ms: float) -> None:
        self.last_lag_ms = lag_ms
        if self.metrics is not None:
            self.metrics.gauge_set("olp.lag_ms", lag_ms)
        if lag_ms > self.lag_watermark_ms:
            if not self.is_overloaded():
                self.trip_count += 1
                if self.metrics is not None:
                    self.metrics.inc("olp.trips")
            self._overloaded_until = time.monotonic() + self.cooldown

    async def _sampler(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.sample_interval)
            lag_ms = (time.monotonic() - t0 - self.sample_interval) * 1000.0
            self.note_lag(max(0.0, lag_ms))

    def _spawn(self) -> None:
        self._task = asyncio.ensure_future(self._sampler())
        self._task.add_done_callback(self._on_sampler_done)

    def _on_sampler_done(self, task: asyncio.Task) -> None:
        """The sampler must outlive its own bugs: a task that died to an
        exception logs it and respawns; cancellation (stop()) does not."""
        if task.cancelled() or self._stopping:
            return
        exc = task.exception()
        if exc is None:
            return  # _sampler never returns normally; defensive
        log.error("olp sampler died: %r; restarting", exc)
        self._task = None
        try:
            self._spawn()
        except RuntimeError:
            # loop already closed (shutdown race): stay down
            self._task = None

    def start(self) -> None:
        if self.enable and self._task is None:
            self._stopping = False
            self._spawn()

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
