"""Retained-replay storm feed: wildcard SUBSCRIBEs ride the serving launch.
The port's copy of `RetainedStormFeed` (emqx_tpu/broker/retained_feed.py
:39).

A wildcard SUBSCRIBE against a big retained store would pay its own launch
train (one storm launch per stored chunk, models/retained_index.py) per
subscriber, on the hook path. The feed turns a subscribe storm into ONE
device pass that rides the publish pipeline:

- concurrent replay requests aggregate here (the subscribe-side analog of
  `BatchIngest`'s publish window);
- when the broker launches a device batch (`Broker.adispatch_begin`), it
  calls `take_job()` on the loop thread and the pending filters fuse into
  that batch's `route_prepared(..., retained=job)`: every chunk's storm
  launches join the batch's launches and its one device->host copy;
- when no publish launch shows up inside the window (a quiet broker, a
  pure subscribe storm), the flush timer answers every pending filter
  with one standalone pass: the storm's filter tables and the chunk sync
  on the loop thread (`DeviceRetainedIndex.storm_job`, which must run on the
  thread that mutates the index), the launches, the readback and the
  decode on `dispatch_pool()` on the loop's stream (`run_storm`), so
  still one launch train for the whole storm. The reference runs the
  whole `match_many`, chunk sync included, on the pool thread.

Waiters receive the matched retained TOPICS (already row-resolved), or
None: the CPU-fallback signal (an unfusable storm, a failed prepare or
launch, a failed flush), on which the Retainer walks its own trie. Rows
become topics on the loop thread, after the device pass: a row deleted
since the storm's chunk sync reads as no topic, and once a freed row has
taken a new topic since (`DeviceRetainedIndex.changed_since`), every
topic is checked against its filter (`_topics`), so a replay never
carries a topic its filter does not match. The Retainer re-fetches each
message from its authoritative store.

A `KernelBuildError` is never answered with the fallback signal: it is
set on the waiters' futures (and raised out of `take_job` and the flush),
so a kernel library that will not build is not served from the CPU.

Counters: `retained.storm.filters` (submits), `.fused` (storms handed to
a launch), `.flushed` (standalone passes), `.deferred` (storms the SLO
controller's `defer` rung held back), `.fallback` (storms whose waiters
got the CPU-fallback signal), `.stale` (rows dropped at resolve because
their topic changed since the chunk sync). Fault site: ``retained.storm``
in `take_job`, before the storm is prepared.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional

from emqx_tpu_torch.kernels.build import KernelBuildError
from emqx_tpu_torch.observe import faults as _faults
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.utils.tracepoints import tp

log = logging.getLogger("emqx_tpu_torch.retained_feed")


class RetainedStormFeed:
    # the feed is LOW-priority work by construction: a retained replay is
    # best-effort catch-up traffic, so under SLO backpressure it defers
    # behind live publishes (broker/slo.py)
    LANE = "low"

    def __init__(self, retained_index, metrics=None, window_s: float = 0.002):
        self.index = retained_index
        self.metrics = metrics
        self.window_s = window_s
        # SloController (broker/slo.py), attached by its owner: on the
        # `defer` rung and above, pending storms sit launches out (and the
        # standalone flush re-arms) until the defer age bound
        self.slo = None
        # filter -> [futures]; subscribers to the same filter share a lane
        self._pending: Dict[str, List[asyncio.Future]] = {}
        self._oldest_t: Optional[float] = None  # first pending submit
        self._waiters: Dict[int, Dict] = {}  # id(job) -> waiters
        self._timer = None
        self._flushing = False  # a standalone pass in flight

    def head_age(self, now: Optional[float] = None) -> float:
        """Seconds the OLDEST pending replay has waited (0 when none): the
        anti-starvation input to the SLO defer gate."""
        if self._oldest_t is None:
            return 0.0
        return (time.monotonic() if now is None else now) - self._oldest_t

    def _deferred(self) -> bool:
        return self.slo is not None and self.slo.defer_low(self.head_age())

    def __len__(self) -> int:
        return len(self._pending)

    # -- subscribe side ----------------------------------------------------
    def submit(self, filter_: str) -> asyncio.Future:
        """Queue one replay; resolves with the matched retained topic list,
        or None (callers fall back to the CPU walk)."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if not self._pending:
            self._oldest_t = time.monotonic()
        self._pending.setdefault(filter_, []).append(fut)
        if self.metrics is not None:
            self.metrics.inc("retained.storm.filters")
        if self._timer is None:
            self._timer = loop.call_later(self.window_s, self._on_window)
        return fut

    # -- serving-pipeline side --------------------------------------------
    def take_job(self):
        """Called by the broker on the loop thread right before a device
        launch: pops every pending filter into a prepared `StormJob` the
        launch fuses in, or returns None (nothing pending, the SLO defer
        rung, a standalone flush owning the pending set, or a storm that
        cannot fuse: its waiters then get the CPU-fallback signal now)."""
        if not self._pending or self._flushing:
            return None
        if self._deferred():
            # SLO `defer` rung: this launch carries live traffic only; the
            # storm rides a later one (or the age bound forces it through)
            if self.metrics is not None:
                self.metrics.inc("retained.storm.deferred")
            return None
        filters = list(self._pending)
        job = None
        build_error = None
        try:
            _faults.hit("retained.storm")
            job = self.index.prepare_storm(filters)
        except KernelBuildError as e:
            build_error = e
        except Exception:  # noqa: BLE001 — never poison the launch
            log.exception("storm prepare failed; falling back to CPU")
        waiters, self._pending = self._pending, {}
        self._oldest_t = None
        self._cancel_timer()
        if build_error is not None:
            self._answer(waiters, error=build_error)
            raise build_error
        if job is None:
            # not fusable (empty index / over-budget filter / failed
            # prepare): answer the waiters with the CPU-fallback signal
            self._answer(waiters)
            return None
        self._waiters[id(job)] = waiters
        if self.metrics is not None:
            self.metrics.inc("retained.storm.fused")
        tp("retained.storm.fused", filters=len(filters))
        return job

    def attach(self, job, fut) -> None:
        """Fail the storm's waiters over to the CPU walk if the fused launch
        itself dies: `resolve` only runs when the batch settles well."""

        def _done(f):
            exc = f.exception() if not f.cancelled() else None
            if exc is not None or f.cancelled():
                self.fail(job, exc)

        fut.add_done_callback(_done)

    def _topics(self, f: str, rows, check: bool) -> List[str]:
        """Rows -> the topics they hold now (loop thread). A row freed
        since the chunk sync holds no topic; with `check` (a freed row
        took a new topic since) each topic is kept only if it matches."""
        topic_at = self.index.topic_at
        out = [t for t in (topic_at(int(r)) for r in rows) if t is not None]
        if not check:
            return out
        kept = [t for t in out if T.match(t, f)]
        if len(kept) < len(out) and self.metrics is not None:
            self.metrics.inc("retained.storm.stale", len(out) - len(kept))
        return kept

    def _answer(self, waiters, matched: Optional[Dict] = None, error=None,
                job=None) -> None:
        """Resolve every waiter: with its filter's topics from `matched`
        (decoded from `job`), with `error` set on its future, or (neither)
        with None, the CPU-fallback signal, counted in
        `retained.storm.fallback`."""
        if error is None and matched is None and waiters and self.metrics is not None:
            self.metrics.inc("retained.storm.fallback")
        check = job is not None and self.index.changed_since(job)
        for f, futs in waiters.items():
            topics = None
            if error is None and matched is not None:
                topics = self._topics(f, matched.get(f, ()), check)
            for fut in futs:
                if fut.done():
                    continue
                if error is not None:
                    fut.set_exception(error)
                else:
                    fut.set_result(topics)

    def resolve(self, job, matched: Optional[Dict]) -> None:
        """Hand the decoded {filter: row-index array} to the waiters (loop
        thread, at batch settle): rows become topics here, the index's row
        table being loop-thread state. A no-op for a storm already failed
        over."""
        waiters = self._waiters.pop(id(job), None)
        if waiters is not None:
            self._answer(waiters, matched, job=job)

    def fail(self, job, exc) -> None:
        """The fused launch died: None ("walk the CPU trie") to every
        waiter, since a failed device launch must not fail the SUBSCRIBE's
        replay; a `KernelBuildError` is set on the waiters instead."""
        waiters = self._waiters.pop(id(job), None)
        if waiters is None:
            return
        if isinstance(exc, KernelBuildError):
            self._answer(waiters, error=exc)
            return
        self._answer(waiters)
        if exc is not None:
            log.warning("fused retained storm failed: %r", exc)

    # -- standalone flush --------------------------------------------------
    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_window(self) -> None:
        self._timer = None
        if not self._pending or self._flushing:
            return
        if self._deferred():
            # deferred: re-arm instead of flushing; head_age bounds the wait
            if self.metrics is not None:
                self.metrics.inc("retained.storm.deferred")
            self._timer = asyncio.get_running_loop().call_later(
                self.window_s, self._on_window)
            return
        asyncio.ensure_future(self._flush())

    async def _flush(self) -> None:
        """No publish launch took the storm inside the window: answer it
        with one standalone pass (one launch train for the whole storm).
        `_flushing` parks take_job so the pending set and the chunk sync
        have exactly one owner."""
        from emqx_tpu_torch.broker.broker import dispatch_pool
        from emqx_tpu_torch.models.router_model import on_stream

        self._flushing = True
        try:
            waiters, self._pending = self._pending, {}
            self._oldest_t = None
            filters = list(waiters)
            if self.metrics is not None:
                self.metrics.inc("retained.storm.flushed")
            tp("retained.storm.flushed", filters=len(filters))
            loop = asyncio.get_running_loop()
            job = None
            try:
                # the loop thread's half: tables and chunk sync; None for an
                # empty index, which matches nothing
                job = self.index.storm_job(filters)
                matched = {}
                if job is not None:
                    matched = await loop.run_in_executor(
                        dispatch_pool(), on_stream, self.index.launch_stream(),
                        self.index.run_storm, job)
            except KernelBuildError as e:
                self._answer(waiters, error=e)
                raise
            except Exception:  # noqa: BLE001 — a replay must not hang
                log.exception("standalone storm flush failed")
                matched = None
            self._answer(waiters, matched, job=job)
        finally:
            self._flushing = False
            if self._pending and self._timer is None:
                self._timer = asyncio.get_running_loop().call_later(
                    self.window_s, self._on_window)
