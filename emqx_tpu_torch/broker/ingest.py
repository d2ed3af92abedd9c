"""Ingest-side publish batch aggregation (SLO-adaptive batch window).

The port's copy of `BatchIngest` (emqx_tpu/broker/ingest.py:71), whole:
the priority lanes with their anti-starvation reserve, the window, the
`pipeline` of launched-but-unsettled dispatches with its FIFO settle,
`stop()`'s drain, the SLO controller's hooks and the flight-recorder
metrics. It drives the port's `Broker.adispatch_begin`, so a batch's
`prepare()` runs on the event loop's thread and its kernel launches and
readback on the broker's dispatch pool (`broker.dispatch_pool`).

Concurrent publishes from all connections collect into priority lanes,
flushed when either `max_batch` messages are pending or the window has
elapsed since the flusher woke — so a lone publisher pays at most one
window of added latency while a firehose fills batches immediately and
never sleeps. With an `SloController` attached (broker/slo.py) the window
adapts each flush cycle to hold an enqueue->settle p99 target and walks
the graded backpressure ladder (widen -> defer low lanes -> shed).

Priority lanes: `control` (QoS2 control flow, $SYS) > `normal` (QoS1) >
`low` (QoS0 firehose when `qos0_low`, explicitly tagged messages). The
flusher assembles batches in lane order with an anti-starvation reserve.

Up to `pipeline` dispatches are in flight at once: batch N+1's prepare,
encode and launch overlap batch N's readback and host fan-out, while
settlement (delivery and the publishers' futures) stays strictly FIFO.

On a broker whose mesh (`Broker.mesh`) has more than one rank, `start()`
raises `NotImplementedError`: the ranks must agree on each batch's
messages, and feeding them the same publishes is the multi-rank app's
part (ROADMAP item 10.3b). On a one-rank mesh it runs as on one device.

The `ingest.enqueue` fault site (observe/faults.py) sits at the top of
`enqueue`: ``raise`` fails the publisher's call, ``drop`` sheds the
enqueue. With the broker's `DegradeController` attached, the shed gate
reads its bound and its device breaker. The span recorder's batch and
publish spans come with the host observability (ROADMAP item 10.3c): no
spans here.

Flight recorder: batch size and occupancy, window hold time, pipeline
depth, per-message and per-lane enqueue->settle latency, lane depths,
the device's idle gaps, and launch/dispatch failures land in the
broker's metrics, and `ingest.launch`/`ingest.settle` tracepoints keyed
by batch seq (utils/tracepoints.py) let tests assert the schedule.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import List, Optional, Tuple

from emqx_tpu_torch.broker.degrade import OPEN, IngestShed
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.metrics import Metrics
from emqx_tpu_torch.broker.slo import LANE_CONTROL, LANE_LOW, LANE_NAMES, LANE_NORMAL
from emqx_tpu_torch.observe import faults as _faults
from emqx_tpu_torch.utils.tracepoints import tp

log = logging.getLogger("emqx_tpu_torch.ingest")

LANE_DEPTH_SERIES = tuple(f"ingest.lane.depth.{n}" for n in LANE_NAMES)
LANE_SETTLE_SERIES = tuple(
    f"ingest.lane.settle.seconds.{n}" for n in LANE_NAMES
)


class BatchIngest:
    def __init__(
        self,
        broker,
        max_batch: int = 4096,
        window_us: int = 1000,
        pipeline: int = 2,
        olp=None,
        slo=None,
        qos0_low: bool = False,
    ):
        self.broker = broker
        self.max_batch = max_batch
        self.window_s = window_us / 1e6
        # overload-protection signal: with the broker's DegradeController
        # attached (and no SLO controller), enqueues shed once the pending
        # backlog passes the shed bound while olp.is_overloaded() holds or
        # the device breaker is open. With an SloController the graded
        # ladder owns admission instead (shed is the LAST rung).
        self.olp = olp
        # SLO-adaptive batching (broker/slo.py): adapts window_s each
        # flush cycle + owns the defer/shed ladder. None = fixed window.
        self.slo = slo
        # lane policy: route QoS0 publishes to the low-priority lane
        self.qos0_low = qos0_low
        # device dispatches in flight at once: batch N+1's table sync,
        # encode and launch overlap batch N's readback and host fan-out.
        # Settlement stays strictly FIFO so per-publisher delivery order
        # holds across batches.
        self.pipeline = max(1, pipeline)
        self.metrics: Metrics = getattr(broker, "metrics", None) or Metrics()
        # per-lane pending lists of (msg, puback future, enqueue
        # perf_counter timestamp, lane). `_pending` is the NORMAL lane's
        # list (the reference's name).
        self._lane_hi: List[Tuple] = []
        self._pending: List[Tuple] = []
        self._lane_lo: List[Tuple] = []
        self._inflight: deque = deque()  # (seq, batch, pending dispatch)
        self._event = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._seq = 0
        # anti-starvation bound for the low lane under sustained
        # control/normal pressure (SloController overrides from config)
        self.starvation_s = slo.starvation_s if slo is not None else 0.05
        # perf_counter stamp of the moment the LAST in-flight dispatch's
        # device work completed (None = device busy or never launched);
        # the gap until the next launch is the ingest.device.idle series
        self._device_done_t: Optional[float] = None
        self.running = False

    def start(self) -> None:
        """Start the flusher. Refused on a broker whose mesh has more than
        one rank: the ranks would each cut their own batches (by the
        timer and the lanes' depths), and a mesh batch needs every rank to
        route the same messages in the same order."""
        mesh = getattr(self.broker, "mesh", None)
        if mesh is not None and mesh.world > 1:
            raise NotImplementedError(
                f"BatchIngest on a {mesh.world}-rank mesh: the ranks must agree "
                "on each batch's messages before it launches, and how "
                "publishes reach the ranks is ROADMAP item 10.3b (the app on "
                "a multi-rank mesh)")
        if self._task is None:
            self.running = True
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self.running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # drain launched-but-unsettled batches first (FIFO), then
        # anything still pending (defer gates ignored: shutdown delivers
        # everything), so no publisher hangs on shutdown
        while self._inflight:
            seq, batch, pd = self._inflight.popleft()
            await self._finish(seq, batch, pd.complete())
        while self._backlog():
            batch = self._take_batch(time.perf_counter(), force=True)
            await self._settle(batch)

    # -- lanes --------------------------------------------------------------
    def _backlog(self) -> int:
        return len(self._lane_hi) + len(self._pending) + len(self._lane_lo)

    def lane_of(self, msg: Message) -> int:
        """Priority-lane classification: QoS2 control flow and $SYS ride
        the control lane; QoS0 rides low when the lane policy is armed;
        explicit `ingest_lane` headers win."""
        ln = msg.headers.get("ingest_lane")
        if ln == "control":
            return LANE_CONTROL
        if ln == "low":
            return LANE_LOW
        if msg.qos == 2 or msg.is_sys():
            return LANE_CONTROL
        if msg.qos == 0 and self.qos0_low:
            return LANE_LOW
        return LANE_NORMAL

    def _lane_list(self, lane: int) -> List[Tuple]:
        if lane == LANE_CONTROL:
            return self._lane_hi
        if lane == LANE_LOW:
            return self._lane_lo
        return self._pending

    def enqueue(self, msg: Message, lane: Optional[int] = None) -> asyncio.Future:
        """Enqueue one folded message; the future resolves with its
        delivery count when the batch flushes.

        Admission: with an SloController attached, the graded ladder
        decides — control never sheds, low sheds at the queue bound on the
        `shed` rung, normal at twice the bound, and `shed_hard_mult` x
        bound is the absolute valve. Without a controller the binary gate
        holds: while the broker is overloaded (olp) or the device breaker
        is open, a backlog past the shed bound refuses new enqueues with
        `IngestShed` on the returned future. Both need the broker's
        `degrade` controller (its shed bound); without one every enqueue
        is admitted, except the ones the ``ingest.enqueue`` fault site
        drops (``raise`` there fails the caller)."""
        act = _faults.hit("ingest.enqueue")  # raise -> the publisher's task
        fut = asyncio.get_running_loop().create_future()
        if lane is None:
            lane = self.lane_of(msg)
        shed = act == "drop"
        deg = getattr(self.broker, "degrade", None)
        if not shed and deg is not None:
            bound = deg.shed_queue_batches * self.max_batch
            if self.slo is not None:
                if self.slo.shed(lane, self._backlog(), bound):
                    shed = True
                    self.metrics.inc("slo.shed")
            elif (
                len(self._pending) >= bound
                and (
                    (self.olp is not None and self.olp.is_overloaded())
                    or deg.device.state == OPEN
                )
            ):
                shed = True
        if shed:
            self.metrics.inc("ingest.shed")
            fut.set_exception(
                IngestShed("ingest backlog shed (overload/degraded)")
            )
            return fut
        self._lane_list(lane).append((msg, fut, time.perf_counter(), lane))
        self._event.set()
        return fut

    async def submit(self, msg: Message) -> int:
        return await self.enqueue(msg)

    def _take_batch(self, now: float, force: bool = False) -> List[Tuple]:
        """Assemble up to max_batch in lane-priority order. The low lane
        joins unless the SLO ladder defers it (never past its defer age
        bound); a starvation reserve guarantees the low lane slots once
        its head has waited `starvation_s` behind full priority lanes.
        `force` (shutdown drain) ignores the defer gate."""
        cap = self.max_batch
        batch: List[Tuple] = []
        hi, no, lo = self._lane_hi, self._pending, self._lane_lo
        if hi:
            take = hi[:cap]
            del hi[: len(take)]
            batch.extend(take)
        room = cap - len(batch)
        if room > 0 and no:
            # anti-starvation reserve: when the low lane's head already
            # waited past the bound, hold slots open so a saturated
            # normal lane cannot push it out forever
            reserve = 0
            if lo and len(no) >= room and (now - lo[0][2]) >= self.starvation_s:
                reserve = max(1, cap // 16)
                self.metrics.inc("ingest.lane.starvation.breaks")
            n_take = min(len(no), max(0, room - reserve))
            if n_take:
                batch.extend(no[:n_take])
                del no[:n_take]
            room = cap - len(batch)
        if room > 0 and lo:
            slo = self.slo
            if (
                not force
                and slo is not None
                and slo.defer_low(now - lo[0][2])
            ):
                # `defer` rung: the low lane sits this launch out so the
                # storm drains control/normal first (delayed, not lost)
                self.metrics.inc("slo.deferrals")
            else:
                take = lo[:room]
                del lo[: len(take)]
                batch.extend(take)
        return batch

    async def _settle(self, batch) -> None:
        seq = self._next_seq(batch)
        await self._finish(
            seq, batch,
            self.broker.adispatch_begin([m for m, _, _, _ in batch]),
        )

    def _next_seq(self, batch) -> int:
        """Assign the batch seq + record launch-side telemetry."""
        n = len(batch)
        seq = self._seq
        self._seq += 1
        self.metrics.observe("ingest.batch.size", n)
        self.metrics.observe("ingest.batch.occupancy", n / self.max_batch)
        # waterfall `queue_wait`: per-message enqueue -> launch wait
        # (window accumulation + lane queueing)
        now = time.perf_counter()
        self.metrics.observe_many(
            "profile.stage.queue_wait.seconds",
            [now - t0 for _, _, t0, _ in batch],
        )
        tp("ingest.launch", batch=seq, n=n)
        return seq

    async def _finish(self, seq: int, batch, aw) -> None:
        try:
            results = await aw
        except Exception as e:  # noqa: BLE001 — flusher must survive
            log.exception("batch dispatch failed; failing %d publishes", len(batch))
            self.metrics.inc("ingest.dispatch.errors")
            for _m, fut, _, _ in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        now = time.perf_counter()
        lane_lats: List[List[float]] = [[], [], []]
        for (_m, fut, t0, lane), n in zip(batch, results):
            if not fut.done():
                fut.set_result(n)
            lane_lats[lane].append(now - t0)
        self.metrics.observe_many(
            "ingest.settle.seconds", [now - t0 for _, _, t0, _ in batch]
        )
        for lane, lats in enumerate(lane_lats):
            if lats:
                # per-lane tails: the control lane stays bounded while
                # the low lane storms
                self.metrics.observe_many(LANE_SETTLE_SERIES[lane], lats)
        tp("ingest.settle", batch=seq, n=len(batch))

    def _engage_threshold(self) -> int:
        # below this pending count the device path won't engage anyway
        # (broker.dispatch_batch_folded falls back per-message), so waiting
        # a window would tax latency for zero batching gain
        return max(2, self.broker.router.min_tpu_batch)

    def _device_idle(self) -> bool:
        """Every in-flight dispatch's DEVICE work is done (their host
        fan-out may still be queued behind the FIFO settle)."""
        return all(pd.ready.done() for _, _, pd in self._inflight)

    def _note_device_done(self, _fut=None) -> None:
        # done-callback on each launch's `ready`: stamp the moment the
        # pipeline's device side drained (idle-gap accounting)
        if self._device_idle():
            self._device_done_t = time.perf_counter()

    async def _run(self) -> None:
        while True:
            slo = self.slo
            if slo is not None:
                deg = getattr(self.broker, "degrade", None)
                self.window_s = slo.tick(
                    backlog=self._backlog(),
                    breaker_open=(
                        deg is not None and deg.device.state == OPEN
                    ),
                )
            if not self._inflight and not self._backlog():
                await self._event.wait()
            # one loop tick: every connection task that is ready to publish
            # gets to enqueue before we decide whether a window is worth it
            await asyncio.sleep(0)
            backlog = self._backlog()
            if (
                self.window_s > 0
                and not self._inflight
                and backlog >= self._engage_threshold()
                and backlog < self.max_batch
            ):
                # real concurrency: hold the window open to fill the batch
                t0 = time.perf_counter()
                await asyncio.sleep(self.window_s)
                self.metrics.observe(
                    "ingest.window.wait.seconds", time.perf_counter() - t0
                )
            # Launch rules. While a dispatch's DEVICE work is in flight,
            # only a FULL batch may launch (eagerly draining small batches
            # would multiply device round-trips). The moment every
            # in-flight dispatch's device work is DONE, a PARTIAL batch
            # launches too: batch N's host fan-out has not run yet (FIFO
            # settle below), so the partial overlaps it with device work.
            batch: List = []
            if (
                not self._inflight
                or self._backlog() >= self.max_batch
                or (
                    self._backlog()
                    and len(self._inflight) < self.pipeline
                    and self._device_idle()
                )
            ):
                batch = self._take_batch(time.perf_counter())
            if batch:
                for lane, series in enumerate(LANE_DEPTH_SERIES):
                    self.metrics.gauge_set(
                        series, len(self._lane_list(lane))
                    )
                if self._device_done_t is not None:
                    self.metrics.observe(
                        "ingest.device.idle.seconds",
                        time.perf_counter() - self._device_done_t,
                    )
                    self._device_done_t = None
                # LAUNCH now (prepare + executor submit), settle later: a
                # full next batch's launch overlaps this one's round trip.
                # Fan-out happens ONLY at settle (pd.complete()), in FIFO
                # order; pd.ready is the side-effect-free pacing signal.
                seq = self._next_seq(batch)
                try:
                    pd = self.broker.adispatch_begin(
                        [m for m, _, _, _ in batch]
                    )
                except Exception as e:  # noqa: BLE001 — flusher survives
                    log.exception("batch launch failed")
                    self.metrics.inc("ingest.launch.errors")
                    for _m, fut, _, _ in batch:
                        if not fut.done():
                            fut.set_exception(e)
                else:
                    self._inflight.append((seq, batch, pd))
                    self._device_done_t = None
                    pd.ready.add_done_callback(self._note_device_done)
                    self.metrics.gauge_set(
                        "ingest.pipeline.depth", len(self._inflight)
                    )
            if not self._inflight:
                if not self._backlog():
                    self._event.clear()
                elif not batch:
                    # everything pending is lane-deferred: nothing is
                    # launchable until the defer age bound releases it —
                    # bounded poll, never a busy spin
                    await asyncio.sleep(max(self.window_s, 0.001))
                continue
            if len(self._inflight) >= self.pipeline:
                seq, b, pd = self._inflight.popleft()
                await self._finish(seq, b, pd.complete())
            elif not batch or not self._backlog():
                # dispatch in flight, nothing launchable: settle when the
                # device work completes OR re-check the moment new
                # publishes arrive (they may fill a full batch). The event
                # is cleared first so only NEW enqueues wake us.
                self._event.clear()
                oldest_ready = self._inflight[0][2].ready
                ev = asyncio.ensure_future(self._event.wait())
                try:
                    await asyncio.wait(
                        {oldest_ready, ev},
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                finally:
                    if not ev.done():
                        # retrieve the cancellation, or the loop logs "Task
                        # was destroyed but it is pending" for every
                        # launch-in-flight/new-enqueue race;
                        # gather(return_exceptions) swallows EV's
                        # CancelledError but still re-raises this task's
                        # own cancellation (stop() must not hang)
                        ev.cancel()
                        await asyncio.gather(ev, return_exceptions=True)
                if oldest_ready.done():
                    if (
                        self._backlog()
                        and len(self._inflight) < self.pipeline
                        and self._device_idle()
                    ):
                        # device idle + launchable backlog: loop back so
                        # the partial LAUNCHES before this settle's host
                        # fan-out runs
                        continue
                    seq, b, pd = self._inflight.popleft()
                    await self._finish(seq, b, pd.complete())
