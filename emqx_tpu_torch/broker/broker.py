"""The pub/sub kernel: subscribe/unsubscribe/publish/dispatch, on the
port's device engine. The port's copy of `Broker`, `Subscriber`,
`PendingDispatch` and `dispatch_pool` (emqx_tpu/broker/broker.py): the
synchronous publish path and the pipelined one that `BatchIngest`
(broker/ingest.py) drives.

Parity with the reference kernel (apps/emqx/src/emqx_broker.erl):
- subscribe/unsubscribe maintain the subscriber registry + route table
  (emqx_broker.erl:127-160 ETS inserts + :441-454 route add)
- publish runs the 'message.publish' fold, matches routes, and dispatches
  to local subscribers (:204-215 publish, :505-530 do_dispatch)
- publish_batch routes many topics in one device step
  (`DeviceRouter.route`), then fans out from the subscriber slots and
  the device's $share picks.

- apublish / apublish_enqueue fold a publish through the async hooks and
  enqueue it on the attached `BatchIngest`, whose batches launch through
  `adispatch_begin`: the table sync (`DeviceRouter.prepare`) on the event
  loop's thread, the launches and readback (`route_prepared`) on the
  bounded `dispatch_pool`, the host fan-out only when the ingest settles
  the `PendingDispatch`, in launch order.

- with a `SessionStore` attached (`Broker.session_store`), every device
  batch of `adispatch_begin` carries the store's pending table writes and
  a requested retry/expiry sweep as a `SessionRider`
  (`SessionStore.take_rider`, on the loop thread) into `route_prepared`;
  the commit (the mirror adopted, the due rows redelivered) runs back on
  the loop, before the batch's fan-out, and a failed launch aborts the
  rider, whose writes ride the next batch.

- with a `SemanticRouting` attached (`Broker.semantic`, broker/semantic.py)
  a subscribe may carry an embedding: its slot then lives in the semantic
  table, not the subscriber table, and it delivers on topic match AND
  similarity. Every device batch carries its messages' embeddings into
  the route launch (`semantic_match`), whose winners come back as slots;
  the CPU path asks the numpy host twin (`SemanticRouting.host_route`).
- with a `RuleEngine` device-attached (`Broker.rule_hook`,
  rules/engine.py `attach_device`) both publish paths mark each message
  for settle-time firing, every device batch carries the compiled WHERE
  programs and the batch's features (`rule_masks`), and the rules fire
  when the batch settles, before its fan-out (`RuleEngine.fire_settled`:
  the readback's masks, or the numpy host ladder for a CPU batch).

- with a `RetainedStormFeed` attached (`Broker.retained_feed`,
  broker/retained_feed.py) and a router that fuses storms, the feed's
  pending wildcard-subscribe replays ride the next device batch of
  `adispatch_begin`: `take_job()` on the loop thread after `prepare()`,
  the storm into `route_prepared(..., retained=)` (then no session rider
  rides), and `resolve` at settle, before the fan-out; a failed launch
  answers the storm's waiters with the CPU-fallback signal.
- with a `DegradeController` attached (`Broker.degrade`,
  broker/degrade.py) both publish paths walk the reference's ladder: an
  open device breaker, a failed launch or readback (after the bounded
  retries on the pipelined path) or a failed `prepare()` with no good
  epoch serve the whole batch from the CPU path (`_dispatch_cpu_batch`:
  the trie and the host fan-out), counted in `degrade.fallback.batches`
  and the `dispatch.degraded` tracepoint, and move the breaker; a good
  device batch records a success (a half-open probe closes it). Without
  a controller a failed launch raises, out of `PendingDispatch.complete()`
  on the pipelined path, as in the reference. A kernel library that fails
  to build (`kernels.build.KernelBuildError`) raises either way: the
  device router loads the library when it is made, on a card, and the
  ladder re-raises the error.

Every plain subscription owns a subscriber slot in `SubscriberTable`
(dense bitmaps or CSR, as `MatcherConfig.sub_table` says); $share groups
are `GroupTable` lanes whose member the device picks. Batches smaller than
`Router.min_tpu_batch` and rows the device flags take the authoritative
CPU path.

- with `Broker.mesh` set (this process's rank of a `parallel.mesh.Mesh`,
  before the first device batch) the device router is a
  `MeshServingRouter`: each batch runs sharded, its 'dp' rows on this
  rank and the subscriber table's 'tp' shard, and every rank assembles
  the same global `RouteResult`, $share picks with the ranks' offsets
  included. The mesh is SPMD, one process a rank, so every rank holds a
  replica of the broker and must make the same subscribes and publish the
  same batches in the same order: a rank that routes a batch the others
  do not, or a batch of another length, stalls or fails their
  collectives. Every rank's fan-out delivers the whole batch; which
  rank's deliverers own the connections is the multi-rank app's part
  (ROADMAP item 10.3b). `adispatch_begin` runs a mesh router's launches
  on a one-worker pool (`mesh_dispatch_pool`), so each rank issues its
  batches' collectives in launch order. A session store on a mesh takes no rider
  (the mesh engine fuses none): its sweep is `tick(fused_path=False)`.
  On a mesh of more than one rank the broker refuses a retained feed and
  a degrade controller (`NotImplementedError`): each rank's window timer
  and breaker would be its own, a storm must ride the same batch on every
  rank, and a rank that falls back to the CPU while the others enter a
  collective stalls them. Agreeing each batch across the ranks is the
  multi-rank app's part (ROADMAP item 10.3b); a one-rank mesh runs as one
  device.

The app on one device (app.py) attaches `BatchIngest`, the
retained feed, the degrade ladder, the session store and the semantic
plane as the reference's does, and feeds the broker from MQTT channels.
Not ported yet: the cluster forward (ROADMAP item 10.3e) and span tracing
(item 10.3c); `adispatch_begin` takes the reference's path for both
absent.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from emqx_tpu_torch.broker.hooks import Hooks, default_hooks
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.metrics import Metrics
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.broker.shared_sub import SharedSub, stable_hash
from emqx_tpu_torch.kernels import build
from emqx_tpu_torch.kernels.build import KernelBuildError
from emqx_tpu_torch.models.router_model import (
    DeviceRouter,
    GroupTable,
    MeshServingRouter,
    SubscriberTable,
    on_stream,
)
from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.utils.tracepoints import tp

# deliverer: called with (msg, subopts); a raise counts as not delivered
Deliverer = Callable[[Message, pkt.SubOpts], None]


_dispatch_pool_inst = None


def dispatch_pool():
    """Process-wide executor for device route launches (one device per
    process). Bounded and dedicated, so launches never queue behind other
    blocking work on the default executor. Two workers are the double
    buffer: batch N+1's encode and launches run on the second worker while
    batch N's worker waits for its readback."""
    global _dispatch_pool_inst
    if _dispatch_pool_inst is None:
        from concurrent.futures import ThreadPoolExecutor

        _dispatch_pool_inst = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="torch-dispatch")
    return _dispatch_pool_inst


_mesh_pool_inst = None


def mesh_dispatch_pool():
    """Process-wide executor for a mesh router's launches: ONE worker, so
    the batches' `route_prepared` calls, and with them their collectives,
    run in launch order on every rank (two workers could interleave two
    batches' collectives differently on two ranks, which gloo and NCCL
    both refuse). Pipeline depth 2 still overlaps batch N + 1's prepare
    and queued launch with batch N's round trip and host fan-out."""
    global _mesh_pool_inst
    if _mesh_pool_inst is None:
        from concurrent.futures import ThreadPoolExecutor

        _mesh_pool_inst = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-mesh-dispatch")
    return _mesh_pool_inst


class Subscriber:
    __slots__ = ("sid", "deliver", "opts", "client_id", "slot", "filter", "semantic")

    def __init__(self, sid: str, client_id: str, deliver: Deliverer, opts: pkt.SubOpts):
        self.sid = sid
        self.client_id = client_id
        self.deliver = deliver
        self.opts = opts
        self.slot = -1  # subscriber-table slot (non-shared subs only)
        self.filter = ""  # the real (share-stripped) subscription filter
        # embedding-filtered: the slot lives in the semantic table, not
        # the subscriber table, and delivery needs topic AND similarity
        self.semantic = False


class PendingDispatch:
    """A launched-but-unsettled batch dispatch (`Broker.adispatch_begin`).

    `ready`: side-effect-free future resolving when the device round
    trip completes (never triggers fan-out — safe to race/poll).
    `complete()`: coroutine performing the host fan-out + returning
    per-message delivery counts; callers invoke it in launch order.
    Awaiting the object is shorthand for awaiting complete()."""

    __slots__ = ("ready", "_complete")

    def __init__(self, ready, complete):
        self.ready = ready
        self._complete = complete

    def complete(self):
        return self._complete()

    def __await__(self):
        return self._complete().__await__()


class Broker:
    def __init__(
        self,
        router: Optional[Router] = None,
        hooks: Optional[Hooks] = None,
        metrics: Optional[Metrics] = None,
    ):
        # NOT `router or Router()`: Router defines __len__, so an EMPTY
        # router is falsy and would be silently swapped for a default one
        self.router = router if router is not None else Router()
        self.hooks = hooks or default_hooks
        self.metrics = metrics or Metrics()
        # filter -> {sid -> Subscriber}
        self._subs: Dict[str, Dict[str, Subscriber]] = {}
        self.shared = SharedSub()
        # the sub_table policy: the CSR representation serves through the
        # compact readback, so fanout_compact=False pins the dense matrix
        mc = self.router.matcher_config
        self.subtab = SubscriberTable(
            mode=mc.sub_table if mc.fanout_compact else "dense")
        # running plain-subscription count (no O(N) recount per subscribe)
        self._plain_subs = 0
        # $share groups mirrored as device lane segments so the kernel
        # resolves the member pick too (emqx_shared_sub.erl:234-285)
        self.grouptab = GroupTable()
        self._slot_subs: List[Optional[Subscriber]] = []
        self._free_slots: List[int] = []
        self._device: Optional[DeviceRouter] = None  # lazy
        # RetainedStormFeed and DegradeController, attached by their owner
        # (the `retained_feed` / `degrade` properties): pending replay
        # storms ride the device batches; the device breaker and the
        # bounded retries. None = no storm rides; a failed launch raises
        self._retained_feed = None
        self._degrade = None
        # this rank of a ('dp', 'tp') mesh (parallel/mesh.py), set before
        # the first device batch: the device router is then a
        # MeshServingRouter (the SPMD contract in the module docstring)
        self._mesh = None
        # a label for this rank's slice, stamped on the mesh router's
        # span attributes (`MeshServingRouter.shard_label`)
        self.shard_label = None
        self.ingest = None  # BatchIngest, attached by its owner
        # SessionStore (broker/session_store.py), attached by its owner:
        # pending inflight writes and retry/expiry sweeps ride the device
        # batches as the fused session stage (no launch or readback of
        # their own)
        self.session_store = None
        # SemanticRouting (broker/semantic.py), attached by its owner:
        # embedding-filter subscriptions, matched inside the route launch
        # (`semantic_match`); None = no semantic stage
        self.semantic = None
        # the RuleEngine's device seam (rules/engine.py `attach_device`):
        # compiled WHERE masks run inside the route launch and fire at
        # settle; None = hook-path rules only
        self.rule_hook = None

    # -- attachments the mesh refuses -------------------------------------
    def _refuse_multirank(self, mesh, what: str) -> None:
        if mesh is not None and mesh.world > 1:
            raise NotImplementedError(
                f"{what} on a {mesh.world}-rank mesh: each rank's window timer and "
                "breaker would be its own, a storm must ride the same batch on every "
                "rank, and a rank falling back to the CPU while the others enter a "
                "collective stalls them; agreeing each batch across the ranks is "
                "ROADMAP item 10.3b (the app on a multi-rank mesh)")

    @property
    def mesh(self):
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        if self._retained_feed is not None:
            self._refuse_multirank(mesh, "Broker.retained_feed")
        if self._degrade is not None:
            self._refuse_multirank(mesh, "Broker.degrade")
        self._mesh = mesh

    @property
    def retained_feed(self):
        return self._retained_feed

    @retained_feed.setter
    def retained_feed(self, feed) -> None:
        """Refused (`NotImplementedError`) on a mesh of more than one rank."""
        if feed is not None:
            self._refuse_multirank(self._mesh, "Broker.retained_feed")
        self._retained_feed = feed

    @property
    def degrade(self):
        return self._degrade

    @degrade.setter
    def degrade(self, ctl) -> None:
        """Refused (`NotImplementedError`) on a mesh of more than one rank."""
        if ctl is not None:
            self._refuse_multirank(self._mesh, "Broker.degrade")
        self._degrade = ctl

    # -- subscribe side ---------------------------------------------------
    def subscribe(
        self,
        sid: str,
        client_id: str,
        filter_: str,
        opts: pkt.SubOpts,
        deliver: Deliverer,
        embedding=None,
        sem_threshold=None,
    ) -> None:
        """`embedding`/`sem_threshold`: an optional embedding filter; the
        subscription then delivers on topic match AND similarity, its slot
        bound into the semantic table instead of the subscriber table.
        Ignored (a plain subscribe, counted in
        `semantic.subscribe.rejected`) when no SemanticRouting is attached
        or the filter is $shared."""
        group, real = T.parse_share(filter_)
        sub = Subscriber(sid, client_id, deliver, opts)
        sub.filter = real
        if embedding is not None and (self.semantic is None or group is not None):
            # no semantic plane, or a $share filter (resolved by a group
            # pick, not by slots): degrade to a plain subscription
            self.metrics.inc("semantic.subscribe.rejected")
            embedding = None
        if group is not None:
            # one route ref per group (matched by delete on group-empty)
            if self.shared.subscribe(group, real, sub):
                self.router.add_route(self.shared.route_filter(group, real))
            fid = self.router.filter_id(real)
            if fid is not None:
                gid = self.grouptab.ensure_group(fid, real, group)
                g = self.shared.group(real, group)
                self.grouptab.set_len(gid, len(g.members) if g else 0)
        else:
            entry = self._subs.setdefault(real, {})
            prev = entry.get(sid)
            first = not entry
            entry[sid] = sub
            fid = self.router.add_route(real) if first else None
            if prev is not None:
                # re-subscribe with fresh opts: keep the slot, swap the sub
                sub.slot = prev.slot
                self._slot_subs[sub.slot] = sub
            else:
                self._plain_subs += 1
                sub.slot = self._alloc_slot(sub)
            if fid is None:
                # route already existed: resolve its id (one probe)
                fid = self.router.filter_id(real)
            if embedding is not None:
                # the slot binds into the semantic table, scoped to this
                # filter's fid (a '#' scope matches every non-$ topic)
                sub.semantic = True
                if prev is not None and not prev.semantic and fid is not None:
                    self.subtab.remove(fid, sub.slot)
                th = (self.semantic.default_threshold if sem_threshold is None
                      else float(sem_threshold))
                self.semantic.attach(sid, sub.slot, embedding, th,
                                     fid=-1 if fid is None else fid, scope=real)
            else:
                if prev is not None and prev.semantic:
                    # the re-subscribe dropped the embedding: back to the
                    # plain fan-out
                    self.semantic.detach(sub.slot)
                if (prev is None or prev.semantic) and fid is not None:
                    self.subtab.add(fid, sub.slot)
        self.metrics.gauge_set("subscriptions.count", self.subscription_count())

    def unsubscribe(self, sid: str, filter_: str) -> bool:
        group, real = T.parse_share(filter_)
        if group is not None:
            fid = self.router.filter_id(real)
            removed, empty = self.shared.unsubscribe(group, real, sid)
            if empty:
                if fid is not None:
                    self.grouptab.drop_group(fid, real, group)
                self.router.delete_route(self.shared.route_filter(group, real))
            elif removed and fid is not None:
                gid = self.grouptab.gid_of(real, group)
                g = self.shared.group(real, group)
                if gid is not None and g is not None:
                    self.grouptab.set_len(gid, len(g.members))
                    # a member leaving shifts indices: re-derive the pin
                    # from the sid so it stays on the same live member
                    self.grouptab.repin(gid, g.members.keys(), g.sticky_sid)
            return removed
        entry = self._subs.get(real)
        if not entry or sid not in entry:
            return False
        sub = entry.pop(sid)
        self._plain_subs -= 1
        if sub.slot >= 0:
            if sub.semantic and self.semantic is not None:
                self.semantic.detach(sub.slot)
            else:
                fid = self.router.filter_id(real)
                if fid is not None:
                    self.subtab.remove(fid, sub.slot)
            self._free_slot(sub.slot)
        if not entry:
            del self._subs[real]
            self.router.delete_route(real)
        self.metrics.gauge_set("subscriptions.count", self.subscription_count())
        return True

    def _alloc_slot(self, sub: Subscriber) -> int:
        if self._free_slots:
            slot = self._free_slots.pop()
            self._slot_subs[slot] = sub
            return slot
        self._slot_subs.append(sub)
        return len(self._slot_subs) - 1

    def _free_slot(self, slot: int) -> None:
        self._slot_subs[slot] = None
        self._free_slots.append(slot)

    def subscription_count(self) -> int:
        return self._plain_subs + self.shared.count()

    def subscriptions(self) -> List[Tuple[str, str, pkt.SubOpts]]:
        out = []
        for f, entry in self._subs.items():
            for sub in entry.values():
                out.append((sub.client_id, f, sub.opts))
        out.extend(self.shared.subscriptions())
        return out

    # -- publish side -----------------------------------------------------
    def publish(self, msg: Message) -> int:
        """Route + dispatch one message on the CPU; returns delivery count."""
        msg = self.hooks.run_fold("message.publish", (), msg)
        if msg is None or msg.headers.get("allow_publish") is False:
            self.metrics.inc("messages.dropped")
            return 0
        return self._dispatch_routed(msg)

    async def apublish(self, msg: Message) -> int:
        """Async `publish` for the connection path: awaits async hooks, so
        a slow extension suspends only the publishing client's task. With
        a running `BatchIngest` attached, the folded message rides the
        batch window onto the device route path."""
        r = await self.apublish_enqueue(msg)
        return r if isinstance(r, int) else await r

    async def apublish_enqueue(self, msg: Message):
        """Pipelined publish: fold + enqueue WITHOUT awaiting dispatch.

        Returns either an int (dispatched inline / dropped) or an
        asyncio.Future resolving to the delivery count when the batch
        settles, so a connection keeps parsing its next frames while
        earlier publishes ride the batch window."""
        rh = self.rule_hook
        ing = self.ingest
        if rh is not None and rh.device_active() and ing is not None and ing.running:
            # compiled rule WHEREs defer to settle time: the batch runs
            # them in its launch (the hook path skips marked messages)
            msg.headers["_batch_rules"] = True
        msg = await self.hooks.arun_fold("message.publish", (), msg)
        if msg is None or msg.headers.get("allow_publish") is False:
            self.metrics.inc("messages.dropped")
            return 0
        ing = self.ingest
        if ing is not None and ing.running:
            return ing.enqueue(msg)
        return self._dispatch_routed(msg)

    def _dispatch_routed(self, msg: Message) -> int:
        n = self._route_dispatch(msg, self.router.match(msg.topic))
        if n == 0:
            self.hooks.run("message.dropped", msg, "no_subscribers")
            self.metrics.inc("messages.dropped.no_subscribers")
        return n

    def publish_batch(self, msgs: Sequence[Message]) -> int:
        """Batch publish: the publish fold per message, then one device
        step for the batch (`dispatch_batch_folded`); returns the total
        delivery count. With device-compiled rules, each message is marked
        for settle-time firing before its fold."""
        rh = self.rule_hook
        defer = rh is not None and rh.device_active()
        msgs2: List[Message] = []
        for m in msgs:
            if defer:
                m.headers["_batch_rules"] = True
            m = self.hooks.run_fold("message.publish", (), m)
            if m is not None and m.headers.get("allow_publish") is not False:
                msgs2.append(m)
        return sum(self.dispatch_batch_folded(msgs2))

    def dispatch_batch_folded(self, msgs: Sequence[Message]) -> List[int]:
        """Route + dispatch already-folded messages as one device step:
        tokenize, match, fan-out and $share picks in `DeviceRouter.route`,
        then host delivery straight from the slots. Rows the device flags
        (too deep / overflow / too long) fall back to the CPU path per row;
        batches below `min_tpu_batch` skip the device. -> deliveries per
        message.

        With a `DegradeController`: an open breaker, or a failed sync,
        launch or readback, serves the whole batch from the CPU path
        (`_dispatch_cpu_batch`) and moves the breaker. No retries here:
        the caller may hold the event loop, so the pipelined path owns the
        retry ladder. Without one a failure raises."""
        r = self.router
        if not (r.enable_tpu and len(msgs) >= r.min_tpu_batch):
            return self._dispatch_cpu_batch(msgs)
        deg = self.degrade
        if deg is not None and not deg.device.allow():
            return self._degraded_cpu_batch(msgs)
        dev = self._device_router()
        try:
            results = dev.route([m.topic_key() for m in msgs], self._client_hashes(msgs),
                                embeds=self._embeds(msgs), rules=self._rule_batch(msgs))
        except KernelBuildError:
            raise
        except Exception:
            if deg is None:
                raise
            deg.device.record_failure("route")
            return self._degraded_cpu_batch(msgs)
        if deg is not None:
            deg.device.record_success()
        return self._dispatch_device_results(msgs, results)

    def _degraded_cpu_batch(self, msgs: Sequence[Message]) -> List[int]:
        """A batch the degrade ladder sends to the CPU path, counted."""
        self.metrics.inc("degrade.fallback.batches")
        tp("dispatch.degraded", n=len(msgs))
        return self._dispatch_cpu_batch(msgs)

    def _dispatch_cpu_batch(self, msgs: Sequence[Message]) -> List[int]:
        """The authoritative CPU path for a whole batch: per-message trie
        match + host fan-out. Never touches the device: it is both the
        small-batch branch and the degrade ladder's target. Deferred
        compiled rules fire here through the numpy host ladder; semantic
        recipients resolve per message in `_route_dispatch` through the
        host twin."""
        if self.rule_hook is not None:
            self.rule_hook.fire_settled(msgs)
        return [self._dispatch_routed(m) for m in msgs]

    async def adispatch_batch_folded(self, msgs: Sequence[Message]) -> List[int]:
        """`dispatch_batch_folded` with the kernel launches and readback on
        the dispatch pool, so the event loop keeps serving every other
        connection; the table sync and the delivery stay on the loop."""
        return await self.adispatch_begin(msgs)

    def adispatch_begin(self, msgs: Sequence[Message]) -> PendingDispatch:
        """Launch the device dispatch of a batch NOW and return a
        `PendingDispatch`: the ingest pipeline's seam, where batch N+1's
        table sync, encode and launches overlap batch N's readback and
        host fan-out.

        On the calling (event loop) thread: `DeviceRouter.prepare()`, the
        table sync (`profile.stage.prepare.seconds`). On a `dispatch_pool`
        thread: `route_prepared`, the encode, the launches and the one
        readback, on the stream of the calling thread (`launch_stream`,
        `on_stream`), so every batch's work and the loop's scatters run in
        the order they were enqueued. The host FAN-OUT runs only inside
        `complete()`, never when the device work finishes, so callers
        settling batches in launch order keep each publisher's delivery
        order across batches (`profile.stage.host_dispatch.seconds`).
        `ready` signals the end of the device round trip (pacing only).

        A batch below `min_tpu_batch` (or with the device path off) is a
        CPU batch: `ready` is already done and its dispatch, too, waits
        for `complete()`, so it never overtakes an in-flight device batch.

        The degrade ladder (with `degrade` attached, as in the reference):
        an open breaker makes the batch a degraded CPU batch at once (a
        half-open breaker admits one probe batch); so does a `prepare()`
        that raised with no good epoch to roll back to (recorded as a
        `delta_sync` failure). A launch or readback that raised is retried
        `max_retries` times after `retry_delays()`' backoff, each retry
        re-preparing and relaunching bare (no storm, no rider; the rider
        aborted first), then recorded as a `launch` failure and served
        from the CPU path; a good settle records a success. Without a
        controller a failed prepare raises here and a failed launch or
        readback out of `complete()`. A `KernelBuildError` always raises.

        On a mesh (`Broker.mesh`) the launches run on `mesh_dispatch_pool`,
        one worker: every rank issues each batch's collectives in launch
        order, whatever the depth, and at depth 2 batch N + 1's prepare
        and encode still overlap batch N. Every rank must begin the same
        batches in the same order and settle them in launch order, and
        no rider rides (the mesh engine fuses none).

        With a retained feed attached and a router that fuses storms, the
        feed's pending storm (`take_job()`, on the loop thread after
        `prepare()`) rides the batch into `route_prepared(..., retained=)`,
        `attach` fails its waiters over to the CPU walk if the launch
        raises, and `complete()` resolves them from the readback's
        `retained` before the fan-out. A batch carrying a storm takes no
        session rider.

        With a session store attached and a router that fuses sessions,
        the store's pending writes (and a requested sweep) ride the batch:
        `take_rider()` here on the loop thread after `prepare()`, the
        rider into `route_prepared(..., session=)` on the pool thread, and
        `complete()` commits it on the loop before the fan-out (whose
        `Session.deliver` calls append to the op-log the next rider
        takes), or aborts it when the launch or readback raised. At most
        one rider is outstanding: with batch N's rider in flight, batch
        N+1 takes none.

        The batch's embeddings (`_embeds`) and the compiled rules'
        features (`_rule_batch`) are built here on the loop thread too:
        `extract_features` writes ``_rule_suspect`` into the message
        headers. `complete()` fires the deferred rules from the readback's
        masks before the fan-out (`_dispatch_device_results`). Spans are
        not ported: their hand-offs take the reference's path for none
        attached."""
        loop = asyncio.get_running_loop()
        r = self.router
        deg = self.degrade

        def _cpu_pending(degraded: bool = False):
            ready = loop.create_future()
            ready.set_result(None)

            async def _cpu():
                # a degraded batch bypasses the device gate inside
                # dispatch_batch_folded, not just prefers the CPU
                if degraded:
                    return self._degraded_cpu_batch(msgs)
                return self.dispatch_batch_folded(msgs)

            return PendingDispatch(ready, _cpu)

        if not (r.enable_tpu and len(msgs) >= r.min_tpu_batch):
            return _cpu_pending()
        if deg is not None and not deg.device.allow():
            # breaker open: the whole batch serves from the CPU path (a
            # half-open breaker lets one probe batch through)
            return _cpu_pending(degraded=True)
        dev = self._device_router()
        t_prep = time.perf_counter()
        try:
            args = dev.prepare()
        except KernelBuildError:
            raise
        except Exception:
            # a failed sync with no good epoch to roll back to
            if deg is None:
                raise
            deg.device.record_failure("delta_sync")
            return _cpu_pending(degraded=True)
        # waterfall `prepare`: the table sync this launch paid before any
        # device work
        self.metrics.observe(
            "profile.stage.prepare.seconds", time.perf_counter() - t_prep)
        feed = self.retained_feed
        storm = None
        if feed is not None and dev.supports_retained_fusion:
            # pending wildcard-subscribe replays ride THIS launch: every
            # chunk's storm match joins the batch's launches and readback
            storm = feed.take_job()
        store = self.session_store
        rider = None
        if store is not None and storm is None and dev.supports_session_fusion:
            # pending session-table writes (+ a requested retry/expiry
            # sweep) fuse into THIS launch as the session-ack stage
            rider = store.take_rider()
        topics = [m.topic_key() for m in msgs]
        hashes = self._client_hashes(msgs)
        embeds = self._embeds(msgs)
        rules = self._rule_batch(msgs)
        pool = dispatch_pool() if dev.mesh is None else mesh_dispatch_pool()
        fut = loop.run_in_executor(
            pool, on_stream, dev.launch_stream(), dev.route_prepared,
            args, topics, hashes, storm, rider, embeds, rules)
        if storm is not None:
            feed.attach(storm, fut)

        async def _complete():
            srd = rider
            try:
                results = await fut
            except Exception as e:
                if deg is None or isinstance(e, KernelBuildError):
                    if srd is not None:
                        # the mirror never advanced: the rider's writes
                        # stay in the op-log and ride a later launch
                        store.abort(srd)
                    raise
                results = None
            if results is None:
                if srd is not None:
                    store.abort(srd)
                    srd = None
                # bounded backoff + jitter, then degrade: each retry
                # re-prepares (a torn sync rolls back to the last good
                # epoch) and relaunches bare: the storm's waiters already
                # fell back to the CPU walk (`feed.attach`)
                for delay in deg.retry_delays():
                    await asyncio.sleep(delay)
                    try:
                        args2 = dev.prepare()
                        results = await loop.run_in_executor(
                            pool, on_stream, dev.launch_stream(), dev.route_prepared,
                            args2, topics, hashes, None, None, embeds, rules)
                        break
                    except KernelBuildError:
                        raise
                    except Exception:
                        results = None
            if results is None:
                # retries exhausted: trip the breaker and serve the batch
                # from the CPU path; the publishes succeed, same recipients
                deg.device.record_failure("launch")
                return self._degraded_cpu_batch(msgs)
            if deg is not None:
                deg.device.record_success()
            if srd is not None:
                # adopt the updated mirror + act on the sweep, on the loop
                # (the single-writer discipline), before the fan-out
                store.commit(srd, results.session)
            if storm is not None:
                # a no-op when the storm already failed over
                feed.resolve(storm, results.retained)
            # waterfall `host_dispatch`: the settle-time fan-out of this
            # device batch (delivery resolution + writes)
            t_hd = time.perf_counter()
            res = self._dispatch_device_results(msgs, results)
            self.metrics.observe(
                "profile.stage.host_dispatch.seconds", time.perf_counter() - t_hd)
            return res

        return PendingDispatch(fut, _complete)

    def _device_router(self) -> DeviceRouter:
        """The lazy device router: a `MeshServingRouter` when `mesh` is set
        (sharded mirrors, the SPMD step), else a `DeviceRouter`
        (emqx_tpu/broker/broker.py:732-758). On a card the kernel library
        is built and loaded here, outside every call the degrade ladder
        guards, so a build failure raises to the caller."""
        if self._device is None:
            cls = DeviceRouter if self.mesh is None else MeshServingRouter
            dev = cls(
                self.router.index,
                self.subtab,
                self.router.matcher_config,
                grouptab=self.grouptab,
                share_strategy=self.shared.strategy,
                mesh=self.mesh,
                metrics=self.metrics,
                semtab=self.semantic.table if self.semantic is not None else None,
                device=self.router.device,
            )
            if dev.device.type == "cuda":
                build.load()
            self._device = dev
            if self.mesh is not None and self.shard_label:
                self._device.shard_label = self.shard_label
        return self._device

    def _embeds(self, msgs):
        """[B, D] query embeddings for the semantic stage, or None (no
        per-row cost) when no semantic plane is live."""
        sem = self.semantic
        if sem is None or not len(sem.table):
            return None
        return sem.embed_batch(msgs)

    def _rule_batch(self, msgs):
        """(progs, feats, valid) of the compiled rules for the in-launch
        WHERE masks, or None when no rule compiled."""
        rh = self.rule_hook
        if rh is None:
            return None
        return rh.device_progs(msgs)

    def _client_hashes(self, msgs):
        """Publisher-id hashes for the device $share pick — skipped
        entirely when no groups exist or the strategy doesn't use them."""
        if not len(self.grouptab) or self.shared.strategy != "hash_clientid":
            return None
        return [stable_hash(m.from_client) for m in msgs]

    def _dispatch_device_results(self, msgs, results) -> List[int]:
        """Fan one routed batch (a `RouteResult`) out to local subscribers.

        On the compact path (`results.slots`) non-overflow rows dispatch
        straight from their slot lists, overflow rows decode the dense rows
        of the second transfer (or, on a CSR table, rows built from the
        host table); with compaction off every row decodes
        `results.bitmaps`. The match and fid memos are per batch.

        The deferred compiled rules fire first (the reference's order:
        rules run in the publish fold, before dispatch), from the batch's
        masks. With the semantic stage in the batch its winners are in
        the slot rows already; an overflow row unions them back into its
        dense row, and every row's slots are deduplicated."""
        matched, flags = results.matched, results.flags
        picks = results.picks
        r = self.router
        if self.rule_hook is not None:
            self.rule_hook.fire_settled(msgs, masks=results.rule_masks)
        sem = results.sem_count is not None
        if sem:
            counts = np.asarray(results.sem_count)
            hits = int(counts.sum())
            if hits:
                self.metrics.inc("semantic.hits", hits)
            topk = self.semantic.table.topk if self.semantic is not None else 0
            if topk:
                trunc = int(np.count_nonzero(counts > topk))
                if trunc:
                    self.metrics.inc("semantic.topk.truncated", trunc)
        out: List[int] = []
        fell_back = 0
        touched_gids: set = set()
        match_memo: Dict[Tuple[str, str], bool] = {}
        fid_memo: Dict[int, Tuple[Optional[str], bool]] = {}
        compact = results.slots is not None
        # ONE .tolist() per output matrix up front: the per-message loop
        # then runs on plain ints
        flags_l = np.asarray(flags).tolist()
        slots_ll = results.slots.tolist() if compact else None
        ovf_l = results.overflow.tolist() if compact else None
        # matched fid rows only matter when groups exist AND the device
        # did not already resolve the picks
        need_fids = picks is None and bool(self.shared._table)
        matched_l = matched.tolist() if need_fids else None
        fanouts: List[int] = []
        for i, m in enumerate(msgs):
            if flags_l[i]:
                fell_back += 1
                n = self._route_dispatch(m, r.match(m.topic))
            else:
                msg_picks = (picks[0][i], picks[1][i]) if picks is not None else None
                if compact and not ovf_l[i]:
                    bits, slots = None, slots_ll[i]  # -1 pads skip below
                elif compact:
                    # the dense row holds the topic fan-out only: the
                    # semantic winners ride the slot row, union them back
                    bits = results.dense_rows[results.dense_index[i]]
                    slots = slots_ll[i] if sem else None
                else:
                    bits, slots = results.bitmaps[i], None
                # matched rows are SPARSE (-1 holes between engines)
                fids = [f for f in matched_l[i] if f >= 0] if matched_l is not None else ()
                n = self._dispatch_row(
                    m, bits, fids, msg_picks, touched_gids, slots=slots,
                    match_memo=match_memo, fid_memo=fid_memo, stats=fanouts, dedup=sem)
            if n == 0:
                self.hooks.run("message.dropped", m, "no_subscribers")
                self.metrics.inc("messages.dropped.no_subscribers")
            out.append(n)
        if fanouts:
            # batched flight-recorder upkeep: same series, one lock
            self.metrics.inc("messages.received", len(fanouts))
            self.metrics.observe_many("dispatch.fanout", fanouts)
            delivered = sum(fanouts)
            if delivered:
                self.metrics.inc("messages.delivered", delivered)
        if touched_gids:
            self._sync_group_counters(touched_gids)
        if fell_back:
            self.metrics.inc("messages.routed.device_fallback", fell_back)
        self.metrics.inc("messages.routed.device", len(msgs) - fell_back)
        return out

    def _dispatch_row(
        self, msg: Message, bits: Optional[np.ndarray], fids, picks=None,
        touched_gids: Optional[set] = None, *, slots=None,
        match_memo: Optional[Dict] = None, fid_memo: Optional[Dict] = None,
        stats: Optional[List] = None, dedup: bool = False,
    ) -> int:
        """Deliver one routed message from its device outputs: the slot
        list (compact path) or the bitmap row (dense path) -> plain subs;
        the device's (gids, idxs) picks, or with no picks the matched
        filter ids, -> shared groups (host pick and failover). With
        `stats` given the fan-out lands there and the caller batches the
        metric upkeep. `bits` AND `slots` together are a semantic overflow
        row: the dense row's topic fan-out plus the slot row's semantic
        winners; `dedup` keeps a slot from delivering twice."""
        if stats is None:
            self.metrics.inc("messages.received")
        if match_memo is None:
            match_memo = {}
        if fid_memo is None:
            fid_memo = {}
        n = 0
        topic = msg.topic
        if bits is not None:
            if not bits.flags.c_contiguous:
                bits = np.ascontiguousarray(bits)
            dense = np.nonzero(
                np.unpackbits(bits.view(np.uint8), bitorder="little")
            )[0].tolist()
            if slots is None:
                slots = dense
            else:
                if not isinstance(slots, list):
                    slots = np.asarray(slots).tolist()
                slots = dense + slots
        elif not isinstance(slots, list):
            slots = np.asarray(slots).tolist()
        slot_subs = self._slot_subs
        nsubs = len(slot_subs)
        seen = set() if dedup else None
        for slot in slots:
            # -1 pads (compact rows) and slots past the table skip here
            if slot < 0 or slot >= nsubs:
                continue
            if seen is not None:
                if slot in seen:
                    continue
                seen.add(slot)
            sub = slot_subs[slot]
            if sub is None:
                continue
            if sub.opts.no_local and sub.client_id == msg.from_client:
                continue
            # staleness net: the kernel ran against a snapshot, and slots
            # freed during an in-flight batch can be reused by unrelated
            # subscriptions — verify the sub's filter really matches before
            # delivering (memoized per batch: a pure fn of (topic, filter))
            f = sub.filter
            if topic != f:
                ok = match_memo.get((topic, f))
                if ok is None:
                    ok = match_memo[(topic, f)] = T.match(topic, f)
                if not ok:
                    continue
            n += self._deliver_one(sub, msg)
        if picks is not None:
            # device-resolved $share picks: the host does delivery + failover
            gids, idxs = picks
            for gid, idx in zip(gids, idxs):
                if gid < 0:
                    continue
                info = self.grouptab.info(int(gid))
                if info is None:
                    continue  # group dropped while the batch was in flight
                real, gname = info
                ok = match_memo.get((topic, real))
                if ok is None:
                    ok = match_memo[(topic, real)] = T.match(topic, real)
                if not ok:
                    continue
                n += self.shared.dispatch_picked(real, gname, int(idx), msg)
                if touched_gids is not None:
                    touched_gids.add(int(gid))
        else:
            for fid in fids:
                fid = int(fid)
                ent = fid_memo.get(fid)
                if ent is None:
                    name = self.router.filter_name(fid)
                    ent = fid_memo[fid] = (
                        name, name is not None and self.shared.has_groups(name))
                name, has_g = ent
                if not has_g:
                    continue
                ok = match_memo.get((topic, name))
                if ok is None:
                    ok = match_memo[(topic, name)] = T.match(topic, name)
                if ok:
                    n += self.shared.dispatch_groups(name, msg)
        if stats is not None:
            stats.append(n)
            return n
        self.metrics.observe("dispatch.fanout", n)
        if n:
            self.metrics.inc("messages.delivered", n)
        return n

    def _sync_group_counters(self, gids) -> None:
        """Push advanced round-robin bases / sticky pins back to the
        device mirror — once per BATCH with the touched gid set, so churn
        is one bounded write per group per batch."""
        for gid in gids:
            info = self.grouptab.info(gid)
            if info is None:
                continue
            g = self.shared.group(*info)
            if g is None:
                continue
            self.grouptab.set_rr(gid, g.rr_index)
            if self.shared.strategy == "sticky" and g.sticky_sid is not None:
                self.grouptab.repin(gid, g.members.keys(), g.sticky_sid)

    def dispatch(self, filters: List[str], msg: Message) -> int:
        """Deliver to local subscribers of pre-matched filters (the
        receiving half of a forward, emqx_broker.erl:505-530)."""
        return self._route_dispatch(msg, filters)

    def _route_dispatch(self, msg: Message, filters: List[str]) -> int:
        self.metrics.inc("messages.received")
        if msg.headers.get("_batch_rules") and self.rule_hook is not None:
            # a deferred-rule message settling outside the batch paths (a
            # device-flagged row of a batch that carried no masks): fire
            # through the host ladder
            self.rule_hook.fire_settled([msg])
        n = 0
        for f in filters:
            # one matched filter may carry plain subscribers AND shared groups
            entry = self._subs.get(f)
            if entry:
                for sub in list(entry.values()):
                    if sub.opts.no_local and sub.client_id == msg.from_client:
                        continue
                    if sub.semantic:
                        continue  # needs similarity too: the host twin below
                    n += self._deliver_one(sub, msg)
            n += self.shared.dispatch_groups(f, msg)
        sem = self.semantic
        if sem is not None and len(sem.table):
            # the authoritative host twin: topic scope AND similarity,
            # global top-k
            slot_subs = self._slot_subs
            for slot in sem.host_route([msg])[0]:
                sub = slot_subs[slot] if 0 <= slot < len(slot_subs) else None
                if sub is None:
                    continue
                if sub.opts.no_local and sub.client_id == msg.from_client:
                    continue
                n += self._deliver_one(sub, msg)
        self.metrics.observe("dispatch.fanout", n)
        if n:
            self.metrics.inc("messages.delivered", n)
        return n

    def _deliver_one(self, sub: Subscriber, msg: Message) -> int:
        """One raising deliverer must not poison the rest of the fan-out
        (or, on the batch path, every other message in the batch)."""
        try:
            sub.deliver(msg, sub.opts)
            return 1
        except Exception:
            self.metrics.inc("delivery.errors")
            return 0

    def drop_session_subs(self, sid: str, filters: Sequence[str]) -> None:
        """Bulk cleanup when a session dies (emqx_broker_helper pmon parity)."""
        for f in list(filters):
            self.unsubscribe(sid, f)
