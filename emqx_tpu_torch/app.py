"""Application assembly + lifecycle: config -> running broker, on the
port's device engine. The port's copy of `BrokerApp` (emqx_tpu/app.py:164)
with `attach_guards` and `attach_authz`.

The emqx_machine analog (apps/emqx_machine/src/emqx_machine_boot.erl:
dependency-ordered app boot, signal handling): builds the broker kernel,
extensions, listeners and periodic housekeeping from one `AppConfig`,
starts them in dependency order, and tears them down cleanly. Its order of
construction is the reference's: the semantic plane is attached before the
first dispatch builds the device router; `start()` wires `BatchIngest` and
the retained storm feed, restores persistent sessions and then the durable
state (segment tables, retained, delayed, banned, breaker states), warms
the device route up and only then opens the listeners.

The device: `BrokerApp(config, device=None)` serves on CUDA unless the
caller passes ``device="cpu"`` (each kernel's plain twin, as the tests
run it); with `router.enable_tpu` on and neither CUDA nor ``device="cpu"``
it raises ("CUDA is not available"). `router.enable_tpu = false` (the
entry point's ``--no-tpu``) serves from the CPU trie, as the reference
does, because the caller asked for it. A kernel library that does not
build (`kernels.build.KernelBuildError`) escapes the warmup: a checkout
whose kernels do not build never boots to serve from the CPU.

The heap (a deviation from the reference, which leaves the collector
alone): `start()` turns the garbage collector off for the restores and
freezes the heap after them (`gc.freeze()`), and `stop()` unfreezes it. A
restored million-filter table is millions of Python objects, and a full
collection over them takes seconds; left in the collector's reach it
lands on the first batches the clients send.

What the port does not carry yet is refused when the app is built: one
`NotImplementedError` that names every enabled section it finds
(`unsupported(config)`) and the ROADMAP entry that will carry it. A
section is never skipped silently. The reference also runs, with no
switch, extensions that are not ported yet (ROADMAP item 10.3c): the
license gate with no key, `TopicMetrics`, `TraceManager`, the device
profiler and its provenance gauges, `DeviceWatch`, the alarm manager (so
no connection congestion alarm either), log formatting (the port leaves
logging to the process, and refuses a `log` section other than the
default) and the `$SYS` heartbeat and stats loops, and
its runtime config-update pipeline belongs to the management API (ROADMAP
item 10.3d). None of them changes a delivery to a subscriber that does
not subscribe to `$SYS`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import logging
import os
import time
from typing import List, Optional

from emqx_tpu_torch.broker.authz import AclRule, Authorizer
from emqx_tpu_torch.broker.banned import Banned, Flapping
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.channel import ChannelConfig
from emqx_tpu_torch.broker.cm import ChannelManager
from emqx_tpu_torch.broker.delayed import DelayedPublish
from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.retainer import Retainer
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.broker.shared_sub import SharedSub
from emqx_tpu_torch.config.schema import AppConfig, EventMessageConfig, LogConfig
from emqx_tpu_torch.kernels.build import KernelBuildError
from emqx_tpu_torch.ops.matcher import MatcherConfig
from emqx_tpu_torch.transport.listener import ListenerConfig, Listeners
from emqx_tpu_torch.utils.node import set_node_name

log = logging.getLogger("emqx_tpu_torch")

# ROADMAP entries that will carry what the app refuses
_MESH = "ROADMAP item 10.3b"
_OBSERVE = "ROADMAP item 10.3c"
_MGMT = "ROADMAP item 10.3d"
_REST = "ROADMAP item 10.3e"


def unsupported(c: AppConfig) -> List[str]:
    """Every enabled config key the port's app does not carry, each with
    the ROADMAP entry that will carry it; [] when the app can be built."""
    out = []

    def refuse(key: str, on, entry: str) -> None:
        if on:
            out.append(f"{key} ({entry})")

    dp, tp = c.router.mesh_shape
    refuse("router.mesh_shape", dp * tp > 1, _MESH)
    refuse("dashboard.enable", c.dashboard.enable, _MGMT)
    refuse("cluster.enable", c.cluster.enable, _REST)
    refuse("gateways", c.gateways, _REST)
    refuse("bridges", c.bridges, _REST)
    refuse("exhook", c.exhook, _REST)
    refuse("plugins.start", c.plugins.start, _REST)
    refuse("authn.enable", c.authn.enable, _REST)
    refuse("authn.scram_enable", c.authn.scram_enable, _REST)
    refuse("psk.enable", c.psk.enable, _REST)
    refuse("authz.http_url", c.authz.http_url, _REST)
    refuse("authz.acl_file", c.authz.acl_file, _REST)
    refuse("license.key", c.license.key, _OBSERVE)
    refuse("rewrite", c.rewrite, _REST)
    refuse("auto_subscribe", c.auto_subscribe, _REST)
    for i, spec in enumerate(c.listeners):
        refuse(f"listeners[{i}].workers", spec.workers > 0, _REST)
        refuse(f"listeners[{i}].type={spec.type}", spec.type in ("ws", "wss"), _REST)
    ob = c.observe
    refuse("observe.telemetry.enable", ob.telemetry.enable, _OBSERVE)
    refuse("observe.statsd.enable", ob.statsd.enable, _OBSERVE)
    refuse("observe.trace_spans_enable", ob.trace_spans_enable, _OBSERVE)
    refuse("observe.sys_mon_enable", ob.sys_mon_enable, _OBSERVE)
    refuse("observe.os_mon_enable", ob.os_mon_enable, _OBSERVE)
    refuse("observe.vm_mon_enable", ob.vm_mon_enable, _OBSERVE)
    refuse("observe.slow_subs.enable", ob.slow_subs.enable, _OBSERVE)
    refuse("observe.tpu_fallback_alarm_enable", ob.tpu_fallback_alarm_enable, _OBSERVE)
    refuse("observe.retrace_alarm_enable", ob.retrace_alarm_enable, _OBSERVE)
    refuse("slo.alarm_enable", c.slo.alarm_enable, _OBSERVE)
    refuse("log", c.log != LogConfig(), _OBSERVE)
    for f in dataclasses.fields(EventMessageConfig):
        refuse(f"observe.event_message.{f.name}", getattr(ob.event_message, f.name), _OBSERVE)
    return out


def attach_guards(hooks: Hooks, c: AppConfig):
    """Banned + flapping admission guards (emqx_banned / emqx_flapping)."""
    banned = Banned()
    banned.attach(hooks)
    flapping = (
        Flapping(
            banned,
            max_count=c.flapping.max_count,
            window=c.flapping.window_time,
            ban_time=c.flapping.ban_time,
        )
        if c.flapping.enable
        else None
    )
    if flapping:
        flapping.attach(hooks)
    return banned, flapping


def attach_authz(hooks: Hooks, c: AppConfig) -> Authorizer:
    """The ACL rules of `authz.rules` (emqx_authz analog); the file ACL and
    the HTTP source are refused (`unsupported`)."""
    authz = Authorizer(
        rules=[BrokerApp._acl_rule(r) for r in c.authz.rules],
        no_match=c.authz.no_match,
        deny_action=c.authz.deny_action,
    )
    authz.attach(hooks)
    return authz


def load_segment_state(path: str, device):
    """A segment-state sidecar -> the captured dict of the port's tables.
    The port's own file unpickles as it is; a file the reference's app
    wrote (its first class reference names an `emqx_tpu.` module) goes
    through `convert.segment_state_from_reference`, which imports nothing
    of the reference package."""
    import pickle
    import pickletools

    reference = False
    with open(path, "rb") as f:
        for op, arg, _pos in pickletools.genops(f):
            if isinstance(arg, str) and arg.startswith("emqx_tpu"):
                reference = not arg.startswith("emqx_tpu_torch")
                break
    if reference:
        from emqx_tpu_torch.convert import segment_state_from_reference

        return segment_state_from_reference(path, device=device)
    with open(path, "rb") as f:
        return pickle.load(f)


class BrokerApp:
    def __init__(self, config: Optional[AppConfig] = None, device=None):
        """`device`: where the device engines run when `router.enable_tpu`
        is on; CUDA unless ``device="cpu"``."""
        self.config = config or AppConfig()
        c = self.config
        refused = unsupported(c)
        if refused:
            raise NotImplementedError(
                "the port's app does not carry these enabled config keys yet: "
                + "; ".join(refused))
        if c.router.enable_tpu:
            from emqx_tpu_torch.convert import resolve_device

            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = None  # the CPU trie serves; no device engine
        dev = str(self.device) if self.device is not None else "cpu"
        if c.node.name:
            set_node_name(c.node.name)

        self.hooks = Hooks()
        self.router = Router(
            matcher_config=MatcherConfig(
                max_levels=c.router.max_levels,
                frontier=c.router.frontier,
                max_matches=c.router.max_matches,
                max_bytes=c.router.max_bytes,
                fanout_compact=c.router.fanout_compact,
                fanout_slots=c.router.fanout_slots,
                sub_table=c.router.sub_table,
                sparse_gather=c.router.sparse_gather,
            ),
            min_tpu_batch=c.router.min_tpu_batch,
            enable_tpu=c.router.enable_tpu,
            device=dev,
        )
        self.broker = Broker(router=self.router, hooks=self.hooks)
        self.broker.shared = SharedSub(strategy=c.shared_subscription.strategy)
        # a [1, 1] mesh runs as one device; more ranks are refused above
        if c.semantic.enable:
            # attached BEFORE the first dispatch builds the device router,
            # so the router binds the semantic table
            from emqx_tpu_torch.broker.semantic import SemanticRouting

            self.broker.semantic = SemanticRouting(
                dim=c.semantic.dim,
                topk=c.semantic.topk,
                threshold=c.semantic.threshold,
                dtype=c.semantic.dtype,
                metrics=self.broker.metrics,
            )
        self.cm = ChannelManager(self.broker)
        # the device session store: inflight windows and QoS state ride
        # the segment machinery, ack clears and sweeps the serving launches
        if c.session.device_store and c.router.enable_tpu:
            from emqx_tpu_torch.broker.session_store import SessionStore

            self.session_store = SessionStore(
                capacity=c.session.store_capacity,
                sweep_slots=c.session.store_sweep_slots,
                retry_interval=c.session.retry_interval,
                metrics=self.broker.metrics,
                device=dev,
            )
            self.broker.session_store = self.session_store
            self.cm.session_store = self.session_store
        else:
            self.session_store = None
        self.channel_config = ChannelConfig(caps=c.mqtt, session=c.session)
        # rate limiting + overload protection (emqx_limiter, emqx_olp)
        from emqx_tpu_torch.broker.limiter import LimiterServer
        from emqx_tpu_torch.broker.olp import Olp
        from emqx_tpu_torch.transport.listener import TransportContext

        self.limiters = LimiterServer(c.limiter)
        self.olp = Olp(
            enable=c.olp.enable,
            lag_watermark_ms=c.olp.lag_watermark_ms,
            cooldown=c.olp.cooldown,
            metrics=self.broker.metrics,
        )
        # fault injection: the process-wide injector counts into this
        # broker's metrics; config-armed rules load here
        from emqx_tpu_torch.observe.faults import default_faults

        self.faults = default_faults
        self.faults.metrics = self.broker.metrics
        if c.faults.enable:
            for fr in c.faults.rules:
                self.faults.arm(
                    fr.site,
                    mode=fr.mode,
                    probability=fr.probability,
                    nth=fr.nth,
                    max_fires=fr.max_fires,
                    delay_ms=fr.delay_ms,
                )
        if c.force_gc.enable:
            from emqx_tpu_torch.transport.congestion import ForcedGC

            _gc_count, _gc_bytes = c.force_gc.count, c.force_gc.bytes
            make_forced_gc = lambda: ForcedGC(_gc_count, _gc_bytes)  # noqa: E731
        else:
            make_forced_gc = None
        self.transport_ctx = TransportContext(
            limiters=self.limiters,
            olp=self.olp,
            make_forced_gc=make_forced_gc,
        )
        self.listeners = Listeners(self.broker, self.cm, ctx=self.transport_ctx)
        if self.limiters.limited("message_routing"):
            # message_routing limiter: overload-drop at the publish gate
            routing_limiter = self.limiters.connect("message_routing")

            def _routing_gate(msg, acc=None):
                m = acc if acc is not None else msg
                if not routing_limiter.try_acquire(1):
                    self.broker.metrics.inc("limiter.dropped.message_routing")
                    m.headers["allow_publish"] = False
                return ("ok", m)

            self.hooks.add(
                "message.publish", _routing_gate, priority=1000,
                tag="limiter.message_routing",
            )

        self.banned, self.flapping = attach_guards(self.hooks, c)

        self.retainer = Retainer(
            max_retained=c.retainer.max_retained_messages,
            max_payload=c.retainer.max_payload_size,
            device_threshold=c.retainer.device_threshold,
            enable_device=c.router.enable_tpu,
            device=dev,
        )
        self.retainer.enabled = c.retainer.enable
        self.retainer.attach(self.hooks)

        self.delayed = DelayedPublish(
            self.broker, max_messages=c.delayed.max_delayed_messages
        )
        self.delayed.enabled = c.delayed.enable
        self.delayed.attach(self.hooks)

        # rule engine (emqx_rule_engine)
        from emqx_tpu_torch.rules.engine import Console, Republish, RuleEngine

        self.rule_engine = RuleEngine(self.broker)
        self.rule_engine.attach(self.hooks)
        if c.semantic.enable and c.semantic.rule_predicates:
            # compiled WHERE predicates filter inside the serving launch
            self.rule_engine.attach_device()
        for spec in c.rules:
            outputs = []
            for o in spec.outputs or [None]:
                if o is None or o.function == "console":
                    outputs.append(Console())
                else:
                    a = o.args
                    outputs.append(
                        Republish(
                            topic=str(a.get("topic", "")),
                            payload=str(a.get("payload", "${payload}")),
                            qos=int(a.get("qos", 0)),
                            retain=bool(a.get("retain", False)),
                        )
                    )
            rule = self.rule_engine.create_rule(
                spec.id, spec.sql, outputs, spec.description
            )
            rule.enabled = spec.enable

        self.authz = attach_authz(self.hooks, c)

        # the degradation ladder: device-path breaker + bounded retries
        if c.degrade.enable:
            from emqx_tpu_torch.broker.degrade import DegradeController

            self.degrade = DegradeController(
                metrics=self.broker.metrics,
                max_retries=c.degrade.max_retries,
                backoff_base_s=c.degrade.backoff_base_ms / 1e3,
                backoff_max_s=c.degrade.backoff_max_ms / 1e3,
                failure_threshold=c.degrade.failure_threshold,
                open_secs=c.degrade.open_secs,
                probe_successes=c.degrade.probe_successes,
                shed_queue_batches=c.degrade.shed_queue_batches,
            )
            self.broker.degrade = self.degrade
        else:
            self.degrade = None
        # SLO-driven adaptive batching, attached to BatchIngest in start()
        if c.slo.enable and c.router.ingest_enable and c.router.enable_tpu:
            from emqx_tpu_torch.broker.slo import SloController

            self.slo = SloController(
                metrics=self.broker.metrics,
                target_p99_ms=c.slo.target_p99_ms,
                min_window_us=c.slo.min_window_us,
                max_window_us=c.slo.max_window_us,
                initial_window_us=c.router.ingest_window_us,
                eval_interval_s=c.slo.eval_interval_ms / 1e3,
                min_samples=c.slo.min_samples,
                gain=c.slo.gain,
                hysteresis=c.slo.hysteresis,
                ladder_patience=c.slo.ladder_patience,
                defer_max_s=c.slo.defer_max_ms / 1e3,
                starvation_s=c.slo.starvation_ms / 1e3,
                shed_hard_mult=c.slo.shed_hard_mult,
                olp=self.olp,
            )
        else:
            self.slo = None
        # background segment compaction, driven by the housekeeping tick
        if c.router.enable_tpu:
            from emqx_tpu_torch.ops.segments import SegmentCompactor

            self.segment_compactor = SegmentCompactor(
                metrics=self.broker.metrics,
                interval_s=c.router.compact_interval_s,
            )
        else:
            self.segment_compactor = None

        # durability (persistent sessions + disc-copies analog)
        if c.durability.enable:
            from emqx_tpu_torch.broker.persistent_session import (
                DurableState,
                SessionPersistence,
            )
            from emqx_tpu_torch.storage.kv import FileKv
            from emqx_tpu_torch.storage.wal import MessageWal

            kv = FileKv(c.durability.data_dir, fsync=c.durability.fsync)
            self.session_persistence = SessionPersistence(
                self.broker,
                self.cm,
                kv,
                self.channel_config.session,
                wal=MessageWal(
                    os.path.join(c.durability.data_dir, "messages.wal"),
                    fsync=c.durability.fsync,
                ),
            )
            self.session_persistence.attach(self.hooks)
            segments = None
            if c.durability.segment_snapshot:
                # the device tables' host state checkpoints as a sidecar
                # pickle, so a replacement process restores million-entry
                # tables instead of replaying every subscribe
                from emqx_tpu_torch.ops.segments import SegmentStateSnapshot

                def _cap_segments():
                    state = {
                        "router": self.broker.router,
                        "subtab": self.broker.subtab,
                        "grouptab": self.broker.grouptab,
                    }
                    if self.session_store is not None:
                        state["session_store"] = self.session_store.capture()
                    return state

                def _install_segments(state):
                    state["router"].device = dev
                    self.broker.router = state["router"]
                    self.broker.subtab = state["subtab"]
                    self.broker.grouptab = state["grouptab"]
                    if (
                        self.session_store is not None
                        and state.get("session_store") is not None
                    ):
                        self.session_store.install(state["session_store"])
                    self.broker._device = None  # rebuilt on next batch

                segments = SegmentStateSnapshot(
                    os.path.join(c.durability.data_dir, "segments.pkl"),
                    capture=_cap_segments,
                    install=_install_segments,
                    read=lambda path: load_segment_state(path, dev),
                )
            self.durable_state = DurableState(
                kv,
                retainer=self.retainer if c.retainer.enable else None,
                delayed=self.delayed if c.delayed.enable else None,
                banned=self.banned,
                degrade=self.degrade,
                segments=segments,
            )
        else:
            self.session_persistence = None
            self.durable_state = None

        self._tasks: List[asyncio.Task] = []
        self.started_at: Optional[float] = None
        self._heap_frozen = False  # start() froze the heap; stop() unfreezes it

    @staticmethod
    def _acl_rule(spec) -> AclRule:
        who = spec.who
        if isinstance(who, str) and ":" in who:
            k, v = who.split(":", 1)
            who = {k: v}
        return AclRule(spec.permit, who, spec.action, list(spec.topics))

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        c = self.config
        # live connection traffic rides the device route path
        if c.router.ingest_enable and c.router.enable_tpu:
            from emqx_tpu_torch.broker.ingest import BatchIngest

            self.broker.ingest = BatchIngest(
                self.broker,
                max_batch=c.router.ingest_max_batch,
                window_us=c.router.ingest_window_us,
                pipeline=c.router.ingest_pipeline,
                olp=self.olp,
                slo=self.slo,
                qos0_low=self.slo is not None and c.slo.qos0_low_lane,
            )
            self.broker.ingest.start()
            if c.retainer.enable and c.retainer.storm_ride:
                # wildcard-subscribe replay storms ride the serving
                # pipeline's fused launch
                from emqx_tpu_torch.broker.retained_feed import RetainedStormFeed

                self.retainer.ensure_device()
                if self.retainer._device is not None:
                    feed = RetainedStormFeed(
                        self.retainer._device,
                        metrics=self.broker.metrics,
                        window_s=c.retainer.storm_window_us / 1e6,
                    )
                    feed.slo = self.slo
                    self.retainer.storm_feed = feed
                    self.broker.retained_feed = feed
        # restore durable state BEFORE listeners accept clients (sessions
        # first, then the segment tables and the stores: the reference's
        # order), the collector off while the restores allocate and the
        # restored heap frozen after them (the module docstring)
        collecting = gc.isenabled()
        gc.disable()
        try:
            if self.session_persistence is not None:
                restored = self.session_persistence.restore()
                if restored:
                    self.broker.metrics.gauge_set("sessions.restored", restored)
            if self.durable_state is not None:
                self.durable_state.restore()
        finally:
            gc.freeze()
            self._heap_frozen = True
            if collecting:
                gc.enable()
        if self.broker.ingest is not None:
            # warm the device route up BEFORE listeners accept (AFTER the
            # restore, so the first full upload carries the restored
            # tables): kernel builds and first uploads stay off live
            # publishers. A kernel library that does not build escapes.
            try:
                dev = self.broker._device_router()
                args = dev.prepare()
                await asyncio.get_running_loop().run_in_executor(
                    None,
                    dev.route_prepared,
                    args,
                    ["warmup/a"] * max(1, c.router.min_tpu_batch),
                )
            except KernelBuildError:
                raise
            except Exception:
                log.exception("device route warmup failed; serving with cold kernel")
        for spec in c.listeners:
            chan_cfg = self.channel_config
            if spec.mountpoint:
                # per-listener channel config: same caps/session, listener-
                # specific topic namespace (emqx_listeners.erl:232 analog)
                chan_cfg = dataclasses.replace(chan_cfg, mountpoint=spec.mountpoint)
            await self.listeners.start_listener(
                ListenerConfig(
                    name=spec.name,
                    type=spec.type,
                    bind=spec.bind,
                    port=spec.port,
                    max_connections=spec.max_connections,
                    ssl_certfile=spec.ssl_certfile,
                    ssl_keyfile=spec.ssl_keyfile,
                    ssl_cacertfile=spec.ssl_cacertfile,
                    ssl_verify=spec.ssl_verify,
                ),
                chan_cfg,
            )
        self.started_at = time.time()
        self.olp.start()
        self._tasks = [asyncio.ensure_future(self._housekeeping())]

    async def stop(self) -> None:
        if self.broker.ingest is not None:
            await self.broker.ingest.stop()
            self.broker.ingest = None
        if self.broker.retained_feed is not None:
            # replays after stop take the synchronous match path
            self.retainer.storm_feed = None
            self.broker.retained_feed = None
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.olp.stop()
        await self.listeners.stop_all()
        # final checkpoint AFTER listeners close: connection teardown parks
        # live persistent sessions into cm._detached, so the snapshot
        # includes clients that were still connected at shutdown
        if self.session_persistence is not None:
            self.session_persistence.flush(force=True)
        if self.durable_state is not None:
            self.durable_state.flush()
        if self._heap_frozen:
            gc.unfreeze()
            self._heap_frozen = False

    async def _housekeeping(self) -> None:
        c = self.config
        last_retainer_sweep = 0.0
        last_session_sweep = 0.0
        last_durability_flush = time.time()
        while True:
            await asyncio.sleep(1.0)
            try:
                now = time.time()
                # delayed dues + detached-session deadlines are monotonic:
                # they read their own clock
                self.delayed.tick()
                self.cm.sweep_expired()
                self.banned.sweep(now)
                if self.flapping is not None:
                    self.flapping.sweep(now)
                if now - last_retainer_sweep >= c.retainer.msg_clear_interval:
                    self.retainer.clear_expired(now)
                    last_retainer_sweep = now
                dev = self.broker._device
                if self.segment_compactor is not None and dev is not None:
                    sh = dev.index.shapes
                    m = self.broker.metrics
                    m.gauge_set("router.segment.hot.fill", sh.hot_live)
                    m.gauge_set("router.segment.hot.capacity", sh.hot_capacity)
                    m.gauge_set("router.segment.tombstones", sh.packed_tombstones)
                    st_sub = self.broker.subtab.status()
                    if st_sub["mode"] == "sparse":
                        m.gauge_set("router.sparse.bytes", st_sub["bytes"])
                        m.gauge_set("router.sparse.fill", st_sub["csr_fill"])
                        m.gauge_set(
                            "router.sparse.tombstones", st_sub["csr_tombstones"]
                        )
                        m.gauge_set("router.sparse.hot.fill", st_sub["hot_fill"])
                    rc = c.router
                    owners = dev.compaction_owners(
                        hot_entries=rc.compact_hot_entries,
                        tombstone_frac=rc.compact_tombstone_frac,
                    )
                    if self.session_store is not None:
                        # the fourth owner on the one compactor: acked
                        # (tombstoned) session rows purge off the hot path
                        owners.append(
                            self.session_store.compaction_owner(
                                tombstone_frac=rc.compact_tombstone_frac
                            )
                        )
                    self.segment_compactor.tick(owners)
                if (
                    self.session_store is not None
                    and now - last_session_sweep >= c.session.store_sweep_interval
                ):
                    # arm a retry/expiry sweep to ride the next serving
                    # launch (the host scan when idle or not fusing)
                    dev2 = self.broker._device
                    self.session_store.tick(
                        fused_path=dev2 is not None
                        and getattr(dev2, "supports_session_fusion", False)
                    )
                    last_session_sweep = now
                if (
                    self.session_persistence is not None
                    and now - last_durability_flush >= c.durability.flush_interval
                ):
                    # non-forced: flush() itself knows when a write is due
                    self.session_persistence.flush()
                    if self.durable_state is not None:
                        self.durable_state.flush()
                    last_durability_flush = now
            except asyncio.CancelledError:
                raise
            except Exception:
                # one bad tick must not kill periodic work for the process
                log.exception("housekeeping tick failed")
