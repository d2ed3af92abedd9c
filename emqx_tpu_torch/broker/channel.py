"""MQTT protocol state machine, transport-agnostic: the port's copy of
`MqttCaps`, `ChannelConfig` and `Channel` (emqx_tpu/broker/channel.py).

Parity with the reference's emqx_channel (apps/emqx/src/emqx_channel.erl):
CONNECT handshake with authentication hook (:303-380), publish pipeline with
authz + QoS1/2 acks (:567-666), SUBSCRIBE/UNSUBSCRIBE (:455-502), deliver ->
session -> outgoing (:806-939), takeover/kick (:1015+), will message, and
the client.*/session.*/message.* hookpoints along the way.

Sans-IO: the transport provides a `sink` with send_packet(p)/close(reason);
timers call `tick()`. The channel never touches sockets, so the same state
machine serves TCP, TLS and in-process tests.

Publishes go through `Broker.apublish_enqueue`: with the app's
`BatchIngest` attached they ride the next device batch, and the acks
settle strictly FIFO through the channel's ack queue. With the device
session store (`session.device_store`) a session's window lives in the
store's `StoreInflight`, and the store's sweeps retransmit through
`_store_resend` / `_store_resend_batch` (the slab serializer's frames).

Trimmed: the reference's worker-fabric seams (the QoS0 raw lane, a
subscribe or session open that the router confirms asynchronously) need
the connection workers (`transport/workers.py`), which the port does not
carry (ROADMAP item 10.3e). MQTT5 enhanced authentication runs only for a
method in `ChannelConfig.enhanced_auth`, which the port's app leaves empty
(SCRAM is refused with the rest of authn), so a CONNECT that names a
method gets "bad authentication method", as the reference's does without
SCRAM configured. The reference's nemesis injection site after the
authenticate fold (`atp`) is a plain trace point here: the port's
tracepoints carry no nemesis.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker import mountpoint as MP
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.session import Session, SessionConfig
from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.mqtt.frame import serialize
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.utils.tracepoints import tp


@dataclass
class MqttCaps:
    """Negotiable capability limits (reference: emqx_mqtt_caps.erl)."""

    max_packet_size: int = 1024 * 1024
    max_clientid_len: int = 65535
    max_topic_levels: int = 128
    max_qos_allowed: int = 2
    retain_available: bool = True
    wildcard_subscription: bool = True
    shared_subscription: bool = True
    max_topic_alias: int = 65535


@dataclass
class ChannelConfig:
    caps: MqttCaps = field(default_factory=MqttCaps)
    session: SessionConfig = field(default_factory=SessionConfig)
    idle_timeout: float = 15.0
    enable_stats: bool = True
    # per-listener topic namespace prefix, ${clientid}/${username}
    # placeholders resolved at CONNECT (emqx_mountpoint.erl parity)
    mountpoint: Optional[str] = None
    # MQTT5 enhanced authentication: Authentication-Method -> authenticator
    # (start/finish state machine, e.g. auth/scram.ScramAuthenticator);
    # reference: emqx_channel enhanced auth + emqx_authn SCRAM mechanism
    enhanced_auth: Dict[str, object] = field(default_factory=dict)


class Channel:
    def __init__(
        self,
        broker: Broker,
        cm,
        sink,
        conninfo: Optional[Dict] = None,
        config: Optional[ChannelConfig] = None,
    ):
        self.broker = broker
        self.cm = cm
        self.sink = sink
        self.hooks: Hooks = broker.hooks
        self.conninfo = conninfo or {}
        self.config = config or ChannelConfig()
        self.state = "idle"
        self._ea = None  # in-flight enhanced-auth exchange
        self.version = pkt.MQTT_V4
        self.client_id = ""
        self.username: Optional[str] = None
        self.keepalive = 0
        self.clean_start = True
        self.session: Optional[Session] = None
        self.will: Optional[pkt.Will] = None
        self.connected_at: Optional[float] = None
        self.disconnect_reason: Optional[str] = None
        self.topic_aliases: Dict[int, str] = {}  # inbound alias -> topic
        # attrs set by auth providers during CONNECT (is_superuser, claims);
        # must persist so later authorize checks see them
        self.auth_attrs: Dict = {}
        # resolved at CONNECT via MP.replvar (placeholders need clientid)
        self.mountpoint: Optional[str] = None
        # pipelined-publish ack queue (active-N analog,
        # emqx_connection.erl:125): entries settle strictly FIFO so acks
        # keep MQTT-4.6.0 ordering even when dispatches resolve out of band
        self._ack_queue: deque = deque()
        self._ack_task: Optional[asyncio.Task] = None
        self._ack_drained: Optional[asyncio.Event] = None
        # hot-path client_info snapshot (see _ci_snapshot)
        self._ci: Optional[Dict] = None

    # -- helpers ----------------------------------------------------------
    def _send(self, p) -> None:
        self.sink.send_packet(p)
        self.broker.metrics.inc("packets.sent")

    def _close(self, reason: str, rc: Optional[int] = None) -> None:
        if rc is not None and self.version == pkt.MQTT_V5 and self.state == "connected":
            self._send(pkt.Disconnect(reason_code=rc))
        self.disconnect_reason = reason
        self.sink.close(reason)

    def client_info(self) -> Dict:
        return {
            "client_id": self.client_id,
            "username": self.username,
            "proto_ver": self.version,
            "clean_start": self.clean_start,
            "keepalive": self.keepalive,
            "mountpoint": self.mountpoint,
            **self.conninfo,
            **self.auth_attrs,
        }

    def _ci_snapshot(self) -> Dict:
        """Read-only client_info for the per-message hot paths (deliver /
        publish-authorize hooks): building the dict fresh per delivery was
        one of the larger host-plane costs. Rebuilt whenever the identity
        attributes change (connect completion, re-auth)."""
        ci = self._ci
        if ci is None:
            ci = self._ci = self.client_info()
        return ci

    # -- inbound dispatch -------------------------------------------------
    async def handle_in(self, p) -> None:
        self.broker.metrics.inc("packets.received")
        t = p.type
        if self.state == "idle":
            if t != pkt.CONNECT:
                return self._close("protocol_error")
            return await self._in_connect(p)
        if self.state == "authenticating":
            # mid enhanced-auth exchange: only AUTH (continue) is legal
            if t != pkt.AUTH:
                return self._close("protocol_error", pkt.RC_PROTOCOL_ERROR)
            return await self._in_auth_continue(p)
        if t == pkt.CONNECT:  # duplicate CONNECT is a protocol error
            return self._close("protocol_error", pkt.RC_PROTOCOL_ERROR)
        if t == pkt.PUBLISH:
            return await self._in_publish(p)
        if t == pkt.PUBACK:
            acked, more = self.session.puback(p.packet_id)
            if acked is not None:
                self.hooks.run("message.acked", self._ci_snapshot(), acked)
                self._delivery_completed(acked)
            for q in more:
                self._send(q)
            return
        if t == pkt.PUBREC:
            if self.session.pubrec(p.packet_id):
                rel = pkt.PubAck(packet_id=p.packet_id)
                rel.type = pkt.PUBREL
                self._send(rel)
            else:
                rel = pkt.PubAck(
                    packet_id=p.packet_id,
                    reason_code=pkt.RC_PACKET_IDENTIFIER_NOT_FOUND,
                )
                rel.type = pkt.PUBREL
                self._send(rel)
            return
        if t == pkt.PUBREL:
            ok = self.session.release_rel(p.packet_id)
            comp = pkt.PubAck(
                packet_id=p.packet_id,
                reason_code=pkt.RC_SUCCESS
                if ok
                else pkt.RC_PACKET_IDENTIFIER_NOT_FOUND,
            )
            comp.type = pkt.PUBCOMP
            self._send(comp)
            return
        if t == pkt.PUBCOMP:
            completed, more = self.session.pubcomp(p.packet_id)
            if completed is not None:
                self.hooks.run("message.acked", self._ci_snapshot(), completed)
                self._delivery_completed(completed)
            for q in more:
                self._send(q)
            return
        if t == pkt.SUBSCRIBE:
            return await self._in_subscribe(p)
        if t == pkt.UNSUBSCRIBE:
            return await self._in_unsubscribe(p)
        if t == pkt.PINGREQ:
            return self._send(pkt.PingResp())
        if t == pkt.DISCONNECT:
            return self._in_disconnect(p)
        if t == pkt.AUTH:
            # MQTT5 re-authentication (spec 4.12.1): allowed when the
            # method is configured; otherwise protocol error
            return await self._in_reauth(p)
        self._close("unexpected_packet")

    async def _in_reauth(self, p) -> None:
        method = p.properties.get("Authentication-Method")
        authenticator = self.config.enhanced_auth.get(method or "")
        if authenticator is None:
            return self._close(
                "auth_not_supported", pkt.RC_BAD_AUTHENTICATION_METHOD
            )
        if p.reason_code == pkt.RC_REAUTHENTICATE:
            r = authenticator.start(
                p.properties.get("Authentication-Data", b"")
            )
            if r[0] != "continue":
                return self._close("reauth_failed", pkt.RC_NOT_AUTHORIZED)
            _, server_first, ea_state = r
            self._ea = (None, None, method, authenticator, ea_state)
            self._send(
                pkt.Auth(
                    reason_code=pkt.RC_CONTINUE_AUTHENTICATION,
                    properties={
                        "Authentication-Method": method,
                        "Authentication-Data": server_first,
                    },
                )
            )
            return
        if p.reason_code == pkt.RC_CONTINUE_AUTHENTICATION and self._ea:
            _, _, ea_method, authenticator, ea_state = self._ea
            if method != ea_method:
                return self._close(
                    "reauth_method_mismatch", pkt.RC_BAD_AUTHENTICATION_METHOD
                )
            r = authenticator.finish(
                ea_state, p.properties.get("Authentication-Data", b"")
            )
            self._ea = None
            if r[0] != "ok":
                return self._close("reauth_failed", pkt.RC_NOT_AUTHORIZED)
            _, server_final, attrs = r
            self.auth_attrs.update(
                {k: v for k, v in attrs.items() if k != "username"}
            )
            self._ci = None  # re-auth may change identity attributes
            self._send(
                pkt.Auth(
                    reason_code=pkt.RC_SUCCESS,
                    properties={
                        "Authentication-Method": method,
                        "Authentication-Data": server_final,
                    },
                )
            )
            return
        self._close("protocol_error", pkt.RC_PROTOCOL_ERROR)

    # -- CONNECT ----------------------------------------------------------
    async def _in_connect(self, p: pkt.Connect) -> None:
        self.version = p.proto_ver
        self.clean_start = p.clean_start
        self.keepalive = p.keepalive
        self.username = p.username
        self.will = p.will
        client_id = p.client_id
        assigned = None
        if not client_id:
            if not p.clean_start and self.version < pkt.MQTT_V5:
                return self._connack_error(pkt.RC_CLIENT_IDENTIFIER_NOT_VALID)
            client_id = assigned = "emqx_tpu_" + secrets.token_hex(8)
        if len(client_id) > self.config.caps.max_clientid_len:
            return self._connack_error(pkt.RC_CLIENT_IDENTIFIER_NOT_VALID)
        self.client_id = client_id

        # MQTT5 enhanced authentication (AUTH exchange before CONNACK,
        # e.g. SCRAM-SHA-256; emqx_channel enhanced auth parity)
        method = (
            p.properties.get("Authentication-Method")
            if self.version == pkt.MQTT_V5
            else None
        )
        if method is not None:
            authenticator = self.config.enhanced_auth.get(method)
            if authenticator is None:
                return self._connack_error(pkt.RC_BAD_AUTHENTICATION_METHOD)
            r = authenticator.start(
                p.properties.get("Authentication-Data", b"")
            )
            if r[0] != "continue":
                return self._connack_error(pkt.RC_NOT_AUTHORIZED)
            _, server_first, ea_state = r
            self._ea = (p, assigned, method, authenticator, ea_state)
            self.state = "authenticating"
            self._send(
                pkt.Auth(
                    reason_code=pkt.RC_CONTINUE_AUTHENTICATION,
                    properties={
                        "Authentication-Method": method,
                        "Authentication-Data": server_first,
                    },
                )
            )
            return
        await self._connect_continue(p, assigned)

    async def _in_auth_continue(self, p: pkt.Auth) -> None:
        stashed, assigned, method, authenticator, ea_state = self._ea
        if p.properties.get("Authentication-Method") != method:
            return self._connack_error(pkt.RC_BAD_AUTHENTICATION_METHOD)
        r = authenticator.finish(
            ea_state, p.properties.get("Authentication-Data", b"")
        )
        if r[0] != "ok":
            await self.hooks.arun(
                "client.connack", self.client_info(), "not_authorized"
            )
            return self._connack_error(pkt.RC_NOT_AUTHORIZED)
        _, server_final, attrs = r
        self._ea = None
        if attrs.get("username") and not self.username:
            self.username = attrs["username"]
        self.auth_attrs.update(
            {k: v for k, v in attrs.items() if k != "username"}
        )
        await self._connect_continue(
            stashed,
            assigned,
            enhanced=True,
            extra_props={
                "Authentication-Method": method,
                "Authentication-Data": server_final,
            },
        )

    async def _connect_continue(
        self, p: pkt.Connect, assigned, enhanced=False, extra_props=None
    ) -> None:
        await self.hooks.arun("client.connect", self.client_info(), p)
        # authenticate fold ALWAYS runs — after enhanced auth too, so the
        # banned/flapping gate (priority 1000) and exhook still apply; the
        # marker tells credential providers the client is already vouched
        creds = (
            {"enhanced_auth": True}
            if enhanced
            else {"password": p.password}
        )
        ci = self.client_info()
        base_keys = set(ci)
        auth = await self.hooks.arun_fold(
            "client.authenticate", (ci, creds), None
        )
        # the await window in which a concurrent same-clientid CONNECT
        # can kick this channel (_gone() guards below)
        tp("channel.authenticated", cid=self.client_id)
        # keep provider-set attrs (is_superuser, jwt claims) for the
        # channel's lifetime — authorize checks read them every packet
        self.auth_attrs.update(
            {k: v for k, v in ci.items() if k not in base_keys}
        )
        if isinstance(auth, dict) and auth.get("result") == "deny":
            await self.hooks.arun(
                "client.connack", self.client_info(), "not_authorized"
            )
            return self._connack_error(
                auth.get("reason_code", pkt.RC_NOT_AUTHORIZED)
            )

        self.mountpoint = MP.replvar(
            self.config.mountpoint, self.client_info()
        )
        session, present = self.cm.open_session(self)
        self.session = session
        if self.version == pkt.MQTT_V5:
            # v5 default expiry is 0 unless the client asks otherwise
            session.config.expiry_interval = p.properties.get(
                "Session-Expiry-Interval", 0
            )
        elif self.clean_start:
            session.config.expiry_interval = 0
        self.state = "connected"
        self.connected_at = time.time()
        self._ci = None  # identity finalized: next hot-path use snapshots
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5:
            if assigned:
                props["Assigned-Client-Identifier"] = assigned
            props["Shared-Subscription-Available"] = 1
            props["Wildcard-Subscription-Available"] = 1
            props["Retain-Available"] = int(self.config.caps.retain_available)
            if extra_props:
                props.update(extra_props)  # enhanced-auth server-final
        await self.hooks.arun("client.connack", self.client_info(), "success")
        if self._gone(session):
            return  # kicked during the awaited hook (takeover race)
        tp("channel.connack", cid=self.client_id, present=present)
        self._send(
            pkt.Connack(
                session_present=present,
                reason_code=pkt.RC_SUCCESS
                if self.version == pkt.MQTT_V5
                else pkt.CONNACK_ACCEPT,
                properties=props,
            )
        )
        await self.hooks.arun("client.connected", self.client_info(), self)
        if self._gone(session):
            return
        if present:
            for q in self.session.replay():
                self._send(q)

    def _gone(self, session) -> bool:
        """True when this channel lost its session while awaiting a hook
        (a concurrent same-clientid CONNECT kicked/takeover'd us — the
        awaits in the async pipeline reopened the window the reference
        closes with per-clientid global locks, emqx_cm.erl:245-273)."""
        return self.session is not session or self.state == "disconnected"

    def _connack_error(self, rc: int) -> None:
        from emqx_tpu_torch.mqtt import reason_codes as RC

        code = rc if self.version == pkt.MQTT_V5 else pkt.connack_compat(rc)
        self._send(pkt.Connack(session_present=False, reason_code=code))
        # close reason carries the spec name (emqx_reason_codes:name/1),
        # which is what traces / client.disconnected hooks surface
        self._close(f"connack_{RC.name(rc)}")

    # -- PUBLISH ----------------------------------------------------------
    async def _in_publish(self, p: pkt.Publish) -> None:
        topic = p.topic
        # MQTT5 topic alias resolution (emqx_channel packet pipeline :567-576)
        alias = p.properties.get("Topic-Alias") if self.version == pkt.MQTT_V5 else None
        if alias is not None:
            if alias == 0 or alias > self.config.caps.max_topic_alias:
                return self._close("topic_alias_invalid", pkt.RC_TOPIC_ALIAS_INVALID)
            if topic:
                self.topic_aliases[alias] = topic
            else:
                topic = self.topic_aliases.get(alias)
                if topic is None:
                    return self._close(
                        "unknown_topic_alias", pkt.RC_PROTOCOL_ERROR
                    )
        try:
            T.validate(topic, kind="name")
        except T.TopicValidationError:
            return self._close("invalid_topic", pkt.RC_TOPIC_NAME_INVALID)
        if len(T.words(topic)) > self.config.caps.max_topic_levels:
            return self._close("too_many_levels", pkt.RC_TOPIC_NAME_INVALID)
        if p.qos > self.config.caps.max_qos_allowed:
            return self._close("qos_not_supported", pkt.RC_QOS_NOT_SUPPORTED)
        if p.retain and not self.config.caps.retain_available:
            return self._close("retain_disabled", pkt.RC_RETAIN_NOT_SUPPORTED)

        allowed = await self.hooks.arun_fold(
            "client.authorize", (self._ci_snapshot(), "publish", topic),
            "allow",
        )
        if allowed != "allow":
            self.broker.metrics.inc("messages.dropped.not_authorized")
            if allowed == "disconnect":
                # authz deny_action=disconnect (reference knob): drop the
                # packet and close the connection
                return self._close("not_authorized", pkt.RC_NOT_AUTHORIZED)
            if p.qos == 0:
                return  # silently drop (emqx default for qos0 deny)
            ack = pkt.PubAck(
                packet_id=p.packet_id, reason_code=pkt.RC_NOT_AUTHORIZED
            )
            ack.type = pkt.PUBACK if p.qos == 1 else pkt.PUBREC
            # through the ack queue: earlier pipelined publishes must ack first
            return self._enqueue_ack(0, lambda n: self._send(ack))

        if self.session is None or self.state != "connected":
            return  # kicked while awaiting the authorize hook
        msg = Message(
            topic=MP.mount(self.mountpoint, topic),
            payload=p.payload,
            qos=p.qos,
            retain=p.retain,
            from_client=self.client_id,
            from_username=self.username,
            properties={
                k: v for k, v in p.properties.items() if k != "Topic-Alias"
            },
        )
        if p.qos == 0:
            r = await self._publish_pipelined(msg)
            if not isinstance(r, int):
                self._enqueue_ack(r)
            return
        if p.qos == 1:
            r = await self._publish_pipelined(msg)
            pid = p.packet_id
            return self._enqueue_ack(
                r, lambda n: self._send_pub_ack(pid, n, pkt.PUBACK)
            )
        # QoS2: publish on first sight of the packet id, dedupe on DUP resend
        try:
            fresh = self.session.await_rel(p.packet_id)
        except OverflowError:
            return self._close("receive_max", pkt.RC_RECEIVE_MAXIMUM_EXCEEDED)
        pid = p.packet_id
        send_rec = lambda n: self._send_pub_ack(pid, n, pkt.PUBREC)  # noqa: E731
        if fresh:
            r = await self._publish_pipelined(msg)
            # on dispatch failure the dedup record must be rolled back, or
            # the client's retransmit would be "DUP"-acked without the
            # message ever publishing (silent QoS2 loss)
            sess = self.session
            self._enqueue_ack(
                r, send_rec, on_fail=lambda: sess.release_rel(pid)
            )
        else:
            self._enqueue_ack(-1, send_rec)  # dup: never no-subscribers rc

    # active-N analog (emqx_connection.erl:125 ?ACTIVE_N): how many
    # publishes one channel may have riding the batch window before the
    # read path stalls awaiting the oldest dispatch (backpressure)
    PUB_PIPELINE_MAX = 100

    async def _publish_pipelined(self, msg: Message):
        """Enqueue to the batch ingest without awaiting dispatch (returns a
        future). At the pipeline cap, stall the read path until the ack
        drainer catches up — ordering is preserved either way."""
        while len(self._ack_queue) >= self.PUB_PIPELINE_MAX:
            self._ack_drained = asyncio.Event()
            await self._ack_drained.wait()
        return await self.broker.apublish_enqueue(msg)

    def _send_pub_ack(self, packet_id: int, n: int, ack_type: int) -> None:
        rc = pkt.RC_SUCCESS
        if n == 0 and self.version == pkt.MQTT_V5:
            rc = pkt.RC_NO_MATCHING_SUBSCRIBERS
        ack = pkt.PubAck(packet_id=packet_id, reason_code=rc)
        ack.type = ack_type
        self._send(ack)

    def _enqueue_ack(self, r, send=None, on_fail=None) -> None:
        """Settle a publish through the FIFO ack queue.

        `r` is an int (already dispatched) or a future. `send(n)` emits the
        ack; `on_fail()` rolls back state if the dispatch errored. The fast
        path (resolved result, empty queue) acks inline; otherwise a single
        drainer task per channel settles entries strictly in order.
        """
        # inline fast path ONLY when nothing is pending anywhere: the
        # drainer holds its current entry OUTSIDE the queue while awaiting,
        # so an empty queue alone doesn't mean order-safe
        if (
            isinstance(r, int)
            and not self._ack_queue
            and (self._ack_task is None or self._ack_task.done())
        ):
            if send is not None:
                send(r)
            return
        self._ack_queue.append((r, send, on_fail))
        if self._ack_task is None or self._ack_task.done():
            self._ack_task = asyncio.ensure_future(self._drain_acks())

    async def _drain_acks(self) -> None:
        while self._ack_queue:
            r, send, on_fail = self._ack_queue.popleft()
            if isinstance(r, int):
                n = r
            else:
                try:
                    n = await r
                except Exception:
                    # dispatch failed inside the flusher; roll back and let
                    # the client retransmit
                    self.broker.metrics.inc("messages.dispatch_error")
                    if on_fail is not None:
                        try:
                            on_fail()
                        except Exception:
                            pass
                    self._signal_drained()
                    continue
            self._signal_drained()
            if send is None or self.state != "connected":
                continue
            try:
                send(n)
            except Exception:
                pass  # transport already torn down

    def _signal_drained(self) -> None:
        if self._ack_drained is not None:
            self._ack_drained.set()
            self._ack_drained = None

    # -- SUBSCRIBE / UNSUBSCRIBE ------------------------------------------
    async def _in_subscribe(self, p: pkt.Subscribe) -> None:
        # fold so extensions (topic rewrite) can transform the filter list
        filters = await self.hooks.arun_fold(
            "client.subscribe", (self.client_info(),), p.filters
        )
        # embedding filter riding the SUBSCRIBE user properties
        # (docs/semantic_routing.md): packet-level, applies to every
        # filter in the packet; malformed embeddings degrade to a plain
        # subscribe (counted) rather than failing the packet
        sem_parsed = None
        sem = getattr(self.broker, "semantic", None)
        if sem is not None and p.properties:
            try:
                sem_parsed = sem.parse_subscribe(p.properties)
            except (ValueError, TypeError):
                self.broker.metrics.inc("semantic.subscribe.rejected")
        rcs: List[int] = []
        for f, opts in filters:
            try:
                T.validate(f)
                group, real = T.parse_share(f)
                if group is not None and not self.config.caps.shared_subscription:
                    rcs.append(pkt.RC_SHARED_SUBSCRIPTIONS_NOT_SUPPORTED)
                    continue
                if T.wildcard(real if group else f) and not self.config.caps.wildcard_subscription:
                    rcs.append(pkt.RC_WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED)
                    continue
            except T.TopicValidationError:
                rcs.append(pkt.RC_TOPIC_FILTER_INVALID)
                continue
            allowed = await self.hooks.arun_fold(
                "client.authorize", (self.client_info(), "subscribe", f), "allow"
            )
            if allowed != "allow":
                if allowed == "disconnect":
                    # authz deny_action=disconnect applies to subscribe too
                    return self._close(
                        "not_authorized", pkt.RC_NOT_AUTHORIZED
                    )
                rcs.append(pkt.RC_NOT_AUTHORIZED)
                continue
            if self.session is None or self.state != "connected":
                return  # kicked while awaiting the authorize hook
            qos = min(opts.qos, self.config.caps.max_qos_allowed)
            opts.qos = qos
            mf = MP.mount(self.mountpoint, f)
            # for retain_handling=1 semantics
            opts._existing = mf in self.session.subscriptions
            sub_kw = {}
            if sem_parsed is not None:
                sub_kw["embedding"] = sem_parsed[0]
                sub_kw["sem_threshold"] = sem_parsed[1]
            self.broker.subscribe(
                self.client_id, self.client_id, mf, opts,
                self._make_deliverer(opts), **sub_kw,
            )
            self.session.subscriptions[mf] = opts
            await self.hooks.arun(
                "session.subscribed", self.client_info(), mf, opts, self
            )
            rcs.append(qos)  # granted qos == success codes 0..2
        self._send(pkt.Suback(packet_id=p.packet_id, reason_codes=rcs))

    def _make_deliverer(self, opts: pkt.SubOpts):
        def deliver(msg: Message, subopts: pkt.SubOpts) -> None:
            self.handle_deliver(msg, subopts)

        return deliver

    async def _in_unsubscribe(self, p: pkt.Unsubscribe) -> None:
        filters = await self.hooks.arun_fold(
            "client.unsubscribe", (self.client_info(),), p.filters
        )
        if self.session is None or self.state != "connected":
            return  # kicked while awaiting the unsubscribe hook
        rcs: List[int] = []
        for f in filters:
            mf = MP.mount(self.mountpoint, f)
            existed = self.broker.unsubscribe(self.client_id, mf)
            self.session.subscriptions.pop(mf, None)
            if existed:
                await self.hooks.arun("session.unsubscribed", self.client_info(), mf)
                rcs.append(pkt.RC_SUCCESS)
            else:
                rcs.append(pkt.RC_NO_SUBSCRIPTION_EXISTED)
        self._send(pkt.Unsuback(packet_id=p.packet_id, reason_codes=rcs))

    # -- DISCONNECT / close ------------------------------------------------
    def _in_disconnect(self, p: pkt.Disconnect) -> None:
        if p.reason_code == pkt.RC_SUCCESS:
            self.will = None  # normal disconnect discards the will
        expiry = p.properties.get("Session-Expiry-Interval")
        if expiry is not None and self.session is not None:
            self.session.config.expiry_interval = expiry
        self.state = "disconnected"
        self._close("normal")

    async def on_sock_closed(self, reason: str = "sock_closed") -> None:
        """Transport-level close (also the abnormal path: publish will)."""
        if self.state == "idle":
            return
        was_connected = self.state == "connected"
        self.state = "disconnected"
        try:
            if was_connected and self.will is not None:
                # apublish: the will is client-originated traffic, so it
                # must pass the same async extension chain (exhook
                # deny/rewrite) as an ordinary PUBLISH
                await self._publish_will()
            await self.hooks.arun(
                "client.disconnected",
                self.client_info(),
                self.disconnect_reason or reason,
            )
        finally:
            # registry cleanup must survive task cancellation mid-await
            # (listener.stop cancels connection tasks in their finally)
            self.cm.on_channel_closed(self, reason)

    async def _publish_will(self) -> None:
        w = self.will
        self.will = None
        try:
            T.validate(w.topic, kind="name")
        except T.TopicValidationError:
            return
        await self.broker.apublish(
            Message(
                topic=MP.mount(self.mountpoint, w.topic),
                payload=w.payload,
                qos=w.qos,
                retain=w.retain,
                from_client=self.client_id,
                properties=dict(w.properties),
            )
        )

    # -- outbound deliveries ----------------------------------------------
    def handle_deliver(self, msg: Message, opts: pkt.SubOpts) -> None:
        if self.mountpoint and msg.topic.startswith(self.mountpoint):
            # unmount on the way out (emqx_channel.erl:970-976)
            import copy

            msg = copy.copy(msg)
            msg.topic = MP.unmount(self.mountpoint, msg.topic)
        if self.state != "connected" or self.session is None:
            # connection-less window (e.g. between takeover begin/end):
            # park in the session queue for replay
            if self.session is not None and msg.qos > 0:
                self.session.mqueue.in_(msg)
            return
        # QoS0 fan-out fast path: serialize ONCE per (version, retain,
        # topic) and write the same bytes to every subscriber socket —
        # per-subscriber Publish construction + serialization was a top
        # per-delivery cost with fan-out 8 (the cache rides the Message
        # object, shared across its mount-variant copies)
        # retained-store replays are EXCLUDED: those Message objects live
        # as long as the store, and the cache would pin one serialized
        # copy per (version, retain, topic) variant against each of
        # millions of stored messages
        qos0 = (
            msg.qos == 0 or (opts is not None and opts.qos == 0)
        ) and not msg.headers.get("retained")
        sb = getattr(self.sink, "send_bytes", None)
        if qos0 and sb is not None:
            retain = (
                msg.retain
                if (opts is not None and opts.retain_as_published)
                else bool(msg.headers.get("retained"))
            )
            fb = getattr(msg, "_fb", None)
            if fb is None:
                fb = {}
                msg._fb = fb
            key = (self.version, retain, msg.topic)
            buf = fb.get(key)
            if buf is None:
                buf = fb[key] = serialize(
                    pkt.Publish(
                        topic=msg.topic,
                        payload=msg.payload,
                        qos=0,
                        retain=retain,
                        packet_id=None,
                        properties=dict(msg.properties),
                    ),
                    self.version,
                )
            self.hooks.run("message.delivered", self._ci_snapshot(), msg)
            sb(buf)
            self.broker.metrics.inc("packets.sent")
            self._delivery_completed(msg)
            return
        out = self.session.deliver(msg, opts)
        for q in out:
            self.hooks.run("message.delivered", self._ci_snapshot(), msg)
            if not (
                q.type == pkt.PUBLISH
                and q.qos
                and q.packet_id
                and not q.dup
                and self._send_pub_split(msg, q)
            ):
                self._send(q)
            if q.type == pkt.PUBLISH and q.qos == 0:
                # QoS0 completes at send; QoS1/2 complete at PUBACK/PUBCOMP
                # ('delivery.completed' hook, emqx_slow_subs.erl:25 parity)
                self._delivery_completed(msg)

    def _send_pub_split(self, msg: Message, q) -> bool:
        """QoS1/2 fan-out fast path: serialize the PUBLISH ONCE per
        (version, qos, retain, topic) as a head/tail pair around the
        packet-id slot (mqtt/slab_serializer.split_publish — bytes
        identical to frame.serialize) and emit each subscriber's frame
        as writelines([head, pid, tail]) — the payload is never copied
        per target. The cache rides the Message like the QoS0 `_fb`
        cache; retained-store replays are excluded for the same
        lifetime reason. Returns False to fall back to `_send`."""
        ws = getattr(self.sink, "send_segments", None)
        if ws is None or msg.headers.get("retained"):
            return False
        from emqx_tpu_torch.mqtt import slab_serializer as SS

        fbq = getattr(msg, "_fbq", None)
        if fbq is None:
            fbq = {}
            msg._fbq = fbq
        key = (self.version, q.qos, q.retain, q.topic)
        ent = fbq.get(key)
        if ent is None:
            tb = q.topic.encode("utf-8")
            if len(tb) > 0xFFFF:
                return False  # _send raises the codec's exact error
            ent = fbq[key] = SS.split_publish(
                tb, q.payload, q.qos, q.retain, False, self.version,
                q.properties,
            )
        head, tail = ent
        ws([head, SS.pid_bytes(q.packet_id), tail])
        self.broker.metrics.inc("packets.sent")
        self.broker.metrics.inc("dispatch.serialize.frames")
        return True

    def _delivery_completed(self, msg: Message) -> None:
        self.hooks.run(
            "delivery.completed",
            self._ci_snapshot(),
            msg,
            time.time() - msg.timestamp,
        )

    # -- timers ------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """Periodic work: QoS retry + awaiting_rel expiry. `now` is a
        monotonic-clock reading (elapsed-time questions only — wall
        steps must not mass-expire windows)."""
        if self.session is None:
            return
        if not self.session.inflight.store_managed:
            # store-managed windows retransmit from the session store's
            # sweep (device scan riding a launch, or the host fallback)
            # through _store_resend — never from a per-channel walk
            for q in self.session.retry():
                self._send(q)
        now = now or time.monotonic()
        timeout = self.session.config.await_rel_timeout
        expired = [
            pid
            for pid, ts in self.session.awaiting_rel.items()
            if now - ts > timeout
        ]
        for pid in expired:
            self.session.release_rel(pid)

    def _store_resend(self, pid: int, state: int, msg) -> bool:
        """Redelivery sink for the session store's retry sweeps: dup
        PUBLISH for the publish phase, PUBREL for the rel phase. Returns
        False (no stamp refresh) when this channel can't transmit."""
        if self.state != "connected" or self.session is None:
            return False
        from emqx_tpu_torch.ops.session_table import ST_PUBREL

        if state == ST_PUBREL:
            rel = pkt.PubAck(packet_id=pid)
            rel.type = pkt.PUBREL
            self._send(rel)
            return True
        if msg is None:
            return False
        self._send(
            self.session._publish_packet(msg, msg.qos, pid, dup=True)
        )
        return True

    def _store_resend_batch(self, items) -> List[bool]:
        """Batched twin of `_store_resend` for the session store's sweep
        floods: ALL of this channel's due rows serialize in ONE slab
        pass (mqtt/slab_serializer — vectorized headers/varints, frames
        byte-identical to the per-packet path) and land on the socket as
        a `writelines` of memoryviews. Returns per-item sent flags (all
        False when the channel can't transmit)."""
        if self.state != "connected" or self.session is None:
            return [False] * len(items)
        from emqx_tpu_torch.mqtt import slab_serializer as SS
        from emqx_tpu_torch.ops.session_table import ST_PUBREL

        sent = [True] * len(items)
        pubs = []  # (item index, serializer tuple)
        segs: List = []  # per-frame segments in item order
        seg_slot: List[int] = []  # index into segs for each publish
        v5 = self.version == pkt.MQTT_V5
        for i, (pid, state, msg) in enumerate(items):
            if state == ST_PUBREL:
                segs.append(SS.pubrel_frame(pid))
                continue
            if msg is None:
                sent[i] = False
                continue
            pb = None
            if v5:
                props = getattr(msg, "properties", None)
                pb = SS.encode_properties(props) if props else None
            pubs.append(
                (msg.topic_bytes(), msg.payload_view(), msg.qos,
                 msg.retain, True, pid, pb)  # dup=True: retransmit
            )
            seg_slot.append(len(segs))
            segs.append(None)  # patched with the slab view below
        if pubs:
            slab, offs = SS.serialize_pub_slab(pubs, self.version)
            for k, mv in enumerate(SS.frames_of(slab, offs)):
                segs[seg_slot[k]] = mv
        segs = [s for s in segs if s is not None]
        if not segs:
            return sent
        ws = getattr(self.sink, "send_segments", None)
        try:
            if ws is not None:
                ws(segs)
            else:
                self.sink.send_bytes(b"".join(segs))
        except Exception:
            return [False] * len(items)
        m = self.broker.metrics
        m.inc("packets.sent", len(segs))
        m.inc("dispatch.serialize.batches")
        m.inc("dispatch.serialize.frames", len(segs))
        m.inc("dispatch.serialize.bytes", sum(len(s) for s in segs))
        return sent

    # -- takeover / kick ---------------------------------------------------
    def kick(self, reason: str) -> Optional[Session]:
        """Forcibly close; returns the session for takeover if requested."""
        session = self.session
        if self.state == "connected":
            rc = (
                pkt.RC_SESSION_TAKEN_OVER
                if reason == "takenover"
                else pkt.RC_ADMINISTRATIVE_ACTION
            )
            if self.version == pkt.MQTT_V5:
                self._send(pkt.Disconnect(reason_code=rc))
        self.state = "disconnected"
        self.disconnect_reason = reason
        self.session = None
        self.sink.close(reason)
        return session
