"""Per-client session state (reference: apps/emqx/src/emqx_session.erl):
the port's copy of `Session` and `SessionConfig`
(emqx_tpu/broker/session.py).

Holds subscriptions, the inflight window, the bounded mqueue, the QoS2
awaiting_rel set and the packet-id counter. Pure state machine, no I/O:
`deliver` returns the Publish packets to send; acks mutate the window and
release queued messages.

With a `store` (`broker.session_store.SessionStore`) the session attaches
a slot and its window is the store's `StoreInflight`: every inflight
mutation, and `await_rel` / `release_rel` / `retry`, also writes through
to the device session table, whose op-log rides the broker's next launch
(`Broker.adispatch_begin`). The dict view stays authoritative for the
live session, so a store-backed session sends exactly what a plain one
sends.

`SessionConfig` carries every field of the reference's: the await-rel
timeout the channel's tick reads, the expiry interval the channel and the
channel manager (broker/cm.py) read, and the device-store knobs the app
(app.py) reads.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from emqx_tpu_torch.broker.inflight import Inflight
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.broker.mqueue import MQueue
from emqx_tpu_torch.mqtt import packet as pkt


@dataclass
class SessionConfig:
    max_inflight: int = 32
    max_mqueue: int = 1000
    retry_interval: float = 30.0
    await_rel_timeout: float = 300.0
    max_awaiting_rel: int = 100
    # default persistence for v3.1.1 clean_session=0 clients (the reference
    # defaults to 2h); v5 clients override via Session-Expiry-Interval, and
    # clean-start v4 sessions are forced to 0 by the channel manager
    expiry_interval: float = 7200.0
    # device-resident session store (broker/session_store.py): inflight
    # windows + QoS state land on segment tables, ack clears fuse into
    # serving launches, retry scans become device sweeps. Off = the
    # host-dict path alone (also the degrade-ladder fallback when on)
    device_store: bool = False
    # initial (slot, packet-id) row capacity; grows by doubling
    store_capacity: int = 4096
    # compact width of the device retry/expiry sweep (pow2-rounded);
    # uncapped counts tell the store when a flood needs a second sweep
    store_sweep_slots: int = 1024
    # how often housekeeping arms a sweep / runs the host fallback scan
    store_sweep_interval: float = 5.0


class Session:
    def __init__(
        self,
        client_id: str,
        config: SessionConfig = SessionConfig(),
        store=None,
    ):
        """`store`: an optional `broker.session_store.SessionStore`; when
        given, inflight and awaiting-rel state writes through to its
        table (the dict view stays authoritative for this live session)."""
        self.client_id = client_id
        self.config = dataclasses.replace(config)  # per-session copy
        self.created_at = time.time()
        self.subscriptions: Dict[str, pkt.SubOpts] = {}
        self.store = store
        if store is not None:
            self.store_slot = store.attach(client_id)
            self.inflight = store.make_inflight(
                self.store_slot, config.max_inflight
            )
        else:
            self.store_slot = None
            self.inflight = Inflight(config.max_inflight)
        self.mqueue = MQueue(config.max_mqueue)
        self.awaiting_rel: Dict[int, float] = {}  # incoming QoS2 packet ids
        self._next_pid = 1

    # -- packet ids -------------------------------------------------------
    def alloc_packet_id(self) -> int:
        while True:
            pid = self._next_pid
            self._next_pid = pid % 65535 + 1
            if not self.inflight.contains(pid):
                return pid

    # -- outgoing (broker -> client) --------------------------------------
    def deliver(
        self, msg: Message, opts: Optional[pkt.SubOpts] = None
    ) -> List[pkt.Publish]:
        """Accept one routed message; return PUBLISH packets ready to send."""
        qos = min(msg.qos, opts.qos) if opts else msg.qos
        # MQTT spec: forwarded messages carry retain=0 unless the subscription
        # set retain-as-published; retained-store replays keep retain=1
        retain = (
            msg.retain
            if (opts and opts.retain_as_published)
            else bool(msg.headers.get("retained"))
        )
        msg = self._adjust(msg, qos, retain)
        if qos == 0:
            return [self._publish_packet(msg, 0, None)]
        if self.inflight.is_full():
            self.mqueue.in_(msg)
            return []
        pid = self.alloc_packet_id()
        self.inflight.insert(pid, msg)
        return [self._publish_packet(msg, qos, pid)]

    def _adjust(self, msg: Message, qos: int, retain: bool) -> Message:
        if msg.qos == qos and msg.retain == retain:
            return msg
        m = copy.copy(msg)
        m.qos = qos
        m.retain = retain
        return m

    def _publish_packet(
        self, msg: Message, qos: int, pid: Optional[int], dup: bool = False
    ) -> pkt.Publish:
        return pkt.Publish(
            topic=msg.topic,
            payload=msg.payload,
            qos=qos,
            retain=msg.retain,
            dup=dup,
            packet_id=pid,
            properties=dict(msg.properties),
        )

    def puback(
        self, packet_id: int
    ) -> Tuple[Optional[Message], List[pkt.Publish]]:
        """QoS1 ack; returns (acked msg | None, replacement publishes)."""
        e = self.inflight.delete(packet_id)
        return (e.msg if e is not None else None), self._drain()

    def pubrec(self, packet_id: int) -> bool:
        """QoS2 phase 1 ack'd by receiver -> move to rel phase."""
        e = self.inflight.get(packet_id)
        if e is None or e.phase != "publish":
            return False
        self.inflight.update(packet_id, "pubrel")
        return True

    def pubcomp(
        self, packet_id: int
    ) -> Tuple[Optional[Message], List[pkt.Publish]]:
        e = self.inflight.delete(packet_id)
        ok = e is not None and e.phase == "pubrel"
        return (e.msg if ok else None), self._drain()

    def _drain(self) -> List[pkt.Publish]:
        out: List[pkt.Publish] = []
        while not self.inflight.is_full():
            msg = self.mqueue.out()
            if msg is None:
                break
            pid = self.alloc_packet_id()
            self.inflight.insert(pid, msg)
            out.append(self._publish_packet(msg, msg.qos, pid))
        return out

    # -- incoming QoS2 (client -> broker) ---------------------------------
    def await_rel(self, packet_id: int) -> bool:
        """Track an incoming QoS2 publish until PUBREL; False if duplicate.
        Stamps are monotonic (expiry is an elapsed-time question)."""
        if packet_id in self.awaiting_rel:
            return False
        if len(self.awaiting_rel) >= self.config.max_awaiting_rel:
            raise OverflowError("max_awaiting_rel")
        self.awaiting_rel[packet_id] = time.monotonic()
        if self.store is not None:
            self.store.await_rel(self.store_slot, packet_id)
        return True

    def release_rel(self, packet_id: int) -> bool:
        ok = self.awaiting_rel.pop(packet_id, None) is not None
        if ok and self.store is not None:
            self.store.release_rel(self.store_slot, packet_id)
        return ok

    # -- retry ------------------------------------------------------------
    def retry(self) -> List[pkt.Packet]:
        """Retransmit inflight entries older than retry_interval."""
        out: List[pkt.Packet] = []
        for pid, e in self.inflight.retry_due(self.config.retry_interval):
            if e.phase == "publish" and e.msg is not None:
                out.append(self._publish_packet(e.msg, e.msg.qos, pid, dup=True))
            else:
                rel = pkt.PubAck(packet_id=pid)
                rel.type = pkt.PUBREL
                out.append(rel)
            e.ts = time.monotonic()
            if self.store is not None:
                self.store.touch_inflight(self.store_slot, pid)
        return out

    # -- takeover ---------------------------------------------------------
    def replay(self) -> List[pkt.Packet]:
        """All inflight packets re-sent after takeover/resume (dup=True)."""
        out: List[pkt.Packet] = []
        for pid, e in self.inflight.items():
            if e.phase == "publish" and e.msg is not None:
                out.append(self._publish_packet(e.msg, e.msg.qos, pid, dup=True))
            else:
                rel = pkt.PubAck(packet_id=pid)
                rel.type = pkt.PUBREL
                out.append(rel)
        return out + self._drain()
