"""Asyncio MQTT client (the reference tests drive the broker with the real
`emqtt` client — apps/emqx/rebar.config:36; this is that role here: a small,
spec-honest client for conformance tests, benchmarks and tooling).

Supports v3.1.1/v5: connect/subscribe/unsubscribe/publish QoS0-2 (full
QoS2 handshake both directions), ping, will, incoming-message queue.

The port's copy of `emqx_tpu/mqtt/client.py`, over TCP and TLS: its API
is the reference's. Deliveries arrive in `client.messages` (an
`asyncio.Queue`) and through `await client.recv(timeout)`, whose default
timeout is 5 s: a longer wait passes its own timeout to `recv` (an outer
`asyncio.wait_for` does not lift it). The WebSocket transport is not
ported (ROADMAP item 10.3e).
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple

from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.mqtt.frame import Parser, serialize


class MqttError(Exception):
    pass


def _insecure_client_ctx():
    """No-verify TLS context (test/tooling default, like `emqtt`'s
    verify_none); pass an explicit `ssl=` context for real deployments."""
    import ssl as ssl_mod

    ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl_mod.CERT_NONE
    return ctx


class Client:
    def __init__(
        self,
        client_id: str = "",
        version: int = pkt.MQTT_V4,
        clean_start: bool = True,
        keepalive: int = 60,
        username: Optional[str] = None,
        password: Optional[bytes] = None,
        will: Optional[pkt.Will] = None,
        properties: Optional[dict] = None,
    ):
        self.client_id = client_id
        self.version = version
        self.clean_start = clean_start
        self.keepalive = keepalive
        self.username = username
        self.password = password
        self.will = will
        self.conn_properties = properties or {}
        self.messages: asyncio.Queue = asyncio.Queue()
        self.connack: Optional[pkt.Connack] = None
        self.disconnect_packet: Optional[pkt.Disconnect] = None
        self._reader = None
        self._writer = None
        self._parser = Parser(version=version)
        self._pid = 0
        self._pending: Dict[Tuple[int, int], asyncio.Future] = {}
        self._await_rel: set = set()
        self._reader_task: Optional[asyncio.Task] = None
        self.closed = asyncio.Event()

    def _next_pid(self) -> int:
        self._pid = self._pid % 65535 + 1
        return self._pid

    async def connect(
        self,
        host: str = "127.0.0.1",
        port: int = 1883,
        timeout: float = 5.0,
        transport: str = "tcp",
        ssl: object = None,
    ):
        if transport in ("tcp", "ssl"):
            if transport == "ssl" and ssl is None:
                ssl = _insecure_client_ctx()
            self._reader, self._writer = await asyncio.open_connection(
                host, port, ssl=ssl
            )
        else:
            raise ValueError(
                f"unsupported transport {transport!r} (tcp|ssl; the "
                "WebSocket transport is not ported)"
            )
        self._send(
            pkt.Connect(
                proto_ver=self.version,
                clean_start=self.clean_start,
                keepalive=self.keepalive,
                client_id=self.client_id,
                username=self.username,
                password=self.password,
                will=self.will,
                properties=self.conn_properties,
            )
        )
        fut = asyncio.get_event_loop().create_future()
        self._pending[(pkt.CONNACK, 0)] = fut
        self._reader_task = asyncio.ensure_future(self._read_loop())
        self.connack = await asyncio.wait_for(fut, timeout)
        ok = (
            self.connack.reason_code == 0
        )
        if not ok:
            raise MqttError(f"connack error: {self.connack.reason_code:#x}")
        return self.connack

    def _send(self, p) -> None:
        self._writer.write(serialize(p, self.version))

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(65536)
                if not data:
                    break
                for p in self._parser.feed(data):
                    self._handle(p)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self.closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(MqttError("connection closed"))
            self._pending.clear()

    def _handle(self, p) -> None:
        # sync on purpose: the inbox queue is unbounded (put never
        # blocks), and an await per inbound packet dominated receiver
        # CPU under delivery floods
        t = p.type
        if t == pkt.CONNACK:
            self._resolve((pkt.CONNACK, 0), p)
        elif t == pkt.PUBLISH:
            if p.qos == 0:
                self.messages.put_nowait(p)
            elif p.qos == 1:
                self.messages.put_nowait(p)
                self._send(pkt.PubAck(packet_id=p.packet_id))
            else:
                if p.packet_id not in self._await_rel:
                    self._await_rel.add(p.packet_id)
                    self.messages.put_nowait(p)
                rec = pkt.PubAck(packet_id=p.packet_id)
                rec.type = pkt.PUBREC
                self._send(rec)
        elif t == pkt.PUBREL:
            self._await_rel.discard(p.packet_id)
            comp = pkt.PubAck(packet_id=p.packet_id)
            comp.type = pkt.PUBCOMP
            self._send(comp)
        elif t in (pkt.PUBACK, pkt.PUBCOMP):
            self._resolve((t, p.packet_id), p)
        elif t == pkt.PUBREC:
            rel = pkt.PubAck(packet_id=p.packet_id)
            rel.type = pkt.PUBREL
            self._send(rel)
        elif t in (pkt.SUBACK, pkt.UNSUBACK):
            self._resolve((t, p.packet_id), p)
        elif t == pkt.PINGRESP:
            self._resolve((pkt.PINGRESP, 0), p)
        elif t == pkt.DISCONNECT:
            self.disconnect_packet = p

    def _resolve(self, key, p) -> None:
        fut = self._pending.pop(key, None)
        if fut is not None and not fut.done():
            fut.set_result(p)

    async def _request(self, key, send_pkt, timeout: float = 5.0):
        fut = asyncio.get_event_loop().create_future()
        self._pending[key] = fut
        self._send(send_pkt)
        return await asyncio.wait_for(fut, timeout)

    async def subscribe(
        self, filters, qos: int = 0, timeout: float = 5.0
    ) -> pkt.Suback:
        if isinstance(filters, str):
            filters = [(filters, pkt.SubOpts(qos=qos))]
        elif filters and isinstance(filters[0], str):
            filters = [(f, pkt.SubOpts(qos=qos)) for f in filters]
        pid = self._next_pid()
        return await self._request(
            (pkt.SUBACK, pid),
            pkt.Subscribe(packet_id=pid, filters=list(filters)),
            timeout,
        )

    async def unsubscribe(self, filters, timeout: float = 5.0) -> pkt.Unsuback:
        if isinstance(filters, str):
            filters = [filters]
        pid = self._next_pid()
        return await self._request(
            (pkt.UNSUBACK, pid),
            pkt.Unsubscribe(packet_id=pid, filters=list(filters)),
            timeout,
        )

    async def publish(
        self,
        topic: str,
        payload: bytes = b"",
        qos: int = 0,
        retain: bool = False,
        properties: Optional[dict] = None,
        timeout: float = 5.0,
    ):
        p = pkt.Publish(
            topic=topic,
            payload=payload,
            qos=qos,
            retain=retain,
            properties=properties or {},
        )
        if qos == 0:
            self._send(p)
            # drain only past a buffer high-water mark: an await
            # round-trip per QoS0 publish dominated flood-side CPU
            # (the WS stream adapter has no transport: always drain)
            tr = getattr(self._writer, "transport", None)
            if tr is None or tr.get_write_buffer_size() > 65536:
                await self._writer.drain()
            return None
        p.packet_id = self._next_pid()
        ack_t = pkt.PUBACK if qos == 1 else pkt.PUBCOMP
        return await self._request((ack_t, p.packet_id), p, timeout)

    async def ping(self, timeout: float = 5.0):
        return await self._request((pkt.PINGRESP, 0), pkt.PingReq(), timeout)

    async def recv(self, timeout: float = 5.0) -> pkt.Publish:
        # fast path: a queued message skips the wait_for timeout
        # machinery entirely (it dominated receiver-side CPU in floods)
        try:
            return self.messages.get_nowait()
        except asyncio.QueueEmpty:
            return await asyncio.wait_for(self.messages.get(), timeout)

    async def disconnect(self, reason_code: int = 0) -> None:
        try:
            self._send(pkt.Disconnect(reason_code=reason_code))
            await self._writer.drain()
        except Exception:
            pass
        await self.close()

    async def close(self) -> None:
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass
