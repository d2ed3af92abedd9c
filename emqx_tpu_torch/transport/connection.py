"""Per-connection pump: socket bytes <-> frames <-> channel. The port's
copy of `Connection` (emqx_tpu/transport/connection.py).

Parity with the reference connection process (apps/emqx/src/
emqx_connection.erl: recvloop :356-390, parse->handle :462-493, serialize +
send, keepalive enforcement). The MQTT spec's 1.5x keepalive grace is
enforced here; an idle pre-CONNECT socket is closed after idle_timeout
(emqx_channel idle timer parity).
"""

from __future__ import annotations

import asyncio
import time

from emqx_tpu_torch.broker.channel import Channel, ChannelConfig
from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.mqtt.frame import FrameError, Parser, serialize


class Connection:
    """One connected socket; owns the parser, the channel, and timers."""

    def __init__(self, broker, cm, reader, writer, config: ChannelConfig, ctx=None):
        self.reader = reader
        self.writer = writer
        peer = writer.get_extra_info("peername") or ("?", 0)
        self.channel = Channel(
            broker,
            cm,
            sink=self,
            conninfo={"peerhost": peer[0], "peerport": peer[1]},
            config=config,
        )
        self.parser = Parser(max_size=config.caps.max_packet_size)
        self.last_rx = time.time()
        self._closing = False
        self._tasks: list = []
        # rate limiting / congestion / forced GC (TransportContext wiring)
        self.limiters = None
        self.congestion = None
        self.forced_gc = None
        if ctx is not None:
            if ctx.limiters is not None:
                # None when all types are unlimited -> zero hot-path cost
                self.limiters = ctx.limiters.container(
                    "bytes_in", "message_in"
                )
            if ctx.alarms is not None:
                from emqx_tpu_torch.transport.congestion import Congestion

                self.congestion = Congestion(alarms=ctx.alarms)
            if ctx.make_forced_gc is not None:
                self.forced_gc = ctx.make_forced_gc()

    # -- sink interface used by the channel -------------------------------
    def send_packet(self, p) -> None:
        if self._closing:
            return
        try:
            self.writer.write(serialize(p, self.channel.version))
        except Exception:
            self.close("send_error")

    def send_bytes(self, b: bytes) -> None:
        """Pre-serialized frame (the channel's QoS0 fan-out cache:
        serialize once per message, write to every subscriber socket)."""
        if self._closing:
            return
        try:
            self.writer.write(b)
        except Exception:
            self.close("send_error")

    def send_segments(self, segs) -> None:
        """Pre-serialized frame segments (the batched slab serializer:
        writelines of memoryviews — shared heads/tails and slab frame
        views land on the socket without an intermediate join)."""
        if self._closing:
            return
        try:
            self.writer.writelines(segs)
        except Exception:
            self.close("send_error")

    def close(self, reason: str) -> None:
        if self._closing:
            return
        self._closing = True
        try:
            self.writer.close()
        except Exception:
            pass

    # -- pump --------------------------------------------------------------
    async def run(self) -> None:
        keeper = asyncio.ensure_future(self._keepalive_loop())
        ticker = asyncio.ensure_future(self._tick_loop())
        try:
            while not self._closing:
                data = await self.reader.read(65536)
                if not data:
                    break
                self.last_rx = time.time()
                if self.forced_gc is not None:
                    self.forced_gc.inc(0, len(data))
                if self.limiters is not None:
                    # bytes_in: pause the read loop until tokens accrue
                    # (emqx_connection rate-limit pause, :103-120)
                    await self._limited("bytes_in", len(data))
                try:
                    for p in self.parser.feed(data):
                        if (
                            self.limiters is not None
                            and p.type == pkt.PUBLISH
                        ):
                            await self._limited("message_in", 1)
                        if self.forced_gc is not None:
                            self.forced_gc.inc(1, 0)
                        await self.channel.handle_in(p)
                except FrameError as e:
                    self.channel.disconnect_reason = f"frame_error:{e.reason}"
                    if self.channel.version == pkt.MQTT_V5:
                        self.send_packet(
                            pkt.Disconnect(reason_code=pkt.RC_MALFORMED_PACKET)
                        )
                    break
                await self._drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            keeper.cancel()
            ticker.cancel()
            if self.congestion is not None:
                self.congestion.on_close(self.channel.client_id)
            self.close("sock_closed")
            try:
                await self.writer.wait_closed()
            except Exception:
                pass
            await self.channel.on_sock_closed()

    async def _limited(self, type_: str, n: float) -> None:
        """Charge the limiter and pause for the returned interval.

        The charge always lands (token debt), so sustained throughput
        converges on the configured rate for any chunk size. The pause is
        counted as liveness — the client IS sending, we are throttling it —
        so keepalive must not fire mid-throttle."""
        wait = self.limiters.consume(type_, n)
        # sleep in short slices, refreshing last_rx each one, so keepalive
        # never fires during a long throttle pause (waits reach 60s)
        while wait > 0 and not self._closing:
            step = min(wait, 5.0)
            self.last_rx = time.time()
            await asyncio.sleep(step)
            wait -= step
        self.last_rx = time.time()

    async def _drain(self) -> None:
        try:
            await self.writer.drain()
        except ConnectionError:
            self.close("sock_error")

    async def _keepalive_loop(self) -> None:
        # pre-CONNECT idle timeout (poll so keepalive arms right after CONNECT)
        start = time.time()
        while self.channel.state == "idle":
            if time.time() - start > self.channel.config.idle_timeout:
                self.close("idle_timeout")
                return
            await asyncio.sleep(0.2)
        while not self._closing:
            ka = self.channel.keepalive
            if ka <= 0:
                return
            await asyncio.sleep(ka / 2)
            if time.time() - self.last_rx > ka * 1.5:
                self.channel.disconnect_reason = "keepalive_timeout"
                self.close("keepalive_timeout")
                return

    async def _tick_loop(self) -> None:
        while not self._closing:
            await asyncio.sleep(
                max(1.0, self.channel.config.session.retry_interval / 2)
            )
            if self.channel.state == "connected":
                self.channel.tick()
                await self._drain()
            if self.congestion is not None:
                self.congestion.check(
                    getattr(self.writer, "transport", None),
                    self.channel.client_id,
                )
