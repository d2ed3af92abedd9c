"""Listener lifecycle: named TCP/TLS endpoints feeding connections. The
port's copy of `TransportContext`, `AdmissionControl`, `ListenerConfig`,
`Listener` and `Listeners` (emqx_tpu/transport/listener.py).

Parity with emqx_listeners (apps/emqx/src/emqx_listeners.erl:230-266):
start/stop/restart per {type, name}; TLS via ssl.SSLContext.

Trimmed: TLS-PSK (the reference wires a `PskStore` into the TLS context;
the port's app refuses `psk.enable`) and the WebSocket transport
(`transport/ws.py`): a `ws` or `wss` listener raises `NotImplementedError`
(ROADMAP item 10.3e).
"""

from __future__ import annotations

import asyncio
import ssl as ssl_mod
from dataclasses import dataclass
from typing import Dict, Optional

from emqx_tpu_torch.broker.channel import ChannelConfig
from emqx_tpu_torch.transport.connection import Connection


@dataclass
class TransportContext:
    """Cross-cutting services every connection shares: rate limiting,
    overload gate, alarms, forced-GC factory (reference: esockd limiter
    adapter + emqx_olp + emqx_congestion wiring in emqx_connection.erl)."""

    limiters: object = None  # LimiterServer
    olp: object = None  # Olp
    alarms: object = None  # AlarmManager
    make_forced_gc: object = None  # Optional[Callable[[], ForcedGC]]


class AdmissionControl:
    """Shared accept-time gate: max-connections + OLP + connection-rate
    limiter; refuse-don't-queue."""

    def __init__(self, ctx: Optional[TransportContext], metrics):
        self.ctx = ctx
        self.metrics = metrics
        self._conn_limiter = (
            ctx.limiters.connect("connection")
            if ctx is not None and ctx.limiters is not None
            else None
        )

    def admit(self, current: int, maximum: int) -> bool:
        if current >= maximum:
            return False
        if self.ctx is not None and self.ctx.olp is not None \
                and self.ctx.olp.is_overloaded():
            self.metrics.inc("olp.refused")
            return False
        if (
            self._conn_limiter is not None
            and not self._conn_limiter.try_acquire(1)
        ):
            self.metrics.inc("limiter.refused.connection")
            return False
        return True


@dataclass
class ListenerConfig:
    name: str = "default"
    type: str = "tcp"  # tcp | ssl | ws | wss
    bind: str = "127.0.0.1"
    port: int = 1883
    max_connections: int = 1_024_000
    ssl_certfile: Optional[str] = None
    ssl_keyfile: Optional[str] = None
    ssl_cacertfile: Optional[str] = None
    ssl_verify: bool = False


def build_ssl_context(config: "ListenerConfig") -> ssl_mod.SSLContext:
    """Server-side TLS context of an ssl listener."""
    ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(config.ssl_certfile, config.ssl_keyfile)
    if config.ssl_cacertfile:
        ctx.load_verify_locations(config.ssl_cacertfile)
    if config.ssl_verify:
        ctx.verify_mode = ssl_mod.CERT_REQUIRED
    return ctx


class Listener:
    def __init__(
        self,
        broker,
        cm,
        config: ListenerConfig,
        channel_config=None,
        ctx: Optional[TransportContext] = None,
    ):
        self.broker = broker
        self.cm = cm
        self.config = config
        self.channel_config = channel_config or ChannelConfig()
        self.ctx = ctx
        self._admission = AdmissionControl(ctx, broker.metrics)
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    @property
    def port(self) -> int:
        """Actual bound port (useful when configured with port=0)."""
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.config.port

    def connection_count(self) -> int:
        return len(self._conns)

    async def start(self) -> None:
        ctx = None
        if self.config.type == "ssl":
            ctx = build_ssl_context(self.config)
        self._server = await asyncio.start_server(
            self._on_client, self.config.bind, self.config.port, ssl=ctx
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # cancel live connection handlers BEFORE wait_closed: since 3.12
        # Server.wait_closed blocks until every handler returns
        for t in list(self._conns):
            t.cancel()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_client(self, reader, writer) -> None:
        if not self._admission.admit(
            len(self._conns), self.config.max_connections
        ):
            writer.close()
            return
        conn = Connection(
            self.broker, self.cm, reader, writer, self.channel_config,
            ctx=self.ctx,
        )
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await conn.run()
        finally:
            self._conns.discard(task)


class Listeners:
    """Registry of named listeners (emqx_listeners API parity)."""

    def __init__(self, broker, cm, ctx: Optional[TransportContext] = None):
        self.broker = broker
        self.cm = cm
        self.ctx = ctx
        self._listeners: Dict[str, Listener] = {}
        # specs survive a stop so the REST surface can start/restart by id
        # (emqx_mgmt_api_listeners start/stop/restart semantics)
        self._specs: Dict[str, tuple] = {}  # key -> (config, channel_config)

    async def start_listener(
        self, config: ListenerConfig, channel_config=None
    ) -> "Listener":
        key = f"{config.type}:{config.name}"
        if key in self._listeners:
            raise ValueError(f"listener {key} already running")
        if config.type in ("ws", "wss"):
            raise NotImplementedError(
                f"listener {key}: the WebSocket transport is not ported "
                "(ROADMAP item 10.3e)")
        l = Listener(
            self.broker, self.cm, config, channel_config, ctx=self.ctx
        )
        await l.start()
        # spec recorded only on success: a failed create must not leave
        # a phantom stopped-listener entry on the REST surface
        self._specs[key] = (config, channel_config)
        self._listeners[key] = l
        return l

    async def stop_listener(self, type_: str, name: str) -> bool:
        key = f"{type_}:{name}"
        l = self._listeners.pop(key, None)
        if l is None:
            return False
        await l.stop()
        return True

    async def start_stopped(self, type_: str, name: str) -> "Listener":
        """Start a previously-stopped listener from its saved spec."""
        key = f"{type_}:{name}"
        if key in self._listeners:
            raise ValueError(f"listener {key} already running")
        spec = self._specs.get(key)
        if spec is None:
            raise KeyError(f"unknown listener {key}")
        return await self.start_listener(spec[0], spec[1])

    async def restart_listener(self, type_: str, name: str) -> "Listener":
        key = f"{type_}:{name}"
        if key not in self._specs:
            raise KeyError(f"unknown listener {key}")
        await self.stop_listener(type_, name)
        return await self.start_stopped(type_, name)

    async def delete_listener(self, type_: str, name: str) -> bool:
        """Stop (if running) and forget the saved spec entirely."""
        await self.stop_listener(type_, name)
        return self._specs.pop(f"{type_}:{name}", None) is not None

    async def stop_all(self) -> None:
        for key in list(self._listeners):
            t, n = key.split(":", 1)
            await self.stop_listener(t, n)

    def list(self):
        return dict(self._listeners)

    def describe(self):
        """Listener status rows for the REST surface: running and
        stopped-but-known listeners alike."""
        rows = []
        for key, (config, _cc) in self._specs.items():
            l = self._listeners.get(key)
            rows.append(
                {
                    "id": key,
                    "type": config.type,
                    "name": config.name,
                    "bind": f"{config.bind}:{config.port}",
                    "running": l is not None,
                    "current_connections": (
                        l.connection_count() if l is not None
                        and hasattr(l, "connection_count") else 0
                    ),
                    "max_connections": config.max_connections,
                    "port": l.port if l is not None else config.port,
                }
            )
        return rows
