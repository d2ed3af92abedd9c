"""Hierarchical token-bucket rate limiting.

Parity with the reference's limiter sub-app (apps/emqx/src/emqx_limiter/,
SURVEY.md §2.1): a per-node limiter server holds one root bucket per limit
type (bytes_in, message_in, connection, message_routing); every connection
gets a container of per-type clients, each with an optional private bucket
chained to the shared root.

Two consumption modes, matching the two callers in the reference:
- `consume(n)` — **charge-and-pause**: the tokens are always charged (the
  bucket may go into debt) and the returned float is how long the caller
  must sleep before proceeding, so sustained throughput converges to the
  configured rate for any n, including reads larger than the bucket
  capacity (emqx_connection's pause/retry loop, emqx_connection.erl:
  103-120,474-483).
- `try_acquire(n)` — **refuse-don't-queue**: consume only if n tokens are
  available now; used for connection admission where the reference refuses
  the socket instead of queueing it.

Infinity (rate<=0) means unlimited, matching the reference's `infinity`
default for every type.

The port's copy of `emqx_tpu/broker/limiter.py`, its code unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class BucketConfig:
    rate: float = 0.0  # tokens/second; <=0 = unlimited
    burst: float = 0.0  # bucket capacity; <=0 = rate (1s worth)

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0

    @property
    def capacity(self) -> float:
        return self.burst if self.burst > 0 else self.rate


class TokenBucket:
    __slots__ = ("rate", "capacity", "tokens", "last")

    def __init__(self, rate: float, capacity: float):
        self.rate = rate
        self.capacity = capacity
        self.tokens = capacity
        self.last: Optional[float] = None  # baseline = first observed clock

    def _refill(self, now: float) -> None:
        if self.last is None:
            self.last = now
        if now > self.last:
            self.tokens = min(
                self.capacity, self.tokens + (now - self.last) * self.rate
            )
            self.last = now

    def consume(self, n: float, now: Optional[float] = None) -> float:
        """Charge n tokens unconditionally (debt allowed); returns the pause
        in seconds the caller should sleep so throughput matches `rate`."""
        now = now if now is not None else time.monotonic()
        self._refill(now)
        self.tokens -= n
        if self.tokens >= 0:
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return -self.tokens / self.rate

    def try_acquire(self, n: float, now: Optional[float] = None) -> bool:
        """Consume n only if available now; no debt (admission control)."""
        now = now if now is not None else time.monotonic()
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class LimiterClient:
    """Per-connection view of one limit type: private bucket + shared root."""

    __slots__ = ("_local", "_root")

    MAX_PAUSE = 60.0

    def __init__(
        self, local: Optional[TokenBucket], root: Optional[TokenBucket]
    ):
        self._local = local
        self._root = root

    def consume(self, n: float = 1.0) -> float:
        """Charge both buckets; returns the pause (seconds) to sleep."""
        now = time.monotonic()
        wait = 0.0
        if self._local is not None:
            wait = self._local.consume(n, now)
        if self._root is not None:
            wait = max(wait, self._root.consume(n, now))
        return min(wait, self.MAX_PAUSE)

    def try_acquire(self, n: float = 1.0) -> bool:
        """Both buckets must have tokens now; no debt on refusal."""
        now = time.monotonic()
        if self._local is not None and not self._local.try_acquire(n, now):
            return False
        if self._root is not None and not self._root.try_acquire(n, now):
            if self._local is not None:
                self._local.tokens = min(
                    self._local.capacity, self._local.tokens + n
                )
            return False
        return True

    @property
    def unlimited(self) -> bool:
        return self._local is None and self._root is None


_UNLIMITED = LimiterClient(None, None)

TYPES = ("bytes_in", "message_in", "connection", "message_routing")


class LimiterServer:
    """Node-level roots + per-client bucket factory (emqx_limiter_server)."""

    def __init__(self, config: Optional[Dict[str, Dict]] = None):
        """config: {type: {"rate": r, "burst": b,
                           "client": {"rate": r, "burst": b}}}"""
        self._roots: Dict[str, TokenBucket] = {}
        self._client_cfg: Dict[str, BucketConfig] = {}
        self.reconfigure(config)

    def reconfigure(self, config: Optional[Dict[str, Dict]]) -> None:
        """Rebuild buckets from a new config (runtime update path,
        emqx_config_handler -> limiter). Existing LimiterClients keep
        their old shared roots until reconnect; new connections pick up
        the new rates immediately."""
        roots: Dict[str, TokenBucket] = {}
        client_cfgs: Dict[str, BucketConfig] = {}
        for type_, spec in (config or {}).items():
            if type_ not in TYPES:
                raise ValueError(f"unknown limiter type {type_!r}")
            root = BucketConfig(
                rate=float(spec.get("rate", 0) or 0),
                burst=float(spec.get("burst", 0) or 0),
            )
            if not root.unlimited:
                roots[type_] = TokenBucket(root.rate, root.capacity)
            client = spec.get("client") or {}
            ccfg = BucketConfig(
                rate=float(client.get("rate", 0) or 0),
                burst=float(client.get("burst", 0) or 0),
            )
            if not ccfg.unlimited:
                client_cfgs[type_] = ccfg
        self._roots = roots
        self._client_cfg = client_cfgs

    def limited(self, type_: str) -> bool:
        return type_ in self._roots or type_ in self._client_cfg

    def connect(self, type_: str) -> LimiterClient:
        root = self._roots.get(type_)
        ccfg = self._client_cfg.get(type_)
        if root is None and ccfg is None:
            return _UNLIMITED
        local = (
            TokenBucket(ccfg.rate, ccfg.capacity) if ccfg is not None else None
        )
        return LimiterClient(local, root)

    def container(self, *types: str) -> Optional["LimiterContainer"]:
        """None when every requested type is unlimited, so hot paths can
        skip limiter work entirely with one is-None check."""
        types = types or TYPES
        if not any(self.limited(t) for t in types):
            return None
        return LimiterContainer({t: self.connect(t) for t in types})


@dataclass
class LimiterContainer:
    """One connection's set of limiter clients (emqx_limiter_container)."""

    clients: Dict[str, LimiterClient] = field(default_factory=dict)

    def consume(self, type_: str, n: float = 1.0) -> float:
        c = self.clients.get(type_)
        return c.consume(n) if c is not None else 0.0
