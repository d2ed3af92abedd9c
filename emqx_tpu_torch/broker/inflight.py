"""Inflight window for QoS1/2 deliveries (reference: emqx_inflight.erl):
the port's copy of `Inflight` and `InflightEntry`
(emqx_tpu/broker/inflight.py).

Insertion-ordered dict keyed by packet id; entries carry the message, send
timestamp, and the QoS2 state ('publish' sent vs 'pubrel' phase).

Timestamps are `time.monotonic()`, NOT wall clock: retry/expiry decisions
are elapsed-time questions, and a wall-clock step (NTP correction, manual
set) would otherwise mass-expire every window at once — or freeze retries
entirely when the clock jumps backward.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

from emqx_tpu_torch.broker.message import Message


@dataclass
class InflightEntry:
    # In the QoS2 rel phase the payload is dropped but topic/qos/timestamp
    # metadata survive so completion hooks can report on the message
    msg: Optional[Message]
    phase: str  # 'publish' | 'pubrel'
    ts: float  # monotonic-clock stamp of the last (re)transmit


class Inflight:
    store_managed = False  # True on the session-store write-through view

    def __init__(self, max_size: int = 32):
        self.max_size = max_size
        self._d: Dict[int, InflightEntry] = {}

    def __len__(self) -> int:
        return len(self._d)

    def is_full(self) -> bool:
        return self.max_size > 0 and len(self._d) >= self.max_size

    def contains(self, packet_id: int) -> bool:
        return packet_id in self._d

    def get(self, packet_id: int) -> Optional[InflightEntry]:
        return self._d.get(packet_id)

    def insert(self, packet_id: int, msg: Message, phase: str = "publish"):
        if msg is not None:
            # the window outlives the dispatch: the message must own its bytes
            msg.own_buffers()
        self._d[packet_id] = InflightEntry(msg, phase, time.monotonic())

    def update(self, packet_id: int, phase: str) -> bool:
        e = self._d.get(packet_id)
        if e is None:
            return False
        e.phase = phase
        e.ts = time.monotonic()
        if phase == "pubrel" and e.msg is not None and e.msg.payload:
            # payload no longer needed after PUBREC; keep the metadata
            m = copy.copy(e.msg)
            m.payload = b""
            e.msg = m
        return True

    def delete(self, packet_id: int) -> Optional[InflightEntry]:
        return self._d.pop(packet_id, None)

    def items(self) -> Iterator[Tuple[int, InflightEntry]]:
        return iter(list(self._d.items()))

    def retry_due(self, interval: float, now: Optional[float] = None):
        """Entries older than `interval` seconds, for retransmission.
        `now` must be a monotonic-clock reading when provided."""
        now = now or time.monotonic()
        return [
            (pid, e) for pid, e in self._d.items() if now - e.ts >= interval
        ]
