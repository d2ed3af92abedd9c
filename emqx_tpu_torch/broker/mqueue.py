"""Bounded message queue (reference: apps/emqx/src/emqx_mqueue.erl): the
port's copy of `MQueue` (emqx_tpu/broker/mqueue.py) at its default
settings, one priority band and QoS0 stored, which is all the session
builds.

Bounded length, drop-oldest when full. The session queues here whatever
its inflight window has no room for.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from emqx_tpu_torch.broker.message import Message


class MQueue:
    def __init__(self, max_len: int = 1000):
        self.max_len = max_len  # 0: unbounded
        self._q: deque = deque()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._q)

    def in_(self, msg: Message) -> Optional[Message]:
        """Enqueue; returns a dropped message if the queue was full."""
        # queued messages outlive their dispatch: they must own their bytes
        msg.own_buffers()
        dropped = None
        if self.max_len and len(self._q) >= self.max_len:
            dropped = self._q.popleft()
            self.dropped += 1
        self._q.append(msg)
        return dropped

    def out(self) -> Optional[Message]:
        return self._q.popleft() if self._q else None

    def peek_all(self):
        yield from self._q
