"""Delayed publish: $delayed/<seconds>/<real topic>.

Parity with the reference module (apps/emqx_modules/src/emqx_delayed.erl):
messages published to $delayed/N/t are intercepted on the 'message.publish'
hook, held for N seconds, then republished to t. Max delay capped; store is
a heap swept by `tick()` from the server loop (the reference uses a
mnesia-backed timer process).

The port's copy of `emqx_tpu/broker/delayed.py`, its code unchanged.
"""

from __future__ import annotations

import heapq
import time
from typing import List, Optional, Tuple

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.message import Message

PREFIX = "$delayed/"
MAX_DELAY = 4294967  # seconds (reference cap)


class DelayedPublish:
    def __init__(
        self, broker, max_delay: int = MAX_DELAY, max_messages: int = 0
    ):
        self.broker = broker
        self.max_delay = max_delay
        self.max_messages = max_messages  # 0 = unlimited (reference default)
        self._heap: List[Tuple[float, int, Message]] = []
        self._seq = 0
        self.enabled = True
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def intercept(self, msg: Optional[Message]):
        """'message.publish' fold callback: swallow $delayed messages."""
        if msg is None or not self.enabled or not msg.topic.startswith(PREFIX):
            return None  # keep acc
        rest = msg.topic[len(PREFIX) :]
        delay_s, sep, real_topic = rest.partition("/")
        try:
            delay = int(delay_s)
        except ValueError:
            delay = -1
        if not sep or delay < 0 or real_topic == "":
            return None  # malformed: treat as a normal topic
        delay = min(delay, self.max_delay)
        if self.max_messages and len(self._heap) >= self.max_messages:
            # store full: drop the delayed message (reference behavior when
            # max_delayed_messages is reached), still swallow the original
            self.dropped += 1
            return ("stop", None)
        import copy

        m = copy.copy(msg)
        m.topic = real_topic
        self._seq += 1
        # monotonic deadline: a forward wall-clock step must not fire
        # every delayed message at once (nor a backward one freeze them).
        # DurableState persists the REMAINING interval and rebases here
        # at restore (persistent_session.py).
        heapq.heappush(self._heap, (time.monotonic() + delay, self._seq, m))
        # stop the fold with None acc => broker.publish drops the original
        return ("stop", None)

    def tick(self, now: Optional[float] = None) -> int:
        """Publish all due messages; returns how many fired. `now` is a
        `time.monotonic()` value (tests patch it)."""
        now = time.monotonic() if now is None else now
        n = 0
        while self._heap and self._heap[0][0] <= now:
            _, _, m = heapq.heappop(self._heap)
            self.broker.publish(m)
            n += 1
        return n

    def pending(self) -> List[Tuple[float, Message]]:
        """[(monotonic due, msg)] — persistence converts to remaining
        intervals before writing (a raw monotonic stamp is meaningless
        in another process)."""
        return [(due, m) for due, _, m in sorted(self._heap)]

    def load(self, due: float, msg: Message) -> bool:
        """Direct insert for durable-state restore (`due` is a
        `time.monotonic()` deadline); honors the cap."""
        if self.max_messages and len(self._heap) >= self.max_messages:
            self.dropped += 1
            return False
        self._seq += 1
        heapq.heappush(self._heap, (due, self._seq, msg))
        return True

    def attach(self, hooks: Hooks) -> None:
        hooks.add("message.publish", self.intercept, priority=200)
