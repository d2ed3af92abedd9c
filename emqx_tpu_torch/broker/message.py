"""Internal message record (reference: apps/emqx/src/emqx_message.erl
#message{}): the port's copy of `Message` (emqx_tpu/broker/message.py:17).

`SlabMessage` (a message whose topic and payload still live in a fabric
read slab) is not ported: the slab fabric is not, so `topic_key()`
always returns the topic string, `topic_bytes()` encodes it,
`payload_view()` is the payload and `own_buffers()` (the ownership hook
every long-lived store calls: inflight windows, queues, the session
store's message slab) has nothing to take. `is_expired` reads the MQTT 5
Message-Expiry-Interval property; the retainer calls it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from emqx_tpu_torch.utils.guid import next_guid


@dataclass
class Message:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    from_client: str = ""
    from_username: Optional[str] = None
    mid: int = field(default_factory=next_guid)
    headers: Dict = field(default_factory=dict)
    properties: Dict = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)

    def is_expired(self, now: Optional[float] = None) -> bool:
        exp = self.properties.get("Message-Expiry-Interval")
        if exp is None:
            return False
        return (now or time.time()) > self.timestamp + exp

    def topic_key(self):
        """Tokenizer input: the topic string."""
        return self.topic

    def is_sys(self) -> bool:
        return self.topic.startswith("$SYS/")

    def topic_bytes(self):
        """Topic as bytes-like (the slab serializer's input)."""
        return self.topic.encode("utf-8", "surrogatepass")

    def payload_view(self):
        """Payload as a bytes-like view."""
        return self.payload or b""

    def own_buffers(self) -> "Message":
        """A message about to outlive its dispatch must own its bytes;
        this one always does."""
        return self
