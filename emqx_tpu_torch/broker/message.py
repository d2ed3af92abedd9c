"""Internal message record (reference: apps/emqx/src/emqx_message.erl
#message{}): the port's copy of `Message` (emqx_tpu/broker/message.py:17).

`SlabMessage` (a message whose topic and payload still live in a fabric
read slab) is not ported: the slab fabric is not, so `topic_key()`
always returns the topic string. The methods the port's broker does not
call (`is_expired`, the zero-copy accessors) are left out.
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

    def topic_key(self):
        """Tokenizer input: the topic string."""
        return self.topic

    def is_sys(self) -> bool:
        return self.topic.startswith("$SYS/")
