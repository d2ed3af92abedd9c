"""The part of the MQTT packet model the port's broker and sessions use:
the publish-flow packet types, the protocol levels, the QoS levels,
`SubOpts`, `Publish`, `PubAck` and the MQTT5 property table, copied from
`emqx_tpu/mqtt/packet.py` (:17-21, :41-47, :110-143, :177-203). The other
packet classes and the parser come with a later slice of the port (the
connection layer); `mqtt/frame.py` holds the property encoder the slab
serializer needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# Packet types (MQTT spec table 2.1): the publish flow
PUBLISH = 3
PUBACK = 4
PUBREC = 5
PUBREL = 6
PUBCOMP = 7

# Protocol versions (CONNECT variable header "protocol level")
MQTT_V4 = 4  # a.k.a. 3.1.1
MQTT_V5 = 5

QOS0, QOS1, QOS2 = 0, 1, 2

RC_SUCCESS = 0x00

# -- MQTT5 properties --------------------------------------------------------
# id -> (name, wire_type); wire types: byte | two | four | varint | binary |
# utf8 | utf8_pair  (spec section 2.2.2.2)
PROPERTY_TABLE: Dict[int, Tuple[str, str]] = {
    0x01: ("Payload-Format-Indicator", "byte"),
    0x02: ("Message-Expiry-Interval", "four"),
    0x03: ("Content-Type", "utf8"),
    0x08: ("Response-Topic", "utf8"),
    0x09: ("Correlation-Data", "binary"),
    0x0B: ("Subscription-Identifier", "varint"),
    0x11: ("Session-Expiry-Interval", "four"),
    0x12: ("Assigned-Client-Identifier", "utf8"),
    0x13: ("Server-Keep-Alive", "two"),
    0x15: ("Authentication-Method", "utf8"),
    0x16: ("Authentication-Data", "binary"),
    0x17: ("Request-Problem-Information", "byte"),
    0x18: ("Will-Delay-Interval", "four"),
    0x19: ("Request-Response-Information", "byte"),
    0x1A: ("Response-Information", "utf8"),
    0x1C: ("Server-Reference", "utf8"),
    0x1F: ("Reason-String", "utf8"),
    0x21: ("Receive-Maximum", "two"),
    0x22: ("Topic-Alias-Maximum", "two"),
    0x23: ("Topic-Alias", "two"),
    0x24: ("Maximum-QoS", "byte"),
    0x25: ("Retain-Available", "byte"),
    0x26: ("User-Property", "utf8_pair"),
    0x27: ("Maximum-Packet-Size", "four"),
    0x28: ("Wildcard-Subscription-Available", "byte"),
    0x29: ("Subscription-Identifier-Available", "byte"),
    0x2A: ("Shared-Subscription-Available", "byte"),
}
PROPERTY_IDS = {name: pid for pid, (name, _) in PROPERTY_TABLE.items()}

# Properties = {name: value}; User-Property accumulates a list of (k, v)
Properties = Dict[str, object]


@dataclass
class Publish:
    topic: str
    payload: bytes = b""
    qos: int = QOS0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None  # required for qos > 0
    properties: Properties = field(default_factory=dict)
    type: int = PUBLISH


@dataclass
class PubAck:
    packet_id: int
    reason_code: int = RC_SUCCESS
    properties: Properties = field(default_factory=dict)
    type: int = PUBACK  # also used for PUBREC/PUBREL/PUBCOMP via `type`


@dataclass
class SubOpts:
    qos: int = QOS0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0


Packet = object  # union of the dataclasses above
