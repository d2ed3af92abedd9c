"""MQTT control packet model (v3.1 / v3.1.1 / v5.0): the port's copy of
`emqx_tpu/mqtt/packet.py`, every packet class field for field.

Parity with the reference's packet records (apps/emqx/include/emqx_mqtt.hrl,
apps/emqx/src/emqx_packet.erl): typed packet classes (`Connect` with its
`Will`, `Connack`, `Publish`, `PubAck` for the four publish acks,
`Subscribe`/`Suback`, `Unsubscribe`/`Unsuback`, `PingReq`/`PingResp`,
`Disconnect`, `Auth`), MQTT5 properties with their wire types, reason
codes, and `connack_compat`. The wire codec lives in
`emqx_tpu_torch.mqtt.frame`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Packet types (MQTT spec table 2.1)
CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
PUBREC = 5
PUBREL = 6
PUBCOMP = 7
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14
AUTH = 15

TYPE_NAMES = {
    CONNECT: "CONNECT", CONNACK: "CONNACK", PUBLISH: "PUBLISH",
    PUBACK: "PUBACK", PUBREC: "PUBREC", PUBREL: "PUBREL",
    PUBCOMP: "PUBCOMP", SUBSCRIBE: "SUBSCRIBE", SUBACK: "SUBACK",
    UNSUBSCRIBE: "UNSUBSCRIBE", UNSUBACK: "UNSUBACK", PINGREQ: "PINGREQ",
    PINGRESP: "PINGRESP", DISCONNECT: "DISCONNECT", AUTH: "AUTH",
}

# Protocol versions (CONNECT variable header "protocol level")
MQTT_V3 = 3
MQTT_V4 = 4  # a.k.a. 3.1.1
MQTT_V5 = 5

QOS0, QOS1, QOS2 = 0, 1, 2

# MQTT5 reason codes (subset used broker-wide; emqx_reason_codes.erl parity)
RC_SUCCESS = 0x00
RC_GRANTED_QOS1 = 0x01
RC_GRANTED_QOS2 = 0x02
RC_DISCONNECT_WITH_WILL = 0x04
RC_NO_MATCHING_SUBSCRIBERS = 0x10
RC_NO_SUBSCRIPTION_EXISTED = 0x11
RC_CONTINUE_AUTHENTICATION = 0x18
RC_REAUTHENTICATE = 0x19
RC_UNSPECIFIED_ERROR = 0x80
RC_MALFORMED_PACKET = 0x81
RC_PROTOCOL_ERROR = 0x82
RC_IMPLEMENTATION_SPECIFIC = 0x83
RC_UNSUPPORTED_PROTOCOL_VERSION = 0x84
RC_CLIENT_IDENTIFIER_NOT_VALID = 0x85
RC_BAD_USERNAME_OR_PASSWORD = 0x86
RC_NOT_AUTHORIZED = 0x87
RC_SERVER_UNAVAILABLE = 0x88
RC_SERVER_BUSY = 0x89
RC_BANNED = 0x8A
RC_BAD_AUTHENTICATION_METHOD = 0x8C
RC_KEEP_ALIVE_TIMEOUT = 0x8D
RC_SESSION_TAKEN_OVER = 0x8E
RC_TOPIC_FILTER_INVALID = 0x8F
RC_TOPIC_NAME_INVALID = 0x90
RC_PACKET_IDENTIFIER_IN_USE = 0x91
RC_PACKET_IDENTIFIER_NOT_FOUND = 0x92
RC_RECEIVE_MAXIMUM_EXCEEDED = 0x93
RC_TOPIC_ALIAS_INVALID = 0x94
RC_PACKET_TOO_LARGE = 0x95
RC_MESSAGE_RATE_TOO_HIGH = 0x96
RC_QUOTA_EXCEEDED = 0x97
RC_ADMINISTRATIVE_ACTION = 0x98
RC_PAYLOAD_FORMAT_INVALID = 0x99
RC_RETAIN_NOT_SUPPORTED = 0x9A
RC_QOS_NOT_SUPPORTED = 0x9B
RC_USE_ANOTHER_SERVER = 0x9C
RC_SERVER_MOVED = 0x9D
RC_SHARED_SUBSCRIPTIONS_NOT_SUPPORTED = 0x9E
RC_CONNECTION_RATE_EXCEEDED = 0x9F
RC_MAXIMUM_CONNECT_TIME = 0xA0
RC_SUBSCRIPTION_IDENTIFIERS_NOT_SUPPORTED = 0xA1
RC_WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED = 0xA2

# CONNACK return codes for MQTT < 5 (emqx_reason_codes:compat/2 parity)
CONNACK_ACCEPT = 0
CONNACK_PROTO_VER = 1
CONNACK_INVALID_ID = 2
CONNACK_SERVER = 3
CONNACK_CREDENTIALS = 4
CONNACK_AUTH = 5

def connack_compat(rc: int) -> int:
    """Map an MQTT5 reason code onto a v3 CONNACK return code —
    delegates to the ONE compat table (mqtt/reason_codes.py,
    emqx_reason_codes:compat/1 parity)."""
    from emqx_tpu_torch.mqtt.reason_codes import compat_connack

    code = compat_connack(rc)
    return CONNACK_SERVER if code is None else code


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
class Will:
    topic: str
    payload: bytes = b""
    qos: int = QOS0
    retain: bool = False
    properties: Properties = field(default_factory=dict)


@dataclass
class Connect:
    proto_ver: int = MQTT_V4
    proto_name: str = "MQTT"
    clean_start: bool = True
    keepalive: int = 60
    client_id: str = ""
    will: Optional[Will] = None
    username: Optional[str] = None
    password: Optional[bytes] = None
    properties: Properties = field(default_factory=dict)
    type: int = CONNECT


@dataclass
class Connack:
    session_present: bool = False
    reason_code: int = RC_SUCCESS
    properties: Properties = field(default_factory=dict)
    type: int = CONNACK


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


@dataclass
class Subscribe:
    packet_id: int
    filters: List[Tuple[str, SubOpts]] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)
    type: int = SUBSCRIBE


@dataclass
class Suback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)
    type: int = SUBACK


@dataclass
class Unsubscribe:
    packet_id: int
    filters: List[str] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)
    type: int = UNSUBSCRIBE


@dataclass
class Unsuback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)
    type: int = UNSUBACK


@dataclass
class PingReq:
    type: int = PINGREQ


@dataclass
class PingResp:
    type: int = PINGRESP


@dataclass
class Disconnect:
    reason_code: int = RC_SUCCESS
    properties: Properties = field(default_factory=dict)
    type: int = DISCONNECT


@dataclass
class Auth:
    reason_code: int = RC_SUCCESS
    properties: Properties = field(default_factory=dict)
    type: int = AUTH


Packet = object  # union of the dataclasses above
