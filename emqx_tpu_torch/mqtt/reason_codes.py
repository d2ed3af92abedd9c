"""MQTT reason-code tables: code -> name/text, v5 <-> v3 compatibility.

Parity: apps/emqx/src/emqx_reason_codes.erl — human-readable names and
texts for every MQTT 5.0 reason code, plus the v5 -> v3.1.1 CONNACK
compatibility mapping (compat/1) used when rejecting v3 clients.

The port's copy of `emqx_tpu/mqtt/reason_codes.py`, its code unchanged.
"""

from __future__ import annotations

from typing import Optional

# code -> (name, text); names follow the MQTT 5.0 spec table 2.4/3.x
V5 = {
    0x00: ("success", "Success"),
    0x01: ("granted_qos1", "Granted QoS 1"),
    0x02: ("granted_qos2", "Granted QoS 2"),
    0x04: ("disconnect_with_will_message", "Disconnect with Will Message"),
    0x10: ("no_matching_subscribers", "No matching subscribers"),
    0x11: ("no_subscription_existed", "No subscription existed"),
    0x18: ("continue_authentication", "Continue authentication"),
    0x19: ("re_authenticate", "Re-authenticate"),
    0x80: ("unspecified_error", "Unspecified error"),
    0x81: ("malformed_packet", "Malformed Packet"),
    0x82: ("protocol_error", "Protocol Error"),
    0x83: ("implementation_specific_error", "Implementation specific error"),
    0x84: ("unsupported_protocol_version", "Unsupported Protocol Version"),
    0x85: ("client_identifier_not_valid", "Client Identifier not valid"),
    0x86: ("bad_username_or_password", "Bad User Name or Password"),
    0x87: ("not_authorized", "Not authorized"),
    0x88: ("server_unavailable", "Server unavailable"),
    0x89: ("server_busy", "Server busy"),
    0x8A: ("banned", "Banned"),
    0x8B: ("server_shutting_down", "Server shutting down"),
    0x8C: ("bad_authentication_method", "Bad authentication method"),
    0x8D: ("keepalive_timeout", "Keep Alive timeout"),
    0x8E: ("session_taken_over", "Session taken over"),
    0x8F: ("topic_filter_invalid", "Topic Filter invalid"),
    0x90: ("topic_name_invalid", "Topic Name invalid"),
    0x91: ("packet_identifier_inuse", "Packet Identifier in use"),
    0x92: ("packet_identifier_not_found", "Packet Identifier not found"),
    0x93: ("receive_maximum_exceeded", "Receive Maximum exceeded"),
    0x94: ("topic_alias_invalid", "Topic Alias invalid"),
    0x95: ("packet_too_large", "Packet too large"),
    0x96: ("message_rate_too_high", "Message rate too high"),
    0x97: ("quota_exceeded", "Quota exceeded"),
    0x98: ("administrative_action", "Administrative action"),
    0x99: ("payload_format_invalid", "Payload format invalid"),
    0x9A: ("retain_not_supported", "Retain not supported"),
    0x9B: ("qos_not_supported", "QoS not supported"),
    0x9C: ("use_another_server", "Use another server"),
    0x9D: ("server_moved", "Server moved"),
    0x9E: ("shared_subscriptions_not_supported",
           "Shared Subscriptions not supported"),
    0x9F: ("connection_rate_exceeded", "Connection rate exceeded"),
    0xA0: ("maximum_connect_time", "Maximum connect time"),
    0xA1: ("subscription_identifiers_not_supported",
           "Subscription Identifiers not supported"),
    0xA2: ("wildcard_subscriptions_not_supported",
           "Wildcard Subscriptions not supported"),
}

# MQTT 3.1.1 CONNACK return codes (emqx_reason_codes.erl name/1 for v3)
V3_CONNACK = {
    0: ("connection_accepted", "Connection accepted"),
    1: ("unacceptable_protocol_version",
        "Connection Refused: unacceptable protocol version"),
    2: ("client_identifier_not_valid",
        "Connection Refused: client identifier rejected"),
    3: ("server_unavailable", "Connection Refused: server unavailable"),
    4: ("malformed_username_or_password",
        "Connection Refused: bad user name or password"),
    5: ("unauthorized_client", "Connection Refused: not authorized"),
}

# v5 CONNACK code -> v3.1.1 CONNACK return code (compat/1)
_COMPAT_CONNACK = {
    0x80: 3, 0x81: 3, 0x82: 3, 0x83: 3,
    0x84: 1,
    0x85: 2,
    0x86: 4,
    0x87: 5, 0x8A: 5, 0x8C: 5,
    0x88: 3, 0x89: 3, 0x8B: 3, 0x97: 3, 0x9C: 3, 0x9D: 3, 0x9F: 3,
}


def name(code: int, version: int = 5) -> str:
    if version < 5:
        entry = V3_CONNACK.get(code)
    else:
        entry = V5.get(code)
    return entry[0] if entry else f"unknown_0x{code:02x}"


def text(code: int, version: int = 5) -> str:
    if version < 5:
        entry = V3_CONNACK.get(code)
    else:
        entry = V5.get(code)
    return entry[1] if entry else f"Unknown reason code 0x{code:02x}"


def compat_connack(v5_code: int) -> Optional[int]:
    """v5 CONNACK reason -> v3.1.1 return code; None when the v5 code
    has no listed v3 analog (emqx_reason_codes:compat(connack, _)) —
    the caller picks its own fallback (the channel uses server
    unavailable)."""
    if v5_code == 0:
        return 0
    return _COMPAT_CONNACK.get(v5_code)
