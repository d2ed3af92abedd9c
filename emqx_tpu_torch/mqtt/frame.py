"""The MQTT5 property encoder and the primitive encoders it calls: the
port's copy of `encode_properties` and its helpers
(emqx_tpu/mqtt/frame.py:24-101). The slab serializer (`mqtt/
slab_serializer.py`) takes pre-encoded property blocks from it. The rest
of the wire codec (the incremental parser, `serialize`, the native
extension) comes with the connection layer.
"""

from __future__ import annotations

import struct
from typing import Optional

from emqx_tpu_torch.mqtt import packet as pkt


class FrameError(Exception):
    def __init__(self, reason: str, **ctx):
        super().__init__(reason)
        self.reason = reason
        self.ctx = ctx


MAX_PACKET_SIZE = 0xFFFFFFF  # varint ceiling (268435455)


def encode_varint(n: int) -> bytes:
    if n < 0 or n > MAX_PACKET_SIZE:
        raise FrameError("varint_out_of_range", value=n)
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise FrameError("utf8_string_too_long")
    return struct.pack(">H", len(b)) + b


def encode_binary(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise FrameError("binary_too_long")
    return struct.pack(">H", len(b)) + b


def encode_properties(props: Optional[pkt.Properties]) -> bytes:
    """{name: value} -> the property block, its length varint first."""
    if not props:
        return b"\x00"
    out = bytearray()
    for name, value in props.items():
        pid = pkt.PROPERTY_IDS.get(name)
        if pid is None:
            raise FrameError("unknown_property", name=name)
        _, wt = pkt.PROPERTY_TABLE[pid]
        if wt == "utf8_pair":
            for k, v in value:  # list of pairs
                out.append(pid)
                out += encode_utf8(k) + encode_utf8(v)
            continue
        if wt == "varint" and isinstance(value, list):
            # Subscription-Identifier may appear multiple times
            for v in value:
                out.append(pid)
                out += encode_varint(v)
            continue
        out.append(pid)
        if wt == "byte":
            out.append(int(value) & 0xFF)
        elif wt == "two":
            out += struct.pack(">H", value)
        elif wt == "four":
            out += struct.pack(">I", value)
        elif wt == "varint":
            out += encode_varint(value)
        elif wt == "binary":
            out += encode_binary(value)
        elif wt == "utf8":
            out += encode_utf8(value)
    return encode_varint(len(out)) + bytes(out)
