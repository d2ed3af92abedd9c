"""MQTT wire codec: incremental parser + serializer, the port's copy of
the reference's pure-Python codec (emqx_tpu/mqtt/frame.py).

Parity with the reference codec (apps/emqx/src/emqx_frame.erl:56-66 parse
state continuation, :115-170 fixed/variable header parse, :559-580
serialize): handles partial frames across TCP reads, enforces max packet
size and varint bounds, parses/serializes v3.1, v3.1.1 and v5 packets
including MQTT5 properties, and auto-switches the session's protocol version
when CONNECT is seen. The slab serializer (`mqtt/slab_serializer.py`) takes
pre-encoded property blocks from `encode_properties`.

The reference calls its pure-Python codec the semantic source of truth and
speeds up frame splitting and PUBLISH parse/serialize with a C extension
when one is built (`codec_native`). The port carries the pure-Python codec
alone, so there is one codec and no switch between two; the native one is
listed in ROADMAP item 10.3e.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from emqx_tpu_torch.mqtt import packet as pkt


class FrameError(Exception):
    def __init__(self, reason: str, **ctx):
        super().__init__(reason)
        self.reason = reason
        self.ctx = ctx


MAX_PACKET_SIZE = 0xFFFFFFF  # varint ceiling (268435455)


# -- primitive encoders ------------------------------------------------------

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


# -- primitive decoders (operate on memoryview + offset) ---------------------

def decode_varint(buf, off: int) -> Tuple[int, int]:
    mult, val = 1, 0
    for i in range(4):
        if off + i >= len(buf):
            raise _NeedMore()
        b = buf[off + i]
        val += (b & 0x7F) * mult
        if not (b & 0x80):
            return val, off + i + 1
        mult *= 128
    raise FrameError("malformed_varint")


def _take(buf, off: int, n: int):
    if off + n > len(buf):
        raise FrameError("frame_truncated")
    return bytes(buf[off : off + n]), off + n


def decode_utf8(buf, off: int) -> Tuple[str, int]:
    raw, off = _take(buf, off, 2)
    (n,) = struct.unpack(">H", raw)
    raw, off = _take(buf, off, n)
    try:
        return raw.decode("utf-8"), off
    except UnicodeDecodeError:
        raise FrameError("invalid_utf8_string")


def decode_binary(buf, off: int) -> Tuple[bytes, int]:
    raw, off = _take(buf, off, 2)
    (n,) = struct.unpack(">H", raw)
    return _take(buf, off, n)


def decode_properties(buf, off: int) -> Tuple[pkt.Properties, int]:
    plen, off = decode_varint(buf, off)
    end = off + plen
    if end > len(buf):
        raise FrameError("frame_truncated")
    props: pkt.Properties = {}
    while off < end:
        pid = buf[off]
        off += 1
        ent = pkt.PROPERTY_TABLE.get(pid)
        if ent is None:
            raise FrameError("unknown_property_id", pid=pid)
        name, wt = ent
        if wt == "byte":
            value, off = buf[off], off + 1
        elif wt == "two":
            raw, off = _take(buf, off, 2)
            (value,) = struct.unpack(">H", raw)
        elif wt == "four":
            raw, off = _take(buf, off, 4)
            (value,) = struct.unpack(">I", raw)
        elif wt == "varint":
            value, off = decode_varint(buf, off)
        elif wt == "binary":
            value, off = decode_binary(buf, off)
        elif wt == "utf8":
            value, off = decode_utf8(buf, off)
        else:  # utf8_pair
            k, off = decode_utf8(buf, off)
            v, off = decode_utf8(buf, off)
            props.setdefault(name, []).append((k, v))
            continue
        if name == "Subscription-Identifier" and name in props:
            prev = props[name]
            props[name] = (prev if isinstance(prev, list) else [prev]) + [value]
        else:
            props[name] = value
    if off != end:
        raise FrameError("malformed_properties")
    return props, off


class _NeedMore(Exception):
    """Internal: fixed header incomplete; wait for more bytes."""


# -- parser ------------------------------------------------------------------

class Parser:
    """Incremental MQTT parser: feed() bytes, collect whole packets.

    Version-sensitive fields follow `self.version`, which starts at the
    configured default and switches when a CONNECT packet is parsed
    (emqx_frame.erl keeps the same in its parse-state options).
    """

    def __init__(
        self,
        version: int = pkt.MQTT_V4,
        max_size: int = MAX_PACKET_SIZE,
        strict: bool = True,
    ):
        self.version = version
        self.max_size = max_size
        self.strict = strict
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[pkt.Packet]:
        self._buf += data
        out: List[pkt.Packet] = []
        while True:
            p = self._try_parse_one()
            if p is None:
                return out
            out.append(p)

    def _try_parse_one(self) -> Optional[pkt.Packet]:
        buf = self._buf
        if len(buf) < 2:
            return None
        try:
            rem_len, body_off = decode_varint(buf, 1)
        except _NeedMore:
            return None
        if rem_len > self.max_size:
            raise FrameError("frame_too_large", size=rem_len)
        if len(buf) < body_off + rem_len:
            return None
        header = buf[0]
        body = memoryview(bytes(buf[body_off : body_off + rem_len]))
        del self._buf[: body_off + rem_len]
        return self._parse_packet(header >> 4, header & 0x0F, body)

    # each _p_* consumes the full body and returns a packet
    def _parse_packet(self, ptype: int, flags: int, body) -> pkt.Packet:
        try:
            return self._parse_packet_inner(ptype, flags, body)
        except _NeedMore:
            # the frame body is complete by construction; a varint running
            # off its end is malformed, not a partial read
            raise FrameError("frame_truncated")

    def _parse_packet_inner(self, ptype: int, flags: int, body) -> pkt.Packet:
        if ptype == pkt.CONNECT:
            return self._p_connect(body)
        if ptype == pkt.CONNACK:
            return self._p_connack(body)
        if ptype == pkt.PUBLISH:
            return self._p_publish(flags, body)
        if ptype in (pkt.PUBACK, pkt.PUBREC, pkt.PUBREL, pkt.PUBCOMP):
            if ptype == pkt.PUBREL and flags != 0x2:
                raise FrameError("malformed_flags", type=ptype)
            return self._p_puback(ptype, body)
        if ptype == pkt.SUBSCRIBE:
            if flags != 0x2:
                raise FrameError("malformed_flags", type=ptype)
            return self._p_subscribe(body)
        if ptype == pkt.SUBACK:
            return self._p_suback(body)
        if ptype == pkt.UNSUBSCRIBE:
            if flags != 0x2:
                raise FrameError("malformed_flags", type=ptype)
            return self._p_unsubscribe(body)
        if ptype == pkt.UNSUBACK:
            return self._p_unsuback(body)
        if ptype == pkt.PINGREQ:
            return pkt.PingReq()
        if ptype == pkt.PINGRESP:
            return pkt.PingResp()
        if ptype == pkt.DISCONNECT:
            return self._p_disconnect(body)
        if ptype == pkt.AUTH:
            return self._p_auth(body)
        raise FrameError("unknown_packet_type", type=ptype)

    def _p_connect(self, body) -> pkt.Connect:
        off = 0
        proto_name, off = decode_utf8(body, off)
        if proto_name not in ("MQTT", "MQIsdp"):
            raise FrameError("invalid_proto_name", name=proto_name)
        ver = body[off]
        off += 1
        if ver not in (pkt.MQTT_V3, pkt.MQTT_V4, pkt.MQTT_V5):
            raise FrameError("unsupported_protocol_version", version=ver)
        cflags = body[off]
        off += 1
        if self.strict and (cflags & 0x01):
            raise FrameError("reserved_connect_flag")
        clean_start = bool(cflags & 0x02)
        will_flag = bool(cflags & 0x04)
        will_qos = (cflags >> 3) & 0x3
        will_retain = bool(cflags & 0x20)
        has_password = bool(cflags & 0x40)
        has_username = bool(cflags & 0x80)
        raw, off = _take(body, off, 2)
        (keepalive,) = struct.unpack(">H", raw)
        props: pkt.Properties = {}
        if ver == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
        client_id, off = decode_utf8(body, off)
        will = None
        if will_flag:
            wprops: pkt.Properties = {}
            if ver == pkt.MQTT_V5:
                wprops, off = decode_properties(body, off)
            wtopic, off = decode_utf8(body, off)
            wpayload, off = decode_binary(body, off)
            will = pkt.Will(
                topic=wtopic, payload=wpayload, qos=will_qos,
                retain=will_retain, properties=wprops,
            )
        elif self.strict and (will_qos or will_retain):
            raise FrameError("invalid_will_flags")
        username = password = None
        if has_username:
            username, off = decode_utf8(body, off)
        if has_password:
            password, off = decode_binary(body, off)
        if off != len(body):
            raise FrameError("trailing_bytes")
        self.version = ver
        return pkt.Connect(
            proto_ver=ver, proto_name=proto_name, clean_start=clean_start,
            keepalive=keepalive, client_id=client_id, will=will,
            username=username, password=password, properties=props,
        )

    def _p_connack(self, body) -> pkt.Connack:
        off = 0
        ackflags = body[off]
        off += 1
        rc = body[off]
        off += 1
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
        return pkt.Connack(
            session_present=bool(ackflags & 0x1), reason_code=rc,
            properties=props,
        )

    def _p_publish(self, flags: int, body) -> pkt.Publish:
        dup = bool(flags & 0x8)
        qos = (flags >> 1) & 0x3
        retain = bool(flags & 0x1)
        if qos == 3:
            raise FrameError("bad_qos")
        off = 0
        topic, off = decode_utf8(body, off)
        if self.strict and ("#" in topic or "+" in topic):
            raise FrameError("topic_name_with_wildcard", topic=topic)
        packet_id = None
        if qos > 0:
            raw, off = _take(body, off, 2)
            (packet_id,) = struct.unpack(">H", raw)
            if self.strict and packet_id == 0:
                raise FrameError("zero_packet_id")
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
        payload = bytes(body[off:])
        return pkt.Publish(
            topic=topic, payload=payload, qos=qos, retain=retain, dup=dup,
            packet_id=packet_id, properties=props,
        )

    def _p_puback(self, ptype: int, body) -> pkt.PubAck:
        raw, off = _take(body, 0, 2)
        (packet_id,) = struct.unpack(">H", raw)
        rc = pkt.RC_SUCCESS
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5 and len(body) > 2:
            rc = body[off]
            off += 1
            if len(body) > off:
                props, off = decode_properties(body, off)
        p = pkt.PubAck(packet_id=packet_id, reason_code=rc, properties=props)
        p.type = ptype
        return p

    def _p_subscribe(self, body) -> pkt.Subscribe:
        raw, off = _take(body, 0, 2)
        (packet_id,) = struct.unpack(">H", raw)
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
        filters: List[Tuple[str, pkt.SubOpts]] = []
        while off < len(body):
            f, off = decode_utf8(body, off)
            o = body[off]
            off += 1
            if self.strict and o & 0xC0:
                raise FrameError("reserved_subopts_bits")
            opts = pkt.SubOpts(
                qos=o & 0x3,
                no_local=bool(o & 0x4),
                retain_as_published=bool(o & 0x8),
                retain_handling=(o >> 4) & 0x3,
            )
            if opts.qos == 3:
                raise FrameError("bad_qos")
            filters.append((f, opts))
        if self.strict and not filters:
            raise FrameError("empty_topic_filters")
        return pkt.Subscribe(packet_id=packet_id, filters=filters, properties=props)

    def _p_suback(self, body) -> pkt.Suback:
        raw, off = _take(body, 0, 2)
        (packet_id,) = struct.unpack(">H", raw)
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
        return pkt.Suback(
            packet_id=packet_id, reason_codes=list(body[off:]), properties=props
        )

    def _p_unsubscribe(self, body) -> pkt.Unsubscribe:
        raw, off = _take(body, 0, 2)
        (packet_id,) = struct.unpack(">H", raw)
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
        filters: List[str] = []
        while off < len(body):
            f, off = decode_utf8(body, off)
            filters.append(f)
        if self.strict and not filters:
            raise FrameError("empty_topic_filters")
        return pkt.Unsubscribe(packet_id=packet_id, filters=filters, properties=props)

    def _p_unsuback(self, body) -> pkt.Unsuback:
        raw, off = _take(body, 0, 2)
        (packet_id,) = struct.unpack(">H", raw)
        props: pkt.Properties = {}
        rcs: List[int] = []
        if self.version == pkt.MQTT_V5:
            props, off = decode_properties(body, off)
            rcs = list(body[off:])
        return pkt.Unsuback(packet_id=packet_id, reason_codes=rcs, properties=props)

    def _p_disconnect(self, body) -> pkt.Disconnect:
        rc = pkt.RC_SUCCESS
        props: pkt.Properties = {}
        if self.version == pkt.MQTT_V5 and len(body) >= 1:
            rc = body[0]
            if len(body) > 1:
                props, _ = decode_properties(body, 1)
        return pkt.Disconnect(reason_code=rc, properties=props)

    def _p_auth(self, body) -> pkt.Auth:
        rc = pkt.RC_SUCCESS
        props: pkt.Properties = {}
        if len(body) >= 1:
            rc = body[0]
            if len(body) > 1:
                props, _ = decode_properties(body, 1)
        return pkt.Auth(reason_code=rc, properties=props)


# -- serializer --------------------------------------------------------------

def _frame(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([ptype << 4 | flags]) + encode_varint(len(body)) + body


def serialize(p, version: int = pkt.MQTT_V4) -> bytes:
    """Serialize a packet for the given protocol version."""
    v5 = version == pkt.MQTT_V5
    t = p.type
    if t == pkt.CONNECT:
        v5c = p.proto_ver == pkt.MQTT_V5
        cflags = (
            (0x02 if p.clean_start else 0)
            | (0x04 if p.will else 0)
            | ((p.will.qos << 3) if p.will else 0)
            | (0x20 if p.will and p.will.retain else 0)
            | (0x40 if p.password is not None else 0)
            | (0x80 if p.username is not None else 0)
        )
        body = bytearray()
        body += encode_utf8("MQIsdp" if p.proto_ver == pkt.MQTT_V3 else "MQTT")
        body.append(p.proto_ver)
        body.append(cflags)
        body += struct.pack(">H", p.keepalive)
        if v5c:
            body += encode_properties(p.properties)
        body += encode_utf8(p.client_id)
        if p.will:
            if v5c:
                body += encode_properties(p.will.properties)
            body += encode_utf8(p.will.topic)
            body += encode_binary(p.will.payload)
        if p.username is not None:
            body += encode_utf8(p.username)
        if p.password is not None:
            body += encode_binary(p.password)
        return _frame(t, 0, bytes(body))
    if t == pkt.CONNACK:
        body = bytearray([1 if p.session_present else 0, p.reason_code])
        if v5:
            body += encode_properties(p.properties)
        return _frame(t, 0, bytes(body))
    if t == pkt.PUBLISH:
        flags = (
            (0x8 if p.dup else 0) | (p.qos << 1) | (0x1 if p.retain else 0)
        )
        if p.qos > 0 and not p.packet_id:
            raise FrameError("missing_packet_id")
        body = bytearray(encode_utf8(p.topic))
        if p.qos > 0:
            body += struct.pack(">H", p.packet_id)
        if v5:
            body += encode_properties(p.properties)
        body += p.payload
        return _frame(t, flags, bytes(body))
    if t in (pkt.PUBACK, pkt.PUBREC, pkt.PUBREL, pkt.PUBCOMP):
        flags = 0x2 if t == pkt.PUBREL else 0
        body = bytearray(struct.pack(">H", p.packet_id))
        if v5 and (p.reason_code != pkt.RC_SUCCESS or p.properties):
            body.append(p.reason_code)
            if p.properties:
                body += encode_properties(p.properties)
        return _frame(t, flags, bytes(body))
    if t == pkt.SUBSCRIBE:
        body = bytearray(struct.pack(">H", p.packet_id))
        if v5:
            body += encode_properties(p.properties)
        for f, o in p.filters:
            body += encode_utf8(f)
            body.append(
                o.qos
                | (0x4 if o.no_local else 0)
                | (0x8 if o.retain_as_published else 0)
                | (o.retain_handling << 4)
            )
        return _frame(t, 0x2, bytes(body))
    if t == pkt.SUBACK:
        body = bytearray(struct.pack(">H", p.packet_id))
        if v5:
            body += encode_properties(p.properties)
        body += bytes(p.reason_codes)
        return _frame(t, 0, bytes(body))
    if t == pkt.UNSUBSCRIBE:
        body = bytearray(struct.pack(">H", p.packet_id))
        if v5:
            body += encode_properties(p.properties)
        for f in p.filters:
            body += encode_utf8(f)
        return _frame(t, 0x2, bytes(body))
    if t == pkt.UNSUBACK:
        body = bytearray(struct.pack(">H", p.packet_id))
        if v5:
            body += encode_properties(p.properties)
            body += bytes(p.reason_codes)
        return _frame(t, 0, bytes(body))
    if t == pkt.PINGREQ:
        return _frame(t, 0, b"")
    if t == pkt.PINGRESP:
        return _frame(t, 0, b"")
    if t == pkt.DISCONNECT:
        if not v5 or (p.reason_code == pkt.RC_SUCCESS and not p.properties):
            return _frame(t, 0, b"" if not v5 else bytes([p.reason_code]))
        return _frame(
            t, 0, bytes([p.reason_code]) + encode_properties(p.properties)
        )
    if t == pkt.AUTH:
        if p.reason_code == pkt.RC_SUCCESS and not p.properties:
            return _frame(t, 0, b"")
        return _frame(
            t, 0, bytes([p.reason_code]) + encode_properties(p.properties)
        )
    raise FrameError("unknown_packet", packet=p)
