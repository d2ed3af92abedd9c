"""The port's MQTT wire codec (`emqx_tpu_torch.mqtt.frame`, `mqtt.packet`,
`mqtt.reason_codes`, the slab serializer's `split_publish`) against the
reference's pure-Python codec: byte-identical `serialize` output for every
packet type at protocol levels 3, 4 and 5, equal packets from `Parser` over
the same byte streams (whole, and split at every offset), and the same
`FrameError` reason for malformed frames.

The reference's native codec is switched off for these tests (its
`codec_native.available`), so the reference is held through its
pure-Python path, which it calls the semantic source of truth. Packet
fields come from hypothesis with derandomized examples, so the cases do
not vary from run to run.
"""

import dataclasses

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import emqx_tpu.mqtt.frame as J_frame
from emqx_tpu.mqtt import packet as J_pkt
from emqx_tpu.mqtt import reason_codes as J_rc
from emqx_tpu.mqtt import slab_serializer as J_slab
from emqx_tpu_torch.mqtt import frame as P_frame
from emqx_tpu_torch.mqtt import packet as P_pkt
from emqx_tpu_torch.mqtt import reason_codes as P_rc
from emqx_tpu_torch.mqtt import slab_serializer as P_slab

VERSIONS = (3, 4, 5)
TYPES = ("Connect", "Connack", "Publish", "PubAck", "Subscribe", "Suback",
         "Unsubscribe", "Unsuback", "PingReq", "PingResp", "Disconnect", "Auth")
SETTINGS = settings(derandomize=True, max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(autouse=True)
def pure_python_reference(monkeypatch):
    monkeypatch.setattr(J_frame._nc, "available", False)


def as_tuple(p):
    """A packet of either package -> (class name, its fields), nested
    dataclasses (a will, subscription options) as dicts."""
    return type(p).__name__, dataclasses.asdict(p)


def build(mod, name, fields):
    """`fields` (plain values, nested packets as ("Cls", {...})) -> the
    packet of package `mod`."""
    def conv(v):
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str) \
                and isinstance(v[1], dict) and hasattr(mod, v[0]):
            return build(mod, v[0], v[1])
        if isinstance(v, list):
            return [conv(x) for x in v]
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v

    kw = {k: conv(v) for k, v in fields.items() if k != "type"}
    p = getattr(mod, name)(**kw)
    if "type" in fields:
        p.type = fields["type"]
    return p


# -- field strategies ----------------------------------------------------------
text = st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)), max_size=12)
topic_name = st.text(st.sampled_from("ab/$x9é"), min_size=1, max_size=10).filter(
    lambda t: "+" not in t and "#" not in t)
topic_filter = st.text(st.sampled_from("ab/+#x9"), min_size=1, max_size=10)
pid = st.integers(1, 65535)
u8 = st.integers(0, 255)
props = st.fixed_dictionaries({}, optional={
    "Payload-Format-Indicator": st.integers(0, 1),
    "Message-Expiry-Interval": st.integers(0, 2**32 - 1),
    "Content-Type": text,
    "Response-Topic": topic_name,
    "Correlation-Data": st.binary(max_size=8),
    "Subscription-Identifier": st.integers(1, 2**28 - 1),
    "Session-Expiry-Interval": st.integers(0, 2**32 - 1),
    "Reason-String": text,
    "Receive-Maximum": st.integers(1, 65535),
    "Topic-Alias": st.integers(1, 65535),
    "User-Property": st.lists(st.tuples(text, text), min_size=1, max_size=3),
})


def will(version):
    return st.builds(lambda t, pl, q, r, pr: ("Will", dict(
        topic=t, payload=pl, qos=q, retain=r,
        properties=pr if version == 5 else {})),
        topic_name, st.binary(max_size=16), st.integers(0, 2), st.booleans(), props)


def packet_strategies(version):
    """Type name -> a strategy of (class name, fields) at `version`;
    properties only where the version carries them, as a real peer sends
    them."""
    v5 = version == 5
    pr = props if v5 else st.just({})
    acks = st.sampled_from([4, 5, 6, 7])

    def ack(t, p, rc, prp):
        return ("PubAck", dict(packet_id=p, reason_code=rc if v5 else 0,
                               properties=prp, type=t))

    return dict(zip(TYPES, (
        st.builds(lambda ka, cid, cs, w, u, pw, prp: ("Connect", dict(
            proto_ver=version, proto_name="MQIsdp" if version == 3 else "MQTT",
            clean_start=cs, keepalive=ka, client_id=cid, will=w, username=u,
            password=pw, properties=prp)),
            st.integers(0, 65535), text, st.booleans(), st.none() | will(version),
            st.none() | text, st.none() | st.binary(max_size=8), pr),
        st.builds(lambda sp, rc, prp: ("Connack", dict(
            session_present=sp, reason_code=rc, properties=prp)),
            st.booleans(), u8, pr),
        st.builds(lambda t, pl, q, r, d, p, prp: ("Publish", dict(
            topic=t, payload=pl, qos=q, retain=r, dup=d,
            packet_id=p if q else None, properties=prp)),
            topic_name, st.binary(max_size=32), st.integers(0, 2), st.booleans(),
            st.booleans(), pid, pr),
        st.builds(ack, acks, pid, st.sampled_from([0, 0x10, 0x80, 0x92]), pr),
        st.builds(lambda p, fs, prp: ("Subscribe", dict(
            packet_id=p, filters=[(f, ("SubOpts", dict(
                qos=q, no_local=nl and v5, retain_as_published=rap and v5,
                retain_handling=rh if v5 else 0))) for f, q, nl, rap, rh in fs],
            properties=prp)),
            pid, st.lists(st.tuples(topic_filter, st.integers(0, 2), st.booleans(),
                                    st.booleans(), st.integers(0, 2)),
                          min_size=1, max_size=4), pr),
        st.builds(lambda p, rcs, prp: ("Suback", dict(
            packet_id=p, reason_codes=rcs, properties=prp)),
            pid, st.lists(st.sampled_from([0, 1, 2, 0x80, 0x87]), min_size=1,
                          max_size=4), pr),
        st.builds(lambda p, fs, prp: ("Unsubscribe", dict(
            packet_id=p, filters=fs, properties=prp)),
            pid, st.lists(topic_filter, min_size=1, max_size=4), pr),
        st.builds(lambda p, rcs, prp: ("Unsuback", dict(
            packet_id=p, reason_codes=rcs if v5 else [], properties=prp)),
            pid, st.lists(st.sampled_from([0, 0x11, 0x80]), min_size=1, max_size=4), pr),
        st.just(("PingReq", {})),
        st.just(("PingResp", {})),
        st.builds(lambda rc, prp: ("Disconnect", dict(
            reason_code=rc if v5 else 0, properties=prp)),
            st.sampled_from([0, 4, 0x8E, 0x98]), pr),
        st.builds(lambda rc, prp: ("Auth", dict(reason_code=rc, properties=prp)),
                  st.sampled_from([0, 0x18, 0x19]), pr),
    )))


def parsed(mod_frame, wire, version, chunks=None):
    """Parse `wire` (fed whole, or in the given chunk sizes) -> the
    packets as tuples, or ("FrameError", reason) at the first error."""
    parser = mod_frame.Parser(version=version)
    out = []
    try:
        if chunks is None:
            out += parser.feed(wire)
        else:
            off = 0
            for n in chunks:
                out += parser.feed(wire[off:off + n])
                off += n
    except mod_frame.FrameError as e:
        return [as_tuple(p) for p in out] + [("FrameError", e.reason)]
    return [as_tuple(p) for p in out]


def both_serialize(name, fields, version):
    jp, pp = build(J_pkt, name, fields), build(P_pkt, name, fields)
    try:
        jw = J_frame.serialize(jp, version)
    except J_frame.FrameError as e:
        with pytest.raises(P_frame.FrameError) as got:
            P_frame.serialize(pp, version)
        assert got.value.reason == e.reason
        return None
    pw = P_frame.serialize(pp, version)
    assert pw == jw
    return jw


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("ptype", TYPES)
def test_serialize_is_byte_identical(ptype, version):
    @SETTINGS
    @given(packet_strategies(version)[ptype])
    def check(p):
        name, fields = p
        wire = both_serialize(name, fields, version)
        if wire is not None:
            # a CONNECT switches the parser to its own level
            pv = fields["proto_ver"] if name == "Connect" else version
            assert parsed(P_frame, wire, pv) == parsed(J_frame, wire, pv)

    check()


@pytest.mark.parametrize("version", VERSIONS)
def test_parser_equal_over_streams_split_at_every_offset(version):
    @settings(derandomize=True, max_examples=12, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(st.one_of(*(s for name, s in packet_strategies(version).items()
                                if name != "Connect")),
                    min_size=1, max_size=6))
    def check(ps):
        wire = b"".join(w for w in (both_serialize(n, f, version) for n, f in ps)
                        if w is not None)
        want = parsed(J_frame, wire, version)
        assert parsed(P_frame, wire, version) == want
        for cut in range(len(wire) + 1):
            chunks = [cut, len(wire) - cut]
            assert parsed(P_frame, wire, version, chunks) == want
            assert parsed(J_frame, wire, version, chunks) == want
        assert parsed(P_frame, wire, version, [1] * len(wire)) == want

    check()


MALFORMED = {
    "bad_qos": bytes([0x36, 0x03, 0x00, 0x01, 0x61]),
    "subscribe_flags": bytes([0x80, 0x06, 0x00, 0x01, 0x00, 0x01, 0x61, 0x00]),
    "varint_5_bytes": bytes([0x30, 0xFF, 0xFF, 0xFF, 0xFF, 0x01]),
    "wildcard_publish": bytes([0x30, 0x05, 0x00, 0x03, 0x61, 0x2F, 0x23]),
    "plus_publish": bytes([0x30, 0x05, 0x00, 0x03, 0x61, 0x2F, 0x2B]),
    "zero_packet_id": bytes([0x32, 0x05, 0x00, 0x01, 0x61, 0x00, 0x00]),
    "pubrel_flags": bytes([0x60, 0x02, 0x00, 0x01]),
    "unsubscribe_flags": bytes([0xA0, 0x05, 0x00, 0x01, 0x00, 0x01, 0x61]),
    "empty_subscribe": bytes([0x82, 0x02, 0x00, 0x01]),
    "empty_unsubscribe": bytes([0xA2, 0x02, 0x00, 0x01]),
    "reserved_subopts": bytes([0x82, 0x06, 0x00, 0x01, 0x00, 0x01, 0x61, 0xC0]),
    "subopts_qos3": bytes([0x82, 0x06, 0x00, 0x01, 0x00, 0x01, 0x61, 0x03]),
    "truncated_topic": bytes([0x30, 0x03, 0x00, 0x05, 0x61]),
    "unknown_type": bytes([0x00, 0x00]),
    "bad_proto_name": b"\x10\x0c\x00\x04MQTX\x04\x02\x00\x3c\x00\x00",
    "bad_proto_level": b"\x10\x0c\x00\x04MQTT\x07\x02\x00\x3c\x00\x00",
    "reserved_connect_flag": b"\x10\x0c\x00\x04MQTT\x04\x03\x00\x3c\x00\x00",
    "will_flags_without_will": b"\x10\x0c\x00\x04MQTT\x04\x0a\x00\x3c\x00\x00",
    "connect_trailing": b"\x10\x0d\x00\x04MQTT\x04\x02\x00\x3c\x00\x00\x00",
    "bad_utf8_client_id": b"\x10\x0e\x00\x04MQTT\x04\x02\x00\x3c\x00\x02\xff\xfe",
    "v5_unknown_property": b"\x10\x0e\x00\x04MQTT\x05\x02\x00\x3c\x02\x7f\x00\x00\x00",
    "v5_properties_overrun": b"\x10\x0d\x00\x04MQTT\x05\x02\x00\x3c\x09\x00\x00",
    "v5_property_varint_off_end": b"\x10\x0e\x00\x04MQTT\x05\x02\x00\x3c\x02\x0b\xff\x00\x00",
}


@pytest.mark.parametrize("version", (4, 5))
@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frames_raise_the_same_reason(case, version):
    wire = MALFORMED[case]
    want = parsed(J_frame, wire, version)
    assert want and want[-1][0] == "FrameError", want
    assert parsed(P_frame, wire, version) == want
    # the reason does not depend on how the bytes arrive
    assert parsed(P_frame, wire, version, [1] * len(wire)) == want


def test_random_byte_streams_parse_alike():
    @settings(derandomize=True, max_examples=300, deadline=None)
    @given(st.binary(min_size=1, max_size=40), st.sampled_from(VERSIONS))
    def check(wire, version):
        assert parsed(P_frame, wire, version) == parsed(J_frame, wire, version)

    check()


def test_max_size_is_enforced_alike():
    wire = J_frame.serialize(J_pkt.Publish(topic="t", payload=b"x" * 100), 4)
    for mod in (J_frame, P_frame):
        with pytest.raises(mod.FrameError) as e:
            mod.Parser(version=4, max_size=64).feed(wire)
        assert e.value.reason == "frame_too_large"


def test_reason_code_tables_and_connack_compat_equal():
    assert P_rc.V5 == J_rc.V5
    for rc in range(256):
        assert P_rc.name(rc) == J_rc.name(rc)
        assert P_rc.compat_connack(rc) == J_rc.compat_connack(rc)
        assert P_pkt.connack_compat(rc) == J_pkt.connack_compat(rc)
    consts = {k: v for k, v in vars(J_pkt).items() if k.isupper()}
    assert {k: getattr(P_pkt, k) for k in consts} == consts


@pytest.mark.parametrize("version", (4, 5))
def test_split_publish_frames_equal_serialize(version):
    @SETTINGS
    @given(topic_name, st.binary(max_size=300), st.integers(1, 2), st.booleans(),
           pid, props)
    def check(topic, payload, qos, retain, packet_id, prp):
        prp = prp if version == 5 else {}
        head, tail = P_slab.split_publish(topic.encode(), payload, qos, retain,
                                          False, version, prp)
        assert (head, tail) == J_slab.split_publish(topic.encode(), payload, qos,
                                                    retain, False, version, prp)
        frame = head + P_slab.pid_bytes(packet_id) + tail
        assert frame == P_frame.serialize(P_pkt.Publish(
            topic=topic, payload=payload, qos=qos, retain=retain,
            packet_id=packet_id, properties=prp), version)

    check()
