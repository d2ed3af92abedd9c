"""Batched PUBLISH serialization into one preallocated slab: the port's
copy of `serialize_pub_slab`, `frames_of`, `split_publish`, `pid_bytes`
and `pubrel_frame` (emqx_tpu/mqtt/slab_serializer.py:56-201).

`serialize_pub_slab` builds N (possibly distinct) PUBLISH frames into ONE
bytearray: every fixed header, remaining-length varint, topic length and
packet id is written with vectorized numpy scatter stores; only the
topic/payload byte copies run per record (each a single slice-assign
memcpy). Frame i is `memoryview(slab)[offs[i]:offs[i+1]]`. It is the
session store's redelivery-flood serializer: a channel's
`_store_resend_batch` gets all of its due rows from
`SessionStore._redeliver` in one call and builds every dup PUBLISH frame
in one pass. Frames are byte-identical to the reference codec's
`frame.serialize` of the same Publish (v5 frames carry the encoded
property block), up to the MQTT maximum of 268,435,455 bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.mqtt.frame import encode_properties

_U16BE = struct.Struct(">H")

# remaining-length varint size-class thresholds
_V1 = 128
_V2 = 16384
_V3 = 2097152


def _varint_len(rem: np.ndarray) -> np.ndarray:
    return (
        1 + (rem >= _V1).astype(np.int64) + (rem >= _V2) + (rem >= _V3)
    )


def serialize_pub_slab(
    items: Sequence[Tuple],
    version: int = pkt.MQTT_V4,
) -> Tuple[bytearray, np.ndarray]:
    """items: [(topic_bytes, payload, qos, retain, dup, packet_id,
    props_bytes | None)] -> (slab, offs int64 [n+1]).

    `topic_bytes`/`payload` are bytes-like (nothing here copies them
    beyond the one memcpy into the output slab). `props_bytes` is a
    pre-encoded MQTT5 property block INCLUDING its own length varint
    (`frame.encode_properties` output); ignored unless version is v5,
    where None means the empty block. Frame i is slab[offs[i]:offs[i+1]].
    """
    n = len(items)
    v5 = version == pkt.MQTT_V5
    if n == 0:
        return bytearray(), np.zeros(1, np.int64)
    # C-level extraction: zip(*) transposes the batch and map(len, ...)
    # measures each field without a Python-bytecode loop — at flood
    # scale (1M frames) the per-row interpreted loop was the dominant
    # serializer cost
    ts, ps, qs, rets, dups, pids, pbs = zip(*items)
    tl_l = list(map(len, ts))
    pl_l = [len(p) if p is not None else 0 for p in ps]
    tl = np.array(tl_l, np.int64)
    pl = np.array(pl_l, np.int64)
    qos = np.fromiter(qs, np.int64, n)
    pid = np.fromiter((p or 0 for p in pids), np.int64, n)
    hdrb = (
        0x30
        | (np.fromiter(dups, bool, n) << 3)
        | (qos << 1)
        | np.fromiter(rets, bool, n)
    )
    if v5:
        props_l = [b"\x00" if pb is None else pb for pb in pbs]
        prl_l = list(map(len, props_l))
        prl = np.array(prl_l, np.int64)
    else:
        props_l = []
        prl_l = []
        prl = np.zeros(n, np.int64)
    pidl = np.where(qos > 0, 2, 0)
    rem = 2 + tl + pidl + prl + pl
    vl = _varint_len(rem)
    flen = 1 + vl + rem
    offs = np.empty(n + 1, np.int64)
    offs[0] = 0
    np.cumsum(flen, out=offs[1:])
    slab = bytearray(int(offs[-1]))
    u8 = np.frombuffer(slab, np.uint8)
    o = offs[:-1]
    # fixed header byte + remaining-length varint, one scatter per size
    # class (almost every frame lands in class 1 or 2)
    u8[o] = hdrb
    r = rem.copy()
    for k in range(4):
        sel = vl > k
        if not sel.any():
            break
        byte = (r[sel] & 0x7F) | np.where(vl[sel] > k + 1, 0x80, 0)
        u8[o[sel] + 1 + k] = byte
        r >>= 7
    # topic length (u16 BE)
    to = o + 1 + vl
    u8[to] = tl >> 8
    u8[to + 1] = tl & 0xFF
    # packet id (u16 BE) for qos>0 rows
    po = to + 2 + tl
    has_pid = qos > 0
    if has_pid.any():
        u8[po[has_pid]] = pid[has_pid] >> 8
        u8[po[has_pid] + 1] = pid[has_pid] & 0xFF
    # variable byte regions: one slice-assign memcpy per field
    body_o = (po + pidl).tolist()
    to_list = (to + 2).tolist()
    i = 0
    for t, p in zip(ts, ps):
        to_i = to_list[i]
        slab[to_i : to_i + tl_l[i]] = t
        bo = body_o[i]
        if v5:
            pbb = props_l[i]
            slab[bo : bo + prl_l[i]] = pbb
            bo += prl_l[i]
        if pl_l[i]:
            slab[bo : bo + pl_l[i]] = p
        i += 1
    return slab, offs


def frames_of(slab: bytearray, offs: np.ndarray) -> List[memoryview]:
    """Per-frame memoryviews into the slab (writelines-ready)."""
    mv = memoryview(slab)
    ol = offs.tolist()
    return [mv[ol[i] : ol[i + 1]] for i in range(len(ol) - 1)]


def split_publish(
    topic_b,
    payload,
    qos: int,
    retain: bool,
    dup: bool,
    version: int = pkt.MQTT_V4,
    props: Optional[dict] = None,
) -> Tuple[bytes, bytes]:
    """One QoS>0 PUBLISH split around its packet-id slot: -> (head,
    tail). `writelines([head, _U16BE.pack(pid), tail])` emits the frame
    byte-identical to frame.serialize — serialize once per message,
    patch 2 bytes per target."""
    assert qos > 0, "split frames exist for per-target packet ids"
    pb = b""
    if version == pkt.MQTT_V5:
        pb = encode_properties(props)
    p = payload or b""
    rem = 2 + len(topic_b) + 2 + len(pb) + len(p)
    head = bytearray()
    head.append(
        0x30 | (0x8 if dup else 0) | (qos << 1) | (0x1 if retain else 0)
    )
    while True:
        b = rem % 128
        rem //= 128
        head.append(b | 0x80 if rem else b)
        if not rem:
            break
    head += _U16BE.pack(len(topic_b))
    head += topic_b
    return bytes(head), pb + bytes(p)


def pid_bytes(pid: int) -> bytes:
    """A packet id as its 2 wire bytes (big-endian)."""
    return _U16BE.pack(pid)


# tiny fixed frames for the rel phase: PUBREL with rc=SUCCESS and no
# props serializes identically for v4/v5 — cache one prefix
_PUBREL_PREFIX = b"\x62\x02"


def pubrel_frame(pid: int) -> bytes:
    return _PUBREL_PREFIX + _U16BE.pack(pid)
