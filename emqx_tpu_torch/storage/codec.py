"""JSON codecs for durable records (Message, SubOpts, Session).

The persistence key scheme mirrors the reference's persistent-session
records (apps/emqx/src/emqx_persistent_session.erl:63-77: session,
subscriptions, undelivered messages) collapsed into one snapshot per
session.

The port's copy of `emqx_tpu/storage/codec.py`, its code unchanged.
"""

from __future__ import annotations

import base64
from typing import Dict

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.mqtt import packet as pkt


def _enc(v):
    """Lossless JSON encoding for property/header values, including MQTT5
    list-valued properties (User-Property pair lists,
    Subscription-Identifier lists). Tuples come back as lists, which the
    frame serializer unpacks identically."""
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if isinstance(v, (list, tuple)):
        return {"__list__": [_enc(x) for x in v]}
    if isinstance(v, dict):
        return {"__map__": {str(k): _enc(x) for k, x in v.items()}}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _dec(v):
    if isinstance(v, dict):
        if "__b64__" in v:
            return base64.b64decode(v["__b64__"])
        if "__list__" in v:
            return [_dec(x) for x in v["__list__"]]
        if "__map__" in v:
            return {k: _dec(x) for k, x in v["__map__"].items()}
    return v


def _jsonable(d: Dict) -> Dict:
    return {str(k): _enc(v) for k, v in d.items()}


def _unjsonable(d: Dict) -> Dict:
    return {k: _dec(v) for k, v in d.items()}


def msg_to_json(m: Message) -> Dict:
    return {
        "topic": m.topic,
        "payload": base64.b64encode(m.payload).decode(),
        "qos": m.qos,
        "retain": m.retain,
        "dup": m.dup,
        "from_client": m.from_client,
        "from_username": m.from_username,
        "mid": m.mid,
        "headers": _jsonable(m.headers),
        "properties": _jsonable(m.properties),
        "timestamp": m.timestamp,
    }


def msg_from_json(d: Dict) -> Message:
    return Message(
        topic=d["topic"],
        payload=base64.b64decode(d["payload"]),
        qos=d.get("qos", 0),
        retain=d.get("retain", False),
        dup=d.get("dup", False),
        from_client=d.get("from_client", ""),
        from_username=d.get("from_username"),
        mid=d.get("mid", 0),
        headers=_unjsonable(d.get("headers", {})),
        properties=_unjsonable(d.get("properties", {})),
        timestamp=d.get("timestamp", 0.0),
    )


def subopts_to_json(o: pkt.SubOpts) -> Dict:
    return {
        "qos": o.qos,
        "no_local": o.no_local,
        "retain_as_published": o.retain_as_published,
        "retain_handling": o.retain_handling,
    }


def subopts_from_json(d: Dict) -> pkt.SubOpts:
    return pkt.SubOpts(
        qos=d.get("qos", 0),
        no_local=d.get("no_local", False),
        retain_as_published=d.get("retain_as_published", False),
        retain_handling=d.get("retain_handling", 0),
    )


def session_to_json(sess) -> Dict:
    """Snapshot: metadata + subscriptions + pending (mqueue/inflight)."""
    import time as _time

    _mono = _time.monotonic()
    inflight = []
    for pid, e in sess.inflight.items():
        inflight.append(
            {
                "pid": pid,
                "phase": e.phase,
                # inflight stamps are monotonic-clock readings, which are
                # meaningless in another process: persist the AGE and
                # rebase at restore (broker/inflight.py clock discipline)
                "age": round(max(0.0, _mono - e.ts), 3),
                "msg": msg_to_json(e.msg) if e.msg is not None else None,
            }
        )
    return {
        "client_id": sess.client_id,
        "created_at": sess.created_at,
        "expiry_interval": sess.config.expiry_interval,
        "next_pid": sess._next_pid,
        "subscriptions": {
            f: subopts_to_json(o) for f, o in sess.subscriptions.items()
        },
        "mqueue": [msg_to_json(m) for m in sess.mqueue.peek_all()],
        "inflight": inflight,
        "awaiting_rel": list(sess.awaiting_rel),
    }


def session_from_json(d: Dict, config, store=None) -> "object":
    import time as _time

    from emqx_tpu_torch.broker.session import Session

    sess = Session(d["client_id"], config, store=store)
    sess.created_at = d.get("created_at", sess.created_at)
    sess.config.expiry_interval = d.get(
        "expiry_interval", sess.config.expiry_interval
    )
    sess._next_pid = d.get("next_pid", 1)
    sess.subscriptions = {
        f: subopts_from_json(o)
        for f, o in d.get("subscriptions", {}).items()
    }
    for m in d.get("mqueue", []):
        sess.mqueue.in_(msg_from_json(m))
    _mono = _time.monotonic()
    for e in d.get("inflight", []):
        msg = msg_from_json(e["msg"]) if e.get("msg") else None
        sess.inflight.insert(e["pid"], msg, phase=e.get("phase", "publish"))
        # rebase the persisted AGE onto this process's monotonic clock;
        # legacy snapshots carried raw stamps ("ts") from another clock —
        # treat those as age 0 (fresh) rather than mass-expiring them
        sess.inflight.get(e["pid"]).ts = _mono - e.get("age", 0.0)
    # fresh timestamp: the receiver-side QoS2 dedup window restarts at
    # resume instead of being instantly expired by the first tick
    for pid in d.get("awaiting_rel", []):
        sess.awaiting_rel[int(pid)] = _mono
    return sess
