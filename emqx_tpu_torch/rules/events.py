"""Hookpoint → rule-event bridging: the port's copy of
`emqx_tpu/rules/events.py`, unchanged but for the modules it imports (the
port's `broker/message.py` and `utils/node.py`).

Reference analog: emqx_rule_events.erl:76-116 — each broker hookpoint maps
to an event topic; a rule's FROM clause decides which events feed it:
- a plain topic filter (`FROM "t/#"`) selects 'message.publish' events
  whose MESSAGE TOPIC matches the filter;
- `FROM "$events/<name>"` selects that lifecycle event.

Event context fields follow the reference's event schemas (clientid,
username, topic, qos, payload, timestamp, event, ...).
"""

from __future__ import annotations

import time
from typing import Dict

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.utils.node import node_name

# $events/<name> supported (emqx_rule_events event list)
EVENT_TOPICS = (
    "$events/message_delivered",
    "$events/message_acked",
    "$events/message_dropped",
    "$events/client_connected",
    "$events/client_disconnected",
    "$events/session_subscribed",
    "$events/session_unsubscribed",
)


def _base(event: str) -> Dict:
    return {
        "event": event,
        "timestamp": int(time.time() * 1000),
        "node": _node(),
    }


def _node() -> str:
    return node_name()


def _msg_fields(msg: Message) -> Dict:
    out = {
        # provenance for the engine's self-loop guard (hidden from SELECT *)
        "__from_rule": msg.headers.get("from_rule"),
    }
    out.update(_msg_public_fields(msg))
    return out


def _msg_public_fields(msg: Message) -> Dict:
    return {
        "id": str(msg.mid),
        "clientid": msg.from_client,
        "username": msg.from_username,
        "topic": msg.topic,
        "qos": msg.qos,
        "flags": {"retain": msg.retain, "dup": msg.dup},
        "payload": msg.payload,
        "publish_received_at": int(msg.timestamp * 1000),
        "pub_props": dict(msg.properties),
    }


def message_publish(msg: Message) -> Dict:
    ctx = _base("message.publish")
    ctx.update(_msg_fields(msg))
    return ctx


def message_delivered(client_info: Dict, msg: Message) -> Dict:
    ctx = _base("message.delivered")
    ctx.update(_msg_fields(msg))
    ctx["from_clientid"] = msg.from_client
    ctx["from_username"] = msg.from_username
    ctx["clientid"] = client_info.get("client_id")
    ctx["username"] = client_info.get("username")
    return ctx


def message_acked(client_info: Dict, msg_or_pid) -> Dict:
    ctx = _base("message.acked")
    if isinstance(msg_or_pid, Message):
        ctx.update(_msg_fields(msg_or_pid))
    else:
        ctx["packet_id"] = msg_or_pid
    ctx["clientid"] = client_info.get("client_id")
    ctx["username"] = client_info.get("username")
    return ctx


def message_dropped(msg: Message, reason: str) -> Dict:
    ctx = _base("message.dropped")
    ctx.update(_msg_fields(msg))
    ctx["reason"] = reason
    return ctx


def client_connected(client_info: Dict) -> Dict:
    ctx = _base("client.connected")
    ctx.update(
        {
            "clientid": client_info.get("client_id"),
            "username": client_info.get("username"),
            "keepalive": client_info.get("keepalive"),
            "clean_start": client_info.get("clean_start"),
            "proto_ver": client_info.get("proto_ver"),
            "peerhost": str(client_info.get("peerhost", "")),
            "connected_at": int(time.time() * 1000),
        }
    )
    return ctx


def client_disconnected(client_info: Dict, reason: str) -> Dict:
    ctx = _base("client.disconnected")
    ctx.update(
        {
            "clientid": client_info.get("client_id"),
            "username": client_info.get("username"),
            "reason": reason,
            "disconnected_at": int(time.time() * 1000),
        }
    )
    return ctx


def session_subscribed(client_info: Dict, filter_: str, opts) -> Dict:
    ctx = _base("session.subscribed")
    ctx.update(
        {
            "clientid": client_info.get("client_id"),
            "username": client_info.get("username"),
            "topic": filter_,
            "qos": getattr(opts, "qos", 0),
        }
    )
    return ctx


def session_unsubscribed(client_info: Dict, filter_: str) -> Dict:
    ctx = _base("session.unsubscribed")
    ctx.update(
        {
            "clientid": client_info.get("client_id"),
            "username": client_info.get("username"),
            "topic": filter_,
        }
    )
    return ctx


# event name as it appears in FROM "$events/..." -> context 'event' field
def event_topic_to_name(topic: str) -> str:
    return topic[len("$events/") :].replace("_", ".", 1)
