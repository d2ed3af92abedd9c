"""Per-listener topic namespace prefixing.

Parity with the reference's emqx_mountpoint (apps/emqx/src/
emqx_mountpoint.erl): `mount` prefixes topics/filters on the way into the
broker, `unmount` strips the prefix on delivery, and `replvar` resolves
``${clientid}``/``${username}``/``${endpoint_name}`` placeholders once at
CONNECT (emqx_channel.erl:1369-1372 fix_mountpoint). Authorization checks
run on the client-visible (unmounted) topic, matching the reference's
pipeline ordering (authz before packet_to_message/do_subscribe mounting).

Shared-subscription filters mount the real topic inside the ``$share``
wrapper so group semantics survive the prefix.

The port's copy of `emqx_tpu/broker/mountpoint.py`, its code unchanged.
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.ops import topics as T

_PLACEHOLDERS = ("clientid", "username", "endpoint_name")


def replvar(mountpoint: Optional[str], info: dict) -> Optional[str]:
    """Resolve ${var} placeholders against client info at CONNECT time.

    Unknown/absent vars leave the placeholder in place (reference
    feed_var/2 keeps the pattern when the value is undefined).
    """
    if not mountpoint:
        return mountpoint
    out = mountpoint
    for key in _PLACEHOLDERS:
        val = info.get(key)
        if key == "clientid" and val is None:
            val = info.get("client_id")
        if val is not None:
            out = out.replace("${" + key + "}", str(val))
    return out


def mount(mountpoint: Optional[str], topic: str) -> str:
    """Prefix a topic name or filter; $share filters mount the real part."""
    if not mountpoint:
        return topic
    group, real = T.parse_share(topic)
    if group is not None:
        return f"$share/{group}/{mountpoint}{real}"
    return mountpoint + topic


def unmount(mountpoint: Optional[str], topic: str) -> str:
    """Strip the prefix if present (no-op otherwise, like the reference)."""
    if not mountpoint:
        return topic
    if topic.startswith(mountpoint):
        return topic[len(mountpoint):]
    return topic
