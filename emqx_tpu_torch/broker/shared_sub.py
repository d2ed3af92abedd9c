"""Shared subscriptions: $share/<group>/<topic> load-balanced dispatch.
The port's copy of `emqx_tpu/broker/shared_sub.py` (`stable_hash`,
`_Group`, `SharedSub`, :23-208).

Parity with the reference (apps/emqx/src/emqx_shared_sub.erl:61-66
strategies, :234-285 pick logic): strategies random | round_robin | sticky |
hash_clientid | hash_topic, group membership registry, and one-of-N dispatch
per message per group. The reference's per-message ACK/NACK redispatch
(:118-130) maps to `dispatch_groups` / `dispatch_picked` trying the
remaining members when a deliverer raises.

A single real topic filter can carry several groups plus plain subscribers;
the broker routes the REAL filter and calls `dispatch_groups` alongside
normal fan-out. Left out with the cluster, which is not ported: the
per-message leader check (`leader_check`), and the worker-fabric listing
`subscriptions_sids`; and the test-only tracepoints.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Tuple


def stable_hash(s: Optional[str]) -> int:
    """FNV-1a 32-bit over the utf-8 bytes. Deterministic across runs and
    identical to the device-side pick input, unlike Python's randomized
    ``hash()`` (the reference uses erlang:phash2 the same way,
    emqx_shared_sub.erl:234-285)."""
    h = 0x811C9DC5
    for b in (s or "").encode("utf-8", "surrogatepass"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


class _Group:
    __slots__ = ("members", "rr_index", "sticky_sid")

    def __init__(self) -> None:
        self.members: Dict[str, object] = {}  # sid -> Subscriber
        self.rr_index = 0
        self.sticky_sid: Optional[str] = None


class SharedSub:
    def __init__(self, strategy: str = "round_robin"):
        self.strategy = strategy
        # real_filter -> {group -> _Group}
        self._table: Dict[str, Dict[str, _Group]] = {}
        self._rng = _random.Random(0xEC0)

    # -- membership -------------------------------------------------------
    def subscribe(self, group: str, real: str, sub) -> bool:
        groups = self._table.setdefault(real, {})
        g = groups.get(group)
        created = False
        if g is None:
            g = groups[group] = _Group()
            created = True
        g.members[sub.sid] = sub
        return created

    def unsubscribe(self, group: str, real: str, sid: str) -> Tuple[bool, bool]:
        """-> (removed, group_now_empty)"""
        groups = self._table.get(real)
        if not groups or group not in groups:
            return False, False
        g = groups[group]
        removed = g.members.pop(sid, None) is not None
        if g.sticky_sid == sid:
            g.sticky_sid = None
        empty = not g.members
        if empty:
            del groups[group]
            if not groups:
                del self._table[real]
        return removed, empty

    def count(self) -> int:
        return sum(
            len(g.members)
            for groups in self._table.values()
            for g in groups.values()
        )

    def subscriptions(self) -> List[Tuple[str, str, object]]:
        out = []
        for real, groups in self._table.items():
            for gname, g in groups.items():
                for sub in g.members.values():
                    out.append(
                        (sub.client_id, f"$share/{gname}/{real}", sub.opts)
                    )
        return out

    def route_filter(self, group: str, real: str) -> str:
        """The filter registered in the route table for a shared sub."""
        return real

    # -- dispatch ---------------------------------------------------------
    def _pick(self, g: _Group, msg) -> List[str]:
        """Ordered candidate sids: first is the pick, rest are failover."""
        sids = list(g.members.keys())
        if not sids:
            return []
        s = self.strategy
        if s == "random":
            self._rng.shuffle(sids)
            return sids
        if s == "sticky":
            if g.sticky_sid in g.members:
                first = g.sticky_sid
            else:
                first = self._rng.choice(sids)
                g.sticky_sid = first
            rest = [x for x in sids if x != first]
            return [first] + rest
        if s == "hash_clientid":
            i = stable_hash(msg.from_client) % len(sids)
        elif s == "hash_topic":
            i = stable_hash(msg.topic) % len(sids)
        else:  # round_robin
            i = g.rr_index % len(sids)
            g.rr_index += 1
        return sids[i:] + sids[:i]

    # -- device-pick delivery ---------------------------------------------
    def group(self, real: str, gname: str) -> Optional[_Group]:
        groups = self._table.get(real)
        return groups.get(gname) if groups else None

    def dispatch_picked(self, real: str, gname: str, idx: int, msg) -> int:
        """Deliver to the device-picked member index, the host keeping only
        ack/retry failover (emqx_shared_sub.erl:165-189 redispatch). The
        pick came from a table snapshot, so an out-of-range idx (members
        left since) just means failover order starts elsewhere."""
        g = self.group(real, gname)
        if g is None or not g.members:
            return 0
        sids = list(g.members.keys())
        i = idx % len(sids) if sids else 0
        candidates = sids[i:] + sids[:i]
        for sid in candidates:
            sub = g.members.get(sid)
            if sub is None:
                continue
            try:
                sub.deliver(msg, sub.opts)
                if self.strategy == "sticky":
                    g.sticky_sid = sid
                elif self.strategy == "round_robin":
                    g.rr_index += 1
                return 1
            except Exception:
                continue
        return 0

    def dispatch_groups(self, real: str, msg) -> int:
        """Deliver to ONE member of each group subscribed at `real`.

        A deliverer raising is the NACK analog: the next candidate is tried
        (emqx_shared_sub redispatch, emqx_shared_sub.erl:165-189).
        """
        groups = self._table.get(real)
        if not groups:
            return 0
        n = 0
        for g in groups.values():
            for sid in self._pick(g, msg):
                sub = g.members.get(sid)
                if sub is None:
                    continue
                try:
                    sub.deliver(msg, sub.opts)
                    n += 1
                    break
                except Exception:
                    continue  # NACK -> failover to next member
        return n

    def has_groups(self, real: str) -> bool:
        return real in self._table
