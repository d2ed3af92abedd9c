"""Ban table + flapping detector.

Parity with the reference (apps/emqx/src/emqx_banned.erl: ban by
clientid/username/peerhost with until-timestamp, checked at connect;
emqx_flapping.erl: clients reconnecting more than N times inside a window
get auto-banned for ban_time).

The port's copy of `emqx_tpu/broker/banned.py`, its code unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.mqtt import packet as pkt


@dataclass
class BanEntry:
    kind: str  # 'clientid' | 'username' | 'peerhost'
    value: str
    by: str = "admin"
    reason: str = ""
    at: float = 0.0
    until: float = float("inf")


class Banned:
    def __init__(self) -> None:
        self._t: Dict[Tuple[str, str], BanEntry] = {}

    def add(self, entry: BanEntry) -> None:
        entry.at = entry.at or time.time()
        self._t[(entry.kind, entry.value)] = entry

    def delete(self, kind: str, value: str) -> bool:
        return self._t.pop((kind, value), None) is not None

    def entries(self) -> List[BanEntry]:
        return list(self._t.values())

    def is_banned(self, ci: Dict, now: Optional[float] = None) -> bool:
        now = now or time.time()
        for kind, key in (
            ("clientid", ci.get("client_id")),
            ("username", ci.get("username")),
            ("peerhost", str(ci.get("peerhost", ""))),
        ):
            if key is None:
                continue
            e = self._t.get((kind, key))
            if e is not None:
                if e.until <= now:
                    del self._t[(kind, key)]
                else:
                    return True
        return False

    def sweep(self, now: Optional[float] = None) -> int:
        now = now or time.time()
        gone = [k for k, e in self._t.items() if e.until <= now]
        for k in gone:
            del self._t[k]
        return len(gone)

    def check_connect(self, ci, p, acc=None):
        """'client.authenticate' high-priority gate."""
        if self.is_banned(ci):
            return (
                "stop",
                {"result": "deny", "reason_code": pkt.RC_BANNED},
            )
        return None

    def attach(self, hooks: Hooks) -> None:
        hooks.add("client.authenticate", self.check_connect, priority=1000)


class Flapping:
    """Auto-ban rapidly reconnecting clients (emqx_flapping.erl parity)."""

    def __init__(
        self,
        banned: Banned,
        max_count: int = 15,
        window: float = 60.0,
        ban_time: float = 300.0,
    ):
        self.banned = banned
        self.max_count = max_count
        self.window = window
        self.ban_time = ban_time
        self._hits: Dict[str, List[float]] = {}

    def on_disconnected(self, ci, reason=None) -> None:
        cid = ci.get("client_id")
        if not cid:
            return
        now = time.time()
        hits = [t for t in self._hits.get(cid, []) if now - t < self.window]
        hits.append(now)
        self._hits[cid] = hits
        if len(hits) >= self.max_count:
            self.banned.add(
                BanEntry(
                    kind="clientid",
                    value=cid,
                    by="flapping_detector",
                    reason=f"flapping: {len(hits)} disconnects in {self.window}s",
                    until=now + self.ban_time,
                )
            )
            del self._hits[cid]

    def sweep(self, now: Optional[float] = None) -> int:
        """Drop ids whose hit window has fully elapsed (memory bound)."""
        now = now or time.time()
        stale = [
            cid
            for cid, hits in self._hits.items()
            if not hits or now - hits[-1] >= self.window
        ]
        for cid in stale:
            del self._hits[cid]
        return len(stale)

    def attach(self, hooks: Hooks) -> None:
        hooks.add(
            "client.disconnected",
            lambda ci, reason: self.on_disconnected(ci, reason),
            priority=50,
        )
