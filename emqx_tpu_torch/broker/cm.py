"""Channel manager: clientid -> channel registry, session open/takeover/
discard. The port's copy of `ChannelManager` (emqx_tpu/broker/cm.py).

Parity with the reference (apps/emqx/src/emqx_cm.erl:245-273 open_session
with clean-start discard, :346-366 takeover_session; registry tables
:104-113). The reference serializes per-clientid races with a cluster-wide
locker; here a single asyncio loop owns the registry, so the lock is the
loop itself (no await points inside open_session).

Detached sessions (clients gone, expiry_interval > 0) are parked for resume,
the emqx_cm session-expiry analog; `sweep_expired` is the GC. With the
device session store (`session_store`), sessions are created store-backed:
a live session's slot is bound to its channel's resend, a detached one's
expiry lane is armed, and a dropped one's rows are freed.

Trimmed: the reference's worker fabrics (a session live on a connection
worker process, taken over through `transport/workers.py`) are not
carried (ROADMAP item 10.3e), so every open is the in-process one and
returns synchronously.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.session import Session
from emqx_tpu_torch.utils.tracepoints import tp


class ChannelManager:
    def __init__(self, broker: Broker, session_store=None):
        self.broker = broker
        # SessionStore (broker/session_store.py): when set, sessions are
        # created store-backed — inflight windows write through to the
        # device-resident table, sweeps retransmit via channel bindings
        self.session_store = session_store
        self._channels: Dict[str, object] = {}  # client_id -> Channel
        self._detached: Dict[str, Tuple[Session, float]] = {}

    def get_channel(self, client_id: str):
        return self._channels.get(client_id)

    def channel_count(self) -> int:
        return len(self._channels)

    def detached_count(self) -> int:
        return len(self._detached)

    def client_ids(self) -> List[str]:
        return list(self._channels)

    # -- session lifecycle -------------------------------------------------
    def open_session(self, channel) -> Tuple[Session, bool]:
        """-> (session, session_present). Synchronous: the asyncio loop
        is the per-clientid lock."""
        cid = channel.client_id
        old = self._channels.pop(cid, None)
        session: Optional[Session] = None
        present = False
        if channel.clean_start:
            if old is not None:
                self._discard_channel(old)
                tp("cm.discarded", cid=cid)
            self._drop_detached(cid)
        else:
            if old is not None:
                session = old.kick("takenover")
                self.broker.hooks.run("session.takenover", cid)
                present = session is not None
                tp("cm.takenover", cid=cid)
            elif cid in self._detached:
                session, _ = self._detached.pop(cid)
                self.broker.hooks.run("session.resumed", cid)
                present = True
                tp("cm.resumed", cid=cid)
        if session is None:
            session = Session(
                cid, channel.config.session, store=self.session_store
            )
            self.broker.hooks.run("session.created", cid)
            tp("cm.created", cid=cid)
        else:
            # rebind broker deliverers from the old channel to the new one
            for f, opts in session.subscriptions.items():
                self.broker.subscribe(
                    cid, cid, f, opts, channel._make_deliverer(opts)
                )
        if self.session_store is not None and session.store_slot is not None:
            # live again: the sweep retransmits through THIS channel,
            # and the expiry lane disarms until the next detach
            self.session_store.bind(
                session.store_slot, channel._store_resend
            )
            self.session_store.set_expiry(cid, 0)
        self._channels[cid] = channel
        self.broker.metrics.gauge_set("connections.count", len(self._channels))
        return session, present

    def _discard_channel(self, old) -> None:
        sess = old.kick("discarded")
        if sess is not None:
            self.broker.drop_session_subs(
                sess.client_id, list(sess.subscriptions)
            )
        if self.session_store is not None:
            self.session_store.drop_session(old.client_id)
        self.broker.hooks.run("session.discarded", old.client_id)

    def _drop_detached(self, cid: str) -> None:
        ent = self._detached.pop(cid, None)
        if ent is not None:
            sess, _ = ent
            self.broker.drop_session_subs(cid, list(sess.subscriptions))
            if self.session_store is not None:
                self.session_store.drop_session(cid)
            self.broker.hooks.run("session.discarded", cid)

    def on_channel_closed(self, channel, reason: str) -> None:
        cid = channel.client_id
        if self._channels.get(cid) is not channel:
            return  # already replaced by takeover/discard
        del self._channels[cid]
        self.broker.metrics.gauge_set("connections.count", len(self._channels))
        sess = channel.session
        if sess is None:
            return
        store = self.session_store
        if store is not None and sess.store_slot is not None:
            store.unbind(sess.store_slot)
        expiry = sess.config.expiry_interval
        if expiry > 0:
            # monotonic deadline: a forward wall-clock step (NTP slew,
            # suspend/resume) must not mass-expire every detached
            # session (the inflight windows keep the same clock discipline).
            # Persistence converts to a remaining-interval at snapshot
            # time (persistent_session.py) so restarts still honor it.
            self._detached[cid] = (sess, time.monotonic() + expiry)
            if store is not None and sess.store_slot is not None:
                # arm the device expiry lane; the table rows stay put —
                # resume is a rebind, never a rebuild
                store.set_expiry(cid, expiry)
            # persistence swaps in its durable banker on this hookpoint
            self.broker.hooks.run("session.detached", cid)
        else:
            self.broker.drop_session_subs(cid, list(sess.subscriptions))
            if store is not None:
                store.drop_session(cid)
            self.broker.hooks.run("session.terminated", cid, reason)

    def kick_client(self, client_id: str) -> bool:
        """Administrative kick (mgmt API / CLI)."""
        ch = self._channels.pop(client_id, None)
        if ch is None:
            return False
        sess = ch.kick("kicked")
        if sess is not None:
            self.broker.drop_session_subs(client_id, list(sess.subscriptions))
        if self.session_store is not None:
            self.session_store.drop_session(client_id)
        return True

    def sweep_expired(self, now: Optional[float] = None) -> int:
        """GC detached sessions past their expiry deadline. `now` is a
        `time.monotonic()` value (tests patch it); wall time would make
        every deadline hostage to clock steps."""
        now = time.monotonic() if now is None else now
        gone = [cid for cid, (_, dl) in self._detached.items() if dl <= now]
        for cid in gone:
            self._drop_detached(cid)
        return len(gone)
