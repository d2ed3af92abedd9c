"""Persistent sessions + session router.

Reference parity (SURVEY.md §2.1 emqx_persistent_session*/emqx_session_router,
§5.4(ii)):
- opt-in persistence for sessions with expiry_interval > 0: session
  metadata, subscriptions, and pending (undelivered) messages survive a
  broker restart (the reference persists messages at publish,
  emqx_broker.erl:213, against per-session undelivered/delivered/marker
  records; here the unit of durability is a session snapshot — pending
  queue + inflight — checkpointed on detach and on a flush interval)
- the **session router** is the separate route table the reference keeps
  for persistent sessions (emqx_session_router.erl): after a restart no
  channel exists, so restored sessions are re-attached to the broker with a
  detached deliverer that banks matched messages into the session mqueue
  until the client resumes (`resume_begin/resume_end` collapse to the
  in-process takeover handshake on a single node)
- durable broker state: retained messages, delayed messages, and the ban
  table snapshot/restore through the same FileKv (mnesia disc_copies
  analog, §5.4(iii)).

The port's copy of `emqx_tpu/broker/persistent_session.py`, its code
unchanged: `DurableState` carries the port's `Retainer`, `DelayedPublish`,
`Banned`, `DegradeController` and `SegmentStateSnapshot`, and writes the
reference's formats (the same namespaces, the same JSON records), so a
data dir written by either package's app is read by the other's. The
segment-state sidecar is a pickle of each package's own host tables: the
port's app also reads the reference's (`convert.segment_state_from_
reference`, through `app.load_segment_state`), the reference does not
read the port's.
"""

from __future__ import annotations

import time
from typing import Dict

from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.storage.codec import (
    msg_from_json,
    msg_to_json,
    session_from_json,
    session_to_json,
)
from emqx_tpu_torch.storage.kv import FileKv

NS_SESSIONS = "persistent_sessions"
NS_RETAINED = "retained"
NS_DELAYED = "delayed"
NS_BANNED = "banned"
NS_DEGRADE = "degrade"
NS_SEGMENTS = "segments"


def make_detached_deliverer(session, wal=None, client_id: str = ""):
    """Deliverer for a session with no live channel: bank QoS1/2 messages
    in the session queue for replay at resume (the reference's
    'undelivered' records). With a WAL attached, each banked message is
    also appended durably — the snapshot-to-snapshot crash window closes
    (emqx_broker.erl:213 persist-at-publish parity)."""

    def deliver(msg: Message, opts: pkt.SubOpts) -> None:
        qos = min(msg.qos, opts.qos)
        if qos == 0:
            return  # QoS0 to an offline session is dropped (spec behavior)
        import copy

        m = copy.copy(msg)
        m.qos = qos
        session.mqueue.in_(m)
        if wal is not None:
            wal.append(client_id, msg_to_json(m))

    return deliver


class SessionPersistence:
    """Checkpoints detached sessions; restores them (with routes) at boot.

    With a `MessageWal` attached, messages banked for detached sessions
    between checkpoints are appended durably and replayed over the
    snapshot at restore — closing the snapshot-to-snapshot crash window
    (the reference's persist-at-publish + undelivered records,
    emqx_persistent_session.erl:63-77)."""

    def __init__(self, broker, cm, kv: FileKv, session_config, wal=None):
        self.broker = broker
        self.cm = cm
        self.kv = kv
        self.session_config = session_config
        self.wal = wal
        self._dirty = False

    # -- hook + cm integration --------------------------------------------
    def attach(self, hooks) -> None:
        hooks.add(
            "client.disconnected", self._on_disconnected, tag="persistence"
        )
        hooks.add("session.detached", self._on_detached, tag="persistence")
        for hp in (
            "session.discarded",
            "session.terminated",
            "session.resumed",
            "session.takenover",
        ):
            hooks.add(hp, self._mark_dirty_any, tag="persistence")

    def _on_disconnected(self, ci, reason) -> None:
        self._dirty = True

    def _on_detached(self, cid: str) -> None:
        """The CM just parked this session: swap the (dead channel's)
        deliverers for the detached banker so every banked message hits
        the WAL from the moment of detach."""
        self._dirty = True
        ent = self.cm._detached.get(cid)
        if ent is None:
            return
        sess, _deadline = ent
        deliver = make_detached_deliverer(sess, self.wal, cid)
        for f, opts in sess.subscriptions.items():
            self.broker.subscribe(cid, cid, f, opts, deliver)

    def _mark_dirty_any(self, *args) -> None:
        self._dirty = True

    # -- checkpoint --------------------------------------------------------
    def flush(self, force: bool = False) -> bool:
        """Snapshot all detached sessions (called from housekeeping and at
        shutdown).

        Skips the write only when nothing could have changed: no lifecycle
        transition raised a hook (_dirty) AND there are no detached
        sessions whose queues mutate hook-free as offline messages bank."""
        if not (self._dirty or force or self.cm._detached):
            return False
        now = time.time()
        mono = time.monotonic()
        sessions = {}
        for cid, (sess, deadline) in self.cm._detached.items():
            snap = session_to_json(sess)
            # deadlines are monotonic (cm.py): persist the REMAINING
            # interval — a raw monotonic stamp means nothing after a
            # restart, and a wall deadline re-imports the clock-step
            # mass-expiry this snapshot format exists to avoid
            snap["expiry_remaining_s"] = max(0.0, deadline - mono)
            sessions[cid] = snap
        self.kv.write(NS_SESSIONS, {"at": now, "sessions": sessions})
        if self.wal is not None:
            # the snapshot now owns everything the WAL recorded
            self.wal.truncate()
        self._dirty = False
        return True

    # -- restore -----------------------------------------------------------
    def restore(self) -> int:
        """Rebuild detached sessions + their routes after a restart."""
        data = self.kv.read(NS_SESSIONS)
        if not data:
            return 0
        now = time.time()
        mono = time.monotonic()
        n = 0
        for cid, snap in data.get("sessions", {}).items():
            if "expiry_remaining_s" in snap:
                # downtime still counts against the interval: subtract
                # the wall time elapsed since the snapshot was cut
                remaining = float(snap["expiry_remaining_s"]) - max(
                    0.0, now - float(data.get("at", now))
                )
            else:
                # legacy snapshot: wall-clock deadline; rebase once
                remaining = snap.get("deadline", 0) - now
            if remaining <= 0:
                continue  # expired while the broker was down
            sess = session_from_json(snap, self.session_config)
            deliver = make_detached_deliverer(sess, self.wal, cid)
            for f, opts in sess.subscriptions.items():
                self.broker.subscribe(cid, cid, f, opts, deliver)
            self.cm._detached[cid] = (sess, mono + remaining)
            n += 1
        if self.wal is not None:
            # replay the post-snapshot suffix: messages banked after the
            # last checkpoint survive the crash (at-least-once)
            for cid, msg_json in self.wal.replay():
                ent = self.cm._detached.get(cid)
                if ent is not None:
                    ent[0].mqueue.in_(msg_from_json(msg_json))
        return n


class DurableState:
    """Retained / delayed / banned snapshot+restore (disc_copies analog)."""

    def __init__(self, kv: FileKv, retainer=None, delayed=None, banned=None,
                 degrade=None, segments=None):
        self.kv = kv
        self.retainer = retainer
        self.delayed = delayed
        self.banned = banned
        # DegradeController (broker/degrade.py): breaker states ride the
        # durable snapshot so a node restarting mid-degradation resumes
        # open/probing instead of hammering a still-broken fast path
        self.degrade = degrade
        # SegmentStateSnapshot (ops/segments.py): device-table host state
        # (route index, hot segments, subscriber bitmaps) checkpoints to
        # a sidecar file; the kv carries the pointer + generation so a
        # rolling upgrade restores tables instead of replaying subscribes
        self.segments = segments

    def flush(self) -> None:
        if self.degrade is not None:
            self.kv.write(NS_DEGRADE, {"paths": self.degrade.snapshot()})
        if self.segments is not None:
            self.kv.write(NS_SEGMENTS, self.segments.save())
        if self.retainer is not None:
            msgs = []
            for t in self.retainer.topics():
                m = self.retainer.get(t)
                if m is not None:
                    msgs.append(msg_to_json(m))
            self.kv.write(NS_RETAINED, {"messages": msgs})
        if self.delayed is not None:
            mono = time.monotonic()
            self.kv.write(
                NS_DELAYED,
                {
                    # remaining intervals, not deadlines: delayed dues
                    # are monotonic (broker/delayed.py) — `at` lets the
                    # restore charge the downtime against them
                    "at": time.time(),
                    "messages": [
                        {
                            "remaining_s": max(0.0, due - mono),
                            "msg": msg_to_json(m),
                        }
                        for due, m in self.delayed.pending()
                    ],
                },
            )
        if self.banned is not None:
            self.kv.write(
                NS_BANNED,
                {
                    "entries": [
                        {
                            "kind": e.kind,
                            "value": e.value,
                            "reason": e.reason,
                            "until": e.until,
                            "by": e.by,
                        }
                        for e in self.banned.entries()
                    ]
                },
            )

    def restore(self) -> Dict[str, int]:
        out = {"retained": 0, "delayed": 0, "banned": 0}
        if self.degrade is not None:
            data = self.kv.read(NS_DEGRADE)
            self.degrade.restore((data or {}).get("paths"))
        if self.segments is not None:
            # BEFORE session restore: re-subscribes then land as
            # refcount hits on the restored tables, not fresh builds
            restored = self.segments.load(self.kv.read(NS_SEGMENTS))
            out["segments"] = len(restored) if restored else 0
        if self.retainer is not None:
            data = self.kv.read(NS_RETAINED)
            for d in (data or {}).get("messages", []):
                m = msg_from_json(d)
                if not m.is_expired():
                    self.retainer.on_publish(m)
                    out["retained"] += 1
        if self.delayed is not None:
            data = self.kv.read(NS_DELAYED)
            now = time.time()
            mono = time.monotonic()
            downtime = max(0.0, now - float((data or {}).get("at", now)))
            for d in (data or {}).get("messages", []):
                m = msg_from_json(d["msg"])
                if m.is_expired():
                    continue
                if "remaining_s" in d:
                    due = mono + max(
                        0.0, float(d["remaining_s"]) - downtime
                    )
                else:  # legacy wall-deadline snapshot: rebase once
                    due = mono + max(0.0, float(d["due"]) - now)
                if self.delayed.load(due, m):
                    out["delayed"] += 1
        if self.banned is not None:
            from emqx_tpu_torch.broker.banned import BanEntry

            data = self.kv.read(NS_BANNED)
            now = time.time()
            for d in (data or {}).get("entries", []):
                if d.get("until") and d["until"] <= now:
                    continue
                until = d.get("until")
                self.banned.add(
                    BanEntry(
                        kind=d["kind"],
                        value=d["value"],
                        reason=d.get("reason", ""),
                        until=until if until is not None else float("inf"),
                        by=d.get("by", "admin"),
                    )
                )
                out["banned"] += 1
        return out
