"""The device session store: the port's copy of
`emqx_tpu/broker/session_store.py` (`SessionRider`, `SessionStepOut`,
`StoreInflight`, `SessionStore`).

The store owns one `ops.session_table.SessionTable` (host-authoritative
inflight rows), its device mirror (a `DeviceSegmentManager` named
"sessions") and the message slab the rows point into:

- **write-through**: a store-backed `broker.session.Session` keeps its
  dict semantics, but its window is a `StoreInflight` (`make_inflight`),
  so every inflight mutation (`inflight_insert`, `inflight_phase`,
  `inflight_delete`, `await_rel`, `release_rel`, `set_expiry`) also lands
  in the table and its op-log;
- **fused acks**: `take_rider()` packages the op-log suffix since the
  mirror (plus a pending sweep request) as a `SessionRider`;
  `Broker.adispatch_begin` takes one for every device batch when the
  store is attached (`Broker.session_store`), and
  `DeviceRouter.route_prepared(args, topics, session=rider)` scatters it
  and sweeps the scattered table in the launch the batch pays anyway, and
  the sweep lists ride its one readback; `commit(rider, result.session)`,
  back on the event loop, adopts the produced tensors as the mirror and
  redelivers every due row after re-verifying it against the host arrays;
  `abort(rider)` drops a failed launch's rider, whose writes then ride the
  next one;
- **host sweeps**: `tick()` arms a device sweep, or, with no fused launch
  for a while, runs `host_sweep()`, the authoritative vectorised scan;
- **mass resume**: `capture()`/`install()` swap the host state in, and the
  next sync is one full upload.

- **on a mesh** (`mesh=`, one rank of a `parallel.mesh.Mesh`): the
  mirror is this rank's 'dp' block of every lane
  (`parallel.mesh.session_placement`), on the rank's device, and a delta
  scatter lands as this rank's writes only. A mesh engine fuses no rider
  (`DeviceRouter.supports_session_fusion`), so the store's sweep is
  `tick(fused_path=False)`: the host sweep plus the manager's own scatter.

- **compaction**: `compaction_owner()` is the table's
  `ops.session_table.SessionSegmentOwner` for the one
  `ops.segments.SegmentCompactor`: acked (tombstoned) rows are purged off
  the serving path, and on a mesh the rebuilt lanes upload as this rank's
  'dp' block.

Threading: every mutator runs on the event loop (single writer);
`route_prepared` on the broker's dispatch pool only reads the rider's
immutable arrays, so at most one rider is outstanding.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from emqx_tpu_torch.broker.inflight import Inflight
from emqx_tpu_torch.convert import resolve_device
from emqx_tpu_torch.ops.nfa import _next_pow2
from emqx_tpu_torch.ops.segments import DeviceSegmentManager
from emqx_tpu_torch.ops.session_table import (
    ST_AWAIT_REL,
    ST_PUBLISH,
    ST_PUBREL,
    SessionTable,
)

# incoming (client -> broker) QoS2 packet ids live at pid + PID_SPACE so
# they can never collide with the outgoing window's ids in the one table
PID_SPACE = 1 << 16


class SessionRider(NamedTuple):
    """One op-log suffix packaged to ride a serving launch."""

    arrays: Dict  # current device mirror (immutable snapshot)
    idxs: Dict  # lane -> int32 write indices (pow2-padded)
    vals: Dict  # lane -> int32 write values
    clock: np.ndarray  # int32 [2]: (now_ds, retry_ds)
    pos: int  # op-log position the produced arrays represent
    epoch: int  # source epoch the rider was taken at
    sweep_k: int  # 0 = no sweep stage this launch
    rows: int  # distinct row writes riding (telemetry)


class SessionStepOut(NamedTuple):
    """Device outputs of one fused session stage (RouteResult.session)."""

    arrays: Dict  # updated device mirror (stays on device)
    due: Optional[np.ndarray]  # [sweep_k] row ids, -1 pad (None: no sweep)
    due_count: int  # uncapped due total (overflow => sweep again)
    expired: Optional[np.ndarray]  # [sweep_k] session slots, -1 pad
    expired_count: int


class StoreInflight(Inflight):
    """`Inflight` with write-through to the session table. The dict view
    stays authoritative for the live channel (identical semantics to the
    host-only path — the equivalence property the tests pin); the table
    write-through is what makes the aggregate state device-resident."""

    store_managed = True

    def __init__(self, store: "SessionStore", slot: int, max_size: int = 32):
        super().__init__(max_size)
        self.store = store
        self.slot = slot

    def insert(self, packet_id: int, msg, phase: str = "publish"):
        super().insert(packet_id, msg, phase)
        self.store.inflight_insert(self.slot, packet_id, msg, phase)

    def update(self, packet_id: int, phase: str) -> bool:
        ok = super().update(packet_id, phase)
        if ok:
            self.store.inflight_phase(self.slot, packet_id, phase)
        return ok

    def delete(self, packet_id: int):
        e = super().delete(packet_id)
        if e is not None:
            self.store.inflight_delete(self.slot, packet_id)
        return e


class SessionStore:
    """Owner of one `SessionTable` + its device mirror + message slab: the
    counterpart of `SessionStore` (emqx_tpu/broker/session_store.py:111)."""

    def __init__(
        self,
        capacity: int = 4096,
        sweep_slots: int = 1024,
        retry_interval: float = 30.0,
        metrics=None,
        mesh=None,
        clock: Optional[Callable[[], float]] = None,
        device=None,
    ):
        """`device`: where the mirror lives (CUDA by default). On a `mesh`
        it is the mesh rank's device, and a `device` other than it raises,
        as `DeviceRouter` does."""
        self.table = SessionTable(capacity=capacity)
        placement = None
        if mesh is not None:
            from emqx_tpu_torch.parallel.mesh import session_placement

            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
            device = mesh.device
            placement = session_placement(mesh)
        self.manager = DeviceSegmentManager("cuda" if device is None else device,
                                            name="sessions", placement=placement)
        self.metrics = metrics
        self.sweep_slots = max(16, _next_pow2(sweep_slots))
        self.retry_ds = max(1, int(retry_interval * 10))
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        # message slab: mid -> message (payloads stay host-side; the
        # table's sess_mid lane indexes here). A free-listed LIST, not a
        # dict — no per-entry hashing at million-entry scale.
        self._slab: List = []
        self._free_mids: List[int] = []
        # client registry: cid -> slot + the dense reverse map
        self._slots: Dict[str, int] = {}
        self._slot_cid: List[Optional[str]] = []
        self._free_slots: List[int] = []
        # slot -> resend(pid, state, msg) for LIVE channels only
        self._bind: Dict[int, Callable] = {}
        self._rider_out = False  # single-writer: loop
        self._want_sweep = False  # single-writer: loop
        self._last_ride = 0.0  # single-writer: loop
        self.on_expired: Optional[Callable] = None  # cids past expiry
        self.restored = 0

    # -- clock -------------------------------------------------------------
    def now_ds(self) -> int:
        return int((self._clock() - self._t0) * 10)

    # -- session registry --------------------------------------------------
    def attach(self, client_id: str) -> int:
        slot = self._slots.get(client_id)
        if slot is not None:
            return slot
        if self._free_slots:
            slot = self._free_slots.pop()
            self._slot_cid[slot] = client_id
        else:
            slot = len(self._slot_cid)
            self._slot_cid.append(client_id)
        self._slots[client_id] = slot
        if self.metrics is not None:
            self.metrics.gauge_set(
                "session.store.sessions", len(self._slots)
            )
        return slot

    def slot_of(self, client_id: str) -> Optional[int]:
        return self._slots.get(client_id)

    def bulk_attach(self, client_ids) -> np.ndarray:
        """Vectorized slot registration for mass loads (bench/restore
        tooling): appends fresh slots in one pass (free list untouched)."""
        base = len(self._slot_cid)
        new = [c for c in client_ids if c not in self._slots]
        self._slots.update({c: base + i for i, c in enumerate(new)})
        self._slot_cid.extend(new)
        if self.metrics is not None:
            self.metrics.gauge_set(
                "session.store.sessions", len(self._slots)
            )
        return np.asarray(
            [self._slots[c] for c in client_ids], np.int64
        )

    def bulk_load(self, client_ids, msgs, pids=None) -> np.ndarray:
        """Mass inflight load (the session_storm bench's build phase):
        one QoS1 publish-phase row per client, placed vectorized with
        ONE epoch bump. Returns the placed row ids."""
        slots = self.bulk_attach(client_ids)
        mids = np.asarray([self._put_msg(m) for m in msgs], np.int64)
        n = len(slots)
        pids = (
            np.asarray(pids, np.int64)
            if pids is not None
            else np.ones(n, np.int64)
        )
        now = self.now_ds()
        rows = self.table.bulk_insert(
            slots, pids, np.full(n, ST_PUBLISH, np.int64),
            np.full(n, now, np.int64), mids,
        )
        self._gauges()
        return rows

    def make_inflight(self, slot: int, max_size: int) -> StoreInflight:
        return StoreInflight(self, slot, max_size)

    def bind(self, slot: int, resend: Callable) -> None:
        """Register a live channel's resend(pid, state, msg) callback —
        sweep hits on unbound (offline) slots are skipped, exactly like
        the dict path never retries a detached session."""
        self._bind[slot] = resend

    def unbind(self, slot: int) -> None:
        self._bind.pop(slot, None)

    def set_expiry(self, client_id: str, deadline_s: float) -> None:
        """Arm the session-expiry lane (deadline on the store clock;
        0/negative disarms — e.g. at resume)."""
        slot = self._slots.get(client_id)
        if slot is None:
            return
        ds = 0
        if deadline_s > 0:
            ds = max(1, self.now_ds() + int(deadline_s * 10))
        self.table.set_expiry(slot, ds)

    def drop_session(self, client_id: str) -> None:
        """Terminal cleanup: clear every row the slot owns, free its
        slab messages, recycle the slot."""
        slot = self._slots.pop(client_id, None)
        if slot is None:
            return
        for row in self.table.rows_of_slot(slot):
            mid = self.table.clear(int(row))
            self._drop_mid(mid)
        self.table.set_expiry(slot, 0)
        self._slot_cid[slot] = None
        self._bind.pop(slot, None)
        self._free_slots.append(slot)
        if self.metrics is not None:
            self.metrics.gauge_set(
                "session.store.sessions", len(self._slots)
            )

    # -- message slab ------------------------------------------------------
    def _put_msg(self, msg) -> int:
        if msg is None:
            return -1
        # the slab holds entries until ack: a message must own its bytes
        # before landing here
        msg.own_buffers()
        if self._free_mids:
            mid = self._free_mids.pop()
            self._slab[mid] = msg
        else:
            mid = len(self._slab)
            self._slab.append(msg)
        return mid

    def _drop_mid(self, mid: int) -> None:
        if 0 <= mid < len(self._slab) and self._slab[mid] is not None:
            self._slab[mid] = None
            self._free_mids.append(mid)

    def _get_msg(self, mid: int):
        if 0 <= mid < len(self._slab):
            return self._slab[mid]
        return None

    # -- inflight write-through (loop thread) ------------------------------
    def inflight_insert(self, slot: int, pid: int, msg, phase: str) -> None:
        state = ST_PUBREL if phase == "pubrel" else ST_PUBLISH
        self.table.insert(
            slot, pid, state, self.now_ds(), self._put_msg(msg)
        )
        self._gauges()

    def inflight_phase(self, slot: int, pid: int, phase: str) -> None:
        row = self.table._find(slot, pid)
        if row < 0:
            return
        if phase == "pubrel":
            # rel phase: the payload is done (PUBREC confirmed receipt);
            # only the PUBREL handshake retries from here
            self._drop_mid(int(self.table.sess_mid[row]))
            self.table.set_state(row, ST_PUBREL, self.now_ds(), mid=-1)
        else:
            self.table.set_state(row, ST_PUBLISH, self.now_ds())

    def touch_inflight(self, slot: int, pid: int) -> None:
        """Refresh the table's retransmit stamp after a host-side resend."""
        row = self.table._find(slot, pid)
        if row >= 0:
            self.table.touch(row, self.now_ds())

    def inflight_delete(self, slot: int, pid: int) -> None:
        row = self.table._find(slot, pid)
        if row < 0:
            return
        self._drop_mid(self.table.clear(row))
        self._gauges()

    # incoming QoS2 (client -> broker): awaiting-rel rows ride the same
    # table at pid + PID_SPACE, so PUBREL releases are fused clears too
    def await_rel(self, slot: int, pid: int) -> None:
        self.table.insert(
            slot, pid + PID_SPACE, ST_AWAIT_REL, self.now_ds(), -1
        )

    def release_rel(self, slot: int, pid: int) -> None:
        row = self.table._find(slot, pid + PID_SPACE)
        if row >= 0:
            self.table.clear(row)

    def _gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge_set("session.store.inflight", self.table.live)
            self.metrics.gauge_set(
                "session.store.tombstones", self.table.tombstones
            )

    # -- the fused-launch rider (loop thread) ------------------------------
    def take_rider(self) -> Optional[SessionRider]:
        """Package the op-log suffix (+ a pending sweep request) for the
        next serving launch; None when there is nothing to ride or a
        rider is already in flight. A structural event (growth, first
        upload) full-syncs HERE, on the loop, off the launch path."""
        if self._rider_out:
            return None
        want_sweep = self._want_sweep
        peek = self.manager.peek_delta(self.table)
        if peek is None:
            if not (self.table.oplog or want_sweep or
                    not self.manager.has_mirror()):
                return None
            self.manager.sync(self.table)  # full resync (rare)
            peek = self.manager.peek_delta(self.table)
            if peek is None:
                return None
        arrays, per, pos, epoch = peek
        sweep_k = self.sweep_slots if want_sweep else 0
        if not per and not sweep_k:
            return None
        idxs: Dict[str, np.ndarray] = {}
        vals: Dict[str, np.ndarray] = {}
        rows = 0
        for name, writes in per.items():
            n = len(writes)
            rows += n
            npad = max(16, _next_pow2(n))
            ix = np.empty(npad, np.int32)
            vv = np.empty(npad, np.int32)
            ix[:n] = np.fromiter(writes.keys(), np.int64, n)
            vv[:n] = np.fromiter(writes.values(), np.int64, n)
            # pad repeats the last write — idempotent: the vectors keep
            # the JAX store's pow2 buckets, and the scatter keeps one
            # write per index; per-lane entries always carry >= 1 write
            ix[n:] = ix[n - 1]
            vv[n:] = vv[n - 1]
            idxs[name] = ix
            vals[name] = vv
        clock = np.asarray([self.now_ds(), self.retry_ds], np.int32)
        self._rider_out = True
        self._want_sweep = False
        return SessionRider(
            arrays, idxs, vals, clock, pos, epoch, sweep_k, rows
        )

    def commit(self, rider: SessionRider, out: SessionStepOut) -> None:
        """Back on the loop after a successful launch: adopt the updated
        device mirror and act on the sweep outputs (every hit host-
        re-verified before anything is transmitted)."""
        self._rider_out = False
        self._last_ride = self._clock()
        self.manager.adopt(out.arrays, rider.pos, rider.epoch)
        if self.metrics is not None:
            self.metrics.inc("session.ack.rides")
            if rider.rows:
                self.metrics.inc("session.ack.rows", rider.rows)
        if rider.sweep_k and out.due is not None:
            if self.metrics is not None:
                self.metrics.inc("session.sweep.device")
                self.metrics.inc(
                    "session.sweep.due", int(out.due_count)
                )
            self._redeliver(out.due[out.due >= 0])
            self._expire(out.expired[out.expired >= 0])
            if (
                out.due_count > rider.sweep_k
                or out.expired_count > rider.sweep_k
            ):
                # flood overflowed the compact width: sweep again on
                # the next launch (counts are uncapped by contract)
                self._want_sweep = True

    def abort(self, rider: SessionRider) -> None:
        """Launch failed/degraded: the mirror never advanced, so the
        suffix simply rides the next rider (or the manager's scatter) —
        host arrays are authoritative, nothing is lost."""
        self._rider_out = False

    # -- sweeps ------------------------------------------------------------
    def request_sweep(self) -> None:
        self._want_sweep = True

    def tick(self, fused_path: bool = True) -> None:
        """Housekeeping: arm a device sweep to ride the next launch; on
        engines without session fusion (mesh) — or when no launch has
        ridden for a while (idle broker) — fall back to the host scan
        and the manager's own scatter path so nothing waits on traffic."""
        self._gauges()
        if fused_path:
            self._want_sweep = True
            if self._clock() - self._last_ride < 2.0:
                return
        # idle / non-fusing: authoritative host sweep + mirror catch-up
        if not self._rider_out and (
            self.table.oplog or not self.manager.has_mirror()
        ):
            self.manager.sync(self.table)
            if self.metrics is not None:
                self.metrics.inc("session.ack.scatters")
        self.host_sweep()

    def host_sweep(self) -> int:
        """The authoritative (and fallback) retransmit scan: one
        vectorized pass over the host arrays — never a dict walk."""
        now = self.now_ds()
        due = self.table.due_rows(now, self.retry_ds)
        if self.metrics is not None:
            self.metrics.inc("session.sweep.host")
            if len(due):
                self.metrics.inc("session.sweep.due", int(len(due)))
        n = self._redeliver(due)
        self._expire(self.table.expired_slots(now))
        return n

    def _redeliver(self, rows) -> int:
        """Retransmit due rows through the bound channels.

        The re-verify against the authoritative host table (rows can
        clear while a sweep is in flight — same staleness net as
        subscriber slots) is ONE vectorized mask over the row arrays,
        not a per-row field walk. Surviving rows then group per bound
        channel: a channel exposing `_store_resend_batch` (the real
        broker channel) gets ALL its due rows in one
        call — one slab-serializer pass, one writelines — and stamps
        refresh via `touch_many`. Plain per-row callbacks keep the
        legacy contract (the degrade/compat path)."""
        t = self.table
        rows = np.asarray(rows, np.int64)
        if not rows.size:
            return 0
        now = self.now_ds()
        slot_a = t.sess_slot[rows]
        state_a = t.sess_state[rows]
        ok = (
            (slot_a >= 0)
            & ((state_a == ST_PUBLISH) | (state_a == ST_PUBREL))
            & ((now - t.sess_ts[rows]) >= self.retry_ds)
            & (t.sess_pid[rows] < PID_SPACE)  # incoming QoS2 never
        )
        if not ok.any():
            return 0
        rows = rows[ok]
        slots_l = slot_a[ok].tolist()
        states_l = state_a[ok].tolist()
        pids_l = t.sess_pid[rows].tolist()
        mids_l = t.sess_mid[rows].tolist()
        rows_l = rows.tolist()
        bind = self._bind
        slab = self._slab
        n_slab = len(slab)
        n = 0
        touched: List[int] = []
        # per-channel batches: OWNER id -> [batch_fn, items, row ids]
        # (grouped by the owning channel — bound methods are distinct
        # objects per bind, so keying on the callback would shatter one
        # sink's rows into single-item batches). cb_ent memoizes the
        # owner/batch resolution per callback object: the flood loop
        # then pays one dict get per row, not two getattrs.
        batches: Dict[int, list] = {}
        cb_ent: Dict[int, object] = {}
        for i, slot in enumerate(slots_l):
            cb = bind.get(slot)
            if cb is None:
                continue  # offline session: nothing to transmit to
            ent = cb_ent.get(id(cb))
            if ent is None:
                owner = getattr(cb, "__self__", cb)
                batch_fn = getattr(owner, "_store_resend_batch", None)
                if batch_fn is None:
                    ent = cb_ent[id(cb)] = 0  # legacy per-row marker
                else:
                    ent = batches.get(id(owner))
                    if ent is None:
                        ent = batches[id(owner)] = [batch_fn, [], []]
                    cb_ent[id(cb)] = ent
            mid = mids_l[i]
            msg = slab[mid] if 0 <= mid < n_slab else None
            if ent != 0:
                ent[1].append((pids_l[i], states_l[i], msg))
                ent[2].append(rows_l[i])
                continue
            try:
                if not cb(pids_l[i], states_l[i], msg):
                    continue
            except Exception:  # noqa: BLE001 — one dead sink, not the sweep
                continue
            t.touch(rows_l[i], now)
            n += 1
        for batch_fn, items, rws in batches.values():
            try:
                sent = batch_fn(items)
            except Exception:  # noqa: BLE001 — one dead sink, not the sweep
                continue
            touched.extend(r for r, s in zip(rws, sent) if s)
            n += sum(map(bool, sent))
        if touched:
            t.touch_many(touched, now)
        if n and self.metrics is not None:
            self.metrics.inc("session.redeliveries", n)
        return n

    def _expire(self, slots) -> None:
        if not len(slots):
            return
        cids = []
        for slot in np.asarray(slots).tolist():
            slot = int(slot)
            if slot < len(self._slot_cid) and self._slot_cid[slot]:
                cids.append(self._slot_cid[slot])
        if self.metrics is not None and cids:
            self.metrics.inc("session.expired.swept", len(cids))
        if self.on_expired is not None and cids:
            self.on_expired(cids)

    # -- compaction + durability -------------------------------------------
    def compaction_owner(self, tombstone_frac: float = 0.25):
        """The session table's owner on the segment compactor
        (emqx_tpu/broker/session_store.py:555), uploading with the
        mirror's placement (this rank's 'dp' block on a mesh)."""
        from emqx_tpu_torch.ops.session_table import SessionSegmentOwner

        return SessionSegmentOwner(
            self.table,
            self.manager,
            placement=self.manager.placement,
            tombstone_frac=tombstone_frac,
        )

    def capture(self) -> Dict:
        """Loop-thread checkpoint for `SegmentStateSnapshot` — the whole
        store as plain numpy + lists (mnesia disc_copies analog)."""
        return {
            "table": self.table,
            "slab": self._slab,
            "free_mids": self._free_mids,
            "slots": self._slots,
            "slot_cid": self._slot_cid,
            "free_slots": self._free_slots,
            "t0_age_ds": self.now_ds(),
        }

    def install(self, state: Dict) -> int:
        """Mass session resume as a segment replay: swap the restored
        host state in; the next sync is ONE full upload and every
        inflight window in the table is live again — zero per-session
        Python objects rebuilt."""
        self.table = state["table"]
        self._slab = state["slab"]
        self._free_mids = state["free_mids"]
        self._slots = state["slots"]
        self._slot_cid = state["slot_cid"]
        self._free_slots = state["free_slots"]
        # rebase the store clock so restored deciseconds stay comparable
        self._t0 = self._clock() - state.get("t0_age_ds", 0) / 10.0
        self.table._bump()  # force the next sync to be a full re-upload
        self._rider_out = False
        self.restored = len(self._slots)
        if self.metrics is not None:
            self.metrics.inc("session.resume.replayed", self.restored)
            self.metrics.gauge_set(
                "session.store.sessions", len(self._slots)
            )
        self._gauges()
        return self.restored

    def status(self) -> Dict:
        """Feeds the hotpath REST `session` block + housekeeping gauges."""
        return {
            "sessions": len(self._slots),
            "inflight": self.table.live,
            "tombstones": self.table.tombstones,
            "capacity": self.table._cap,
            "slab": len(self._slab) - len(self._free_mids),
            "full_resyncs": self.manager.full_resyncs,
            "delta_launches": self.manager.delta_launches,
        }
