"""Device-resident session and QoS state: the port's copy of
`emqx_tpu/ops/session_table.py` — the (session slot, packet id) table and
its fused device stage.

- **host side**: `SessionTable`, a vectorised open-addressing
  (slot, pid) -> row table, numpy bit for bit as in the JAX package. The
  host arrays are authoritative: acks and inserts change them first, and
  every scalar write is op-logged for the device mirror
  (`ops.segments.DeviceSegmentManager`, name "sessions").
- **device side**: `session_ack`, the stage that rides a routed batch
  (`models.router_model.DeviceRouter.route_prepared(..., session=rider)`):
  the rider's op-log suffix scattered into fresh lanes by the
  `segment_scatter` kernel, then, with ``sweep_k > 0``, the whole-table
  retransmit and expiry sweep (kernel `session_sweep`,
  `kernels/csrc/session_sweep.cu`) over the SCATTERED lanes. Each has its
  plain PyTorch twin (`session_ack_plain`, `session_sweep_plain`); a
  wrapper runs the twin only for CPU tensors.

Row lanes (all int32):
  ``sess_slot``  owning session slot (-1 empty, -2 tombstone)
  ``sess_pid``   packet id (1..65535; incoming QoS2 ids at pid + 2^16)
  ``sess_state`` 0 free | 1 publish phase (awaiting PUBACK/PUBREC)
                 | 2 rel phase (awaiting PUBCOMP) | 3 incoming QoS2
                 (awaiting PUBREL)
  ``sess_ts``    last (re)transmit stamp, deciseconds on the store's
                 monotonic clock
  ``sess_mid``   message-slab id for redelivery (-1 when the payload is
                 gone, e.g. the rel phase)
Session lanes (indexed by slot; grown alone via the `!resync` marker):
  ``slot_expiry`` session-expiry deadline in deciseconds (0 = none)

`SessionSegmentOwner` drives the table's compaction cycle on
`ops.segments.SegmentCompactor`: acked (tombstoned) rows are purged by a
rebuild off the serving path, uploaded there (this rank's 'dp' block on a
mesh), and the next sync adopts it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.ops.nfa import _next_pow2
from emqx_tpu_torch.ops.segments import segment_scatter, segment_scatter_plain

# states
FREE = 0
ST_PUBLISH = 1  # QoS1/2 publish sent, awaiting PUBACK / PUBREC
ST_PUBREL = 2  # QoS2 rel phase, awaiting PUBCOMP
ST_AWAIT_REL = 3  # incoming QoS2 publish, awaiting PUBREL

# sess_slot occupancy markers
EMPTY = -1
TOMB = -2

SESSION_PROBES = 16
ROW_LANES = ("sess_slot", "sess_pid", "sess_state", "sess_ts", "sess_mid")
SLOT_LANES = ("slot_expiry",)
RESYNC = "!resync"


# -- kernel 12: the retransmit / expiry sweep --------------------------------


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 value of their low 32 bits (in int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _left_pack(mask: torch.Tensor, k: int):
    """Ascending indices of the set entries of `mask`, the first `k`, -1
    padded to `k` (int32), and the uncapped count (int32, 0-d): JAX's
    `_compact` of ``where(mask, arange, -1)`` and ``sum(mask)``."""
    hits = torch.nonzero(mask).reshape(-1)[:k]
    out = torch.full((k,), -1, dtype=torch.int32, device=mask.device)
    out[: hits.numel()] = hits.to(torch.int32)
    return out, mask.sum(dtype=torch.int32)


def session_sweep_plain(sess_slot, sess_state, sess_ts, slot_expiry, now: int,
                        retry: int, sweep_k: int):
    """Plain PyTorch twin of the `session_sweep` kernel (any device)."""
    age = _wrap_i32(int(now) - sess_ts.to(torch.int64))
    due_mask = (
        (sess_slot >= 0)
        & ((sess_state == ST_PUBLISH) | (sess_state == ST_PUBREL))
        & (age >= int(retry))
    )
    ex_mask = (slot_expiry > 0) & (slot_expiry <= int(now))
    due, due_count = _left_pack(due_mask, sweep_k)
    expired, expired_count = _left_pack(ex_mask, sweep_k)
    return due, due_count, expired, expired_count


class _SweepScratch:
    """The look-back state of `session_sweep` on one (device, stream): the
    64-bit ticket counter, a word of each half's blocks done and hits (each
    call's last blocks leave them zero) and one status word a block, zeroed
    once;
    the tickets the earlier calls took (`base`) and the last call's epoch.
    A status word is valid only under its call's epoch, so nothing is
    cleared between calls; when the epochs run out the buffer is zeroed
    once."""

    __slots__ = ("buf", "base", "epoch", "shape", "blocks")

    def __init__(self, blocks: int, device):
        self.buf = torch.zeros(_SWEEP_WORDS + blocks, dtype=torch.int64, device=device)
        self.base = 0
        self.epoch = 0
        self.shape = None
        self.blocks = 0


_sweep_scratch: Dict = {}  # (device index, stream handle) -> _SweepScratch
_SWEEP_WORDS = 3  # the ticket counter and the halves' words
_EPOCHS = (1 << 32) - 1  # the kernel keeps an epoch in 32 bits; 0 is never used


def session_sweep(sess_slot, sess_state, sess_ts, slot_expiry, now: int,
                  retry: int, sweep_k: int):
    """The retransmit and expiry sweep (kernel `session_sweep`, one launch:
    an ordered compaction with decoupled look-back).

    sess_slot, sess_state, sess_ts int32 [cap]; slot_expiry int32 [scap];
    `now`, `retry` int32 deciseconds; sweep_k >= 1 ->
    (due int32 [sweep_k], due_count int32 [], expired int32 [sweep_k],
    expired_count int32 []): the ascending rows in publish or rel phase
    whose int32 age ``now - ts`` (with wraparound) is at least `retry`, and
    the ascending slots with ``0 < slot_expiry <= now``, each -1 padded,
    beside its uncapped count. The counterpart of the sweep of
    `session_ack_impl` (emqx_tpu/ops/session_table.py:107-131). The four
    outputs are views of one allocation."""
    names = ("sess_slot", "sess_state", "sess_ts", "slot_expiry")
    lanes = (sess_slot, sess_state, sess_ts, slot_expiry)
    for name, t in zip(names, lanes):
        kernels.check_tensor(t, name, torch.int32, 1)
    cap, scap = sess_slot.numel(), slot_expiry.numel()
    if sess_state.numel() != cap or sess_ts.numel() != cap:
        raise ValueError("the row lanes differ in length")
    if cap < 1 or scap < 1 or sweep_k < 1:
        raise ValueError(f"cap {cap}, scap {scap}, sweep_k {sweep_k}: each must be >= 1")
    if max(cap, scap) >= 1 << 31:
        raise ValueError(f"cap {cap}, scap {scap}: ids must fit int32")
    for v in (now, retry):
        if not -(1 << 31) <= int(v) < (1 << 31):
            raise ValueError(f"{v} is not an int32")
    if not kernels.on_cuda(*lanes):
        return session_sweep_plain(*lanes, now, retry, sweep_k)
    dev = sess_slot.device
    key = (dev.index, kernels.stream_handle(dev))
    sc = _sweep_scratch.get(key)
    if sc is None or sc.shape != (cap, scap):
        blocks = int(kernels.build.load().emqx_sweep_blocks(cap, scap))
        if sc is None or sc.buf.numel() < _SWEEP_WORDS + blocks:
            sc = _sweep_scratch[key] = _SweepScratch(blocks, dev)
        sc.shape, sc.blocks = (cap, scap), blocks
    if sc.epoch == _EPOCHS:
        sc.buf.zero_()
        sc.base = sc.epoch = 0
    sc.epoch += 1
    out = torch.empty(2 * sweep_k + 2, dtype=torch.int32, device=dev)
    ptr = out.data_ptr()  # due, then expired, then the two counts
    kernels.launch("session_sweep", "emqx_session_sweep", dev,
                   sess_slot.data_ptr(), sess_state.data_ptr(), sess_ts.data_ptr(), cap,
                   slot_expiry.data_ptr(), scap, int(now), int(retry), sc.buf.data_ptr(),
                   sc.base, sc.epoch, ptr, ptr + 4 * sweep_k, ptr + 8 * sweep_k, sweep_k)
    sc.base += sc.blocks
    return out[:sweep_k], out[2 * sweep_k], out[sweep_k : 2 * sweep_k], out[2 * sweep_k + 1]


# -- the fused session stage ---------------------------------------------------


def _ack(tables, idxs, vals, clock, sweep_k, scatter, sweep) -> Dict:
    out = dict(tables)
    touched = [k for k in tables if k in idxs]
    if touched:
        out.update(scatter({k: tables[k] for k in touched},
                           {k: idxs[k] for k in touched},
                           {k: vals[k] for k in touched}))
    res = {"tables": out}
    if sweep_k > 0:
        now, retry = (int(v) for v in np.asarray(clock).reshape(-1)[:2])
        # the sweep reads the SCATTERED lanes, as JAX's reads `out`
        due, due_count, expired, expired_count = sweep(
            out["sess_slot"], out["sess_state"], out["sess_ts"], out["slot_expiry"],
            now, retry, sweep_k,
        )
        res.update(due=due, due_count=due_count, expired=expired,
                   expired_count=expired_count)
    return res


def session_ack_plain(tables: Dict, idxs: Dict, vals: Dict, clock, *,
                      sweep_k: int = 0) -> Dict:
    """Plain PyTorch twin of `session_ack`: `segment_scatter_plain`, then
    `session_sweep_plain` (any device)."""
    return _ack(tables, idxs, vals, clock, sweep_k, segment_scatter_plain,
                session_sweep_plain)


def session_ack(tables: Dict, idxs: Dict, vals: Dict, clock, *,
                sweep_k: int = 0) -> Dict:
    """The fused session stage that rides a routed batch: the counterpart
    of `session_ack_impl` (emqx_tpu/ops/session_table.py:76).

    tables: {lane: int32 tensor} (the rider's mirror generation, never
    written); idxs/vals: {lane: int32 write indices and values}, applied
    as ``tables[k][idxs[k]] = vals[k]`` by ONE `segment_scatter` call
    into fresh tensors (lanes without writes pass through by reference);
    clock: ``(now_ds, retry_ds)`` int32, a host array. Returns ``{"tables": ...}`` and,
    when ``sweep_k > 0``, ``due``, ``due_count``, ``expired`` and
    ``expired_count`` from `session_sweep` over the scattered lanes, on
    the same stream."""
    return _ack(tables, idxs, vals, clock, sweep_k, segment_scatter, session_sweep)


def _mix(slot, pid):
    """Row hash of (slot, pid) — vectorized 32-bit mixing in uint64
    lanes (masked, so numpy never warns on scalar overflow), the same
    independent-multiplier shape as the route index's fid table."""
    m32 = np.uint64(0xFFFFFFFF)
    a = (
        (np.asarray(slot, np.uint64) * np.uint64(0x9E3779B1))
        ^ (np.asarray(pid, np.uint64) * np.uint64(0x85EBCA77))
    ) & m32
    a ^= a >> np.uint64(15)
    return (a * np.uint64(0xC2B2AE35)) & m32


def _step(slot, pid):
    """Odd probe stride (full cycle over any pow2 capacity): decouples
    probe paths that share a starting row, so clustering never walls a
    bulk load the way a linear stride does."""
    return (
        (np.asarray(pid, np.uint64) << np.uint64(1))
        ^ np.asarray(slot, np.uint64)
    ) | np.uint64(1)


class SessionTable:
    """Host-authoritative open-addressing (slot, pid) -> row store: the
    port's copy of `SessionTable` (emqx_tpu/ops/session_table.py:158).

    Implements the segment-manager source protocol (`epoch`, `version`,
    `oplog`, `device_snapshot`) so `DeviceSegmentManager` mirrors it like
    every other table owner; the hot mutation stream additionally rides
    serving launches via `SessionStore.take_rider`. Growth of the row
    table doubles capacity and bumps the epoch (full re-upload); growth
    of the per-slot lanes re-uploads those arrays ALONE via the
    per-array `!resync` marker.
    """

    def __init__(self, capacity: int = 1024, slots: int = 256):
        cap = _next_pow2(max(64, capacity))
        scap = _next_pow2(max(64, slots))
        self._cap = cap
        self._scap = scap
        self.sess_slot = np.full(cap, EMPTY, np.int32)
        self.sess_pid = np.zeros(cap, np.int32)
        self.sess_state = np.zeros(cap, np.int32)
        self.sess_ts = np.zeros(cap, np.int32)
        self.sess_mid = np.full(cap, -1, np.int32)
        self.slot_expiry = np.zeros(scap, np.int32)
        self.live = 0
        self.tombstones = 0
        self.epoch = 0
        self.version = 0
        self.oplog: list = []
        self.OPLOG_MAX = 262144
        # compaction journal (loop-thread): semantic (slot,pid) upserts/
        # clears that raced a background rebuild — row ids relocate, so
        # raw lane writes cannot replay
        self._journal: Optional[list] = None
        self._structure_gen = 0

    # -- op-log plumbing ---------------------------------------------------
    def _bump(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1
        self._structure_gen += 1

    def _log(self, name: str, idx: int, val: int) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump()
            return
        self.oplog.append((name, int(idx), int(val)))

    def _log_resync(self, name: str) -> None:
        """Per-array re-upload marker. Appending through `_log` and
        rewriting `oplog[-1]` is NOT equivalent: at OPLOG_MAX `_log`
        bumps the epoch and clears the log, so the rewrite would blow
        up on an empty list (and the bump already covers the grow)."""
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump()
            return
        self.oplog.append((RESYNC, name, 0))

    def device_snapshot(self) -> Dict[str, np.ndarray]:
        return {
            "sess_slot": self.sess_slot,
            "sess_pid": self.sess_pid,
            "sess_state": self.sess_state,
            "sess_ts": self.sess_ts,
            "sess_mid": self.sess_mid,
            "slot_expiry": self.slot_expiry,
        }

    # -- probing -----------------------------------------------------------
    def _find(self, slot: int, pid: int) -> int:
        """Row of a live (slot, pid) entry, or -1."""
        mask = self._cap - 1
        h = int(_mix(slot, pid))
        st = int(_step(slot, pid))
        for r in range(SESSION_PROBES):
            row = (h + r * st) & mask
            if self.sess_slot[row] == EMPTY:
                return -1
            if (
                self.sess_slot[row] == slot
                and self.sess_pid[row] == pid
            ):
                return row
        return -1

    def _find_free(self, slot: int, pid: int) -> int:
        """First empty/tombstone row on the probe path, or -1 (full)."""
        mask = self._cap - 1
        h = int(_mix(slot, pid))
        st = int(_step(slot, pid))
        for r in range(SESSION_PROBES):
            row = (h + r * st) & mask
            if self.sess_slot[row] < 0:
                return row
        return -1

    def lookup_batch(self, slots, pids) -> np.ndarray:
        """Vectorized (slot, pid) -> row (-1 miss): one gather per probe
        round over the whole batch — the EMOMA exact-match idiom."""
        slots = np.asarray(slots, np.int64)
        pids = np.asarray(pids, np.int64)
        n = len(slots)
        mask = self._cap - 1
        h = _mix(slots, pids).astype(np.int64)
        st = _step(slots, pids).astype(np.int64)
        found = np.full(n, -1, np.int64)
        dead = np.zeros(n, bool)  # hit a hard EMPTY: stop probing
        for r in range(SESSION_PROBES):
            rows = (h + r * st) & mask
            open_ = (found < 0) & ~dead
            ent_slot = self.sess_slot[rows]
            hit = open_ & (ent_slot == slots) & (self.sess_pid[rows] == pids)
            found[hit] = rows[hit]
            dead |= open_ & (ent_slot == EMPTY)
            if not open_.any():
                break
        return found.astype(np.int64)

    # -- mutation ----------------------------------------------------------
    def _write_row(self, row: int, slot: int, pid: int, state: int,
                   ts: int, mid: int) -> None:
        self.sess_slot[row] = slot
        self.sess_pid[row] = pid
        self.sess_state[row] = state
        self.sess_ts[row] = ts
        self.sess_mid[row] = mid
        self._log("sess_slot", row, slot)
        self._log("sess_pid", row, pid)
        self._log("sess_state", row, state)
        self._log("sess_ts", row, ts)
        self._log("sess_mid", row, mid)

    def insert(self, slot: int, pid: int, state: int, ts: int,
               mid: int = -1) -> int:
        """Upsert one (slot, pid) row; returns its row id. Grows (epoch
        bump) when the probe path is saturated or load passes 3/4."""
        if self._journal is not None:
            self._journal.append(("set", slot, pid, state, ts, mid))
        row = self._find(slot, pid)
        if row < 0:
            if self.live + self.tombstones >= (self._cap * 3) // 4:
                self._grow(self._cap * 2)
            row = self._find_free(slot, pid)
            while row < 0:
                self._grow(self._cap * 2)
                row = self._find_free(slot, pid)
            if self.sess_slot[row] == TOMB:
                self.tombstones -= 1
            self.live += 1
        self._write_row(row, slot, pid, state, ts, mid)
        return row

    def set_state(self, row: int, state: int, ts: int,
                  mid: Optional[int] = None) -> None:
        if self._journal is not None:
            self._journal.append(
                ("set", int(self.sess_slot[row]), int(self.sess_pid[row]),
                 state, ts, self.sess_mid[row] if mid is None else mid)
            )
        self.sess_state[row] = state
        self.sess_ts[row] = ts
        self._log("sess_state", row, state)
        self._log("sess_ts", row, ts)
        if mid is not None:
            self.sess_mid[row] = mid
            self._log("sess_mid", row, mid)

    def touch(self, row: int, ts: int) -> None:
        """Refresh the retransmit stamp after a resend."""
        self.sess_ts[row] = ts
        self._log("sess_ts", row, ts)

    def touch_many(self, rows, ts: int) -> None:
        """Vectorized stamp refresh for a whole sweep's retransmits:
        one scatter store + one op-log extend (the redelivery flood
        used to pay `touch`'s per-row `_log` a million times)."""
        rows = np.asarray(rows, np.int64)
        if not rows.size:
            return
        self.sess_ts[rows] = ts
        if len(self.oplog) + rows.size > self.OPLOG_MAX:
            self._bump()  # overflow: next sync is a full re-upload
            return
        self.version += int(rows.size)
        t = int(ts)
        self.oplog.extend(("sess_ts", int(r), t) for r in rows)

    def clear(self, row: int) -> int:
        """Tombstone one row; returns the message id it carried.

        Idempotent: clearing an EMPTY/TOMB row is a no-op returning -1.
        Without the guard a duplicate clear (e.g. a redundant ack path
        holding a stale row handle) double-decrements `live` AND — when
        a compaction capture is open — journals the tombstone sentinel
        as the slot, which a later `apply_compact` replay feeds to
        `_find`/`_mix` where the negative value overflows uint64. The
        crash fires an arbitrary number of mutations after the actual
        bug, so it is stopped here at the source."""
        if self.sess_slot[row] < 0:
            return -1
        if self._journal is not None:
            self._journal.append(
                ("clear", int(self.sess_slot[row]),
                 int(self.sess_pid[row]), 0, 0, -1)
            )
        mid = int(self.sess_mid[row])
        self.sess_slot[row] = TOMB
        self.sess_state[row] = FREE
        self.sess_mid[row] = -1
        self._log("sess_slot", row, TOMB)
        self._log("sess_state", row, FREE)
        self._log("sess_mid", row, -1)
        self.live -= 1
        self.tombstones += 1
        return mid

    def set_expiry(self, slot: int, deadline_ds: int) -> None:
        if slot >= self._scap:
            self._grow_slots(_next_pow2(slot + 1))
        if self._journal is not None:
            self._journal.append(("expiry", slot, 0, 0, deadline_ds, -1))
        self.slot_expiry[slot] = deadline_ds
        self._log("slot_expiry", slot, deadline_ds)

    def bulk_insert(self, slots, pids, states, tss, mids) -> np.ndarray:
        """Vectorized cold/storm load of UNIQUE (slot, pid) keys: place
        everything with round-robin probe bidding (the `_bulk_place_hot`
        idiom) and ONE epoch bump. Returns the placed row ids (-1 = lost
        after growth retries — callers treat that as table-full)."""
        slots = np.asarray(slots, np.int64)
        pids = np.asarray(pids, np.int64)
        states = np.asarray(states, np.int64)
        tss = np.asarray(tss, np.int64)
        mids = np.asarray(mids, np.int64)
        n = len(slots)
        while self.live + self.tombstones + n > (self._cap * 3) // 4:
            self._grow(self._cap * 2)
        rows = self._bulk_place(slots, pids, states, tss, mids)
        for _ in range(4):
            lost = rows < 0
            if not lost.any():
                break
            # saturated probe paths: double (relocating every placed
            # entry), place ONLY the losers, then re-resolve all row ids
            # against the grown table — never re-place a placed key
            self._grow(self._cap * 2)
            self._bulk_place(
                slots[lost], pids[lost], states[lost], tss[lost],
                mids[lost],
            )
            rows = self.lookup_batch(slots, pids)
        self._bump()
        return rows

    # oplog-covered-by: callers (_grow / bulk_insert) bump the epoch
    def _bulk_place(self, slots, pids, states, tss, mids) -> np.ndarray:
        mask = self._cap - 1
        n = len(slots)
        h = _mix(slots, pids).astype(np.int64)
        stp = _step(slots, pids).astype(np.int64)
        rows = np.full(n, -1, np.int64)
        pending = np.arange(n)
        for r in range(SESSION_PROBES):
            if not len(pending):
                break
            cand = (h[pending] + r * stp[pending]) & mask
            free = self.sess_slot[cand] < 0
            bid = pending[free]
            brow = cand[free]
            # first bidder per row wins this round; losers re-probe
            uniq, first = np.unique(brow, return_index=True)
            win = bid[first]
            wrow = brow[first]
            tomb = self.sess_slot[wrow] == TOMB
            self.tombstones -= int(np.count_nonzero(tomb))
            self.sess_slot[wrow] = slots[win]
            self.sess_pid[wrow] = pids[win]
            self.sess_state[wrow] = states[win]
            self.sess_ts[wrow] = tss[win]
            self.sess_mid[wrow] = mids[win]
            rows[win] = wrow
            self.live += len(win)
            pending = pending[rows[pending] < 0]
        return rows

    # -- growth ------------------------------------------------------------
    def _grow(self, new_cap: int) -> None:
        """Double the row table and re-place every live entry (epoch
        bump: full re-upload, one recompile of the table-shaped jits)."""
        old = (
            self.sess_slot, self.sess_pid, self.sess_state,
            self.sess_ts, self.sess_mid,
        )
        live = np.nonzero(old[0] >= 0)[0]
        self._cap = new_cap
        self.sess_slot = np.full(new_cap, EMPTY, np.int32)
        self.sess_pid = np.zeros(new_cap, np.int32)
        self.sess_state = np.zeros(new_cap, np.int32)
        self.sess_ts = np.zeros(new_cap, np.int32)
        self.sess_mid = np.full(new_cap, -1, np.int32)
        self.live = 0
        self.tombstones = 0
        if len(live):
            self._bulk_place(
                old[0][live].astype(np.int64),
                old[1][live].astype(np.int64),
                old[2][live].astype(np.int64),
                old[3][live].astype(np.int64),
                old[4][live].astype(np.int64),
            )
        self._bump()

    def _grow_slots(self, new_scap: int) -> None:
        new = np.zeros(new_scap, np.int32)
        new[: self._scap] = self.slot_expiry
        self.slot_expiry = new
        self._scap = new_scap
        # small lane: re-upload ALONE (never the row table) — the
        # per-array resync marker exists for exactly this
        self._log_resync("slot_expiry")

    # -- host sweeps (authoritative; the device sweep mirrors these) -------
    def due_rows(self, now_ds: int, retry_ds: int) -> np.ndarray:
        """QoS retransmit scan (publish phase -> dup PUBLISH, rel phase
        -> PUBREL) — one vectorized pass, no dict walk."""
        return np.nonzero(
            (self.sess_slot >= 0)
            & (
                (self.sess_state == ST_PUBLISH)
                | (self.sess_state == ST_PUBREL)
            )
            & ((now_ds - self.sess_ts) >= retry_ds)
        )[0]

    def expired_slots(self, now_ds: int) -> np.ndarray:
        return np.nonzero(
            (self.slot_expiry > 0) & (self.slot_expiry <= now_ds)
        )[0]

    def rows_of_slot(self, slot: int) -> np.ndarray:
        """Every live row owned by one session (resume/drop path)."""
        return np.nonzero(self.sess_slot == slot)[0]

    # -- compaction (SegmentCompactor owner protocol) ----------------------
    def begin_compact(self) -> Dict:
        self._journal = []
        return {
            "arrays": {k: v.copy() for k, v in self.device_snapshot().items()},
            "cap": self._cap,
            "gen": self._structure_gen,
        }

    @staticmethod
    def build_compact(cap: Dict) -> Dict:
        """Re-place every live row into a fresh table (tombstones
        purged). Pure numpy over the capture — any thread."""
        arrs = cap["arrays"]
        live = np.nonzero(arrs["sess_slot"] >= 0)[0]
        built = SessionTable(capacity=cap["cap"], slots=1)
        built.slot_expiry = arrs["slot_expiry"].copy()
        built._scap = len(built.slot_expiry)
        if len(live):
            built._bulk_place(
                arrs["sess_slot"][live].astype(np.int64),
                arrs["sess_pid"][live].astype(np.int64),
                arrs["sess_state"][live].astype(np.int64),
                arrs["sess_ts"][live].astype(np.int64),
                arrs["sess_mid"][live].astype(np.int64),
            )
        return {"table": built, "gen": cap["gen"]}

    def apply_compact(self, built: Dict) -> Optional[int]:
        """Swap in the rebuilt table + replay the journal of racing
        mutations (semantic (slot, pid) upserts — row ids relocated).
        Returns the new epoch, or None when a structural event
        invalidated the capture."""
        journal = self._journal
        self._journal = None
        if journal is None or built["gen"] != self._structure_gen:
            return None
        t = built["table"]
        self._cap = t._cap
        self._scap = t._scap
        self.sess_slot = t.sess_slot
        self.sess_pid = t.sess_pid
        self.sess_state = t.sess_state
        self.sess_ts = t.sess_ts
        self.sess_mid = t.sess_mid
        self.slot_expiry = t.slot_expiry
        self.live = t.live
        self.tombstones = t.tombstones
        self._bump()
        for op, slot, pid, state, ts, mid in journal:
            if op == "set":
                self.insert(slot, pid, state, ts, mid)
            elif op == "clear":
                row = self._find(slot, pid)
                if row >= 0:
                    self.clear(row)
            elif op == "expiry":
                self.set_expiry(slot, ts)
        return self.epoch


class SessionSegmentOwner:
    """Compaction adapter for a `SessionTable` + its manager: purge
    tombstoned (acked) rows off the critical path, uploading the rebuilt
    table on the compaction thread — the `ShapeSegmentOwner` contract,
    fourth owner on the one `SegmentCompactor`. The port's copy of
    emqx_tpu/ops/session_table.py:564."""

    key = "sessions"

    def __init__(self, table: SessionTable, manager, placement=None,
                 tombstone_frac: float = 0.25):
        self.table = table
        self.manager = manager
        self._placement = placement
        self.tombstone_frac = tombstone_frac

    def needs_compact(self) -> bool:
        t = self.table
        return t.tombstones > 0 and (
            t.tombstones >= self.tombstone_frac * t._cap
        )

    def begin(self):
        return self.table.begin_compact()

    def build(self, cap):
        from emqx_tpu_torch.ops.segments import upload_offer

        built = SessionTable.build_compact(cap)
        built["devs"] = upload_offer(built["table"].device_snapshot(), self.manager.device,
                                     self._placement)
        return built

    def apply(self, built):
        from emqx_tpu_torch.ops.segments import fresh_offer

        merged = self.table.tombstones
        epoch0 = self.table.epoch
        epoch = self.table.apply_compact(built)
        if epoch is None:
            return None
        return epoch, fresh_offer(built["devs"], epoch, epoch0), 0, merged
