"""Filter-shape hash index: the large-table fast path of the route matcher,
the port's copy of `emqx_tpu/ops/shape_index.py`.

Real subscription tables cluster into a handful of *shapes* — patterns of
(literal | +) positions with an optional trailing '#'. The reference's trie
compaction leans on the same observation (literal runs between wildcards,
emqx_trie.erl:201-232); taken to its batch-kernel conclusion, matching
becomes:

    for each shape m:  one combined hash over the topic's words at m's
                       literal positions  ->  one table probe

i.e. O(#shapes) hashes + probes per topic, independent of filter count and
topic depth. The per-level word hashes come out of the tokenizer kernel
(ops/tokenizer.py); the combined hash is a masked sum-product over levels.
Only the final table probe touches device memory, reading ONE fused
16-byte row per (topic, shape, probe).

The host side (everything down to `ShapeIndex.apply_compact`) is numpy, bit
for bit as in the JAX package. The device side is `shape_match`: the
hand-written kernel `kernels/csrc/shape_match.cu` on CUDA tensors, its
plain PyTorch twin `shape_match_plain` on CPU tensors.

Filters whose shape doesn't fit (more than MAX_SHAPES distinct shapes, or
a 2^-64 combined-hash collision) fall back to the residual NFA engine —
correctness never depends on the shape heuristic.

Host-side updates follow the same delta-overlay protocol as NfaBuilder
(epoch / oplog / device_snapshot; see ops/nfa.py): the router's device
mirror (`ops.segments.DeviceSegmentManager`) replays the op-log suffix as
one `segment_scatter` launch, and uploads in full only when the epoch
moves.

Update-path segmentation (docs/update_path.md): the PACKED table
(`arr_table`) is written only by rebuilds — cold bulk loads and
compaction. Incremental subscribes land in a small append-only **hot
segment** (`arr_hot`, an open-addressing table probed with the same
slot_hash/probe_step sequence), so a subscribe is O(1) host writes plus
one device scatter, never an O(table) rehash; unsubscribes of packed
entries set a bit in a **tombstone mask** (`arr_tomb`) instead of
touching the row. The device kernel matches against
``packed ∪ hot − tombstones`` in the same single launch, and a
background compaction (`ops.segments.SegmentCompactor` with
`ShapeSegmentOwner`) periodically merges the hot segment into a rebuilt
packed table off the critical path, replaying the mutations that raced
the build from a journal.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.ops.nfa import MAX_PROBES, _next_pow2, word_hash_pair

_M32 = 0xFFFFFFFF

MAX_SHAPES = 64
MAX_MASK_LEVELS = 32  # literal mask is one int32
# open-addressing probe bound. The DEVICE kernel must probe at least this
# far or host-placed entries at the cluster tail become invisible to it —
# shape_match_device and ShapeIndex._place share this constant.
SHAPE_PROBES = MAX_PROBES

# per-level combining multipliers (odd => bijective mod 2^32) and the
# shape-id fold constants; the device kernel computes the same values
K1_MUL = 0x9E3779B1
K2_MUL = 0x85EBCA77
FOLD1 = 0xC2B2AE35
FOLD2 = 0x27D4EB2F
SLOT_MUL = 0x165667B1
SLOT_SHIFT = 14

TOMB_FID = -2  # tombstoned table slot (fid lane)


def _mix32_np(x):
    """Vectorized `_mix32` (numpy uint32, wraps mod 2^32)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x = x * np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _mix32(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def level_mul(l: int, which: int) -> int:
    base = K1_MUL if which == 1 else K2_MUL
    return (base * (l + 1) * 2 + 1) & _M32


def combined_pair(words: List[str], mask: int, shape_id: int, salt: int) -> Tuple[int, int]:
    """(c1, c2) for a filter's literal words / a topic probed under a shape."""
    s1 = 0
    s2 = 0
    for l, w in enumerate(words):
        if mask >> l & 1:
            h1, h2 = word_hash_pair(w, salt)
            s1 = (s1 + h1 * level_mul(l, 1)) & _M32
            s2 = (s2 + h2 * level_mul(l, 2)) & _M32
    c1 = _mix32(s1 ^ ((shape_id * FOLD1) & _M32))
    c2 = _mix32(s2 ^ ((shape_id * FOLD2) & _M32))
    return c1, c2


def slot_hash(c1: int) -> int:
    h = (c1 * SLOT_MUL) & _M32
    h ^= h >> SLOT_SHIFT
    return h


def probe_step(c2: int) -> int:
    """Double-hashing probe stride (odd => full cycle mod pow2 capacity).

    Linear probing's clustering makes an 8-probe bound fail thousands of
    placements at 10M entries even at 30% load (forcing capacity
    doublings into the GBs); with a c2-derived stride the probe sequence
    is uniform and P(8 occupied) ~ load^8."""
    return (c2 | 1) & _M32


class ShapeIndex:
    """Incrementally-maintained shape hash index (host side).

    Accepts filters whose (wildcard-shape, combined-hash) fit; `add`
    returns False when the filter must go to the residual NFA engine.
    """

    OPLOG_MAX = 65536
    HOT_MIN = 256  # initial/minimum hot-segment capacity (pow2)
    # largest hot-segment population a warm bulk_add may leave behind;
    # bigger loads take the classic packed rebuild (they are restore-
    # scale, already epoch-bump territory)
    HOT_ABSORB_MAX = 1 << 17

    def __init__(self, salt: int = 0, max_shapes: int = MAX_SHAPES):
        self.salt = salt
        self.max_shapes = max_shapes
        # shape registry: key -> shape id
        self._shape_ids: Dict[Tuple[int, int, bool], int] = {}
        self._shape_refs: List[int] = []
        self._free_shapes: List[int] = []
        # shape meta (fixed capacity; device slices [0:M_active])
        self.arr_shape_mask = np.zeros(max_shapes, np.int32)
        self.arr_shape_len = np.full(max_shapes, -1, np.int32)  # -1 = dead
        self.arr_shape_flags = np.zeros(max_shapes, np.int32)  # 1=#, 2=rootwild
        # PACKED filter table: fused [T, 4] int32 (c1, c2, fid, shape_id);
        # written only by rebuilds (cold bulk load / compaction)
        self._Tcap = 1024
        self.arr_table = np.zeros((self._Tcap, 4), np.int32)
        self.arr_table[:, 2] = -1  # fid lane: -1 empty
        self._fill = 0  # non-empty slots (live + tombstones)
        # packed-row tombstone mask: bit i set => packed slot i is dead.
        # Unsubscribe flips ONE bit (one device scatter word) instead of
        # rewriting the row; compaction purges the mask.
        self.arr_tomb = np.zeros(self._Tcap // 32, np.uint32)
        self._tombs = 0  # tombstoned packed slots
        # HOT segment: same fused [H, 4] layout + probe sequence as the
        # packed table, but small and append-only between compactions.
        # Every incremental add lands here — the packed table never
        # rehashes on the subscribe path.
        self._Hcap = self.HOT_MIN
        self.arr_hot = np.zeros((self._Hcap, 4), np.int32)
        self.arr_hot[:, 2] = -1
        self._hot_fill = 0  # non-empty hot slots (live + tombstones)
        self._hot_tombs = 0
        self._in_hot: set = set()  # filters currently living in hot
        # compaction bookkeeping: a capture is valid while no structural
        # rebuild (_rehash / cold load) happened; mutations racing an
        # outstanding build are journaled and replayed at apply
        self._structure_gen = 0
        self._journal: Optional[list] = None  # single-writer: loop
        # The packed/hot arrays ARE the host mirror: an entry's
        # (c1, c2) recomputes from its filter string (shape registry +
        # salt) and its row is found by the same probe walk the device
        # runs — no 10M-entry shadow dicts, so nothing materializes on
        # the first post-restore subscribe/unsubscribe (the dict version
        # cost a ~30s one-shot stall there). Name recovery for the rare
        # salt rebuild goes through `resolve_name` (fid -> filter; set
        # by RouteIndex to its registry lookup).
        self.resolve_name: Optional[Callable[[int], Optional[str]]] = None
        self.epoch = 0
        self.oplog: list = []
        self.version = 0

    # -- host probe mirror -------------------------------------------------
    def _find_live(self, c1: int, c2: int):
        """Locate the LIVE row holding (c1, c2): -> (in_hot, idx, fid,
        sid) or None. Walks the same (home, stride) probe sequence as
        the device kernel — hot segment first, then the packed table
        with its tombstone mask."""
        cc1 = np.int32(np.uint32(c1))
        cc2 = np.int32(np.uint32(c2))
        slot = slot_hash(c1)
        step = probe_step(c2)
        hot = self.arr_hot
        for p in range(MAX_PROBES):
            idx = (slot + p * step) & (self._Hcap - 1)
            if (
                hot[idx, 2] >= 0
                and hot[idx, 0] == cc1
                and hot[idx, 1] == cc2
            ):
                return True, idx, int(hot[idx, 2]), int(hot[idx, 3])
        tab = self.arr_table
        for p in range(MAX_PROBES):
            idx = (slot + p * step) & (self._Tcap - 1)
            if (
                tab[idx, 2] >= 0
                and tab[idx, 0] == cc1
                and tab[idx, 1] == cc2
                and not (self.arr_tomb[idx >> 5] >> (idx & 31)) & 1
            ):
                return False, idx, int(tab[idx, 2]), int(tab[idx, 3])
        return None

    def _find_live_batch(self, c1s: np.ndarray, c2s: np.ndarray):
        """Vectorized `_find_live` existence test for a batch of
        (c1, c2) pairs (uint32 arrays) -> bool [n]. One probe-round
        sweep over the hot segment and the packed table."""
        n = len(c1s)
        with np.errstate(over="ignore"):
            home = c1s * np.uint32(SLOT_MUL)
            home = home ^ (home >> np.uint32(SLOT_SHIFT))
            step = c2s | np.uint32(1)
        cc1 = c1s.view(np.int32)
        cc2 = c2s.view(np.int32)
        found = np.zeros(n, bool)
        hot, Hm = self.arr_hot, np.uint32(self._Hcap - 1)
        tab, Tm = self.arr_table, np.uint32(self._Tcap - 1)
        with np.errstate(over="ignore"):
            for p in range(MAX_PROBES):
                idx = ((home + np.uint32(p) * step) & Hm).astype(np.int64)
                row = hot[idx]
                found |= (
                    (row[:, 2] >= 0)
                    & (row[:, 0] == cc1)
                    & (row[:, 1] == cc2)
                )
            for p in range(MAX_PROBES):
                idx = ((home + np.uint32(p) * step) & Tm).astype(np.int64)
                row = tab[idx]
                alive = (row[:, 2] >= 0) & (
                    (
                        (self.arr_tomb[idx >> 5] >> (idx & 31).astype(
                            np.uint32
                        ))
                        & np.uint32(1)
                    )
                    == 0
                )
                found |= alive & (row[:, 0] == cc1) & (row[:, 1] == cc2)
        return found

    def _ent_of(self, filter_: str):
        """Recompute `filter_`'s entry from live state: -> (sid, c1, c2,
        fid) or None when absent. The shape registry lookup is read-only
        (no ref bump)."""
        parsed = self.parse_shape(filter_)
        if parsed is None:
            return None
        mask, plen, has_hash, prefix = parsed
        sid = self._shape_ids.get((mask, plen, has_hash))
        if sid is None:
            return None
        c1, c2 = combined_pair(prefix, mask, sid, self.salt)
        found = self._find_live(c1, c2)
        if found is None:
            return None
        _in_hot, _idx, fid, row_sid = found
        if row_sid != sid:
            return None  # foreign row (collision shadow): not ours
        if self.resolve_name is not None:
            owner = self.resolve_name(fid)
            if owner is not None and owner != filter_:
                return None  # 64-bit collision: the live row is another's
        return sid, c1, c2, fid

    def _live_rows(self, with_hot: bool = True) -> np.ndarray:
        """All live rows [(c1, c2, fid, sid)] as an int32 [n, 4] matrix:
        packed minus tombstones, plus (optionally) the hot segment."""
        idx = np.nonzero(self.arr_table[:, 2] >= 0)[0]
        tword = self.arr_tomb[idx >> 5]
        dead = (tword >> (idx & 31).astype(np.uint32)) & np.uint32(1)
        rows = [self.arr_table[idx[dead == 0]]]
        if with_hot:
            rows.append(self.arr_hot[self.arr_hot[:, 2] >= 0])
        return np.concatenate(rows, axis=0)

    # -- delta protocol ----------------------------------------------------
    def _log(self, name: str, idx: int, val: int) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        self.oplog.append((name, int(idx), int(val)))

    def _bump_epoch(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _log_resync(self, name: str) -> None:
        """Per-array resync marker: consumers re-upload ONLY `name`
        (DeviceSegmentManager) — the big packed table never rides along
        with a hot-segment rebuild."""
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        from emqx_tpu_torch.ops.segments import RESYNC

        self.oplog.append((RESYNC, name, 0))

    def device_snapshot(self) -> Dict[str, np.ndarray]:
        return {
            # flat view: row-major [T,4] -> [T*4], matching the oplog's
            # flat indices
            "shape_tab": self.arr_table.reshape(-1),
            "shape_hot": self.arr_hot.reshape(-1),
            "shape_tomb": self.arr_tomb,
            "shape_mask": self.arr_shape_mask,
            "shape_len": self.arr_shape_len,
            "shape_flags": self.arr_shape_flags,
        }

    # -- segment status (metrics / compaction triggers) --------------------
    @property
    def hot_live(self) -> int:
        return self._hot_fill - self._hot_tombs

    @property
    def hot_capacity(self) -> int:
        return self._Hcap

    @property
    def packed_tombstones(self) -> int:
        return self._tombs

    # -- shape parsing -----------------------------------------------------
    @staticmethod
    def parse_shape(filter_: str) -> Optional[Tuple[int, int, bool, List[str]]]:
        """-> (literal_mask, prefix_len, has_hash, words) or None if unfit."""
        ws = T.words(filter_)
        has_hash = bool(ws) and ws[-1] == "#"
        prefix = ws[:-1] if has_hash else ws
        if len(prefix) > MAX_MASK_LEVELS:
            return None
        mask = 0
        for l, w in enumerate(prefix):
            if w == "#":
                return None  # invalid anyway ('# only last'), but be safe
            if w != "+":
                mask |= 1 << l
        return mask, len(prefix), has_hash, prefix

    # -- mutation ----------------------------------------------------------
    def _shape_for(self, mask: int, plen: int, has_hash: bool) -> Optional[int]:
        key = (mask, plen, has_hash)
        sid = self._shape_ids.get(key)
        if sid is not None:
            self._shape_refs[sid] += 1
            return sid
        if self._free_shapes:
            sid = self._free_shapes.pop()
        elif len(self._shape_refs) < self.max_shapes:
            sid = len(self._shape_refs)
            self._shape_refs.append(0)
        else:
            return None  # shape overflow -> residual
        self._shape_ids[key] = sid
        self._shape_refs[sid] = 1
        rootwild = (plen == 0 and has_hash) or (plen > 0 and not (mask & 1))
        flags = (1 if has_hash else 0) | (2 if rootwild else 0)
        # int32 wrap: a 32-literal-level mask sets bit 31; the device's
        # arithmetic shift + &1 reads bits identically either way
        mask_i32 = int(np.int32(np.uint32(mask)))
        self.arr_shape_mask[sid] = mask_i32
        self._log("shape_mask", sid, mask_i32)
        self.arr_shape_flags[sid] = flags
        self._log("shape_flags", sid, flags)
        self.arr_shape_len[sid] = plen
        self._log("shape_len", sid, plen)
        return sid

    def _shape_release(self, sid: int, key: Tuple[int, int, bool]) -> None:
        self._shape_refs[sid] -= 1
        if self._shape_refs[sid] == 0:
            del self._shape_ids[key]
            self._free_shapes.append(sid)
            self.arr_shape_len[sid] = -1  # dead: never matches
            self._log("shape_len", sid, -1)

    def num_active_shapes(self) -> int:
        """High-water shape id + 1 (device meta slice length)."""
        return len(self._shape_refs)

    def m_active(self, floor: int = 4) -> int:
        """Device meta slice length, pow2-bucketed as in the JAX package
        (whose compiled step changes only on doublings), clamped to capacity
        (max_shapes need not be a power of two). The single source for
        every shape_route_step caller."""
        return min(
            _next_pow2(max(floor, self.num_active_shapes())),
            self.max_shapes,
        )

    def _place_hot(self, filter_: str, c1: int, c2: int, fid: int,
                   sid: int) -> None:
        """O(1) insert into the hot segment (probe placement + 4 logged
        writes = one device scatter). The caller has already registered
        key uniqueness against the live tables. Growth rebuilds ONLY the hot
        segment (small) and re-uploads only it (resync marker)."""
        if (self._hot_fill + 1) * 2 > self._Hcap:
            self._rebuild_hot(extra=[(filter_, c1, c2, fid, sid)])
            return
        slot = slot_hash(c1)
        step = probe_step(c2)
        for p in range(MAX_PROBES):
            idx = (slot + p * step) & (self._Hcap - 1)
            f = self.arr_hot[idx, 2]
            if f == -1 or f == TOMB_FID:
                if f == -1:
                    self._hot_fill += 1
                else:
                    self._hot_tombs -= 1
                row = (
                    int(np.int32(np.uint32(c1))),
                    int(np.int32(np.uint32(c2))),
                    fid,
                    sid,
                )
                self.arr_hot[idx] = row
                base = idx * 4
                for lane in range(4):
                    self._log("shape_hot", base + lane, row[lane])
                self._in_hot.add(filter_)
                return
        # probe window full (pathological cluster): grow + rebuild hot
        self._rebuild_hot(extra=[(filter_, c1, c2, fid, sid)])

    def _rebuild_hot(self, extra=(), min_cap: int = 0) -> None:
        """Rebuild the hot segment (vectorized placement, drops hot
        tombstones) sized for its live population plus `extra` fresh
        entries [(filter, c1, c2, fid, sid)]. O(hot) — the hot segment is
        small by construction; one `!resync` marker re-uploads it."""
        live = self.arr_hot[self.arr_hot[:, 2] >= 0]  # drops tombs
        n = len(live) + len(extra)
        if n > self.HOT_ABSORB_MAX:
            # no compactor drained the hot segment (standalone index):
            # fold everything into the packed table inline, `extra`
            # rides along explicitly (it is not in any array yet)
            self._rehash(
                self._Tcap,
                extra=[(a, b, f, s) for _name, a, b, f, s in extra],
            )
            return
        newH = max(
            self.HOT_MIN, min_cap, _next_pow2(2 * (n + 1))
        )
        sid = np.empty(n, np.int64)
        c1 = np.empty(n, np.uint32)
        c2 = np.empty(n, np.uint32)
        fid = np.empty(n, np.int64)
        k = len(live)
        sid[:k] = live[:, 3].astype(np.int64)
        c1[:k] = np.ascontiguousarray(live[:, 0]).view(np.uint32)
        c2[:k] = np.ascontiguousarray(live[:, 1]).view(np.uint32)
        fid[:k] = live[:, 2].astype(np.int64)
        for j, (name, a, b, f, s) in enumerate(extra):
            i = k + j
            sid[i], c1[i], c2[i], fid[i] = s, a & _M32, b & _M32, f
            self._in_hot.add(name)
        tab, newH = self._build_table(sid, c1, c2, fid, newH)
        self._Hcap = newH
        self.arr_hot = tab
        self._hot_fill = n
        self._hot_tombs = 0
        self._log_resync("shape_hot")

    def _bulk_place_hot(self, accepted) -> None:
        """Vectorized placement of a fresh batch [(filter, c1, c2, fid,
        sid)] into the LIVE hot table — probe-round bidding in the
        `_build_table` style, O(batch) not O(hot), with ONE `!resync`
        marker (re-uploading the small hot array beats logging 4 scalar
        writes per entry, and keeps the op-log flat under churn storms).
        This is what lets a mass-reconnect wave land at millions of
        subscribes/sec without ever touching the packed table."""
        n = len(accepted)
        if n == 0:
            return
        if self.hot_live + n > self.HOT_ABSORB_MAX:
            # restore-scale batch: classic full rebuild, one epoch bump
            # (the batch rows ride as extras — they are in no array yet)
            self._rehash(
                self._Tcap,
                extra=[(a, b, f, s) for _name, a, b, f, s in accepted],
            )
            return
        if (self._hot_fill + n + 1) * 2 > self._Hcap:
            self._rebuild_hot(extra=accepted)  # grows + places, 1 marker
            return
        c1 = np.fromiter((a[1] & _M32 for a in accepted), np.uint32, n)
        c2 = np.fromiter((a[2] & _M32 for a in accepted), np.uint32, n)
        fidv = np.fromiter((a[3] for a in accepted), np.int64, n)
        sidv = np.fromiter((a[4] for a in accepted), np.int64, n)
        with np.errstate(over="ignore"):
            home = c1 * np.uint32(SLOT_MUL)
            home = home ^ (home >> np.uint32(SLOT_SHIFT))
            step = c2 | np.uint32(1)
        H = self._Hcap
        tab = self.arr_hot
        unplaced = np.arange(n)
        placed_empty = 0
        for p in range(MAX_PROBES):
            if not len(unplaced):
                break
            with np.errstate(over="ignore"):
                idx = (
                    home[unplaced] + np.uint32(p) * step[unplaced]
                ) & np.uint32(H - 1)
            idx = idx.astype(np.int64)
            free = tab[idx, 2] == -1  # tombs stay occupied here; the
            # next rebuild drops them
            cand = unplaced[free]
            cidx = idx[free]
            _, first = np.unique(cidx, return_index=True)
            win, widx = cand[first], cidx[first]
            tab[widx, 0] = c1[win].view(np.int32)
            tab[widx, 1] = c2[win].view(np.int32)
            tab[widx, 2] = fidv[win]
            tab[widx, 3] = sidv[win]
            placed_empty += len(win)
            pm = np.zeros(n, bool)
            pm[win] = True
            unplaced = unplaced[~pm[unplaced]]
        self._hot_fill += placed_empty
        self._in_hot.update(a[0] for a in accepted)
        self._log_resync("shape_hot")
        for i in unplaced.tolist():
            # pathological-cluster tail (~load^8): per-entry placement,
            # which may grow/rebuild the hot segment
            f = accepted[i][0]
            self._in_hot.discard(f)  # _place_hot re-registers it
            self._place_hot(
                f, int(c1[i]), int(c2[i]), int(fidv[i]), int(sidv[i])
            )

    def _tomb_hot(self, c1: int, c2: int) -> None:
        """Tombstone a live hot entry (fid lane -> TOMB_FID: one logged
        write; the slot stays occupied so probe chains hold)."""
        slot = slot_hash(c1)
        step = probe_step(c2)
        cc1, cc2 = np.int32(np.uint32(c1)), np.int32(np.uint32(c2))
        for p in range(MAX_PROBES):
            idx = (slot + p * step) & (self._Hcap - 1)
            if (
                self.arr_hot[idx, 2] >= 0
                and self.arr_hot[idx, 0] == cc1
                and self.arr_hot[idx, 1] == cc2
            ):
                self.arr_hot[idx, 2] = TOMB_FID
                self._log("shape_hot", idx * 4 + 2, TOMB_FID)
                self._hot_tombs += 1
                break
        if self._hot_tombs * 4 > self._Hcap:
            self._rebuild_hot()  # cheap: hot is small

    def _tomb_packed(self, c1: int, c2: int) -> None:
        """Tombstone a packed entry by setting its mask bit — the row is
        untouched (probe chains hold), the device sees one scattered
        word, and compaction purges the bit later."""
        slot = slot_hash(c1)
        step = probe_step(c2)
        cc1, cc2 = np.int32(np.uint32(c1)), np.int32(np.uint32(c2))
        for p in range(MAX_PROBES):
            idx = (slot + p * step) & (self._Tcap - 1)
            if (
                self.arr_table[idx, 2] >= 0
                and self.arr_table[idx, 0] == cc1
                and self.arr_table[idx, 1] == cc2
                and not (self.arr_tomb[idx >> 5] >> (idx & 31)) & 1
            ):
                self.arr_tomb[idx >> 5] |= np.uint32(1 << (idx & 31))
                self._log(
                    "shape_tomb", idx >> 5, int(self.arr_tomb[idx >> 5])
                )
                self._tombs += 1
                break

    @staticmethod
    def _probe_positions(c1: int, c2: int, Tcap: int):
        home = slot_hash(c1)
        step = probe_step(c2)
        return [(home + p * step) & (Tcap - 1) for p in range(MAX_PROBES)]

    @staticmethod
    def _cuckoo_walk(tab, Tcap: int, entry, max_kicks: int = 512):
        """Place `entry` = (c1u32, c2u32, fid, sid) into `tab` [T,4] i32,
        displacing resident entries among THEIR OWN probe positions when
        every position of the current entry is full (random-walk cuckoo
        with MAX_PROBES choices). Lookup correctness only needs each
        entry to sit at one of its probe positions, so displacement is
        invisible to readers. Returns (writes, terminal_was_empty) where
        `writes` is the list of (slot, row4) applied — or None when the
        walk exceeds max_kicks (caller doubles the table).
        """
        writes = []
        c1, c2, fid, sid = entry
        seed = c1
        for _kick in range(max_kicks):
            pos = ShapeIndex._probe_positions(
                int(np.uint32(c1)), int(np.uint32(c2)), Tcap
            )
            row = np.array(
                [np.int32(np.uint32(c1)), np.int32(np.uint32(c2)), fid, sid],
                np.int32,
            )
            for idx in pos:
                f = tab[idx, 2]
                if f == -1 or f == TOMB_FID:
                    tab[idx] = row
                    writes.append((idx, row))
                    return writes, f == -1
            # all positions full: evict a deterministic pseudo-random one
            seed = _mix32(seed ^ (_kick * 0x9E3779B1))
            vidx = pos[seed % MAX_PROBES]
            victim = tab[vidx].copy()
            tab[vidx] = row
            writes.append((vidx, row))
            c1 = int(np.uint32(victim[0]))
            c2 = int(np.uint32(victim[1]))
            fid = int(victim[2])
            sid = int(victim[3])
        return None

    @staticmethod
    def _build_table(sid, c1, c2, fid, newT: int):
        """Vectorized double-hash placement -> (tab [T,4] i32, T).

        Any placement within MAX_PROBES along an entry's (home, stride)
        probe sequence is valid for lookup (host and device walk the same
        sequence), so placement runs in probe ROUNDS: in round p every
        still-unplaced entry bids for home + p*stride, first bidder per
        empty slot wins. The tail left after MAX_PROBES rounds (~load^8
        of the batch) is placed by cuckoo displacement; only if a walk
        fails does the table double.
        """
        n = len(sid)
        with np.errstate(over="ignore"):
            home = c1 * np.uint32(SLOT_MUL)
            home = home ^ (home >> np.uint32(SLOT_SHIFT))
            step = c2 | np.uint32(1)
        while True:
            tab = np.zeros((newT, 4), np.int32)
            tab[:, 2] = -1
            unplaced = np.arange(n)
            for p in range(MAX_PROBES):
                if not len(unplaced):
                    break
                with np.errstate(over="ignore"):
                    idx = (
                        home[unplaced] + np.uint32(p) * step[unplaced]
                    ) & np.uint32(newT - 1)
                idx = idx.astype(np.int64)
                free = tab[idx, 2] == -1
                cand = unplaced[free]
                cidx = idx[free]
                # first bidder per distinct empty slot wins this round
                _, first = np.unique(cidx, return_index=True)
                win, widx = cand[first], cidx[first]
                tab[widx, 0] = c1[win].view(np.int32)
                tab[widx, 1] = c2[win].view(np.int32)
                tab[widx, 2] = fid[win]
                tab[widx, 3] = sid[win]
                placed_mask = np.zeros(n, bool)
                placed_mask[win] = True
                unplaced = unplaced[~placed_mask[unplaced]]
            ok = True
            for i in unplaced.tolist():
                if (
                    ShapeIndex._cuckoo_walk(
                        tab,
                        newT,
                        (int(c1[i]), int(c2[i]), int(fid[i]), int(sid[i])),
                    )
                    is None
                ):
                    ok = False
                    break
            if ok:
                return tab, newT
            newT *= 2

    def _reset_segments(self) -> None:  # oplog-covered-by: caller bump
        """Fresh tombstone mask (sized to the packed table) + empty hot
        segment: the packed rebuild just absorbed everything live."""
        self.arr_tomb = np.zeros(max(1, self._Tcap // 32), np.uint32)
        self._tombs = 0
        self.arr_hot = np.zeros((self._Hcap, 4), np.int32)
        self.arr_hot[:, 2] = -1
        self._hot_fill = 0
        self._hot_tombs = 0
        self._in_hot = set()

    def _rehash(self, newT: int, extra=()) -> None:
        """Full rebuild from the LIVE rows (vectorized array scan — no
        dict walk) — the inline path for restore-scale bulk loads, salt
        rebuilds and the tombstone safety valve. `extra` rows
        [(c1, c2, fid, sid)] are not in any array yet (overflowing
        insert) and ride the same placement. Invalidates any outstanding
        compaction capture (`_structure_gen`) and absorbs the hot
        segment."""
        self._structure_gen += 1
        self._journal = None
        live = self._live_rows()
        n = len(live) + len(extra)
        while (n + 1) * 2 > newT:
            newT *= 2
        if n == 0:
            tab = np.zeros((newT, 4), np.int32)
            tab[:, 2] = -1
            self._Tcap = newT
            self.arr_table = tab
            self._fill = 0
            self._reset_segments()
            self._bump_epoch()
            return
        sid = np.empty(n, np.int64)
        c1 = np.empty(n, np.uint32)
        c2 = np.empty(n, np.uint32)
        fid = np.empty(n, np.int64)
        k = len(live)
        sid[:k] = live[:, 3].astype(np.int64)
        c1[:k] = np.ascontiguousarray(live[:, 0]).view(np.uint32)
        c2[:k] = np.ascontiguousarray(live[:, 1]).view(np.uint32)
        fid[:k] = live[:, 2].astype(np.int64)
        for j, (a, b, f, s) in enumerate(extra):
            i = k + j
            sid[i], c1[i], c2[i], fid[i] = s, a & _M32, b & _M32, f
        tab, newT = self._build_table(sid, c1, c2, fid, newT)
        self._Tcap = newT
        self.arr_table = tab
        self._fill = n
        self._reset_segments()
        self._bump_epoch()

    def add(self, filter_: str, fid: int) -> bool:
        """Index this filter under `fid`. False => caller routes it to the
        residual NFA engine (shape overflow or hash collision)."""
        parsed = self.parse_shape(filter_)
        if parsed is None:
            return False
        mask, plen, has_hash, prefix = parsed
        sid = self._shape_for(mask, plen, has_hash)
        if sid is None:
            return False
        c1, c2 = combined_pair(prefix, mask, sid, self.salt)
        if self._find_live(c1, c2) is not None:
            # (c1, c2) already live: a true 64-bit collision between
            # distinct filters (the caller only adds absent filters) —
            # first-probe-wins lookup cannot hold both, so residual
            self._shape_release(sid, (mask, plen, has_hash))
            return False
        if self._journal is not None:
            self._journal.append(("add", filter_, (sid, c1, c2, fid)))
        self._place_hot(filter_, c1, c2, fid, sid)
        return True

    def bulk_add_cold(
        self,
        names: List[str],
        fids: np.ndarray,
        masks: np.ndarray,
        plens: np.ndarray,
        hhs: np.ndarray,
        s1: np.ndarray,
        s2: np.ndarray,
        unfit: np.ndarray,
    ) -> List[Tuple[str, int]]:
        """Fully-vectorized cold-start insert (empty index only).

        The caller (RouteIndex._bulk_add_cold) has already tokenized the
        DISTINCT filters and reduced each to its shape signature
        (masks/plens/hhs) and pre-fold combined sums (s1/s2 — the masked
        sum-products WITHOUT the shape-id fold, which is applied here once
        shape ids are assigned). `unfit` marks rows parse_shape would
        reject. Returns the rejected (filter, fid) pairs, in input order,
        for the residual engine. Bit-identical to repeated `add`.
        """
        assert len(self) == 0, "bulk_add_cold requires an empty index"
        n = len(names)
        rej = np.zeros(n, dtype=bool)
        rej |= unfit
        # -- shape registration (first-occurrence order, like add) -------
        key = (
            (masks.astype(np.uint64) << np.uint64(8))
            | (plens.astype(np.uint64) << np.uint64(1))
            | hhs.astype(np.uint64)
        )
        key[unfit] = np.uint64(0xFFFFFFFFFFFFFFFF)
        uq_key, first_idx, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        sid_of_group = np.full(len(uq_key), -1, dtype=np.int64)
        group_counts = np.bincount(inv, minlength=len(uq_key))
        for g in order.tolist():
            i = int(first_idx[g])
            if unfit[i]:
                continue
            sid = self._shape_for(int(masks[i]), int(plens[i]), bool(hhs[i]))
            if sid is None:
                continue  # shape overflow -> whole family is residual
            sid_of_group[g] = sid
            self._shape_refs[sid] += int(group_counts[g]) - 1
        sids = sid_of_group[inv]
        rej |= sids < 0
        # -- combined hashes (sid fold applied post-registration) --------
        with np.errstate(over="ignore"):
            su = sids.astype(np.uint32)
            c1 = _mix32_np(s1 ^ (su * np.uint32(FOLD1)))
            c2 = _mix32_np(s2 ^ (su * np.uint32(FOLD2)))
        # -- 64-bit key collisions: first (by input order) wins ----------
        fit_idx = np.nonzero(~rej)[0]
        ckey = (c1[fit_idx].astype(np.uint64) << np.uint64(32)) | c2[
            fit_idx
        ].astype(np.uint64)
        srt = np.argsort(ckey, kind="stable")  # stable => input order
        dup = np.zeros(len(ckey), dtype=bool)
        dup[srt[1:]] = ckey[srt[1:]] == ckey[srt[:-1]]
        for i in fit_idx[dup].tolist():
            # true 64-bit collision between distinct filters: residual
            self._shape_release(
                int(sids[i]),
                (int(masks[i]), int(plens[i]), bool(hhs[i])),
            )
            rej[i] = True
        # -- vectorized placement ----------------------------------------
        keep = np.nonzero(~rej)[0]
        newT = self._Tcap
        while (len(keep) + 1) * 2 > newT:
            newT *= 2
        tab, newT = self._build_table(
            sids[keep], c1[keep], c2[keep], fids[keep], newT
        )
        self._structure_gen += 1
        self._journal = None
        self._Tcap = newT
        self.arr_table = tab
        self._fill = len(keep)
        self._reset_segments()
        # -- no shadow mirror to build: the packed table IS the host
        # state (probe lookups + array scans serve every later need) ----
        if rej.any():
            rej_idx = np.nonzero(rej)[0].tolist()
            out = [(names[i], int(fids[i])) for i in rej_idx]
        else:
            out = []
        self._bump_epoch()
        return out

    def bulk_add(self, entries: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
        """Vectorized insert of many (filter, fid) pairs; returns the
        REJECTED pairs (shape overflow / hash collision / unparseable) the
        caller must route to the residual engine.

        The cold-start path (restore 10M subscriptions): per-level word
        hashes come from the numpy mirror of the device tokenizer in one
        pass, combined hashes and table placement are vectorized; results
        are bit-identical to repeated `add` calls. Ends with an epoch bump
        (one full device upload) instead of millions of op-log entries.
        """
        from emqx_tpu_torch.ops.tokenizer import encode_topics, tokenize_host_np

        rejected: List[Tuple[str, int]] = []
        metas = []  # (filter, fid, sid, key=(mask, plen, has_hash))
        raw: List[str] = []
        for f, fid in entries:
            parsed = self.parse_shape(f)
            if parsed is None:
                rejected.append((f, fid))
                continue
            mask, plen, has_hash, _prefix = parsed
            sid = self._shape_for(mask, plen, has_hash)
            if sid is None:
                rejected.append((f, fid))
                continue
            metas.append((f, fid, sid, (mask, plen, has_hash)))
            raw.append(f)
        if not metas:
            return rejected
        L = MAX_MASK_LEVELS
        # row width sized to the actual data (so every row fits by
        # construction) and rows processed in blocks: a fixed 8*L width at
        # 1M+ filters costs GBs of cumsum intermediates
        maxlen = max(16, max(len(f.encode()) for f in raw))
        width = 1 << (maxlen - 1).bit_length()
        masks = np.array([m[3][0] for m in metas], dtype=np.int64)
        sids = np.array([m[2] for m in metas], dtype=np.uint32)
        k1 = np.array([level_mul(l, 1) for l in range(L)], dtype=np.uint32)
        k2 = np.array([level_mul(l, 2) for l in range(L)], dtype=np.uint32)
        lvls = np.arange(L)[None, :]
        n = len(raw)
        c1s = np.empty(n, np.uint32)
        c2s = np.empty(n, np.uint32)
        BLOCK = 1 << 18
        with np.errstate(over="ignore"):
            for lo in range(0, n, BLOCK):
                hi = min(lo + BLOCK, n)
                mat, lens, _tl = encode_topics(raw[lo:hi], width)
                h1, h2, _nw, _dl, _ws, _wl = tokenize_host_np(
                    mat, lens, self.salt, L
                )
                lb = ((masks[lo:hi, None] >> lvls) & 1).astype(np.uint32)
                s1 = np.sum(h1 * k1[None, :] * lb, axis=1, dtype=np.uint32)
                s2 = np.sum(h2 * k2[None, :] * lb, axis=1, dtype=np.uint32)
                c1s[lo:hi] = _mix32_np(s1 ^ (sids[lo:hi] * np.uint32(FOLD1)))
                c2s[lo:hi] = _mix32_np(s2 ^ (sids[lo:hi] * np.uint32(FOLD2)))
        accepted = []  # (filter, c1, c2, fid, sid)
        journal = self._journal
        live_clash = self._find_live_batch(c1s, c2s)  # ONE vector sweep
        batch_keys: Dict[Tuple[int, int], bool] = {}  # in-batch dups
        for i, (f, fid, sid, key) in enumerate(metas):
            c1, c2 = int(c1s[i]), int(c2s[i])
            if live_clash[i] or (c1, c2) in batch_keys:
                # live (c1, c2) => a different filter (caller only adds
                # absent ones): 64-bit collision, route to residual
                self._shape_release(sid, key)
                rejected.append((f, fid))
                continue
            batch_keys[(c1, c2)] = True
            if journal is not None:
                journal.append(("add", f, (sid, c1, c2, fid)))
            accepted.append((f, c1, c2, fid, sid))
        # churn-scale batches land in the hot segment (one vectorized
        # placement + one small re-upload; the packed table is never
        # touched); restore-scale batches fall through to a full rebuild
        # inside _bulk_place_hot
        self._bulk_place_hot(accepted)
        return rejected

    def remove(self, filter_: str) -> bool:
        ent = self._ent_of(filter_)
        if ent is None:
            return False
        sid, c1, c2, fid = ent
        if self._journal is not None:
            self._journal.append(("remove", filter_, ent))
        if filter_ in self._in_hot:
            self._in_hot.discard(filter_)
            self._tomb_hot(c1, c2)
        else:
            self._tomb_packed(c1, c2)
        parsed = self.parse_shape(filter_)
        if parsed is not None:
            mask, plen, has_hash, _ = parsed
            self._shape_release(sid, (mask, plen, has_hash))
        if self._tombs * 2 > self._Tcap:
            # safety valve only: background compaction (SegmentCompactor)
            # normally purges tombstones long before half the table dies
            self._rehash(self._Tcap)
        return True

    # oplog-covered-by: _rehash ends the rebuild with an epoch bump
    def rebuild(self, salt: int) -> List[Tuple[str, int]]:
        """Salt changed (vocab collision in the residual engine): recompute
        every combined hash and rebuild the table. Rare by construction.

        Returns [(filter, fid)] EVICTED because their new combined hash
        collides with another filter's — `add` enforces key uniqueness, so
        rebuild must too or the first-probe-wins device lookup would
        silently drop one of the pair. The caller (RouteIndex) re-homes
        evictees in the residual NFA engine.
        """
        self.salt = salt
        if self.resolve_name is None:
            raise RuntimeError(
                "ShapeIndex.rebuild needs resolve_name (fid -> filter) "
                "to re-hash entries under the new salt"
            )
        live = self._live_rows()
        seen: Dict[Tuple[int, int], bool] = {}
        rows: List[Tuple[int, int, int, int]] = []
        evicted: List[Tuple[str, int]] = []
        for fid, sid in zip(
            live[:, 2].astype(np.int64).tolist(),
            live[:, 3].astype(np.int64).tolist(),
        ):
            f = self.resolve_name(int(fid))
            parsed = self.parse_shape(f)
            mask, plen, has_hash, prefix = parsed
            c1, c2 = combined_pair(prefix, mask, sid, salt)
            if (c1, c2) in seen:
                self._shape_release(sid, (mask, plen, has_hash))
                evicted.append((f, int(fid)))
                continue
            seen[(c1, c2)] = True
            rows.append((c1, c2, int(fid), int(sid)))
        # drop EVERYTHING live (the old-salt rows are all stale) and
        # rebuild from the re-hashed rows only
        self.arr_table[:, 2] = -1
        self._fill = 0
        self._reset_segments()
        self._rehash(self._Tcap, extra=rows)
        return evicted

    def __len__(self) -> int:
        return (
            self._fill
            - self._tombs
            + self._hot_fill
            - self._hot_tombs
        )

    # -- background compaction (ops/segments.SegmentCompactor) -------------
    # One cycle: begin() on the mutating thread (array memcpys + journal
    # on), build_compact() anywhere (pure numpy over the capture),
    # apply_compact() back on the mutating thread (swap + journal
    # replay). A structural rebuild racing the build (_rehash/cold load)
    # bumps `_structure_gen` and the apply aborts cleanly.

    def begin_compact(self) -> Dict:
        """Capture a consistent array snapshot (fast memcpys — never the
        10M-entry host dicts) and start journaling mutations."""
        cap = {
            "tab": self.arr_table.copy(),
            "tomb": self.arr_tomb.copy(),
            "hot": self.arr_hot.copy(),
            "Tcap": self._Tcap,
            "gen": self._structure_gen,
        }
        self._journal = []
        return cap

    @staticmethod
    def build_compact(cap: Dict) -> Dict:
        """Merge `packed − tombstones + hot` into a fresh packed table.
        Pure numpy over the capture — safe on any thread, off the
        subscribe path entirely."""
        tab, Tcap = cap["tab"], cap["Tcap"]
        idx = np.nonzero(tab[:, 2] >= 0)[0]
        tword = cap["tomb"][idx >> 5]
        dead = (tword >> (idx & 31).astype(np.uint32)) & np.uint32(1)
        rows = [tab[idx[dead == 0]]]
        hot = cap["hot"]
        rows.append(hot[hot[:, 2] >= 0])
        live = np.concatenate(rows, axis=0)
        n = len(live)
        newT = 1024
        while (n + 1) * 2 > newT:
            newT *= 2
        if n:
            tab2, newT = ShapeIndex._build_table(
                live[:, 3].astype(np.int64),
                np.ascontiguousarray(live[:, 0]).view(np.uint32),
                np.ascontiguousarray(live[:, 1]).view(np.uint32),
                live[:, 2].astype(np.int64),
                newT,
            )
        else:
            tab2 = np.zeros((newT, 4), np.int32)
            tab2[:, 2] = -1
        return {"tab": tab2, "Tcap": newT, "gen": cap["gen"], "n": n}

    def apply_compact(self, built: Dict) -> Optional[int]:
        """Install a built packed table (mutating thread). The journal of
        mutations that raced the build replays on top — adds re-place
        into the (fresh) hot segment, removes re-tombstone — so the
        result is bit-equivalent to having paused the world. Returns the
        new epoch (for `DeviceSegmentManager.offer`), or None when a
        structural rebuild invalidated the capture."""
        if self._journal is None or built["gen"] != self._structure_gen:
            self._journal = None
            return None
        journal, self._journal = self._journal, None
        self._structure_gen += 1
        self._Tcap = built["Tcap"]
        self.arr_table = built["tab"]
        self._fill = built["n"]
        self._reset_segments()
        self._bump_epoch()
        for op, f, (sid, c1, c2, fid) in journal:
            if op == "add":
                self._place_hot(f, c1, c2, fid, sid)
            elif f in self._in_hot:  # remove of a journal-replayed add
                self._in_hot.discard(f)
                self._tomb_hot(c1, c2)
            else:  # remove of an entry the build merged into packed
                self._tomb_packed(c1, c2)
        return self.epoch


# -- device kernel ---------------------------------------------------------

# shape_tables keys, in the order the kernel takes them
SHAPE_TABLE_KEYS = (
    "shape_tab",
    "shape_hot",
    "shape_tomb",
    "shape_mask",
    "shape_len",
    "shape_flags",
)


def shape_match_plain(tables, m_active: int, h1, h2, nwords, dollar,
                      probes: int = SHAPE_PROBES):
    """Plain PyTorch twin of the `shape_match` kernel (any device).

    32-bit hashes ride int64 lanes in [0, 2^32) (ops/u32.py); the probe
    loops keep the JAX function's `found` chain: the first live packed hit
    in probe order wins, then the hot overlay's."""
    from emqx_tpu_torch.ops.u32 import mix32, mul32, u32

    B, L = h1.shape
    M = m_active
    dev = h1.device
    mask = tables["shape_mask"][:M].to(torch.int64)  # sign-extended int32
    plen = tables["shape_len"][:M].to(torch.int64)
    flags = tables["shape_flags"][:M].to(torch.int64)
    a1, a2 = u32(h1), u32(h2)
    s1 = torch.zeros((B, M), dtype=torch.int64, device=dev)
    s2 = torch.zeros((B, M), dtype=torch.int64, device=dev)
    for l in range(L):
        bit = (mask >> l) & 1  # [M]
        s1 = (s1 + mul32(a1[:, l : l + 1], (bit * level_mul(l, 1))[None, :])) & _M32
        s2 = (s2 + mul32(a2[:, l : l + 1], (bit * level_mul(l, 2))[None, :])) & _M32
    sid = torch.arange(M, dtype=torch.int64, device=dev)
    c1 = mix32(s1 ^ mul32(sid, FOLD1)[None, :])
    c2 = mix32(s2 ^ mul32(sid, FOLD2)[None, :])

    has_hash = (flags & 1) != 0
    rootwild = (flags & 2) != 0
    nw = nwords.to(torch.int64)[:, None]
    ok_len = torch.where(has_hash[None, :], nw >= plen[None, :], nw == plen[None, :])
    valid = ok_len & (plen >= 0)[None, :] & ~(dollar[:, None] & rootwild[None, :])

    slot = mul32(c1, SLOT_MUL)
    slot = slot ^ (slot >> SLOT_SHIFT)
    step = c2 | 1
    fid = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    found = torch.zeros((B, M), dtype=torch.bool, device=dev)
    tomb = u32(tables["shape_tomb"])
    for tab, t_masked in ((tables["shape_tab"], True), (tables["shape_hot"], False)):
        tab = tab.to(torch.int64)
        cap = tab.shape[0] // 4
        for p in range(probes):
            idx = (slot + p * step) & (cap - 1)
            base4 = idx * 4
            hit = (
                ((tab[base4] & _M32) == c1)
                & ((tab[base4 + 1] & _M32) == c2)
                & (tab[base4 + 3] == sid[None, :])
                & (tab[base4 + 2] >= 0)
                & valid
                & ~found
            )
            if t_masked:
                hit &= ((tomb[idx >> 5] >> (idx & 31)) & 1) == 0
            fid = torch.where(hit, tab[base4 + 2], fid)
            found |= hit
    return fid.to(torch.int32)


def _check_pow2_rows(t, name: str) -> int:
    rows = t.shape[0] // 4
    if t.shape[0] % 4 or rows < 1 or rows & (rows - 1):
        raise ValueError(f"{name}: expected [T*4] with T a power of two, got {tuple(t.shape)}")
    return rows


def shape_match(tables, m_active: int, h1, h2, nwords, dollar,
                probes: int = SHAPE_PROBES):
    """Match tokenized topics against the shape index (kernel 2).

    tables: the port's device dict (`convert.tables_to_device`): shape_tab
    int32 [T*4] and shape_hot int32 [H*4] flat row-major (c1, c2, fid, sid)
    rows, shape_tomb int32 [T/32] holding the uint32 tombstone bits,
    shape_mask/len/flags int32 [Mcap]. h1, h2 int32 [B, L] (uint32 bits);
    nwords int32 [B]; dollar bool [B].
    -> matched fid int32 [B, m_active] (-1 = no match; SPARSE, not
    compacted). The counterpart of `shape_match_device`
    (emqx_tpu/ops/shape_index.py:1108).
    """
    for k in SHAPE_TABLE_KEYS:
        kernels.check_tensor(tables[k], k, torch.int32, 1)
    kernels.check_tensor(h1, "h1", torch.int32, 2)
    kernels.check_tensor(h2, "h2", torch.int32, 2)
    kernels.check_tensor(nwords, "nwords", torch.int32, 1)
    kernels.check_tensor(dollar, "dollar", torch.bool, 1)
    B, L = h1.shape
    if h2.shape != h1.shape or nwords.shape[0] != B or dollar.shape[0] != B:
        raise ValueError("h1, h2, nwords and dollar disagree on the batch")
    if not 0 < m_active <= tables["shape_len"].shape[0]:
        raise ValueError(f"m_active {m_active} outside the shape meta")
    tcap = _check_pow2_rows(tables["shape_tab"], "shape_tab")
    hcap = _check_pow2_rows(tables["shape_hot"], "shape_hot")
    if tables["shape_tomb"].shape[0] * 32 < tcap:
        raise ValueError("shape_tomb does not cover shape_tab")
    args = [tables[k] for k in SHAPE_TABLE_KEYS] + [h1, h2, nwords, dollar]
    if not kernels.on_cuda(*args):
        return shape_match_plain(tables, m_active, h1, h2, nwords, dollar, probes)
    out = torch.empty((B, m_active), dtype=torch.int32, device=h1.device)
    kernels.launch(
        "shape_match",
        "emqx_shape_match",
        h1.device,
        h1.data_ptr(),
        h2.data_ptr(),
        nwords.data_ptr(),
        dollar.data_ptr(),
        tables["shape_mask"].data_ptr(),
        tables["shape_len"].data_ptr(),
        tables["shape_flags"].data_ptr(),
        tables["shape_tab"].data_ptr(),
        tcap,
        tables["shape_hot"].data_ptr(),
        hcap,
        tables["shape_tomb"].data_ptr(),
        out.data_ptr(),
        B,
        L,
        m_active,
        probes,
    )
    return out
