"""CSR subscriber tables: O(total subscriptions) device fan-out state. The
port's copy of `emqx_tpu/ops/csr_table.py:48-689` (`HOT_POS`, `CSR_KEYS`,
the hashing helpers, the host `CsrTable`) and its device half,
`sparse_fanout_slots`, as the hand-written kernel
`kernels/csrc/sparse_fanout.cu` with its plain PyTorch twin.

The dense representation (`router_model.SubscriberTable`'s
``sub_bitmaps [Fcap, W]``) costs O(Fcap * W) whatever the number of
subscriptions: at 2^20 subscriber slots and 10M filters it would be about
2.2 TB. This representation keeps per-filter slot LISTS instead:

- **packed CSR** (written only by rebuilds and compaction):
  ``csr_off [S, F]`` / ``csr_len [S, F]`` int32 region table plus the
  concatenated slot column ``csr_slots [S, P]`` (-1 = hole/tombstone),
  regions laid contiguously in fid order, exactly sized at build;
- **hot segment** (append-only between rebuilds): ``hot_fid / hot_slot
  [S, H]`` pairs. A subscribe is two op-logged scalar writes that the
  router's mirror replays as one scatter; an unsubscribe tombstones ONE
  lane (a packed slot or a hot fid) the same way;
- **registry**: a vectorised open-addressing (fid, slot) -> position table
  (int64 key lanes + int32 position lanes) that makes unsubscribe O(1)
  without a per-entry Python dict.

``S`` is the shard axis of the mesh placement (`parallel.mesh
.csr_placement` gives 'tp' rank t the block ``[t : t + 1]``): a
subscription is owned by shard ``slot % S``, and slot ids are stored
globally, so the per-shard compact rows concatenate over 'tp' with no lane
rebase. `reshard` re-partitions a live table. `CsrSegmentOwner` drives
the table's compaction cycle on `ops.segments.SegmentCompactor`: the
packed CSR is rebuilt and uploaded off the subscribe path, and the next
prepare adopts it.

`sparse_fanout_slots` unions the matched fids' slot lists into the same
``slots [B, kslot] / count [B] / overflow [B]`` compact contract as
`compact_fanout_slots`, so the router's readback is the same for both
representations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.ops.nfa import _next_pow2

_M64 = 0xFFFFFFFFFFFFFFFF

# registry position flag: the entry lives in the hot segment (low bits =
# hot index within its shard), not the packed slot column
HOT_POS = 1 << 30

# device-snapshot array names (the segment-manager sync set)
CSR_KEYS = ("csr_off", "csr_len", "csr_slots", "hot_fid", "hot_slot")


# -- kernel 8: the CSR gather-union ----------------------------------------


def sparse_fanout_slots_plain(csr: Dict, matched, kslot: int, kg: int = 0):
    """Plain PyTorch twin of the `sparse_fanout_slots` kernel (any device),
    written after `emqx_tpu/ops/csr_table.py:84` line by line: windowed
    gather of the packed regions, hot overlay, left-pack of the first
    `kslot` live candidates, sort, adjacent duplicates set to -1 in place."""
    from emqx_tpu_torch.ops.matcher import _compact

    if kslot <= 0:
        raise ValueError("sparse fan-out requires kslot > 0")
    if kg <= 0:
        kg = 2 * kslot
    off = csr["csr_off"][0].to(torch.int64)
    ln = csr["csr_len"][0].to(torch.int64)
    col = csr["csr_slots"][0]
    hfid = csr["hot_fid"][0]
    hslot = csr["hot_slot"][0]
    B, K = matched.shape
    dev = matched.device
    has = matched >= 0
    safe = matched.clamp(0, off.shape[0] - 1).to(torch.int64)  # as JAX's gathers clamp
    fl = torch.where(has, ln[safe], torch.zeros_like(safe))  # [B, K]
    fo = off[safe]
    starts = torch.cumsum(fl, dim=1) - fl  # exclusive
    total = starts[:, -1] + fl[:, -1]  # [B]
    pos = torch.arange(kg, dtype=torch.int64, device=dev)
    seg = (starts[:, :, None] <= pos[None, None, :]).sum(dim=1) - 1
    seg = seg.clamp(0, K - 1)
    sg = torch.gather(starts, 1, seg)
    lg = torch.gather(fl, 1, seg)
    og = torch.gather(fo, 1, seg)
    j = pos[None, :] - sg
    valid = (pos[None, :] < total[:, None]) & (j < lg)
    src = (og + j).clamp(0, col.shape[0] - 1)
    cand_p = torch.where(valid, col[src], torch.full_like(col[src], -1))
    # hot overlay: a live pair whose fid is one of the row's matched fids
    memb = torch.zeros((B, hfid.shape[0]), dtype=torch.bool, device=dev)
    for k in range(K):
        memb |= matched[:, k : k + 1] == hfid[None, :]
    hlive = hfid >= 0  # masks holes AND tombstones (and -1 == -1 ties)
    cand_h = torch.where(memb & hlive[None, :], hslot[None, :].expand(B, -1),
                         torch.full((B, hfid.shape[0]), -1, dtype=torch.int32, device=dev))
    cand = torch.cat([cand_p, cand_h], dim=1)
    live = (cand >= 0).sum(dim=1, dtype=torch.int32)
    slots, _ = _compact(cand, kslot)
    slots = torch.sort(slots, dim=1).values  # -1 pads sort to the front
    dup = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=dev),
         (slots[:, 1:] == slots[:, :-1]) & (slots[:, 1:] >= 0)],
        dim=1,
    )
    slots = torch.where(dup, torch.full_like(slots, -1), slots)
    gather_ovf = total > kg
    count = torch.where(gather_ovf, total.clamp(min=kslot + 1), live.to(torch.int64))
    count = count.to(torch.int32)
    return slots.contiguous(), count, count > kslot, live


def sparse_fanout_slots(csr: Dict, matched, kslot: int, kg: int = 0):
    """Union the matched fids' CSR slot lists -> compact slot rows (kernel 8).

    csr: the five `CSR_KEYS` int32 tensors of one shard, ``[1, ...]`` (a
    single device's table, or a mesh rank's 'tp' slice of it);
    matched: int32 [B, K] sparse fids (-1 holes; a fid past Fcap gathers
    Fcap - 1's region, as JAX's clamped gathers do). Returns
    (slots int32 [B, kslot], count int32 [B], overflow bool [B], live int32
    [B]). The counterpart of `sparse_fanout_slots`
    (emqx_tpu/ops/csr_table.py:84).

    ``kg`` bounds the packed-gather window per row (0 = 2 * kslot). A row
    whose regions do not fit the window has its count forced past kslot,
    so it is flagged `overflow` and rebuilt on the host; the window is a
    bandwidth knob, never a correctness one. `live` counts every live
    candidate, duplicates included; `slots` holds the first kslot of them
    (window first, then hot), sorted ascending, each adjacent duplicate
    set to -1 where it stands.
    """
    for k in CSR_KEYS:
        kernels.check_tensor(csr[k], k, torch.int32, 2)
    kernels.check_tensor(matched, "matched", torch.int32, 2)
    if kslot <= 0:
        raise ValueError("sparse fan-out requires kslot > 0")
    if kg <= 0:
        kg = 2 * kslot
    B, K = matched.shape
    if K < 1:
        raise ValueError("matched needs at least one column")
    if csr["csr_len"].shape != csr["csr_off"].shape or (
            csr["hot_slot"].shape != csr["hot_fid"].shape):
        raise ValueError("csr_off/csr_len and hot_fid/hot_slot must pair up")
    if not kernels.on_cuda(matched, *(csr[k] for k in CSR_KEYS)):
        return sparse_fanout_slots_plain(csr, matched, kslot, kg)
    dev = matched.device
    slots = torch.empty((B, kslot), dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    live = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.launch(
        "sparse_fanout_slots",
        "emqx_sparse_fanout_slots",
        dev,
        csr["csr_off"].data_ptr(),
        csr["csr_len"].data_ptr(),
        csr["csr_off"].shape[1],
        csr["csr_slots"].data_ptr(),
        csr["csr_slots"].shape[1],
        csr["hot_fid"].data_ptr(),
        csr["hot_slot"].data_ptr(),
        csr["hot_fid"].shape[1],
        matched.data_ptr(),
        slots.data_ptr(),
        count.data_ptr(),
        overflow.data_ptr(),
        live.data_ptr(),
        B,
        K,
        kslot,
        kg,
    )
    return slots, count, overflow, live


# -- host registry: (fid, slot) -> position --------------------------------


def _mix64_np(x):
    """splitmix64 finalizer, vectorized (uint64 wrap)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _mix64(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class CsrTable:
    """Host-side CSR subscriber state (one representation behind
    `router_model.SubscriberTable`). Mutations emit op-log writes through
    the owner-provided `log` / `log_resync` / `bump` callbacks: the owner
    holds the ONE epoch/version/oplog the segment manager syncs on, so a
    representation flip is just another epoch bump.
    """

    HOT_MIN = 256  # minimum hot-segment capacity per shard (pow2)
    # hot population past this forces an inline rebuild instead of another
    # growth: the kernel scans the full hot segment per batch
    HOT_ABSORB_MAX = 1 << 17
    # serve-time absorb bound (`maybe_absorb`, called from the dirty
    # prepare): past this the prepare folds hot into packed once (epoch
    # bump) before snapshotting, so the kernel never scans a huge hot
    # segment when no background compactor drains it
    HOT_SERVE_MAX = 4096

    def __init__(self, shards: int = 1, log=None, log_resync=None,
                 bump=None):
        self.shards = S = max(1, int(shards))
        self._log = log or (lambda name, idx, val: None)
        self._log_resync = log_resync or (lambda name: None)
        self._bump = bump or (lambda: None)
        self._fcap = 64
        self._pcap = 256  # packed column capacity PER SHARD
        self.csr_off = np.zeros((S, self._fcap), np.int32)
        self.csr_len = np.zeros((S, self._fcap), np.int32)
        self.csr_slots = np.full((S, self._pcap), -1, np.int32)
        self._hcap = self.HOT_MIN
        self.hot_fid = np.full((S, self._hcap), -1, np.int32)
        self.hot_slot = np.full((S, self._hcap), -1, np.int32)
        self._hot_tail = [0] * S  # next append index per shard
        self.live = 0
        self.packed_tombs = 0
        self.hot_tombs = 0
        self.max_slot = -1
        # (fid, slot) -> position registry (no per-entry Python objects)
        self._reg_cap = 1024
        self._reg_key = np.full(self._reg_cap, -1, np.int64)
        self._reg_pos = np.zeros(self._reg_cap, np.int32)
        self._reg_live = 0
        self._reg_fill = 0  # live + tombstones
        # compaction bookkeeping: a capture is valid while no structural
        # rebuild happened; racing mutations journal
        self._structure_gen = 0
        self._journal: Optional[list] = None

    # -- registry ----------------------------------------------------------
    @staticmethod
    def _key(fid: int, slot: int) -> int:
        return (fid << 32) | slot

    def _reg_get(self, key: int) -> Optional[int]:
        cap = self._reg_cap
        h = _mix64(key)
        home = h & (cap - 1)
        step = ((h >> 32) | 1) & (cap - 1)
        rk = self._reg_key
        for p in range(cap):
            i = (home + p * step) & (cap - 1)
            k = rk[i]
            if k == key:
                return int(self._reg_pos[i])
            if k == -1:
                return None
        return None

    def _reg_set(self, key: int, pos: int) -> None:
        if (self._reg_fill + 1) * 2 > self._reg_cap:
            self._reg_rehash()
        cap = self._reg_cap
        h = _mix64(key)
        home = h & (cap - 1)
        step = ((h >> 32) | 1) & (cap - 1)
        rk = self._reg_key
        first_tomb = -1
        for p in range(cap):
            i = (home + p * step) & (cap - 1)
            k = rk[i]
            if k == key:
                self._reg_pos[i] = pos
                return
            if k == -2 and first_tomb < 0:
                first_tomb = i
            elif k == -1:
                if first_tomb >= 0:
                    i = first_tomb
                else:
                    self._reg_fill += 1
                rk[i] = key
                self._reg_pos[i] = pos
                self._reg_live += 1
                return
        raise RuntimeError("csr registry probe exhausted")  # unreachable

    def _reg_del(self, key: int) -> Optional[int]:
        cap = self._reg_cap
        h = _mix64(key)
        home = h & (cap - 1)
        step = ((h >> 32) | 1) & (cap - 1)
        rk = self._reg_key
        for p in range(cap):
            i = (home + p * step) & (cap - 1)
            k = rk[i]
            if k == key:
                rk[i] = -2
                self._reg_live -= 1
                return int(self._reg_pos[i])
            if k == -1:
                return None
        return None

    def _reg_rehash(self) -> None:
        live = self._reg_key >= 0
        keys = self._reg_key[live]
        poss = self._reg_pos[live]
        cap = self._reg_cap
        while (len(keys) + 1) * 2 > cap:
            cap *= 2
        rk, rp = self._reg_build_arrays(keys, poss, cap)
        self._reg_key, self._reg_pos = rk, rp
        self._reg_cap = cap
        self._reg_fill = self._reg_live = len(keys)

    @staticmethod
    def _reg_build_arrays(keys, poss, cap):
        """Vectorized probe-round build: round p, every unplaced key bids
        for home + p*step; the first bidder per empty slot wins. The
        reference finds each slot's first bidder with `np.unique` (a sort
        a round); here a per-slot minimum of the bidders' indices
        (`np.minimum.at`, linear) finds the same winner, so the arrays are
        the reference's, byte for byte, in half the time at 8M keys."""
        rk = np.full(cap, -1, np.int64)
        rp = np.zeros(cap, np.int32)
        n = len(keys)
        if not n:
            return rk, rp
        h = _mix64_np(keys.astype(np.uint64))
        home = (h & np.uint64(cap - 1)).astype(np.int64)
        step = (((h >> np.uint64(32)) | np.uint64(1)) & np.uint64(
            cap - 1
        )).astype(np.int64)
        unplaced = np.arange(n)
        # per slot, the lowest index among this round's bidders (n: none)
        owner = np.full(cap, n, np.int64)
        for p in range(cap):
            if not len(unplaced):
                break
            idx = (home[unplaced] + p * step[unplaced]) & (cap - 1)
            free = rk[idx] == -1
            cand = unplaced[free]
            cidx = idx[free]
            np.minimum.at(owner, cidx, cand)
            won = owner[cidx] == cand
            owner[cidx] = n
            win, widx = cand[won], cidx[won]
            rk[widx] = keys[win]
            rp[widx] = poss[win]
            lost = np.ones(n, bool)
            lost[win] = False
            unplaced = unplaced[lost[unplaced]]
        assert not len(unplaced), "csr registry build did not converge"
        return rk, rp

    # -- structure ---------------------------------------------------------
    def _grow_fcap(self, need: int) -> None:
        nf = max(self._fcap, _next_pow2(need))
        if nf == self._fcap:
            return
        for name in ("csr_off", "csr_len"):
            old = getattr(self, name)
            new = np.zeros((self.shards, nf), np.int32)
            new[:, : self._fcap] = old
            setattr(self, name, new)
            # per-array resync: only the (small) region tables re-upload
            self._log_resync(name)
        self._fcap = nf

    def _grow_hot(self) -> None:
        nh = self._hcap * 2
        for name in ("hot_fid", "hot_slot"):
            old = getattr(self, name)
            new = np.full((self.shards, nh), -1, np.int32)
            new[:, : self._hcap] = old  # append-only: indices preserved
            setattr(self, name, new)
            self._log_resync(name)
        self._hcap = nh

    def pack(self, filter_capacity: int) -> None:
        """Grow the region tables to cover `filter_capacity` fids (the
        serving snapshot gathers a real region for every matched fid)."""
        if filter_capacity > self._fcap:
            self._grow_fcap(filter_capacity)

    def maybe_absorb(self) -> bool:
        """Serve-time hot bound: fold an oversized hot segment into the
        packed CSR before the next snapshot (see HOT_SERVE_MAX). Runs on
        the mutating thread (the dirty prepare); one epoch bump."""
        if self.hot_fill <= self.HOT_SERVE_MAX:
            return False
        self._rebuild()
        return True

    @property
    def max_region(self) -> int:
        """Largest allocated packed region (diagnostics)."""
        return int(self.csr_len.max()) if self.csr_len.size else 0

    @property
    def hot_fill(self) -> int:
        return sum(self._hot_tail) - self.hot_tombs

    @property
    def nbytes(self) -> int:
        """Device-table footprint: the five mirrored arrays, exactly what
        the segment manager uploads."""
        return (
            self.csr_off.nbytes
            + self.csr_len.nbytes
            + self.csr_slots.nbytes
            + self.hot_fid.nbytes
            + self.hot_slot.nbytes
        )

    # -- mutation ----------------------------------------------------------
    def add(self, fid: int, slot: int) -> bool:
        key = self._key(fid, slot)
        if self._reg_get(key) is not None:
            return False  # already live (idempotent, like a bitmap OR)
        self._grow_fcap(fid + 1)
        s = slot % self.shards
        if self._hot_tail[s] >= self._hcap:
            if sum(self._hot_tail) - self.hot_tombs >= self.HOT_ABSORB_MAX:
                # no compactor is draining hot: fold inline (epoch bump)
                self._rebuild([(fid, slot)])
                return True
            self._grow_hot()
        h = self._hot_tail[s]
        self._hot_tail[s] = h + 1
        self.hot_fid[s, h] = fid
        self._log("hot_fid", s * self._hcap + h, fid)
        self.hot_slot[s, h] = slot
        self._log("hot_slot", s * self._hcap + h, slot)
        self._reg_set(key, h | HOT_POS)
        self.live += 1
        if slot > self.max_slot:
            self.max_slot = slot
        if self._journal is not None:
            self._journal.append(("add", fid, slot))
        return True

    def remove(self, fid: int, slot: int) -> bool:
        pos = self._reg_del(self._key(fid, slot))
        if pos is None:
            return False
        s = slot % self.shards
        if pos & HOT_POS:
            h = pos & ~HOT_POS
            self.hot_fid[s, h] = -1
            self._log("hot_fid", s * self._hcap + h, -1)
            self.hot_tombs += 1
        else:
            self.csr_slots[s, pos] = -1
            self._log("csr_slots", s * self._pcap + pos, -1)
            self.packed_tombs += 1
        self.live -= 1
        if self._journal is not None:
            self._journal.append(("remove", fid, slot))
        return True

    def slots_of(self, fid: int, out=None) -> np.ndarray:
        """All live slots of one fid (vectorized scans; the overflow-row
        dense fallback and oracles use it — NOT the batch path)."""
        parts = []
        if fid < self._fcap:
            for s in range(self.shards):
                o = int(self.csr_off[s, fid])
                n = int(self.csr_len[s, fid])
                seg = self.csr_slots[s, o : o + n]
                parts.append(seg[seg >= 0])
        m = self.hot_fid == fid
        if m.any():
            parts.append(self.hot_slot[m])
        if not parts:
            return np.empty(0, np.int32)
        return np.concatenate(parts)

    def live_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(fids, slots) of every live subscription — vectorized array
        scans (rebuilds, snapshots, representation flips)."""
        return self._pairs_from(
            self.csr_len, self.csr_slots, self.hot_fid, self.hot_slot
        )

    @staticmethod
    def _pairs_from(csr_len, csr_slots, hot_fid, hot_slot):
        fids, slots = [], []
        S = csr_len.shape[0]
        for s in range(S):
            total = int(csr_len[s].sum())
            if total:
                fid_of_pos = np.repeat(
                    np.arange(csr_len.shape[1], dtype=np.int64), csr_len[s]
                )
                seg = csr_slots[s, :total]
                m = seg >= 0
                fids.append(fid_of_pos[m])
                slots.append(seg[m].astype(np.int64))
        hm = hot_fid >= 0
        if hm.any():
            fids.append(hot_fid[hm].astype(np.int64))
            slots.append(hot_slot[hm].astype(np.int64))
        if not fids:
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        return np.concatenate(fids), np.concatenate(slots)

    def _rebuild(self, extra_fids=None, extra_slots=None) -> None:
        """Inline full rebuild (bulk loads, the hot safety valve): merge
        the live pairs and the extra ones into a fresh exact-size CSR. One
        epoch bump — the op-log path never sees O(table) writes.

        The JAX table takes the extra pairs as a list of tuples; here they
        are two int arrays (or one list of tuples as `extra_fids`), so an
        80M-pair bulk load never becomes Python objects. `_build` sorts
        and dedups the keys, so the result is the same table."""
        fids, slots = self.live_pairs()
        if extra_slots is None and extra_fids is not None and len(extra_fids):
            extra_fids, extra_slots = (
                np.array([e[0] for e in extra_fids], np.int64),
                np.array([e[1] for e in extra_fids], np.int64),
            )
        if extra_slots is not None and len(extra_slots):
            if len(fids):
                fids = np.concatenate([fids, extra_fids])
                slots = np.concatenate([slots, extra_slots])
            else:
                fids, slots = extra_fids, extra_slots
        self._structure_gen += 1
        self._journal = None
        built = self._build(
            fids, slots, self.shards, max(self._fcap, 64)
        )
        self._install(built)
        self._bump()

    @staticmethod
    def _build(fids, slots, shards: int, fcap: int) -> Dict:
        """Pure-numpy CSR build from (fid, slot) pairs (dedup'd): safe on
        any thread."""
        if len(fids):
            key = (fids.astype(np.int64) << 32) | slots.astype(np.int64)
            key = np.unique(key)  # dedup + sorted by (fid, slot)
            fids = (key >> 32).astype(np.int64)
            slots = (key & 0xFFFFFFFF).astype(np.int64)
            fcap = max(fcap, _next_pow2(int(fids.max()) + 1))
        S = shards
        shard = (slots % S).astype(np.int64) if len(slots) else slots
        counts = np.zeros((S, fcap), np.int64)
        if len(fids):
            np.add.at(counts, (shard, fids), 1)
        per_total = counts.sum(axis=1)
        pcap = max(256, _next_pow2(int(per_total.max()) if S else 0))
        csr_len = counts.astype(np.int32)
        csr_off = np.zeros((S, fcap), np.int32)
        csr_slots = np.full((S, pcap), -1, np.int32)
        poss = np.zeros(len(fids), np.int64)
        for s in range(S):
            off = np.cumsum(counts[s]) - counts[s]
            csr_off[s] = off.astype(np.int32)
            m = shard == s
            # key-sorted pairs are already grouped by fid (ascending):
            # position = region offset + rank within the fid run
            sf = fids[m]
            if len(sf):
                idx = np.arange(len(sf))
                rank = idx - np.searchsorted(sf, sf, side="left")
                pos = off[sf] + rank
                csr_slots[s, pos] = slots[m].astype(np.int32)
                poss[m] = pos
        keys = (
            (fids << 32) | slots
            if len(fids)
            else np.empty(0, np.int64)
        )
        cap = 1024
        while (len(keys) + 1) * 2 > cap:
            cap *= 2
        rk, rp = CsrTable._reg_build_arrays(
            keys, poss.astype(np.int32), cap
        )
        return {
            "fcap": fcap,
            "pcap": pcap,
            "csr_off": csr_off,
            "csr_len": csr_len,
            "csr_slots": csr_slots,
            "reg_key": rk,
            "reg_pos": rp,
            "reg_cap": cap,
            "n": len(fids),
            "max_slot": int(slots.max()) if len(slots) else -1,
        }

    # oplog-covered-by: every caller bumps the epoch after install
    def _install(self, built: Dict) -> None:
        S = self.shards
        self._fcap = built["fcap"]
        self._pcap = built["pcap"]
        self.csr_off = built["csr_off"]
        self.csr_len = built["csr_len"]
        self.csr_slots = built["csr_slots"]
        self._hcap = self.HOT_MIN
        self.hot_fid = np.full((S, self._hcap), -1, np.int32)
        self.hot_slot = np.full((S, self._hcap), -1, np.int32)
        self._hot_tail = [0] * S
        self.hot_tombs = 0
        self.packed_tombs = 0
        self.live = built["n"]
        self.max_slot = max(self.max_slot, built["max_slot"])
        self._reg_key = built["reg_key"]
        self._reg_pos = built["reg_pos"]
        self._reg_cap = built["reg_cap"]
        self._reg_fill = self._reg_live = built["n"]

    def bulk_add(self, fids, slots) -> None:
        """Vectorized bulk load: one rebuild + one epoch bump (the dense
        table's `bulk_add` contract). The arrays go to `_build` as they
        are, never through a Python list."""
        fids = np.asarray(fids, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        if not len(fids):
            return
        self._rebuild(fids, slots)

    def reshard(self, shards: int) -> None:
        """Re-partition the table over a new shard count (a mesh attached
        after subscriptions landed): one rebuild, one epoch bump. The
        counterpart of `reshard` (emqx_tpu/ops/csr_table.py:625)."""
        if shards == self.shards:
            return
        fids, slots = self.live_pairs()
        self.shards = max(1, int(shards))
        self._structure_gen += 1
        self._journal = None
        built = self._build(fids, slots, self.shards, 64)
        self._install(built)
        self._bump()

    def device_snapshot(self) -> Dict[str, np.ndarray]:
        return {
            "csr_off": self.csr_off,
            "csr_len": self.csr_len,
            "csr_slots": self.csr_slots,
            "hot_fid": self.hot_fid,
            "hot_slot": self.hot_slot,
        }

    # -- compaction cycle (capture, build off-thread, install + replay) ----
    def begin_compact(self) -> Dict:
        cap = {
            "csr_len": self.csr_len.copy(),
            "csr_slots": self.csr_slots.copy(),
            "hot_fid": self.hot_fid.copy(),
            "hot_slot": self.hot_slot.copy(),
            "shards": self.shards,
            "fcap": self._fcap,
            "gen": self._structure_gen,
        }
        self._journal = []
        return cap

    @staticmethod
    def build_compact(cap: Dict) -> Dict:
        fids, slots = CsrTable._pairs_from(
            cap["csr_len"], cap["csr_slots"], cap["hot_fid"],
            cap["hot_slot"],
        )
        built = CsrTable._build(fids, slots, cap["shards"], cap["fcap"])
        built["gen"] = cap["gen"]
        return built

    def apply_compact(self, built: Dict) -> bool:
        """Install a built CSR + replay the journal of mutations that raced
        the build. False = capture invalidated by a structural rebuild
        (the cycle aborts cleanly)."""
        if self._journal is None or built["gen"] != self._structure_gen:
            self._journal = None
            return False
        journal, self._journal = self._journal, None
        self._structure_gen += 1
        self._install(built)
        self._bump()
        for op, fid, slot in journal:
            if op == "add":
                self.add(fid, slot)
            else:
                self.remove(fid, slot)
        return True


class CsrSegmentOwner:
    """Compaction adapter for a sparse `SubscriberTable` + its segment
    manager: merge ``packed - tombstones + hot`` into a fresh exact-size
    CSR off the subscribe path, uploading the packed arrays on the
    compaction thread (`ops.segments.SegmentCompactor` drives the cycle).
    The port's copy of emqx_tpu/ops/csr_table.py:692. With a `placement`
    (`parallel.mesh.csr_placement`) the upload is this rank's shard."""

    key = "bitmaps"

    def __init__(self, subtab, manager, placement=None,
                 hot_entries: int = 1024, tombstone_frac: float = 0.25):
        self.subtab = subtab  # the facade; .csr is the live CsrTable
        self.manager = manager
        self._placement = placement
        self.hot_entries = hot_entries
        self.tombstone_frac = tombstone_frac

    def needs_compact(self) -> bool:
        sp = self.subtab.csr
        if sp is None:
            return False
        if sp.hot_fill >= self.hot_entries:
            return True
        tombs = sp.packed_tombs + sp.hot_tombs
        return tombs > 0 and tombs >= self.tombstone_frac * max(
            1, sp.live
        )

    def begin(self):
        return self.subtab.csr.begin_compact()

    def build(self, cap):
        from emqx_tpu_torch.ops.segments import upload_offer

        built = CsrTable.build_compact(cap)
        # upload the packed arrays on THIS (executor) thread: the built
        # table is immutable, so the upload is race-free and the serving
        # path adopts instead of paying it
        built["dev"] = upload_offer(
            {name: built[name] for name in ("csr_off", "csr_len", "csr_slots")},
            self.manager.device, self._placement)
        return built

    def apply(self, built):
        sp = self.subtab.csr
        if sp is None:  # the representation flipped away mid-cycle
            return None
        from emqx_tpu_torch.ops.segments import fresh_offer

        merged = sp.hot_fill
        epoch0 = self.subtab.epoch
        if not sp.apply_compact(built):
            return None
        epoch = self.subtab.epoch
        return epoch, fresh_offer(built["dev"], epoch, epoch0), 0, merged
