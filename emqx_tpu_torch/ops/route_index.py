"""Top-level incremental route compiler: shape fast path + residual NFA.

One filter-id space shared by two device engines:

- `ShapeIndex` (ops/shape_index.py) — O(#shapes) hash probes per topic;
  takes every filter whose wildcard shape fits. This is where ~all real
  subscription tables land.
- `NfaBuilder` (ops/nfa.py) — the general trie-walk kernel; holds only the
  RESIDUAL filters the shape index rejected (shape overflow past
  MAX_SHAPES, or a 2^-64 combined-hash collision).

The device route step runs the shape kernel always and the NFA kernel only
when residuals exist (models/router_model.shape_route_step). Both engines
speak the delta-overlay protocol, so churn reaches the device as scatters.

Reference analog: this pair replaces emqx_router's match path
(emqx_router.erl:128-141) the way the trie's compaction replaces
level-by-level walking (emqx_trie.erl:201-232) — except compiled all the
way down to fixed-shape batch kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.ops.nfa import NfaBuilder, _next_pow2
from emqx_tpu_torch.ops.shape_index import (
    MAX_MASK_LEVELS,
    MAX_SHAPES,
    ShapeIndex,
    level_mul,
)

_PLUS = ord("+")
_HASH = ord("#")
_SLASH = ord("/")


class _ColdFallback(Exception):
    """Input needs the per-filter path (non-ASCII, exotic dtypes, ...)."""


def _encode_ascii(filters: List[str]):
    """list[str] -> (mat uint8 [n,W], lens int32 [n]) via numpy's C-level
    ASCII encode. Raises _ColdFallback for non-ASCII / embedded NULs
    (the 'S' dtype cannot represent trailing NULs faithfully)."""
    try:
        arr = np.asarray(filters, dtype="S")
    except (UnicodeEncodeError, TypeError) as e:
        raise _ColdFallback from e
    width = arr.dtype.itemsize
    if width == 0:
        raise _ColdFallback  # all-empty: let validate raise properly
    lens = np.char.str_len(arr).astype(np.int32)
    if int(lens.sum()) != sum(map(len, filters)):
        raise _ColdFallback  # NUL bytes somewhere: disagreement w/ S-dtype
    mat = np.ascontiguousarray(arr).view(np.uint8).reshape(len(arr), width)
    return mat, lens


def _validate_rows(filters: List[str], mat, lens) -> None:
    """Vectorized emqx_topic validate over the whole batch; raises the
    slow-path TopicValidationError for the first offending filter.
    Processed in row blocks so the working set stays cache-resident."""
    n, width = mat.shape
    cols = np.arange(width, dtype=np.int32)[None, :]
    BLOCK = 1 << 17
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        mb, lb = mat[lo:hi], lens[lo:hi]
        inb = cols < lb[:, None]
        nul = inb & (mb == 0)  # embedded NUL: invalid (trailing NULs are
        # padding and sit beyond lens, so inb excludes them)
        is_p = inb & (mb == _PLUS)
        is_h = inb & (mb == _HASH)
        w = is_p | is_h
        if (
            not w.any()
            and not nul.any()
            and not (lb == 0).any()
            and width <= T.MAX_TOPIC_LEN
        ):
            continue  # pure-literal block: nothing left to check
        left_ok = np.empty(mb.shape, dtype=bool)
        left_ok[:, 0] = True
        left_ok[:, 1:] = mb[:, :-1] == _SLASH
        at_end = cols == (lb[:, None] - 1)
        right_ok = np.empty(mb.shape, dtype=bool)
        right_ok[:, :-1] = mb[:, 1:] == _SLASH
        right_ok[:, -1] = False
        right_ok |= at_end
        standalone = left_ok & right_ok
        bad = (w & ~standalone) | (is_h & standalone & ~at_end) | nul
        bad_rows = bad.any(axis=1) | (lb == 0)
        if width > T.MAX_TOPIC_LEN:
            bad_rows |= lb > T.MAX_TOPIC_LEN
        if bad_rows.any():
            i = lo + int(np.argmax(bad_rows))
            T.validate(filters[i])  # raises with the precise reason
            raise T.TopicValidationError("topic_invalid: %r" % filters[i])


_ROW_C = np.uint64(0x9E3779B97F4A7C15)
_ROW_C2 = np.uint64(0xC2B2AE3D27D4EB4F)
_row_R_cache: Optional[np.ndarray] = None
_row_R2_cache: Optional[np.ndarray] = None


def _row_R(width: int) -> np.ndarray:
    """Per-column multipliers for the primary 64-bit row hash. One fixed
    stream sliced to `width`: zero-padding beyond a row's length
    contributes nothing, so the key of a string is independent of the
    batch's padded matrix width."""
    global _row_R_cache
    if _row_R_cache is None or len(_row_R_cache) < width:
        rng = np.random.default_rng(0x5EED)
        # 4x: utf-8 bytes per char upper bound (scalar keys hash the
        # encoded bytes) — the stream must never regrow once keys exist
        n = max(4 * (T.MAX_TOPIC_LEN + 1), width)
        _row_R_cache = rng.integers(
            1, 1 << 63, size=n, dtype=np.uint64
        ) | np.uint64(1)
    return _row_R_cache[:width]


def _row_R2(width: int) -> np.ndarray:
    """Independent multiplier stream for the 32-bit confirm hash (96
    bits of key material total — see RouteIndex registry notes)."""
    global _row_R2_cache
    if _row_R2_cache is None or len(_row_R2_cache) < width:
        rng = np.random.default_rng(0xBEEF)
        n = max(4 * (T.MAX_TOPIC_LEN + 1), width)
        _row_R2_cache = rng.integers(
            1, 1 << 63, size=n, dtype=np.uint64
        ) | np.uint64(1)
    return _row_R2_cache[:width]


def _row_keys(mat, lens) -> np.ndarray:
    """Primary 64-bit row hashes for an encoded batch (shared by dedup
    and the registry hash table, so cold-load keys are reusable
    verbatim)."""
    with np.errstate(over="ignore"):
        return mat.astype(np.uint64) @ _row_R(mat.shape[1]) + lens.astype(
            np.uint64
        ) * _ROW_C


def _fold32(k: np.ndarray) -> np.ndarray:
    return (k ^ (k >> np.uint64(32))).astype(np.uint32)


def _row_keys2(mat, lens) -> np.ndarray:
    """Confirm hashes (uint32) from the independent stream."""
    with np.errstate(over="ignore"):
        k = mat.astype(np.uint64) @ _row_R2(
            mat.shape[1]
        ) + lens.astype(np.uint64) * _ROW_C2
    return _fold32(k)


def _row_key_str(f: str):
    """Scalar (primary, confirm) key pair for one (possibly non-ASCII)
    filter string — bit-identical to the vectorized batch keys."""
    b = np.frombuffer(f.encode("utf-8"), np.uint8)
    n = len(b)
    with np.errstate(over="ignore"):
        b64 = b.astype(np.uint64)
        k1 = (b64 * _row_R(n)).sum(dtype=np.uint64) + np.uint64(n) * _ROW_C
        k2 = (b64 * _row_R2(n)).sum(dtype=np.uint64) + np.uint64(n) * _ROW_C2
    return k1, _fold32(k2)


def _dedup_rows(mat, lens, key=None):
    """Group identical rows without a full string sort: 64-bit row hashes
    + stable argsort + exact adjacent-row compare. Returns
    (first_pos, inv_fid, counts) with distinct rows numbered in
    FIRST-OCCURRENCE order, or None when a hash collision makes the
    grouping ambiguous (caller falls back to the per-filter path)."""
    n, width = mat.shape
    if key is None:
        key = _row_keys(mat, lens)
    srt = np.argsort(key, kind="stable")
    ks = key[srt]
    ms = mat[srt]
    same_key = np.empty(n, dtype=bool)
    same_key[0] = False
    same_key[1:] = ks[1:] == ks[:-1]
    same_row = np.empty(n, dtype=bool)
    same_row[0] = False
    same_row[1:] = (
        same_key[1:] & (ms[1:] == ms[:-1]).all(axis=1)
    )
    # hash-equal but content-different adjacency could interleave two
    # distinct strings' duplicates => ambiguous grouping; bail out
    if (same_key & ~same_row).any():
        return None
    group_sorted = np.cumsum(~same_row) - 1  # group id along sorted order
    n_groups = int(group_sorted[-1]) + 1
    starts = np.nonzero(~same_row)[0]
    counts_sorted = np.diff(np.append(starts, n))
    first_pos_sorted = np.minimum.reduceat(srt, starts)
    # renumber groups by first occurrence (== repeated-add fid order)
    order = np.argsort(first_pos_sorted, kind="stable")
    rank = np.empty(n_groups, dtype=np.int64)
    rank[order] = np.arange(n_groups, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[srt] = rank[group_sorted]
    return first_pos_sorted[order], inv, counts_sorted[order]


# registry hash-table fid-lane sentinels
_H_EMPTY = -1
_H_TOMB = -2


class RouteIndex:
    def __init__(self, max_shapes: int = MAX_SHAPES):
        # filter -> fid registry as an open-addressing numpy table:
        # `_hkey` (primary 64-bit row hash), `_hkey2` (independent
        # 32-bit confirm hash), `_hfid` fids. A Python dict at 10M
        # entries costs ~700MB and a ~30s one-shot materialization the
        # first post-restore subscribe would stall on; the table is
        # built vectorized inside the cold bulk load and batch lookups
        # are numpy probe rounds — the mass-reconnect path never walks
        # a 10M dict. Exactness: scalar paths (add/remove/filter_id)
        # confirm every hit by exact string compare; BULK lookups
        # confirm by the 96-bit key pair only — re-encoding ~131k
        # candidate strings per churn wave costs ~70ms (measured), vs
        # a 2^-96 false-accept bound, orders below memory-error rates.
        self._hkey: np.ndarray = np.zeros(16, np.uint64)
        self._hkey2: np.ndarray = np.zeros(16, np.uint32)
        self._hfid: np.ndarray = np.full(16, _H_EMPTY, np.int64)
        self._hfill = 0  # occupied slots (live + tombstones)
        self._live = 0  # distinct live filters
        self._ids: List[Optional[str]] = []
        # refcounts as a capacity-doubled numpy array: churn-storm waves
        # bump thousands of refs per batch as ONE np.add.at scatter
        self._refs: np.ndarray = np.zeros(16, np.int64)
        self._free: List[int] = []
        self.nfa = NfaBuilder()
        self.shapes = ShapeIndex(max_shapes=max_shapes)
        # fid -> name recovery for the shape engine's salt rebuilds
        # (bound method: picklable, follows `_ids` mutations)
        self.shapes.resolve_name = self.filter_name
        self._residual: Set[str] = set()

    def _refs_ensure(self, n: int) -> None:
        if n > len(self._refs):
            new = np.zeros(max(16, _next_pow2(n)), np.int64)
            new[: len(self._refs)] = self._refs
            self._refs = new

    # -- filter->fid registry (open-addressing, two-key confirmed) --------
    def _hash_get(self, filter_: str, _keys=None) -> Optional[int]:
        """Probe for `filter_`; every key hit is confirmed by exact
        string compare, so a key collision degrades to one extra probe,
        never a wrong fid. `_keys` lets add() reuse one key computation
        across its get+set pair (subscribe-storm hot path)."""
        key, key2 = _keys if _keys is not None else _row_key_str(filter_)
        cap = len(self._hkey)
        mask = cap - 1
        slot = int(key) & mask
        step = ((int(key) >> 32) & mask) | 1
        hfid, hkey, hkey2, ids = (
            self._hfid, self._hkey, self._hkey2, self._ids
        )
        for _ in range(cap):
            fid = int(hfid[slot])
            if fid == _H_EMPTY:
                return None
            if (
                fid >= 0
                and hkey[slot] == key
                and hkey2[slot] == key2
                and ids[fid] == filter_
            ):
                return fid
            slot = (slot + step) & mask
        return None

    def _hash_set(self, filter_: str, fid: int, _keys=None) -> None:
        """Insert (caller has established absence). Reuses the first
        tombstone on the probe path; grows at 2/3 occupancy."""
        if (self._hfill + 1) * 3 > 2 * len(self._hkey):
            self._hash_rehash(self._live + 1)
        key, key2 = _keys if _keys is not None else _row_key_str(filter_)
        cap = len(self._hkey)
        mask = cap - 1
        slot = int(key) & mask
        step = ((int(key) >> 32) & mask) | 1
        tomb = -1
        for _ in range(cap):
            fid0 = int(self._hfid[slot])
            if fid0 == _H_EMPTY:
                if tomb >= 0:
                    slot = tomb
                else:
                    self._hfill += 1
                self._hkey[slot] = key
                self._hkey2[slot] = key2
                self._hfid[slot] = fid
                return
            if fid0 == _H_TOMB and tomb < 0:
                tomb = slot
            slot = (slot + step) & mask
        raise RuntimeError("registry hash table full")  # unreachable

    def _hash_del(self, filter_: str) -> None:
        key, key2 = _row_key_str(filter_)
        cap = len(self._hkey)
        mask = cap - 1
        slot = int(key) & mask
        step = ((int(key) >> 32) & mask) | 1
        ids = self._ids
        for _ in range(cap):
            fid = int(self._hfid[slot])
            if fid == _H_EMPTY:
                return
            if (
                fid >= 0
                and self._hkey[slot] == key
                and self._hkey2[slot] == key2
                and ids[fid] == filter_
            ):
                self._hfid[slot] = _H_TOMB  # slot stays occupied for probes
                return
            slot = (slot + step) & mask

    def _hash_alloc(self, cap: int) -> None:
        self._hkey = np.zeros(cap, np.uint64)
        self._hkey2 = np.zeros(cap, np.uint32)
        self._hfid = np.full(cap, _H_EMPTY, np.int64)
        self._hfill = 0

    def _hash_build(
        self,
        keys: np.ndarray,
        keys2: np.ndarray,
        fids: np.ndarray,
        cap: int,
    ) -> None:
        """Vectorized table build from per-row keys: each probe round
        gathers the pending rows' slots, the first pending row per free
        slot claims it (stable sort), losers and occupied-slot rows
        advance by their stride. ~2 rounds resolve a fresh table."""
        self._hash_alloc(cap)
        mask = np.int64(cap - 1)
        slot = (keys & np.uint64(cap - 1)).astype(np.int64)
        step = (
            ((keys >> np.uint64(32)).astype(np.int64) & mask) | np.int64(1)
        )
        pending = np.arange(len(keys))
        while pending.size:
            s = slot[pending]
            free = self._hfid[s] == _H_EMPTY
            if free.any():
                cand, scand = pending[free], s[free]
                order = np.argsort(scand, kind="stable")
                scand, cand = scand[order], cand[order]
                first = np.empty(len(scand), bool)
                first[0] = True
                first[1:] = scand[1:] != scand[:-1]
                win, wslot = cand[first], scand[first]
                self._hkey[wslot] = keys[win]
                self._hkey2[wslot] = keys2[win]
                self._hfid[wslot] = fids[win]
                placed = np.zeros(len(keys), bool)
                placed[win] = True
                pending = pending[~placed[pending]]
                if pending.size == 0:
                    break
            slot[pending] = (slot[pending] + step[pending]) & mask
        self._hfill = len(keys)

    def _hash_insert_batch(
        self, keys: np.ndarray, keys2: np.ndarray, fids: np.ndarray
    ) -> None:
        """Vectorized insert of fresh rows into the LIVE table (caller
        has established absence): probe rounds claim empty OR tombstone
        slots, first bidder per slot wins. O(batch), not O(table)."""
        n = len(keys)
        if n == 0:
            return
        if (self._hfill + n) * 3 > 2 * len(self._hkey):
            self._hash_rehash(self._live + n)
        cap = len(self._hkey)
        mask = np.int64(cap - 1)
        slot = (keys & np.uint64(cap - 1)).astype(np.int64)
        step = (
            ((keys >> np.uint64(32)).astype(np.int64) & mask) | np.int64(1)
        )
        pending = np.arange(n)
        while pending.size:
            s = slot[pending]
            free = self._hfid[s] < 0  # EMPTY or TOMB: both claimable
            if free.any():
                cand, scand = pending[free], s[free]
                order = np.argsort(scand, kind="stable")
                scand, cand = scand[order], cand[order]
                first = np.empty(len(scand), bool)
                first[0] = True
                first[1:] = scand[1:] != scand[:-1]
                win, wslot = cand[first], scand[first]
                # count EMPTY claims before overwriting the lane
                self._hfill += int(
                    (self._hfid[wslot] == _H_EMPTY).sum()
                )
                self._hkey[wslot] = keys[win]
                self._hkey2[wslot] = keys2[win]
                self._hfid[wslot] = fids[win]
                placed = np.zeros(n, bool)
                placed[win] = True
                pending = pending[~placed[pending]]
                if pending.size == 0:
                    break
            slot[pending] = (slot[pending] + step[pending]) & mask

    def _hash_rehash(self, need: int) -> None:
        """Grow + drop tombstones: vectorized rebuild from `_ids` (the
        per-filter fallback covers non-ASCII registries)."""
        cap = _next_pow2(max(16, 2 * max(need, self._live)))
        ids = self._ids
        live = [
            (f, fid) for fid, f in enumerate(ids) if f is not None
        ]
        if not live:
            self._hash_alloc(cap)
            return
        try:
            mat, lens = _encode_ascii([f for f, _ in live])
        except _ColdFallback:
            self._hash_alloc(cap)
            for f, fid in live:
                self._hash_set(f, fid)
            return
        self._hash_build(
            _row_keys(mat, lens),
            _row_keys2(mat, lens),
            np.array([fid for _, fid in live], np.int64),
            cap,
        )

    def _hash_lookup_batch(self, filters: List[str]):
        """Vectorized membership for a warm batch: returns
        (fids int64 — -1 for miss, mat, lens, keys, keys2). Hits are
        confirmed by BOTH independent keys (96 bits; see __init__
        notes); unconfirmed key-matches keep probing (a same-key
        different-string chain is legal). Raises _ColdFallback for
        non-ASCII input."""
        mat, lens = _encode_ascii(filters)
        keys = _row_keys(mat, lens)
        keys2 = _row_keys2(mat, lens)
        n = len(filters)
        cap = len(self._hkey)
        mask = np.int64(cap - 1)
        res = np.full(n, -1, np.int64)
        slot = (keys & np.uint64(cap - 1)).astype(np.int64)
        step = (
            ((keys >> np.uint64(32)).astype(np.int64) & mask) | np.int64(1)
        )
        pending = np.arange(n)
        for _ in range(cap):
            s = slot[pending]
            fidv = self._hfid[s]
            empty = fidv == _H_EMPTY
            hit = (
                (fidv >= 0)
                & (self._hkey[s] == keys[pending])
                & (self._hkey2[s] == keys2[pending])
            )
            res[pending[hit]] = fidv[hit]
            pending = pending[~(empty | hit)]
            if pending.size == 0:
                break
            slot[pending] = (slot[pending] + step[pending]) & mask
        return res, mat, lens, keys, keys2

    # -- mutation ----------------------------------------------------------
    def add(self, filter_: str) -> int:
        T.validate(filter_)
        keys = _row_key_str(filter_)
        fid = self._hash_get(filter_, keys)
        if fid is not None:
            self._refs[fid] += 1
            return fid
        if self._free:
            fid = self._free.pop()
            self._ids[fid] = filter_
            self._refs[fid] = 1
        else:
            fid = len(self._ids)
            self._ids.append(filter_)
            self._refs_ensure(fid + 1)
            self._refs[fid] = 1
        self._hash_set(filter_, fid, keys)
        self._live += 1
        if not self.shapes.add(filter_, fid):
            self._residual.add(filter_)
            self.nfa.add(filter_, fid=fid)
            # vocab collision bumped the tokenizer salt: every combined
            # hash in the shape index is now stale. Filters whose NEW
            # hashes collide are evicted and re-homed in the NFA — which
            # can itself bump the salt again, hence the loop (converges:
            # each iteration needs a fresh 64-bit hash collision).
            while self.nfa.salt != self.shapes.salt:
                for ef, efid in self.shapes.rebuild(self.nfa.salt):
                    self._residual.add(ef)
                    self.nfa.add(ef, fid=efid)
        return fid

    def bulk_add(self, filters) -> List[int]:
        """Vectorized insert (cold start / session restore). Returns fids,
        parallel to `filters`. Matches repeated `add` bit-for-bit (tests
        enforce).

        Two tiers: on an EMPTY index with ASCII filters the whole load —
        encode, validate, dedup, tokenize, shape compile, hash-table
        placement, host mirror — runs as numpy passes with no per-filter
        Python (`_bulk_add_cold`); anything else takes the per-filter
        dict path (`_bulk_add_warm`), which still vectorizes hashing and
        placement but walks dicts for dedup against live state.
        """
        filters = list(filters)
        if not filters:
            return []
        if not self._ids and not self._free:
            try:
                return self._bulk_add_cold(filters)
            except _ColdFallback:
                pass
        return self._bulk_add_warm(filters)

    def _bulk_add_cold(self, filters: List[str]) -> List[int]:
        """Cold-start load: every step a numpy pass over the batch.

        Replaces the reference's per-route mnesia writes on session
        restore (emqx_trie.erl:66-119 insert per filter) with one
        vectorized table compile; at 10M filters this is the difference
        between minutes and seconds.
        """
        mat, lens = _encode_ascii(filters)
        _validate_rows(filters, mat, lens)
        key = _row_keys(mat, lens)
        dd = _dedup_rows(mat, lens, key)
        if dd is None:
            raise _ColdFallback  # pathological 64-bit row-hash collision
        first_pos, inv, counts = dd
        n = len(first_pos)
        # registry keys for the distinct rows (both streams, pre-del)
        keys_d = key[first_pos]
        keys2_d = _row_keys2(mat, lens)[first_pos]
        del key
        first_l = first_pos.tolist()
        names = [filters[i] for i in first_l]
        mat_d = mat[first_pos]
        lens_d = lens[first_pos]
        del mat, lens
        # -- tokenize + shape-compile the distinct rows, in blocks -------
        from emqx_tpu_torch.ops.tokenizer import tokenize_host_np

        cols = np.arange(mat_d.shape[1], dtype=np.int32)[None, :]
        nsep_all = (
            (mat_d == _SLASH) & (cols < lens_d[:, None])
        ).sum(axis=1)
        # levels needed: literal mask positions (<= 32) + the last word
        # for the trailing-'#' test; deeper rows are residual regardless
        L = int(min(int(nsep_all.max()) + 1, MAX_MASK_LEVELS + 2))
        Lc = min(L, MAX_MASK_LEVELS)
        k1 = np.array([level_mul(l, 1) for l in range(Lc)], dtype=np.uint32)
        k2 = np.array([level_mul(l, 2) for l in range(Lc)], dtype=np.uint32)
        lvls = np.arange(Lc, dtype=np.int64)[None, :]
        masks = np.empty(n, np.uint32)
        plens = np.empty(n, np.int64)
        hhs = np.empty(n, bool)
        s1 = np.empty(n, np.uint32)
        s2 = np.empty(n, np.uint32)
        unfit = np.zeros(n, bool)
        BLOCK = 1 << 18
        salt = self.shapes.salt
        W = mat_d.shape[1]
        with np.errstate(over="ignore"):
            for lo in range(0, n, BLOCK):
                hi = min(lo + BLOCK, n)
                mb, lb = mat_d[lo:hi], lens_d[lo:hi]
                h1, h2, nw, _dol, ws, wl = tokenize_host_np(mb, lb, salt, L)
                first_b = np.take_along_axis(
                    mb, np.clip(ws, 0, W - 1), axis=1
                )
                one = wl == 1
                isp = one & (first_b == _PLUS)
                ish = one & (first_b == _HASH)
                nwb = nw.astype(np.int64)
                deep = nwb > L
                last = np.clip(nwb - 1, 0, L - 1)[:, None]
                hh = (
                    np.take_along_axis(ish, last, axis=1)[:, 0] & ~deep
                )
                pl = nwb - hh
                bad = deep | (pl > MAX_MASK_LEVELS)
                lit = (~isp[:, :Lc]) & (lvls < pl[:, None])
                mk = (
                    lit.astype(np.uint64) << lvls.astype(np.uint64)
                ).sum(axis=1).astype(np.uint32)
                lb32 = lit.astype(np.uint32)
                s1[lo:hi] = np.sum(
                    h1[:, :Lc] * k1[None, :] * lb32, axis=1, dtype=np.uint32
                )
                s2[lo:hi] = np.sum(
                    h2[:, :Lc] * k2[None, :] * lb32, axis=1, dtype=np.uint32
                )
                masks[lo:hi] = mk
                plens[lo:hi] = pl
                hhs[lo:hi] = hh
                unfit[lo:hi] = bad
        fids = np.arange(n, dtype=np.int64)
        rejected = self.shapes.bulk_add_cold(
            names, fids, masks, plens, hhs, s1, s2, unfit
        )
        # -- host registry (COPY the list — `names` is also stashed in
        # shapes._cold and `add` appends to `_ids`). The hash table builds
        # HERE, vectorized from the dedup keys: ~2s at 10M vs the ~30s
        # first-subscribe stall a lazily-materialized dict would cost ----
        self._ids = list(names)
        self._refs = np.zeros(max(16, _next_pow2(len(names))), np.int64)
        self._refs[: len(names)] = counts
        self._hash_build(
            keys_d,
            keys2_d,
            np.arange(n, dtype=np.int64),
            _next_pow2(max(16, 2 * n)),
        )
        self._live = n
        for ef, efid in rejected:
            self._residual.add(ef)
            self.nfa.add(ef, fid=efid)
        while self.nfa.salt != self.shapes.salt:
            for ef, efid in self.shapes.rebuild(self.nfa.salt):
                self._residual.add(ef)
                self.nfa.add(ef, fid=efid)
        return inv.tolist()

    def _bulk_add_warm(self, filters) -> List[int]:
        """Warm-state batch path, churn-storm shaped: resubscribes (the
        mass-reconnect common case — the filter already exists) resolve
        as vectorized hash-table probe rounds plus ONE refcount scatter
        — no per-filter Python and no 10M-entry dict; fresh filters
        validate first (an invalid filter must not leave earlier batch
        entries half-registered => silently unroutable), then flow to
        the shape engine's hot segment in one batch."""
        try:
            got_a, _mat, _lens, keys, keys2 = self._hash_lookup_batch(
                filters
            )
        except _ColdFallback:
            # non-ASCII somewhere: per-filter path, identical semantics
            return [self.add(f) for f in filters]
        if (got_a < 0).any():
            fresh_pos = np.nonzero(got_a < 0)[0].tolist()
            seen: Dict[str, int] = {}
            uniq_i: List[int] = []
            for i in fresh_pos:
                f = filters[i]
                if f not in seen:
                    seen[f] = -1
                    uniq_i.append(i)
            # validate EVERYTHING before any mutation: an invalid filter
            # must not leave earlier batch entries half-registered
            # (named but not indexed => silently unroutable)
            for i in uniq_i:
                T.validate(filters[i])
            fresh: List[tuple] = []
            ids = self._ids
            free = self._free
            ufids = np.empty(len(uniq_i), np.int64)
            for j, i in enumerate(uniq_i):
                f = filters[i]
                if free:
                    fid = free.pop()
                    ids[fid] = f
                else:
                    fid = len(ids)
                    ids.append(f)
                ufids[j] = fid
                seen[f] = fid
                fresh.append((f, fid))
            self._refs_ensure(int(ufids.max()) + 1)
            self._refs[ufids] = 0  # counted with the batch below
            ui = np.array(uniq_i, np.int64)
            self._hash_insert_batch(keys[ui], keys2[ui], ufids)
            self._live += len(uniq_i)
            for ef, efid in self.shapes.bulk_add(fresh):
                self._residual.add(ef)
                self.nfa.add(ef, fid=efid)
            while self.nfa.salt != self.shapes.salt:
                for ef, efid in self.shapes.rebuild(self.nfa.salt):
                    self._residual.add(ef)
                    self.nfa.add(ef, fid=efid)
            for i in fresh_pos:
                got_a[i] = seen[filters[i]]
        np.add.at(self._refs, got_a, 1)
        return got_a.tolist()

    def remove(self, filter_: str) -> bool:
        fid = self._hash_get(filter_)
        if fid is None:
            return False
        self._refs[fid] -= 1
        if self._refs[fid] > 0:
            return False
        self._hash_del(filter_)
        self._live -= 1
        self._ids[fid] = None
        self._free.append(fid)
        if filter_ in self._residual:
            self._residual.discard(filter_)
            self.nfa.remove(filter_)
        else:
            self.shapes.remove(filter_)
        return True

    # -- lookups -----------------------------------------------------------
    def filter_name(self, fid: int) -> Optional[str]:
        return self._ids[fid] if 0 <= fid < len(self._ids) else None

    def filter_id(self, filter_: str) -> Optional[int]:
        return self._hash_get(filter_)

    def __len__(self) -> int:
        return self._live

    @property
    def num_filters_capacity(self) -> int:
        return len(self._ids)

    @property
    def residual_count(self) -> int:
        return len(self._residual)

    @property
    def salt(self) -> int:
        return self.shapes.salt

    @property
    def version(self) -> int:
        return self.shapes.version + self.nfa.version
