"""The serving step: topics -> matched filters -> subscriber slots, on one
device. The port's counterpart of `emqx_tpu/models/router_model.py`,
restricted to the shape-index path (with the residual-NFA lane) and dense
subscriber bitmaps.

One routed batch runs these hand-written CUDA kernels, in order:

  tokenize (ops/tokenizer.py)  ->  shape_match (ops/shape_index.py)
  [->  vocab_lookup (ops/tokenizer.py)  ->  nfa_walk (ops/matcher.py),
       when the table holds residual filters]
  ->  fanout_bitmaps  ->  compact_fanout_slots   (this module)

then `DeviceRouter._readback` brings the trimmed outputs to the host in
one copy. Subscriber state is the dense bitmap matrix
``sub_bitmaps [Fcap, W]`` (uint32 bits in an int32 tensor): row = filter
id, bit = subscriber slot. Each kernel has its plain PyTorch twin in the
same module; a wrapper runs the twin only for CPU tensors. The device
copies of the shape index, the NFA and the bitmaps are kept current by
three `ops.segments.DeviceSegmentManager` mirrors (O(delta) scatters).

Not in this slice, and refused rather than routed elsewhere: the sparse
CSR subscriber table (`SubscriberTable.set_mode` raises), `$share` picks,
the semantic and rule stages, retained and session fusion, and the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.convert import resolve_device
from emqx_tpu_torch.ops.matcher import MatcherConfig, batch_match_syms
from emqx_tpu_torch.ops.nfa import MAX_PROBES, _next_pow2
from emqx_tpu_torch.ops.segments import DeviceSegmentManager
from emqx_tpu_torch.ops.shape_index import shape_match
from emqx_tpu_torch.ops.tokenizer import encode_topics, tokenize, vocab_lookup
from emqx_tpu_torch.ops.u32 import u32


# -- kernel 3: fan-out OR + popcount ---------------------------------------


def fanout_bitmaps_plain(sub_bitmaps, matched):
    """Plain PyTorch twin of the `fanout_bitmaps` kernel (any device)."""
    B, K = matched.shape
    W = sub_bitmaps.shape[1]
    out = torch.zeros((B, W), dtype=torch.int32, device=matched.device)
    for k in range(K):
        f = matched[:, k].to(torch.int64)
        rows = sub_bitmaps[f.clamp(min=0)]
        out |= torch.where((f >= 0)[:, None], rows, torch.zeros_like(rows))
    x = u32(out)
    bits = (x[:, :, None] >> torch.arange(32, device=x.device)) & 1
    return out, bits.sum(dim=(1, 2)).to(torch.int32)


def fanout_bitmaps(sub_bitmaps, matched):
    """OR the bitmap rows of each topic's matched filters (kernel 3).

    sub_bitmaps int32 [Fcap, W] (uint32 bits); matched int32 [B, K] fids
    (-1 holes skipped; every fid must be < Fcap) -> (bitmaps int32 [B, W],
    popcount int32 [B]). The counterpart of `fanout_bitmaps` and
    `popcount32` (emqx_tpu/models/router_model.py:52, :44).
    """
    kernels.check_tensor(sub_bitmaps, "sub_bitmaps", torch.int32, 2)
    kernels.check_tensor(matched, "matched", torch.int32, 2)
    if not kernels.on_cuda(sub_bitmaps, matched):
        return fanout_bitmaps_plain(sub_bitmaps, matched)
    B, K = matched.shape
    fcap, W = sub_bitmaps.shape
    out = torch.empty((B, W), dtype=torch.int32, device=matched.device)
    popcount = torch.zeros(B, dtype=torch.int32, device=matched.device)
    kernels.launch(
        "fanout_bitmaps",
        "emqx_fanout_bitmaps",
        matched.device,
        sub_bitmaps.data_ptr(),
        fcap,
        matched.data_ptr(),
        out.data_ptr(),
        popcount.data_ptr(),
        B,
        K,
        W,
    )
    return out, popcount


# -- kernel 4: slot compaction ---------------------------------------------


def compact_fanout_slots_plain(bitmaps, kslot: int):
    """Plain PyTorch twin of the `compact_fanout_slots` kernel (any device).

    Expands every bit, left-packs the set ones with a cumsum and a scatter
    into [B, kslot + 1] (the last column is the discard bucket JAX's
    `mode="drop"` stands for), and slices the bucket off."""
    B, W = bitmaps.shape
    dev = bitmaps.device
    x = u32(bitmaps)
    bits = ((x[:, :, None] >> torch.arange(32, device=dev)) & 1).reshape(B, W * 32)
    count = bits.sum(dim=1)
    pos = torch.cumsum(bits, dim=1) - 1
    idx = torch.where((bits == 1) & (pos < kslot), pos, torch.full_like(pos, kslot))
    slot_ids = torch.arange(W * 32, dtype=torch.int32, device=dev).expand(B, -1)
    out = torch.full((B, kslot + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, idx, slot_ids)
    return out[:, :kslot].contiguous(), count.to(torch.int32), count > kslot


def compact_fanout_slots(bitmaps, kslot: int):
    """Set bits -> ascending slot-id lists (kernel 4).

    bitmaps int32 [B, W] (uint32 bits) -> (slots int32 [B, kslot], -1
    padded; count int32 [B], the UNCAPPED number of set bits; overflow
    bool [B] = count > kslot, whose dense rows the host fetches instead).
    The counterpart of `compact_fanout_slots`
    (emqx_tpu/models/router_model.py:77).
    """
    kernels.check_tensor(bitmaps, "bitmaps", torch.int32, 2)
    if kslot < 1:
        raise ValueError(f"kslot must be >= 1, got {kslot}")
    if not kernels.on_cuda(bitmaps):
        return compact_fanout_slots_plain(bitmaps, kslot)
    B, W = bitmaps.shape
    dev = bitmaps.device
    slots = torch.empty((B, kslot), dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    kernels.launch(
        "compact_fanout_slots",
        "emqx_compact_fanout_slots",
        dev,
        bitmaps.data_ptr(),
        slots.data_ptr(),
        count.data_ptr(),
        overflow.data_ptr(),
        B,
        W,
        kslot,
    )
    return slots, count, overflow


# -- the composite ---------------------------------------------------------


def shape_route_step(
    tables: Dict[str, torch.Tensor],
    bytes_mat,
    lengths,
    *,
    m_active: int,
    salt: int,
    nfa_tables: Optional[Dict[str, torch.Tensor]] = None,
    with_nfa: bool = False,
    max_levels: int = 16,
    frontier: int = 32,
    max_matches: int = 64,
    probes: int = MAX_PROBES,
    kslot: int = 0,
    device="cuda",
):
    """The serving step: tokenize -> shape match (-> residual NFA) ->
    fan-out (-> compact).

    The counterpart of `shape_route_step_impl`
    (emqx_tpu/models/router_model.py:225) with dense ``sub_bitmaps`` and no
    groups, semantic or rule stage. `tables` holds the shape tables and
    ``sub_bitmaps`` on `device` (`convert.tables_to_device`, or the
    `DeviceRouter` mirrors); bytes_mat uint8 [B, MB] and lengths int32 [B]
    (numpy or tensors) as `encode_topics` makes them. ``with_nfa`` runs
    the residual lane over `nfa_tables` (`NfaBuilder.device_snapshot()`
    uploaded): the topics' word hashes become symbols (`vocab_lookup`) and
    walk the NFA (`batch_match_syms`), whose K = `max_matches` columns join
    the shape lane's M and whose flags join the row flags.

    Returns {matched [B, M (+ K)] (sparse, -1 holes), mcount [B], flags [B]
    (too deep or NFA overflow: the host must route the row), bitmaps
    [B, W], stats {routed, matches, fanout_bits}} and, with ``kslot > 0``,
    slots [B, kslot], slot_count [B] and overflow [B].
    """
    dev = resolve_device(device)
    if with_nfa and nfa_tables is None:
        raise ValueError("with_nfa needs nfa_tables")
    for k, t in list(tables.items()) + list((nfa_tables or {}).items()):
        if t.device != dev:
            raise ValueError(f"table {k} lies on {t.device}, not {dev}")
    bytes_mat = torch.as_tensor(bytes_mat, dtype=torch.uint8, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    h1, h2, nwords, dollar = tokenize(bytes_mat, lengths, salt, max_levels)
    matched = shape_match(tables, m_active, h1, h2, nwords, dollar)
    flags = nwords > max_levels
    if with_nfa:
        syms = vocab_lookup(nfa_tables, h1, h2, probes)
        m2, _c2, f2, _causes2 = batch_match_syms(
            nfa_tables, syms, nwords, dollar, frontier=frontier,
            max_matches=max_matches, probes=probes,
        )
        matched = torch.cat([matched, m2], dim=1)
        flags = flags | f2
    mcount = (matched >= 0).sum(dim=1, dtype=torch.int32)
    bitmaps, popcount = fanout_bitmaps(tables["sub_bitmaps"], matched)
    out = {
        "matched": matched,
        "mcount": mcount,
        "flags": flags,
        "bitmaps": bitmaps,
        "stats": {
            "routed": (mcount > 0).sum(),
            "matches": mcount.sum(),
            "fanout_bits": popcount.sum(),
        },
    }
    if kslot > 0:
        out["slots"], out["slot_count"], out["overflow"] = compact_fanout_slots(
            bitmaps, kslot
        )
    return out


# -- host-side subscriber registry (dense) ---------------------------------


def _popcount_u32(arr: np.ndarray) -> int:
    total = 0
    flat = arr.reshape(-1).view(np.uint8)
    step = 1 << 22
    for lo in range(0, len(flat), step):
        total += int(np.unpackbits(flat[lo : lo + step]).sum())
    return total


class SubscriberTable:
    """Host-side registry: (filter id, subscriber slot) -> fan-out bits, as a
    dense ``sub_bitmaps [Fcap, W]`` uint32 matrix. The port's copy of the
    dense mode of `SubscriberTable` (emqx_tpu/models/router_model.py:998).

    Every scalar write is op-logged (flat index) and growth bumps `epoch`,
    as in the JAX package, so the router's `DeviceSegmentManager` mirror
    replays churn as O(delta) scatters and re-uploads only on growth.
    """

    OPLOG_MAX = 65536

    def __init__(self, max_subscribers: int = 1024, mode: str = "dense"):
        self.width_words = max(2, _next_pow2((max_subscribers + 31) // 32))
        self._fcap = 64
        self.arr = np.zeros((self._fcap, self.width_words), dtype=np.uint32)
        self.epoch = 0
        self.oplog: list = []  # (name, flat_idx, value)
        self.version = 0
        self.live = 0  # live subscriptions
        self.set_mode(mode)

    def set_mode(self, mode: str) -> None:
        if mode not in ("auto", "dense", "sparse"):
            raise ValueError(f"sub_table mode {mode!r}")
        if mode != "dense":
            raise NotImplementedError(
                f"sub_table mode {mode!r}: the sparse CSR subscriber table "
                "(ops/csr_table.py sparse_fanout_slots) is a later slice of "
                "the port (ROADMAP.md, Queue 1)"
            )

    def _bump_epoch(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _log(self, fid: int, w: int, val: int) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        self.oplog.append(("sub_bitmaps", fid * self.width_words + w, int(val)))

    def _ensure(self, fid: int, slot: int) -> None:
        need_w = _next_pow2(slot // 32 + 1)
        need_f = _next_pow2(fid + 1)
        if need_w > self.width_words or need_f > self._fcap:
            nw = max(self.width_words, need_w)
            nf = max(self._fcap, need_f)
            new = np.zeros((nf, nw), dtype=np.uint32)
            new[: self._fcap, : self.width_words] = self.arr
            self.arr = new
            self.width_words = nw
            self._fcap = nf
            self._bump_epoch()

    def add(self, filter_id: int, slot: int) -> None:
        self._ensure(filter_id, slot)
        w = slot // 32
        bit = np.uint32(1 << (slot % 32))
        if not self.arr[filter_id, w] & bit:
            self.live += 1
        self.arr[filter_id, w] |= bit
        self._log(filter_id, w, int(self.arr[filter_id, w]))

    def bulk_add(self, fids, slots) -> None:
        """Vectorized (fid, slot) load for cold starts; one epoch bump."""
        fids = np.asarray(fids, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        if not len(fids):
            return
        self._ensure(int(fids.max()), int(slots.max()))
        w = slots // 32
        bits = (np.uint32(1) << (slots % 32).astype(np.uint32)).astype(np.uint32)
        np.bitwise_or.at(self.arr, (fids, w), bits)
        self.live = _popcount_u32(self.arr)
        self._bump_epoch()

    def remove(self, filter_id: int, slot: int) -> None:
        if filter_id >= self._fcap or slot // 32 >= self.width_words:
            return
        w = slot // 32
        bit = np.uint32(1 << (slot % 32))
        if self.arr[filter_id, w] & bit:
            self.live -= 1
        self.arr[filter_id, w] &= np.uint32(~bit & 0xFFFFFFFF)
        self._log(filter_id, w, int(self.arr[filter_id, w]))

    def pack(self, filter_capacity: int) -> np.ndarray:
        """Grow to cover `filter_capacity` filter rows; returns the live
        matrix (a view — valid until the next mutation)."""
        if filter_capacity > self._fcap:
            self._ensure(filter_capacity - 1, 0)
        return self.arr

    def device_snapshot(self):
        return {"sub_bitmaps": self.arr}



class RouteResult(NamedTuple):
    """Host-side outputs of one routed batch (all numpy, device-free).

    Exactly ONE of the fan-out encodings is populated per row:

    - compact path (``slots is not None`` and not ``overflow[i]``):
      ``slots[i]`` holds the row's subscriber slot ids, ascending, -1 pad;
    - dense path: ``bitmaps[i]`` (compaction off) or
      ``dense_rows[dense_index[i]]`` (compaction on, row overflowed the
      kslot cap — the masked second copy of the fallback contract).

    ``readback_bytes`` is the device->host transfer this batch paid.
    """

    matched: np.ndarray  # [B, M (+ K)] sparse fids, -1 holes
    mcount: np.ndarray  # [B]
    flags: np.ndarray  # [B] host-must-fallback rows
    bitmaps: Optional[np.ndarray]  # [B, W] uint32 (None on compact path)
    slots: Optional[np.ndarray] = None  # [B, kslot] int32, -1 pad
    slot_count: Optional[np.ndarray] = None  # [B] total set bits (uncapped)
    overflow: Optional[np.ndarray] = None  # [B] bool: fanout > kslot
    dense_rows: Optional[np.ndarray] = None  # [n_overflow, W] uint32
    dense_index: Optional[Dict[int, int]] = None  # batch row -> dense_rows row
    readback_bytes: int = 0


# floor for the auto-sized compact-slot cap: below this the slot list is
# cheaper than the bookkeeping either way, and a tiny cap would overflow
# constantly while the fanout histogram warms up
KSLOT_MIN = 64


class Prepared(NamedTuple):
    """Immutable device state of one `DeviceRouter.prepare()`: the tensors
    hold one generation of the mirrors, which a later sync never writes."""

    tables: Dict[str, torch.Tensor]  # shape tables + "sub_bitmaps"
    nfa_tables: Optional[Dict[str, torch.Tensor]]  # None: no residual filters
    salt: int
    m_active: int
    kslot: int


class DeviceRouter:
    """Serving-path engine on one device: owns the device mirrors of the
    shape index, the residual NFA and the subscriber bitmaps and runs
    `shape_route_step` over host batches. The counterpart of `DeviceRouter`
    (emqx_tpu/models/router_model.py:1413), single device, dense.

    Each host table is mirrored by its own `DeviceSegmentManager`
    (`_shape_sync`, `_nfa_sync`, `_bits_sync`): a full upload on an epoch
    change, otherwise one `segment_scatter` launch over the op-log suffix.
    A prepare whose tables are all clean (`_version_key()` unchanged)
    touches no mirror at all. The residual lane runs exactly when the
    index holds residual filters.
    """

    # clean-table prepares re-check the auto-sized kslot only every this
    # many batches: the fanout histogram drifts slowly
    KSLOT_RECHECK = 64

    def __init__(self, index, subtab: SubscriberTable, config=None,
                 metrics=None, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.subtab = subtab
        # duck-typed: metrics.histogram(name) -> object with count, p99
        self.metrics = metrics
        config = config or MatcherConfig()
        if config.probes < MAX_PROBES:
            # the probe loops must cover the host placement bound, or
            # entries at the end of a probe window become invisible
            config = dataclasses.replace(config, probes=MAX_PROBES)
        self.config = config
        self._shape_sync = DeviceSegmentManager(self.device, name="shapes")
        self._nfa_sync = DeviceSegmentManager(self.device, name="nfa")
        self._bits_sync = DeviceSegmentManager(self.device, name="bitmaps")
        self._kslot = 0  # auto-sized compact-slot cap (grow-only)
        # O(dirty) prepare: (version key, args) of the last clean sync
        self._prep_key = None
        self._prep_args = None
        self._clean_streak = 0

    def _fanout_kslot(self, width_words: int) -> int:
        """kslot for the next batch; 0 = compaction off.

        Sized from the `dispatch.fanout` histogram p99 with 2x headroom,
        pow2-padded and GROW-ONLY; KSLOT_MIN when no metrics object is
        given. Compaction is off while the slot universe (W*32) is no
        wider than the compact output would be."""
        want = KSLOT_MIN
        if self.metrics is not None:
            h = self.metrics.histogram("dispatch.fanout")
            # 256 observations before trusting p99
            if h is not None and h.count >= 256:
                want = max(want, 2 * max(1, int(h.p99)))
        k = max(self._kslot, _next_pow2(want))
        self._kslot = k
        if k >= width_words * 32:
            return 0  # dense rows are already the smaller readback
        return k

    def _version_key(self):
        """Generation counters of every host table the mirrors are built
        from — equal keys mean the device copies are current."""
        return (self.index.version, self.subtab.version)

    def _device_args(self) -> Prepared:
        # grow the bitmap matrix to cover every live filter id BEFORE the
        # version key: the growth bumps the subtab's epoch and version, and
        # a bump inside the sync would read as a torn snapshot
        self.subtab.pack(self.index.num_filters_capacity)
        key = self._version_key()
        if self._prep_key == key:
            self._clean_streak += 1
            if self._clean_streak % self.KSLOT_RECHECK == 0:
                kslot = self._fanout_kslot(self.subtab.width_words)
                if kslot != self._prep_args.kslot:
                    self._prep_args = self._prep_args._replace(kslot=kslot)
            return self._prep_args
        self._clean_streak = 0
        idx = self.index
        bits = self._bits_sync.sync(self.subtab)["sub_bitmaps"]
        tables = self._shape_sync.sync(idx.shapes)
        tables["sub_bitmaps"] = bits
        nfa_tables = self._nfa_sync.sync(idx.nfa) if idx.residual_count > 0 else None
        args = Prepared(
            tables,
            nfa_tables,
            idx.salt,
            idx.shapes.m_active(),
            self._fanout_kslot(self.subtab.width_words),
        )
        if self._version_key() == key:
            # a sync that raced a mutation is used once, never cached
            self._prep_key = key
            self._prep_args = args
        return args

    def prepare(self) -> Prepared:
        """Sync the device mirrors with the current tables. MUST run on the
        thread that mutates the index/subtab. The returned tuple is
        immutable device state for `route_prepared`."""
        return self._device_args()

    def segment_status(self) -> Dict[str, Dict[str, int]]:
        """Per mirror (`shapes`, `nfa`, `bitmaps`): full_resyncs,
        delta_launches and array_resyncs since the router was made."""
        return {
            m.name: m.counters()
            for m in (self._shape_sync, self._nfa_sync, self._bits_sync)
        }

    def route(self, topics) -> RouteResult:
        """Batch route: returns a host-side `RouteResult` (all numpy)."""
        return self.route_prepared(self._device_args(), topics)

    def route_prepared(self, args: Prepared, topics) -> RouteResult:
        """Kernel launches + readback against a `prepare()` snapshot.

        Unlike the JAX router, the batch is not padded to a power of two:
        there is no compiled program whose shape it would have to match."""
        cfg = self.config
        mat, lens, too_long = encode_topics(list(topics), cfg.max_bytes)
        out = shape_route_step(
            args.tables,
            torch.from_numpy(mat).to(self.device),
            torch.from_numpy(lens).to(self.device),
            m_active=args.m_active,
            salt=args.salt,
            nfa_tables=args.nfa_tables,
            with_nfa=args.nfa_tables is not None,
            max_levels=cfg.max_levels,
            frontier=cfg.frontier,
            max_matches=cfg.max_matches,
            probes=cfg.probes,
            kslot=args.kslot,
            device=self.device,
        )
        return self._readback(out, len(topics), too_long, args.kslot)

    def _readback(self, out, B: int, too_long, kslot: int) -> RouteResult:
        """Pull one batch's outputs to the host -> `RouteResult`.

        Every output the batch needs crosses in ONE device->host copy of a
        packed int32 buffer. Only the overflow rows' dense bitmaps are a
        second (masked) copy, because which rows need it is decided by
        `slot_count`, which must be on the host first."""
        M = out["matched"].shape[1]
        parts = [
            out["matched"].reshape(-1),
            out["mcount"],
            out["flags"].to(torch.int32),
        ]
        if kslot:
            parts += [out["slots"].reshape(-1), out["slot_count"]]
        else:
            parts.append(out["bitmaps"].reshape(-1))
        host = torch.cat(parts).cpu().numpy()
        readback = host.nbytes
        o = 0

        def take(n):
            nonlocal o
            o += n
            return host[o - n : o]

        matched = take(B * M).reshape(B, M)
        mcount = take(B)
        flags = take(B).astype(bool) | too_long
        if not kslot:
            W = out["bitmaps"].shape[1]
            bitmaps = take(B * W).reshape(B, W).view(np.uint32)
            return RouteResult(matched, mcount, flags, bitmaps,
                               readback_bytes=readback)
        slots = take(B * kslot).reshape(B, kslot)
        slot_count = take(B)
        overflow = slot_count > kslot
        dense_rows = dense_index = None
        ovf_idx = np.nonzero(overflow)[0]
        if ovf_idx.size:
            dense_index = {int(r): j for j, r in enumerate(ovf_idx)}
            sel = torch.from_numpy(ovf_idx).to(out["bitmaps"].device)
            dense_rows = out["bitmaps"][sel].cpu().numpy().view(np.uint32)
            readback += dense_rows.nbytes
        return RouteResult(
            matched, mcount, flags, None,
            slots=slots, slot_count=slot_count, overflow=overflow,
            dense_rows=dense_rows, dense_index=dense_index,
            readback_bytes=readback,
        )
