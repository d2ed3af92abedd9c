"""Device mirrors of the host tables: the port's copy of
`emqx_tpu/ops/segments.py` (`RESYNC`, `segment_scatter_impl`,
`DeviceSegmentManager` with the rider handoff `peek_delta`/`adopt` and the
compaction handoff `offer`, `compact_pool`, `SegmentCompactor`,
`ShapeSegmentOwner`, `BitmapGrowthOwner`, `SegmentStateSnapshot`).

Every host table the serving step reads (the shape index, the residual
NFA, the subscriber bitmaps, the group table, the retained topic chunks,
the session lanes, the semantic table)
keeps its arrays as numpy, mutates them in place, and op-logs each scalar
write as ``(array_name, flat_index, value)``; a structural event (growth,
rehash, salt change, a full op-log) bumps its `epoch` and clears the log.
`DeviceSegmentManager.sync(src)` keeps one torch tensor per array equal to
``src.device_snapshot()``:

- a full upload (`convert.upload`) when the epoch moved;
- otherwise the op-log suffix since the last sync, replayed by ONE
  `segment_scatter` call over every touched array (kernel
  `kernels/csrc/segment_scatter.cu`), which keeps the last write per slot
  on the card;
- a ``(RESYNC, name, 0)`` marker re-uploads only that array from the live
  host table (which already holds every logged write to it).

Op-log protocol (sources: `NfaBuilder`, `ShapeIndex`, `SubscriberTable`,
`GroupTable`, `DeviceRetainedIndex`, `SessionTable`, `SemanticTable`):
`epoch` int, `version` int (total mutation counter), `oplog` list and
`device_snapshot() -> {name: np.ndarray}`.

Background compaction (`SegmentCompactor`): an owner merges a table's hot
segment and tombstones into a fresh packed table off the serving path —
`begin` captures arrays on the loop thread and starts a journal, `build`
merges the capture in numpy on the one-worker `compact_pool` thread and
uploads the packed arrays there (`upload_offer`: a side stream, waited
for on that thread), `apply` swaps the build in on the loop and replays
the journal, and the manager is `offer`ed the uploaded tensors, which the
next `prepare()` adopts instead of uploading them. The owners: shapes
(`ShapeSegmentOwner`), the dense bitmaps' growth (`BitmapGrowthOwner`),
CSR tables (`ops.csr_table.CsrSegmentOwner`), semantic tables
(`ops.semantic_table.SemanticSegmentOwner`) and session tables
(`ops.session_table.SessionSegmentOwner`).

`SegmentStateSnapshot` pickles host tables (numpy and registries, never a
tensor) to a sidecar file and installs them back: the broker's capture
and install callables are its owner's (the reference app's closures).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.convert import bf16_bits, resolve_device, upload

RESYNC = "!resync"  # op-log marker: (RESYNC, array_name, 0)


# -- kernel 7: the O(delta) scatter ----------------------------------------


def _value_bits(val, dtype: torch.dtype) -> np.ndarray:
    """Op-logged values -> int32 array of the bits an element of `dtype`
    stores: a float32 array takes ``np.float32(value)``'s 32 bits, a
    bfloat16 array the value rounded to nearest even from float32 (as
    ``np.array(values, dtype=bfloat16)`` rounds it in the JAX manager) in
    the low 16 bits, an int32 or uint8 array the int32 bits of an int32 or
    uint32 value."""
    if dtype == torch.float32:
        return np.asarray(val, np.float64).astype(np.float32).view(np.int32)
    if dtype == torch.bfloat16:
        return bf16_bits(np.asarray(val, np.float64).astype(np.float32)).astype(np.int32)
    return np.asarray(val, dtype=np.int64).astype(np.uint32).view(np.int32)


def _last_writes(idx, val, dtype: torch.dtype = torch.int32):
    """Ascending flat indices and the bits of their values
    (`_value_bits`), one entry per slot: the last write in program order
    wins."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    val = _value_bits(val, dtype).reshape(-1)
    if idx.shape != val.shape:
        raise ValueError(f"{idx.shape[0]} indices but {val.shape[0]} values")
    uniq, last = np.unique(idx[::-1], return_index=True)
    return uniq, val[::-1][last]


def _apply_plain(flats, writes):
    out = {}
    for k, flat in flats.items():
        ix, bits = writes[k]
        new = flat.clone()
        ix = torch.from_numpy(ix).to(flat.device)
        if flat.dtype == torch.float32:
            new.view(torch.int32).view(-1)[ix] = torch.from_numpy(bits).to(flat.device)
        elif flat.dtype == torch.bfloat16:
            new.view(torch.int16).view(-1)[ix] = torch.from_numpy(
                bits.astype(np.int16)).to(flat.device)
        else:
            new.view(-1)[ix] = torch.from_numpy(bits).to(device=flat.device,
                                                         dtype=flat.dtype)
        out[k] = new
    return out


def segment_scatter_plain(flats, idxs, vals):
    """Plain PyTorch twin of the `segment_scatter` kernel (any device):
    `out[k] = flats[k].clone()` with ``out[k].view(-1)[idx] = val``, the
    values converted to the array's type (`_value_bits`; a uint8 array
    takes their low byte)."""
    return _apply_plain(flats, {k: _last_writes(idxs[k], vals[k], flats[k].dtype)
                                for k in flats})


# element width in bytes of each array type the kernel writes
_WIDTHS = {torch.int32: 4, torch.uint8: 1, torch.float32: 4, torch.bfloat16: 2}
# kernel launches of one scatter call that has entries: the claim pass,
# then the store pass
SCATTER_LAUNCHES = 2
# the most entries one call takes: the kernel's positions and hash slots
# are 32-bit
SCATTER_MAX_ENTRIES = 1 << 30


def pack_entries(flats, idxs, vals):
    """The scatter's entries in program order, as the kernel reads them:
    array by array (in `flats`' order), each array's flat indices and the
    bits of its values (`_value_bits`), with NO reduction to the last
    write per slot. -> ``(names, offsets int64 [A + 1], idx int64 [n],
    bits int32 [n])``: the entries of array ``names[a]`` are
    ``offsets[a]:offsets[a + 1]``. Raises TypeError for an array type the
    kernel does not write, ValueError for a non-contiguous array or
    unequal index and value counts, IndexError for an index outside its
    array."""
    names = list(flats)
    ix_parts, bit_parts = [], []
    for k in names:
        flat = flats[k]
        if not isinstance(flat, torch.Tensor) or flat.dtype not in _WIDTHS:
            raise TypeError(f"{k}: expected an int32, uint8, float32 or bfloat16 tensor")
        if not flat.is_contiguous():
            raise ValueError(f"{k}: must be contiguous")
        ix = np.asarray(idxs[k], dtype=np.int64).reshape(-1)
        bits = _value_bits(vals[k], flat.dtype).reshape(-1)
        if ix.shape != bits.shape:
            raise ValueError(f"{k}: {ix.shape[0]} indices but {bits.shape[0]} values")
        if len(ix) and (ix.min() < 0 or ix.max() >= flat.numel()):
            raise IndexError(f"{k}: index outside [0, {flat.numel()})")
        ix_parts.append(ix)
        bit_parts.append(bits)
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(ix) for ix in ix_parts])
    idx = np.concatenate(ix_parts) if ix_parts else np.zeros(0, np.int64)
    bits = np.concatenate(bit_parts) if bit_parts else np.zeros(0, np.int32)
    return names, offsets, idx, bits


def last_write_mask_plain(offsets, idx) -> torch.Tensor:
    """Plain twin of the kernel's deduplication, which the tests hold
    against `_last_writes`: True for each entry that is the last one in
    program order to write its (array, flat index) slot (the claim pass's
    `atomicMax` of positions, then the store pass's test)."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    counts = torch.as_tensor(np.diff(np.asarray(offsets, np.int64)))
    arr = torch.repeat_interleave(torch.arange(len(counts)), counts)
    _, inv = torch.unique(arr * (1 << 40) + idx, return_inverse=True)
    pos = torch.arange(len(idx))
    last = torch.full((int(inv.max()) + 1 if len(idx) else 0,), -1, dtype=torch.int64)
    last.scatter_reduce_(0, inv, pos, "amax")
    return last[inv] == pos


def segment_scatter(
    flats: Mapping[str, torch.Tensor],
    idxs: Mapping[str, Sequence[int]],
    vals: Mapping[str, Sequence[int]],
) -> Dict[str, torch.Tensor]:
    """The O(delta) update (kernel `segment_scatter`): for every array k,
    a FRESH tensor equal to flats[k] with ``flat[idxs[k]] = vals[k]``, every
    array in one call. The counterpart of `segment_scatter_impl`
    (emqx_tpu/ops/segments.py:73).

    flats: contiguous int32 tensors (uint32 tables hold their bits), uint8
    tensors (byte tables), float32 or bfloat16 tensors (the semantic
    table's lanes and vectors) of any shape, all on one device; idxs/vals:
    host arrays or lists of flat indices and values in program order; a
    float value travels as its bits (`_value_bits`). A repeated index
    keeps its last value. The host only converts and concatenates the
    entries (`pack_entries`) into one pinned buffer and copies it once,
    without waiting; on the card the claim pass keeps, per slot, the
    latest program-order position in a hash table and the store pass
    writes that entry alone (`SCATTER_LAUNCHES` launches), so no host
    sort runs and no two threads store to one element. On the CPU the
    twin `segment_scatter_plain` runs, after the same checks. The inputs
    are never written: a snapshot a caller still holds stays as it was.
    """
    names, offsets, idx, bits = pack_entries(flats, idxs, vals)
    n = len(idx)
    if not names or not kernels.on_cuda(*(flats[k] for k in names)):
        return segment_scatter_plain(flats, idxs, vals)
    if n > SCATTER_MAX_ENTRIES:
        raise ValueError(f"{n} entries: one scatter takes at most {SCATTER_MAX_ENTRIES}")
    dev = flats[names[0]].device
    out = {k: flats[k].clone() for k in names}
    if n == 0:
        return out
    host = pinned_entries([out[k] for k in names], offsets, idx, bits)
    launch_scatter(host.to(dev, non_blocking=True), len(names), n)
    return out


def pinned_entries(outs, offsets, idx, bits) -> torch.Tensor:
    """The kernel's one int64 buffer in pinned host memory: [A base
    pointers | A element widths | A + 1 offsets | n indices | n int32
    value bits, two a word]. The caching host allocator keeps the block
    until the copy that reads it has run, so a `non_blocking` copy needs
    no wait here."""
    A, n = len(outs), len(idx)
    head = 3 * A + 1
    host = torch.empty(head + n + (n + 1) // 2, dtype=torch.int64, pin_memory=True)
    hb = host.numpy()
    hb[:A] = [t.data_ptr() for t in outs]
    hb[A : 2 * A] = [_WIDTHS[t.dtype] for t in outs]
    hb[2 * A : head] = offsets
    hb[head : head + n] = idx
    hb[head + n :].view(np.int32)[:n] = bits
    return host


def launch_scatter(dbuf: torch.Tensor, A: int, n: int) -> None:
    """The claim and store launches over the device copy of
    `pinned_entries`, with a hash table of 2 next_pow2(n) slots: keys (8
    B) and positions (4 B), zeroed by the claim launch, then each entry's
    slot (4 B)."""
    cap = 2 << max(0, (n - 1).bit_length())
    table = torch.empty(cap + cap // 2 + (n + 1) // 2, dtype=torch.int64, device=dbuf.device)
    for launcher in ("emqx_scatter_claim", "emqx_scatter_store"):
        kernels.launch("segment_scatter", launcher, dbuf.device,
                       dbuf.data_ptr(), A, n, table.data_ptr(), cap)


# -- the mirror ------------------------------------------------------------


class DeviceSegmentManager:
    """Device-resident mirror of one incrementally mutated host source.

    `sync(src)` returns ``{name: tensor}`` equal to ``src.device_snapshot()``
    (`convert.upload`'s types: int32 tensors, uint32 arrays keeping their
    bits, uint8 tensors for byte arrays, float32 and bfloat16 tensors for
    the semantic table's lanes and vectors). All internal state
    changes under `_lock`, and callers receive a fresh shallow-copied dict,
    so a snapshot held across a later sync never tears.

    Generations: a full resync or a scatter makes new tensors and never
    writes the old ones, so a `prepare()` tuple a caller still holds keeps
    its generation alive by reference count and frees it when dropped. The
    JAX manager's `free_retired` grace (an explicit `.delete()` one epoch
    later) has no counterpart here. `peek_delta`/`adopt` hand the op-log
    suffix to the session rider (`broker/session_store.py`), which fuses
    the scatter into a routed batch; `offer` hands the next full resync
    the tensors a background compaction already uploaded
    (`SegmentCompactor`).

    `placement` (a `convert.Replicated` or `convert.Block`, the counterpart
    of the JAX manager's placement hook, emqx_tpu/ops/segments.py:106-135)
    makes the mirror one mesh rank's part of each array: a full upload or
    an array resync places this rank's slice, and an op-log suffix is
    filtered to the writes this rank owns, rebased to its local flat
    indices. Every rank takes the same full / delta / array decisions as a
    single-device mirror of the same op-log; a rank that owns none of a
    delta's writes launches nothing for it (`delta_skipped`).

    Counters: `full_resyncs` (epoch changes and torn syncs), `delta_launches`
    (scatter launches), `array_resyncs` (single arrays re-uploaded) and, for
    a placed mirror, `delta_skipped` (deltas of which this rank owned no
    write).
    """

    def __init__(self, device="cuda", name: str = "", placement=None) -> None:
        self.device = resolve_device(device)
        self.name = name
        self.placement = placement
        self._lock = threading.Lock()
        self._arrays = None  # guarded-by: _lock
        self._shapes: Dict[str, tuple] = {}  # guarded-by: _lock (host shapes)
        self._epoch = -1  # guarded-by: _lock
        self._pos = 0  # guarded-by: _lock
        self._torn = False  # guarded-by: _lock
        self._offer: Optional[Tuple] = None  # guarded-by: _lock
        self.full_resyncs = 0  # guarded-by: _lock
        self.delta_launches = 0  # guarded-by: _lock
        self.delta_skipped = 0  # guarded-by: _lock
        self.array_resyncs = 0  # guarded-by: _lock

    def counters(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "full_resyncs": self.full_resyncs,
                "delta_launches": self.delta_launches,
                "array_resyncs": self.array_resyncs,
            }
            if self.placement is not None:
                out["delta_skipped"] = self.delta_skipped
            return out

    def has_mirror(self) -> bool:
        with self._lock:
            return self._arrays is not None

    # -- background-compaction handoff -------------------------------------
    def offer(self, epoch: int, arrays: Mapping[str, torch.Tensor], pos: int = 0) -> None:
        """Tensors for the NEXT full resync, already on this mirror's
        device (this rank's part of each array on a placed mirror),
        tagged with the source epoch they represent at op-log position
        `pos`. Adopted only while the epoch still matches at sync time (a
        later structural event makes the offer stale and it is dropped);
        the op-log suffix past `pos` replays on top as usual. The
        counterpart of `offer` (emqx_tpu/ops/segments.py:143)."""
        with self._lock:
            self._offer = (epoch, dict(arrays), pos)

    # -- fused-launch rider handoff ----------------------------------------
    def peek_delta(self, src):
        """The current mirror and the op-log suffix as per-array
        last-write-wins dicts, WITHOUT applying anything: the caller fuses
        the scatter into a routed batch (`session_ack`) and hands the
        produced tensors back through `adopt`. Returns ``(arrays,
        {name: {index: value}}, pos, epoch)``, or None when there is no
        mirror, the epoch moved, the mirror is torn, or the suffix holds a
        `!resync` marker or an array the mirror lacks: those go through
        `sync()`; and so does every suffix of a placed (mesh) mirror. The
        counterpart of `peek_delta` (emqx_tpu/ops/segments.py:157)."""
        with self._lock:
            if self._arrays is None or self._epoch != src.epoch or self._torn \
                    or self.placement is not None:
                return None
            per: Dict[str, Dict[int, int]] = {}
            for name, idx, val in src.oplog[self._pos :]:
                if name == RESYNC or name not in self._arrays:
                    return None
                per.setdefault(name, {})[idx] = val
            return dict(self._arrays), per, len(src.oplog), self._epoch

    def adopt(self, arrays: Mapping[str, torch.Tensor], pos: int, epoch: int) -> bool:
        """Install rider-produced tensors as the mirror at op-log position
        `pos`. Refused (False) when the epoch moved, the mirror is torn or
        `pos` is behind it: the host arrays are authoritative, so the
        refused rider's writes are covered by the resync that superseded
        it. The counterpart of `adopt` (emqx_tpu/ops/segments.py:181)."""
        with self._lock:
            if (
                self._arrays is None
                or self._epoch != epoch
                or self._torn
                or pos < self._pos
            ):
                return False
            self._arrays = dict(arrays)
            self._pos = pos
            return True

    def sync(self, src) -> Dict[str, torch.Tensor]:
        with self._lock:
            v0 = src.version
            out = self._sync_locked(src)
            if src.version != v0:
                # torn read: the source moved during the sync. The result
                # is this call's to use, but it must never be cached as
                # clean: the next sync uploads in full.
                self._torn = True
            return out

    def _sync_locked(self, src):  # holds-lock: _lock
        if self._arrays is None or self._epoch != src.epoch or self._torn:
            self._torn = False
            return self._full_resync(src)
        return self._delta_sync(src)

    def _full_resync(self, src):  # holds-lock: _lock
        offer, self._offer = self._offer, None
        if offer is not None and offer[0] != src.epoch:
            offer = None  # stale: a later structural event superseded it
        offered = offer[1] if offer is not None else {}
        snap = src.device_snapshot()
        fresh = upload({k: v for k, v in snap.items() if k not in offered},
                       self.device, self.placement)
        for k, t in offered.items():
            if t.device != self.device:
                raise ValueError(f"offered {k} on {t.device}, the mirror is on {self.device}")
            if t.is_cuda:
                # uploaded on the compaction thread's side stream: the
                # allocator must not hand its block out again while this
                # stream's launches still read it
                t.record_stream(torch.cuda.current_stream(t.device))
        self._arrays = {k: offered[k] if k in offered else fresh[k] for k in snap}
        self._shapes = {k: v.shape for k, v in snap.items()}
        self._epoch = src.epoch
        self.full_resyncs += 1
        if offer is not None:
            # the adopted tensors represent op-log position `pos`: the
            # suffix (the compaction journal's replay) scatters on top
            self._pos = offer[2]
            return self._delta_sync(src)
        self._pos = len(src.oplog)
        return dict(self._arrays)

    def _put(self, name: str, arr: np.ndarray) -> torch.Tensor:
        self._shapes[name] = arr.shape
        return upload({name: arr}, self.device, self.placement)[name]

    def _owned(self, per):  # holds-lock: _lock
        """Per array, the writes this rank owns, at local flat indices."""
        if self.placement is None:
            return per
        out = {}
        for name, (ix, vv) in per.items():
            keep, local = self.placement.local_writes(
                name, self._shapes[name], np.asarray(ix, np.int64))
            if local.size:
                out[name] = (local, np.asarray(vv, dtype=object)[keep].tolist())
        return out

    def _delta_sync(self, src):  # holds-lock: _lock
        ops = src.oplog[self._pos :]
        if not ops:
            return dict(self._arrays)
        resync_names = {a for name, a, _v in ops if name == RESYNC}
        # per array, its writes in program order; `segment_scatter` keeps
        # the last write per slot
        per: Dict[str, Tuple[List[int], List[int]]] = {}
        for name, idx, val in ops:
            if name == RESYNC or name in resync_names:
                continue  # the live re-upload supersedes these writes
            ix, vv = per.setdefault(name, ([], []))
            ix.append(idx)
            vv.append(val)
        snap = None
        if resync_names:
            snap = src.device_snapshot()
            for name in resync_names:
                if name in snap:
                    self._arrays[name] = self._put(name, snap[name])
                else:
                    self._arrays.pop(name, None)
                self.array_resyncs += 1
        # arrays that appeared without a marker (a source growing its
        # snapshot dict) upload in full too
        for name in list(per):
            if name not in self._arrays:
                if snap is None:
                    snap = src.device_snapshot()
                self._arrays[name] = self._put(name, snap[name])
                self.array_resyncs += 1
                del per[name]
        if per:
            mine = self._owned(per)
            if mine:
                out = segment_scatter(
                    {k: self._arrays[k] for k in mine},
                    {k: w[0] for k, w in mine.items()},
                    {k: w[1] for k, w in mine.items()},
                )
                self.delta_launches += 1
                self._arrays.update(out)
            else:
                self.delta_skipped += 1
        self._pos = len(src.oplog)
        return dict(self._arrays)


# -- background compaction ---------------------------------------------------


# the pinned staging buffers of an offered upload (two of this size): a
# batch routed beside a pageable copy waits for it (on an NVIDIA H100 80GB
# HBM3 at 700 W: 194.7 ms beside one 671 MB copy, 116.4 beside it in 32 MiB
# pageable pieces, 13.7-27.3 beside the pinned pieces, 10.8-27.9 alone)
OFFER_CHUNK_BYTES = 32 << 20


def upload_offer(arrays: Mapping[str, np.ndarray], device, placement=None) -> Dict[str, torch.Tensor]:
    """A compaction build's packed arrays -> fresh tensors on `device`
    (this rank's part of each under `placement`), for
    `DeviceSegmentManager.offer`. Runs on the compaction thread: on a card
    the copies go on a side stream, staged through pinned buffers of
    OFFER_CHUNK_BYTES, and this thread waits for them, so the tensors are
    whole before the loop thread offers them; the adopting sync records
    its own stream on each (`_full_resync`). On the CPU a plain copy."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return upload(arrays, dev, placement)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        out = upload(arrays, dev, placement, chunk_bytes=OFFER_CHUNK_BYTES)
    side.synchronize()
    return out


def fresh_offer(bufs: Dict[str, torch.Tensor], epoch: int, epoch0: int) -> Dict[str, torch.Tensor]:
    """An owner's uploaded tensors if they still stand for `epoch`: they
    are the table as its `apply_compact` installed it, at the epoch that
    install bumped to (`epoch0` + 1) and op-log position 0. A journal
    replay that bumped the epoch again (an op-log overflow, a growth)
    cleared the log entries the offer would have replayed, so nothing is
    offered and the next sync uploads in full (the reference offers the
    stale tensors under the new epoch)."""
    return bufs if epoch == epoch0 + 1 else {}


_compact_pool = None
_compact_pool_lock = threading.Lock()


def compact_pool():
    """Process-wide single-worker executor for segment compaction builds.
    One worker: compaction is a throughput background chore, and two
    concurrent multi-GB table builds would double peak host memory."""
    global _compact_pool
    with _compact_pool_lock:
        if _compact_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _compact_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="segment-compact"
            )
        return _compact_pool


class SegmentCompactor:
    """Housekeeping-driven merge of hot segments into the packed tables.
    The port's copy of `SegmentCompactor` (emqx_tpu/ops/segments.py:355).

    The loop thread owns every host table; the `segment-compact` executor
    thread only ever touches the immutable capture and built artifacts
    and the upload (`upload_offer`). Per owner, one cycle is:

      loop:    cap   = owner.begin()          (array memcpys + journal on)
      thread:  built = owner.build(cap)       (numpy merge, then the upload)
      loop:    epoch = owner.apply(built)     (swap + journal replay)
      loop:    owner.manager.offer(epoch, tensors)

    so the next serving `prepare()` adopts the uploaded tensors and the
    subscribe path never pays an O(table) rebuild or upload. A cycle that
    raises is logged and counted in `aborted` (metric
    `router.compact.aborted`), as one whose capture a structural rebuild
    invalidated is.
    """

    def __init__(self, metrics=None, interval_s: float = 5.0):
        self.metrics = metrics
        self.interval_s = interval_s
        self._busy = False  # single-writer: loop
        self._last: Dict[str, float] = {}  # single-writer: loop
        self._need_since: Dict[str, float] = {}  # single-writer: loop
        self.runs = 0  # single-writer: loop
        self.aborted = 0  # single-writer: loop

    def lag_s(self, key: str, now: Optional[float] = None) -> float:
        t0 = self._need_since.get(key)
        if t0 is None:
            return 0.0
        return (time.monotonic() if now is None else now) - t0

    def tick(self, owners) -> bool:
        """One housekeeping tick (loop thread): update gauges, and start
        at most one background compaction cycle. Returns True when a
        cycle was started."""
        import asyncio

        now = time.monotonic()
        started = False
        for owner in owners:
            key = owner.key
            need = owner.needs_compact()
            if need and key not in self._need_since:
                self._need_since[key] = now
            elif not need:
                self._need_since.pop(key, None)
            if self.metrics is not None and key == "shapes":
                self.metrics.gauge_set(
                    "router.compact.lag.seconds", self.lag_s(key, now)
                )
            if started or self._busy or not need:
                continue
            if now - self._last.get(key, 0.0) < self.interval_s:
                continue
            self._busy = True
            started = True
            asyncio.ensure_future(self._run(owner))
        return started

    def _offer(self, owner, applied) -> None:
        """The loop half after a build that applied: offer the uploaded
        tensors and count the run."""
        epoch, bufs, pos, merged = applied
        owner.manager.offer(epoch, bufs, pos)
        self.runs += 1
        if self.metrics is not None:
            self.metrics.inc("router.compact.runs")
            self.metrics.inc("router.compact.merged", merged)
            if getattr(owner, "_placement", None) is not None:
                # the rebuilt table uploaded straight into this rank's
                # part of the mesh layout
                self.metrics.inc("mesh.shard.compact.runs")

    async def _run(self, owner) -> None:
        import asyncio

        t0 = time.perf_counter()
        key = owner.key
        try:
            cap = owner.begin()
            loop = asyncio.get_running_loop()
            built = await loop.run_in_executor(compact_pool(), owner.build, cap)
            # back on the loop: swap host arrays + replay the journal,
            # then hand the uploaded tensors to the manager
            applied = owner.apply(built)
            if applied is None:
                self.aborted += 1
                if self.metrics is not None:
                    self.metrics.inc("router.compact.aborted")
            else:
                self._offer(owner, applied)
        except Exception:  # noqa: BLE001 — one bad cycle must not stop
            self.aborted += 1
            if self.metrics is not None:
                self.metrics.inc("router.compact.aborted")
            logging.getLogger("emqx_tpu_torch.segments").exception(
                "segment compaction cycle failed (%s)", key
            )
        finally:
            self._busy = False
            self._last[key] = time.monotonic()
            self._need_since.pop(key, None)
            if self.metrics is not None:
                self.metrics.observe(
                    "router.compact.seconds", time.perf_counter() - t0
                )

    def compact_now(self, owner) -> bool:
        """Synchronous cycle (tests / bench): begin+build+apply+offer on
        the calling thread. Returns False when the cycle aborted."""
        cap = owner.begin()
        built = owner.build(cap)
        applied = owner.apply(built)
        if applied is None:
            self.aborted += 1
            return False
        self._offer(owner, applied)
        return True


class ShapeSegmentOwner:
    """Compaction adapter for a `ShapeIndex` + its manager: merges the
    hot segment into the packed table and purges tombstones (the port's
    copy of emqx_tpu/ops/segments.py:484)."""

    key = "shapes"

    def __init__(self, shapes, manager, placement=None,
                 hot_entries: int = 1024, tombstone_frac: float = 0.25):
        self.shapes = shapes
        self.manager = manager
        self._placement = placement
        self.hot_entries = hot_entries
        self.tombstone_frac = tombstone_frac

    def needs_compact(self) -> bool:
        s = self.shapes
        if s.hot_live >= self.hot_entries:
            return True
        return s.packed_tombstones > 0 and (
            s.packed_tombstones >= self.tombstone_frac * s._Tcap
        )

    def begin(self):
        return self.shapes.begin_compact()

    def build(self, cap):
        built = type(self.shapes).build_compact(cap)
        # upload on THIS (executor) thread: the built table is immutable,
        # so the upload is race-free and the serving path never pays it
        built["dev"] = upload_offer({"shape_tab": built["tab"].reshape(-1)},
                                    self.manager.device, self._placement)
        return built

    def apply(self, built):
        merged = self.shapes.hot_live
        epoch0 = self.shapes.epoch
        epoch = self.shapes.apply_compact(built)
        if epoch is None:
            return None
        return epoch, fresh_offer(built["dev"], epoch, epoch0), 0, merged


class BitmapGrowthOwner:
    """Compaction adapter for the dense subscriber bitmap matrix:
    PROACTIVE growth (the port's copy of emqx_tpu/ops/segments.py:530).
    `SubscriberTable` growth is an epoch bump (a full upload of the
    biggest array in the process); growing at 3/4 occupancy from
    housekeeping, and uploading the grown matrix off-thread, keeps the
    bump off the subscribe path."""

    key = "bitmaps"

    def __init__(self, subtab, index, manager, placement=None,
                 headroom: float = 0.75):
        self.subtab = subtab
        self.index = index
        self.manager = manager
        self._placement = placement
        self.headroom = headroom

    def needs_compact(self) -> bool:
        if getattr(self.subtab, "sparse", False):
            return False  # the CSR representation has its own owner
        return (
            self.index.num_filters_capacity
            > self.headroom * self.subtab._fcap
        )

    def begin(self):
        # grow NOW on the loop (one memcpy; the expensive half, the device
        # upload, happens on the executor below), then capture a
        # consistent copy + the op-log position it represents
        from emqx_tpu_torch.ops.nfa import _next_pow2

        tab = self.subtab
        tab.pack(_next_pow2(int(tab._fcap * 2)))
        return {
            "epoch": tab.epoch,
            "pos": len(tab.oplog),
            "arr": tab.arr.copy(),
        }

    def build(self, cap):
        cap["dev"] = upload_offer({"sub_bitmaps": cap["arr"]}, self.manager.device,
                                  self._placement)
        return cap

    def apply(self, built):
        if self.subtab.epoch != built["epoch"]:
            return None  # another structural event superseded the copy
        return built["epoch"], built["dev"], built["pos"], 0


# -- durable snapshot/restore ------------------------------------------------


class SegmentStateSnapshot:
    """Rolling-upgrade story for the segment tables: pickle the host
    sources (numpy arrays + registries) to a sidecar file, written to a
    temporary file and moved into place, so a replacement process
    restores million-entry tables instead of replaying every subscribe.
    The port's copy of emqx_tpu/ops/segments.py:585.

    `capture()` must run on the thread that owns the tables (the loop).
    Nothing it returns may hold a tensor or a process group: a `Router`
    drops its lazy matcher and its mesh when pickled, and a broker's
    device router is rebuilt on the next batch after `install`. `read`
    (a path -> the captured dict) replaces the plain unpickle: the app
    reads the reference's files through it (`app.load_segment_state`).
    """

    def __init__(self, path: str, capture: Callable[[], Dict],
                 install: Optional[Callable[[Dict], None]] = None,
                 read: Optional[Callable[[str], Dict]] = None):
        self.path = path
        self._capture = capture
        self._install = install
        self._read = read

    def save(self) -> Dict:
        import os
        import pickle

        state = self._capture()
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.path)
        return {
            "path": self.path,
            "at": time.time(),
            "keys": sorted(state),
        }

    def load(self, meta: Optional[Dict]) -> Optional[Dict]:
        import os
        import pickle

        path = (meta or {}).get("path", self.path)
        if not path or not os.path.exists(path):
            return None
        if self._read is not None:
            state = self._read(path)
        else:
            with open(path, "rb") as f:
                state = pickle.load(f)
        if self._install is not None:
            self._install(state)
        return state
