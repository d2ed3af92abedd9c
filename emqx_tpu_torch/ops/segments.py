"""Device mirrors of the host tables: the port's copy of
`emqx_tpu/ops/segments.py:56-330` (`RESYNC`, `segment_scatter_impl`,
`DeviceSegmentManager` with the rider handoff `peek_delta`/`adopt`).

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
  `segment_scatter` launch over every touched array (kernel
  `kernels/csrc/segment_scatter.cu`), which first reduces each array's
  writes on the host to the last write per slot;
- a ``(RESYNC, name, 0)`` marker re-uploads only that array from the live
  host table (which already holds every logged write to it).

Op-log protocol (sources: `NfaBuilder`, `ShapeIndex`, `SubscriberTable`,
`GroupTable`, `DeviceRetainedIndex`, `SessionTable`, `SemanticTable`):
`epoch` int, `version` int (total mutation counter), `oplog` list and
`device_snapshot() -> {name: np.ndarray}`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Sequence, Tuple

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


def segment_scatter(
    flats: Mapping[str, torch.Tensor],
    idxs: Mapping[str, Sequence[int]],
    vals: Mapping[str, Sequence[int]],
) -> Dict[str, torch.Tensor]:
    """The O(delta) update (kernel `segment_scatter`): for every array k,
    a FRESH tensor equal to flats[k] with ``flat[idxs[k]] = vals[k]``, every
    array in one launch. The counterpart of `segment_scatter_impl`
    (emqx_tpu/ops/segments.py:73).

    flats: contiguous int32 tensors (uint32 tables hold their bits), uint8
    tensors (byte tables), float32 or bfloat16 tensors (the semantic
    table's lanes and vectors) of any shape, all on one device; idxs/vals:
    host arrays or lists of flat indices and values in program order; a
    float value travels as its bits (`_value_bits`). A
    repeated index keeps its last value: the host reduces each array to
    one write per slot before the launch, so no two threads of the kernel
    touch one element. The inputs are never written: a snapshot a caller
    still holds stays as it was.
    """
    names = list(flats)
    for k in names:
        if not isinstance(flats[k], torch.Tensor) or flats[k].dtype not in _WIDTHS:
            raise TypeError(f"{k}: expected an int32, uint8, float32 or bfloat16 tensor")
        if not flats[k].is_contiguous():
            raise ValueError(f"{k}: must be contiguous")
    writes = {k: _last_writes(idxs[k], vals[k], flats[k].dtype) for k in names}
    for k, (ix, _) in writes.items():
        if len(ix) and (ix.min() < 0 or ix.max() >= flats[k].numel()):
            raise IndexError(f"{k}: index outside [0, {flats[k].numel()})")
    if not names or not kernels.on_cuda(*(flats[k] for k in names)):
        return _apply_plain(flats, writes)
    dev = flats[names[0]].device
    out = {k: flats[k].clone() for k in names}
    n = sum(len(ix) for ix, _ in writes.values())
    if n == 0:
        return out
    A = len(names)
    # one host buffer, one copy:
    # [A base pointers | A element widths | ids | indices | values]
    buf = np.empty(2 * A + 3 * n, dtype=np.int64)
    buf[:A] = [out[k].data_ptr() for k in names]
    buf[A : 2 * A] = [_WIDTHS[out[k].dtype] for k in names]
    o = 2 * A
    for a, k in enumerate(names):
        ix, vv = writes[k]
        m = len(ix)
        buf[o : o + m] = a
        buf[o + n : o + n + m] = ix
        buf[o + 2 * n : o + 2 * n + m] = vv
        o += m
    dbuf = torch.from_numpy(buf).to(dev)
    kernels.launch("segment_scatter", "emqx_segment_scatter", dev,
                   dbuf.data_ptr(), A, n)
    return out


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
    the scatter into a routed batch; `offer`, whose caller (background
    compaction) is a later slice, is not ported.

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
        snap = src.device_snapshot()
        self._arrays = upload(snap, self.device, self.placement)
        self._shapes = {k: v.shape for k, v in snap.items()}
        self._epoch = src.epoch
        self._pos = len(src.oplog)
        self.full_resyncs += 1
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
