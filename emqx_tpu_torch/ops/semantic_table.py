"""Semantic routing tables: embedding-filter subscriptions on the segment
machinery, and the similarity stage of the serving step. The port's copy
of `emqx_tpu/ops/semantic_table.py` (`HOT_POS`, `SEM_KEYS`, `normalize`,
`SemanticTable`; host code numpy, bit for bit as in the original) and its
device half, `semantic_match_step` and `union_semantic_slots`, as the
hand-written kernels of `kernels/csrc/semantic_match.cu` with their plain
PyTorch twins.

A subscription may carry an embedding filter: a unit vector, a
cosine-similarity threshold and an optional topic scope. The serving step
answers every filter of the table for every message of a batch:

  ``sims [B, E] = q_vecs [B, D]  @  vecs.T [D, E]``   (f32 accumulation)

then keeps the entries that are live (``slot >= 0``), at or above their
threshold, and in scope (``fid == -1``, or the fid among the row's matched
fids), and picks the row's ``topk`` best by (score desc, index asc), as
``lax.top_k`` breaks ties. The winners' slots union into the topic
fan-out's compact slot rows before the readback (`union_semantic_slots`):
a winner already among the row's topic slots becomes -1, and the topic
part stays byte-identical, so ``slot_count``/``overflow`` keep their
topic-only meaning.

The table: a packed segment ``sem_vec [S, P, D]`` (f32, or bf16 in the
quantized mode) with the lanes ``sem_fid / sem_slot / sem_thresh [S, P]``,
written only by rebuilds; an append-only hot segment, the ``sem_hot_*``
twins, where an insert is D + 3 op-logged scalar writes the router's
mirror replays as one `segment_scatter`; a remove is ONE op-logged write
of ``slot = -1``. ``S`` is the mesh's shard axis (`parallel.mesh
.semantic_placement`: 'tp' rank t holds shard t, and each shard's winners
are global slot ids); a single device holds ``S = 1``. E = P + H:
the kernels read both segments in place, and nothing of size [B, E] is
ever stored (the JAX program materialises the [B, E] similarities and a
[B, E] membership mask: 8.6 GB and 2.1 GB at B = 8,192, E = 2^18).

The broker binds subscriptions into this table through `SemanticRouting`
(`broker/semantic.py`). `SemanticSegmentOwner` drives the table's
compaction cycle (`begin_compact` / `build_compact` / `apply_compact`) on
`ops.segments.SegmentCompactor`: the packed segment is rebuilt and
uploaded off the subscribe path (a bf16 table's vectors as their bf16
bits), and the next prepare adopts it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.convert import to_bf16
from emqx_tpu_torch.ops.nfa import _next_pow2
from emqx_tpu_torch.ops.segments import RESYNC

# registry position flag: entry lives in the hot segment
HOT_POS = 1 << 30

# device-snapshot array names (the segment-manager sync set)
SEM_KEYS = (
    "sem_vec", "sem_fid", "sem_slot", "sem_thresh",
    "sem_hot_vec", "sem_hot_fid", "sem_hot_slot", "sem_hot_thresh",
)


def normalize(vec, dim: int) -> np.ndarray:
    """Embedding intake: f32, exactly ``dim`` wide, unit-norm (cosine
    similarity is then one dot product). Zero vectors stay zero — they
    match nothing at any positive threshold."""
    v = np.asarray(vec, np.float32).reshape(-1)
    if v.shape[0] != dim:
        raise ValueError(
            f"embedding has dim {v.shape[0]}, table expects {dim}"
        )
    n = float(np.linalg.norm(v))
    if n > 1e-12:
        v = v / np.float32(n)
    return v.astype(np.float32)


# -- kernel 13: the similarity stage ---------------------------------------

# the most winners a row keeps on the card: one per lane of a warp
TOPK_MAX = 32
# rows and entries of one tile of the score kernel (semantic_match.cu)
SEM_TILE = 128
# the most column splits of one call (the merge walks S lists a row)
SPLITS_MAX = 64


def _lanes(sem: Dict[str, torch.Tensor]):
    """(vecs [E, D], fids, slots, ths [E]) of the one shard the tensors hold
    (a single device's, or a mesh rank's): packed ++ hot."""
    return tuple(
        torch.cat([sem[k][0], sem[h][0]], dim=0)
        for k, h in (("sem_vec", "sem_hot_vec"), ("sem_fid", "sem_hot_fid"),
                     ("sem_slot", "sem_hot_slot"), ("sem_thresh", "sem_hot_thresh"))
    )


def semantic_match_step_plain(sem: Dict[str, torch.Tensor], q_vecs, matched, topk: int):
    """Plain PyTorch twin of `semantic_match_step` (any device), written
    after the JAX function (emqx_tpu/ops/semantic_table.py:104): it
    materialises the [B, E] similarities and masks, so a caller at full
    size runs it in row chunks. A bf16 table casts the query down, and both
    operands are widened to f32 before the product (a product of two bf16
    values is exact in f32; a bf16 matmul would round the sums to bf16).
    On a card the product runs with TF32 off. Winners are sorted by (score
    desc, index asc) with a stable sort: torch.topk promises no order among
    ties, lax.top_k takes the lower index."""
    if topk <= 0:
        raise ValueError("semantic matching requires topk > 0")
    vecs, fids, slots, ths = _lanes(sem)
    B, K = matched.shape
    E = vecs.shape[0]
    q = q_vecs
    if vecs.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sims = q.float() @ vecs.float().T  # [B, E] f32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    memb = torch.zeros((B, E), dtype=torch.bool, device=q.device)
    for k in range(K):
        memb |= matched[:, k, None] == fids[None, :]
    ok = (slots >= 0)[None, :] & (sims >= ths[None, :]) & ((fids < 0)[None, :] | memb)
    count = ok.sum(dim=1, dtype=torch.int32)
    score = torch.where(ok, sims, torch.full_like(sims, -math.inf))
    k = min(topk, E)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    top_v = torch.gather(score, 1, order)
    sem_slots = torch.where(top_v > -math.inf, slots[order],
                            torch.full_like(order, -1)).to(torch.int32)
    if k < topk:  # tiny tables: pad to the static contract width
        sem_slots = torch.cat([sem_slots, sem_slots.new_full((B, topk - k), -1)], dim=1)
    return sem_slots, count


def union_semantic_slots_plain(slots, sem_slots):
    """Plain PyTorch twin of `union_semantic_slots` (any device)."""
    dup = ((sem_slots[:, :, None] == slots[:, None, :])
           & (sem_slots >= 0)[:, :, None]).any(dim=2)
    clean = torch.where(dup, torch.full_like(sem_slots, -1), sem_slots)
    return torch.cat([slots, clean], dim=1)


def _check_sem(sem, q_vecs, matched, topk: int, *extra) -> bool:
    """Validate the stage's inputs; True when they lie on a card (with
    `extra`, the tensors that must lie with them)."""
    if topk <= 0:
        raise ValueError("semantic matching requires topk > 0")
    vdt = sem["sem_vec"].dtype
    if vdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sem_vec: expected float32 or bfloat16, got {vdt}")
    kernels.check_tensor(sem["sem_vec"], "sem_vec", vdt, 3)
    kernels.check_tensor(sem["sem_hot_vec"], "sem_hot_vec", vdt, 3)
    for k, dt in (("sem_fid", torch.int32), ("sem_slot", torch.int32),
                  ("sem_thresh", torch.float32), ("sem_hot_fid", torch.int32),
                  ("sem_hot_slot", torch.int32), ("sem_hot_thresh", torch.float32)):
        kernels.check_tensor(sem[k], k, dt, 2)
    D = sem["sem_vec"].shape[2]
    if sem["sem_vec"].shape[0] != 1:
        raise ValueError("one shard a call: a mesh rank passes its own 'tp' slice")
    kernels.check_tensor(q_vecs, "q_vecs", torch.float32, 2)
    kernels.check_tensor(matched, "matched", torch.int32, 2)
    if q_vecs.shape[1] != D or q_vecs.shape[0] != matched.shape[0]:
        raise ValueError(f"q_vecs {tuple(q_vecs.shape)} against D = {D}, "
                         f"B = {matched.shape[0]}")
    return kernels.on_cuda(q_vecs, matched, *extra, *(sem[k] for k in SEM_KEYS))


def semantic_splits(B: int, E: int, sms: int) -> int:
    """Column splits of the score kernel: the S (at most `SPLITS_MAX` and
    the tile count) that finishes the row blocks x tiles of work in the
    fewest tile-times on `sms` multiprocessors, a block resident on each
    (waves ``ceil(row_blocks S / sms)`` of ``ceil(tiles / S)`` tiles); a
    tie takes the smaller S, which leaves the merge less to do."""
    row_blocks = max(1, -(-B // SEM_TILE))
    tiles = max(1, -(-E // SEM_TILE))
    best = None
    for S in range(1, min(tiles, SPLITS_MAX) + 1):
        cost = -(-row_blocks * S // sms) * -(-tiles // S)
        if best is None or cost < best[0]:
            best = (cost, S)
    return best[1]


def _scores(sem, q_vecs, matched, topk: int):
    """Launch (a), the scores and each split's top-k: -> ``(cand_s f32
    [B, S, topk], cand_i int32 [B, S, topk], part int32 [B, S])``, a
    split's candidates in (score desc, index asc) order, -inf / -1 past
    its qualifying entries, and its uncapped count."""
    if topk > TOPK_MAX:
        raise ValueError(f"topk {topk}: the semantic_match kernel keeps at most {TOPK_MAX}")
    vp, vh = sem["sem_vec"], sem["sem_hot_vec"]
    B, K = matched.shape
    P, H, D = vp.shape[1], vh.shape[1], vp.shape[2]
    E = P + H
    if E >= 1 << 31:
        raise ValueError(f"{E} entries: the kernel's entry indices are 31-bit")
    dev = q_vecs.device
    S = semantic_splits(B, E, torch.cuda.get_device_properties(dev).multi_processor_count)
    tiles = -(-E // SEM_TILE)
    bf16 = vp.dtype == torch.bfloat16
    cand_s = torch.empty((B, S, topk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, S, topk), dtype=torch.int32, device=dev)
    part = torch.empty((B, S), dtype=torch.int32, device=dev)
    # bf16: scratch for the query rows rounded to bf16, which the kernel
    # streams from beside the table; whole row blocks, D padded to its
    # 64-dimension chunks
    qb = (torch.empty((-(-B // SEM_TILE) * SEM_TILE, -(-D // 64) * 64),
                      dtype=torch.bfloat16, device=dev) if bf16 else None)
    kernels.launch(
        "semantic_match", "emqx_semantic_scores", dev,
        q_vecs.data_ptr(), qb.data_ptr() if bf16 else None, vp.data_ptr(), P,
        vh.data_ptr(), H, 1 if bf16 else 0,
        sem["sem_fid"].data_ptr(), sem["sem_slot"].data_ptr(),
        sem["sem_thresh"].data_ptr(), sem["sem_hot_fid"].data_ptr(),
        sem["sem_hot_slot"].data_ptr(), sem["sem_hot_thresh"].data_ptr(),
        matched.data_ptr(), B, K, D, topk, S, -(-tiles // S),
        cand_s.data_ptr(), cand_i.data_ptr(), part.data_ptr(),
    )
    return cand_s, cand_i, part


def _launch(sem, q_vecs, matched, topk: int, slots: Optional[torch.Tensor]):
    """The two launches: scores + per-split top-k, then the merge (and the
    union with `slots` [B, kslot] when given)."""
    cand_s, cand_i, part = _scores(sem, q_vecs, matched, topk)
    B, S = part.shape
    P = sem["sem_vec"].shape[1]
    dev = q_vecs.device
    kslot = 0 if slots is None else slots.shape[1]
    out = torch.empty((B, kslot + topk), dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.launch(
        "semantic_match", "emqx_semantic_merge", dev,
        cand_s.data_ptr(), cand_i.data_ptr(), part.data_ptr(), S,
        sem["sem_slot"].data_ptr(), P, sem["sem_hot_slot"].data_ptr(),
        slots.data_ptr() if slots is not None else None, kslot, B, topk,
        out.data_ptr(), count.data_ptr(),
    )
    return out, count


def semantic_match_step(sem: Dict[str, torch.Tensor], q_vecs, matched, topk: int):
    """ONE batched similarity pass + threshold/scope mask + top-k (kernel
    `semantic_match`, two launches).

    sem: the eight `SEM_KEYS` tensors of one shard ([1, ...] leading axis:
    a single device's `SemanticTable.device_snapshot()`, or one mesh
    rank's 'tp' slice of it; ``sem_vec``
    float32 or bfloat16); q_vecs: f32 [B, D] per-message embeddings;
    matched: int32 [B, K] sparse fids (-1 holes) from the topic match.
    Returns ``(sem_slots int32 [B, topk], sem_count int32 [B])``: the top-k
    qualifying entries' slots, score-ordered, -1 holes, and the UNCAPPED
    qualifying count. The counterpart of `semantic_match_step`
    (emqx_tpu/ops/semantic_table.py:104). On a card ``topk`` is at most
    `TOPK_MAX`."""
    if not _check_sem(sem, q_vecs, matched, topk):
        return semantic_match_step_plain(sem, q_vecs, matched, topk)
    return _launch(sem, q_vecs, matched, topk, None)


def union_semantic_slots(slots, sem_slots):
    """Union the semantic winners into the topic fan-out's compact slot
    rows: ``[B, kslot] ++ [B, topk] -> [B, kslot + topk]``, a winner
    already in the row's topic part set to -1, the topic part unchanged.
    The counterpart of `union_semantic_slots`
    (emqx_tpu/ops/semantic_table.py:176): one launch of
    `semantic_match.cu`'s union kernel (the serving step fuses the union
    into the merge instead, `semantic_route_stage`)."""
    kernels.check_tensor(slots, "slots", torch.int32, 2)
    kernels.check_tensor(sem_slots, "sem_slots", torch.int32, 2)
    if slots.shape[0] != sem_slots.shape[0]:
        raise ValueError(f"slots {tuple(slots.shape)} against sem_slots "
                         f"{tuple(sem_slots.shape)}")
    if not kernels.on_cuda(slots, sem_slots):
        return union_semantic_slots_plain(slots, sem_slots)
    B, kslot = slots.shape
    topk = sem_slots.shape[1]
    out = torch.empty((B, kslot + topk), dtype=torch.int32, device=slots.device)
    kernels.launch("semantic_match", "emqx_semantic_union", slots.device,
                   slots.data_ptr(), kslot, sem_slots.data_ptr(), topk, B,
                   out.data_ptr())
    return out


def semantic_route_stage(sem: Dict[str, torch.Tensor], q_vecs, matched, topk: int,
                         slots):
    """The serving step's semantic stage: `semantic_match_step` with the
    union fused into its merge launch -> (slots int32 [B, kslot + topk],
    sem_count int32 [B]). Two launches on a card; the twins on the CPU."""
    kernels.check_tensor(slots, "slots", torch.int32, 2)
    if slots.shape[0] != matched.shape[0]:
        raise ValueError(f"slots {tuple(slots.shape)} against B = {matched.shape[0]}")
    if not _check_sem(sem, q_vecs, matched, topk, slots):
        sem_slots, count = semantic_match_step_plain(sem, q_vecs, matched, topk)
        return union_semantic_slots_plain(slots, sem_slots), count
    return _launch(sem, q_vecs, matched, topk, slots)


# -- host table --------------------------------------------------------------


class SemanticTable:
    """Host-side embedding-filter registry + its device mirror source
    (epoch/oplog/version protocol, docs/update_path.md): the port's copy of
    `SemanticTable` (emqx_tpu/ops/semantic_table.py:202) (``shards``
    entries' owner axis: an entry is owned by shard ``slot % shards``, the
    mesh's 'tp' rank of that index holds it), with its compaction cycle
    (`begin_compact`, `build_compact`, `apply_compact`): mutations that
    race a build are journaled and replayed by the apply. With no
    compactor draining it, a hot segment past `HOT_ABSORB_MAX` folds
    inline by `_rebuild`.

    One entry per subscriber slot: ``slot`` is the broker's fan-out
    slot (`Broker._slot_subs`), so a semantic hit IS an ordinary slot
    recipient. ``fid`` scopes the entry to a topic filter (-1 =
    unscoped). Vectors normalize at intake.
    """

    HOT_MIN = 64  # minimum hot-segment capacity per shard (pow2)
    # hot population past this forces an inline rebuild instead of
    # another growth (the kernel concatenates hot into the matmul, so
    # hot size is a FLOP knob, not just memory)
    HOT_ABSORB_MAX = 1 << 14

    def __init__(self, dim: int = 64, topk: int = 16, shards: int = 1,
                 dtype: str = "float32"):
        if dim < 1:
            raise ValueError("semantic dim must be >= 1")
        if topk < 1:
            raise ValueError("semantic topk must be >= 1")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"semantic dtype {dtype!r}")
        self.dim = dim
        self.topk = topk
        self.dtype = dtype
        self.shards = S = max(1, int(shards))
        self._pcap = 64  # packed capacity PER SHARD
        self.sem_vec = np.zeros((S, self._pcap, dim), np.float32)
        self.sem_fid = np.full((S, self._pcap), -1, np.int32)
        self.sem_slot = np.full((S, self._pcap), -1, np.int32)
        self.sem_thresh = np.ones((S, self._pcap), np.float32)
        self._hcap = self.HOT_MIN
        self.sem_hot_vec = np.zeros((S, self._hcap, dim), np.float32)
        self.sem_hot_fid = np.full((S, self._hcap), -1, np.int32)
        self.sem_hot_slot = np.full((S, self._hcap), -1, np.int32)
        self.sem_hot_thresh = np.ones((S, self._hcap), np.float32)
        self._hot_tail = [0] * S
        self.live = 0
        self.packed_tombs = 0
        self.hot_tombs = 0
        # slot -> packed position | (HOT_POS | hot index), shard implied
        # by slot % shards (see module docstring for why a dict is fine)
        self._reg: Dict[int, int] = {}
        self.epoch = 0
        self.oplog: list = []
        self.version = 0
        self.OPLOG_MAX = 65536
        # compaction bookkeeping (the ShapeIndex/CsrTable cycle)
        self._structure_gen = 0
        self._journal: Optional[list] = None  # single-writer: loop

    # -- op-log plumbing ----------------------------------------------------
    def _bump(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _log(self, name: str, flat_idx: int, val) -> None:
        # values stay python floats for the f32 lanes (the segment
        # scatter casts to the array dtype; int() here would truncate)
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump()
            return
        self.oplog.append((name, int(flat_idx), val))

    def _log_resync(self, name: str) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump()
            return
        self.oplog.append((RESYNC, name, 0))

    # -- mutation -----------------------------------------------------------
    def add(self, slot: int, vec, threshold: float, fid: int = -1) -> bool:
        """Install (or replace) the embedding filter bound to a
        subscriber slot. Returns True when a NEW entry was created."""
        v = normalize(vec, self.dim)
        fid = -1 if fid is None or fid < 0 else int(fid)
        th = float(threshold)
        pos = self._reg.get(slot)
        if pos is not None:
            self._write_entry(slot, pos, v, th, fid)
            if self._journal is not None:
                self._journal.append(("add", slot, v, th, fid))
            return False
        s = slot % self.shards
        if self._hot_tail[s] >= self._hcap:
            if self.hot_fill >= self.HOT_ABSORB_MAX:
                # no compactor is draining hot: fold inline (epoch bump)
                self._rebuild([(slot, v, th, fid)])
                return True
            self._grow_hot()
        h = self._hot_tail[s]
        self._hot_tail[s] = h + 1
        self.sem_hot_vec[s, h] = v
        base = (s * self._hcap + h) * self.dim
        for d in range(self.dim):
            self._log("sem_hot_vec", base + d, float(v[d]))
        self.sem_hot_fid[s, h] = fid
        self._log("sem_hot_fid", s * self._hcap + h, fid)
        self.sem_hot_thresh[s, h] = th
        self._log("sem_hot_thresh", s * self._hcap + h, th)
        # slot lane LAST: liveness flips on only once the row is whole
        self.sem_hot_slot[s, h] = slot
        self._log("sem_hot_slot", s * self._hcap + h, slot)
        self._reg[slot] = h | HOT_POS
        self.live += 1
        if self._journal is not None:
            self._journal.append(("add", slot, v, th, fid))
        return True

    def _write_entry(self, slot: int, pos: int, v, th: float,
                     fid: int) -> None:
        """In-place filter replacement (same slot re-subscribes with a
        new embedding): scalar op-logged writes, no structural event."""
        s = slot % self.shards
        if pos & HOT_POS:
            h = pos & ~HOT_POS
            self.sem_hot_vec[s, h] = v
            base = (s * self._hcap + h) * self.dim
            for d in range(self.dim):
                self._log("sem_hot_vec", base + d, float(v[d]))
            self.sem_hot_fid[s, h] = fid
            self._log("sem_hot_fid", s * self._hcap + h, fid)
            self.sem_hot_thresh[s, h] = th
            self._log("sem_hot_thresh", s * self._hcap + h, th)
        else:
            self.sem_vec[s, pos] = v
            base = (s * self._pcap + pos) * self.dim
            for d in range(self.dim):
                self._log("sem_vec", base + d, float(v[d]))
            self.sem_fid[s, pos] = fid
            self._log("sem_fid", s * self._pcap + pos, fid)
            self.sem_thresh[s, pos] = th
            self._log("sem_thresh", s * self._pcap + pos, th)

    def remove(self, slot: int) -> bool:
        """Tombstone the entry bound to a slot: ONE op-logged write."""
        pos = self._reg.pop(slot, None)
        if pos is None:
            return False
        s = slot % self.shards
        if pos & HOT_POS:
            h = pos & ~HOT_POS
            self.sem_hot_slot[s, h] = -1
            self._log("sem_hot_slot", s * self._hcap + h, -1)
            self.hot_tombs += 1
        else:
            self.sem_slot[s, pos] = -1
            self._log("sem_slot", s * self._pcap + pos, -1)
            self.packed_tombs += 1
        self.live -= 1
        if self._journal is not None:
            self._journal.append(("remove", slot, None, 0.0, -1))
        return True

    def bulk_add(self, slots, vecs, thresholds, fids=None) -> None:
        """Vectorized cold load: one rebuild + one epoch bump."""
        slots = np.asarray(slots, np.int64)
        vecs = np.asarray(vecs, np.float32)
        ths = np.asarray(thresholds, np.float32)
        if fids is None:
            fids = np.full(len(slots), -1, np.int64)
        else:
            fids = np.asarray(fids, np.int64)
        n = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = (vecs / np.maximum(n, 1e-12)).astype(np.float32)
        extra = [
            (int(slots[i]), vecs[i], float(ths[i]), int(fids[i]))
            for i in range(len(slots))
        ]
        self._rebuild(extra)

    def reshard(self, shards: int) -> None:
        """Re-partition over a new shard count (a mesh attached after
        filters landed): one rebuild, one epoch bump. The counterpart of
        `reshard` (emqx_tpu/ops/semantic_table.py:380)."""
        shards = max(1, int(shards))
        if shards == self.shards:
            return
        # the live entries of the OLD layout, before every array's leading
        # axis changes
        ent = self._live_tuples()
        self.shards = shards
        self._structure_gen += 1
        self._journal = None
        built = self._build(ent, shards, self.dim)
        self._install(built)
        self._bump()

    # -- structure ----------------------------------------------------------
    def _grow_hot(self) -> None:
        nh = self._hcap * 2
        S = self.shards
        for name, fill in (
            ("sem_hot_fid", -1), ("sem_hot_slot", -1),
            ("sem_hot_thresh", 1.0),
        ):
            old = getattr(self, name)
            new = np.full((S, nh), fill, old.dtype)
            new[:, : self._hcap] = old  # append-only: indices preserved
            setattr(self, name, new)
            self._log_resync(name)
        old = self.sem_hot_vec
        new = np.zeros((S, nh, self.dim), np.float32)
        new[:, : self._hcap] = old
        self.sem_hot_vec = new
        self._log_resync("sem_hot_vec")
        self._hcap = nh

    @property
    def hot_fill(self) -> int:
        return sum(self._hot_tail) - self.hot_tombs

    @property
    def nbytes(self) -> int:
        """Device-table footprint: the eight mirrored arrays (bf16
        halves the vec arrays at upload; this reports the host f32)."""
        return sum(
            getattr(self, k).nbytes for k in SEM_KEYS
        )

    def __len__(self) -> int:
        return self.live

    def entries(self) -> List[Tuple[int, int, float]]:
        """(slot, fid, threshold) of every live entry (REST listing)."""
        out = []
        for slot, pos in self._reg.items():
            s = slot % self.shards
            if pos & HOT_POS:
                h = pos & ~HOT_POS
                out.append((
                    slot, int(self.sem_hot_fid[s, h]),
                    float(self.sem_hot_thresh[s, h]),
                ))
            else:
                out.append((
                    slot, int(self.sem_fid[s, pos]),
                    float(self.sem_thresh[s, pos]),
                ))
        return sorted(out)

    def live_arrays(self):
        """(vecs [E, D] f32, slots [E], fids [E], ths [E]) of every live
        entry — the host fallback / reference evaluator's view (loop
        thread; vectorized scans, no per-entry Python objects)."""
        vs, sl, fi, th = [], [], [], []
        for s in range(self.shards):
            m = self.sem_slot[s] >= 0
            if m.any():
                vs.append(self.sem_vec[s][m])
                sl.append(self.sem_slot[s][m])
                fi.append(self.sem_fid[s][m])
                th.append(self.sem_thresh[s][m])
            hm = self.sem_hot_slot[s] >= 0
            if hm.any():
                vs.append(self.sem_hot_vec[s][hm])
                sl.append(self.sem_hot_slot[s][hm])
                fi.append(self.sem_hot_fid[s][hm])
                th.append(self.sem_hot_thresh[s][hm])
        if not vs:
            z = np.empty(0, np.int32)
            return (np.empty((0, self.dim), np.float32), z, z,
                    np.empty(0, np.float32))
        return (
            np.concatenate(vs), np.concatenate(sl),
            np.concatenate(fi), np.concatenate(th),
        )

    def device_snapshot(self) -> Dict[str, np.ndarray]:
        out = {k: getattr(self, k) for k in SEM_KEYS}
        if self.dtype == "bfloat16":
            out = dict(out)
            for k in ("sem_vec", "sem_hot_vec"):
                out[k] = to_bf16(out[k])
        return out

    def status(self) -> Dict:
        """Hotpath-REST / gauge block."""
        return {
            "filters": self.live,
            "dim": self.dim,
            "topk": self.topk,
            "dtype": self.dtype,
            "shards": self.shards,
            "packed_capacity": self._pcap * self.shards,
            "hot_fill": self.hot_fill,
            "tombstones": self.packed_tombs + self.hot_tombs,
            "bytes": self.nbytes,
        }

    # -- rebuild / compaction ----------------------------------------------
    def _live_tuples(self) -> List[Tuple[int, np.ndarray, float, int]]:
        vecs, slots, fids, ths = self.live_arrays()
        return [
            (int(slots[i]), vecs[i].copy(), float(ths[i]), int(fids[i]))
            for i in range(len(slots))
        ]

    def _rebuild(self, extra=()) -> None:
        ent = self._live_tuples()
        seen = {e[0] for e in extra}
        ent = [e for e in ent if e[0] not in seen] + list(extra)
        self._structure_gen += 1
        self._journal = None
        built = self._build(ent, self.shards, self.dim)
        self._install(built)
        self._bump()

    @staticmethod
    def _build(entries, shards: int, dim: int) -> Dict:
        """Pure-numpy exact-size packed build from (slot, vec, th, fid)
        tuples — safe on any thread (the compaction executor runs it)."""
        S = shards
        per: List[list] = [[] for _ in range(S)]
        for slot, v, th, fid in entries:
            per[slot % S].append((slot, v, th, fid))
        pcap = max(64, _next_pow2(max((len(p) for p in per), default=1)))
        vec = np.zeros((S, pcap, dim), np.float32)
        fidl = np.full((S, pcap), -1, np.int32)
        slotl = np.full((S, pcap), -1, np.int32)
        thl = np.ones((S, pcap), np.float32)
        reg: Dict[int, int] = {}
        n = 0
        for s in range(S):
            for i, (slot, v, th, fid) in enumerate(sorted(per[s])):
                vec[s, i] = v
                fidl[s, i] = fid
                slotl[s, i] = slot
                thl[s, i] = th
                reg[slot] = i
                n += 1
        return {
            "pcap": pcap, "sem_vec": vec, "sem_fid": fidl,
            "sem_slot": slotl, "sem_thresh": thl, "reg": reg, "n": n,
        }

    # oplog-covered-by: every caller bumps the epoch after install
    def _install(self, built: Dict) -> None:
        S = self.shards
        self._pcap = built["pcap"]
        self.sem_vec = built["sem_vec"]
        self.sem_fid = built["sem_fid"]
        self.sem_slot = built["sem_slot"]
        self.sem_thresh = built["sem_thresh"]
        self._hcap = self.HOT_MIN
        self.sem_hot_vec = np.zeros((S, self._hcap, self.dim), np.float32)
        self.sem_hot_fid = np.full((S, self._hcap), -1, np.int32)
        self.sem_hot_slot = np.full((S, self._hcap), -1, np.int32)
        self.sem_hot_thresh = np.ones((S, self._hcap), np.float32)
        self._hot_tail = [0] * S
        self.hot_tombs = 0
        self.packed_tombs = 0
        self.live = built["n"]
        self._reg = dict(built["reg"])

    # -- background compaction (ops/segments.SegmentCompactor cycle) -------
    def begin_compact(self) -> Dict:
        cap = {
            "entries": self._live_tuples(),
            "shards": self.shards,
            "dim": self.dim,
            "gen": self._structure_gen,
        }
        self._journal = []
        return cap

    @staticmethod
    def build_compact(cap: Dict) -> Dict:
        built = SemanticTable._build(
            cap["entries"], cap["shards"], cap["dim"]
        )
        built["gen"] = cap["gen"]
        return built

    def apply_compact(self, built: Dict) -> bool:
        """Install a built table (loop thread) + replay the journal of
        mutations that raced the build. False = capture invalidated by
        a structural rebuild (the cycle aborts cleanly)."""
        if self._journal is None or built["gen"] != self._structure_gen:
            self._journal = None
            return False
        journal, self._journal = self._journal, None
        self._structure_gen += 1
        self._install(built)
        self._bump()
        for op, slot, v, th, fid in journal:
            if op == "add":
                self.add(slot, v, th, fid)
            else:
                self.remove(slot)
        return True


class SemanticSegmentOwner:
    """Compaction adapter for a `SemanticTable` + its segment manager:
    merge ``packed - tombstones + hot`` into a fresh exact-size table off
    the subscribe path, uploading the packed arrays on the compaction
    thread (`ops.segments.SegmentCompactor` drives the cycle). The port's
    copy of emqx_tpu/ops/semantic_table.py:602; a bf16 table's vectors
    upload as their bf16 bits (`convert.to_bf16`), the mirror's type."""

    key = "semantic"

    def __init__(self, semtab: SemanticTable, manager, placement=None,
                 hot_entries: int = 1024, tombstone_frac: float = 0.25):
        self.semtab = semtab
        self.manager = manager
        self._placement = placement
        self.hot_entries = hot_entries
        self.tombstone_frac = tombstone_frac

    def needs_compact(self) -> bool:
        t = self.semtab
        if t.hot_fill >= self.hot_entries:
            return True
        tombs = t.packed_tombs + t.hot_tombs
        return tombs > 0 and tombs >= self.tombstone_frac * max(1, t.live)

    def begin(self):
        return self.semtab.begin_compact()

    def build(self, cap):
        from emqx_tpu_torch.ops.segments import upload_offer

        built = SemanticTable.build_compact(cap)
        # upload the packed arrays on THIS (executor) thread: the built
        # table is immutable, so the upload is race-free
        arrays = {name: built[name] for name in ("sem_vec", "sem_fid", "sem_slot",
                                                 "sem_thresh")}
        if self.semtab.dtype == "bfloat16":
            arrays["sem_vec"] = to_bf16(arrays["sem_vec"])
        built["dev"] = upload_offer(arrays, self.manager.device, self._placement)
        return built

    def apply(self, built):
        from emqx_tpu_torch.ops.segments import fresh_offer

        merged = self.semtab.hot_fill
        epoch0 = self.semtab.epoch
        if not self.semtab.apply_compact(built):
            return None
        epoch = self.semtab.epoch
        return epoch, fresh_offer(built["dev"], epoch, epoch0), 0, merged
