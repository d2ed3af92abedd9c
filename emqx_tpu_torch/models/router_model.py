"""The serving step: topics -> matched filters -> subscriber slots and
$share picks, on one device. The port's counterpart of
`emqx_tpu/models/router_model.py`, single device: the shape-index path
with the residual-NFA lane, dense bitmaps or the sparse CSR subscriber
table, on-device $share picks, the semantic routing stage and the
compiled rule masks.

One routed batch runs these hand-written CUDA kernels, in order:

  tokenize (ops/tokenizer.py)  ->  shape_match (ops/shape_index.py)
  [->  vocab_lookup (ops/tokenizer.py)  ->  nfa_walk (ops/matcher.py),
       when the table holds residual filters]
  ->  dense table: fanout_bitmaps  ->  compact_fanout_slots  (this module)
      CSR table:   sparse_fanout_slots                     (ops/csr_table.py)
  [->  occurrence_index (round_robin only)  ->  share_pick   (this module),
       when a group table is given]
  [->  semantic_match, scores then merge + union (ops/semantic_table.py),
       when a semantic table is live]
  [->  rule_masks (rules/compile.py), when compiled rules ride the batch]

then `DeviceRouter._readback` brings the trimmed outputs to the host in
one copy. `route_step` is the NFA-only step (every filter in the NFA, no
shape index): tokenize -> vocab_lookup -> nfa_walk -> the same fan-out;
`DeviceRouter(index, None, config)` is a match-only router (no fan-out
half) with its `match_batch`. A retained replay storm (`models/retained_index.py`) can ride a
routed batch: `DeviceRouter.route_prepared(..., retained=job)` launches
the storm's chunk matches after the route kernels and reads their match
matrices back in the same copy. So can the session store's rider
(`broker/session_store.py`): `route_prepared(..., session=rider)` runs
`ops.session_table.session_ack` after the route kernels (the rider's
inflight writes as one `segment_scatter`, then the `session_sweep`
retransmit/expiry sweep over the scattered lanes), and the sweep lists
join the same copy. Subscriber state is either the dense
bitmap matrix ``sub_bitmaps [Fcap, W]`` (uint32 bits in an int32 tensor:
row = filter id, bit = subscriber slot) or the five CSR arrays of
`ops/csr_table.py`; `SubscriberTable` switches between them (`set_mode`,
or the `auto` policy). $share groups are `GroupTable`'s lanes. Embedding
filters are `ops.semantic_table.SemanticTable`'s entries: their winners
union into the compact slot rows, so a semantic table makes the compact
stage mandatory. Each kernel has its plain
PyTorch twin in the same module as its wrapper; a wrapper runs the twin
only for CPU tensors. The device copies of the shape index, the NFA, the
subscriber table, the group table and the semantic table are kept current
by five `ops.segments.DeviceSegmentManager` mirrors (O(delta) scatters).

On a ('dp', 'tp') mesh (`parallel.mesh`) each process is one rank: a
`DeviceRouter(mesh=)` or `MeshServingRouter` mirrors its part of every
table, runs the same kernels on its 'dp' rows and 'tp' shard (the dense
compaction with a lane base, the round-robin picks with the lower dp
ranks' group counts), and assembles the global result from one
all-gather (`_route_mesh`, `_readback_mesh`).

Background compaction: `DeviceRouter.compaction_owners()` hands the
`ops.segments.SegmentCompactor` one owner per table it can merge (shapes,
the CSR table or the dense matrix's growth, the semantic table); each
rebuild is uploaded off the serving path and adopted by the next
`prepare()`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker.session_store import SessionStepOut
from emqx_tpu_torch.broker.shared_sub import stable_hash
from emqx_tpu_torch.convert import resolve_device
from emqx_tpu_torch.kernels.build import KernelBuildError
from emqx_tpu_torch.observe import faults as _faults
from emqx_tpu_torch.ops.csr_table import CSR_KEYS, CsrTable, sparse_fanout_slots
from emqx_tpu_torch.ops.matcher import (
    MatcherConfig,
    MatchError,
    batch_match_bytes,
    batch_match_syms,
)
from emqx_tpu_torch.ops.nfa import MAX_PROBES, _next_pow2
from emqx_tpu_torch.ops.segments import RESYNC, DeviceSegmentManager
from emqx_tpu_torch.ops.semantic_table import SEM_KEYS, semantic_route_stage
from emqx_tpu_torch.ops.session_table import session_ack
from emqx_tpu_torch.ops.shape_index import shape_match
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.ops.tokenizer import encode_topics, tokenize, vocab_lookup
from emqx_tpu_torch.ops.u32 import mul32, u32
from emqx_tpu_torch.rules.compile import eval_rule_masks


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


def fanout_bitmaps(sub_bitmaps, matched, *, streaming: bool = False):
    """OR the bitmap rows of each topic's matched filters (kernel 3).

    sub_bitmaps int32 [Fcap, W] (uint32 bits); matched int32 [B, K] fids
    (-1 holes skipped; every fid must be < Fcap) -> (bitmaps int32 [B, W],
    popcount int32 [B]). The counterpart of `fanout_bitmaps` and
    `popcount32` (emqx_tpu/models/router_model.py:52, :44). `streaming`
    makes the kernel store its output with streaming (evict-first) stores.
    """
    kernels.check_tensor(sub_bitmaps, "sub_bitmaps", torch.int32, 2)
    kernels.check_tensor(matched, "matched", torch.int32, 2)
    if not kernels.on_cuda(sub_bitmaps, matched):
        return fanout_bitmaps_plain(sub_bitmaps, matched)
    B, K = matched.shape
    fcap, W = sub_bitmaps.shape
    dev = matched.device
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    popcount = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.launch("fanout_bitmaps", "emqx_fanout_bitmaps", dev, sub_bitmaps.data_ptr(),
                   fcap, matched.data_ptr(), out.data_ptr(), popcount.data_ptr(), B, K, W,
                   int(streaming))
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
        None,
        B,
        W,
        kslot,
        0,
    )
    return slots, count, overflow


def compact_fanout_slots_shard_plain(bitmaps, kslot: int, lane_base: int):
    """Plain PyTorch twin of `compact_fanout_slots_shard` (any device)."""
    slots, count, overflow = compact_fanout_slots_plain(bitmaps, kslot)
    slots = torch.where(slots >= 0, slots + lane_base, slots)
    return slots, torch.stack([count, overflow.to(torch.int32)])


def compact_fanout_slots_shard(bitmaps, kslot: int, lane_base: int):
    """One 'tp' shard's compaction on a mesh (kernel 4 with a lane base).

    bitmaps int32 [B, W] holds this shard's lane slice; ``lane_base`` =
    tp rank x W x 32. -> (slots int32 [B, kslot], GLOBAL slot ids, -1
    padded; pair int32 [2, B]: the uncapped local count and the local
    overflow as 0/1, one buffer for the 'tp' all-reduce). Replaces the
    dense branch of the mesh builders (emqx_tpu/parallel/mesh.py:372-384):
    `compact_fanout_slots`, then `jnp.where(slots >= 0, slots + off, -1)`,
    in the kernel's one store."""
    kernels.check_tensor(bitmaps, "bitmaps", torch.int32, 2)
    if kslot < 1:
        raise ValueError(f"kslot must be >= 1, got {kslot}")
    B, W = bitmaps.shape
    if lane_base < 0 or lane_base + W * 32 >= 1 << 31:
        raise ValueError(f"lane_base {lane_base} with {W} words leaves int32")
    if not kernels.on_cuda(bitmaps):
        return compact_fanout_slots_shard_plain(bitmaps, kslot, lane_base)
    dev = bitmaps.device
    slots = torch.empty((B, kslot), dtype=torch.int32, device=dev)
    pair = torch.empty((2, B), dtype=torch.int32, device=dev)
    kernels.launch("compact_fanout_slots", "emqx_compact_fanout_slots", dev,
                   bitmaps.data_ptr(), slots.data_ptr(), None, None,
                   pair.data_ptr(), B, W, kslot, lane_base)
    return slots, pair


# -- kernel 10: per-group occurrence rank ------------------------------------


def occurrence_index_plain(flat_gids):
    """Plain PyTorch twin of the `occurrence_index` kernel (any device),
    written after `_occurrence_index` (emqx_tpu/models/router_model.py:885):
    stable argsort, run starts by a cummax, scatter back."""
    n = flat_gids.shape[0]
    dev = flat_gids.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    order = torch.sort(flat_gids, stable=True).indices
    sg = flat_gids[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sg[1:] != sg[:-1]])
    seg_start = torch.cummax(torch.where(new_seg, idx, torch.zeros_like(idx)), 0).values
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[order] = (idx - seg_start).to(torch.int32)
    return out


OCC_SUB = 2048  # lanes of a sub-tile of occurrence_index.cu (its kSub)
# the per-tile count matrix of `occurrence_index` (int32 words) and the
# depth of its scan over tiles: a tile takes more sub-tiles
# (`occurrence_plan`) rather than pass either
OCC_MAX_COUNTS = 1 << 23
OCC_MAX_TILES = 1024


def occurrence_plan(n: int, gcap: int):
    """-> (sub-tiles a tile, tiles, scratch int32 words) of an
    `occurrence_index` call over n lanes of gids below gcap: one tile a
    sub-tile, doubling the sub-tiles a tile while the tiles pass
    `OCC_MAX_TILES` or their count rows (gcap + 1 words, rounded up to 4)
    pass `OCC_MAX_COUNTS`. The kernel checks the scratch against the same
    rule and refuses a call that does not fit."""
    stride = (gcap + 4) & ~3
    subs = -(-n // OCC_SUB)
    sub = 1
    while True:
        tiles = -(-subs // sub)
        if tiles == 1 or (tiles <= OCC_MAX_TILES and tiles * stride <= OCC_MAX_COUNTS):
            return sub, tiles, tiles * stride
        sub *= 2


def occurrence_index(flat_gids, *, gcap: Optional[int] = None, totals: bool = False):
    """occ[i] = #{j < i : g[j] == g[i]} in flat order (kernel 10).

    flat_gids int32 [n] -> int32 [n]. The counterpart of `_occurrence_index`
    (emqx_tpu/models/router_model.py:885): round-robin's per-batch offset
    of each pick from its group's synced base. On CUDA it needs `gcap` and
    launches 3 kernels: the in-tile ranks and per-tile counts of the gids
    in [-1, gcap), their prefix over tiles, and the add
    (`kernels/csrc/occurrence_index.cu`). A gid outside [-1, gcap) is
    ranked exactly too, by the add launch counting its equals among the
    lanes before it (O(n) reads a lane: the path for group tables that
    name a group past their arrays, which a `GroupTable` never uploads).
    On the CPU the twin needs no range and `gcap` is not read.

    With ``totals=True`` it returns ``(occ, totals)``: totals int32
    [gcap] is each group's count of lanes, the `dp_axis` histogram of
    `share_pick_device` (emqx_tpu/models/router_model.py:944-947; a gid
    outside [0, gcap) is not counted), which the prefix launch writes
    from the column totals it already holds (twin: `group_counts_plain`).
    It then needs `gcap` on either device."""
    kernels.check_tensor(flat_gids, "flat_gids", torch.int32, 1)
    n = flat_gids.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"occurrence_index: {n} lanes, at most 2^31 - 1")
    cuda = kernels.on_cuda(flat_gids)
    if (cuda or totals) and (gcap is None or not 0 <= gcap < (1 << 31) - 1):
        raise ValueError(f"occurrence_index on CUDA or with totals needs gcap in "
                         f"[0, 2^31 - 1), got {gcap}")
    if not cuda:
        occ = occurrence_index_plain(flat_gids)
        return (occ, group_counts_plain(flat_gids, gcap)) if totals else occ
    dev = flat_gids.device
    occ = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return (occ, torch.zeros(gcap, dtype=torch.int32, device=dev)) if totals else occ
    tot = torch.empty(gcap, dtype=torch.int32, device=dev) if totals else None
    sub, _tiles, words = occurrence_plan(n, gcap)
    counts = torch.empty(words, dtype=torch.int32, device=dev)
    kernels.launch("occurrence_index", "emqx_occ_count", dev, flat_gids.data_ptr(), n,
                   gcap, sub, counts.data_ptr(), words, occ.data_ptr())
    kernels.launch("occurrence_index", "emqx_occ_scan", dev, n, gcap, sub,
                   counts.data_ptr(), words, tot.data_ptr() if totals else None)
    kernels.launch("occurrence_index", "emqx_occ_add", dev, flat_gids.data_ptr(), n,
                   gcap, sub, counts.data_ptr(), words, occ.data_ptr())
    return (occ, tot) if totals else occ


# -- kernel 9: $share picks ----------------------------------------------------

STRATEGY_IDS = {
    "random": 0,
    "round_robin": 1,
    "sticky": 2,
    "hash_clientid": 3,
    "hash_topic": 4,
}

GROUP_KEYS = ("filter_groups", "group_len", "group_rr", "group_sticky")


def _group_lanes(group_tables, matched):
    """-> (gids [B, K * GPF] with -1 for dead lanes, g = max(gids, 0))."""
    fg = group_tables["filter_groups"]
    B, K = matched.shape
    gpf = fg.shape[1]
    safe = matched.clamp(0, fg.shape[0] - 1).to(torch.int64)
    gids = fg[safe]  # [B, K, GPF]
    valid = (matched >= 0)[:, :, None] & (gids >= 0)
    gids = torch.where(valid, gids, torch.full_like(gids, -1)).reshape(B, K * gpf)
    return gids, gids.clamp(min=0)


def group_counts_plain(gids, gcap: int):
    """Per-group count of live $share lanes, the plain twin of the totals
    of `occurrence_index` (any device): gids int32 (any shape; -1 = no
    group) -> int32 [gcap], a gid at or past gcap dropped. One dp shard's
    histogram of the mesh branch of `share_pick_device`
    (emqx_tpu/models/router_model.py:944-947):
    ``zeros(Gcap).at[max(gids, 0)].add(gids >= 0, mode="drop")``."""
    g = gids.reshape(-1).to(torch.int64)
    g = g[(g >= 0) & (g < gcap)]
    return torch.bincount(g, minlength=gcap)[:gcap].to(torch.int32)


def _dp_check(all_counts, dp_rank: int, gcap: int) -> None:
    kernels.check_tensor(all_counts, "all_counts", torch.int32, 2)
    if all_counts.shape[1] != gcap or not 0 <= dp_rank < all_counts.shape[0] \
            or all_counts.numel() >= 1 << 31:
        raise ValueError(f"all_counts {tuple(all_counts.shape)} against gcap "
                         f"{gcap}, dp rank {dp_rank}")


def share_pick_plain(group_tables, matched, client_hash, topic_hash, rand, *,
                     strategy: int, dp_gather=None, dp_rank: int = 0):
    """Plain PyTorch twin of the `share_pick` kernel (any device), written
    after `share_pick_device` (emqx_tpu/models/router_model.py:904), with
    the mesh branch when `dp_gather` is given (see `share_pick`). uint32
    arithmetic runs in int64 lanes masked to 32 bits (`ops/u32.py`);
    round-robin's int32 sum wraps and its modulo is floored, as jnp's
    ``%``."""
    glen = group_tables["group_len"]
    gids, gsafe = _group_lanes(group_tables, matched)
    gi = gsafe.clamp(max=glen.shape[0] - 1).to(torch.int64)
    lens = glen[gi]
    denom = lens.clamp(min=1).to(torch.int64)
    g32 = gsafe.to(torch.int64)
    if strategy == 1:  # round_robin: per-batch occurrence + synced base
        occ = occurrence_index_plain(gids.reshape(-1)).reshape(gids.shape).to(torch.int64)
        if dp_gather is not None:
            gcap = glen.shape[0]
            all_c = dp_gather(group_counts_plain(gids, gcap))
            _dp_check(all_c, dp_rank, gcap)
            prev = all_c[:dp_rank].to(torch.int64).sum(dim=0)
            occ = occ + prev[gi]
        a = group_tables["group_rr"][gi].to(torch.int64) + occ
        a = ((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # int32 wrap-around
        idx = torch.remainder(a, denom)
    elif strategy == 2:  # sticky: stored index, random fallback
        st = group_tables["group_sticky"][gi]
        fallback = (u32(rand)[:, None] ^ g32) % denom
        idx = torch.where((st >= 0) & (st < lens), st.to(torch.int64), fallback)
    elif strategy == 3:  # hash_clientid
        idx = u32(client_hash)[:, None] % denom
    elif strategy == 4:  # hash_topic
        idx = u32(topic_hash)[:, None] % denom
    else:  # random: per-message entropy decorrelated across groups
        mixed = mul32(u32(rand), 2654435761)[:, None] ^ g32
        idx = mixed % denom
    ok = (gids >= 0) & (lens > 0)
    minus = torch.full_like(gids, -1)
    return torch.where(ok, gids, minus), torch.where(ok, idx.to(torch.int32), minus)


def share_pick(group_tables, matched, client_hash, topic_hash, rand, *,
               strategy: int, dp_gather=None, dp_rank: int = 0):
    """Resolve $share picks (kernel 9; round_robin also runs kernel 10).

    group_tables: the four `GROUP_KEYS` int32 tensors (`GroupTable`'s
    snapshot, uploaded); matched int32 [B, K] fids; client_hash, topic_hash
    and rand int32 [B] (uint32 bits), read only by the strategies that use
    them. Returns (pick_gid [B, K * GPF], pick_idx [B, K * GPF]) int32, -1
    holes: per live group lane, the member index the strategy picks. The
    counterpart of `share_pick_device` (emqx_tpu/models/router_model.py:904)
    with `dp_axis=None`.

    On CUDA, round_robin launches the pick kernel twice: first for the raw
    group lanes, whose per-group ranks `occurrence_index` computes, then
    for the picks, which reads those lanes back from ``pick_gid``. The
    kernel indexes in 32 bits: B x K x GPF and Fcap x GPF at or past 2^31
    raise, on either device. A `filter_groups` gid at or past Gcap (raw
    tables only: a `GroupTable` grows Gcap with its gids) picks as JAX
    does on either device: its member count, base and sticky index are
    group Gcap - 1's (JAX's gathers clamp), and round robin ranks it
    among the lanes of the same gid (`occurrence_index`'s exact path).

    The mesh branch (``dp_axis``, emqx_tpu/models/router_model.py:942-962):
    with the batch split over 'dp', ``dp_gather`` maps this shard's
    per-group lane counts int32 [Gcap] to every dp rank's, [dp, Gcap] (an
    all-gather over 'dp'), and ``dp_rank`` is this shard's rank. Under
    round_robin the counts are the totals of the `occurrence_index` call
    over the raw lanes (no launch of their own), and the pick launch adds
    the counts of the lower ranks to each lane's occurrence, so the picks
    equal the single-device picks of the whole batch. Other strategies ignore both."""
    for k in GROUP_KEYS:
        kernels.check_tensor(group_tables[k], k, torch.int32,
                             2 if k == "filter_groups" else 1)
    kernels.check_tensor(matched, "matched", torch.int32, 2)
    gcap = group_tables["group_len"].shape[0]
    if any(group_tables[k].shape[0] != gcap for k in ("group_rr", "group_sticky")):
        raise ValueError("group_len, group_rr and group_sticky must be one length")
    B, K = matched.shape
    for name, t in (("client_hash", client_hash), ("topic_hash", topic_hash),
                    ("rand", rand)):
        kernels.check_tensor(t, name, torch.int32, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name}: expected [{B}], got {tuple(t.shape)}")
    fcap, gpf = group_tables["filter_groups"].shape
    if fcap < 1 or gcap < 1:
        raise ValueError(f"share_pick: empty group tables (Fcap {fcap}, Gcap {gcap})")
    if B * K * gpf >= 1 << 31 or fcap * gpf >= 1 << 31:
        raise ValueError(f"share_pick: B x K x GPF ({B * K * gpf}) and Fcap x GPF "
                         f"({fcap * gpf}) must stay below 2^31 (32-bit lane indices)")
    if not kernels.on_cuda(matched, client_hash, topic_hash, rand,
                           *(group_tables[k] for k in GROUP_KEYS)):
        return share_pick_plain(group_tables, matched, client_hash, topic_hash,
                                rand, strategy=strategy, dp_gather=dp_gather,
                                dp_rank=dp_rank)
    fg = group_tables["filter_groups"]
    glen = group_tables["group_len"]
    dev = matched.device
    pick_gid = torch.empty((B, K * gpf), dtype=torch.int32, device=dev)
    pick_idx = torch.empty((B, K * gpf), dtype=torch.int32, device=dev)

    def run(occ_ptr, phase, all_c=None):
        kernels.launch(
            "share_pick", "emqx_share_pick", dev,
            fg.data_ptr(), fcap, gpf, glen.data_ptr(),
            group_tables["group_rr"].data_ptr(),
            group_tables["group_sticky"].data_ptr(), glen.shape[0],
            matched.data_ptr(), occ_ptr, client_hash.data_ptr(),
            topic_hash.data_ptr(), rand.data_ptr(), pick_gid.data_ptr(),
            pick_idx.data_ptr(), B, K, strategy, phase,
            all_c.data_ptr() if all_c is not None else None, dp_rank,
        )

    occ = all_c = None
    if strategy == 1:
        run(None, 0)  # the raw group lanes, into pick_gid
        if dp_gather is None:
            occ = occurrence_index(pick_gid.reshape(-1), gcap=gcap)
        else:
            occ, counts = occurrence_index(pick_gid.reshape(-1), gcap=gcap, totals=True)
            all_c = dp_gather(counts).contiguous()
            _dp_check(all_c, dp_rank, gcap)
    run(occ.data_ptr() if occ is not None else None, 1, all_c)
    return pick_gid, pick_idx


# -- the composites ----------------------------------------------------------


def route_step(
    tables: Dict[str, torch.Tensor],
    sub_bitmaps,
    bytes_mat,
    lengths,
    *,
    salt: int,
    max_levels: int = 16,
    frontier: int = 32,
    max_matches: int = 64,
    probes: int = MAX_PROBES,
    kslot: int = 0,
    kg: int = 0,
    device="cuda",
):
    """The NFA-only serving step: tokenize -> vocab lookup -> NFA walk ->
    fan-out (-> compact). The counterpart of `route_step_impl`
    (emqx_tpu/models/router_model.py:130, contract `route_step` :210),
    built from the kernels of rows 1, 3-6 and 9; it has no kernel of its
    own.

    `tables` holds the NFA tables (`NFA_TABLE_KEYS`, an `NfaBuilder`'s
    snapshot uploaded) on `device`; `sub_bitmaps` is the dense int32
    [Fcap, W] matrix (every matched fid < Fcap) or a dict of the five
    `CSR_KEYS` arrays. bytes_mat uint8 [B, MB] and lengths int32 [B]
    (numpy or tensors) as `encode_topics` makes them.

    Dense: `fanout_bitmaps`, then with ``kslot > 0`` `compact_fanout_slots`.
    CSR: `sparse_fanout_slots` (kslot must be > 0; ``kg`` its gather
    window, 0 = 2 * kslot), and ``bitmaps`` is None. Returns {matched
    [B, K], mcount [B] (capped at K), flags [B], bitmaps [B, W] or None,
    stats {routed, matches, fanout_bits}} and, with compaction, slots
    [B, kslot], slot_count [B], overflow [B]."""
    dev = resolve_device(device)
    sparse = isinstance(sub_bitmaps, dict)
    subs = list(sub_bitmaps.values()) if sparse else [sub_bitmaps]
    for t in list(tables.values()) + subs:
        if t.device != dev:
            raise ValueError(f"a table lies on {t.device}, not {dev}")
    bytes_mat = torch.as_tensor(bytes_mat, dtype=torch.uint8, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    matched, mcount, flags, _causes = batch_match_bytes(
        tables, bytes_mat, lengths, salt=salt, max_levels=max_levels,
        frontier=frontier, max_matches=max_matches, probes=probes,
    )
    sub = {k: sub_bitmaps[k] for k in CSR_KEYS} if sparse else sub_bitmaps
    return _with_fanout(matched, mcount, flags, sub, kslot, kg, dev)


def _with_fanout(matched, mcount, flags, sub, kslot: int, kg: int, dev) -> dict:
    """The fan-out half both composites share, as `route_step_impl` and
    `shape_route_step_impl` share theirs: `sub` a dict of the `CSR_KEYS`
    arrays (`sparse_fanout_slots`, straight to compact slots), a dense
    [Fcap, W] matrix (`fanout_bitmaps`, then `compact_fanout_slots` with
    ``kslot > 0``), or None (match-only: no fan-out runs). -> the step's
    output dict with its stats."""
    compact = None
    if isinstance(sub, dict):
        bitmaps = None
        *compact, live = sparse_fanout_slots(sub, matched, kslot=kslot, kg=kg)
        fanout_bits = live.sum()
    elif sub is not None:
        bitmaps, popcount = fanout_bitmaps(sub, matched)
        fanout_bits = popcount.sum()
        if kslot > 0:
            compact = compact_fanout_slots(bitmaps, kslot)
    else:
        bitmaps = None
        fanout_bits = torch.zeros((), dtype=torch.int32, device=dev)
    out = {
        "matched": matched,
        "mcount": mcount,
        "flags": flags,
        "bitmaps": bitmaps,
        "stats": {
            "routed": (mcount > 0).sum(),
            "matches": mcount.sum(),
            "fanout_bits": fanout_bits,
        },
    }
    if compact is not None:
        out["slots"], out["slot_count"], out["overflow"] = compact
    return out


def shape_route_step(
    tables: Dict[str, torch.Tensor],
    bytes_mat,
    lengths,
    *,
    m_active: int,
    salt: int,
    nfa_tables: Optional[Dict[str, torch.Tensor]] = None,
    with_nfa: bool = False,
    group_tables: Optional[Dict[str, torch.Tensor]] = None,
    client_hash=None,
    topic_hash=None,
    rand=None,
    with_groups: bool = False,
    share_strategy: int = 0,
    max_levels: int = 16,
    frontier: int = 32,
    max_matches: int = 64,
    probes: int = MAX_PROBES,
    kslot: int = 0,
    kg: int = 0,
    sem_tables: Optional[Dict[str, torch.Tensor]] = None,
    q_vecs=None,
    sem_topk: int = 0,
    rule_progs: tuple = (),
    rule_feats=None,
    rule_valid=None,
    dp_gather=None,
    dp_rank: int = 0,
    device="cuda",
):
    """The serving step: tokenize -> shape match (-> residual NFA) ->
    fan-out (-> compact) (-> semantic stage) (-> rule masks) (-> $share
    picks).

    The counterpart of `shape_route_step_impl`
    (emqx_tpu/models/router_model.py:225). `tables` holds the shape tables on `device` plus the subscriber
    table: ``sub_bitmaps`` (dense; `convert.tables_to_device`) or the five
    `CSR_KEYS` arrays (sparse), as the `DeviceRouter` mirrors hold them.
    bytes_mat uint8 [B, MB] and lengths int32 [B] (numpy or tensors) as
    `encode_topics` makes them. ``with_nfa`` runs the residual lane over
    `nfa_tables` (`NfaBuilder.device_snapshot()` uploaded): the topics'
    word hashes become symbols (`vocab_lookup`) and walk the NFA
    (`batch_match_syms`), whose K = `max_matches` columns join the shape
    lane's M and whose flags join the row flags.

    Dense: `fanout_bitmaps` ORs the rows, and with ``kslot > 0``
    `compact_fanout_slots` lists them. CSR: `sparse_fanout_slots` (kslot
    must be > 0; ``kg`` is its gather window, 0 = 2 * kslot) emits the same
    compact outputs directly and ``bitmaps`` is None. Match-only (`tables`
    hold neither, as for a retained storm's filter table): no fan-out runs,
    ``bitmaps`` is None and no slots are returned whatever ``kslot`` is,
    as the JAX step does with ``sub_bitmaps=None``. ``with_groups`` runs
    `share_pick` over `group_tables` (`GroupTable`'s snapshot uploaded)
    with strategy ``share_strategy`` (`STRATEGY_IDS`) and the per-row
    client_hash / topic_hash / rand (uint32 bits, [B]); on a mesh shard,
    ``dp_gather`` and ``dp_rank`` make its round-robin picks globally exact
    (`share_pick`'s mesh branch).

    ``sem_tables`` (the `SEM_KEYS` tensors of a `SemanticTable` mirror)
    runs the semantic stage over ``q_vecs`` f32 [B, D] after the compact
    stage, which it needs (kslot > 0 and a subscriber table, else
    ValueError, as in JAX): `semantic_route_stage` widens ``slots`` to
    [B, kslot + sem_topk] with the deduplicated winners and adds
    ``sem_count`` [B], the uncapped qualifying count; ``slot_count`` and
    ``overflow`` keep their topic-only meaning. ``rule_progs`` (compiled
    WHERE programs, `rules.compile.compile_where`) adds ``rule_masks``
    bool [R, B] over ``rule_feats`` f32 / ``rule_valid`` bool [B, F].

    Returns {matched [B, M (+ K)] (sparse, -1 holes), mcount [B], flags [B]
    (too deep or NFA overflow: the host must route the row), bitmaps
    [B, W] or None, stats {routed, matches, fanout_bits}}; with
    ``kslot > 0`` (always, for CSR) also slots [B, kslot], slot_count [B]
    and overflow [B]; with ``with_groups`` also pick_gid / pick_idx
    [B, (M (+ K)) * GPF]; with ``sem_tables`` sem_count [B]; with
    ``rule_progs`` rule_masks [R, B].
    """
    dev = resolve_device(device)
    if with_nfa and nfa_tables is None:
        raise ValueError("with_nfa needs nfa_tables")
    if with_groups and group_tables is None:
        raise ValueError("with_groups needs group_tables")
    extra = (list((nfa_tables or {}).items()) + list((group_tables or {}).items())
             + list((sem_tables or {}).items()))
    for k, t in list(tables.items()) + extra:
        if t.device != dev:
            raise ValueError(f"table {k} lies on {t.device}, not {dev}")
    sparse = "csr_slots" in tables
    dense = "sub_bitmaps" in tables
    if sparse and dense:
        raise ValueError("tables hold both a dense and a CSR subscriber table")
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
    # match-only: no subscriber table, no fan-out half
    sub = ({k: tables[k] for k in CSR_KEYS} if sparse
           else tables["sub_bitmaps"] if dense else None)
    out = _with_fanout(matched, mcount, flags, sub, kslot, kg, dev)
    if sem_tables is not None:
        if "slots" not in out:
            raise ValueError(
                "semantic routing requires the compact fan-out stage "
                "(kslot > 0 and a subscriber table)"
            )
        q = torch.as_tensor(q_vecs, dtype=torch.float32, device=dev).contiguous()
        out["slots"], out["sem_count"] = semantic_route_stage(
            {k: sem_tables[k] for k in SEM_KEYS}, q, matched, sem_topk, out["slots"]
        )
    if rule_progs:
        out["rule_masks"] = eval_rule_masks(
            rule_progs,
            torch.as_tensor(rule_feats, dtype=torch.float32, device=dev).contiguous(),
            torch.as_tensor(rule_valid, dtype=torch.bool, device=dev).contiguous(),
        )
    if with_groups:
        B = matched.shape[0]
        out["pick_gid"], out["pick_idx"] = share_pick(
            group_tables, matched,
            *(_u32_rows(v, B, dev) for v in (client_hash, topic_hash, rand)),
            strategy=share_strategy, dp_gather=dp_gather, dp_rank=dp_rank,
        )
    return out


def _u32_rows(v, B: int, dev) -> torch.Tensor:
    """A per-row uint32 pick input (numpy, tensor or None = zeros) -> its
    int32 bits on `dev`."""
    if v is None:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.uint32)).view(np.int32))
    return v.to(device=dev, dtype=torch.int32).contiguous()


# -- host tables: $share groups and subscribers -------------------------------


class GroupTable:
    """$share groups as device lane segments: the port's copy of
    `GroupTable` (emqx_tpu/models/router_model.py:715).

    Host registry mapping (real filter, group name) -> gid, mirrored on
    device as:
      ``filter_groups [Fcap, GPF]`` int32 — group ids per filter (-1 pad)
      ``group_len     [Gcap]``      int32 — member count per group
      ``group_rr      [Gcap]``      int32 — round-robin base (synced once
                                            per batch, not per message)
      ``group_sticky  [Gcap]``      int32 — sticky member index (-1 unset)

    The kernel picks a member INDEX per (topic, group); the host resolves
    index -> member and keeps only ack/retry failover. Same epoch / op-log /
    `device_snapshot` contract as `SubscriberTable`.
    """

    def __init__(self, gpf: int = 4):
        self.gpf = gpf
        self._fcap = 64
        self._gcap = 64
        self.filter_groups = np.full((self._fcap, self.gpf), -1, np.int32)
        self.group_len = np.zeros(self._gcap, np.int32)
        self.group_rr = np.zeros(self._gcap, np.int32)
        self.group_sticky = np.full(self._gcap, -1, np.int32)
        self._gids: Dict = {}  # (real, gname) -> gid
        self._info: Dict[int, tuple] = {}  # gid -> (real, gname)
        self._free: List[int] = []
        self._next_gid = 0
        self.epoch = 0
        self.oplog: list = []
        self.version = 0
        self.OPLOG_MAX = 65536

    def _bump(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _log(self, name: str, flat_idx: int, val: int) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump()
            return
        self.oplog.append((name, flat_idx, val))

    def _grow_fcap(self, need: int) -> None:
        nf = max(self._fcap, _next_pow2(need))
        if nf != self._fcap:
            new = np.full((nf, self.gpf), -1, np.int32)
            new[: self._fcap] = self.filter_groups
            self.filter_groups = new
            self._fcap = nf
            self._bump()

    def _grow_gpf(self) -> None:
        new = np.full((self._fcap, self.gpf * 2), -1, np.int32)
        new[:, : self.gpf] = self.filter_groups
        self.filter_groups = new
        self.gpf *= 2
        self._bump()

    def _grow_gcap(self) -> None:
        ng = self._gcap * 2
        for name in ("group_len", "group_rr", "group_sticky"):
            arr = getattr(self, name)
            fill = -1 if name == "group_sticky" else 0
            new = np.full(ng, fill, arr.dtype)
            new[: self._gcap] = arr
            setattr(self, name, new)
        self._gcap = ng
        self._bump()

    # -- membership ---------------------------------------------------------
    def ensure_group(self, fid: int, real: str, gname: str) -> int:
        key = (real, gname)
        gid = self._gids.get(key)
        if gid is not None:
            return gid
        if self._free:
            gid = self._free.pop()
        else:
            gid = self._next_gid
            self._next_gid += 1
        while gid >= self._gcap:
            self._grow_gcap()
        self._gids[key] = gid
        self._info[gid] = key
        # reset through the log so a recycled gid's device row resets too
        for name, val in (
            ("group_len", 0),
            ("group_rr", 0),
            ("group_sticky", -1),
        ):
            getattr(self, name)[gid] = val
            self._log(name, gid, val)
        self._grow_fcap(fid + 1)
        row = self.filter_groups[fid]
        slot = int(np.argmax(row < 0)) if (row < 0).any() else -1
        if slot < 0 or row[slot] >= 0:
            self._grow_gpf()
            row = self.filter_groups[fid]
            slot = int(np.argmax(row < 0))
        self.filter_groups[fid, slot] = gid
        self._log("filter_groups", fid * self.gpf + slot, gid)
        return gid

    def set_len(self, gid: int, n: int) -> None:
        if self.group_len[gid] != n:
            self.group_len[gid] = n
            self._log("group_len", gid, n)

    def set_rr(self, gid: int, v: int) -> None:
        v &= 0x7FFFFFFF
        if self.group_rr[gid] != v:
            self.group_rr[gid] = v
            self._log("group_rr", gid, v)

    def set_sticky(self, gid: int, idx: int) -> None:
        if self.group_sticky[gid] != idx:
            self.group_sticky[gid] = idx
            self._log("group_sticky", gid, idx)

    def repin(self, gid: int, member_sids, sticky_sid) -> None:
        """Recompute the device sticky index from the pinned sid (the ONE
        place the sid->index mapping convention lives; membership changes
        shift indices, so a raw index cannot be kept)."""
        sids = list(member_sids)
        if sticky_sid in sids:
            self.set_sticky(gid, sids.index(sticky_sid))
        else:
            self.set_sticky(gid, -1)

    def drop_group(self, fid: int, real: str, gname: str) -> None:
        gid = self._gids.pop((real, gname), None)
        if gid is None:
            return
        self._info.pop(gid, None)
        self._free.append(gid)
        self.group_len[gid] = 0
        self._log("group_len", gid, 0)
        if fid < self._fcap:
            row = self.filter_groups[fid]
            for slot in np.nonzero(row == gid)[0]:
                self.filter_groups[fid, slot] = -1
                self._log("filter_groups", fid * self.gpf + int(slot), -1)

    def gid_of(self, real: str, gname: str):
        return self._gids.get((real, gname))

    def info(self, gid: int):
        return self._info.get(gid)

    def pack_fcap(self, filter_capacity: int) -> None:
        if filter_capacity > self._fcap:
            self._grow_fcap(filter_capacity)

    def device_snapshot(self):
        return {
            "filter_groups": self.filter_groups,
            "group_len": self.group_len,
            "group_rr": self.group_rr,
            "group_sticky": self.group_sticky,
        }

    def __len__(self) -> int:
        return len(self._gids)


def _popcount_u32(arr: np.ndarray) -> int:
    """Total set bits of a uint32 array (chunked: no 8x byte blowup)."""
    bc = getattr(np, "bitwise_count", None)
    if bc is not None:
        return int(bc(arr).sum())
    total = 0
    flat = arr.reshape(-1).view(np.uint8)
    step = 1 << 22
    for lo in range(0, len(flat), step):
        total += int(np.unpackbits(flat[lo : lo + step]).sum())
    return total


class SubscriberTable:
    """Host-side registry: (filter id, subscriber slot) -> fan-out state, in
    one of TWO device representations behind one mutation interface. The
    port's copy of `SubscriberTable` (emqx_tpu/models/router_model.py:998),
    single device:

    - **dense**: a ``sub_bitmaps [Fcap, W]`` uint32 matrix — O(Fcap * W)
      memory, one gather+OR per batch row;
    - **sparse** (`ops/csr_table.py`): per-fid CSR slot lists — O(total
      subscriptions) memory.

    ``mode`` is the representation policy: ``dense`` pins the matrix,
    ``sparse`` converts at once, and ``auto`` starts dense and flips ONCE
    (checked at growth events) when the matrix passes
    `AUTO_MIN_DENSE_BYTES` and exceeds `AUTO_RATIO` x the estimated CSR
    footprint. A flip is an ordinary epoch bump on the SAME object: the
    router's mirror sees a full resync with the other representation's
    arrays. Both representations op-log their scalar writes (flat index)
    so `DeviceSegmentManager` replays churn as O(delta) scatters.
    """

    AUTO_MIN_DENSE_BYTES = 8 << 20  # don't bother below 8MB dense
    AUTO_RATIO = 2.0  # flip when dense > ratio x estimated CSR bytes

    def __init__(self, max_subscribers: int = 1024, mode: str = "dense",
                 shards: int = 1):
        self.width_words = max(2, _next_pow2((max_subscribers + 31) // 32))
        self._fcap = 64
        self.arr = np.zeros((self._fcap, self.width_words), dtype=np.uint32)
        self.epoch = 0
        self.oplog: list = []  # (name, flat_idx, value)
        self.version = 0
        self.OPLOG_MAX = 65536
        self.mode = "dense"
        self.shards = max(1, int(shards))
        self._sp: Optional[CsrTable] = None  # the sparse rep when active
        self.live = 0  # live subscriptions (both reps; drives the policy)
        self.flips = 0
        if mode != "dense":
            self.set_mode(mode)

    # -- op-log plumbing (shared by both representations) ------------------
    def _bump_epoch(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _log_any(self, name: str, flat_idx: int, val: int) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        self.oplog.append((name, int(flat_idx), int(val)))

    def _log_resync(self, name: str) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        self.oplog.append((RESYNC, name, 0))

    def _log(self, fid: int, w: int, val: int) -> None:
        self._log_any("sub_bitmaps", fid * self.width_words + w, val)

    # -- representation policy ---------------------------------------------
    @property
    def sparse(self) -> bool:
        return self._sp is not None

    @property
    def csr(self) -> Optional[CsrTable]:
        return self._sp

    def set_mode(self, mode: str) -> None:
        """Pin the representation policy; converts immediately when the
        pinned representation differs from the live one."""
        if mode not in ("auto", "dense", "sparse"):
            raise ValueError(f"sub_table mode {mode!r}")
        self.mode = mode
        if mode == "sparse" and self._sp is None:
            self._flip_sparse()
        elif mode == "dense" and self._sp is not None:
            self._flip_dense()

    def set_shards(self, shards: int) -> None:
        """Partition count for the mesh placement ('tp' slices of the CSR
        slot column). Re-shards a live sparse table (epoch bump). The dense
        matrix has no shard axis: its lanes split over 'tp' at upload."""
        shards = max(1, int(shards))
        if shards == self.shards:
            return
        self.shards = shards
        if self._sp is not None:
            self._sp.reshard(shards)

    def _csr_estimate(self) -> int:
        """Estimated CSR footprint: 4B slot column + 2 x 4B region lanes
        per fid + the hot segment floor."""
        return 16 * max(self.live, 1) + 8 * self._fcap + 8192

    def _maybe_flip(self) -> None:
        """Auto policy, checked only at dense growth events (the only times
        the answer can change): flip when occupancy x width says the matrix
        is mostly zeros AND it is big enough to matter."""
        if self.mode != "auto" or self._sp is not None:
            return
        dense_bytes = self.arr.nbytes
        if dense_bytes < self.AUTO_MIN_DENSE_BYTES:
            return
        if dense_bytes > self.AUTO_RATIO * self._csr_estimate():
            self._flip_sparse()

    def _mk_csr(self) -> CsrTable:
        return CsrTable(
            shards=self.shards,
            log=self._log_any,
            log_resync=self._log_resync,
            bump=self._bump_epoch,
        )

    def _flip_sparse(self) -> None:
        """dense -> CSR: expand the live bits (vectorized), build the
        exact-size CSR + registry, drop the matrix. One epoch bump."""
        rows, words = np.nonzero(self.arr)
        if len(rows):
            vals = self.arr[rows, words]
            bits = (
                (vals[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool)
            e_idx, e_bit = np.nonzero(bits)
            fids = rows[e_idx].astype(np.int64)
            slots = words[e_idx].astype(np.int64) * 32 + e_bit
        else:
            fids = slots = np.empty(0, np.int64)
        sp = self._mk_csr()
        built = CsrTable._build(fids, slots, sp.shards, self._fcap)
        sp._install(built)
        sp.max_slot = max(
            sp.max_slot, self.width_words * 32 - 1 if len(rows) else -1
        )
        self._sp = sp
        self.arr = None  # the matrix is gone — that is the point
        self.live = built["n"]
        self.flips += 1
        self._bump_epoch()

    def _flip_dense(self) -> None:
        """CSR -> dense (the degrade fallback / explicit pin)."""
        sp = self._sp
        fids, slots = sp.live_pairs()
        self._sp = None
        nf = max(64, _next_pow2(int(fids.max()) + 1 if len(fids) else 1))
        nw = max(
            self.width_words,
            _next_pow2((int(slots.max()) // 32 + 1) if len(slots) else 2),
        )
        self._fcap, self.width_words = nf, nw
        self.arr = np.zeros((nf, nw), np.uint32)
        if len(fids):
            w = slots // 32
            bits = (np.uint32(1) << (slots % 32).astype(np.uint32)).astype(
                np.uint32
            )
            np.bitwise_or.at(self.arr, (fids, w), bits)
        self.live = len(fids)
        self.flips += 1
        self._bump_epoch()

    # -- mutation (mode-dispatched) ----------------------------------------
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
            self._maybe_flip()

    def _track_width(self, slot: int) -> None:
        # readers size dense fallback rows from width_words; keep it
        # covering the slot universe in sparse mode too
        need_w = _next_pow2(slot // 32 + 1)
        if need_w > self.width_words:
            self.width_words = need_w

    def add(self, filter_id: int, slot: int) -> None:
        if self._sp is not None:
            if self._sp.add(filter_id, slot):
                self.live += 1
            self._fcap = max(self._fcap, self._sp._fcap)
            self._track_width(slot)
            return
        self._ensure(filter_id, slot)
        if self._sp is not None:  # _ensure's growth flipped the rep
            return self.add(filter_id, slot)
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
        if self._sp is not None:
            self._sp.bulk_add(fids, slots)
            self.live = self._sp.live
            self._fcap = max(self._fcap, self._sp._fcap)
            self._track_width(int(slots.max()))
            return
        self._ensure(int(fids.max()), int(slots.max()))
        if self._sp is not None:
            return self.bulk_add(fids, slots)
        w = slots // 32
        bits = (np.uint32(1) << (slots % 32).astype(np.uint32)).astype(
            np.uint32
        )
        np.bitwise_or.at(self.arr, (fids, w), bits)
        self.live = _popcount_u32(self.arr)
        self._bump_epoch()
        self._maybe_flip()

    def remove(self, filter_id: int, slot: int) -> None:
        if self._sp is not None:
            if self._sp.remove(filter_id, slot):
                self.live -= 1
            return
        if filter_id >= self._fcap or slot // 32 >= self.width_words:
            return
        w = slot // 32
        bit = np.uint32(1 << (slot % 32))
        if self.arr[filter_id, w] & bit:
            self.live -= 1
        self.arr[filter_id, w] &= np.uint32(~bit & 0xFFFFFFFF)
        self._log(filter_id, w, int(self.arr[filter_id, w]))

    def pack(self, filter_capacity: int):
        """Grow to cover `filter_capacity` filter rows. Dense mode returns
        the live matrix (a view — valid until the next mutation); sparse
        mode returns None (there is no matrix)."""
        if self._sp is not None:
            # serve-time hot bound: a storm of adds with no background
            # compactor must not hand the kernel a giant hot scan
            self._sp.maybe_absorb()
            self._sp.pack(filter_capacity)
            self._fcap = max(self._fcap, self._sp._fcap)
            return None
        if filter_capacity > self._fcap:
            self._ensure(filter_capacity - 1, 0)
            if self._sp is not None:
                self._sp.pack(filter_capacity)
                return None
        return self.arr

    def device_snapshot(self):
        if self._sp is not None:
            return self._sp.device_snapshot()
        return {"sub_bitmaps": self.arr}

    # -- introspection -------------------------------------------------------
    def fill_row_bits(self, fid: int, row: np.ndarray) -> None:
        """OR one fid's subscriber bits into a uint32 bitmap row — the
        host-built dense fallback for sparse overflow rows, read from the
        LIVE table."""
        if self._sp is not None:
            slots = self._sp.slots_of(fid)
            slots = slots[slots < len(row) * 32]
            if len(slots):
                np.bitwise_or.at(
                    row,
                    slots // 32,
                    (np.uint32(1) << (slots % 32).astype(np.uint32)).astype(
                        np.uint32
                    ),
                )
            return
        if fid < self._fcap:
            n = min(len(row), self.width_words)
            row[:n] |= self.arr[fid, :n]

    def table_bytes(self) -> int:
        """Device-table footprint of the ACTIVE representation."""
        if self._sp is not None:
            return self._sp.nbytes
        return int(self.arr.nbytes)

    def status(self) -> Dict:
        """Mode, bytes, fill and tombstones: the app's `router.sparse.*`
        gauges (emqx_tpu/models/router_model.py:1303)."""
        out = {
            "mode": "sparse" if self._sp is not None else "dense",
            "policy": self.mode,
            "bytes": self.table_bytes(),
            "subscriptions": self.live,
            "width_words": self.width_words,
            "fcap": self._fcap,
            "flips": self.flips,
            "shards": self.shards,
        }
        if self._sp is not None:
            sp = self._sp
            out["csr_fill"] = sp.live
            out["csr_tombstones"] = sp.packed_tombs + sp.hot_tombs
            out["hot_fill"] = sp.hot_fill
            out["max_region"] = sp.max_region
        return out


class RouteResult(NamedTuple):
    """Host-side outputs of one routed batch (all numpy, device-free).

    Exactly ONE of the fan-out encodings is populated per row:

    - compact path (``slots is not None`` and not ``overflow[i]``):
      ``slots[i]`` holds the row's subscriber slot ids (-1 holes allowed
      anywhere: the CSR path sets duplicates to -1 where they stand);
    - dense path: ``bitmaps[i]`` (compaction off) or
      ``dense_rows[dense_index[i]]`` (compaction on, row overflowed the
      kslot cap — the masked second copy of the dense table, or, for a
      CSR table, a row built from the host table on access, for which
      nothing crossed the link).

    ``picks`` is (pick_gid, pick_idx) [B, P] when the router has a group
    table. ``readback_bytes`` is the device->host transfer this batch paid.
    ``retained`` is the decoded {filter: row-index array} of a retained
    storm that rode the batch (`route_prepared(..., retained=job)`).
    ``session`` holds the outputs of a session rider's stage
    (`route_prepared(..., session=rider)`): the updated lanes, which stay
    on the device, and the sweep lists and counts, read back with the rest.
    With a live semantic table, ``slots`` is [B, kslot + topk] (the
    semantic winners after the topic slots, -1 where deduplicated) and
    ``sem_count`` [B] the uncapped number of qualifying entries;
    ``rule_masks`` is bool [R, B] when compiled rules rode the batch.
    """

    matched: np.ndarray  # [B, M (+ K)] sparse fids, -1 holes
    mcount: np.ndarray  # [B]
    flags: np.ndarray  # [B] host-must-fallback rows
    bitmaps: Optional[np.ndarray]  # [B, W] uint32 (None on compact path)
    picks: Optional[tuple] = None  # (pick_gid [B, P], pick_idx [B, P])
    slots: Optional[np.ndarray] = None  # [B, kslot] int32, -1 pad
    slot_count: Optional[np.ndarray] = None  # [B] total set bits (uncapped)
    overflow: Optional[np.ndarray] = None  # [B] bool: fanout > kslot
    dense_rows: Optional[object] = None  # [n_overflow, W] uint32 rows
    dense_index: Optional[Dict[int, int]] = None  # batch row -> dense_rows row
    readback_bytes: int = 0
    retained: Optional[Dict[str, np.ndarray]] = None  # fused storm's rows
    session: Optional[SessionStepOut] = None  # fused session stage
    sem_count: Optional[np.ndarray] = None  # [B] qualifying semantic entries
    rule_masks: Optional[np.ndarray] = None  # [R, B] bool compiled WHERE masks


class _LazyDenseRows:
    """Dense fallback rows for SPARSE overflow rows, built on demand: the
    port's copy of `_LazyDenseRows` (emqx_tpu/models/router_model.py:1371).

    The CSR path has no device bitmap matrix to gather overflow rows from,
    so the fallback unions the row's matched fids' slot lists from the
    HOST table instead. Construction stores only the fid lists; the union
    runs at `__getitem__` time, on the thread that owns the table.
    Duck-types the `dense_rows[j]` indexing of the device-gathered
    overflow contract; nothing crossed the link for these rows."""

    __slots__ = ("subtab", "fid_lists")

    def __init__(self, subtab, fid_lists):
        self.subtab = subtab
        self.fid_lists = fid_lists

    def __len__(self) -> int:
        return len(self.fid_lists)

    def __getitem__(self, j: int) -> np.ndarray:
        row = np.zeros(self.subtab.width_words, np.uint32)
        for fid in self.fid_lists[j]:
            self.subtab.fill_row_bits(int(fid), row)
        return row


# floor for the auto-sized compact-slot cap: below this the slot list is
# cheaper than the bookkeeping either way, and a tiny cap would overflow
# constantly while the fanout histogram warms up
KSLOT_MIN = 64


class Prepared(NamedTuple):
    """Immutable device state of one `DeviceRouter.prepare()`: the tensors
    hold one generation of the mirrors, which a later sync never writes."""

    # shape tables + the subscriber table ("sub_bitmaps", or CSR_KEYS)
    tables: Dict[str, torch.Tensor]
    nfa_tables: Optional[Dict[str, torch.Tensor]]  # None: no residual filters
    salt: int
    m_active: int
    kslot: int
    group_tables: Optional[Dict[str, torch.Tensor]] = None  # None: no groups
    # the semantic mirror and its top-k; None: no live semantic table
    sem_tables: Optional[Dict[str, torch.Tensor]] = None
    sem_topk: int = 0
    kg: int = 0  # the CSR gather window (`MatcherConfig.sparse_gather`)


class DeviceRouter:
    """Serving-path engine on one device: owns the device mirrors of the
    shape index, the residual NFA, the subscriber table, the $share group
    table and the semantic table, and runs `shape_route_step` over host
    batches. The counterpart of `DeviceRouter`
    (emqx_tpu/models/router_model.py:1413), single device.

    Each host table is mirrored by its own `DeviceSegmentManager`
    (`_shape_sync`, `_nfa_sync`, `_bits_sync`, `_group_sync`,
    `_sem_sync`): a full
    upload on an epoch change, otherwise one `segment_scatter` launch over
    the op-log suffix. The subscriber mirror follows the table's ACTIVE
    representation: a dense <-> CSR flip swaps in a fresh manager, whose
    first sync is a full upload of the other representation's arrays. A
    prepare whose tables are all clean (`_version_key()` unchanged) touches
    no mirror at all. The residual lane runs exactly when the index holds
    residual filters; the pick stage exactly when the group table holds a
    group (strategy `share_strategy`, one of `STRATEGY_IDS`); the semantic
    stage exactly when `semtab` (an `ops.semantic_table.SemanticTable`)
    holds an entry, and then the compact stage runs whatever the width.

    ``subtab=None`` makes a match-only router (`broker.router.Router`'s
    matcher, emqx_tpu/models/router_model.py:1452): no subscriber mirror,
    no fan-out half, and `match_batch` decodes the matched filters. The
    config's fan-out knobs act as in the reference: ``fanout_compact=False``
    reads dense bitmap rows back (kslot 0), ``fanout_slots > 0`` pins the
    kslot, ``sparse_gather`` is the CSR gather window.
    """

    # clean-table prepares re-check the auto-sized kslot only every this
    # many batches: the fanout histogram drifts slowly
    KSLOT_RECHECK = 64

    def __init__(self, index, subtab: SubscriberTable, config=None,
                 grouptab: Optional[GroupTable] = None,
                 share_strategy: str = "round_robin", metrics=None,
                 semtab=None, device=None, mesh=None):
        """`mesh`: a `parallel.mesh.Mesh` (this process's rank of a ('dp',
        'tp') mesh): the mirrors then upload this rank's part of every
        table (match and group tables replicated, subscriber lanes or CSR
        shards and semantic shards over 'tp'), and every batch runs the
        sharded step, its global result assembled on every rank
        (`_route_mesh`). The router serves from the mesh's device; a
        `device` other than it raises. Without a mesh, `device` defaults to
        CUDA. A match-only router (``subtab=None``) on a mesh holds its
        match tables whole and runs the single-device step on the rank's
        device, with no collective (emqx_tpu/models/router_model.py:2036:
        the mesh step needs a fan-out table)."""
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.device
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.index = index
        self.subtab = subtab
        self.grouptab = grouptab  # None: no $share picks on the device
        self.semtab = semtab  # None: no semantic stage
        self.share_strategy = STRATEGY_IDS.get(share_strategy, 1)
        # duck-typed: metrics.histogram(name) -> object with count, p99, and
        # metrics.inc(name, n) (the `device.transfer.bytes` counter)
        self.metrics = metrics
        config = config or MatcherConfig()
        if config.probes < MAX_PROBES:
            # the probe loops must cover the host placement bound, or
            # entries at the end of a probe window become invisible
            config = dataclasses.replace(config, probes=MAX_PROBES)
        self.config = config
        tplace = sem_place = None
        if mesh is not None:
            from emqx_tpu_torch.parallel.mesh import semantic_placement, table_placement

            tplace = table_placement(mesh)
            sem_place = semantic_placement(mesh)
        self._shape_sync = DeviceSegmentManager(self.device, name="shapes", placement=tplace)
        self._nfa_sync = DeviceSegmentManager(self.device, name="nfa", placement=tplace)
        # group tables are replicated on a mesh, like the match tables
        self._group_sync = DeviceSegmentManager(self.device, name="groups", placement=tplace)
        # semantic entries shard their slot-owner axis over 'tp'
        self._sem_sync = DeviceSegmentManager(self.device, name="semantic",
                                              placement=sem_place)
        self._bits_sparse = subtab is not None and subtab.sparse
        self._bits_sync = self._mk_bits_sync()
        # per-batch pick entropy: batch n draws from default_rng(0xEC0 + n),
        # the JAX router's sequence
        self._rand_seq = itertools.count(0xEC0)
        self._kslot = 0  # auto-sized compact-slot cap (grow-only)
        # O(dirty) prepare: (version key, args) of the last clean sync
        self._prep_key = None
        self._prep_args = None
        self._clean_streak = 0

    def _mk_bits_sync(self) -> DeviceSegmentManager:
        """The subscriber mirror of the ACTIVE representation: on a mesh,
        dense lanes over 'tp' or the CSR table's slot-owner shards over
        'tp' (a flip swaps in a fresh mirror under the other placement)."""
        placement = None
        if self.mesh is not None:
            from emqx_tpu_torch.parallel.mesh import bitmap_placement, csr_placement

            placement = (csr_placement if self._bits_sparse else bitmap_placement)(self.mesh)
        return DeviceSegmentManager(self.device, name="bitmaps", placement=placement)

    # a retained storm or a session rider may ride `route_prepared` on one
    # device; a plain router on a mesh fuses neither (`MeshServingRouter`
    # fuses storms), as in JAX (emqx_tpu/models/router_model.py:2363-2375)
    @property
    def supports_retained_fusion(self) -> bool:
        return self.mesh is None

    @property
    def supports_session_fusion(self) -> bool:
        return self.mesh is None

    def _fanout_kslot(self, width_words: int, sparse: bool = False,
                      semantic: bool = False) -> int:
        """kslot for the next batch; 0 = compaction off.

        0 for a match-only router, and on a dense table with
        ``fanout_compact`` off. A pinned ``fanout_slots`` is used
        pow2-padded. Otherwise sized from the `dispatch.fanout` histogram
        p99 with 2x headroom, pow2-padded and GROW-ONLY; KSLOT_MIN when no
        metrics object is given. On a dense table compaction is off while
        the slot universe (W*32) is no wider than the compact output would
        be. A CSR table has no dense rows to read back, and a live semantic
        table's winners ride the compact slot rows, so there the cap is
        mandatory: never 0."""
        cfg = self.config
        if self.subtab is None or (not sparse and not semantic and not cfg.fanout_compact):
            return 0
        if cfg.fanout_slots > 0:
            return _next_pow2(cfg.fanout_slots)
        want = KSLOT_MIN
        if self.metrics is not None:
            h = self.metrics.histogram("dispatch.fanout")
            # 256 observations before trusting p99
            if h is not None and h.count >= 256:
                want = max(want, 2 * max(1, int(h.p99)))
        k = max(self._kslot, _next_pow2(want))
        self._kslot = k
        if sparse or semantic:
            return k
        if self.mesh is not None:
            # per-shard compaction: each tp shard emits its own kslot-wide
            # list, so the win condition is against the LOCAL lane width
            width_words = max(1, width_words // self.mesh.tp)
        if k >= width_words * 32:
            return 0  # dense rows are already the smaller readback
        return k

    def _version_key(self):
        """Generation counters of every host table the mirrors are built
        from — equal keys mean the device copies are current."""
        return (
            self.index.version,
            self.subtab.version if self.subtab is not None else -1,
            self.grouptab.version if self.grouptab is not None else -1,
            self.semtab.version if self.semtab is not None else -1,
        )

    def _device_args(self) -> Prepared:
        # grow the subscriber and group tables to cover every live filter id
        # BEFORE the version key: the growth bumps their epoch and version,
        # and a bump inside the sync would read as a torn snapshot (on a CSR
        # table `pack` also folds an oversized hot segment into the packed
        # regions, `CsrTable.maybe_absorb`). A mesh attached after the
        # tables were built re-partitions the CSR and semantic tables over
        # 'tp' here, like any growth.
        subtab = self.subtab
        if self.mesh is not None and subtab is not None:
            tp = self.mesh.tp
            if subtab.sparse and subtab.shards != tp:
                subtab.set_shards(tp)
            if self.semtab is not None and self.semtab.shards != tp:
                self.semtab.reshard(tp)
        if subtab is not None:
            subtab.pack(self.index.num_filters_capacity)
            if self.mesh is not None and not subtab.sparse \
                    and subtab.width_words % self.mesh.tp:
                raise ValueError(
                    f"subscriber bitmap width {subtab.width_words} not "
                    f"divisible by mesh tp={self.mesh.tp}; use a power-of-two tp")
        if self.grouptab is not None and len(self.grouptab):
            self.grouptab.pack_fcap(self.index.num_filters_capacity)
        key = self._version_key()
        sem_on = self.semtab is not None and len(self.semtab) > 0
        if self._prep_key == key:
            self._clean_streak += 1
            if self._clean_streak % self.KSLOT_RECHECK == 0 and subtab is not None:
                kslot = self._fanout_kslot(subtab.width_words, sparse=subtab.sparse,
                                           semantic=sem_on)
                if kslot != self._prep_args.kslot:
                    self._prep_args = self._prep_args._replace(kslot=kslot)
            if self.metrics is not None:
                self.metrics.inc("router.sync.skipped")
            return self._prep_args
        self._clean_streak = 0
        # the epoch discipline around the dirty sync: a sync that raises,
        # or tears (the version key moved during it, or the fault site's
        # "corrupt"), never becomes the serving snapshot. The last good
        # `Prepared` serves instead, and `_prep_key` stays stale so the
        # next prepare retries the sync; with no good epoch yet it raises
        # (the broker's ladder serves the batch from the CPU). A mirror
        # that synced before the failure keeps its tensors and its op-log
        # cursor together, so the retry replays nothing twice and loses no
        # write; a held `Prepared` keeps its tensors, which no sync writes.
        # A kernel that failed to build is no table fault: it escapes.
        try:
            action = _faults.hit("router.delta_sync")
            args = self._sync_dirty(subtab, sem_on)
            if action == "corrupt" or self._version_key() != key:
                raise RuntimeError(
                    "torn delta sync: table generations moved during the snapshot")
        except KernelBuildError:
            raise
        except Exception:
            if self._prep_args is None:
                raise
            if self.metrics is not None:
                self.metrics.inc("router.sync.rollback")
            return self._prep_args
        self._prep_key = key
        self._prep_args = args
        if self.metrics is not None:
            self.metrics.inc("router.prepare.dirty")
        return args

    def _sync_dirty(self, subtab, sem_on: bool) -> Prepared:
        """Every mirror synced with its host table -> a fresh `Prepared`."""
        idx = self.index
        bits, kslot, kg = {}, 0, 0
        if subtab is not None:
            sparse = subtab.sparse
            if sparse != self._bits_sparse:
                # representation flip: a fresh mirror, whose first sync is
                # a full upload of the other representation's arrays
                self._bits_sparse = sparse
                self._bits_sync = self._mk_bits_sync()
            bits = self._bits_sync.sync(subtab)
            kslot = self._fanout_kslot(subtab.width_words, sparse=sparse,
                                       semantic=sem_on)
            if sparse:
                kg = self.config.sparse_gather
        tables = self._shape_sync.sync(idx.shapes)
        tables.update(bits)
        nfa_tables = self._nfa_sync.sync(idx.nfa) if idx.residual_count > 0 else None
        group_tables = None
        if self.grouptab is not None and len(self.grouptab):
            group_tables = self._group_sync.sync(self.grouptab)
        sem_tables = None
        if sem_on:
            # full upload on an epoch change, op-logged float and int
            # writes as one scatter otherwise
            sem_tables = self._sem_sync.sync(self.semtab)
        return Prepared(
            tables,
            nfa_tables,
            idx.salt,
            idx.shapes.m_active(),
            kslot,
            group_tables,
            sem_tables,
            self.semtab.topk if sem_on else 0,
            kg,
        )

    def prepare(self) -> Prepared:
        """Sync the device mirrors with the current tables. MUST run on the
        thread that mutates the tables. The returned tuple is immutable
        device state for `route_prepared`.

        Safe for the broker's pipeline (`Broker.adispatch_begin`), where
        it runs on the event loop's thread while an earlier batch's
        `route_prepared` still works on a pool thread: a sync writes no
        tensor a held `Prepared` names (a scatter writes fresh clones, a
        full or array resync uploads fresh tensors), and a delta sync
        waits on nothing: its entries go up through pinned memory without
        a wait, and it reads no device value back. Only a full or array
        resync (an epoch change: table growth, a flip, a torn sync) copies
        pageable host arrays, which waits for the stream.

        A dirty sync that raises or tears (fault site ``router.delta_sync``)
        returns the last good `Prepared` instead, counting
        `router.sync.rollback`, and the next call retries it; with no good
        epoch yet it raises (`_device_args`). Counters, as in JAX:
        `router.prepare.dirty`, `router.sync.skipped`."""
        return self._device_args()

    def launch_stream(self):
        """The CUDA stream this thread launches on (None on the CPU).
        `Broker.adispatch_begin` hands it to the pool thread that runs
        `route_prepared` (`on_stream`), so the loop thread's scatters and
        every batch's launches and readback share one stream and run in
        the order they were enqueued."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def segment_status(self) -> Dict[str, Dict[str, int]]:
        """Per mirror (`shapes`, `nfa`, `bitmaps` unless the router is
        match-only, `groups` when it has a group table, `semantic` when it
        has a semantic table): full_resyncs, delta_launches and
        array_resyncs since the mirror was made (the bitmaps mirror is
        remade by a representation flip)."""
        mirrors = [self._shape_sync, self._nfa_sync]
        if self.subtab is not None:
            mirrors.append(self._bits_sync)
        if self.grouptab is not None:
            mirrors.append(self._group_sync)
        if self.semtab is not None:
            mirrors.append(self._sem_sync)
        return {m.name: m.counters() for m in mirrors}

    def compaction_owners(self, hot_entries: int = 1024,
                          tombstone_frac: float = 0.25) -> list:
        """Adapters the background `ops.segments.SegmentCompactor` drives
        (emqx_tpu/models/router_model.py:1807; the defaults are the
        reference's `router.compact_*` settings): merge the shape hot
        segment into the packed table; for the subscriber table, merge a
        CSR table's hot segment and tombstones, or grow a dense matrix
        ahead of need; and merge a semantic table's. Each builds and
        uploads on the compaction thread and is applied on the loop, so
        the subscribe path never pays an O(table) rebuild or a full
        upload. On a mesh each owner uploads this rank's part: the shape
        table whole, the CSR and semantic shards over 'tp'."""
        from emqx_tpu_torch.ops.csr_table import CsrSegmentOwner
        from emqx_tpu_torch.ops.segments import BitmapGrowthOwner, ShapeSegmentOwner
        from emqx_tpu_torch.ops.semantic_table import SemanticSegmentOwner

        owners = [
            ShapeSegmentOwner(
                self.index.shapes,
                self._shape_sync,
                placement=self._shape_sync.placement,
                hot_entries=hot_entries,
                tombstone_frac=tombstone_frac,
            )
        ]
        if self.subtab is not None and self.subtab.sparse:
            placement = None
            if self.mesh is not None:
                from emqx_tpu_torch.parallel.mesh import csr_placement

                placement = csr_placement(self.mesh)
            owners.append(
                CsrSegmentOwner(
                    self.subtab,
                    self._bits_sync,
                    placement=placement,
                    hot_entries=hot_entries,
                    tombstone_frac=tombstone_frac,
                )
            )
        elif self.subtab is not None:
            owners.append(
                BitmapGrowthOwner(
                    self.subtab,
                    self.index,
                    self._bits_sync,
                    placement=self._bits_sync.placement,
                )
            )
        if self.semtab is not None:
            sem_place = None
            if self.mesh is not None:
                from emqx_tpu_torch.parallel.mesh import semantic_placement

                sem_place = semantic_placement(self.mesh)
            owners.append(
                SemanticSegmentOwner(
                    self.semtab,
                    self._sem_sync,
                    placement=sem_place,
                    hot_entries=hot_entries,
                    tombstone_frac=tombstone_frac,
                )
            )
        return owners

    def route(self, topics, client_hashes=None, embeds=None, rules=None) -> RouteResult:
        """Batch route: returns a host-side `RouteResult` (all numpy).
        `client_hashes` (uint32 per topic) feed the hash_clientid pick;
        `embeds` and `rules` as `route_prepared` takes them."""
        return self.route_prepared(self._device_args(), topics, client_hashes,
                                   embeds=embeds, rules=rules)

    def match_batch(self, topics, fallback=None) -> List:
        """Topic strings -> per row the matched filter names, no fan-out
        half (emqx_tpu/models/router_model.py:2475). A flagged row (too
        deep, NFA overflow, too long) gets ``fallback(topic)``, or a
        `MatchError` in its slot without one. Every device hit is
        re-verified on the host with `topics.match` before it is returned:
        the shape lane's 64-bit combined hash admits a ~2^-64 false
        positive, and a route decision has no per-delivery re-check."""
        res = self.route(topics)
        matched, flags = res.matched, res.flags
        out: List = []
        for i, t in enumerate(topics):
            if flags[i]:
                out.append(MatchError(t) if fallback is None else fallback(t))
                continue
            row = matched[i]
            names = []
            for fid in row[row >= 0]:
                name = self.index.filter_name(int(fid))
                if name is not None and T.match(t, name):
                    names.append(name)
            out.append(names)
        return out

    def _pick_inputs(self, topics, client_hashes):
        """The per-row pick inputs (client hash, topic hash, entropy), uint32
        [B]; only those the strategy reads are filled, the rest are zeros.

        The JAX router pads each batch to Bp = max(64, next_pow2(B)) rows
        and draws Bp entropy words per batch; this router does not pad, but
        draws the same Bp words from the same sequence and keeps the first
        B, so its random and sticky picks equal the JAX router's."""
        B = len(topics)
        Bp = max(64, _next_pow2(B))
        ch = np.zeros(B, np.uint32)
        if client_hashes is not None:
            ch[:] = np.asarray(client_hashes, np.uint32)
        if self.share_strategy == 4:  # hash_topic
            th = np.fromiter(
                (stable_hash(t if isinstance(t, str) else str(t)) for t in topics),
                np.uint32,
                count=B,
            )
        else:
            th = np.zeros(B, np.uint32)
        if self.share_strategy in (0, 2):  # random / sticky fallback
            rand = np.random.default_rng(next(self._rand_seq)).integers(
                0, 1 << 32, size=Bp, dtype=np.uint32
            )[:B]
        else:
            rand = np.zeros(B, np.uint32)
        return ch, th, rand

    def route_prepared(self, args: Prepared, topics, client_hashes=None,
                       retained=None, session=None, embeds=None,
                       rules=None) -> RouteResult:
        """Kernel launches + readback against a `prepare()` snapshot.

        Unlike the JAX router, the batch is not padded to a power of two:
        there is no compiled program whose shape it would have to match.

        `embeds` ([B, D] f32 per-message embeddings) feeds the semantic
        stage when the snapshot carries a semantic table; without it every
        row rides a zero vector, which matches nothing at any positive
        threshold. `rules` is an optional ``(progs, feats, valid)`` triple
        (`rules.compile.DeviceRuleFilter`: its `progs` and `features`):
        the compiled WHERE masks run in the same call and land in
        `RouteResult.rule_masks`. Both join the stages of a rider's or a
        storm's call too, as in JAX.

        `retained`: a prepared replay storm (`StormJob`, from
        `DeviceRetainedIndex.prepare_storm`) to fuse into this call, as
        `fused_route_retained_step` does (emqx_tpu/models/router_model.py
        :573): chunk 0's storm match launches right after the route
        kernels and every further chunk's before any readback; each match
        matrix joins the batch's one device->host copy, and the decoded
        {filter: row-index array} lands in `RouteResult.retained`.

        `session`: a `SessionRider` (`SessionStore.take_rider`) to fuse
        into this call, as `session_route_step_impl` does
        (emqx_tpu/models/router_model.py:463): `session_ack` launches after
        the route kernels, on the rider's mirror generation, which it never
        writes; with a sweep, `due`, `due_count`, `expired` and
        `expired_count` join the one device->host copy. `RouteResult.session`
        is the `SessionStepOut` to `commit`. A rider takes precedence over a
        storm, as in the JAX router (the broker never pairs them): given
        both, the storm is not launched and `retained` is None.

        On a mesh the batch runs sharded (`_route_mesh`); a match-only
        router there runs the single-device step on the rank's device.

        Fault sites: ``device.launch`` here, before anything is encoded or
        launched, and ``device.readback`` at the top of the readback (on
        a mesh too), as in JAX (emqx_tpu/models/router_model.py:1967,
        :2171): the broker's degrade ladder handles both."""
        _faults.hit("device.launch")
        if self.mesh is not None and self.subtab is not None:
            return self._route_mesh(args, list(topics), client_hashes,
                                    retained=retained, session=session,
                                    embeds=embeds, rules=rules)
        cfg = self.config
        topics = list(topics)
        mat, lens, too_long = encode_topics(topics, cfg.max_bytes)
        B = len(topics)
        qv = None
        if args.sem_tables is not None:
            qv = np.zeros((B, args.sem_tables["sem_vec"].shape[2]), np.float32)
            if embeds is not None:
                qv[:] = np.asarray(embeds, np.float32)
            qv = torch.from_numpy(qv).to(self.device)
        rprogs, rfeats, rvalid = (), None, None
        if rules is not None and rules[0]:
            rprogs = tuple(rules[0])
            rfeats = torch.from_numpy(np.ascontiguousarray(rules[1], np.float32)).to(self.device)
            rvalid = torch.from_numpy(np.ascontiguousarray(rules[2], bool)).to(self.device)
        with_groups = args.group_tables is not None
        ch = th = rand = None
        if with_groups:
            ch, th, rand = (
                torch.from_numpy(v.view(np.int32)).to(self.device)
                for v in self._pick_inputs(topics, client_hashes)
            )
        out = shape_route_step(
            args.tables,
            torch.from_numpy(mat).to(self.device),
            torch.from_numpy(lens).to(self.device),
            m_active=args.m_active,
            salt=args.salt,
            nfa_tables=args.nfa_tables,
            with_nfa=args.nfa_tables is not None,
            group_tables=args.group_tables,
            client_hash=ch,
            topic_hash=th,
            rand=rand,
            with_groups=with_groups,
            share_strategy=self.share_strategy,
            max_levels=cfg.max_levels,
            frontier=cfg.frontier,
            max_matches=cfg.max_matches,
            probes=cfg.probes,
            kslot=args.kslot,
            kg=args.kg,
            sem_tables=args.sem_tables,
            q_vecs=qv,
            sem_topk=args.sem_topk,
            rule_progs=rprogs,
            rule_feats=rfeats,
            rule_valid=rvalid,
            device=self.device,
        )
        if session is not None:
            sess = session_ack(session.arrays, session.idxs, session.vals,
                               session.clock, sweep_k=session.sweep_k)
            return self._readback(out, len(topics), too_long, args.kslot,
                                  session=sess)
        storm = None
        if retained is not None and retained.chunks:
            from emqx_tpu_torch.models.retained_index import retained_step

            storm = [
                retained_step(retained.shape_tables, retained.nfa_tables, c,
                              **retained.kwargs)
                for c in retained.chunks
            ]
        return self._readback(out, len(topics), too_long, args.kslot,
                              retained=retained, storm=storm)

    def _readback(self, out, B: int, too_long, kslot: int, retained=None,
                  storm=None, session=None) -> RouteResult:
        """Pull one batch's outputs to the host -> `RouteResult`.

        Every output the batch needs, the picks included, crosses in ONE
        device->host copy of a packed int32 buffer. Only a dense table's
        overflow rows are a second (masked) copy, because which rows need
        it is decided by `slot_count`, which must be on the host first. A
        CSR table has no dense rows on the device: its overflow rows are
        `_LazyDenseRows`, built from the host table when read, and nothing
        more crosses the link for them. A fused storm's match matrices
        (`storm`, one per chunk, int16 or int32) ride the same copy: an
        int16 matrix joins the int32 buffer as its bytes, two entries a
        word. So do a session stage's sweep lists and counts (`session`,
        the dict `session_ack` returns; its updated lanes stay on the
        device), the semantic stage's ``sem_count`` (its winners are in
        ``slots`` already) and the rule masks, four to a word."""
        _faults.hit("device.readback")
        M = out["matched"].shape[1]
        with_groups = "pick_gid" in out
        sparse = out["bitmaps"] is None
        fan = not sparse or "slots" in out  # False: a match-only router
        parts = [
            out["matched"].reshape(-1),
            out["mcount"],
            out["flags"].to(torch.int32),
        ]
        if with_groups:
            P = out["pick_gid"].shape[1]
            parts += [out["pick_gid"].reshape(-1), out["pick_idx"].reshape(-1)]
        if kslot:
            SW = out["slots"].shape[1]  # kslot (+ topk with a semantic table)
            parts += [out["slots"].reshape(-1), out["slot_count"]]
        elif fan:
            parts.append(out["bitmaps"].reshape(-1))
        if "sem_count" in out:
            parts.append(out["sem_count"])
        masks = out.get("rule_masks")
        if masks is not None:
            parts.append(_as_words(masks))
        storm = storm or []
        storm_words = [_as_words(m) for m in storm]
        sweep = session is not None and "due" in session
        if sweep:
            K = session["due"].numel()
            parts += [session["due"], session["due_count"].reshape(1),
                      session["expired"], session["expired_count"].reshape(1)]
        host = _to_host(torch.cat(parts + storm_words))
        readback = host.nbytes
        o = 0

        def take(n):
            nonlocal o
            o += n
            return host[o - n : o]

        matched = take(B * M).reshape(B, M)
        mcount = take(B)
        flags = take(B).astype(bool) | too_long
        picks = None
        if with_groups:
            picks = (take(B * P).reshape(B, P), take(B * P).reshape(B, P))
        bitmaps = slots = slot_count = None
        if kslot:
            slots = take(B * SW).reshape(B, SW)
            slot_count = take(B)
        elif fan:
            W = out["bitmaps"].shape[1]
            bitmaps = take(B * W).reshape(B, W).view(np.uint32)
        sem_count = take(B) if "sem_count" in out else None
        rule_masks = None
        if masks is not None:
            rule_masks = _from_words(take(-(-masks.numel() // 4)), masks)
        sess_res = None
        if session is not None:
            if sweep:
                due, due_count = take(K), int(take(1)[0])
                expired, expired_count = take(K), int(take(1)[0])
                sess_res = SessionStepOut(session["tables"], due, due_count,
                                          expired, expired_count)
            else:
                sess_res = SessionStepOut(session["tables"], None, 0, None, 0)
        retained_res = None
        if storm:
            mats = [_from_words(take(w.numel()), m) for m, w in zip(storm, storm_words)]
            retained_res = retained.decode(mats)
        if not kslot:
            return self._count_transfer(RouteResult(
                matched, mcount, flags, bitmaps, picks, readback_bytes=readback,
                retained=retained_res, session=sess_res, sem_count=sem_count,
                rule_masks=rule_masks))
        # holds on the CSR path too: the kernel forces count past kslot for
        # gather-window overflow rows
        overflow = slot_count > kslot
        dense_rows = dense_index = None
        ovf_idx = np.nonzero(overflow)[0]
        if ovf_idx.size:
            dense_index = {int(r): j for j, r in enumerate(ovf_idx)}
            if sparse:
                dense_rows = _LazyDenseRows(
                    self.subtab,
                    [matched[r][matched[r] >= 0].tolist() for r in ovf_idx],
                )
            else:
                sel = torch.from_numpy(ovf_idx).to(out["bitmaps"].device)
                dense_rows = out["bitmaps"][sel].cpu().numpy().view(np.uint32)
                readback += dense_rows.nbytes
        return self._count_transfer(RouteResult(
            matched, mcount, flags, None, picks,
            slots=slots, slot_count=slot_count, overflow=overflow,
            dense_rows=dense_rows, dense_index=dense_index,
            readback_bytes=readback, retained=retained_res, session=sess_res,
            sem_count=sem_count, rule_masks=rule_masks,
        ))

    def _count_transfer(self, res: RouteResult) -> RouteResult:
        """Add a batch's device->host bytes to the `device.transfer.bytes`
        counter, once a readback, as the JAX router's `route_prepared`
        does (emqx_tpu/models/router_model.py:1943)."""
        if self.metrics is not None:
            self.metrics.inc("device.transfer.bytes", res.readback_bytes)
        return res


    # -- the mesh ---------------------------------------------------------------

    def _route_mesh(self, args: Prepared, topics, client_hashes=None,
                    retained=None, session=None, embeds=None,
                    rules=None) -> RouteResult:
        """SPMD serving (emqx_tpu/models/router_model.py:2381): this rank
        encodes only its 'dp' rows of the batch (padded to a multiple of
        dp, `_mesh_pad`), runs `parallel.mesh.dist_shape_route_step` (or
        `dist_fused_route_step` with a storm, `MeshServingRouter` only) on
        the tables its mirrors hold, and `_readback_mesh` assembles the
        same global `RouteResult` on every rank. The per-row pick entropy,
        query vectors and rule features follow their rows. A session rider
        raises: the mesh engine fuses none (`supports_session_fusion`)."""
        from emqx_tpu_torch.parallel import mesh as M

        if session is not None:
            raise RuntimeError("session rider handed to a non-fusing mesh engine")
        storm = retained is not None and bool(retained.chunks)
        if storm and not self.supports_retained_fusion:
            raise RuntimeError("retained storm handed to a non-fusing mesh engine; "
                               "use MeshServingRouter for mesh serving")
        mesh, cfg = self.mesh, self.config
        B = len(topics)
        per, lo = M.batch_rows(mesh, B)
        mine = topics[lo:lo + per]
        mat, lens, too_long = encode_topics(mine, cfg.max_bytes)
        bm, ln = (torch.from_numpy(x).to(self.device) for x in self._mesh_pad(mat, lens, per))
        tl = np.zeros(per, bool)
        tl[:len(mine)] = too_long
        dev = self.device
        with_groups = args.group_tables is not None
        ch = th = rand = None
        if with_groups:
            ch, th, rand = (
                torch.from_numpy(self._mesh_pad_rows(v, lo, per).view(np.int32)).to(dev)
                for v in self._pick_inputs(topics, client_hashes)
            )
        qv = None
        if args.sem_tables is not None:
            qv = np.zeros((B, args.sem_tables["sem_vec"].shape[2]), np.float32)
            if embeds is not None:
                qv[:] = np.asarray(embeds, np.float32)
            qv = torch.from_numpy(self._mesh_pad_rows(qv, lo, per)).to(dev)
        rprogs, rfeats, rvalid = (), None, None
        if rules is not None and rules[0]:
            rprogs = tuple(rules[0])
            rfeats = torch.from_numpy(self._mesh_pad_rows(
                np.asarray(rules[1], np.float32), lo, per)).to(dev)
            rvalid = torch.from_numpy(self._mesh_pad_rows(
                np.asarray(rules[2], bool), lo, per)).to(dev)
        sub = {k: v for k, v in args.tables.items() if k in CSR_KEYS}
        if not sub:
            sub = args.tables["sub_bitmaps"]
        shape_tables = {k: v for k, v in args.tables.items()
                        if k not in CSR_KEYS and k != "sub_bitmaps"}
        kw = dict(
            m_active=args.m_active, salt=args.salt, max_levels=cfg.max_levels,
            frontier=cfg.frontier, max_matches=cfg.max_matches,
            probes=cfg.probes, share_strategy=self.share_strategy,
            kslot=args.kslot, kg=args.kg, sem_topk=args.sem_topk, rule_progs=rprogs,
        )
        pick_in = (args.group_tables, ch, th, rand, args.sem_tables, qv, rfeats, rvalid)
        extra = []
        if storm:
            out = M.dist_fused_route_step(
                mesh, shape_tables, args.nfa_tables, sub, bm, ln,
                retained.shape_tables, retained.nfa_tables, retained.chunks[0],
                *pick_in,
                ret_m_active=retained.kwargs["m_active"],
                ret_with_nfa=retained.kwargs["with_nfa"],
                ret_salt=retained.kwargs["salt"],
                ret_max_levels=retained.kwargs["max_levels"],
                ret_narrow=retained.kwargs["narrow"], **kw)
            from emqx_tpu_torch.models.retained_index import retained_step

            # each further chunk on this rank's row block, before any
            # readback; the blocks meet in the one assembly gather
            extra = [retained_step(retained.shape_tables, retained.nfa_tables, c,
                                   **retained.kwargs)
                     for c in retained.chunks[1:]]
        else:
            out = M.dist_shape_route_step(mesh, shape_tables, args.nfa_tables, sub,
                                          bm, ln, *pick_in, **kw)
        out["flags"] = out["flags"] | torch.from_numpy(tl).to(dev)
        storm_out = [out["retained"]] + extra if storm else None
        return self._readback_mesh(out, B, per, args.kslot,
                                   retained=retained if storm else None,
                                   storm=storm_out)

    @staticmethod
    def _mesh_pad(mat, lens, per: int):
        """This rank's encoded rows padded to `per` empty rows (JAX pads
        the whole batch to a multiple of dp, `_mesh_pad`,
        emqx_tpu/models/router_model.py:2456: the same rows land on each
        rank) -> (bytes, lengths), numpy."""
        return (np.pad(mat, ((0, per - len(mat)), (0, 0))),
                np.pad(lens, (0, per - len(lens))))

    @staticmethod
    def _mesh_pad_rows(v: np.ndarray, lo: int, per: int) -> np.ndarray:
        """Rows [lo, lo + per) of a per-row batch input, zero padded past
        its end (`_mesh_pad_rows`, emqx_tpu/models/router_model.py:2445)."""
        part = np.ascontiguousarray(v[lo:lo + per])
        if len(part) == per:
            return part
        pad = [(0, per - len(part))] + [(0, 0)] * (part.ndim - 1)
        return np.pad(part, pad)

    def _readback_mesh(self, out, B: int, per: int, kslot: int, retained=None,
                       storm=None) -> RouteResult:
        """Every rank's outputs -> the global `RouteResult`, on every rank:
        the mesh branch of `_readback` (emqx_tpu/models/router_model.py
        :2142, ``mesh=True``). Each rank packs its block of every output
        into one int32 buffer, ONE all-gather over the world carries them
        all, and one device->host copy brings the gathered buffers over.
        The layout is JAX's `_out_specs` (emqx_tpu/parallel/mesh.py:107):
        matched, mcount, flags, picks, sem_count and rule masks
        concatenated over 'dp' (from the tp = 0 replicas); slots [B, SW x
        tp], each 'tp' shard's segment side by side with -1 holes; slot
        count and overflow reduced over 'tp'; overflow read from the
        device, since a row overflows when any shard did. A storm's match
        matrices join the buffer and come back as whole chunks (row blocks
        over 'dp'). A dense table's overflow rows come back through a
        second, masked gather; a CSR table's are built from the host table
        when read (`_LazyDenseRows`)."""
        _faults.hit("device.readback")
        mesh = self.mesh
        dp, tp = mesh.dp, mesh.tp
        M_ = out["matched"].shape[1]
        with_groups = "pick_gid" in out
        sparse = out["bitmaps"] is None
        fields = [("matched", out["matched"]), ("mcount", out["mcount"]),
                  ("flags", out["flags"].to(torch.int32))]
        if with_groups:
            fields += [("pick_gid", out["pick_gid"]), ("pick_idx", out["pick_idx"])]
        if kslot:
            fields += [("slots", out["slots"]), ("slot_count", out["slot_count"]),
                       ("overflow", out["overflow"].to(torch.int32))]
        else:
            fields.append(("bitmaps", out["bitmaps"]))
        if "sem_count" in out:
            fields.append(("sem_count", out["sem_count"]))
        masks = out.get("rule_masks")
        storm = storm or []
        words = [(k, t.reshape(-1)) for k, t in fields]
        if masks is not None:
            words.append(("rule_masks", _as_words(masks)))
        words += [(f"storm{j}", _as_words(m)) for j, m in enumerate(storm)]
        sizes = [w.numel() for _, w in words]
        buf = torch.cat([w for _, w in words])
        host = self.mesh.all_gather(buf, ("dp", "tp"), "readback").cpu().numpy()
        readback = host.nbytes
        offs = np.concatenate([[0], np.cumsum(sizes)])
        part = {k: (offs[i], offs[i + 1]) for i, (k, _) in enumerate(words)}

        def block(rank, k):
            a, b = part[k]
            return host[rank, a:b]

        def rows(k, shape):  # a 'dp'-split output: the tp = 0 replicas
            return np.concatenate([block(d * tp, k).reshape(shape) for d in range(dp)])[:B]

        matched = rows("matched", (per, M_))
        mcount = rows("mcount", (per,))
        flags = rows("flags", (per,)).astype(bool)
        picks = None
        if with_groups:
            P = out["pick_gid"].shape[1]
            picks = (rows("pick_gid", (per, P)), rows("pick_idx", (per, P)))
        sem_count = rows("sem_count", (per,)) if "sem_count" in out else None
        rule_masks = None
        if masks is not None:
            rule_masks = np.concatenate(
                [_from_words(block(d * tp, "rule_masks"), masks) for d in range(dp)],
                axis=1)[:, :B]
        retained_res = None
        if storm:
            mats = [np.concatenate([_from_words(block(d * tp, f"storm{j}"), m)
                                    for d in range(dp)])
                    for j, m in enumerate(storm)]
            retained_res = retained.decode(mats)
        if not kslot:
            W_ = out["bitmaps"].shape[1]
            bitmaps = np.concatenate(
                [np.concatenate([block(d * tp + t, "bitmaps").reshape(per, W_)
                                 for t in range(tp)], axis=1) for d in range(dp)]
            )[:B].view(np.uint32)
            return self._count_transfer(RouteResult(
                matched, mcount, flags, bitmaps, picks, readback_bytes=readback,
                retained=retained_res, sem_count=sem_count, rule_masks=rule_masks))
        SW = out["slots"].shape[1]
        slots = np.concatenate(
            [np.concatenate([block(d * tp + t, "slots").reshape(per, SW)
                             for t in range(tp)], axis=1) for d in range(dp)]
        )[:B]
        slot_count = rows("slot_count", (per,))
        overflow = rows("overflow", (per,)).astype(bool)
        dense_rows = dense_index = None
        ovf_idx = np.nonzero(overflow)[0]
        if ovf_idx.size:
            dense_index = {int(r): j for j, r in enumerate(ovf_idx)}
            if sparse:
                dense_rows = _LazyDenseRows(
                    self.subtab,
                    [matched[r][matched[r] >= 0].tolist() for r in ovf_idx],
                )
            else:
                dense_rows = self._gather_dense_rows(out["bitmaps"], ovf_idx, per)
                readback += dense_rows.nbytes
        return self._count_transfer(RouteResult(
            matched, mcount, flags, None, picks,
            slots=slots, slot_count=slot_count, overflow=overflow,
            dense_rows=dense_rows, dense_index=dense_index,
            readback_bytes=readback, retained=retained_res,
            sem_count=sem_count, rule_masks=rule_masks,
        ))

    def _gather_dense_rows(self, bitmaps, ovf_idx: np.ndarray, per: int) -> np.ndarray:
        """The dense rows of the overflow rows (global row ids, the same on
        every rank): each rank fills the rows of its 'dp' block from its
        lane slice, one all-gather over the world, and the host puts every
        row's 'tp' slices side by side -> uint32 [n, W]."""
        mesh = self.mesh
        d0 = mesh.axis_index("dp") * per
        W_ = bitmaps.shape[1]
        local = torch.zeros((len(ovf_idx), W_), dtype=torch.int32, device=self.device)
        mine = np.nonzero((ovf_idx >= d0) & (ovf_idx < d0 + per))[0]
        if mine.size:
            src = torch.from_numpy(ovf_idx[mine] - d0).to(self.device)
            local[torch.from_numpy(mine).to(self.device)] = bitmaps[src]
        host = mesh.all_gather(local, ("dp", "tp"), "readback").cpu().numpy()
        owner = ovf_idx // per  # the dp rank of each row
        rows = np.empty((len(ovf_idx), W_ * mesh.tp), np.int32)
        for t in range(mesh.tp):
            rows[:, t * W_:(t + 1) * W_] = host[owner * mesh.tp + t, np.arange(len(ovf_idx))]
        return rows.view(np.uint32)


class MeshServingRouter(DeviceRouter):
    """The scale-out serving engine (emqx_tpu/models/router_model.py:2513):
    a `DeviceRouter` on a ('dp', 'tp') mesh that also fuses a retained
    storm into the sharded call (`parallel.mesh.dist_fused_route_step`):
    chunk 0's row block rides the route step, the further chunks run on
    their row blocks before the readback, and every block meets in the one
    assembly gather. `shard_label` names this process's slice in span
    attributes."""

    supports_retained_fusion = True

    def __init__(self, index, subtab: SubscriberTable, config=None,
                 grouptab: Optional[GroupTable] = None,
                 share_strategy: str = "round_robin", mesh=None, metrics=None,
                 semtab=None, device=None):
        if mesh is None:
            raise ValueError("MeshServingRouter requires a ('dp','tp') mesh")
        super().__init__(index, subtab, config, grouptab=grouptab,
                         share_strategy=share_strategy, metrics=metrics,
                         semtab=semtab, device=device, mesh=mesh)
        self.shard_label = "local"

    def span_attrs(self) -> Dict:
        return {"device.mesh_shape": f"{self.mesh.dp}x{self.mesh.tp}",
                "device.shard": self.shard_label}

    def shard_status(self) -> Dict:
        """Per-'tp'-shard occupancy of the subscriber table: nonzero lane
        words of each dense lane slice, or each CSR shard's live
        subscriptions as a share of all (`shard_status`,
        emqx_tpu/models/router_model.py:2561)."""
        mesh = self.mesh
        out = {"dp": mesh.dp, "tp": mesh.tp, "shards": mesh.world}
        if self.subtab.sparse:
            sp = self.subtab.csr
            per = sp.csr_len.sum(axis=1)
            hot_live = (sp.hot_fid >= 0).sum(axis=1)
            fills = (per + hot_live).astype(np.float64)
            denom = max(1.0, float(fills.sum()))
            out["lane_fill_max"] = float(fills.max()) / denom
            out["lane_fill_min"] = float(fills.min()) / denom
            out["sub_table"] = "sparse"
            return out
        arr = self.subtab.arr
        w = arr.shape[1]
        per = w // mesh.tp if w % mesh.tp == 0 else w
        fills = [float(np.count_nonzero(arr[:, s * per:(s + 1) * per]))
                 / max(1, arr[:, s * per:(s + 1) * per].size)
                 for s in range(w // per if per else 0)]
        out["lane_fill_max"] = max(fills) if fills else 0.0
        out["lane_fill_min"] = min(fills) if fills else 0.0
        return out


def on_stream(stream, fn, *args):
    """fn(*args) with `stream` as this thread's current CUDA stream (as it
    is when `stream` is None): how a dispatch pool thread launches on the
    stream of the thread that prepared the batch."""
    if stream is None:
        return fn(*args)
    with torch.cuda.stream(stream):
        return fn(*args)


def _to_host(buf: torch.Tensor) -> np.ndarray:
    """A batch's packed outputs -> host numpy, in one device->host copy. On
    CUDA the copy goes to pinned memory and the caller waits for an event
    recorded right after it, not for the whole stream: with the pipeline's
    threads on one stream, a later batch's launches enqueued meanwhile do
    not hold this readback back."""
    if not buf.is_cuda:
        return buf.numpy()
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(buf.device))
    done.synchronize()
    return host.numpy()


def _as_words(m: torch.Tensor) -> torch.Tensor:
    """A tensor as flat int32 words for the coalesced readback: int32 as it
    is; int16 (a narrowed match matrix) or bool (rule masks) as its bytes,
    zero padded to a whole word, with no copy where no padding is
    needed."""
    flat = m.reshape(-1)
    if m.dtype == torch.int32:
        return flat
    raw = flat.view(torch.uint8)
    if raw.numel() % 4:
        raw = torch.cat([raw, raw.new_zeros(4 - raw.numel() % 4)])
    return raw.view(torch.int32)


def _from_words(words: np.ndarray, m: torch.Tensor) -> np.ndarray:
    """The inverse of `_as_words` on the host: `m`'s values, shape and
    type (int32, int16 or bool) back from its words."""
    dt = {torch.int32: np.int32, torch.int16: np.int16, torch.bool: np.bool_}[m.dtype]
    raw = words.view(np.uint8)[: m.numel() * m.element_size()]
    return raw.view(dt).reshape(tuple(m.shape))
