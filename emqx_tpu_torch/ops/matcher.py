"""Batched NFA topic matching: the port's copy of `MatcherConfig`, the
residual-NFA walk of `emqx_tpu/ops/matcher.py` (`batch_match_syms` with its
helpers `_probe_edges`, `_compact` and `_append`, :84-:214), the fused
`batch_match_bytes` (:221) and the host-facing `TpuMatcher` (:277).

The route index keeps the filters its 64-shape table rejects in an NFA
(ops/nfa.py). `batch_match_syms` walks a batch of tokenized topics through
it: per topic level it collects the `#` filters of every frontier state,
probes the literal edge for the level's symbol, takes the `+` child, and
left-packs the new frontier (literal children first, then `+` children, in
frontier order). After the last level it collects the exact and the `#`
filters of the surviving frontier. `$` topics skip the root's wildcards.

On CUDA tensors `batch_match_syms` launches the hand-written kernel
`kernels/csrc/nfa_walk.cu` (the whole level scan in one launch); on CPU
tensors it runs `batch_match_syms_plain`, the same scan in plain PyTorch,
written after the JAX function line by line. Both give the same outputs in
the same order: the order of `matched` is part of the contract.

`batch_match_bytes` runs the three kernels of a match in sequence
(`tokenize`, `vocab_lookup`, `nfa_walk`); `TpuMatcher` owns an
`NfaBuilder`'s device mirror (a `DeviceSegmentManager`, the counterpart of
JAX's `DeviceDeltaSync`, ops/nfa.py:171), matches batches of topic strings
through it with one readback, and hands each flagged row to a fallback or
a `MatchError` in its slot.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker.metrics import default_metrics
from emqx_tpu_torch.ops.nfa import (
    EDGE_H_MUL_NODE,
    EDGE_H_MUL_SYM,
    EDGE_H_SHIFT,
    MAX_PROBES,
    _next_pow2,
)
from emqx_tpu_torch.ops.segments import DeviceSegmentManager
from emqx_tpu_torch.ops.tokenizer import encode_topics, tokenize, vocab_lookup
from emqx_tpu_torch.ops.u32 import M32, mul32, u32


@dataclass(frozen=True)
class MatcherConfig:
    """The fields of `MatcherConfig` (emqx_tpu/ops/matcher.py:46) with the
    reference's defaults; the two jit knobs (`donate_buffers`,
    `jit_cache_max`) have no compiled program to act on here."""

    max_levels: int = 16  # topic depth budget (scan length)
    frontier: int = 32  # max simultaneous NFA states per topic
    max_matches: int = 64  # max matched filters per topic (NFA lane)
    # open-addressing probe bound; must cover the build-time bound
    # (nfa.MAX_PROBES) or lookups would silently miss — DeviceRouter clamps
    probes: int = MAX_PROBES
    max_bytes: int = 256  # topic byte budget for the tokenizer
    # compact fan-out readback (`compact_fanout_slots`): O(matches) slot
    # lists instead of dense [B, W] bitmaps; overflow rows take a masked
    # dense transfer, so the cap is a bandwidth knob, never a correctness one
    fanout_compact: bool = True
    # per-row compact-slot cap: 0 = auto-size from the dispatch.fanout
    # histogram p99 (grow-only, pow2-padded); > 0 pins it (pow2-padded)
    fanout_slots: int = 0
    # subscriber-table policy: "dense" pins the [Fcap, W] matrix, "sparse"
    # the CSR slot lists, "auto" starts dense and flips once when the
    # matrix is mostly zeros (`SubscriberTable._maybe_flip`)
    sub_table: str = "auto"
    # CSR gather-window bound per row: 0 = auto (2 x kslot)
    sparse_gather: int = 0


# the NFA device tables, as `NfaBuilder.device_snapshot()` names them
NFA_TABLE_KEYS = (
    "plus_child",
    "hash_filter",
    "term_filter",
    "edge_node",
    "edge_sym",
    "edge_child",
    "vocab_h1",
    "vocab_h2",
    "vocab_sym",
)


# -- plain PyTorch twin ----------------------------------------------------


def _probe_edges(tables, node, sym, probes: int):
    """Open-addressing lookup of literal edges (node, sym) -> child; the
    first hit among `probes` slots wins (tombstones never equal a node)."""
    E = tables["edge_node"].shape[0]
    valid = (node >= 0) & (sym >= 0)
    h = (mul32(u32(node), EDGE_H_MUL_NODE) + mul32(u32(sym), EDGE_H_MUL_SYM)) & M32
    h = h ^ (h >> EDGE_H_SHIFT)
    child = torch.full(node.shape, -1, dtype=torch.int32, device=node.device)
    found = torch.zeros(node.shape, dtype=torch.bool, device=node.device)
    for p in range(probes):
        idx = (h + p) & (E - 1)
        hit = (
            (tables["edge_node"][idx] == node)
            & (tables["edge_sym"][idx] == sym)
            & valid
            & ~found
        )
        child = torch.where(hit, tables["edge_child"][idx], child)
        found |= hit
    return child


def _compact(cand, width: int):
    """Left-pack the >= 0 entries of cand [B, W] into [B, width]; flag rows
    with more than `width`. Column `width` is the discard bucket that JAX's
    `mode="drop"` stands for."""
    B = cand.shape[0]
    valid = cand >= 0
    pos = torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid & (pos < width), pos, width)
    out = torch.full((B, width + 1), -1, dtype=cand.dtype, device=cand.device)
    out.scatter_(1, idx, cand)
    return out[:, :width], valid.sum(dim=1) > width


def _append(matched, mcount, hits, cap: int):
    """Append the >= 0 entries of hits [B, H] to matched [B, cap] at
    mcount (uncapped); writes at or past `cap` fall into the discard
    column."""
    B = matched.shape[0]
    valid = hits >= 0
    pos = mcount[:, None] + torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid & (pos < cap), pos, cap)
    buf = torch.cat(
        [matched, torch.full((B, 1), -1, dtype=matched.dtype, device=matched.device)],
        dim=1,
    )
    buf.scatter_(1, idx, hits)
    return buf[:, :cap], mcount + valid.sum(dim=1)


def batch_match_syms_plain(tables, syms, nwords, dollar, *, frontier: int,
                           max_matches: int, probes: int):
    """Plain PyTorch twin of the `nfa_walk` kernel (any device): the level
    scan of `batch_match_syms` (emqx_tpu/ops/matcher.py:139) as a Python
    loop over levels."""
    B, L = syms.shape
    F, K = frontier, max_matches
    dev = syms.device
    fr = torch.full((B, F), -1, dtype=torch.int32, device=dev)
    fr[:, 0] = 0  # root
    matched = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    mcount = torch.zeros(B, dtype=torch.int64, device=dev)
    fover = torch.zeros(B, dtype=torch.bool, device=dev)
    for lvl in range(L):
        active_row = lvl < nwords
        act = (fr >= 0) & active_row[:, None]
        fr_safe = fr.clamp(min=0)
        allow_wild = act & ~(dollar & (lvl == 0))[:, None]
        hf = torch.where(allow_wild, tables["hash_filter"][fr_safe], -1)
        matched, mcount = _append(matched, mcount, hf, K)
        lit = _probe_edges(
            tables,
            torch.where(act, fr, -1),
            syms[:, lvl : lvl + 1].expand(B, F),
            probes,
        )
        plus = torch.where(allow_wild, tables["plus_child"][fr_safe], -1)
        newf, over = _compact(torch.cat([lit, plus], dim=1), F)
        fr = torch.where(active_row[:, None], newf, fr)
        fover = fover | (over & active_row)
    done = nwords <= L
    fin = (fr >= 0) & done[:, None]
    fr_safe = fr.clamp(min=0)
    term = torch.where(fin, tables["term_filter"][fr_safe], -1)
    matched, mcount = _append(matched, mcount, term, K)
    endhash = torch.where(fin, tables["hash_filter"][fr_safe], -1)
    matched, mcount = _append(matched, mcount, endhash, K)
    too_deep = ~done
    mover = mcount > K
    causes = {"too_deep": too_deep, "frontier_overflow": fover,
              "match_overflow": mover}
    return (matched.contiguous(), mcount.clamp(max=K).to(torch.int32),
            fover | mover | too_deep, causes)


# -- the wrapper -----------------------------------------------------------


def _pow2_len(t, name: str) -> int:
    n = t.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name}: length must be a power of two, got {n}")
    return n


def check_nfa_tables(tables) -> None:
    for k in NFA_TABLE_KEYS:
        kernels.check_tensor(tables[k], k, torch.int32, 1)
    n = tables["plus_child"].shape[0]
    if tables["hash_filter"].shape[0] != n or tables["term_filter"].shape[0] != n:
        raise ValueError("plus_child, hash_filter and term_filter disagree in length")
    E = _pow2_len(tables["edge_node"], "edge_node")
    if tables["edge_sym"].shape[0] != E or tables["edge_child"].shape[0] != E:
        raise ValueError("edge_node, edge_sym and edge_child disagree in length")
    V = _pow2_len(tables["vocab_sym"], "vocab_sym")
    if tables["vocab_h1"].shape[0] != V or tables["vocab_h2"].shape[0] != V:
        raise ValueError("vocab_h1, vocab_h2 and vocab_sym disagree in length")


# frontier states live in shared memory, two buffers of F per row (a warp
# a row past F = 64); the launcher shrinks its block until they fit in 48 KB
MAX_FRONTIER = 6144


def batch_match_syms(tables, syms, nwords, dollar, *, frontier: int = 32,
                     max_matches: int = 64, probes: int = MAX_PROBES):
    """Match tokenized topics against the residual NFA (kernel `nfa_walk`).

    tables: int32 device tensors named as in `NFA_TABLE_KEYS` (vocab hashes
    hold uint32 bits); syms int32 [B, L] symbol ids (-1 = out of
    vocabulary) from `vocab_lookup`; nwords int32 [B]; dollar bool [B].
    -> (matched int32 [B, K] filter ids in walk order, -1 padded;
    min(mcount, K) int32 [B]; flags bool [B] (the host must route the
    row); causes {too_deep, frontier_overflow, match_overflow} bool [B]).
    The counterpart of `batch_match_syms` (emqx_tpu/ops/matcher.py:139).
    """
    check_nfa_tables(tables)
    kernels.check_tensor(syms, "syms", torch.int32, 2)
    kernels.check_tensor(nwords, "nwords", torch.int32, 1)
    kernels.check_tensor(dollar, "dollar", torch.bool, 1)
    B, L = syms.shape
    if nwords.shape[0] != B or dollar.shape[0] != B:
        raise ValueError("syms, nwords and dollar disagree on the batch")
    if not 1 <= frontier <= MAX_FRONTIER:
        raise ValueError(f"frontier must be in [1, {MAX_FRONTIER}], got {frontier}")
    if max_matches < 1 or probes < 1:
        raise ValueError("max_matches and probes must be >= 1")
    args = [tables[k] for k in NFA_TABLE_KEYS] + [syms, nwords, dollar]
    if not kernels.on_cuda(*args):
        return batch_match_syms_plain(tables, syms, nwords, dollar, frontier=frontier,
                                      max_matches=max_matches, probes=probes)
    dev = syms.device
    K = max_matches
    matched = torch.empty((B, K), dtype=torch.int32, device=dev)
    mcount = torch.empty(B, dtype=torch.int32, device=dev)
    # flags, too_deep, frontier_overflow, match_overflow
    bools = torch.empty((4, B), dtype=torch.bool, device=dev)
    kernels.launch(
        "nfa_walk",
        "emqx_nfa_walk",
        dev,
        syms.data_ptr(),
        nwords.data_ptr(),
        dollar.data_ptr(),
        tables["plus_child"].data_ptr(),
        tables["hash_filter"].data_ptr(),
        tables["term_filter"].data_ptr(),
        tables["edge_node"].data_ptr(),
        tables["edge_sym"].data_ptr(),
        tables["edge_child"].data_ptr(),
        tables["edge_node"].shape[0],
        matched.data_ptr(),
        mcount.data_ptr(),
        bools.data_ptr(),
        B,
        L,
        frontier,
        K,
        probes,
    )
    causes = {"too_deep": bools[1], "frontier_overflow": bools[2],
              "match_overflow": bools[3]}
    return matched, mcount, bools[0], causes


# -- the fused match and the host-facing matcher ---------------------------


def batch_match_bytes(tables, bytes_mat, lengths, *, salt: int, max_levels: int = 16,
                      frontier: int = 32, max_matches: int = 64,
                      probes: int = MAX_PROBES):
    """tokenize -> vocab lookup -> NFA walk: the counterpart of
    `batch_match_bytes_impl` (emqx_tpu/ops/matcher.py:221), three kernel
    launches on CUDA tensors (their plain twins on CPU tensors).

    bytes_mat uint8 [B, MB] and lengths int32 [B] tensors on the tables'
    device, as `encode_topics` makes them -> (matched, mcount, flags,
    causes) as `batch_match_syms` returns them."""
    h1, h2, nwords, dollar = tokenize(bytes_mat, lengths, salt, max_levels)
    syms = vocab_lookup(tables, h1, h2, probes)
    return batch_match_syms(tables, syms, nwords, dollar, frontier=frontier,
                            max_matches=max_matches, probes=probes)


def _pad_pow2(n: int, lo: int = 256) -> int:
    return max(lo, _next_pow2(n))


class MatchError(RuntimeError):
    """Per-row match failure marker, returned in the row's slot and never
    raised mid-batch (emqx_tpu/ops/matcher.py:258): one flagged topic must
    not poison its batchmates' results."""

    def __init__(self, topic: str, cause: str = "overflow"):
        super().__init__(
            f"device match overflow for topic {topic!r}; no fallback provided"
        )
        self.topic = topic
        self.cause = cause


CAUSES = ("too_deep", "frontier_overflow", "match_overflow")


class TpuMatcher:
    """Host-facing matcher over an `NfaBuilder` (emqx_tpu/ops/matcher.py:277):
    owns the NFA's device mirror, pads each batch to a power of two (at
    least 64 rows, as the reference does), runs `batch_match_bytes`,
    brings every output back in one copy and decodes the filter ids to
    names. A flagged row (too deep, frontier or match overflow, too long)
    gets ``fallback(topic)`` or, without a fallback, a `MatchError` in its
    slot.

    Records the `matcher.*` series of the reference into `metrics` (a
    `broker.metrics.Metrics`; the process-wide default when None):
    sync and match wall time, batch size, rows, fallback rows by cause."""

    def __init__(self, builder, config: MatcherConfig = MatcherConfig(), metrics=None,
                 device="cuda"):
        self.builder = builder
        if config.probes < MAX_PROBES:
            config = dataclasses.replace(config, probes=MAX_PROBES)
        self.config = config
        self.metrics = metrics if metrics is not None else default_metrics
        self._sync = DeviceSegmentManager(device, name="nfa")
        self.device = self._sync.device
        self._salt = 0

    def _tables(self):
        # churn reaches the device as O(delta) scatters, not full uploads
        self._salt = self.builder.salt
        t0 = time.perf_counter()
        tables = self._sync.sync(self.builder)
        self.metrics.observe("matcher.sync.seconds", time.perf_counter() - t0)
        return tables

    def match_batch(self, topics: Sequence[str], fallback=None) -> List:
        """Topic strings -> per row the matched filter names, the
        fallback's answer, or a `MatchError` (flagged rows)."""
        cfg = self.config
        tables = self._tables()
        B = len(topics)
        Bp = _pad_pow2(B, 64)
        mat, lens, too_long = encode_topics(list(topics), cfg.max_bytes)
        if Bp != B:
            mat = np.pad(mat, ((0, Bp - B), (0, 0)))
            lens = np.pad(lens, (0, Bp - B))
        t0 = time.perf_counter()
        matched, mcount, flags, causes = batch_match_bytes(
            tables,
            torch.from_numpy(mat).to(self.device),
            torch.from_numpy(lens).to(self.device),
            salt=self._salt,
            max_levels=cfg.max_levels,
            frontier=cfg.frontier,
            max_matches=cfg.max_matches,
            probes=cfg.probes,
        )
        # ONE device->host copy for the rows and their causes
        K = matched.shape[1]
        host = torch.cat(
            [matched[:B].reshape(-1), mcount[:B]]
            + [v[:B].to(torch.int32) for v in [flags] + [causes[c] for c in CAUSES]]
        ).cpu().numpy()
        matched = host[: B * K].reshape(B, K)
        mcount = host[B * K : B * K + B]
        rest = host[B * K + B :].reshape(1 + len(CAUSES), B).astype(bool)
        cause_rows = dict(zip(CAUSES, rest[1:]))
        flags = rest[0] | too_long
        self.metrics.inc("device.transfer.bytes", host.nbytes)
        self._record(B, time.perf_counter() - t0, flags, cause_rows, too_long)
        out: List = []
        for i in range(B):
            if flags[i]:
                out.append(MatchError(topics[i]) if fallback is None
                           else fallback(topics[i]))
                continue
            names = []
            for fid in matched[i, : mcount[i]]:
                name = self.builder.filter_name(int(fid))
                if name is not None:
                    names.append(name)
            out.append(names)
        return out

    def _record(self, B, wall_s, flags, causes, too_long) -> None:
        m = self.metrics
        m.observe("matcher.device.seconds", wall_s)
        m.observe("matcher.batch.size", B)
        m.inc("matcher.rows", B)
        fell = int(np.count_nonzero(flags))
        if not fell:
            return
        m.inc("matcher.fallback.rows", fell)
        # causes are independent bits: a row may count under two of them
        for cause, arr in causes.items():
            n = int(np.count_nonzero(arr))
            if n:
                m.inc(f"matcher.fallback.rows.{cause}", n)
        n_long = int(np.count_nonzero(too_long))
        if n_long:
            m.inc("matcher.fallback.rows.too_long", n_long)
