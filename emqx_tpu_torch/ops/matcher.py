"""Batched NFA topic matching: the port's copy of `MatcherConfig` and the
residual-NFA walk of `emqx_tpu/ops/matcher.py` (`batch_match_syms` with its
helpers `_probe_edges`, `_compact` and `_append`, :84-:214).

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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.ops.nfa import (
    EDGE_H_MUL_NODE,
    EDGE_H_MUL_SYM,
    EDGE_H_SHIFT,
    MAX_PROBES,
)
from emqx_tpu_torch.ops.u32 import M32, mul32, u32


@dataclass(frozen=True)
class MatcherConfig:
    """The fields of `MatcherConfig` (emqx_tpu/ops/matcher.py:46) that a
    caller of the port's serving path sets; the fan-out knobs
    (`fanout_compact`, `fanout_slots`) join with the first caller that
    sets them."""

    max_levels: int = 16  # topic depth budget (scan length)
    frontier: int = 32  # max simultaneous NFA states per topic
    max_matches: int = 64  # max matched filters per topic (NFA lane)
    # open-addressing probe bound; must cover the build-time bound
    # (nfa.MAX_PROBES) or lookups would silently miss — DeviceRouter clamps
    probes: int = MAX_PROBES
    max_bytes: int = 256  # topic byte budget for the tokenizer


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
    return (matched, mcount.clamp(max=K).to(torch.int32),
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


# frontier states live in shared memory, two buffers of F per warp; the
# launcher shrinks its block until they fit in 48 KB
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
