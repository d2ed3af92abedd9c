"""Subscription-trie -> dense NFA table compiler (host side, incrementally
maintained): the port's copy of `emqx_tpu/ops/nfa.py`.

The route index keeps the filters the shape index rejects (more than
MAX_SHAPES shapes, or a 2^-64 combined-hash collision) in this automaton.
Its device walk is `tokenizer.vocab_lookup` (word hashes -> symbols) and
`matcher.batch_match_syms` (the level scan), kernels `vocab_lookup.cu`
and `nfa_walk.cu`; `word_hash_pair` and the hashing constants below are
the single definition those kernels and the tokenizer kernel reproduce
bit for bit.

Flat tables (`plus_child`, `hash_filter`, `term_filter`, the literal-edge
and vocab open-addressing tables) are the PRIMARY storage, mutated in place
per subscribe/unsubscribe and op-logged; structural events (growth,
rehash, salt change) bump `epoch`. Deletions leave tombstones
(edge_node = -2, vocab_sym = -3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from emqx_tpu_torch.ops import topics as T

# Polynomial-hash parameters; must match emqx_tpu_torch.ops.tokenizer exactly.
P1 = np.uint32(0x01000193)  # FNV prime, odd => invertible mod 2^32
P2 = np.uint32(0x00BC8F6B)  # odd
_SALT1 = np.uint32(0x9E3779B9)
_SALT2 = np.uint32(0x85EBCA6B)

MAX_PROBES = 8

# Slot-hash constants shared bit-for-bit by the host packers below and the
# device probe loops (matcher._probe_edges, tokenizer.vocab_lookup_device).
EDGE_H_MUL_NODE = 0x9E3779B1
EDGE_H_MUL_SYM = 0x85EBCA77
EDGE_H_SHIFT = 15
VOCAB_H_MUL = 0xC2B2AE3D
VOCAB_H_SHIFT = 13

PLUS_SYM = -2  # sentinel syms (never produced by vocab lookup)
HASH_SYM = -3

EDGE_TOMB = -2  # tombstoned edge slot (edge_node value)
VOCAB_TOMB = -3  # tombstoned vocab slot (vocab_sym value)


_M32 = 0xFFFFFFFF


def _mix32(x: int) -> int:
    """Murmur3-style finalizer (32-bit). Pure-int: this runs per-word on the
    subscribe path and numpy scalar math is ~10x slower."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def _poly_raw(word: bytes, P: int) -> int:
    h = 1  # == P^0; encodes length so "" hashes distinctly
    for c in word:
        h = (h * P + c) & _M32
    return h


def word_hash_pair(word: str, salt: int) -> Tuple[int, int]:
    """(h1, h2) for one word; the device tokenizer computes the same pair."""
    b = word.encode("utf-8", "surrogatepass")
    s1 = (salt * int(_SALT1) + 1) & _M32
    s2 = (salt * int(_SALT2) + 7) & _M32
    h1 = _mix32(_poly_raw(b, int(P1)) ^ s1)
    h2 = _mix32(_poly_raw(b, int(P2)) ^ s2)
    return h1, h2


def edge_slot_hash(node: int, sym: int) -> int:
    """Initial probe slot hash for the literal-edge table (pre-mask)."""
    h = (node * EDGE_H_MUL_NODE + sym * EDGE_H_MUL_SYM) & _M32
    h ^= h >> EDGE_H_SHIFT
    return h


def vocab_slot_hash(h1: int) -> int:
    h = (h1 * VOCAB_H_MUL) & _M32
    h ^= h >> VOCAB_H_SHIFT
    return h


@dataclass
class NfaTables:
    """Flat match tables; everything the device kernel needs.

    Arrays are VIEWS of the builder's live storage — valid until the next
    builder mutation. Consumers that need isolation across mutations copy."""

    plus_child: np.ndarray  # int32 [N]
    hash_filter: np.ndarray  # int32 [N]
    term_filter: np.ndarray  # int32 [N]
    edge_node: np.ndarray  # int32 [E]
    edge_sym: np.ndarray  # int32 [E]
    edge_child: np.ndarray  # int32 [E]
    vocab_h1: np.ndarray  # uint32 [V]
    vocab_h2: np.ndarray  # uint32 [V]
    vocab_sym: np.ndarray  # int32 [V]
    salt: int
    num_nodes: int
    num_filters: int
    version: int


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class NfaBuilder:
    """Incrementally maintained subscription automaton.

    add/remove mirror emqx_trie:insert/delete refcount semantics
    (emqx_trie.erl:170-199), mutating the flat device tables in place and
    op-logging every write (see module docstring). `pack()` is O(1): it
    hands out views of the live arrays.
    """

    ROOT = 0
    OPLOG_MAX = 65536
    _MIN_CAP = 1024

    def __init__(self) -> None:
        cap = self._MIN_CAP
        # node tables
        self._cap_nodes = cap
        self.arr_plus = np.full(cap, -1, np.int32)
        self.arr_hashf = np.full(cap, -1, np.int32)
        self.arr_term = np.full(cap, -1, np.int32)
        self._n_nodes = 1  # high-water node count (root pre-allocated)
        self._refs: List[int] = [0]  # filters at-or-below node
        self._free_nodes: List[int] = []
        # literal edges: authoritative dict + open-addressing device table
        self._edges: Dict[Tuple[int, int], int] = {}
        self._E = cap
        self.arr_edge_node = np.full(cap, -1, np.int32)
        self.arr_edge_sym = np.full(cap, -1, np.int32)
        self.arr_edge_child = np.full(cap, -1, np.int32)
        self._edge_fill = 0  # non-empty slots (live + tombstones)
        # vocab: word -> [sym, refcount]; device table keyed by hash pair
        self._vocab: Dict[str, List[int]] = {}
        self._hash_pairs: Dict[Tuple[int, int], str] = {}
        self._V = cap
        self.arr_vocab_h1 = np.zeros(cap, np.uint32)
        self.arr_vocab_h2 = np.zeros(cap, np.uint32)
        self.arr_vocab_sym = np.full(cap, -1, np.int32)
        self._vocab_fill = 0
        self._sym_words: List[Optional[str]] = []
        self._free_syms: List[int] = []
        # filters
        self._filter_ids: Dict[str, int] = {}
        self._id_filters: List[Optional[str]] = []
        self._free_filters: List[int] = []
        self._filter_refs: List[int] = []
        self.salt = 0
        self.epoch = 0  # full-device-resync marker
        self.oplog: List[Tuple[str, int, int]] = []
        self.version = 0

    # -- op-logged writes --------------------------------------------------
    def _log(self, name: str, idx: int, val: int) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            # cap the log: consumers that fell this far behind resync fully
            self._bump_epoch()
            return
        self.oplog.append((name, int(idx), int(val)))

    def _bump_epoch(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _set_plus(self, node: int, val: int) -> None:
        self.arr_plus[node] = val
        self._log("plus_child", node, val)

    def _set_hashf(self, node: int, val: int) -> None:
        self.arr_hashf[node] = val
        self._log("hash_filter", node, val)

    def _set_term(self, node: int, val: int) -> None:
        self.arr_term[node] = val
        self._log("term_filter", node, val)

    # -- vocab -------------------------------------------------------------
    def _vocab_place(self, h1: int, h2: int, sym: int) -> bool:
        """Probe-insert into the device vocab table; False if window full."""
        slot = vocab_slot_hash(h1) & (self._V - 1)
        for p in range(MAX_PROBES):
            idx = (slot + p) & (self._V - 1)
            s = self.arr_vocab_sym[idx]
            if s == -1 or s == VOCAB_TOMB:
                if s == -1:
                    self._vocab_fill += 1
                self.arr_vocab_h1[idx] = h1
                self._log("vocab_h1", idx, h1)
                self.arr_vocab_h2[idx] = h2
                self._log("vocab_h2", idx, h2)
                self.arr_vocab_sym[idx] = sym
                self._log("vocab_sym", idx, sym)
                return True
        return False

    def _vocab_rehash(self, newV: int) -> None:
        while True:
            h1a = np.zeros(newV, np.uint32)
            h2a = np.zeros(newV, np.uint32)
            syma = np.full(newV, -1, np.int32)
            ok = True
            for w, ent in self._vocab.items():
                sym, h1, h2 = ent[0], ent[2], ent[3]
                slot = vocab_slot_hash(h1) & (newV - 1)
                placed = False
                for p in range(MAX_PROBES):
                    idx = (slot + p) & (newV - 1)
                    if syma[idx] < 0:
                        h1a[idx], h2a[idx], syma[idx] = h1, h2, sym
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
            if ok:
                break
            newV *= 2
        self._V = newV
        self.arr_vocab_h1, self.arr_vocab_h2, self.arr_vocab_sym = h1a, h2a, syma
        self._vocab_fill = len(self._vocab)
        self._bump_epoch()

    def _salt_rebuild(self) -> None:
        """Hash-pair collision between distinct words: bump salt, rebuild."""
        for _ in range(16):
            self.salt += 1
            pairs: Dict[Tuple[int, int], str] = {}
            ok = True
            for w in self._vocab:
                p = word_hash_pair(w, self.salt)
                if p in pairs:
                    ok = False
                    break
                pairs[p] = w
            if ok:
                self._hash_pairs = pairs
                for w, ent in self._vocab.items():
                    ent[2], ent[3] = word_hash_pair(w, self.salt)
                self._vocab_rehash(self._V)
                return
        raise RuntimeError("vocab hash collisions persisted across 16 salts")

    def _sym_for(self, word: str, create: bool) -> int:
        ent = self._vocab.get(word)
        if ent is not None:
            if create:
                ent[1] += 1
            return ent[0]
        if not create:
            return -1
        if self._free_syms:
            sym = self._free_syms.pop()
            self._sym_words[sym] = word
        else:
            sym = len(self._sym_words)
            self._sym_words.append(word)
        h1, h2 = word_hash_pair(word, self.salt)
        self._vocab[word] = [sym, 1, h1, h2]
        other = self._hash_pairs.get((h1, h2))
        if other is not None and other != word:
            self._salt_rebuild()  # rehashes every word incl. this one
            return sym
        self._hash_pairs[(h1, h2)] = word
        if (self._vocab_fill + 1) * 2 > self._V:
            self._vocab_rehash(self._V * 2)
        elif not self._vocab_place(h1, h2, sym):
            self._vocab_rehash(self._V * 2)
        return sym

    def _sym_release(self, word: str) -> None:
        ent = self._vocab[word]
        ent[1] -= 1
        if ent[1] == 0:
            del self._vocab[word]
            self._sym_words[ent[0]] = None
            self._free_syms.append(ent[0])
            h1, h2 = ent[2], ent[3]
            self._hash_pairs.pop((h1, h2), None)
            slot = vocab_slot_hash(h1) & (self._V - 1)
            for p in range(MAX_PROBES):
                idx = (slot + p) & (self._V - 1)
                if (
                    self.arr_vocab_sym[idx] >= 0
                    and self.arr_vocab_h1[idx] == np.uint32(h1)
                    and self.arr_vocab_h2[idx] == np.uint32(h2)
                ):
                    self.arr_vocab_sym[idx] = VOCAB_TOMB
                    self._log("vocab_sym", idx, VOCAB_TOMB)
                    break
            # tombstone-heavy table: compact at the SAME size (without this,
            # churn of unique words ratchets fill up and doubles V forever)
            if (self._vocab_fill - len(self._vocab)) * 4 > self._V:
                self._vocab_rehash(self._V)

    # -- edges -------------------------------------------------------------
    def _edge_rehash(self, newE: int) -> None:
        while True:
            ena = np.full(newE, -1, np.int32)
            esa = np.full(newE, -1, np.int32)
            eca = np.full(newE, -1, np.int32)
            ok = True
            for (node, sym), child in self._edges.items():
                slot = edge_slot_hash(node, sym) & (newE - 1)
                placed = False
                for p in range(MAX_PROBES):
                    idx = (slot + p) & (newE - 1)
                    if ena[idx] == -1:
                        ena[idx], esa[idx], eca[idx] = node, sym, child
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
            if ok:
                break
            newE *= 2
        self._E = newE
        self.arr_edge_node, self.arr_edge_sym, self.arr_edge_child = (
            ena,
            esa,
            eca,
        )
        self._edge_fill = len(self._edges)
        self._bump_epoch()

    def _edge_insert(self, node: int, sym: int, child: int) -> None:
        self._edges[(node, sym)] = child
        if (self._edge_fill + 1) * 2 > self._E:
            self._edge_rehash(self._E * 2)  # places the new edge too
            return
        slot = edge_slot_hash(node, sym) & (self._E - 1)
        for p in range(MAX_PROBES):
            idx = (slot + p) & (self._E - 1)
            n = self.arr_edge_node[idx]
            if n == -1 or n == EDGE_TOMB:
                if n == -1:
                    self._edge_fill += 1
                self.arr_edge_node[idx] = node
                self._log("edge_node", idx, node)
                self.arr_edge_sym[idx] = sym
                self._log("edge_sym", idx, sym)
                self.arr_edge_child[idx] = child
                self._log("edge_child", idx, child)
                return
        self._edge_rehash(self._E * 2)

    def _edge_delete(self, node: int, sym: int) -> None:
        del self._edges[(node, sym)]
        slot = edge_slot_hash(node, sym) & (self._E - 1)
        for p in range(MAX_PROBES):
            idx = (slot + p) & (self._E - 1)
            if (
                self.arr_edge_node[idx] == node
                and self.arr_edge_sym[idx] == sym
            ):
                self.arr_edge_node[idx] = EDGE_TOMB
                self._log("edge_node", idx, EDGE_TOMB)
                break
        # tombstone-heavy table: compact in place (drops tombstones)
        if (self._edge_fill - len(self._edges)) * 4 > self._E:
            self._edge_rehash(self._E)

    # -- nodes -------------------------------------------------------------
    def _grow_nodes(self) -> None:
        cap = self._cap_nodes * 2
        for name in ("arr_plus", "arr_hashf", "arr_term"):
            old = getattr(self, name)
            new = np.full(cap, -1, np.int32)
            new[: len(old)] = old
            setattr(self, name, new)
        self._cap_nodes = cap
        self._bump_epoch()

    def _new_node(self) -> int:
        if self._free_nodes:
            n = self._free_nodes.pop()
            if self.arr_plus[n] != -1:
                self._set_plus(n, -1)
            if self.arr_hashf[n] != -1:
                self._set_hashf(n, -1)
            if self.arr_term[n] != -1:
                self._set_term(n, -1)
            self._refs[n] = 0
            return n
        n = self._n_nodes
        self._n_nodes += 1
        if n >= self._cap_nodes:
            self._grow_nodes()
        self._refs.append(0)
        return n

    # -- filters -----------------------------------------------------------
    def _filter_id(self, filter_: str) -> int:
        fid = self._filter_ids.get(filter_)
        if fid is not None:
            return fid
        if self._free_filters:
            fid = self._free_filters.pop()
            self._id_filters[fid] = filter_
            self._filter_refs[fid] = 0
        else:
            fid = len(self._id_filters)
            self._id_filters.append(filter_)
            self._filter_refs.append(0)
        self._filter_ids[filter_] = fid
        return fid

    def filter_name(self, fid: int) -> Optional[str]:
        return self._id_filters[fid] if 0 <= fid < len(self._id_filters) else None

    def filter_id(self, filter_: str) -> Optional[int]:
        """Stable id of a live filter (None if not present)."""
        return self._filter_ids.get(filter_)

    def __len__(self) -> int:
        return len(self._filter_ids)

    @property
    def num_filters_capacity(self) -> int:
        return len(self._id_filters)

    # -- public mutation ---------------------------------------------------
    def _adopt_fid(self, filter_: str, fid: int) -> None:
        """Register an externally-allocated filter id (RouteIndex shares one
        fid space between the shape index and this residual engine)."""
        while len(self._id_filters) <= fid:
            self._id_filters.append(None)
            self._filter_refs.append(0)
        self._filter_ids[filter_] = fid
        self._id_filters[fid] = filter_

    def add(self, filter_: str, fid: Optional[int] = None) -> int:
        """Insert a topic filter; returns its stable filter id (refcounted).

        O(words) — array writes + op-log appends; never a table rebuild
        except amortized growth/rehash.
        """
        T.validate(filter_)  # before any mutation: invalid input must not corrupt state
        if fid is None:
            fid = self._filter_id(filter_)
        else:
            self._adopt_fid(filter_, fid)
        if self._filter_refs[fid] > 0:
            self._filter_refs[fid] += 1
            return fid
        self._filter_refs[fid] = 1
        ws = T.words(filter_)
        node = self.ROOT
        path = [node]
        for i, w in enumerate(ws):
            last = i == len(ws) - 1
            if w == "#":
                self._set_hashf(node, fid)
                break
            if w == "+":
                child = int(self.arr_plus[node])
                if child < 0:
                    child = self._new_node()
                    self._set_plus(node, child)
            else:
                sym = self._sym_for(w, create=True)
                key = (node, sym)
                child = self._edges.get(key, -1)
                if child < 0:
                    child = self._new_node()
                    self._edge_insert(node, sym, child)
            node = child
            path.append(node)
            if last:
                self._set_term(node, fid)
        for n in path:
            self._refs[n] += 1
        return fid

    def remove(self, filter_: str) -> bool:
        """Delete one reference to a filter; True when fully removed."""
        fid = self._filter_ids.get(filter_)
        if fid is None or self._filter_refs[fid] == 0:
            return False
        self._filter_refs[fid] -= 1
        if self._filter_refs[fid] > 0:
            return False
        del self._filter_ids[filter_]
        self._id_filters[fid] = None
        self._free_filters.append(fid)
        ws = T.words(filter_)
        node = self.ROOT
        steps: List[Tuple[int, str, int]] = []  # (parent, word, child)
        for i, w in enumerate(ws):
            if w == "#":
                self._set_hashf(node, -1)
                break
            child = (
                int(self.arr_plus[node])
                if w == "+"
                else self._edges.get((node, self._sym_for(w, create=False)), -1)
            )
            steps.append((node, w, child))
            node = child
            if i == len(ws) - 1:
                self._set_term(node, -1)
        self._refs[self.ROOT] -= 1
        for parent, w, child in steps:
            self._refs[child] -= 1
            if self._refs[child] == 0:
                if w == "+":
                    self._set_plus(parent, -1)
                else:
                    sym = self._vocab[w][0]
                    self._edge_delete(parent, sym)
                self._free_nodes.append(child)
            if w not in ("+", "#"):
                self._sym_release(w)
        return True

    # -- packing (O(1): views over live storage) ---------------------------
    def pack(self) -> NfaTables:
        return NfaTables(
            plus_child=self.arr_plus,
            hash_filter=self.arr_hashf,
            term_filter=self.arr_term,
            edge_node=self.arr_edge_node,
            edge_sym=self.arr_edge_sym,
            edge_child=self.arr_edge_child,
            vocab_h1=self.arr_vocab_h1,
            vocab_h2=self.arr_vocab_h2,
            vocab_sym=self.arr_vocab_sym,
            salt=self.salt,
            num_nodes=self._n_nodes,
            num_filters=len(self._id_filters),
            version=self.version,
        )

    def device_snapshot(self) -> Dict[str, np.ndarray]:
        """Host arrays for a full device upload."""
        return {
            "plus_child": self.arr_plus,
            "hash_filter": self.arr_hashf,
            "term_filter": self.arr_term,
            "edge_node": self.arr_edge_node,
            "edge_sym": self.arr_edge_sym,
            "edge_child": self.arr_edge_child,
            "vocab_h1": self.arr_vocab_h1,
            "vocab_h2": self.arr_vocab_h2,
            "vocab_sym": self.arr_vocab_sym,
        }

    # -- host-side tokenization (exact; used by tests and CPU fallback) ----
    def tokenize_host(self, topic: str, max_levels: int):
        """-> (syms int32[max_levels], nwords, is_dollar, too_deep)."""
        ws = T.words(topic)
        syms = np.full(max_levels, -1, dtype=np.int32)
        for i, w in enumerate(ws[:max_levels]):
            ent = self._vocab.get(w)
            syms[i] = ent[0] if ent is not None else -1
        return syms, len(ws), topic.startswith("$"), len(ws) > max_levels
