"""Authoritative CPU topic trie for wildcard filters: the port's copy of
`emqx_tpu/broker/trie.py`, its code unchanged.

This is the *semantic reference*: the device matcher (`ops.nfa` /
`ops.matcher`) is held against it, and the broker falls back to it for
pathological inputs (topics deeper than the compiled level budget).

Capability parity with the reference trie (apps/emqx/src/emqx_trie.erl:29-35,
271-333): insert/delete of wildcard filters with prefix reference counting,
and `match(topic)` returning every stored filter matching the topic, with

- ``+`` matching exactly one level,
- ``#`` matching any suffix including the empty one (``a/#`` matches ``a``),
- root-level ``+``/``#`` never matching ``$``-prefixed topics
  (emqx_trie.erl:271-278).

Unlike the reference, which stores prefix-counted rows in a replicated mnesia
table (because match *and* update both walk ETS), this trie is a plain linked
node structure: the CPU side only needs single-key updates and occasional
fallback matches — batch matching happens on the device tables compiled from
the same insert/delete stream.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from emqx_tpu_torch.ops import topics as T


class _Node:
    __slots__ = ("children", "terminal", "refcount")

    def __init__(self) -> None:
        self.children: Dict[str, _Node] = {}
        # terminal > 0 => a filter ends here (refcount of identical inserts)
        self.terminal: int = 0
        # number of filters stored at or below this node
        self.refcount: int = 0


class TopicTrie:
    """Counted topic trie over level words; stores any topic filter."""

    def __init__(self) -> None:
        self._root = _Node()
        self._size = 0  # distinct filters

    def __len__(self) -> int:
        return self._size

    def is_empty(self) -> bool:
        return self._size == 0

    def insert(self, filter_: str) -> bool:
        """Insert a filter; returns True if it was newly added."""
        node = self._root
        path = [node]
        for w in T.words(filter_):
            node = node.children.setdefault(w, _Node())
            path.append(node)
        new = node.terminal == 0
        node.terminal += 1
        if new:
            for n in path:
                n.refcount += 1
            self._size += 1
        return new

    def delete(self, filter_: str) -> bool:
        """Remove a filter; returns True if it existed (fully removed)."""
        ws = T.words(filter_)
        path: List[tuple[_Node, str]] = []
        node = self._root
        for w in ws:
            child = node.children.get(w)
            if child is None:
                return False
            path.append((node, w))
            node = child
        if node.terminal == 0:
            return False
        node.terminal -= 1
        if node.terminal > 0:
            return False
        self._size -= 1
        self._root.refcount -= 1
        for parent, w in path:
            child = parent.children[w]
            child.refcount -= 1
            if child.refcount == 0:
                del parent.children[w]
        return True

    def has(self, filter_: str) -> bool:
        node = self._root
        for w in T.words(filter_):
            node = node.children.get(w)
            if node is None:
                return False
        return node.terminal > 0

    def filters(self) -> Iterator[str]:
        """Iterate all stored filters (depth-first)."""

        def walk(node: _Node, prefix: List[str]) -> Iterator[str]:
            if node.terminal:
                yield "/".join(prefix)
            for w, child in node.children.items():
                prefix.append(w)
                yield from walk(child, prefix)
                prefix.pop()

        for w, child in self._root.children.items():
            yield from walk(child, [w])

    def match(self, topic: str) -> List[str]:
        """All stored filters matching `topic` (exact filters included)."""
        ws = T.words(topic)
        acc: List[str] = []
        dollar = topic.startswith("$")

        def walk(node: _Node, i: int, prefix: List[str], root_level: bool) -> None:
            if i == len(ws):
                if node.terminal:
                    acc.append("/".join(prefix))
                hchild = node.children.get("#")
                if hchild is not None and hchild.terminal and not (root_level and dollar):
                    acc.append("/".join(prefix + ["#"]))
                return
            hchild = node.children.get("#")
            if hchild is not None and hchild.terminal and not (root_level and dollar):
                acc.append("/".join(prefix + ["#"]))
            w = ws[i]
            # children named '+'/'#' are wildcard branches, not literals: a
            # literal '+'/'#' character in a (malformed) topic must not take
            # them as an exact-word step (the reference cannot confuse the
            # two: its wildcard branch keys are atoms, topic words binaries)
            lit = node.children.get(w) if w not in ("+", "#") else None
            if lit is not None:
                prefix.append(w)
                walk(lit, i + 1, prefix, False)
                prefix.pop()
            if not (root_level and dollar):
                plus = node.children.get("+")
                if plus is not None:
                    prefix.append("+")
                    walk(plus, i + 1, prefix, False)
                    prefix.pop()

        walk(self._root, 0, [], True)
        return acc
