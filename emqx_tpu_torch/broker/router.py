"""Route table: exact-topic index + wildcard trie + the device batch engine.
The port's copy of `Router` (emqx_tpu/broker/router.py:29-128).

Parity with the reference's split storage (apps/emqx/src/emqx_router.erl:
111-125: plain topics go straight into the route table, wildcard topics
also enter the trie; match = trie match + direct lookup, :128-141):

- exact (non-wildcard) filters: refcounted dict, O(1) lookup per topic;
- wildcard filters: the authoritative CPU trie (`TopicTrie`);
- BOTH feed the `RouteIndex` (shape-hash fast path + residual NFA,
  ops/route_index.py), so the device batch path resolves every filter kind
  in one step and the CPU path is only a correctness fallback and the
  small-batch shortcut.

`match_batch` takes the device when the batch reaches `min_tpu_batch`,
through a lazy match-only `DeviceRouter` on `device`, and falls back to
`match` for every row the device flags. `Router.mesh` (a
`parallel.mesh.Mesh`, set beside `Broker.mesh` before the first device
match) hands the mesh to that router: its match tables then sit whole on
the rank's device and each rank matches on its own, with no collective.

A `Router` pickles (segment-state snapshots,
`ops.segments.SegmentStateSnapshot`) without its lazy matcher, which holds
tensors, and without its mesh, which holds a process group: a restored
router rebuilds its matcher on its own `device` at first use, and the
restoring process attaches its own mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from emqx_tpu_torch.broker.trie import TopicTrie
from emqx_tpu_torch.models.router_model import DeviceRouter
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.ops.matcher import MatcherConfig
from emqx_tpu_torch.ops.route_index import RouteIndex


class Router:
    def __init__(
        self,
        matcher_config: Optional[MatcherConfig] = None,
        min_tpu_batch: int = 64,
        enable_tpu: bool = True,
        device="cuda",
    ):
        """`device`: where the device engines (this router's matcher and
        the broker's `DeviceRouter`) run; CUDA by default, and building
        one without CUDA raises unless ``device="cpu"`` (the kernels'
        plain twins)."""
        self._exact: Dict[str, int] = {}
        self._trie = TopicTrie()
        self._index = RouteIndex()
        self._matcher = None  # lazy match-only DeviceRouter
        self._matcher_config = matcher_config or MatcherConfig()
        self.min_tpu_batch = min_tpu_batch
        self.enable_tpu = enable_tpu
        self.device = device
        # this rank of a ('dp', 'tp') mesh, set beside `Broker.mesh`: the
        # lazy match-only router is built on it
        self.mesh = None

    def __getstate__(self):
        # segment-state snapshots pickle the router; the lazy
        # DeviceRouter holds tensors and is rebuilt on first use after a
        # restore. The mesh holds a process group (unpicklable by
        # design): the restoring process attaches its OWN mesh.
        d = self.__dict__.copy()
        d["_matcher"] = None
        d["mesh"] = None
        return d

    def __len__(self) -> int:
        return len(self._exact) + len(self._trie)

    def topics(self) -> List[str]:
        return list(self._exact) + list(self._trie.filters())

    def has_route(self, filter_: str) -> bool:
        return filter_ in self._exact or self._trie.has(filter_)

    def add_route(self, filter_: str) -> int:
        """Refcounted insert (one ref per subscriber entry). Returns the
        filter id so subscribe-storm callers skip a registry re-probe."""
        fid = self._index.add(filter_)
        if T.wildcard(filter_):
            self._trie.insert(filter_)
        else:
            self._exact[filter_] = self._exact.get(filter_, 0) + 1
        return fid

    def delete_route(self, filter_: str) -> None:
        self._index.remove(filter_)
        if T.wildcard(filter_):
            self._trie.delete(filter_)
        else:
            n = self._exact.get(filter_, 0) - 1
            if n > 0:
                self._exact[filter_] = n
            else:
                self._exact.pop(filter_, None)

    # -- matching ---------------------------------------------------------
    def match(self, topic: str) -> List[str]:
        """CPU single-topic match: direct lookup + trie walk."""
        out = []
        if topic in self._exact:
            out.append(topic)
        out.extend(self._trie.match(topic))
        return out

    def match_batch(self, topics: Sequence[str]) -> List[List[str]]:
        if not self.enable_tpu or len(topics) < self.min_tpu_batch:
            return [self.match(t) for t in topics]
        return self.matcher.match_batch(topics, fallback=self.match)

    def filter_id(self, filter_: str) -> Optional[int]:
        return self._index.filter_id(filter_)

    def filter_name(self, fid: int) -> Optional[str]:
        return self._index.filter_name(fid)

    @property
    def index(self) -> RouteIndex:
        return self._index

    @property
    def matcher(self):
        """Match-only device engine (its own table mirror; the broker's
        fan-out DeviceRouter keeps a separate one)."""
        if self._matcher is None:
            self._matcher = DeviceRouter(self._index, None, self._matcher_config,
                                         device=self.device, mesh=self.mesh)
        return self._matcher

    @property
    def matcher_config(self) -> MatcherConfig:
        return self._matcher_config
