"""Broker half of the semantic routing plane: the port's copy of
`emqx_tpu/broker/semantic.py` (`decode_embedding`, `_user_props`,
`SemanticRouting`), unchanged but for the modules it imports (the port's
`ops/topics.py` and `ops/semantic_table.py`). The REST intake the text
below names belongs to the management API, which the port does not have
yet (ROADMAP item 10.3d).

`SemanticRouting` owns the `SemanticTable` (ops/semantic_table.py) and
everything host-side around it:

- **intake**: embedding filters arrive on SUBSCRIBE as MQTT5 user
  properties (``semantic-embedding`` = JSON float list or base64 f32le,
  optional ``semantic-threshold``) or through
  ``POST /api/v5/semantic/filters`` (mgmt/api.py); per-message query
  embeddings ride PUBLISH user properties the same way, with
  ``msg.headers["semantic_embedding"]`` as the copy-free internal path
  (bench drivers, bridges);
- **binding**: an entry binds to the subscription's fan-out SLOT
  (`Broker._slot_subs`) and optionally its topic-filter fid — semantic
  hits come back from the device as ordinary slot recipients, so
  dispatch needs zero new fan-out machinery;
- **host twin** (`host_route`): the authoritative numpy evaluator —
  the degrade target for CPU-fallback batches and single-message
  paths, and the reference the differential tests (and the
  `semantic_vs_host_filter_x` bench headline) compare against.

Delivery semantics: a subscription WITH an embedding filter delivers
when its topic scope matches AND similarity clears the threshold
(it is NOT in the plain subscriber table); an unscoped filter (REST,
or a ``#`` subscribe) delivers on similarity alone. Fan-out per
message is bounded by top-k BY DESIGN — "route to the k most similar
subscribers" — on a mesh the pick is per 'tp' shard (a bounded
superset: at most topk x tp winners). Retained replay is NOT
semantically filtered (replay runs before any message embedding
exists); live routing is the plane's scope.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.ops.semantic_table import SemanticTable, normalize

# MQTT5 user-property keys (SUBSCRIBE and PUBLISH)
PROP_EMBEDDING = "semantic-embedding"
PROP_THRESHOLD = "semantic-threshold"
# internal fast path: a ready np/list embedding in the message headers
HDR_EMBEDDING = "semantic_embedding"


def decode_embedding(value, dim: int) -> np.ndarray:
    """Wire formats: JSON float list (starts with '[') or base64 of
    little-endian f32 bytes. Raises ValueError on anything else."""
    if isinstance(value, (list, tuple, np.ndarray)):
        return normalize(value, dim)
    if isinstance(value, bytes):
        value = value.decode("utf-8", "replace")
    v = value.strip()
    if v.startswith("["):
        return normalize(json.loads(v), dim)
    raw = base64.b64decode(v, validate=True)
    if len(raw) != dim * 4:
        raise ValueError(
            f"embedding payload is {len(raw)}B, expected {dim * 4}"
        )
    return normalize(np.frombuffer(raw, "<f4"), dim)


def _user_props(properties: Optional[Dict]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for k, v in (properties or {}).get("User-Property", ()):
        out.setdefault(k, v)
    return out


class SemanticRouting:
    """Embedding-filter registry + host evaluator, attached to a Broker
    as ``broker.semantic`` (app.py wires it from `semantic.*` config)."""

    def __init__(self, dim: int = 64, topk: int = 16,
                 threshold: float = 0.75, dtype: str = "float32",
                 shards: int = 1, metrics=None):
        self.table = SemanticTable(
            dim=dim, topk=topk, shards=shards, dtype=dtype
        )
        self.default_threshold = float(threshold)
        self.metrics = metrics
        # slot -> (sid, scope filter name | None, threshold); the REST
        # listing and the host twin's scope checks read this
        self._by_slot: Dict[int, Tuple[str, Optional[str], float]] = {}

    def __len__(self) -> int:
        return len(self.table)

    # -- intake -------------------------------------------------------------
    def parse_subscribe(self, properties: Optional[Dict]):
        """SUBSCRIBE properties -> (vec, threshold) or None (no
        embedding filter requested). Raises ValueError on a malformed
        embedding — the channel maps it to an error reason code."""
        props = _user_props(properties)
        raw = props.get(PROP_EMBEDDING)
        if raw is None:
            return None
        vec = decode_embedding(raw, self.table.dim)
        th = props.get(PROP_THRESHOLD)
        return vec, (
            float(th) if th is not None else self.default_threshold
        )

    def embedding_of(self, msg) -> Optional[np.ndarray]:
        """Per-message query embedding: headers fast path first, then
        the PUBLISH user property. None = no embedding (the row rides a
        zero vector — matches nothing at any positive threshold)."""
        e = msg.headers.get(HDR_EMBEDDING)
        if e is None:
            raw = _user_props(msg.properties).get(PROP_EMBEDDING)
            if raw is None:
                return None
            try:
                e = decode_embedding(raw, self.table.dim)
            except (ValueError, TypeError):
                if self.metrics is not None:
                    self.metrics.inc("semantic.embed.rejected")
                return None
            msg.headers[HDR_EMBEDDING] = e  # decode once per message
            return e
        try:
            return normalize(e, self.table.dim)
        except ValueError:
            if self.metrics is not None:
                self.metrics.inc("semantic.embed.rejected")
            return None

    def embed_batch(self, msgs) -> Optional[np.ndarray]:
        """[B, D] f32 query matrix, or None when NO row carries an
        embedding (the semantic stage still runs — zero rows match
        nothing — but the host skips building the matrix)."""
        out = None
        for i, m in enumerate(msgs):
            e = self.embedding_of(m)
            if e is None:
                continue
            if out is None:
                out = np.zeros((len(msgs), self.table.dim), np.float32)
            out[i] = e
        return out

    # -- binding ------------------------------------------------------------
    def attach(self, sid: str, slot: int, vec, threshold: float,
               fid: int = -1, scope: Optional[str] = None) -> None:
        """Bind (or replace) the embedding filter on a subscriber slot.
        `fid`/`scope` carry the topic-filter binding (fid for the
        device mask, the filter NAME for the host twin's T.match)."""
        self.table.add(slot, vec, threshold, fid=fid)
        self._by_slot[slot] = (sid, scope, float(threshold))
        if self.metrics is not None:
            self.metrics.gauge_set("semantic.filters", len(self.table))

    def detach(self, slot: int) -> bool:
        ok = self.table.remove(slot)
        self._by_slot.pop(slot, None)
        if ok and self.metrics is not None:
            self.metrics.gauge_set("semantic.filters", len(self.table))
        return ok

    def entries(self) -> List[Dict]:
        """REST listing (GET /api/v5/semantic/filters)."""
        out = []
        for slot, fid, th in self.table.entries():
            sid, scope, _th = self._by_slot.get(slot, ("?", None, th))
            out.append({
                "slot": slot,
                "clientid": sid,
                "topic_filter": scope,
                "fid": fid,
                "threshold": th,
            })
        return out

    # -- host twin ----------------------------------------------------------
    def host_route(self, msgs) -> List[List[int]]:
        """Authoritative numpy evaluation: per-message qualifying slots,
        GLOBAL top-k by similarity (the single-device kernel's
        semantics). The degrade target for CPU-fallback batches and the
        differential reference for the fused path."""
        n = len(msgs)
        if not len(self.table):
            return [[] for _ in range(n)]
        vecs, slots, fids, ths = self.table.live_arrays()
        q = self.embed_batch(msgs)
        if q is None:
            if self.metrics is not None:
                self.metrics.inc("semantic.host.batches")
            return [[] for _ in range(n)]
        sims = q @ vecs.T  # [B, E]
        out: List[List[int]] = []
        k = self.table.topk
        for i, m in enumerate(msgs):
            ok = sims[i] >= ths
            if not ok.any():
                out.append([])
                continue
            idx = np.nonzero(ok)[0]
            topic = m.topic
            keep = []
            for j in idx:
                if fids[j] >= 0:
                    _sid, scope, _t = self._by_slot.get(
                        int(slots[j]), (None, None, 0.0)
                    )
                    if scope is None or not T.match(topic, scope):
                        continue
                keep.append(j)
            if len(keep) > k:
                keep = sorted(keep, key=lambda j: -sims[i][j])[:k]
            out.append([int(slots[j]) for j in keep])
        if self.metrics is not None:
            self.metrics.inc("semantic.host.batches")
            self.metrics.inc(
                "semantic.host.matches", sum(len(r) for r in out)
            )
        return out

    def status(self) -> Dict:
        out = self.table.status()
        out["default_threshold"] = self.default_threshold
        return out
