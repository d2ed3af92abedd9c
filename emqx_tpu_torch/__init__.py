"""emqx_tpu_torch: the PyTorch/CUDA port of emqx_tpu's device engine.

This package carries the single-device publish-routing path: host tables
(`ops.route_index.RouteIndex` with its shape index and residual NFA,
`models.router_model.SubscriberTable` as dense bitmaps or the CSR slot
lists of `ops.csr_table`, `models.router_model.GroupTable` for $share
groups) -> device mirrors (`ops.segments.DeviceSegmentManager`: full
upload on an epoch change, O(delta) `segment_scatter` otherwise) ->
hand-written CUDA kernels (tokenize, shape match, vocab lookup + NFA walk
for residual filters, fan-out OR + slot compaction or the CSR
gather-union, $share picks with their occurrence index) -> one coalesced
readback (`models.router_model.DeviceRouter`); and retained replay storms
(`models.retained_index.DeviceRetainedIndex`: the stored topics as the
batch, the storm's filters as a one-shot shape index, alone or riding a
routed batch as a `StormJob`); and the device session store
(`broker.session_store.SessionStore` over `ops.session_table.SessionTable`:
QoS1/QoS2 inflight writes and the retransmit/expiry sweep riding a routed
batch as a `SessionRider`, its outputs a `SessionStepOut`); and the
semantic routing plane and compiled rule masks
(`ops.semantic_table.SemanticTable`, the fifth mirrored table, and
`rules.compile.DeviceRuleFilter`: `DeviceRouter(semtab=...)
.route(topics, embeds=, rules=)` runs the similarity top-k and the WHERE
masks in the same call and the same readback); and all of it on a
('dp', 'tp') mesh of ranks (`parallel.mesh`, `parallel.launch`:
`MeshServingRouter` over sharded mirrors, the same kernels on each rank's
rows and shard, all-reduces and all-gathers on torch.distributed); and
the NFA-only step (`models.router_model.route_step`, on the mesh
`parallel.mesh.dist_route_step`) with its host-facing matcher
(`ops.matcher.TpuMatcher`); and the broker's synchronous publish path
(`broker.broker.Broker` over `broker.router.Router`: subscribe and
unsubscribe, plain and `$share`, `publish_batch` through one
`DeviceRouter.route` a batch, the CPU trie for small batches and flagged
rows); and the application around the broker (`app.BrokerApp`, built from
`config.schema.AppConfig` and started by `python -m emqx_tpu_torch`: the
MQTT wire codec `mqtt.frame`, channels and their manager
`broker.channel` / `broker.cm`, TCP and TLS listeners `transport`, durable
state with the segment-state snapshot `broker.persistent_session`, and
the housekeeping tick that drives the background compactor).

The package imports torch and numpy only — never jax, never emqx_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``, which
runs each kernel's plain PyTorch twin instead.
"""

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.router import Router
from emqx_tpu_torch.broker.session_store import SessionRider, SessionStepOut, SessionStore
from emqx_tpu_torch.convert import resolve_device, tables_to_device, upload
from emqx_tpu_torch.models.retained_index import DeviceRetainedIndex, StormJob
from emqx_tpu_torch.models.router_model import (
    DeviceRouter,
    GroupTable,
    MeshServingRouter,
    Prepared,
    RouteResult,
    SubscriberTable,
    route_step,
    shape_route_step,
)
from emqx_tpu_torch.ops.matcher import TpuMatcher
from emqx_tpu_torch.ops.route_index import RouteIndex
from emqx_tpu_torch.ops.segments import DeviceSegmentManager
from emqx_tpu_torch.ops.semantic_table import SemanticTable
from emqx_tpu_torch.ops.session_table import SessionTable
from emqx_tpu_torch.parallel.mesh import dist_route_step
from emqx_tpu_torch.rules.compile import DeviceRuleFilter, compile_where, extract_features

__all__ = [
    "Broker",
    "DeviceRetainedIndex",
    "DeviceRouter",
    "DeviceRuleFilter",
    "DeviceSegmentManager",
    "GroupTable",
    "MeshServingRouter",
    "Prepared",
    "RouteIndex",
    "RouteResult",
    "Router",
    "SemanticTable",
    "SessionRider",
    "SessionStepOut",
    "SessionStore",
    "SessionTable",
    "StormJob",
    "SubscriberTable",
    "TpuMatcher",
    "compile_where",
    "dist_route_step",
    "extract_features",
    "resolve_device",
    "route_step",
    "shape_route_step",
    "tables_to_device",
    "upload",
]
