"""emqx_tpu_torch: the PyTorch/CUDA port of emqx_tpu's device engine.

This slice carries the single-device, shape-index publish-routing path:
host tables (`ops.route_index.RouteIndex`, `models.router_model.
SubscriberTable`) -> upload (`convert.tables_to_device`) -> four
hand-written CUDA kernels (tokenize, shape match, fan-out OR, slot
compaction) -> one coalesced readback (`models.router_model.DeviceRouter`).

The package imports torch and numpy only — never jax, never emqx_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``, which
runs each kernel's plain PyTorch twin instead.
"""

from emqx_tpu_torch.convert import resolve_device, tables_to_device
from emqx_tpu_torch.models.router_model import (
    DeviceRouter,
    RouteResult,
    SubscriberTable,
    shape_route_step,
)
from emqx_tpu_torch.ops.route_index import RouteIndex

__all__ = [
    "DeviceRouter",
    "RouteIndex",
    "RouteResult",
    "SubscriberTable",
    "resolve_device",
    "shape_route_step",
    "tables_to_device",
]
