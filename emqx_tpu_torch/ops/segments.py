"""Op-log plumbing shared by the host tables: the port's copy of the two
names `emqx_tpu/ops/segments.py:56-63` defines for them.

The device mirror itself (`DeviceSegmentManager` and its O(delta) scatter
kernel `segment_scatter_impl`) is not ported yet: `DeviceRouter.prepare`
re-uploads the whole table set when a table's version moves.
"""

from __future__ import annotations

RESYNC = "!resync"  # op-log marker: (RESYNC, array_name, 0)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
