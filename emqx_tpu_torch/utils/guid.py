"""Monotonic snowflake-style message ids: the port's copy of
`emqx_tpu/utils/guid.py` (reference: emqx_guid.erl)."""

from __future__ import annotations

import itertools
import os
import time

_node_bits = (os.getpid() & 0x3FF) << 22
_counter = itertools.count()


def next_guid() -> int:
    """53-ish bit id: ms timestamp | pid slice | sequence."""
    return (
        (int(time.time() * 1000) & 0x1FFFFFFFFFF) << 32
        | _node_bits
        | (next(_counter) & 0x3FFFFF)
    )
