"""Node identity (reference analog: the Erlang node() name used in $SYS
topics): the port's copy of `emqx_tpu/utils/node.py`. The default name
and the `EMQX_TPU_NODE` override are the original's, so a rule's event
context names the same node in both packages; the app sets it from
`node.name` (`set_node_name`)."""

from __future__ import annotations

import os
import socket

_node_name: str | None = None


def node_name() -> str:
    global _node_name
    if _node_name is None:
        _node_name = os.environ.get(
            "EMQX_TPU_NODE", f"emqx_tpu@{socket.gethostname()}"
        )
    return _node_name


def set_node_name(name: str) -> None:
    global _node_name
    _node_name = name
