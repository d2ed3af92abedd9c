"""The part of the MQTT packet model the port's broker uses: the QoS
levels and `SubOpts`, copied from `emqx_tpu/mqtt/packet.py:44`, `:198`.
The packet classes and the wire codec come with a later slice of the
port (the connection layer)."""

from __future__ import annotations

from dataclasses import dataclass

QOS0, QOS1, QOS2 = 0, 1, 2


@dataclass
class SubOpts:
    qos: int = QOS0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0
