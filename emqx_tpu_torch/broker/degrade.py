"""The part of the graceful-degradation controller that `BatchIngest`
reads: the port's copy of `IngestShed` and the breaker state names
(emqx_tpu/broker/degrade.py:41-53).

`Breaker` and `DegradeController` come with the app (ROADMAP item 10).
Until then the port's `Broker` has no `degrade` attribute set, and
`BatchIngest` takes the reference's path for a broker without one: no
breaker gate, and a failed launch fails its batch's publishes.
"""

from __future__ import annotations

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"


class IngestShed(RuntimeError):
    """The ingest gate refused an enqueue (overload / open breaker past
    the queue bound). Backpressure, not loss: the publisher's PUBACK
    fails and a QoS>=1 client retries — the queue never grows unbounded
    behind a broken device path."""
