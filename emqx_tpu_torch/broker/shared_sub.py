"""Shared subscriptions: the port's copy of `stable_hash`
(`emqx_tpu/broker/shared_sub.py:23-31`), the hash the `hash_topic` $share
strategy picks by. The rest of the module (`SharedSub`, member delivery
and failover) comes with the port's broker.
"""

from __future__ import annotations

from typing import Optional


def stable_hash(s: Optional[str]) -> int:
    """FNV-1a 32-bit over the utf-8 bytes. Deterministic across runs and
    identical to the device-side pick input, unlike Python's randomized
    ``hash()`` (the reference uses erlang:phash2 the same way,
    emqx_shared_sub.erl:234-285)."""
    h = 0x811C9DC5
    for b in (s or "").encode("utf-8", "surrogatepass"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h
