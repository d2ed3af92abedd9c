"""Matcher configuration: the port's copy of `MatcherConfig`
(emqx_tpu/ops/matcher.py:46), trimmed to the fields a caller of the
shape-index serving path sets.

The NFA walk of that module (`batch_match_syms` with `_probe_edges`,
`_compact` and `_append`) is the next slice of the port; its fields
(`frontier`, `max_matches`) join this class with it, and the fan-out
knobs (`fanout_compact`, `fanout_slots`) with the first caller that sets
them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MatcherConfig:
    max_levels: int = 16  # topic depth budget
    max_bytes: int = 256  # topic byte budget for the tokenizer
