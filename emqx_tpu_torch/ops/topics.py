"""MQTT topic algebra.

Capability parity with the reference's `emqx_topic` module
(reference: apps/emqx/src/emqx_topic.erl:17-110): word split/join, wildcard
test, single-pair name-vs-filter match (including the `$`-prefix exclusion
rules), validation of names and filters, and `$share/<group>/<topic>` parsing.

Topics are plain Python strings here; the hot path never touches this module —
batch matching happens on padded byte tensors (`emqx_tpu_torch.ops.tokenizer`,
`emqx_tpu_torch.ops.shape_index`). The port's copy of `emqx_tpu/ops/topics.py`
without `systop`, which needs the broker's node name.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

MAX_TOPIC_LEN = 65535  # bytes (reference: emqx_topic.erl ?MAX_TOPIC_LEN)

SHARE_PREFIX = "$share"
SYS_PREFIX = "$SYS"


def words(topic: str) -> List[str]:
    """Split a topic into its level words. ``a//b`` -> ``['a', '', 'b']``."""
    return topic.split("/")


def join(ws: List[str]) -> str:
    return "/".join(ws)


def levels(topic: str) -> int:
    return len(words(topic))


def wildcard(topic_or_words) -> bool:
    """True if the filter contains ``+`` or ``#`` at any level."""
    ws = words(topic_or_words) if isinstance(topic_or_words, str) else topic_or_words
    return any(w in ("+", "#") for w in ws)


def is_dollar(topic: str) -> bool:
    """Topics beginning with ``$`` are excluded from root-level wildcards."""
    return topic.startswith("$")


def match(name: str, filter_: str) -> bool:
    """Does topic `name` match topic `filter_`?

    Implements MQTT matching semantics, including:
    - ``+`` matches exactly one level, ``#`` matches any suffix *including the
      empty suffix* (so ``a/#`` matches ``a``).
    - A ``$``-prefixed name never matches a filter starting with ``+`` or ``#``
      (reference: emqx_topic.erl match/2 clauses on ``<<$$, ...>>``).
    """
    if name.startswith("$") and (filter_.startswith("+") or filter_.startswith("#")):
        return False
    return match_words(words(name), words(filter_))


def match_words(nw: List[str], fw: List[str]) -> bool:
    i = 0
    nn, nf = len(nw), len(fw)
    while True:
        if i == nf:
            return i == nn
        f = fw[i]
        if f == "#":
            # '#' must be last; matches any remaining suffix incl. empty
            return True
        if i == nn:
            return False
        if f != "+" and f != nw[i]:
            return False
        i += 1


class TopicValidationError(ValueError):
    pass


def validate(topic: str, kind: str = "filter") -> None:
    """Validate a topic name or filter; raises TopicValidationError.

    Rules (reference: emqx_topic.erl validate/2, validate2/1, validate3/1):
    empty topic invalid; > 65535 bytes invalid; ``#`` only as last level;
    ``+``/``#`` must occupy a whole level; names must contain no wildcards;
    no NUL characters.
    """
    if topic == "":
        raise TopicValidationError("empty_topic")
    if len(topic.encode("utf-8", "surrogatepass")) > MAX_TOPIC_LEN:
        raise TopicValidationError("topic_too_long")
    if "\x00" in topic:
        raise TopicValidationError("topic_invalid_char")
    ws = words(topic)
    for i, w in enumerate(ws):
        if w == "#":
            if i != len(ws) - 1:
                raise TopicValidationError("'#' must be the last level")
        elif "#" in w or "+" in w:
            if w not in ("+", "#"):
                raise TopicValidationError(
                    "'+' and '#' must occupy an entire level: %r" % w
                )
    if kind == "name" and wildcard(ws):
        raise TopicValidationError("topic_name_error: wildcards not allowed in names")


def parse_share(topic: str) -> Tuple[Optional[str], str]:
    """Parse ``$share/<group>/<real topic>`` -> (group, real_topic).

    Returns (None, topic) for non-shared subscriptions.
    (reference: emqx_topic.erl parse/2)
    """
    if not topic.startswith(SHARE_PREFIX + "/"):
        return None, topic
    rest = topic[len(SHARE_PREFIX) + 1 :]
    group, sep, real = rest.partition("/")
    if not sep or group == "" or real == "":
        raise TopicValidationError("invalid_share_subscription: %r" % topic)
    if "+" in group or "#" in group:
        raise TopicValidationError("invalid_share_group: %r" % group)
    return group, real


def feed_var(var: str, value: str, topic: str) -> str:
    """Substitute a ``%c``/``%u``-style or ``${var}`` placeholder level."""
    return join([value if w == var else w for w in words(topic)])
