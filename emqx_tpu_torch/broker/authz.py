"""Authorization rules (reference: apps/emqx_authz rule DSL,
emqx_authz_rule.erl + the file-ACL source; result cache as in
apps/emqx/src/emqx_authz_cache.erl).

Rule = (permit|deny, who, action, topics):
- who: 'all' | {'clientid': x} | {'username': x} | {'ipaddr': cidr-ish}
- action: 'publish' | 'subscribe' | 'all'
- topics: filters with ${clientid}/${username} placeholders; an 'eq ' prefix
  compares literally instead of wildcard-matching (reference eq semantics).

Folds over 'client.authorize'; first matching rule wins; default from
`no_match` (allow, as the reference ships). Per-client result cache keyed
(action, topic), invalidated by rule updates.

The port's copy of `emqx_tpu/broker/authz.py`, its code unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.ops import topics as T

Who = Union[str, Dict[str, str]]


@dataclass
class AclRule:
    permit: str  # 'allow' | 'deny'
    who: Who = "all"
    action: str = "all"  # 'publish' | 'subscribe' | 'all'
    topics: List[str] = field(default_factory=list)


class Authorizer:
    def __init__(
        self,
        rules: Optional[List[AclRule]] = None,
        no_match: str = "allow",
        deny_action: str = "ignore",
        cache_size: int = 1024,
        sources: Optional[List] = None,
        cache_ttl: float = 60.0,
    ):
        self.rules = rules or []
        self.no_match = no_match
        self.deny_action = deny_action
        # external sources consulted BEFORE the built-in rules, in order
        # (reference authz source chain: each answers allow/deny/ignore;
        # sources expose `async def check(ci, action, topic) -> str`)
        self.sources = sources or []
        self._cache: Dict[tuple, Tuple[str, float]] = {}
        self._cache_size = cache_size
        self._cache_ttl = cache_ttl
        self._epoch = 0

    def set_rules(self, rules: List[AclRule]) -> None:
        self.rules = rules
        self._cache.clear()
        self._epoch += 1

    def add_source(self, source) -> None:
        self.sources.append(source)
        self._cache.clear()

    def _who_matches(self, who: Who, ci: Dict) -> bool:
        if who == "all":
            return True
        if isinstance(who, dict):
            if "clientid" in who:
                return ci.get("client_id") == who["clientid"]
            if "username" in who:
                return ci.get("username") == who["username"]
            if "ipaddr" in who:
                return str(ci.get("peerhost", "")).startswith(
                    who["ipaddr"].rstrip("*")
                )
        return False

    def _topic_matches(self, topic: str, pattern: str, ci: Dict) -> bool:
        pattern = pattern.replace("${clientid}", ci.get("client_id", ""))
        pattern = pattern.replace("${username}", ci.get("username") or "")
        if pattern.startswith("eq "):
            return topic == pattern[3:]
        return T.match(topic, pattern)

    def _rules_check(self, ci: Dict, action: str, topic: str) -> str:
        """Built-in rule list -> allow | deny | ignore (no rule matched)."""
        for r in self.rules:
            if r.action not in (action, "all"):
                continue
            if not self._who_matches(r.who, ci):
                continue
            if any(self._topic_matches(topic, p, ci) for p in r.topics):
                return r.permit
        return "ignore"

    def _cache_key(self, ci: Dict, action: str, topic: str) -> tuple:
        # key must capture the full client identity: rules and placeholders
        # depend on username/peerhost too, and client_ids can be reused by
        # different principals across connections
        return (
            ci.get("client_id", ""),
            ci.get("username"),
            str(ci.get("peerhost", "")),
            action,
            topic,
        )

    def _cache_get(self, key) -> Optional[str]:
        hit = self._cache.get(key)
        if hit is None:
            return None
        result, expires = hit
        if time.monotonic() > expires:
            del self._cache[key]
            return None
        return result

    def _cache_put(self, key, result: str) -> None:
        if len(self._cache) >= self._cache_size:
            self._cache.clear()
        self._cache[key] = (result, time.monotonic() + self._cache_ttl)

    def check(self, ci: Dict, action: str, topic: str) -> str:
        """Sync path: built-in rules only (external sources are async)."""
        if ci.get("is_superuser"):
            return "allow"
        key = self._cache_key(ci, action, topic)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        result = self._rules_check(ci, action, topic)
        if result == "ignore":
            result = self.no_match
        self._cache_put(key, result)
        return result

    async def acheck(self, ci: Dict, action: str, topic: str) -> str:
        """Full path: external sources in order, then built-in rules, then
        no_match (reference source-chain semantics; result cached with
        TTL as in emqx_authz_cache)."""
        if ci.get("is_superuser"):
            return "allow"
        key = self._cache_key(ci, action, topic)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        result = "ignore"
        for src in self.sources:
            result = await src.check(ci, action, topic)
            if result in ("allow", "deny"):
                break
        if result == "ignore":
            result = self._rules_check(ci, action, topic)
        if result == "ignore":
            result = self.no_match
        self._cache_put(key, result)
        return result

    async def authorize(self, ci, action, topic, acc="allow"):
        """'client.authorize' fold callback (async: the channel folds via
        arun_fold, so a slow HTTP source suspends only that client).

        On deny, the fold result carries the configured deny_action: the
        channel drops the packet for 'ignore' and closes the connection for
        'disconnect' (reference authz.deny_action knob).
        """
        result = await self.acheck(ci, action, topic)
        if result != "deny":
            return None
        return (
            "stop",
            "disconnect" if self.deny_action == "disconnect" else "deny",
        )

    def attach(self, hooks: Hooks) -> None:
        hooks.add("client.authorize", self.authorize, priority=100)
