"""Deterministic fault injection for the serving pipeline: the port's copy
of `emqx_tpu/observe/faults.py` (`FaultError`, `FaultRule`,
`FaultInjector`, `default_faults`, `hit`), with the same sites, modes and
triggers, so a test arms the same rule in both packages.

Every fast path of the pipeline is also a way to fail: a launch, a
readback, a torn delta sync. This module makes those failures injectable,
so the degradation ladder (broker/degrade.py) is proven by tests rather
than by incidents.

Model: a registry of named fault SITES, each a single `faults.hit(site)`
call on the real code path. A site with no armed rule costs one dict
lookup. Armed rules fire one of four behaviours:

- ``raise``   raise `FaultError` at the site (the caller's recovery path
              takes over);
- ``delay``   sleep `delay_ms` at the site (a wedged readback);
- ``drop``    return "drop": the site interprets it (ingest sheds the
              enqueue);
- ``corrupt`` return "corrupt": the site treats its fresh state as torn
              (the delta sync rolls back to the last good epoch).

Triggers compose: fire on every `nth` call, with `probability`, at most
`max_fires` times (1 = one-shot). Tests arm rules directly
(`default_faults.arm(...)`, `disarm()` in teardown).

Every fire counts into the `faults.injected` series (when the injector
has a metrics sink) and the rule's own `fired` counter.

The sites the port calls: ``ingest.enqueue`` (broker/ingest.py),
``device.launch`` and ``device.readback`` (`DeviceRouter.route_prepared`
and its readback), ``router.delta_sync`` (`DeviceRouter.prepare`) and
``retained.storm`` (broker/retained_feed.py). ``cluster.forward`` and
``exhook.call`` are accepted and never hit: the port has no cluster bus
and no exhook sidecar.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

# every injectable site, in pipeline order (the reference's list)
SITES = (
    "ingest.enqueue",  # publish entering the batch window
    "device.launch",  # route_prepared kernel launch (pool thread)
    "device.readback",  # the device->host transfer of a routed batch
    "router.delta_sync",  # the mirrors' sync of a dirty prepare
    "retained.storm",  # fused retained-replay storm prepare
    "cluster.forward",  # cross-node send on the cluster bus
    "exhook.call",  # gRPC call into an exhook sidecar
)

MODES = ("raise", "delay", "drop", "corrupt")


class FaultError(RuntimeError):
    """An injected failure (mode=raise). Carries the site so recovery
    paths and tests can tell injected faults from organic ones."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


@dataclass
class FaultRule:
    """One armed behaviour at one site (mutable: carries fire counters)."""

    site: str
    mode: str = "raise"
    probability: float = 1.0
    nth: int = 0  # fire only on every nth eligible call (0 = every)
    max_fires: int = 0  # stop firing after this many (0 = unlimited)
    delay_ms: float = 0.0
    calls: int = 0  # guarded-by: injector lock
    fired: int = 0  # guarded-by: injector lock

    def to_json(self) -> Dict:
        return {
            "site": self.site,
            "mode": self.mode,
            "probability": self.probability,
            "nth": self.nth,
            "max_fires": self.max_fires,
            "delay_ms": self.delay_ms,
            "calls": self.calls,
            "fired": self.fired,
        }


class FaultInjector:
    """The site registry. One process-wide instance (`default_faults`)
    backs the module-level `hit()` the pipeline calls."""

    def __init__(self, metrics=None, seed: int = 0):
        self.metrics = metrics
        self._rules: Dict[str, FaultRule] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._rng = random.Random(seed)

    # -- control surface (tests) --------------------------------------------
    def arm(
        self,
        site: str,
        mode: str = "raise",
        probability: float = 1.0,
        nth: int = 0,
        max_fires: int = 0,
        delay_ms: float = 0.0,
    ) -> FaultRule:
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (one of {', '.join(SITES)})")
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (one of {', '.join(MODES)})")
        if not 0.0 <= probability <= 1.0:
            raise ValueError("fault probability must be in [0, 1]")
        rule = FaultRule(
            site=site,
            mode=mode,
            probability=float(probability),
            nth=int(nth),
            max_fires=int(max_fires),
            delay_ms=float(delay_ms),
        )
        with self._lock:
            self._rules[site] = rule
        return rule

    def disarm(self, site: Optional[str] = None) -> None:
        """Remove one site's rule, or every rule when `site` is None."""
        with self._lock:
            if site is None:
                self._rules.clear()
            else:
                self._rules.pop(site, None)

    def rules(self) -> List[Dict]:
        with self._lock:
            return [r.to_json() for r in self._rules.values()]

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    # -- the hot-path hook ----------------------------------------------------
    def hit(self, site: str) -> Optional[str]:
        """Consult the registry at a fault site.

        Disarmed: one dict lookup, returns None. Armed: evaluates the
        rule's triggers under the lock; a firing rule raises (`raise`),
        sleeps (`delay`: the launch and readback sites run on pool
        threads, the delta sync on the loop thread), or returns its mode
        string for the site to interpret (`drop`, `corrupt`). Non-firing
        calls return None."""
        rule = self._rules.get(site)
        if rule is None:
            return None
        with self._lock:
            rule = self._rules.get(site)
            if rule is None:
                return None
            rule.calls += 1
            if rule.max_fires and rule.fired >= rule.max_fires:
                return None
            if rule.nth > 1 and rule.calls % rule.nth:
                return None
            if rule.probability < 1.0 and self._rng.random() >= rule.probability:
                return None
            rule.fired += 1
        if self.metrics is not None:
            self.metrics.inc("faults.injected")
        if rule.mode == "delay":
            time.sleep(rule.delay_ms / 1e3)
            return "delay"
        if rule.mode == "raise":
            raise FaultError(site)
        return rule.mode  # "drop" | "corrupt"

    def snapshot(self) -> Dict:
        """Armed rules + aggregate counters."""
        rules = self.rules()
        return {
            "enabled": bool(rules),
            "sites": list(SITES),
            "modes": list(MODES),
            "rules": rules,
            "injected": (
                self.metrics.get("faults.injected")
                if self.metrics is not None
                else sum(r["fired"] for r in rules)
            ),
        }


# the process-wide injector every pipeline fault site consults; its owner
# wires a metrics sink in (`faults.injected` accounting)
default_faults = FaultInjector()


def hit(site: str) -> Optional[str]:
    """Module-level shorthand: `faults.hit("device.launch")`."""
    return default_faults.hit(site)
