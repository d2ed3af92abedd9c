"""Rule registry + runtime wiring + outputs: the port's copy of
`emqx_tpu/rules/engine.py` (`Republish`, `Console`, `FunctionOutput`,
`Rule`, `RuleMetrics`, `RuleEngine`, `test_sql`), unchanged but for the
modules it imports (the port's own).

The device plane: `attach_device` makes the engine the broker's
`rule_hook`. The broker's batch paths then mark each message
(``_batch_rules``), the publish hook skips the compiled rules for marked
messages, every device batch carries the compiled WHERE programs and the
batch's features into `DeviceRouter.route_prepared` (one `rule_masks`
launch), and `fire_settled` fires them when the batch settles, from the
readback's masks, or through the numpy host ladder
(`DeviceRuleFilter.host_masks`) for a CPU batch or a rule set that changed
while the batch was in flight.

Reference analog: emqx_rule_engine.erl (registry/metrics),
emqx_rule_outputs.erl (republish/console/custom function),
emqx_plugin_libs' emqx_placeholder (${var} templating),
emqx_rule_sqltester (test_sql).
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.message import Message
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.rules import events as EV
from emqx_tpu_torch.rules.compile import DeviceRuleFilter
from emqx_tpu_torch.rules.runtime import apply_query
from emqx_tpu_torch.rules.sql import Query, parse_sql
from emqx_tpu_torch.utils.placeholder import render as render_template

log = logging.getLogger("emqx_tpu_torch.rules")


# -- outputs -----------------------------------------------------------------

class Output:
    name = "output"

    def run(self, engine: "RuleEngine", rule: "Rule", row: Dict, ctx: Dict):
        raise NotImplementedError


class Republish(Output):
    """Publish the rule result back into the broker
    (emqx_rule_outputs republish)."""

    name = "republish"

    def __init__(
        self,
        topic: str,
        payload: str = "${payload}",
        qos: int = 0,
        retain: bool = False,
    ):
        self.topic = topic
        self.payload = payload
        self.qos = qos
        self.retain = retain

    def run(self, engine, rule, row, ctx):
        env = dict(ctx)
        env.update(row)
        topic = render_template(self.topic, env)
        if self.payload == "${payload}" and "payload" not in env:
            payload = json.dumps(row).encode()
        else:
            payload = render_template(self.payload, env).encode()
        msg = Message(
            topic=topic,
            payload=payload,
            qos=self.qos,
            retain=self.retain,
            from_client=ctx.get("clientid") or "rule_engine",
        )
        # guard against a rule republishing into its own FROM clause forever
        msg.headers["from_rule"] = rule.id
        engine.broker.publish(msg)


class Console(Output):
    """Log the result (emqx_rule_outputs console)."""

    name = "console"

    def run(self, engine, rule, row, ctx):
        log.info("rule %s output: %s", rule.id, row)
        engine.console_log.append((rule.id, row))


class FunctionOutput(Output):
    """Custom callable — the seam data bridges plug into
    (reference: bridge outputs resolve to connector sends)."""

    name = "function"

    def __init__(self, fn: Callable[[Dict, Dict], None], name: str = "function"):
        self.fn = fn
        self.name = name

    def run(self, engine, rule, row, ctx):
        self.fn(row, ctx)


@dataclass
class RuleMetrics:
    matched: int = 0
    passed: int = 0
    failed: int = 0
    no_result: int = 0
    outputs_success: int = 0
    outputs_failed: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class Rule:
    id: str
    sql: str
    outputs: List[Output]
    description: str = ""
    enabled: bool = True
    query: Query = None  # type: ignore[assignment]
    metrics: RuleMetrics = field(default_factory=RuleMetrics)

    def __post_init__(self):
        if self.query is None:
            self.query = parse_sql(self.sql)


class RuleEngine:
    MAX_CHAIN_DEPTH = 5  # republish -> event -> republish chains

    def __init__(self, broker) -> None:
        self.broker = broker
        self._rules: Dict[str, Rule] = {}
        self._lock = threading.Lock()
        self.console_log: List = []
        self._depth = threading.local()
        # DeviceRuleFilter (rules/compile.py): compiled WHERE programs
        # evaluated inside serving launches (docs/semantic_routing.md).
        # None = every rule stays on the per-message hook path.
        self.device_filter = None

    # -- device-predicate plane (rules/compile.py) -------------------------
    def attach_device(self) -> None:
        """Enable device-compiled WHERE filtering: the broker batch
        paths defer compiled rules to settle time, where they fire from
        the in-launch masks (or the vectorized host ladder)."""
        self.device_filter = DeviceRuleFilter()
        self.device_filter.refresh(self.rules())
        self.broker.rule_hook = self

    def refresh_device(self) -> None:
        """Recompile the device rule set (rule create/delete/enable).
        The progs tuple keys the encoded programs on the device
        (`rules.compile.rule_code`), so this is also exactly when the
        next `rule_masks` launch uploads them again."""
        if self.device_filter is not None:
            self.device_filter.refresh(self.rules())

    def device_active(self) -> bool:
        df = self.device_filter
        return df is not None and df.active

    def device_progs(self, msgs):
        """(progs, feats [B,F], valid) for a batch about to launch, or
        None — called by the broker right before the device dispatch."""
        df = self.device_filter
        if df is None or not df.active:
            return None
        feats, valid = df.features(msgs)
        return df.progs, feats, valid

    def fire_settled(self, msgs, masks=None) -> None:
        """Fire deferred (device-compiled) rules for the marked
        messages of a settled batch. `masks` [R, B] comes from the
        launch readback; None (or a rule-set shape mismatch — the set
        churned while the batch was in flight) drops to the vectorized
        numpy twin. Passing rows re-run `apply_query` — the scalar host
        stays the single authority for SELECT projection AND the final
        WHERE word (hashed string lanes make the device mask a
        superset filter; see rules/compile.py)."""
        df = self.device_filter
        marked = [
            i for i, m in enumerate(msgs)
            if m.headers.pop("_batch_rules", None) is not None
        ]
        if not marked or df is None or not df.compiled:
            for m in msgs:
                m.headers.pop("_rule_suspect", None)
            return
        mtr = self.broker.metrics
        if masks is None or len(masks) != len(df.compiled):
            masks = df.host_masks(msgs)
            mtr.inc("rules.host.batches")
        else:
            mtr.inc("rules.device.batches")
        if self._chain_depth() >= self.MAX_CHAIN_DEPTH:
            return
        self._depth.value = self._chain_depth() + 1
        try:
            memo: Dict = {}
            for r, cr in enumerate(df.compiled):
                rule = cr.rule
                if not rule.enabled or self._rules.get(rule.id) is not rule:
                    continue
                row = masks[r]
                for i in marked:
                    msg = msgs[i]
                    if msg.headers.get("from_rule") == rule.id:
                        continue
                    key = (rule.id, msg.topic)
                    sel = memo.get(key)
                    if sel is None:
                        sel = any(
                            T.match(msg.topic, t)
                            for t in rule.query.topics
                        )
                        memo[key] = sel
                    if not sel:
                        continue
                    rule.metrics.matched += 1
                    mtr.inc("rules.matched")
                    if not row[i] and not msg.headers.get(
                        "_rule_suspect"
                    ):
                        # the device-rate drop: WHERE said no, the host
                        # never builds a context for this row (suspect
                        # rows — string/bool-typed numeric lanes — fall
                        # through to the scalar re-verify below)
                        rule.metrics.no_result += 1
                        mtr.inc("rules.dropped")
                        continue
                    ctx = EV.message_publish(msg)
                    try:
                        rows = apply_query(rule.query, ctx)
                    except Exception:
                        rule.metrics.failed += 1
                        mtr.inc("rules.failed")
                        log.exception("rule %s SQL failed", rule.id)
                        continue
                    if not rows:
                        rule.metrics.no_result += 1
                        mtr.inc("rules.dropped")
                        continue
                    rule.metrics.passed += 1
                    mtr.inc("rules.passed")
                    for row_out in rows:
                        for out in rule.outputs:
                            try:
                                out.run(self, rule, row_out, ctx)
                                rule.metrics.outputs_success += 1
                            except Exception:
                                rule.metrics.outputs_failed += 1
                                log.exception(
                                    "rule %s output %s failed",
                                    rule.id, out.name,
                                )
        finally:
            self._depth.value = self._chain_depth() - 1
            for m in msgs:
                m.headers.pop("_rule_suspect", None)

    # -- registry ----------------------------------------------------------
    def create_rule(
        self,
        rule_id: str,
        sql: str,
        outputs: List[Output],
        description: str = "",
        replace: bool = False,
    ) -> Rule:
        rule = Rule(id=rule_id, sql=sql, outputs=outputs, description=description)
        with self._lock:
            if not replace and rule_id in self._rules:
                raise ValueError(f"rule {rule_id!r} already exists")
            self._rules[rule_id] = rule
        self.refresh_device()
        return rule

    def delete_rule(self, rule_id: str) -> bool:
        with self._lock:
            existed = self._rules.pop(rule_id, None) is not None
        if existed:
            self.refresh_device()
        return existed

    def get_rule(self, rule_id: str) -> Optional[Rule]:
        return self._rules.get(rule_id)

    def rules(self) -> List[Rule]:
        return list(self._rules.values())

    # -- hook wiring (emqx_rule_events parity) ----------------------------
    def _any_enabled(self) -> bool:
        """Fast gate for the per-message event hooks: building an event
        context (dict of ~10 fields) on every delivery/ack is pure
        overhead on a rule-less broker — the dominant per-delivery cost
        in the r4 serving profile. Same live-check semantics as
        _on_publish: no cached flag, so an externally toggled
        `rule.enabled = True` is honored immediately."""
        rules = self._rules
        return bool(rules) and any(r.enabled for r in rules.values())

    def attach(self, hooks: Hooks) -> None:
        hooks.add("message.publish", self._on_publish, priority=120)
        hooks.add(
            "message.delivered",
            lambda ci, msg: self._any_enabled()
            and self._fire(EV.message_delivered(ci, msg)),
        )
        hooks.add(
            "message.acked",
            lambda ci, m: self._any_enabled()
            and self._fire(EV.message_acked(ci, m)),
        )
        hooks.add(
            "message.dropped",
            lambda msg, reason: self._any_enabled()
            and self._fire(EV.message_dropped(msg, reason)),
        )
        hooks.add(
            "client.connected",
            lambda ci, _ch: self._any_enabled()
            and self._fire(EV.client_connected(ci)),
        )
        hooks.add(
            "client.disconnected",
            lambda ci, reason: self._any_enabled()
            and self._fire(EV.client_disconnected(ci, reason)),
        )
        hooks.add(
            "session.subscribed",
            lambda ci, f, opts, _ch=None: self._any_enabled()
            and self._fire(EV.session_subscribed(ci, f, opts)),
        )
        hooks.add(
            "session.unsubscribed",
            lambda ci, f: self._any_enabled()
            and self._fire(EV.session_unsubscribed(ci, f)),
        )

    def _on_publish(self, msg: Optional[Message]):
        """'message.publish' fold callback: fire rules, pass msg through.

        Fast path: with no enabled rules there is nothing to select —
        skip building the event context entirely (this hook runs on
        EVERY publish; the context dict was ~9us/msg of pure overhead
        on rule-less brokers)."""
        if msg is None:
            return None
        # O(1) for the common rule-less broker; with rules registered the
        # any() scan is noise next to _fire's own per-rule work, and a
        # cached flag would silently bypass rules if an external
        # `.enabled = True` forgot to refresh it
        if not self._rules or not any(
            r.enabled for r in self._rules.values()
        ):
            return None
        skip = None
        df = self.device_filter
        if df is not None and msg.headers.get("_batch_rules"):
            # the broker marked this message for settle-time firing:
            # device-compiled rules evaluate in the serving launch, the
            # hook path keeps only the uncompilable remainder
            skip = df._ids
        self._fire(
            EV.message_publish(msg),
            from_rule=msg.headers.get("from_rule"),
            skip_rules=skip,
        )
        return None

    def _chain_depth(self) -> int:
        return getattr(self._depth, "value", 0)

    # -- evaluation --------------------------------------------------------
    def _selects_event(self, q: Query, ctx: Dict) -> bool:
        event = ctx["event"]
        for t in q.topics:
            if t.startswith("$events/"):
                if EV.event_topic_to_name(t) == event:
                    return True
            elif event == "message.publish" and T.match(ctx["topic"], t):
                return True
        return False

    def _fire(self, ctx: Dict, from_rule: Optional[str] = None,
              skip_rules=None) -> None:
        # re-entrancy bound: outputs that publish re-enter _fire
        # synchronously (via broker hooks); cap the chain so a rule feeding
        # its own event class (e.g. $events/message_dropped -> republish to
        # a subscriber-less topic) cannot recurse unboundedly
        if self._chain_depth() >= self.MAX_CHAIN_DEPTH:
            log.warning("rule chain depth limit hit; dropping event %s", ctx.get("event"))
            return
        from_rule = from_rule or ctx.get("__from_rule")
        mtr = self.broker.metrics
        self._depth.value = self._chain_depth() + 1
        try:
            for rule in list(self._rules.values()):
                if not rule.enabled:
                    continue
                if skip_rules is not None and rule.id in skip_rules:
                    continue  # fires at settle from the device mask
                if from_rule is not None and rule.id == from_rule:
                    continue  # self-republish loop guard
                if not self._selects_event(rule.query, ctx):
                    continue
                rule.metrics.matched += 1
                mtr.inc("rules.matched")
                try:
                    rows = apply_query(rule.query, ctx)
                except Exception:
                    rule.metrics.failed += 1
                    mtr.inc("rules.failed")
                    log.exception("rule %s SQL failed", rule.id)
                    continue
                if rows is None or not rows:
                    rule.metrics.no_result += 1
                    mtr.inc("rules.dropped")
                    continue
                rule.metrics.passed += 1
                mtr.inc("rules.passed")
                for row in rows:
                    for out in rule.outputs:
                        try:
                            out.run(self, rule, row, ctx)
                            rule.metrics.outputs_success += 1
                        except Exception:
                            rule.metrics.outputs_failed += 1
                            log.exception(
                                "rule %s output %s failed", rule.id, out.name
                            )
        finally:
            self._depth.value = self._chain_depth() - 1


def test_sql(sql: str, ctx: Dict) -> Optional[List[Dict]]:
    """SQL test bench (emqx_rule_sqltester parity): run a statement against
    a hand-built event context, no broker required."""
    q = parse_sql(sql)
    full = dict(ctx)
    full.setdefault("event", "message.publish")
    return apply_query(q, full)


test_sql.__test__ = False  # not a pytest case despite the reference's name
