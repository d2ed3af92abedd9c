"""The port's rule engine against the JAX package.

`emqx_tpu_torch.rules` (`engine`, `runtime`, `funcs`, `events`) and
`utils.placeholder`, with the port's `Broker` (on ``device="cpu"``: the
kernels' plain twins), against `emqx_tpu`'s on the same inputs:

- `FUNCS` over a grid of arguments (every deterministic function, up to
  three arguments), and `apply_query` / `test_sql` over every rule
  statement of `tests/test_rules.py` and `tests/test_rule_funcs_parity.py`
  on the contexts those suites build: the same rows or the same error;
- `Republish`, `Console` and `FunctionOutput` through the hook path: the
  same rows, console log and republished messages (chains, the self-loop
  guard and the depth limit included);
- the device attach (`RuleEngine.attach_device`): settle-time firing of
  the compiled rules exactly once a matching message on the device path
  (the batch's `rule_masks`) and on the degraded one (`enable_tpu=False`,
  the numpy host ladder), with `rules.matched`, `passed`, `dropped`,
  `device.batches` and `host.batches`, every rule's metrics and the fired
  rows equal to JAX's, on `chip_smoke.RULES_SQL` over
  `chip_smoke.rule_messages` (missing keys, suspect string values, a
  hashed string lane); uncompilable rules (FOREACH, `$events`, a function
  call) staying on the hook path; device-flagged rows of a synchronous
  batch firing once; a rule created while a pipelined batch is in flight
  taking the host ladder at settle.

Tolerance: EXACT equality. Event contexts carry wall-clock fields
(`timestamp`, `publish_received_at`) and message ids, which differ between
two runs of either package: they are dropped before rows are compared.
"""

import ast
import asyncio
import itertools
import json
import logging
import pathlib

import numpy as np
import pytest

import chip_smoke
from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.rules import engine as J_engine
from emqx_tpu.rules import funcs as J_funcs
from emqx_tpu.rules import runtime as J_runtime
from emqx_tpu.rules import sql as J_sql
from emqx_tpu.utils import placeholder as J_ph
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.rules import engine as P_engine
from emqx_tpu_torch.rules import funcs as P_funcs
from emqx_tpu_torch.rules import runtime as P_runtime
from emqx_tpu_torch.rules import sql as P_sql
from emqx_tpu_torch.utils import placeholder as P_ph

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = {
    "port": dict(broker=P_broker, hooks=P_hooks, message=P_message, router=P_brouter,
                 packet=P_packet, engine=P_engine, dev={"device": "cpu"}),
    "jax": dict(broker=J_broker, hooks=J_hooks, message=J_message, router=J_brouter,
                packet=J_packet, engine=J_engine, dev={}),
}
WALL_CLOCK = ("timestamp", "publish_received_at", "id")
NONDETERMINISTIC = {"now_rfc3339", "now_timestamp", "random", "uuid", "uuid_v4"}
MIN_TPU_BATCH = 32


def outcome(fn, *a):
    try:
        return "ok", fn(*a)
    except Exception as e:  # noqa: BLE001 - the error's type is compared
        return "raised", type(e).__name__


def clean(row):
    """A row or context without its wall-clock fields (nested too)."""
    if isinstance(row, dict):
        return {k: clean(v) for k, v in row.items() if k not in WALL_CLOCK}
    if isinstance(row, list):
        return [clean(v) for v in row]
    return row


# -- the function library and the evaluator -------------------------------------

GRID = [1, -2, 2.5, 0, "3", "a/b", "", b"xy\x00", [1, 2, 3], {"a": 1, "b": [2]}, None, True]


def test_funcs_match_jax_over_an_argument_grid():
    assert set(P_funcs.FUNCS) == set(J_funcs.FUNCS)
    assert set(P_funcs.CONTEXT_FUNCS) == set(J_funcs.CONTEXT_FUNCS)
    rng = np.random.default_rng(3)
    triples = [tuple(GRID[i] for i in rng.integers(0, len(GRID), 3)) for _ in range(40)]
    args = [()] + [(a,) for a in GRID] + list(itertools.product(GRID, GRID)) + triples
    calls = 0
    for name in sorted(P_funcs.FUNCS):
        if name in NONDETERMINISTIC:
            continue
        for a in args:
            got = outcome(P_funcs.FUNCS[name], *a)
            want = outcome(J_funcs.FUNCS[name], *a)
            assert got == want, (name, a, got, want)
            calls += 1
    ctx = {"clientid": "c", "username": "u", "topic": "a/b", "qos": 1, "payload": b"{}",
           "peerhost": "1.2.3.4", "id": "9", "flags": {"retain": True}, "pub_props": {}}
    for name in sorted(P_funcs.CONTEXT_FUNCS):
        assert outcome(P_funcs.CONTEXT_FUNCS[name], ctx) == \
            outcome(J_funcs.CONTEXT_FUNCS[name], ctx), name
    assert calls > 15_000


def suite_statements(path):
    """Every SQL statement of a test file: its string constants (and
    implicitly joined ones) that start with SELECT or FOREACH, plus the
    ``SELECT {expr} AS v`` statements its sampler tables build."""
    tree = ast.parse((ROOT / path).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            s = node.value.strip()
            if s.upper().startswith(("SELECT ", "FOREACH ")):
                out.append(s)
        elif isinstance(node, ast.Tuple) and len(node.elts) == 2 and \
                isinstance(node.elts[0], ast.Constant) and isinstance(node.elts[0].value, str) \
                and "(" in node.elts[0].value:
            out.append(f'SELECT {node.elts[0].value} AS v FROM "t/#"')
    return sorted(set(out))


def contexts():
    base = {"event": "message.publish", "topic": "t/1", "qos": 1, "clientid": "c1",
            "username": "u1", "timestamp": 1700000000000,
            "payload": json.dumps({"x": 1, "y": {"z": "deep"}, "arr": [10, 20, 30],
                                   "temp": 42, "readings": [{"v": 1}, {"v": -2}]})}
    return [base, dict(base, topic="t", qos=0, payload=b"not json"),
            dict(base, topic="s/1/x", clientid=None, payload={"a": {"b": 7}})]


@pytest.mark.parametrize("path", ["tests/test_rules.py", "tests/test_rule_funcs_parity.py"])
def test_apply_query_matches_jax_over_the_rule_suites_statements(path):
    stmts = suite_statements(path)
    assert len(stmts) >= (20 if path.endswith("test_rules.py") else 1)
    checked = 0
    for sql in stmts:
        p, j = outcome(P_sql.parse_sql, sql), outcome(J_sql.parse_sql, sql)
        assert p[0] == j[0], sql
        if p[0] != "ok":
            continue
        for ctx in contexts():
            got = outcome(P_runtime.apply_query, p[1], dict(ctx))
            want = outcome(J_runtime.apply_query, j[1], dict(ctx))
            assert got == want, (sql, ctx, got, want)
            assert outcome(P_engine.test_sql, sql, dict(ctx)) == \
                outcome(J_engine.test_sql, sql, dict(ctx)), sql
            checked += 1
    assert checked >= len(stmts)


def test_render_template_matches_jax():
    env = {"clientid": "c1", "payload": json.dumps({"x": 5, "f": 2.0, "n": None, "l": [1]}),
           "flag": True, "b": b"bytes", "d": {"k": {"z": 1}}}
    for tpl in ["a/${clientid}", "${payload.x}-${payload.f}-${payload.n}", "${flag}/${b}",
                "${d.k}", "${missing}/${payload.l}", "${payload.x.y}", "no vars", "${$x}"]:
        assert P_ph.render(tpl, env) == J_ph.render(tpl, env), tpl


# -- outputs on the hook path ------------------------------------------------------


class EngineRun:
    """One package's broker with a `RuleEngine` on its hooks; deliveries
    and function-output rows recorded in order."""

    def __init__(self, pkg, device=False, enable_tpu=True):
        self.pkg = pkg
        self.broker = pkg["broker"].Broker(
            pkg["router"].Router(min_tpu_batch=MIN_TPU_BATCH, **pkg["dev"]), pkg["hooks"].Hooks())
        self.broker.router.enable_tpu = enable_tpu
        self.eng = pkg["engine"].RuleEngine(self.broker)
        self.eng.attach(self.broker.hooks)
        self.got = []
        self.rows = []
        if device:
            self.eng.attach_device()

    def sub(self, sid, filter_):
        self.broker.subscribe(sid, sid, filter_, self.pkg["packet"].SubOpts(),
                              lambda m, o: self.got.append(
                                  (sid, m.topic, m.payload, m.from_client,
                                   m.headers.get("from_rule"))))

    def record(self, tag):
        return self.pkg["engine"].FunctionOutput(
            lambda row, ctx: self.rows.append((tag, clean(row), ctx["topic"])), name=tag)

    def msg(self, topic, payload=b"", qos=0, client="dev-1"):
        if not isinstance(payload, bytes):
            payload = json.dumps(payload).encode()
        return self.pkg["message"].Message(topic=topic, payload=payload, qos=qos,
                                           from_client=client)

    def counters(self):
        keys = ("rules.matched", "rules.passed", "rules.dropped", "rules.failed",
                "rules.device.batches", "rules.host.batches", "messages.delivered")
        return {k: self.broker.metrics.get(k) for k in keys}

    def rule_metrics(self):
        return {r.id: r.metrics.as_dict() for r in self.eng.rules()}


def test_outputs_emit_the_rows_of_jax(caplog):
    out = {}
    for name, pkg in PKG.items():
        run = EngineRun(pkg)
        E = pkg["engine"]
        run.sub("s", "alerts/#")
        run.sub("e", "each/#")
        run.eng.create_rule("r1", 'SELECT payload.temp AS temp, clientid FROM "sensors/+" '
                                  "WHERE payload.temp > 30",
                            [E.Republish(topic="alerts/${clientid}", payload="${temp}", qos=1),
                             run.record("r1")])
        run.eng.create_rule("star", 'SELECT * FROM "sensors/#"', [run.record("star")])
        run.eng.create_rule("whole", 'SELECT payload, topic FROM "sensors/#"',
                            [E.Republish(topic="alerts/whole/${topic}")])
        run.eng.create_rule("loop", 'SELECT * FROM "loop/#"',
                            [E.Republish(topic="loop/again", payload="x")])
        run.eng.create_rule("fe", 'FOREACH payload.readings AS r DO r.v AS v INCASE r.v > 0 '
                                  'FROM "batch/in"', [E.Republish(topic="each/out",
                                                                  payload="${v}")])
        run.eng.create_rule("con", 'SELECT clientid, qos FROM "sensors/#"', [E.Console()])
        run.eng.create_rule("bad", 'SELECT unknown_func(1) AS v FROM "sensors/#"',
                            [E.Console()])
        run.eng.create_rule("ev", 'SELECT clientid, event FROM "$events/message_dropped"',
                            [run.record("ev"), E.Republish(topic="nobody/${clientid}")])
        with caplog.at_level(logging.CRITICAL):
            for k, temp in enumerate([42, 10, 31.5]):
                run.broker.publish(run.msg("sensors/room1", {"temp": temp}, qos=k % 2))
            run.broker.publish(run.msg("loop/start"))
            run.broker.publish(run.msg("batch/in", {"readings": [{"v": 1}, {"v": -2},
                                                                 {"v": 3}]}))
            run.broker.publish(run.msg("nobody/home", client="dev-2"))
        out[name] = (run.got, run.rows, [(r, clean(row)) for r, row in run.eng.console_log],
                     run.counters(), run.rule_metrics())
    assert out["port"] == out["jax"]
    got, rows, console, counters, metrics = out["port"]
    assert ("s", "alerts/dev-1", b"42", "dev-1", "r1") in got
    assert [g[2] for g in got if g[0] == "e"] == [b"1", b"3"]
    assert metrics["loop"]["matched"] == 1 and metrics["bad"]["failed"] == 3
    assert len(console) == 3 and rows


# -- the device attach: settle-time firing ------------------------------------------

EXTRA_SQL = (
    # a hashed string lane (inexact): passing rows re-verify on the host
    "SELECT * FROM \"device/#\" WHERE topic(4) = '3' AND payload.temp > 10",
    # uncompilable (a function call): the hook path
    "SELECT * FROM \"device/#\" WHERE abs(payload.temp) > 20",
    # FOREACH and $events: the hook path
    'FOREACH payload.arr AS e INCASE e > 1 FROM "device/#"',
    'SELECT clientid FROM "$events/message_dropped"',
)


def rule_batch(pkg, seed, n):
    """`chip_smoke.rule_messages` payloads on mixed_1m-like topics, some
    carrying an array for the FOREACH rule; every tenth message too deep
    for the device (flagged, taking the CPU row path), one topic nobody
    subscribes to."""
    rng = np.random.default_rng(seed)
    topics = [f"device/{i}/mid/{j}/leaf" for i, j in zip(rng.integers(0, 6, n),
                                                           rng.integers(0, 5, n))]
    for k in range(0, n, 10):
        topics[k] = "device/1/a/b/c/d/e/f/g/h/i"
    topics[1] = "elsewhere/x"
    ctxs = chip_smoke.rule_messages(rng, topics)
    out = []
    for k, c in enumerate(ctxs):
        payload = json.loads(c["payload"])
        if k % 3 == 0:
            payload["arr"] = [k % 4, 2, 5]
        m = pkg["message"].Message(topic=c["topic"], payload=json.dumps(payload).encode(),
                                   qos=c["qos"], from_client=f"pub{k % 3}")
        out.append(m)
    return out


def rules_run(pkg, *, device, enable_tpu, seeds=(1, 2)):
    run = EngineRun(pkg, device=device, enable_tpu=enable_tpu)
    run.sub("all", "device/#")
    for i, w in enumerate(chip_smoke.RULES_SQL):
        run.eng.create_rule(f"r{i}", f'SELECT * FROM "device/#" WHERE {w}', [run.record(f"r{i}")])
    for i, sql in enumerate(EXTRA_SQL):
        run.eng.create_rule(f"x{i}", sql, [run.record(f"x{i}")])
    for seed in seeds:
        run.broker.publish_batch(rule_batch(pkg, seed, 96))
    return run


@pytest.mark.parametrize("path", ["device", "degraded", "hook"])
def test_settle_firing_matches_jax(path):
    kw = {"device": dict(device=True, enable_tpu=True),
          "degraded": dict(device=True, enable_tpu=False),
          "hook": dict(device=False, enable_tpu=True)}[path]
    runs = {name: rules_run(pkg, **kw) for name, pkg in PKG.items()}
    p, j = runs["port"], runs["jax"]
    assert sorted(p.rows, key=repr) == sorted(j.rows, key=repr)
    assert p.counters() == j.counters()
    assert p.rule_metrics() == j.rule_metrics()
    assert sorted(p.got, key=repr) == sorted(j.got, key=repr)
    c = p.counters()
    if path == "hook":
        assert p.eng.device_filter is None and c["rules.device.batches"] == 0
    else:
        df = p.eng.device_filter
        assert [cr.rule.id for cr in df.compiled] == [f"r{i}" for i in range(8)] + ["x0"]
        assert c["rules.device.batches" if path == "device" else "rules.host.batches"] == 2
        assert c["rules.host.batches" if path == "device" else "rules.device.batches"] == 0
    assert c["rules.dropped"] > 0 and c["rules.passed"] > 0
    # exactly once: every (rule, message) pair fired at most once, and the
    # three paths fire the same rows
    keys = [(tag, row.get("topic"), json.dumps(row.get("payload"), default=str))
            for tag, row, _t in p.rows if tag.startswith("r")]
    assert len(keys) == len(set(keys))
    if path != "hook":
        hook = rules_run(PKG["port"], device=False, enable_tpu=True)
        assert sorted(p.rows, key=repr) == sorted(hook.rows, key=repr)
        assert p.rule_metrics() == hook.rule_metrics()


# payloads whose f32 sum or difference lands on the other side of the
# rule's constant than the scalar evaluator's f64 (RULES_SQL[0] and [4])
F32_BOUNDARY = ({"temp": -4.95, "base": 34.95}, {"temp": 8.05, "base": 3.05})


@pytest.mark.parametrize("device", [True, False])
def test_f32_masks_drop_rows_the_scalar_where_passes_as_jax(device):
    """The device masks are f32 programs and drop a row whose f32
    arithmetic misses the constant that the scalar evaluator's f64 meets;
    the engine never re-verifies a dropped row, so with the device
    attached those rows do not fire, in both packages, while the hook
    path (the scalar evaluator alone) fires them."""
    out = {}
    for name, pkg in PKG.items():
        run = EngineRun(pkg, device=device)
        run.sub("all", "device/#")
        for i in (0, 4):
            run.eng.create_rule(f"r{i}", f'SELECT * FROM "device/#" WHERE '
                                f'{chip_smoke.RULES_SQL[i]}', [run.record(f"r{i}")])
        msgs = [run.msg(f"device/{k}/mid/0/leaf", F32_BOUNDARY[k % 2], qos=1)
                for k in range(MIN_TPU_BATCH)]
        run.broker.publish_batch(msgs)
        out[name] = (sorted(run.rows, key=repr), run.counters())
    assert out["port"] == out["jax"]
    fired = {(tag, row["topic"]) for tag, row, _t in out["port"][0]}
    want = {("r0", f"device/{k}/mid/0/leaf") for k in range(0, MIN_TPU_BATCH, 2)} | {
        ("r4", f"device/{k}/mid/0/leaf") for k in range(1, MIN_TPU_BATCH, 2)}
    assert fired == (set() if device else want)


@pytest.mark.parametrize("i", sorted(chip_smoke.RULES_F32_COMPARED))
def test_f32_boundary_check_names_exactly_the_rows_the_masks_drop(i):
    """`chip_smoke.rule_f32_boundary`, which reads the payload alone, names
    exactly the rows that RULES_SQL[i]'s f32 host masks drop (in both
    packages) while the scalar evaluator passes them: over seeded
    `rule_messages` rows plus rows built to meet the constant in two
    decimals, some of which f32 puts on the other side."""
    from emqx_tpu.rules import compile as J_compile
    from emqx_tpu_torch.rules import compile as P_compile

    rng = np.random.default_rng(23 + i)
    ctxs = chip_smoke.rule_messages(rng, [f"device/{k}/mid/0/leaf" for k in range(2048)])
    for k in range(2048):
        t = round(float(rng.uniform(-5, 50)), 2)
        base = round(30 - t, 2) if i == 0 else round(t - 5, 2)
        ctxs.append({"qos": 0, "topic": f"device/{k}/x", "payload": json.dumps(
            {"temp": t, "base": base}).encode()})
    ctxs += [{"qos": 0, "topic": "device/f32", "payload": json.dumps(p).encode()}
             for p in F32_BOUNDARY]
    masks = {}
    for name, sql, comp in (("port", P_sql, P_compile), ("jax", J_sql, J_compile)):
        f = chip_smoke.rule_filter([chip_smoke.RULES_SQL[i]], sql, comp)
        suspect = comp.extract_features(ctxs, f.lanes)[2]
        masks[name] = f.host_masks(ctxs)[0] | suspect
    assert np.array_equal(masks["port"], masks["jax"])
    query = P_sql.parse_sql(f'SELECT * FROM "device/#" WHERE {chip_smoke.RULES_SQL[i]}')

    def passes(c):
        got = outcome(P_runtime.apply_query, query, dict(c))
        return got[0] == "ok" and bool(got[1])

    dropped = np.array([passes(c) for c in ctxs]) & ~masks["port"]
    named = np.array([chip_smoke.rule_f32_boundary(i, c["payload"]) for c in ctxs])
    assert np.array_equal(dropped, named)
    assert 0 < dropped.sum() < 2048


def test_hook_path_rules_skip_compiled_rules_for_marked_messages_as_jax():
    """With the device attached, the fold fires only the uncompilable
    rules; a single `publish` (never marked) fires every rule in the fold."""
    out = {}
    for name, pkg in PKG.items():
        run = rules_run(pkg, device=True, enable_tpu=True, seeds=(5,))
        fold = [t for t, _r, _tp in run.rows]
        run.rows.clear()
        run.broker.publish(rule_batch(pkg, 6, 12)[3])
        out[name] = (sorted(fold), sorted(t for t, _r, _tp in run.rows), run.counters())
    assert out["port"] == out["jax"]
    assert {t for t in out["port"][0] if t.startswith("x")} >= {"x1", "x2"}


def test_rule_created_mid_flight_takes_the_host_ladder_as_jax():
    async def drive(pkg):
        run = EngineRun(pkg, device=True)
        run.sub("all", "device/#")
        run.eng.create_rule("a", 'SELECT * FROM "device/#" WHERE payload.temp > 20',
                            [run.record("a")])
        msgs = rule_batch(pkg, 8, 80)
        for m in msgs:
            m.headers["_batch_rules"] = True
        first = run.broker.adispatch_begin(msgs[:40])  # the masks of one rule
        run.eng.create_rule("b", 'SELECT * FROM "device/#" WHERE payload.hum < 30',
                            [run.record("b")])
        second = run.broker.adispatch_begin(msgs[40:])  # both rules' masks
        await first.ready
        counts = await first.complete() + await second.complete()
        return run, counts

    out = {}
    for name, pkg in PKG.items():
        run, counts = asyncio.run(asyncio.wait_for(drive(pkg), 60))
        out[name] = (sorted(run.rows, key=repr), counts, run.counters(), run.rule_metrics())
    assert out["port"] == out["jax"]
    c = out["port"][2]
    assert c["rules.host.batches"] == 1 and c["rules.device.batches"] == 1
    assert {t for t, _r, _tp in out["port"][0]} == {"a", "b"}
