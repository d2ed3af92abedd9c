"""The port's semantic plane in the broker against the JAX package.

`emqx_tpu_torch.broker.semantic.SemanticRouting` and the port's `Broker`
with it attached (on ``device="cpu"``: the kernels' plain twins) against
`emqx_tpu`'s, on the same seeded inputs at D = 32 and a few hundred
filters:

- `decode_embedding`: the JSON list and base64 f32le forms give the same
  bits in both packages; a payload of the wrong length raises ValueError
  in both;
- `SemanticRouting` alone: `parse_subscribe`, `embedding_of`,
  `embed_batch`, `entries`, `status` and the numpy host twin `host_route`
  through seeded attach/detach churn;
- the broker: seeded churn of plain and embedding subscribes,
  unsubscribes and re-subscribes that add or drop an embedding, with
  batches that have and lack embeddings, on a dense table and on the CSR
  table (the `auto` flip threshold lowered in both packages, as
  `tests/test_torch_broker.py`'s `low_flip` does): every message's
  recipient set equal to JAX's broker; overflow rows keep their semantic
  winners; top-k truncation bounded and counted; the CPU path
  (`enable_tpu=False`) equal to the device path; a `$share` filter with an
  embedding (or no plane attached) rejected as in JAX;
- both publish paths (`publish_batch`, and `apublish_enqueue` through
  `BatchIngest` at pipeline 1 and 2) on a small `bench_agentic_fabric`
  shape with its rule: the deliveries and fired rule rows of JAX's;
- `convert.semantic_state_from_reference`: the carried table byte-identical
  to the JAX table's fold, routing as it does.

Tolerance: EXACT equality (recipients are names, counts integers), except
where the float order of the D-term similarity sums can decide: torch's
CPU matmul and XLA sum in different orders, so a message's semantic
recipients may differ only where every differing entry's similarity,
recomputed in f64, lies within TAU = D * 2^-23 of its threshold or of the
k-th score of the message (the band of `chip_smoke.semantic_row_ok`).
"""

import asyncio
import base64
import collections
import json

import numpy as np
import pytest

from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import ingest as J_ingest
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.broker import semantic as J_semantic
from emqx_tpu.models import router_model as J_router
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu.rules import engine as J_engine
from emqx_tpu_torch import convert
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import ingest as P_ingest
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.broker import semantic as P_semantic
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.ops import matcher as P_matcher
from emqx_tpu_torch.rules import engine as P_engine

PKG = {
    "port": dict(broker=P_broker, hooks=P_hooks, ingest=P_ingest, message=P_message,
                 router=P_brouter, semantic=P_semantic, packet=P_packet, matcher=P_matcher,
                 engine=P_engine, dev={"device": "cpu"}),
    "jax": dict(broker=J_broker, hooks=J_hooks, ingest=J_ingest, message=J_message,
                router=J_brouter, semantic=J_semantic, packet=J_packet, matcher=J_matcher,
                engine=J_engine, dev={}),
}
DIM = 32
TAU = DIM * 2.0 ** -23


def unit(rng, n=None):
    v = rng.normal(size=(n, DIM) if n else DIM).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture
def low_flip(monkeypatch):
    """Lower the `auto` flip threshold in both packages, so that a
    test-sized table flips to CSR as a million subscriptions do."""
    for mod in (P_router, J_router):
        monkeypatch.setattr(mod.SubscriberTable, "AUTO_MIN_DENSE_BYTES", 1 << 14)


class SemRun:
    """One package's broker with a `SemanticRouting` attached; every
    delivery lands in `log` as (message index, subscriber id)."""

    def __init__(self, pkg, mode="dense", topk=8, threshold=0.45, kslot=0, min_batch=1,
                 semantic=True):
        self.pkg = pkg
        cfg = pkg["matcher"].MatcherConfig(max_bytes=64, max_levels=8, sub_table=mode,
                                           fanout_slots=kslot)
        self.broker = pkg["broker"].Broker(
            pkg["router"].Router(cfg, min_tpu_batch=min_batch, **pkg["dev"]),
            pkg["hooks"].Hooks())
        if semantic:
            self.broker.semantic = pkg["semantic"].SemanticRouting(
                dim=DIM, topk=topk, threshold=threshold, metrics=self.broker.metrics)
        self.log = []

    def sink(self, sid):
        return lambda msg, opts: self.log.append((int(msg.payload), sid))

    def sub(self, sid, filter_, emb=None, th=None, **opts):
        self.broker.subscribe(sid, sid, filter_, self.pkg["packet"].SubOpts(**opts),
                              self.sink(sid), embedding=emb, sem_threshold=th)

    def messages(self, batch):
        out = []
        for k, topic, emb in batch:
            m = self.pkg["message"].Message(topic=topic, payload=b"%d" % k, from_client="pub")
            if emb is not None:
                m.headers["semantic_embedding"] = np.array(emb, np.float32)
            out.append(m)
        return out

    def publish(self, batch):
        return self.broker.dispatch_batch_folded(self.messages(batch))

    def per_message(self):
        out = collections.defaultdict(set)
        for k, sid in self.log:
            out[k].add(sid)
        return out


def explained(routing, emb, topic, sids, topk):
    """Can the differing recipients `sids` of one message come from the
    float order alone? Each must be a semantic entry whose f64 similarity
    lies within TAU of its threshold or of the message's k-th score."""
    if emb is None:
        return False
    vecs, slots, fids, ths = routing.table.live_arrays()
    sims = vecs.astype(np.float64) @ np.asarray(emb, np.float64)
    sid_of = {int(s): routing._by_slot[int(s)][0] for s in slots}
    from emqx_tpu_torch.ops import topics as T

    scope_ok = np.array([fids[j] < 0 or T.match(topic, routing._by_slot[int(slots[j])][1])
                         for j in range(len(slots))], bool)
    ok = scope_ok & (sims >= ths)
    kth = np.sort(sims[ok])[::-1][topk - 1] if ok.sum() >= topk else -np.inf
    for sid in sids:
        js = [j for j in range(len(slots)) if sid_of[int(slots[j])] == sid]
        if not js or not any(scope_ok[j] and (abs(sims[j] - ths[j]) <= TAU
                                              or abs(sims[j] - kth) <= TAU) for j in js):
            return False
    return True


def assert_same_recipients(port, jax_, refs, topk, where):
    got, want = port.per_message(), jax_.per_message()
    band = []
    for k, topic, emb in refs:
        g, w = got.get(k, set()), want.get(k, set())
        if g != w:
            assert explained(port.broker.semantic, emb, topic, g ^ w, topk), (where, k, g ^ w)
            band.append(k)
    return band


def churn_ops(seed, steps=12, wave=6, clients=24):
    """One seeded script of (op, sid, filter, embedding, threshold) waves
    and publish batches, shared by both packages."""
    rng = np.random.default_rng(seed)
    topics = [f"s/{i}/t" for i in range(8)] + ["s/0/u", "x/y", "device/3/mid/1/leaf"]
    filters = ["s/#", "s/+/t", "x/y", "#"] + [f"s/{i}/t" for i in range(4)]
    subs = {}
    script = []
    k = 0
    for step in range(steps):
        ops = []
        for _ in range(wave):
            sid = f"c{int(rng.integers(0, clients))}"
            f = filters[int(rng.integers(0, len(filters)))]
            r = rng.random()
            if r < 0.3 and (sid, f) in subs:
                ops.append(("unsub", sid, f, None, None))
                del subs[(sid, f)]
            elif r < 0.65:
                ops.append(("sub", sid, f, unit(rng), float(rng.uniform(0.3, 0.7))))
                subs[(sid, f)] = "sem"
            else:
                ops.append(("sub", sid, f, None, None))
                subs[(sid, f)] = "plain"
        batch = []
        for _ in range(24):
            t = topics[int(rng.integers(0, len(topics)))]
            batch.append((k, t, unit(rng) if rng.random() < 0.8 else None))
            k += 1
        script.append((ops, batch))
    return script


def background(run):
    """Plain subscriptions enough for the lowered `auto` threshold to flip
    the table to CSR."""
    for i in range(30):
        for j in range(8):
            run.sub(f"b{i}_{j}", f"device/{i}/+/{j}/#")


@pytest.mark.parametrize("mode", ["dense", "auto"])
def test_churn_recipients_match_jax(low_flip, mode):
    script = churn_ops(seed=11 if mode == "dense" else 13)
    runs = {name: SemRun(pkg, mode=mode) for name, pkg in PKG.items()}
    bands = []
    for run in runs.values():
        background(run)
    for step, (ops, batch) in enumerate(script):
        counts = {}
        for name, run in runs.items():
            for op, sid, f, emb, th in ops:
                if op == "unsub":
                    assert run.broker.unsubscribe(sid, f)
                else:
                    run.sub(sid, f, emb, th)
            run.log.clear()
            counts[name] = run.publish(batch)
        bands += assert_same_recipients(runs["port"], runs["jax"], batch, 8, step)
        if not bands:
            assert counts["port"] == counts["jax"], step
    p, j = runs["port"].broker, runs["jax"].broker
    assert p.subtab.sparse == j.subtab.sparse == (mode == "auto")
    assert p.semantic.entries() == j.semantic.entries()
    assert p.subtab.live == j.subtab.live
    for key in ("semantic.hits", "messages.routed.device", "messages.delivered"):
        if not bands:
            assert p.metrics.get(key) == j.metrics.get(key), key
    assert p.metrics.get("semantic.hits") > 0
    assert p.metrics.gauge("semantic.filters") == j.metrics.gauge("semantic.filters") > 0
    assert len(bands) <= 2, bands


def test_decode_embedding_matches_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(size=DIM).astype(np.float32)
    forms = [v.tolist(), tuple(v.tolist()), v, json.dumps(v.tolist()),
             json.dumps(v.tolist()).encode(), "  " + base64.b64encode(v.tobytes()).decode(),
             base64.b64encode(v.astype("<f4").tobytes())]
    for form in forms:
        got = P_semantic.decode_embedding(form, DIM)
        want = J_semantic.decode_embedding(form, DIM)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    short = base64.b64encode(v[:-1].tobytes()).decode()
    for mod in (P_semantic, J_semantic):
        with pytest.raises(ValueError, match="expected"):
            mod.decode_embedding(short, DIM)
        with pytest.raises(ValueError):
            mod.decode_embedding("!!not base64!!", DIM)
        with pytest.raises(ValueError):
            mod.decode_embedding(v[:5].tolist(), DIM)


def test_semantic_routing_matches_jax_through_churn():
    rng = np.random.default_rng(7)
    mods = {"port": (P_semantic, P_message), "jax": (J_semantic, J_message)}
    rt = {k: m.SemanticRouting(dim=DIM, topk=4, threshold=0.35) for k, (m, _) in mods.items()}
    props = [None, {}, {"User-Property": [("semantic-embedding", json.dumps(unit(rng).tolist()))]},
             {"User-Property": [("x", "y"), ("semantic-embedding",
                                             base64.b64encode(unit(rng).tobytes()).decode()),
                                ("semantic-threshold", "0.8"), ("semantic-embedding", "[1]")]}]
    for p in props:
        got, want = rt["port"].parse_subscribe(p), rt["jax"].parse_subscribe(p)
        if want is None:
            assert got is None
        else:
            assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]
    scopes = [None, "a/#", "a/+/c", "b/1"]
    live = set()
    for step in range(10):
        for _ in range(12):
            slot = int(rng.integers(0, 40))
            if slot in live and rng.random() < 0.35:
                assert rt["port"].detach(slot) == rt["jax"].detach(slot)
                live.discard(slot)
                continue
            v, th = unit(rng), float(rng.uniform(0.0, 0.6))
            scope = scopes[int(rng.integers(0, len(scopes)))]
            fid = -1 if scope is None else scopes.index(scope)
            for r in rt.values():
                r.attach(f"s{slot}", slot, v, th, fid=fid, scope=scope)
            live.add(slot)
        assert rt["port"].entries() == rt["jax"].entries()
        st_p, st_j = rt["port"].status(), rt["jax"].status()
        assert st_p == st_j
        topics = ["a/b/c", "a/x", "b/1", "c"]
        batch = []
        for i in range(16):
            t = topics[i % 4]
            kind = i % 4
            e = unit(rng)
            batch.append((t, kind, e))
        msgs = {}
        for name, (_m, M) in mods.items():
            out = []
            for t, kind, e in batch:
                m = M.Message(topic=t)
                if kind == 0:
                    m.headers["semantic_embedding"] = e.tolist()
                elif kind == 1:
                    m.properties["User-Property"] = [
                        ("semantic-embedding", base64.b64encode(e.tobytes()).decode())]
                elif kind == 2:
                    m.properties["User-Property"] = [("semantic-embedding", "[0.5]")]
                out.append(m)
            msgs[name] = out
        q_p, q_j = rt["port"].embed_batch(msgs["port"]), rt["jax"].embed_batch(msgs["jax"])
        assert q_p.tobytes() == q_j.tobytes()
        for mp, mj in zip(msgs["port"], msgs["jax"]):
            ep, ej = rt["port"].embedding_of(mp), rt["jax"].embedding_of(mj)
            assert (ep is None) == (ej is None)
            if ep is not None:
                assert ep.tobytes() == ej.tobytes()
        assert rt["port"].host_route(msgs["port"]) == rt["jax"].host_route(msgs["jax"])


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_overflow_rows_keep_semantic_winners_as_jax(mode):
    """A row whose topic fan-out passes kslot decodes its dense row (the
    second transfer, or on a CSR table a row built from the host table),
    which holds the topic fan-out only: its semantic winners come back
    from the slot row, deduplicated."""
    rng = np.random.default_rng(9)
    vec = unit(rng)
    logs = {}
    for name, pkg in PKG.items():
        run = SemRun(pkg, mode=mode, topk=4, threshold=0.4, kslot=8)
        for i in range(40):  # slot_count > kslot = 8
            run.sub(f"p{i}", "big/t")
        run.sub("sem", "big/#", vec, 0.9)
        run.sub("sem2", "big/+", unit(rng), -1.0)
        dev = run.broker._device_router()
        seen = []
        route = dev.route
        dev.route = lambda *a, **k: seen.append(route(*a, **k)) or seen[-1]
        run.publish([(0, "big/t", vec)] + [(k, "big/t", None) for k in range(1, 4)])
        logs[name] = sorted(run.log)
        assert np.asarray(seen[0].overflow).all() and seen[0].sem_count is not None
        assert run.broker.subtab.sparse == (mode == "sparse")
        assert (0, "sem") in run.log and (0, "sem2") in run.log
        assert sum(1 for k, s in run.log if s.startswith("p")) == 4 * 40
        assert len(run.log) == len(set(run.log))
    assert logs["port"] == logs["jax"]


def test_topk_truncation_is_bounded_and_counted_as_jax():
    rng = np.random.default_rng(21)
    vec = unit(rng)
    got = {}
    for name, pkg in PKG.items():
        run = SemRun(pkg, topk=4, threshold=0.0)
        for i in range(12):
            run.sub(f"s{i}", "#", vec, -1.0)
        run.publish([(k, "t/x", vec) for k in range(4)])
        assert len(run.log) == 4 * 4
        got[name] = (run.broker.metrics.get("semantic.topk.truncated"),
                     run.broker.metrics.get("semantic.hits"))
    assert got["port"] == got["jax"] == (4, 48)


def test_cpu_path_equals_device_path_as_jax():
    rng = np.random.default_rng(5)
    vecs = [unit(rng) for _ in range(6)]
    batch = [(k, f"a/{k % 3}", unit(rng) if k % 5 else None) for k in range(16)]
    logs = {}
    for name, pkg in PKG.items():
        for tpu in (True, False):
            run = SemRun(pkg, topk=4, threshold=0.4)
            run.broker.router.enable_tpu = tpu
            run.sub("p1", "a/#")
            for i, v in enumerate(vecs):
                run.sub(f"m{i}", "a/#" if i % 2 else "a/1", v, 0.2)
            run.publish(batch)
            logs[(name, tpu)] = sorted(run.log)
            hits = run.broker.metrics.get("semantic.hits" if tpu else "semantic.host.batches")
            assert hits > 0
    assert logs[("port", True)] == logs[("port", False)] == logs[("jax", True)] \
        == logs[("jax", False)]
    assert any(s.startswith("m") for _k, s in logs[("port", True)])


def test_shared_or_planeless_embedding_subscribe_is_rejected_as_jax():
    rng = np.random.default_rng(2)
    got = {}
    for name, pkg in PKG.items():
        run = SemRun(pkg)
        run.sub("g", "$share/g/t/#", unit(rng), 0.5)
        bare = SemRun(pkg, semantic=False)
        bare.sub("c", "t/#", unit(rng), 0.5)
        bare.publish([(0, "t/x", None)] * 2)
        got[name] = (len(run.broker.semantic.table),
                     run.broker.metrics.get("semantic.subscribe.rejected"),
                     bare.broker.metrics.get("semantic.subscribe.rejected"), sorted(bare.log),
                     run.broker.subscription_count())
    assert got["port"] == got["jax"] == (0, 1, 1, [(0, "c"), (0, "c")], 1)


def test_subscribe_lifecycle_moves_the_slot_as_jax():
    rng = np.random.default_rng(1)
    vecs = [unit(rng) for _ in range(2)]
    trace = {}
    for name, pkg in PKG.items():
        run = SemRun(pkg)
        b = run.broker
        steps = []

        def look():
            steps.append((b.subtab.live, len(b.semantic.table),
                          b.metrics.gauge("semantic.filters"), b._slot_subs[0].semantic))

        run.sub("c", "a/b")
        look()
        run.sub("c", "a/b", vecs[0], 0.9)  # plain -> semantic: out of the subscriber table
        look()
        run.sub("c", "a/b")  # semantic -> plain: back
        look()
        run.sub("c", "a/b", vecs[1])  # semantic at the default threshold
        look()
        run.sub("c", "a/b", vecs[0], 0.1)  # semantic -> semantic: replaced in place
        look()
        steps.append(b.semantic.entries())
        assert b.unsubscribe("c", "a/b")
        gone = (len(b.semantic.table), b.metrics.gauge("semantic.filters"),
                b.subscription_count())
        trace[name] = (steps, gone)
    assert trace["port"] == trace["jax"]
    assert trace["port"][0][:5] == [(1, 0, 0.0, False), (0, 1, 1, True), (1, 0, 0, False),
                                    (0, 1, 1, True), (0, 1, 1, True)]
    assert trace["port"][1] == (0, 0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_semantic_state_carries_across_byte_identical(dtype):
    """`convert.semantic_state_from_reference`: a JAX `SemanticRouting`
    after churn (packed and hot entries, tombstones, a replacement) -> a
    port one whose host twin equals JAX's, and whose snapshot equals the
    JAX table's after its own fold byte for byte (bf16 vectors as their
    bits)."""
    rng = np.random.default_rng(17)
    jr = J_semantic.SemanticRouting(dim=DIM, topk=4, threshold=0.6, dtype=dtype)
    scopes = {0: None, 1: "a/#", 2: "a/+/c"}
    for slot in range(300):
        k = slot % 3
        jr.attach(f"s{slot}", slot, unit(rng), float(rng.uniform(0.0, 0.5)),
                  fid=-1 if k == 0 else k, scope=scopes[k])
    jr.table.bulk_add([], np.zeros((0, DIM), np.float32), [])  # a fold: the hot entries pack
    for slot in range(300, 340):
        jr.attach(f"s{slot}", slot, unit(rng), 0.3, fid=1, scope="a/#")
    for slot in range(0, 340, 7):
        jr.detach(slot)
    jr.attach("s1", 1, unit(rng), 0.25, fid=1, scope="a/#")
    pr = convert.semantic_state_from_reference(jr.table._live_tuples(), jr._by_slot,
                                               jr.default_threshold, dim=DIM, topk=4,
                                               dtype=dtype)
    msgs = {}
    for name, M in (("port", P_message), ("jax", J_message)):
        msgs[name] = []
        for i in range(32):
            m = M.Message(topic=["a/b/c", "a/x", "q"][i % 3])
            m.headers["semantic_embedding"] = unit(np.random.default_rng(i))
            msgs[name].append(m)
    want_route = jr.host_route(msgs["jax"])
    assert pr.host_route(msgs["port"]) == want_route
    assert pr.entries() == jr.entries()
    assert sum(map(len, want_route)) > 10
    jr.table._rebuild()
    p_snap, j_snap = pr.table.device_snapshot(), jr.table.device_snapshot()
    assert set(p_snap) == set(j_snap)
    for key in j_snap:
        assert p_snap[key].dtype.itemsize == j_snap[key].dtype.itemsize, key
        assert p_snap[key].shape == j_snap[key].shape, key
        assert p_snap[key].tobytes() == j_snap[key].tobytes(), key
    assert pr.table.dtype == jr.table.dtype == dtype
    assert pr.host_route(msgs["port"]) == jr.host_route(msgs["jax"]) == want_route
    with pytest.raises(ValueError):
        convert.semantic_state_from_reference([(0, np.ones(3), 0.5, -1)], {}, 0.5,
                                              dim=DIM, topk=4)


# -- both publish paths, bench_agentic_fabric's shape ---------------------------


AF_DIM, AF_TOPK, AF_TH = 32, 16, 0.70
AF_ROOMS, AF_PLAIN, AF_SEM, AF_MSGS, AF_BATCH = 8, 64, 48, 512, 128
AF_RULE = 'SELECT qos, payload.p AS p FROM "agents/#" WHERE payload.p = 1'


def agentic_inputs(scen):
    """bench.py `bench_agentic_fabric`'s generator at small counts: `_near`
    draws around 8 room centroids; fan_out (room topics, room-scoped
    semantic filters) or fan_in (device topics, '#' semantic filters)."""
    rng = np.random.default_rng(2209)
    cents = rng.normal(size=(AF_ROOMS, AF_DIM)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)

    def near(c):
        n = rng.normal(size=AF_DIM).astype(np.float32)
        n /= np.linalg.norm(n)
        v = cents[c] + 0.25 * n
        return (v / np.linalg.norm(v)).astype(np.float32)

    if scen == "fan_out":
        msgs = [(f"agents/room/{i % AF_ROOMS}/evt", near(i % AF_ROOMS), i % 4)
                for i in range(AF_MSGS)]
        sem = [(f"agents/room/{i % AF_ROOMS}/#", near(i % AF_ROOMS)) for i in range(AF_SEM)]
        plain = [f"agents/room/{i % AF_ROOMS}/#" for i in range(AF_PLAIN)]
    else:
        msgs = [(f"agents/dev/{int(rng.integers(0, 4096))}/out", near(i % AF_ROOMS), i % 4)
                for i in range(AF_MSGS)]
        sem = [("#", near(i % AF_ROOMS)) for i in range(AF_SEM)]
        plain = ["agents/dev/+/out" for _ in range(16)]
    return msgs, sem, plain


def msg_index(m):
    """The message's index from its payload: a `Message`, or a rule's event
    context."""
    return json.loads(m["payload"] if isinstance(m, dict) else m.payload)["k"]


def agentic_broker(pkg, scen):
    """-> (broker, messages, deliveries [(k, sid)], fired rule rows)."""
    msgs, sem, plain = agentic_inputs(scen)
    b = pkg["broker"].Broker(
        pkg["router"].Router(pkg["matcher"].MatcherConfig(), min_tpu_batch=64, **pkg["dev"]),
        pkg["hooks"].Hooks())
    b.semantic = pkg["semantic"].SemanticRouting(dim=AF_DIM, topk=AF_TOPK, threshold=AF_TH,
                                                 metrics=b.metrics)
    log, fired = [], []

    def sink(sid):
        return lambda m, o: log.append((msg_index(m), sid))

    for i, f in enumerate(plain):
        b.subscribe(f"p{i}", f"p{i}", f, pkg["packet"].SubOpts(), sink(f"p{i}"))
    for i, (f, vec) in enumerate(sem):
        b.subscribe(f"s{i}", f"s{i}", f, pkg["packet"].SubOpts(), sink(f"s{i}"),
                    embedding=vec, sem_threshold=AF_TH)
    eng = pkg["engine"].RuleEngine(b)
    eng.attach(b.hooks)
    eng.create_rule("agentic", AF_RULE, [pkg["engine"].FunctionOutput(
        lambda row, ctx: fired.append((msg_index(ctx), ctx["topic"], row["p"], row["qos"])))])
    eng.attach_device()
    out = []
    for k, (t, e, pv) in enumerate(msgs):
        m = pkg["message"].Message(topic=t, payload=b'{"p": %d, "k": %d}' % (pv, k),
                                   from_client="pub")
        m.headers["semantic_embedding"] = e
        out.append(m)
    return b, out, log, fired


def agentic_sync(pkg, scen):
    b, msgs, log, fired = agentic_broker(pkg, scen)
    counts = []
    for lo in range(0, len(msgs), AF_BATCH):
        counts.append(b.publish_batch(msgs[lo:lo + AF_BATCH]))
    return sorted(log), sorted(fired), counts, b.metrics


async def agentic_ingest(pkg, scen, pipeline):
    b, msgs, log, fired = agentic_broker(pkg, scen)
    ing = pkg["ingest"].BatchIngest(b, max_batch=AF_BATCH, window_us=0, pipeline=pipeline)
    b.ingest = ing
    ing.start()
    futs = []
    for m in msgs:
        r = await b.apublish_enqueue(m)
        futs.append(r)
    counts = [c if isinstance(c, int) else await c for c in futs]
    await ing.stop()
    return sorted(log), sorted(fired), counts, b.metrics


RULE_COUNTERS = ("rules.matched", "rules.passed", "rules.dropped", "rules.device.batches",
                 "rules.host.batches", "semantic.hits", "messages.routed.device")


@pytest.mark.parametrize("scen", ["fan_out", "fan_in"])
def test_agentic_fabric_sync_path_matches_jax(scen):
    got = {name: agentic_sync(pkg, scen) for name, pkg in PKG.items()}
    (p_log, p_fired, p_counts, pm), (j_log, j_fired, j_counts, jm) = got["port"], got["jax"]
    assert p_log == j_log and p_counts == j_counts
    assert p_fired == j_fired
    assert len(p_fired) == AF_MSGS // 4  # payload.p = 1 on every fourth message, once each
    assert len({f[0] for f in p_fired}) == len(p_fired)
    for key in RULE_COUNTERS:
        assert pm.get(key) == jm.get(key), key
    batches = AF_MSGS // AF_BATCH
    assert pm.get("rules.device.batches") == batches and pm.get("rules.host.batches") == 0
    assert any(s.startswith("s") for _k, s in p_log)


@pytest.mark.parametrize("pipeline", [1, 2])
def test_agentic_fabric_ingest_path_matches_jax(pipeline):
    scen = "fan_out"
    got = {name: asyncio.run(asyncio.wait_for(agentic_ingest(pkg, scen, pipeline), 120))
           for name, pkg in PKG.items()}
    (p_log, p_fired, p_counts, pm), (j_log, j_fired, j_counts, jm) = got["port"], got["jax"]
    assert p_log == j_log and p_counts == j_counts and p_fired == j_fired
    for key in RULE_COUNTERS:
        assert pm.get(key) == jm.get(key), key
    assert pm.get("rules.device.batches") == AF_MSGS // AF_BATCH
    assert pm.get("rules.host.batches") == 0
    # the synchronous path delivers and fires the same
    s_log, s_fired, _c, _m = agentic_sync(PKG["port"], scen)
    assert s_log == p_log and s_fired == p_fired
