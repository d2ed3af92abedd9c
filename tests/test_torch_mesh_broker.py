"""The port's broker on a ('dp', 'tp') mesh against the JAX package.

`Broker.mesh` makes the broker's device router a `MeshServingRouter`, and
the mesh is SPMD: one process a rank, each holding a replica of the
broker that makes the same subscribes and routes the same batches. The
launcher (`python -m emqx_tpu_torch.parallel.launch`) forks four gloo
ranks on the CPU into a 2 x 2 mesh, and `rank_main` below runs every
scenario in them, so the file pays for one launch and each test reads its
part of the ranks' results. The launch has its own timeout (100 s, and
the subprocess 120 s): a hung collective fails a test and never stalls
the suite. JAX runs in this process, on the 2 x 2 slice of the virtual
8-device CPU mesh; the same seeded drive (numpy seeds) runs in both
packages.

- (a) a dense broker with `$share` groups (round robin, hash_clientid),
  plain and exact subscriptions, `no_local`, a raising deliverer, rows the
  device flags, a batch below `min_tpu_batch`, churn between batches,
  through `dispatch_batch_folded`: against JAX's mesh broker on the 2 x 2
  slice and JAX's single-device broker;
- (b) the CSR broker (`tests/test_sparse_fanout.py`'s churn recipe, seeds
  5 and 6, kslot 4 so rows overflow into host-built rows) with the mesh
  set before the `auto` table flips and after it (the first prepare then
  reshards the CSR table over 'tp'): against JAX's single-device broker
  (JAX's own CSR mesh program is not a stable oracle in this JAX);
- (c) semantic subscriptions and a device-compiled rule through the mesh
  broker (bench.py's `bench_agentic_fabric` fan_out at a test's size, no
  row's candidates past top-k, so the shards' union is the global set):
  against JAX's single-device broker;
- (d) `adispatch_begin` at depth 1 and 2 over eight batches, each rank's
  pool worker delayed by rank x 10 ms before it launches: the launches'
  collectives stay in order, and the logs equal the synchronous path (at
  depth 2 under round robin, where batch N + 1 is prepared before batch
  N's bases are written back, JAX's single-device broker on the same
  schedule);
- (e) `SessionStore(mesh=...)` through seeded churn: each rank's mirror
  equals its 'dp' block of the host lanes after every sync, every rank
  takes the same full / delta / array decisions, the host lanes equal
  JAX's `SessionStore(mesh=...)` lanes, `tick(fused_path=False)`
  redelivers what the single-device stores redeliver, and a mesh broker
  hands its store no rider;
- (f) `Router.mesh`: `match_batch` on the mesh equals the router without
  one and JAX's router with a mesh;
- (g) `BatchIngest.start()` on a four-rank mesh broker raises, naming
  ROADMAP item 10; on a one-rank mesh it delivers as with no mesh.

Tolerance: EXACT equality of every delivery log, count and host lane,
except (c)'s semantic recipients, which may differ only where every
differing entry's f64 similarity lies within TAU = D x 2^-23 of its
threshold or of the message's k-th score (the band of
`chip_smoke.semantic_row_ok`).
"""

import asyncio
import collections
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import ingest as P_ingest
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.broker import semantic as P_semantic
from emqx_tpu_torch.broker import session_store as P_store
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.ops import matcher as P_matcher
from emqx_tpu_torch.ops import session_table as P_st
from emqx_tpu_torch.parallel import mesh as P_mesh
from emqx_tpu_torch.rules import engine as P_engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve()
LAUNCH_TIMEOUT = 100
DP, TP = 2, 2
MIN_BATCH = 32
LOW_FLIP = 1 << 14  # the `auto` flip threshold a test-sized table crosses
STRATEGIES = ("round_robin", "hash_clientid")
CSR_CASES = [(5, "before"), (5, "after"), (6, "before"), (6, "after")]
PIPE_BATCHES = 8
AF_DIM, AF_TOPK, AF_TH = 32, 16, 0.70
AF_ROOMS, AF_PLAIN, AF_SEM, AF_MSGS, AF_BATCH = 8, 64, 48, 384, 128
AF_RULE = 'SELECT qos, payload.p AS p FROM "agents/#" WHERE payload.p = 1'
TAU = AF_DIM * 2.0 ** -23
COUNTERS = ("messages.delivered", "messages.received", "messages.routed.device",
            "messages.routed.device_fallback", "messages.dropped.no_subscribers",
            "delivery.errors")


def port_pkg(device):
    return dict(broker=P_broker, hooks=P_hooks, ingest=P_ingest, message=P_message,
                router=P_brouter, semantic=P_semantic, packet=P_packet, matcher=P_matcher,
                engine=P_engine, store=P_store, model=P_router, dev={"device": device})


def jax_pkg():
    from emqx_tpu.broker import broker, hooks, ingest, message, router, semantic, session_store
    from emqx_tpu.models import router_model
    from emqx_tpu.mqtt import packet
    from emqx_tpu.ops import matcher
    from emqx_tpu.rules import engine

    return dict(broker=broker, hooks=hooks, ingest=ingest, message=message, router=router,
                semantic=semantic, packet=packet, matcher=matcher, engine=engine,
                store=session_store, model=router_model, dev={})


# -- the seeded drives, in either package ----------------------------------------


class Run:
    """One package's broker (optionally on a mesh); every delivery lands in
    `log` as (message index, subscriber id), in delivery order."""

    def __init__(self, pkg, mode="dense", strategy="round_robin", min_batch=MIN_BATCH,
                 kslot=0, mesh=None):
        self.pkg = pkg
        cfg = pkg["matcher"].MatcherConfig(max_bytes=64, max_levels=8, sub_table=mode,
                                           fanout_slots=kslot)
        self.broker = pkg["broker"].Broker(
            pkg["router"].Router(cfg, min_tpu_batch=min_batch, **pkg["dev"]),
            pkg["hooks"].Hooks())
        self.broker.shared.strategy = strategy
        if mesh is not None:
            self.attach(mesh)
        self.log = []
        self.counts = []

    def attach(self, mesh):
        self.broker.mesh = mesh
        self.broker.router.mesh = mesh

    def sink(self, sid, fails=False):
        def deliver(msg, opts):
            if fails:
                raise RuntimeError(f"{sid} refuses")
            self.log.append((int(msg.payload), sid))
        return deliver

    def sub(self, sid, filter_, client=None, fails=False, **opts):
        self.broker.subscribe(sid, client or sid, filter_, self.pkg["packet"].SubOpts(**opts),
                              self.sink(sid, fails))

    def messages(self, batch):
        return [self.pkg["message"].Message(topic=t, payload=str(k).encode(), from_client=c)
                for k, t, c in batch]

    def dispatch(self, batch):
        self.counts.append(self.broker.dispatch_batch_folded(self.messages(batch)))

    def counters(self):
        return {k: self.broker.metrics.get(k) for k in COUNTERS}


def topic_batch(rng, start, n, edge=False):
    ids = np.minimum(rng.zipf(1.4, size=n) - 1, 33)
    nums = rng.integers(0, 10, size=n)
    out = [(start + k, f"device/{i}/mid/{j}/leaf", f"pub{rng.integers(0, 7)}")
           for k, (i, j) in enumerate(zip(ids, nums))]
    out[0] = (start, "device/3/mid/1/leaf", "c3")  # the no_local client publishes
    if edge:
        out[1] = (start + 1, "device/1/a/2/b/c/d/e/f/g", "pub1")  # too deep
        out[2] = (start + 2, "device/2/" + "x" * 70, "pub2")  # too long
        out[3] = (start + 3, "exact/topic", "pub3")
        out[4] = (start + 4, "$SYS/broker/up", "pub4")
    return out


def base_subscriptions(run: Run, groups=True):
    """Wildcard and exact plain subscriptions, `no_local`, a raising
    deliverer and (with `groups`) $share groups with a raising member."""
    for i in range(30):
        for j in range(8):
            for k in range(1 + (i + j) % 2):
                run.sub(f"s{i}_{j}_{k}", f"device/{i}/+/{j}/#")
    for i in range(10):
        run.sub(f"h{i}", f"device/{i}/#")
    run.sub("c3", "device/3/#", no_local=True)
    run.sub("bad4", "device/4/#", fails=True)
    run.sub("x1", "exact/topic")
    run.sub("deep", "device/1/#")
    if groups:
        for i in range(10):
            for m in range(4):
                run.sub(f"g{i}_{m}", f"$share/ingest/device/{i}/#",
                        fails=(i == 2 and m == 0))
        for i in range(5):
            for m in range(3):
                run.sub(f"a{i}_{m}", f"$share/audit/device/{i}/+/1/#")


def dense_scenario(run: Run, seed: int):
    """(a): subscriptions, then batches through `dispatch_batch_folded`
    with churn between them (unsubscribes, members leaving, a group
    emptied and made again, a re-subscribe, a session's subscriptions
    dropped) and one batch below `min_tpu_batch`."""
    rng = np.random.default_rng(seed)
    base_subscriptions(run)
    run.dispatch(topic_batch(rng, 0, 96, edge=True))
    for k in rng.choice(240, 25, replace=False):
        i, j = divmod(int(k), 8)
        run.broker.unsubscribe(f"s{i}_{j}_0", f"device/{i}/+/{j}/#")
    for i in range(0, 10, 3):
        run.broker.unsubscribe(f"g{i}_1", f"$share/ingest/device/{i}/#")
    for m in range(3):
        run.broker.unsubscribe(f"a4_{m}", f"$share/audit/device/4/+/1/#")
    run.sub("c3", "device/3/#", no_local=False)
    for i in range(30, 34):
        run.sub(f"n{i}", f"device/{i}/+/+/leaf")
    run.dispatch(topic_batch(rng, 1000, 80, edge=True))
    run.dispatch(topic_batch(rng, 2000, MIN_BATCH // 2))  # the CPU branch
    run.sub("a4_0", "$share/audit/device/4/+/1/#")
    run.broker.drop_session_subs("h5", ["device/5/#"])
    run.dispatch(topic_batch(rng, 3000, 64))
    run.dispatch(topic_batch(rng, 4000, 64))


SEGS = ["a", "b", "c", "+", "#"]


def rand_filter(rng):
    depth = int(rng.integers(1, 4))
    parts = []
    for lvl in range(depth):
        s = SEGS[int(rng.integers(0, len(SEGS)))]
        if s == "#" and lvl != depth - 1:
            s = "+"
        parts.append(s)
    return "/".join(parts)


def rand_topic(rng):
    depth = int(rng.integers(1, 4))
    return "/".join(SEGS[int(rng.integers(0, 3))] for _ in range(depth))


def churn_round(run: Run, rng, r: int, subs: dict, sid0: int) -> int:
    """One round of `tests/test_sparse_fanout.py`'s `_churn`: 14 subscribes
    (a quarter $share), a third dropped, half of those back (tombstoned
    re-subscribes). -> the next subscriber number."""
    sid = sid0
    for _ in range(14):
        f = rand_filter(rng)
        if rng.random() < 0.25:
            f = f"$share/g{int(rng.integers(0, 2))}/{f}"
        name = f"s{sid}"
        sid += 1
        run.sub(name, f)
        subs[name] = f
    drop = [n for i, n in enumerate(sorted(subs)) if i % 3 == r % 3]
    for n in drop:
        run.broker.unsubscribe(n, subs[n])
    for n in drop[::2]:
        run.sub(n, subs[n])
    for n in drop[1::2]:
        del subs[n]
    return sid


def background(run: Run):
    """Plain subscriptions enough for the lowered `auto` threshold to flip
    the table to CSR."""
    for i in range(30):
        for j in range(8):
            run.sub(f"b{i}_{j}", f"device/{i}/+/{j}/#")


def csr_scenario(run: Run, seed: int, order: str, mesh=None):
    """(b): the churn recipe on an `auto` table with kslot 4. ``before``:
    the mesh set first, a batch on the dense table, the flip, more churn,
    the batch again (the flip's fresh mirror takes the CSR placement, its
    first prepare reshards the table over 'tp'); ``after``: the whole
    churn and the flip, then the mesh, then the batch."""
    rng = np.random.default_rng(seed)
    topics = [rand_topic(np.random.default_rng(seed + 7)) for _ in range(16)]
    batch = [(k, t, "pub") for k, t in enumerate(topics)]
    subs = {}
    if order == "before" and mesh is not None:
        run.attach(mesh)
    sid = churn_round(run, rng, 0, subs, 0)
    if order == "before":
        run.dispatch(batch)
        run.dense_first = not run.broker.subtab.sparse
    background(run)
    for r in (1, 2):
        sid = churn_round(run, rng, r, subs, sid)
    if order == "after" and mesh is not None:
        run.attach(mesh)
    run.dispatch([(100 + k, t, c) for k, t, c in batch])


def pipe_batches(seed: int):
    rng = np.random.default_rng(seed)
    return [topic_batch(rng, 1000 * b, 40) for b in range(PIPE_BATCHES)]


async def pipelined(broker, batches, depth: int):
    """Each batch through `adispatch_begin`, at most `depth` outstanding,
    settled in launch order: launch 0 .. depth - 1, then settle N before
    launching N + depth."""
    pend = collections.deque()
    counts = []
    for msgs in batches:
        if len(pend) == depth:
            counts.append(await pend.popleft().complete())
        pend.append(broker.adispatch_begin(msgs))
    while pend:
        counts.append(await pend.popleft().complete())
    return counts


def pipe_run(pkg, strategy, depth, mesh=None, delay=0.0):
    """(d): the base subscriptions, then `pipe_batches` at `depth` (0: the
    synchronous `dispatch_batch_folded`). `delay`: seconds the pool worker
    sleeps before each launch."""
    run = Run(pkg, "dense", strategy, mesh=mesh)
    base_subscriptions(run)
    batches = [run.messages(b) for b in pipe_batches(17)]
    if depth == 0:
        run.counts = [run.broker.dispatch_batch_folded(m) for m in batches]
        return run
    dev = run.broker._device_router()
    if delay:
        launch = dev.route_prepared

        def slow(*a, **k):
            time.sleep(delay)
            return launch(*a, **k)

        dev.route_prepared = slow
    run.counts = asyncio.run(asyncio.wait_for(pipelined(run.broker, batches, depth), 60))
    return run


def agentic_inputs():
    """bench.py `bench_agentic_fabric`'s fan_out at a test's size: room
    topics, room-scoped semantic filters (6 a room, under top-k 16)."""
    rng = np.random.default_rng(2209)
    cents = rng.normal(size=(AF_ROOMS, AF_DIM)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)

    def near(c):
        n = rng.normal(size=AF_DIM).astype(np.float32)
        n /= np.linalg.norm(n)
        v = cents[c] + 0.25 * n
        return (v / np.linalg.norm(v)).astype(np.float32)

    msgs = [(f"agents/room/{i % AF_ROOMS}/evt", near(i % AF_ROOMS), i % 4)
            for i in range(AF_MSGS)]
    sem = [(f"agents/room/{i % AF_ROOMS}/#", near(i % AF_ROOMS)) for i in range(AF_SEM)]
    plain = [f"agents/room/{i % AF_ROOMS}/#" for i in range(AF_PLAIN)]
    return msgs, sem, plain


def msg_index(m):
    return json.loads(m["payload"] if isinstance(m, dict) else m.payload)["k"]


def semantic_run(pkg, mesh=None):
    """(c): plain and semantic subscriptions, a device-attached rule, the
    messages through `publish_batch` in batches of AF_BATCH. -> (broker,
    deliveries [(k, sid)], fired rule rows, counts)."""
    msgs, sem, plain = agentic_inputs()
    b = pkg["broker"].Broker(
        pkg["router"].Router(pkg["matcher"].MatcherConfig(), min_tpu_batch=64, **pkg["dev"]),
        pkg["hooks"].Hooks())
    if mesh is not None:
        b.mesh = b.router.mesh = mesh
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
    counts = [b.publish_batch(out[lo:lo + AF_BATCH]) for lo in range(0, len(out), AF_BATCH)]
    return b, log, fired, counts


class Msg:
    """A stand-in slab message (the stores call `own_buffers`)."""

    def __init__(self, tag):
        self.tag = tag

    def own_buffers(self):
        pass


class Sink:
    """A channel-shaped resend sink: its due rows in one call."""

    def __init__(self):
        self.items = []

    def resend(self, pid, st, msg):  # bound per slot; the batch path is taken
        raise AssertionError("the batch path must be taken")

    def _store_resend_batch(self, items):
        self.items.extend((pid, st, msg.tag if msg is not None else None)
                          for pid, st, msg in items)
        return [True] * len(items)


def session_script(store, mono, sink, expired, on_sync):
    """(e): seeded churn of one store: inflight writes, phases, deletes,
    incoming QoS2 rows, a `bulk_load` that grows the table and the slot
    lane, expiry armed and swept, sessions dropped; `tick(fused_path=
    False)` after each step, then ``on_sync(step)``."""
    rng = np.random.default_rng(41)
    store.on_expired = expired.extend
    n0 = 40
    for i in range(n0):
        slot = store.attach(f"c{i}")
        for pid in range(1, 2 + i % 3):
            store.inflight_insert(slot, pid, Msg(i * 10 + pid), "publish")
        store.bind(slot, sink.resend)
    steps = []

    def sync(name):
        store.tick(fused_path=False)
        on_sync(name)
        steps.append(name)

    sync("load")
    mono[0] += 2.0
    for i in rng.choice(n0, 12, replace=False).tolist():
        store.inflight_phase(i, 1, "pubrel")
    for i in rng.choice(n0, 8, replace=False).tolist():
        store.inflight_delete(i, 2)
    for i in range(0, n0, 5):
        store.await_rel(i, 7)
    sync("phases")
    cids = [f"b{i}" for i in range(300)]
    store.bulk_load(cids, [Msg(5000 + i) for i in range(300)],
                    pids=(np.arange(300) % 3) + 1)
    for slot in range(n0, n0 + 300, 7):
        store.bind(slot, sink.resend)
    sync("bulk")
    mono[0] += 2.0
    for i in range(0, n0, 5):
        store.release_rel(i, 7)
    store.set_expiry("c3", 0.5)
    store.set_expiry("b10", 0.5)
    store.drop_session("c7")
    for i in rng.choice(n0, 10, replace=False).tolist():
        if i != 7:
            store.inflight_insert(i, 9, Msg(900 + i), "publish")
    sync("expiry")
    mono[0] += 3.0
    store.set_expiry("b290", 60.0)  # slot 330: the slot lane grows (an array resync)
    sync("sweep")
    return steps


# -- the ranks ----------------------------------------------------------------------


def per_message(log):
    out = collections.defaultdict(collections.Counter)
    for k, sid in log:
        out[k][sid] += 1
    return dict(out)


def scen_dense(mesh, pkg):
    out = {}
    for strategy in STRATEGIES:
        run = Run(pkg, "dense", strategy, mesh=mesh)
        dense_scenario(run, seed=len(strategy))
        out[strategy] = {"log": run.log, "counts": run.counts, "counters": run.counters(),
                         "router": type(run.broker._device_router()).__name__,
                         "span": run.broker._device_router().span_attrs()}
    return out


def scen_csr(mesh, pkg):
    out = {}
    flip = P_router.SubscriberTable.AUTO_MIN_DENSE_BYTES
    P_router.SubscriberTable.AUTO_MIN_DENSE_BYTES = LOW_FLIP
    try:
        for seed, order in CSR_CASES:
            run = Run(pkg, "auto", min_batch=1, kslot=4)
            run.dense_first = None
            ovf = []
            settle = run.broker._dispatch_device_results

            def counted(msgs, results, _settle=settle, _ovf=ovf):
                _ovf.append(int(np.count_nonzero(results.overflow)))
                return _settle(msgs, results)

            run.broker._dispatch_device_results = counted
            P_mesh.reset_collectives()
            csr_scenario(run, seed, order, mesh)
            st = run.broker._device_router().shard_status()
            out[(seed, order)] = {
                "log": run.log, "counts": run.counts, "dense_first": run.dense_first,
                "sparse": run.broker.subtab.sparse, "flips": run.broker.subtab.flips,
                "shards": run.broker.subtab.shards, "sub_table": st.get("sub_table"),
                "collectives": {k: dict(v) for k, v in P_mesh.COLLECTIVES.items()},
                "overflow_rows": ovf}
    finally:
        P_router.SubscriberTable.AUTO_MIN_DENSE_BYTES = flip
    return out


def scen_semantic(mesh, pkg):
    b, log, fired, counts = semantic_run(pkg, mesh)
    return {"log": sorted(log), "fired": sorted(fired), "counts": counts,
            "router": type(b._device_router()).__name__,
            "counters": {k: b.metrics.get(k) for k in (
                "rules.device.batches", "rules.host.batches", "semantic.hits",
                "messages.routed.device")},
            "sem_shards": b.semantic.table.shards}


def scen_pipeline(mesh, pkg):
    out = {}
    delay = 0.01 * mesh.rank
    for strategy in STRATEGIES:
        for depth in (0, 1, 2):
            run = pipe_run(pkg, strategy, depth, mesh=mesh, delay=delay)
            out[(strategy, depth)] = {"log": run.log, "counts": run.counts,
                                      "counters": run.counters()}
    return out


def mirror_equal(store) -> bool:
    """The store's mirror against this rank's block of its host lanes."""
    mgr = store.manager
    snap = store.table.device_snapshot()
    if set(mgr._arrays) != set(snap):
        return False
    return all(np.array_equal(mgr._arrays[k].cpu().numpy(),
                              np.ascontiguousarray(mgr.placement.place(k, v)).view(np.int32))
               for k, v in snap.items())


def scen_session(mesh, pkg):
    mono = [0.0]
    store = P_store.SessionStore(capacity=256, sweep_slots=16, retry_interval=1.0,
                                 clock=lambda: mono[0], mesh=mesh)
    sink, expired, syncs, checks = Sink(), [], [], []
    sync = store.manager.sync

    def checked(src):
        # the mirror against the host lanes as the sync left them (the
        # host sweep after it touches rows, which the next sync carries)
        out = sync(src)
        checks.append((mirror_equal(store), int(out["sess_slot"].shape[0]),
                       len(src.sess_slot)))
        return out

    store.manager.sync = checked

    def on_sync(step):
        syncs.append({"step": step, "syncs": len(checks),
                      "equal": all(c[0] and c[1] * mesh.dp == c[2] for c in checks),
                      "counters": store.manager.counters(),
                      "lanes": {k: v.copy() for k, v in store.table.device_snapshot().items()},
                      "local_rows": checks[-1][1],
                      "redelivered": len(sink.items)})

    steps = session_script(store, mono, sink, expired, on_sync)
    # a mesh broker hands its store no rider: the writes wait for the
    # manager's own scatter
    run = Run(pkg, "dense", mesh=mesh)
    base_subscriptions(run, groups=False)
    run.broker.session_store = store
    store.inflight_insert(0, 30, Msg(30), "publish")
    pos = store.manager._pos

    async def one():
        pd = run.broker.adispatch_begin(run.messages(topic_batch(np.random.default_rng(3), 0, 40)))
        rider_out = store._rider_out
        return rider_out, await pd.complete()

    rider_out, counts = asyncio.run(one())
    return {"steps": steps, "syncs": syncs, "items": sink.items, "expired": expired,
            "fusion": run.broker._device_router().supports_session_fusion,
            "rider_out": rider_out, "manager_pos_moved": store.manager._pos != pos,
            "oplog_pending": len(store.table.oplog) > store.manager._pos,
            "broker_counts": counts}


def router_pair(pkg, mesh=None):
    filters = [f"device/{i}/+/{j}/#" for i in range(12) for j in range(6)]
    filters += ["a/b/c", "a/b/c", "a/+/c", "#", "+/x", "$SYS/#", "device/1/#"]
    r = pkg["router"].Router(pkg["matcher"].MatcherConfig(max_bytes=64, max_levels=8),
                             min_tpu_batch=16, **pkg["dev"])
    r.mesh = mesh
    for f in filters:
        r.add_route(f)
    r.delete_route("a/b/c")
    r.delete_route("device/1/#")
    return r


def router_topics():
    rng = np.random.default_rng(2)
    topics = [f"device/{i}/m/{j}/x" for i, j in zip(rng.integers(0, 14, 40),
                                                   rng.integers(0, 8, 40))]
    return topics + ["a/b/c", "q/x", "$SYS/x", "", "device/1/a/2/b/c/d/e/f/g", "d/" + "y" * 80]


def scen_router(mesh, pkg):
    on, off = router_pair(pkg, mesh), router_pair(pkg)
    P_mesh.reset_collectives()
    got = on.match_batch(router_topics())
    coll = {k: dict(v) for k, v in P_mesh.COLLECTIVES.items()}
    return {"mesh": got, "plain": off.match_batch(router_topics()), "collectives": coll,
            "matcher_on_mesh": on.matcher.mesh is mesh,
            "fusion": on.matcher.supports_session_fusion}


async def ingest_drive(run: Run, batch):
    ing = P_ingest.BatchIngest(run.broker, max_batch=64, window_us=0, pipeline=1)
    run.broker.ingest = ing
    ing.start()
    futs = [await run.broker.apublish_enqueue(m) for m in run.messages(batch)]
    counts = [c if isinstance(c, int) else await c for c in futs]
    await ing.stop()
    run.broker.ingest = None
    return counts


def scen_ingest(mesh, pkg):
    import torch.distributed as dist

    refused = None
    run = Run(pkg, "dense", mesh=mesh)
    base_subscriptions(run, groups=False)

    async def start():
        P_ingest.BatchIngest(run.broker).start()

    try:
        asyncio.run(start())
    except NotImplementedError as e:
        refused = str(e)
    # a one-rank mesh of this rank alone: every rank makes every group
    solo = [dist.new_group([r]) for r in range(mesh.world)][mesh.rank]
    one = P_mesh.Mesh(1, 1, 0, mesh.device, mesh.backend,
                      {P_mesh.AXES: solo, "dp": solo, "tp": solo})
    batch = topic_batch(np.random.default_rng(23), 0, 200)
    out = {"refused": refused}
    for name, m in (("one_rank", one), ("no_mesh", None)):
        r = Run(pkg, "dense", mesh=m)
        base_subscriptions(r, groups=False)
        counts = asyncio.run(asyncio.wait_for(ingest_drive(r, batch), 60))
        out[name] = {"log": r.log, "counts": counts,
                     "device": r.broker.metrics.get("messages.routed.device"),
                     "router": type(r.broker._device_router()).__name__}
    return out


def rank_main(mesh):
    """Every scenario, on every rank of a 2 x 2 gloo mesh."""
    assert (mesh.dp, mesh.tp) == (DP, TP)
    pkg = port_pkg(mesh.device)
    return {"rank": mesh.rank, "coords": (mesh.axis_index("dp"), mesh.axis_index("tp")),
            "dense": scen_dense(mesh, pkg), "csr": scen_csr(mesh, pkg),
            "semantic": scen_semantic(mesh, pkg), "pipeline": scen_pipeline(mesh, pkg),
            "session": scen_session(mesh, pkg), "router": scen_router(mesh, pkg),
            "ingest": scen_ingest(mesh, pkg)}


# -- the launch ---------------------------------------------------------------------


def run_launch(tmp, target, device="cpu", timeout=LAUNCH_TIMEOUT):
    out = tmp / f"{target}.pkl"
    proc = subprocess.run(
        [sys.executable, "-m", "emqx_tpu_torch.parallel.launch", "--world", str(DP * TP),
         "--tp", str(TP), "--backend", "gloo", "--device", device, "--timeout", str(timeout),
         "--out", str(out), f"{HERE}:{target}"],
        # the subprocess's own limit adds interpreter start-up under load
        cwd=ROOT, capture_output=True, text=True, timeout=timeout + 20,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    res = pickle.loads(out.read_bytes()) if proc.returncode == 0 else None
    return proc, res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    proc, res = run_launch(tmp_path_factory.mktemp("mesh_broker"), "rank_main")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    return res


@pytest.fixture(scope="module")
def jmesh():
    from emqx_tpu.parallel.mesh import make_mesh

    return make_mesh(DP * TP, tp=TP)


@pytest.fixture
def low_flip(monkeypatch):
    from emqx_tpu.models import router_model as J_router

    monkeypatch.setattr(J_router.SubscriberTable, "AUTO_MIN_DENSE_BYTES", LOW_FLIP)


# -- every rank ----------------------------------------------------------------------


def test_every_rank_delivers_the_same(ranks):
    """The SPMD contract: every rank's fan-out delivers the whole batch, in
    the same order, whatever its 'dp' and 'tp' coordinates."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for s in STRATEGIES:
            assert r["dense"][s]["log"] == r0["dense"][s]["log"], (r["rank"], s)
            assert r["dense"][s]["counters"] == r0["dense"][s]["counters"]
        for case in CSR_CASES:
            assert r["csr"][case]["log"] == r0["csr"][case]["log"], (r["rank"], case)
        assert r["semantic"]["log"] == r0["semantic"]["log"]
        assert r["semantic"]["fired"] == r0["semantic"]["fired"]
        for key, got in r["pipeline"].items():
            assert got["log"] == r0["pipeline"][key]["log"], (r["rank"], key)
        assert r["session"]["items"] == r0["session"]["items"]
        assert r["router"]["mesh"] == r0["router"]["mesh"]


# -- (a) the dense broker --------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dense_mesh_broker_delivers_as_jax_mesh_and_single_device(ranks, jmesh, strategy):
    got = ranks[0]["dense"][strategy]
    assert got["router"] == "MeshServingRouter"
    assert got["span"] == {"device.mesh_shape": "2x2", "device.shard": "local"}
    for mesh in (jmesh, None):
        want = Run(jax_pkg(), "dense", strategy, mesh=mesh)
        dense_scenario(want, seed=len(strategy))
        assert (type(want.broker._device_router()).__name__ == "MeshServingRouter") == \
            (mesh is not None)
        assert got["counts"] == want.counts
        assert per_message(got["log"]) == per_message(want.log)
        assert got["counters"] == want.counters()
    c = got["counters"]
    assert c["messages.routed.device"] > 0 and c["messages.routed.device_fallback"] >= 4
    assert c["delivery.errors"] > 0
    # every matched group delivered each message to one member
    groups = per_message(got["log"])
    assert sum(1 for k in groups for s in groups[k] if s.startswith(("g", "a"))) > 50
    assert all(sum(1 for s in v if s.startswith("g")) <= 1 for v in groups.values())


# -- (b) the CSR broker ------------------------------------------------------------------


@pytest.mark.parametrize("seed,order", CSR_CASES)
def test_csr_mesh_broker_delivers_as_jax_single_device(ranks, low_flip, seed, order):
    got = ranks[0]["csr"][(seed, order)]
    want = Run(jax_pkg(), "auto", min_batch=1, kslot=4)
    csr_scenario(want, seed, order)
    assert got["counts"] == want.counts
    assert per_message(got["log"]) == per_message(want.log)
    assert got["sparse"] and want.broker.subtab.sparse
    assert got["flips"] == want.broker.subtab.flips == 1
    assert got["shards"] == TP and got["sub_table"] == "sparse"
    if order == "before":
        assert got["dense_first"]  # the first batch ran on the dense lanes
    # kslot 4: host-built rows beside compact ones (seed 5's batch has them)
    assert any(ranks[0]["csr"][c]["overflow_rows"][-1] for c in CSR_CASES)
    assert got["collectives"]["sparse_dist_shape_step"]["all_gather"] >= 1
    for r in ranks:
        assert r["csr"][(seed, order)]["shards"] == TP


# -- (c) semantic subscriptions and device rules -------------------------------------------


def explained(routing, emb, topic, sids):
    """Can the differing recipients `sids` of one message come from the
    float order alone? Each must be a semantic entry whose f64 similarity
    lies within TAU of its threshold or of the message's k-th score."""
    from emqx_tpu_torch.ops import topics as T

    vecs, slots, fids, ths = routing.table.live_arrays()
    sims = vecs.astype(np.float64) @ np.asarray(emb, np.float64)
    sid_of = {int(s): routing._by_slot[int(s)][0] for s in slots}
    scope_ok = np.array([fids[j] < 0 or T.match(topic, routing._by_slot[int(slots[j])][1])
                         for j in range(len(slots))], bool)
    ok = scope_ok & (sims >= ths)
    kth = np.sort(sims[ok])[::-1][AF_TOPK - 1] if ok.sum() >= AF_TOPK else -np.inf
    for sid in sids:
        js = [j for j in range(len(slots)) if sid_of[int(slots[j])] == sid]
        if not js or not any(scope_ok[j] and (abs(sims[j] - ths[j]) <= TAU
                                              or abs(sims[j] - kth) <= TAU) for j in js):
            return False
    return True


def test_semantic_and_rules_through_mesh_broker_as_jax(ranks):
    got = ranks[0]["semantic"]
    assert got["router"] == "MeshServingRouter" and got["sem_shards"] == TP
    _b, j_log, j_fired, j_counts = semantic_run(jax_pkg())
    assert got["fired"] == sorted(j_fired)
    assert len(got["fired"]) == AF_MSGS // 4
    twin, _l, _f, _c = semantic_run(port_pkg("cpu"))
    msgs, _sem, _plain = agentic_inputs()
    g, w = per_message(got["log"]), per_message(j_log)
    band = [k for k in set(g) | set(w) if g.get(k) != w.get(k)]
    for k in band:
        diff = set(g.get(k, {})) ^ set(w.get(k, {}))
        assert explained(twin.semantic, msgs[k][1], msgs[k][0], diff), (k, diff)
    assert len(band) <= 2, band
    if not band:
        assert got["counts"] == j_counts
    c = got["counters"]
    assert c["rules.device.batches"] == AF_MSGS // AF_BATCH and c["rules.host.batches"] == 0
    assert c["semantic.hits"] > 0 and c["messages.routed.device"] == AF_MSGS
    assert any(s.startswith("s") for _k, s in got["log"])


# -- (d) the pipelined seam -------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_adispatch_depth_2_completes_and_delivers_as_depth_1(ranks, strategy):
    p = ranks[0]["pipeline"]
    sync, d1, d2 = (p[(strategy, d)] for d in (0, 1, 2))
    assert len(sync["counts"]) == PIPE_BATCHES
    # depth 1 is the synchronous path, delivery for delivery
    assert d1["log"] == sync["log"] and d1["counts"] == sync["counts"]
    assert d1["counters"] == sync["counters"] == d2["counters"]
    plain = [(k, s) for k, s in sync["log"] if not s.startswith(("g", "a"))]
    assert [(k, s) for k, s in d2["log"] if not s.startswith(("g", "a"))] == plain
    if strategy == "hash_clientid":  # picks read no base: the same members
        assert d2["log"] == sync["log"] and d2["counts"] == sync["counts"]
    # depth 2 is the single-device schedule, in both packages
    for pkg in (port_pkg("cpu"), jax_pkg()):
        want = pipe_run(pkg, strategy, 2)
        assert d2["log"] == want.log and d2["counts"] == want.counts
    want1 = pipe_run(jax_pkg(), strategy, 1)
    assert d1["log"] == want1.log


# -- (e) the session store on the mesh ------------------------------------------------------


def test_session_mirror_is_each_ranks_dp_block(ranks):
    cap = None
    for r in ranks:
        s = r["session"]
        assert s["steps"] == ["load", "phases", "bulk", "expiry", "sweep"]
        for sync in s["syncs"]:
            assert sync["equal"], (r["rank"], sync["step"])
            cap = len(sync["lanes"]["sess_slot"])
        assert s["syncs"][-1]["local_rows"] == cap // DP
    # a tick syncs only with writes pending: `bulk`'s epoch bump left none,
    # so its full upload waits for `expiry`'s writes, as in the reference
    assert [s["syncs"] for s in ranks[0]["session"]["syncs"]] == [1, 2, 2, 3, 4]
    # the table and the slot lane grew in `bulk`: both still split over dp
    assert cap >= 512
    assert len(ranks[0]["session"]["syncs"][-1]["lanes"]["slot_expiry"]) >= 512

    def decision(c):
        return c["full_resyncs"], c["array_resyncs"], c["delta_launches"] + c["delta_skipped"]

    for step in range(len(ranks[0]["session"]["syncs"])):
        c = [r["session"]["syncs"][step]["counters"] for r in ranks]
        assert len({decision(x) for x in c}) == 1, (step, c)
    last = ranks[0]["session"]["syncs"][-1]["counters"]
    assert last["full_resyncs"] == 2 and last["array_resyncs"] >= 1
    assert last["delta_launches"] + last["delta_skipped"] >= 1


def test_session_host_lanes_and_redeliveries_match_jax_and_one_device(ranks, jmesh):
    got = ranks[0]["session"]
    for pkg, kw in ((jax_pkg(), {"mesh": jmesh}), (port_pkg("cpu"), {"device": "cpu"})):
        mono = [0.0]
        store = pkg["store"].SessionStore(capacity=256, sweep_slots=16, retry_interval=1.0,
                                          clock=lambda: mono[0], **kw)
        sink, expired, lanes = Sink(), [], []

        def on_sync(step):
            lanes.append({k: np.asarray(v).copy()
                          for k, v in store.table.device_snapshot().items()})

        session_script(store, mono, sink, expired, on_sync)
        for want, sync in zip(lanes, got["syncs"]):
            assert set(want) == set(sync["lanes"])
            for k in want:
                np.testing.assert_array_equal(sync["lanes"][k], want[k],
                                              err_msg=(sync["step"], k))
        assert got["items"] == sink.items
        assert got["expired"] == expired
    assert len(got["items"]) > 100 and got["expired"]


def test_mesh_broker_hands_no_rider(ranks):
    for r in ranks:
        s = r["session"]
        assert s["fusion"] is False and s["rider_out"] is False
        assert not s["manager_pos_moved"] and s["oplog_pending"]
        assert sum(s["broker_counts"]) > 0


# -- (f) Router.mesh --------------------------------------------------------------------------


def test_router_mesh_matches_the_router_without_and_jax(ranks, jmesh):
    want = router_pair(jax_pkg(), jmesh).match_batch(router_topics())
    for r in ranks:
        got = r["router"]
        assert got["matcher_on_mesh"] and got["fusion"] is False
        assert got["mesh"] == got["plain"] == want
        assert got["collectives"] == {}  # the match-only step meets no other rank


# -- (g) BatchIngest on the mesh ----------------------------------------------------------


def test_batch_ingest_refuses_a_four_rank_mesh(ranks):
    for r in ranks:
        msg = r["ingest"]["refused"]
        assert msg is not None and "4-rank mesh" in msg and "ROADMAP item 10" in msg


def test_batch_ingest_on_a_one_rank_mesh_delivers_as_without(ranks):
    for r in ranks:
        one, plain = r["ingest"]["one_rank"], r["ingest"]["no_mesh"]
        assert one["router"] == "MeshServingRouter" and plain["router"] == "DeviceRouter"
        assert one["counts"] == plain["counts"]
        assert per_message(one["log"]) == per_message(plain["log"])
        # 200 messages: three batches of 64 on the device, 8 on the CPU path
        assert one["device"] == plain["device"] == 192


# -- CPU, no launch ----------------------------------------------------------------------


def test_session_placement_cuts_lanes_as_jax_p_dp(jmesh):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    table = P_st.SessionTable(capacity=64, slots=16)
    for i in range(40):
        table.insert(i % 16, 1 + i, P_st.ST_PUBLISH, 3 * i, i)
    snap = table.device_snapshot()
    devices = np.asarray(jmesh.devices)
    for rank in range(DP * TP):
        m = P_mesh.Mesh(DP, TP, rank, torch.device("cpu"), "gloo", {})
        place = P_mesh.session_placement(m)
        dev = devices[m.axis_index("dp"), m.axis_index("tp")]
        for name, arr in snap.items():
            sharded = jax.device_put(arr, NamedSharding(jmesh, P("dp")))
            want = [np.asarray(s.data) for s in sharded.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(place.place(name, arr), want[0], err_msg=name)


def test_match_only_router_on_a_one_rank_mesh_equals_one_without():
    one = P_mesh.Mesh(1, 1, 0, torch.device("cpu"), "gloo", {})
    on, off = router_pair(port_pkg("cpu"), one), router_pair(port_pkg("cpu"))
    P_mesh.reset_collectives()
    assert on.match_batch(router_topics()) == off.match_batch(router_topics())
    assert on.matcher.mesh is one and P_mesh.COLLECTIVES == {}
    assert on.matcher.device == torch.device("cpu")


def test_store_on_a_mesh_takes_the_ranks_device():
    one = P_mesh.Mesh(1, 1, 0, torch.device("cpu"), "gloo", {})
    store = P_store.SessionStore(capacity=64, mesh=one)
    assert store.manager.device == torch.device("cpu")
    assert store.manager.placement.parts == 1
    slot = store.attach("c")
    store.inflight_insert(slot, 1, Msg(1), "publish")
    store.tick(fused_path=False)
    assert mirror_equal(store)
    card = P_mesh.Mesh(1, 1, 0, torch.device("cuda", 0), "nccl", {})
    with pytest.raises(ValueError, match="not the mesh rank's"):
        P_store.SessionStore(mesh=card, device="cpu")


# -- on the card (skipped without CUDA) ---------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


def rank_cuda(mesh):
    """The dense, CSR and pipelined scenarios on four gloo ranks on CUDA."""
    assert mesh.device.type == "cuda"
    pkg = port_pkg(mesh.device)
    return {"rank": mesh.rank, "dense": scen_dense(mesh, pkg), "csr": scen_csr(mesh, pkg),
            "pipeline": scen_pipeline(mesh, pkg), "session": scen_session(mesh, pkg)}


@pytest.mark.cuda
def test_gloo_mesh_broker_on_cuda_equals_the_cpu_mesh(ranks, cuda_device, tmp_path):
    proc, res = run_launch(tmp_path, "rank_cuda", device="cuda", timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for got, want in zip(res, ranks):
        for s in STRATEGIES:
            assert got["dense"][s]["log"] == want["dense"][s]["log"]
            assert got["dense"][s]["counts"] == want["dense"][s]["counts"]
        for case in CSR_CASES:
            assert got["csr"][case]["log"] == want["csr"][case]["log"]
        for key, p in got["pipeline"].items():
            assert p["log"] == want["pipeline"][key]["log"], key
        assert got["session"]["items"] == want["session"]["items"]
        assert all(s["equal"] for s in got["session"]["syncs"])
