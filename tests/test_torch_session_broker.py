"""The session store's broker half in the port against the JAX package.

`emqx_tpu_torch.broker.inflight`, `.mqueue`, `.session`, the store's
`StoreInflight`, `mqtt.slab_serializer`, the rider handoff in
`Broker.adispatch_begin` and `convert.session_state_from_reference`
(port, on ``device="cpu"``: the kernels' plain twins) against
`emqx_tpu`'s modules on the same seeded drives:

- `Inflight` and `MQueue` through one op script; a seeded `Session`
  script of delivers (QoS 0-2, queueing past a full window, retain and
  property handling), PUBACK / PUBREC / PUBCOMP, `await_rel` /
  `release_rel`, `retry` and `replay` under a frozen monotonic clock: the
  same packets and the same window in both packages, with and without a
  store, and a store-backed session sending what a plain one sends;
- `StoreInflight`: the table's lanes, op-log and message slab after the
  script;
- `serialize_pub_slab` (v4 and v5, properties, empty payloads, every
  remaining-length size class), `frames_of`, `pid_bytes`, `pubrel_frame`
  and `encode_properties`: byte-identical;
- the broker's rider handoff: one device->host transfer a batch and no
  scatter of the store's own; a device sweep riding a launch; one rider
  outstanding and an abort requeueing; `adispatch_batch_folded` and a
  `BatchIngest` drive at pipeline 1 and 2 delivering the same packets
  with the same riders, counters and redelivered (pid, state) sets as
  JAX's broker; a PUBREC landing during a stalled launch; a raising
  launch aborting its rider; the mirror equal to the host lanes after a
  flush;
- the dict path's `Session.retry()` picking what the store's sweep
  redelivers;
- a JAX store's capture carried across: the port's store installed from
  it redelivers the rows JAX's does;
- `chip_smoke.py`'s broker flood (bench.py's session_storm drive) at 2,048
  sessions through both brokers.

The `cuda` test runs the broker drive on the card against the CPU twins.
Tolerance: EXACT equality (packets, bytes, integer lanes and counts).
"""

import asyncio
import functools
import time

import numpy as np
import pytest
import torch

import chip_smoke
from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import inflight as J_inflight
from emqx_tpu.broker import ingest as J_ingest
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import mqueue as J_mqueue
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.broker import session as J_session
from emqx_tpu.broker import session_store as J_store
from emqx_tpu.models import router_model as J_router
from emqx_tpu.mqtt import frame as J_frame
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.mqtt import slab_serializer as J_slab
from emqx_tpu_torch import convert
from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import inflight as P_inflight
from emqx_tpu_torch.broker import ingest as P_ingest
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import mqueue as P_mqueue
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.broker import session as P_session
from emqx_tpu_torch.broker import session_store as P_store
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.mqtt import frame as P_frame
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.mqtt import slab_serializer as P_slab
from emqx_tpu_torch.ops import segments as P_seg

PKG = {
    "port": dict(broker=P_broker, hooks=P_hooks, inflight=P_inflight, ingest=P_ingest,
                 message=P_message, mqueue=P_mqueue, router=P_brouter, session=P_session,
                 store=P_store, rmodel=P_router, packet=P_packet, slab=P_slab,
                 dev={"device": "cpu"}),
    "jax": dict(broker=J_broker, hooks=J_hooks, inflight=J_inflight, ingest=J_ingest,
                message=J_message, mqueue=J_mqueue, router=J_brouter, session=J_session,
                store=J_store, rmodel=J_router, packet=J_packet, slab=J_slab, dev={}),
}


def run_async(fn, *a, timeout=120):
    return asyncio.run(asyncio.wait_for(fn(*a), timeout=timeout))


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pkt_key(p):
    """A packet as plain values (the two packages' classes differ)."""
    if hasattr(p, "topic"):
        return ("publish", p.type, p.topic, bytes(p.payload), p.qos, p.retain, p.dup,
                p.packet_id, sorted(p.properties.items()))
    return ("ack", p.type, p.packet_id, p.reason_code)


def msg_key(m):
    if m is None:
        return None
    return (m.topic, bytes(m.payload), m.qos, m.retain, m.dup, m.from_client,
            sorted(m.properties.items()), sorted(m.headers.items()))


@pytest.fixture
def frozen(monkeypatch):
    """time.monotonic frozen at a clock the test moves: both packages'
    inflight windows and sessions read it through the `time` module."""
    mono = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: mono[0])
    return mono


# -- Inflight, MQueue ----------------------------------------------------------


def inflight_mqueue_trace(pkg, mono):
    M = pkg["message"].Message
    mono[0] = 100.0
    out = []
    inf = pkg["inflight"].Inflight(max_size=3)
    for pid in (1, 2, 3):
        inf.insert(pid, M(topic=f"t/{pid}", payload=b"x%d" % pid, qos=2))
    out.append((len(inf), inf.is_full(), inf.contains(2), inf.contains(9)))
    out.append((inf.update(2, "pubrel"), inf.update(9, "pubrel")))
    e = inf.get(2)
    out.append((e.phase, msg_key(e.msg), e.ts))
    out.append([(pid, e.phase, msg_key(e.msg)) for pid, e in inf.items()])
    mono[0] = 140.0
    out.append([p for p, _e in inf.retry_due(30.0)])
    out.append([p for p, _e in inf.retry_due(50.0)])
    out.append(msg_key(inf.delete(1).msg))
    out.append((inf.delete(1), len(inf), inf.is_full()))
    out.append(pkg["inflight"].Inflight(max_size=0).is_full())
    q = pkg["mqueue"].MQueue(max_len=4)
    for k, topic in enumerate(["a", "hi", "lo", "b", "hi", "lo", "c"]):
        dropped = q.in_(M(topic=topic, payload=b"%d" % k, qos=k % 3))
        out.append((len(q), msg_key(dropped), q.dropped))
    out.append([msg_key(m) for m in q.peek_all()])
    out.append([msg_key(q.out()) for _ in range(6)])
    q0 = pkg["mqueue"].MQueue(max_len=0)
    for k in range(5):
        q0.in_(M(topic="z", payload=b"%d" % k, qos=0))
    out.append((len(q0), q0.dropped, msg_key(q0.out()), len(q0)))
    return out


def test_inflight_and_mqueue_equal_jax(frozen):
    got = {name: inflight_mqueue_trace(pkg, frozen) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    assert got["port"][1] == (True, False)
    assert got["port"][2][1][1] == b""  # the rel phase dropped the payload


# -- Session ---------------------------------------------------------------------


def session_script(pkg, seed, store, mono):
    """A seeded conversation on one session; -> (trace, final state)."""
    rng = np.random.default_rng(seed)
    S = pkg["session"]
    M = pkg["message"].Message
    Opts = pkg["packet"].SubOpts
    cfg = S.SessionConfig(max_inflight=4, max_mqueue=6, retry_interval=30.0,
                          max_awaiting_rel=5)
    sess = S.Session("c1", cfg, store=store)
    trace = []

    def known_pid():
        pids = [p for p, _e in sess.inflight.items()]
        if pids and rng.random() < 0.85:
            return int(pids[rng.integers(0, len(pids))])
        return int(rng.integers(1, 12))

    for step in range(160):
        op = rng.integers(0, 10)
        if op <= 3:
            props = {"Content-Type": "text/x"} if rng.random() < 0.3 else {}
            headers = {"retained": True} if rng.random() < 0.2 else {}
            msg = M(topic=f"q/{step}", payload=b"" if rng.random() < 0.2 else b"p%d" % step,
                    qos=int(rng.integers(0, 3)), retain=bool(rng.random() < 0.3),
                    properties=props, headers=headers)
            opts = None if rng.random() < 0.3 else Opts(
                qos=int(rng.integers(0, 3)), retain_as_published=bool(rng.random() < 0.5))
            trace.append(("deliver", [pkt_key(p) for p in sess.deliver(msg, opts)]))
        elif op == 4:
            m, more = sess.puback(known_pid())
            trace.append(("puback", msg_key(m), [pkt_key(p) for p in more]))
        elif op == 5:
            trace.append(("pubrec", sess.pubrec(known_pid())))
        elif op == 6:
            m, more = sess.pubcomp(known_pid())
            trace.append(("pubcomp", msg_key(m), [pkt_key(p) for p in more]))
        elif op == 7:
            pid = int(rng.integers(1, 9))
            try:
                trace.append(("await_rel", pid, sess.await_rel(pid)))
            except OverflowError as e:
                trace.append(("await_rel", pid, str(e)))
            trace.append(("release_rel", sess.release_rel(int(rng.integers(1, 9)))))
        elif op == 8:
            mono[0] += float(rng.integers(0, 40))
            trace.append(("retry", [pkt_key(p) for p in sess.retry()]))
        else:
            trace.append(("replay", [pkt_key(p) for p in sess.replay()]))
        mono[0] += 1.0
    state = ([(pid, e.phase, msg_key(e.msg), e.ts) for pid, e in sess.inflight.items()],
             [msg_key(m) for m in sess.mqueue.peek_all()], sess.mqueue.dropped,
             sorted(sess.awaiting_rel.items()), sess._next_pid, sess.store_slot)
    return trace, state


def twin_store(pkg, mono, **kw):
    kw = {"capacity": 64, "sweep_slots": 16, "retry_interval": 30.0, **kw}
    return pkg["store"].SessionStore(clock=lambda: mono[0], **kw, **pkg["dev"])


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_session_script_equals_jax(frozen, seed, store):
    got = {}
    for name, pkg in PKG.items():
        frozen[0] = 100.0
        got[name] = session_script(pkg, seed, twin_store(pkg, frozen) if store else None,
                                   frozen)
    assert got["port"] == got["jax"]
    trace, _state = got["port"]
    kinds = {t[0] for t in trace}
    assert kinds == {"deliver", "puback", "pubrec", "pubcomp", "await_rel", "release_rel",
                     "retry", "replay"}
    if store:  # the write-through changes nothing a client sees
        frozen[0] = 100.0
        assert session_script(PKG["port"], seed, None, frozen)[0] == trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_inflight_lanes_and_oplog_equal_jax(frozen, seed):
    stores = {}
    for name, pkg in PKG.items():
        frozen[0] = 100.0
        stores[name] = twin_store(pkg, frozen)
        session_script(pkg, seed, stores[name], frozen)
    p, j = stores["port"], stores["jax"]
    assert p.table.oplog == j.table.oplog and p.table.epoch == j.table.epoch
    for k, v in j.table.device_snapshot().items():
        a = p.table.device_snapshot()[k]
        assert a.dtype == v.dtype == np.int32
        np.testing.assert_array_equal(a, v, err_msg=k)
    assert p.status() == j.status()
    assert [msg_key(m) for m in p._slab] == [msg_key(m) for m in j._slab]
    assert p._free_mids == j._free_mids
    assert p.table.live > 0 and p.table.oplog
    sess = P_session.Session("c2", P_session.SessionConfig(), store=p)
    assert isinstance(sess.inflight, P_store.StoreInflight) and sess.inflight.store_managed
    assert not P_inflight.Inflight.store_managed


def test_redelivery_equivalence_sweep_vs_retry_as_jax(frozen):
    """The store's sweep and the dict path's `retry` pick the same packets
    (tests/test_session_store.py:354), in both packages."""
    out = {}
    for name, pkg in PKG.items():
        frozen[0] = 100.0
        S, M, P = pkg["session"], pkg["message"].Message, pkg["packet"]
        cfg = S.SessionConfig(retry_interval=30.0)
        plain = S.Session("rd", cfg)
        store = twin_store(pkg, frozen, capacity=256)
        backed = S.Session("rd", cfg, store=store)
        for s in (plain, backed):
            s.deliver(M(topic="a", payload=b"1", qos=1))
            s.pubrec(s.deliver(M(topic="b", payload=b"2", qos=2))[0].packet_id)
        frozen[0] += 31.0
        dict_out = sorted((p.type, p.qos if p.type == P.PUBLISH else None, p.packet_id)
                          for p in plain.retry())
        swept = []

        def resend(pid, state, msg, P=P, mod=pkg["store"]):
            swept.append((P.PUBREL, None, pid) if state == mod.ST_PUBREL
                         else (P.PUBLISH, msg.qos, pid))
            return True

        store.bind(backed.store_slot, resend)
        assert store.host_sweep() == 2
        assert sorted(swept) == dict_out
        assert store.host_sweep() == 0  # stamps refreshed
        out[name] = dict_out
    assert out["port"] == out["jax"]


# -- the slab serializer ---------------------------------------------------------


PROPS = [
    {},
    {"Content-Type": "json", "Message-Expiry-Interval": 60},
    {"User-Property": [("k", "v"), ("a", "ü")], "Correlation-Data": b"\x00\x01",
     "Payload-Format-Indicator": 1, "Topic-Alias": 7},
    {"Subscription-Identifier": [1, 300, 70000], "Response-Topic": "r/t"},
]


def slab_items(mod_frame, rng, n=300):
    items = []
    sizes = [0, 0, 1, 100, 125, 126, 127, 200, 16380, 20000, 2_097_200]
    for k in range(n):
        size = sizes[k % len(sizes)] if k < 3 * len(sizes) else int(rng.integers(0, 300))
        topic = ("t/%d/" % k + "x" * int(rng.integers(0, 40))).encode()
        if k % 5 == 0:
            topic = memoryview(topic)
        payload = bytes(rng.integers(0, 256, size, dtype=np.uint8)) if size else (
            None if k % 2 else b"")
        qos = int(rng.integers(0, 3))
        props = PROPS[k % len(PROPS)]
        pb = None if k % 3 == 0 else mod_frame.encode_properties(props)
        items.append((topic, payload, qos, bool(rng.random() < 0.3), bool(rng.random() < 0.5),
                      int(rng.integers(1, 65536)) if qos else None, pb))
    return items


@pytest.mark.parametrize("version", [4, 5])
def test_serialize_pub_slab_equals_jax(version):
    for seed in (0, 1):
        got = {}
        for name, mod_frame, mod_slab in (("port", P_frame, P_slab), ("jax", J_frame, J_slab)):
            items = slab_items(mod_frame, np.random.default_rng(seed))
            slab, offs = mod_slab.serialize_pub_slab(items, version=version)
            frames = [bytes(f) for f in mod_slab.frames_of(slab, offs)]
            got[name] = (bytes(slab), offs, frames)
        assert got["port"][0] == got["jax"][0]
        assert got["port"][1].dtype == np.int64
        np.testing.assert_array_equal(got["port"][1], got["jax"][1])
        assert got["port"][2] == got["jax"][2] and len(got["port"][2]) == 300
    empty = P_slab.serialize_pub_slab([], version=version)
    assert empty[0] == bytearray() and empty[1].tolist() == [0]
    for pid in (1, 255, 256, 65535):
        assert P_slab.pid_bytes(pid) == J_slab.pid_bytes(pid)
        assert P_slab.pubrel_frame(pid) == J_slab.pubrel_frame(pid)


def test_encode_properties_equals_jax():
    for props in PROPS + [None, {"Reason-String": "x" * 70000}]:
        outs = []
        for mod in (P_frame, J_frame):
            try:
                outs.append(mod.encode_properties(props))
            except mod.FrameError as e:
                outs.append(("error", e.reason))
        assert outs[0] == outs[1]
    assert outs[0] == ("error", "utf8_string_too_long")
    for mod in (P_frame, J_frame):
        with pytest.raises(mod.FrameError, match="unknown_property"):
            mod.encode_properties({"No-Such": 1})
        for n in (0, 127, 128, 16383, 16384, 268435455):
            assert P_frame.encode_varint(n) == J_frame.encode_varint(n)
        with pytest.raises(mod.FrameError):
            mod.encode_varint(268435456)


# -- the broker's rider handoff --------------------------------------------------


def mk_broker(pkg, min_batch=1):
    cfg = {"min_tpu_batch": min_batch, **pkg["dev"]}
    return pkg["broker"].Broker(router=pkg["router"].Router(**cfg), hooks=pkg["hooks"].Hooks())


def attach_store(pkg, b, **kw):
    kw = {"capacity": 256, "sweep_slots": 64, "retry_interval": 30.0, **kw}
    store = pkg["store"].SessionStore(metrics=b.metrics, **kw, **pkg["dev"])
    b.session_store = store
    return store


def session_sub(pkg, b, store, cid="c0", qos=1, flt="t/#"):
    """One store-backed subscriber session wired into the broker's fan-out."""
    sess = pkg["session"].Session(cid, pkg["session"].SessionConfig(), store=store)
    sent = []
    b.subscribe(cid, cid, flt, pkg["packet"].SubOpts(qos=qos),
                lambda m, o: sent.extend(sess.deliver(m, o)))
    return sess, sent


def msgs(pkg, n, qos=1, prefix="t"):
    return [pkg["message"].Message(topic=f"{prefix}/{i % 8}/x", payload=b"p%d" % i, qos=qos)
            for i in range(n)]


def nomatch(pkg, n):
    """No subscribers: the batch carries the pending session writes."""
    return [pkg["message"].Message(topic=f"none/{i}", payload=b"p") for i in range(n)]


def mirror(store):
    """The store's mirror on the host, asserted to hold every host write."""
    peek = store.manager.peek_delta(store.table)
    assert peek is not None, "mirror absent or behind an epoch"
    arrays, per, _pos, _epoch = peek
    assert not per, "the mirror lags the host op-log"
    return {k: host(v) for k, v in arrays.items()}


def assert_mirror_is_host(store):
    m, t = mirror(store), store.table.device_snapshot()
    assert sorted(m) == sorted(t)
    for k, v in t.items():
        assert m[k].dtype == v.dtype == np.int32
        np.testing.assert_array_equal(m[k], v, err_msg=k)


class TransferSpy:
    """Counts `device.transfer.bytes` increments on a broker's metrics."""

    def __init__(self, metrics):
        self.metrics, self.incs, self.real = metrics, [], metrics.inc

        def inc(name, n=1):
            if name == "device.transfer.bytes":
                self.incs.append(n)
            return self.real(name, n)

        metrics.inc = inc

    def close(self):
        self.metrics.inc = self.real


COUNTERS = ("session.ack.rides", "session.ack.rows", "session.sweep.device",
            "session.sweep.due", "session.redeliveries", "session.sweep.host")


def counters(b):
    return {k: b.metrics.get(k) for k in COUNTERS}


async def acks_ride(pkg):
    """tests/test_session_store.py:401: acks ride the batch's one launch."""
    b = mk_broker(pkg)
    store = attach_store(pkg, b)
    sess, sent = session_sub(pkg, b, store)
    await b.adispatch_batch_folded(msgs(pkg, 8))  # the first full sync
    pids = [p.packet_id for p in sent]
    for pid in pids[:4]:
        sess.puback(pid)
    spy = TransferSpy(b.metrics)
    await b.adispatch_batch_folded(msgs(pkg, 8))  # the acks ride this one
    spy.close()
    rides = counters(b)
    delta0 = store.manager.delta_launches
    for p in sent[8:]:
        sess.puback(p.packet_id)
    for _ in range(2):
        await b.adispatch_batch_folded(nomatch(pkg, 4))
    assert_mirror_is_host(store)
    return ([pkt_key(p) for p in sent], len(spy.incs), rides, delta0,
            store.manager.delta_launches, counters(b), store.table.live)


def test_acks_ride_one_launch_one_transfer_as_jax():
    got = {name: run_async(acks_ride, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    sent, transfers, rides, d0, d1, final, live = got["port"]
    assert len(sent) == 16 and transfers == 1
    assert rides["session.ack.rides"] == 1 and rides["session.ack.rows"] > 0
    assert d0 == d1 == 0 and live == 4  # the last batch's four stay unacked


async def sweep_ride(pkg):
    """tests/test_session_store.py:446: a device sweep rides a launch."""
    mono = [50.0]
    b = mk_broker(pkg)
    store = attach_store(pkg, b, retry_interval=1.0, clock=lambda: mono[0])
    sess, sent = session_sub(pkg, b, store)
    resent = []
    store.bind(sess.store_slot, lambda pid, st, msg: resent.append((pid, st)) or True)
    await b.adispatch_batch_folded(msgs(pkg, 6))
    await b.adispatch_batch_folded(msgs(pkg, 1))  # the inserts ride
    live = store.table.live
    mono[0] += 5.0
    store.request_sweep()
    await b.adispatch_batch_folded(msgs(pkg, 4))
    return [pkt_key(p) for p in sent], resent, live, counters(b)


def test_device_sweep_rides_launch_and_redelivers_as_jax():
    got = {name: run_async(sweep_ride, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    sent, resent, live, c = got["port"]
    assert live == 7 and c["session.sweep.device"] == 1 and c["session.redeliveries"] >= 7
    assert sorted(p for p, _ in resent[:7]) == sorted(p[7] for p in sent[:7])


def test_one_rider_outstanding_and_abort_requeues_as_jax():
    """tests/test_session_store.py:467 in both packages."""
    out = {}
    for name, pkg in PKG.items():
        store = pkg["store"].SessionStore(capacity=128, **pkg["dev"])
        S, M = pkg["session"], pkg["message"].Message
        s = S.Session("r1", S.SessionConfig(), store=store)
        s.deliver(M(topic="a", payload=b"x", qos=1))
        assert store.take_rider() is None  # the first: a full sync, no suffix
        s.deliver(M(topic="b", payload=b"x", qos=1))
        r1 = store.take_rider()
        assert r1 is not None and r1.rows > 0
        s.deliver(M(topic="c", payload=b"x", qos=1))
        assert store.take_rider() is None  # behind r1
        store.abort(r1)
        r2 = store.take_rider()
        assert r2 is not None and r2.pos > r1.pos
        for k in r1.idxs:  # r2 re-carries r1's writes
            assert set(r1.idxs[k].tolist()) <= set(r2.idxs[k].tolist())
        out[name] = [(r.pos, r.epoch, r.rows, sorted(r.idxs), [r.idxs[k].tolist() for k in
                                                             sorted(r.idxs)])
                     for r in (r1, r2)]
    assert out["port"] == out["jax"]


DRIVE_SESSIONS = 24
DRIVE_BATCH = 32


async def broker_drive(pkg, mode, sweep_k=256):
    """Store-backed sessions s{i} (QoS1 on s/{i}/#; every fourth QoS2)
    under one broker, driven by `mode`: "folded" (`adispatch_batch_folded`
    a batch) or "ingest1" / "ingest2" (`BatchIngest` at that pipeline,
    full batches enqueued at once). Four batches of publishes, acks on the
    loop (PUBACKs, PUBRECs, PUBCOMPs), a sweep with the clock past the
    retry interval (one sweep lists every due row) riding two batches, a
    flush. -> what every party saw."""
    mono = [10.0]
    b = mk_broker(pkg, min_batch=8)
    store = attach_store(pkg, b, capacity=64, sweep_slots=sweep_k, retry_interval=1.0,
                         clock=lambda: mono[0])
    M = pkg["message"].Message
    subs, resent = [], []
    for i in range(DRIVE_SESSIONS):
        sess, sent = session_sub(pkg, b, store, cid=f"s{i}", qos=2 if i % 4 == 0 else 1,
                                 flt=f"s/{i}/#")
        store.bind(sess.store_slot,
                   lambda pid, st, msg, i=i: resent.append((i, pid, st, msg_key(msg))) or True)
        subs.append((sess, sent))
    batches = []
    ing = None
    if mode != "folded":
        ing = pkg["ingest"].BatchIngest(b, max_batch=DRIVE_BATCH, window_us=0,
                                        pipeline=int(mode[-1]))
        b.ingest = ing
        ing.start()

    async def publish(ms):
        batches.append(len(ms))
        if ing is None:
            for k in range(0, len(ms), DRIVE_BATCH):
                await b.adispatch_batch_folded(ms[k:k + DRIVE_BATCH])
        else:
            await asyncio.gather(*[ing.enqueue(m) for m in ms])

    spy = TransferSpy(b.metrics)
    k = 0
    for rnd in range(4):
        ms = []
        for _ in range(DRIVE_BATCH):
            i = (k * 7) % DRIVE_SESSIONS
            # QoS2 publishes (the ingest's control lane: one lane keeps the
            # batches in enqueue order), delivered at the subscription's QoS
            ms.append(M(topic=f"s/{i}/{rnd}", payload=b"%d" % k, qos=2))
            k += 1
        await publish(ms)
    for i, (sess, sent) in enumerate(subs):
        for p in sent[: len(sent) // 2]:
            if p.qos == 1:
                sess.puback(p.packet_id)
            elif i % 8 == 0:
                sess.pubrec(p.packet_id)
                sess.pubcomp(p.packet_id)
            else:
                sess.pubrec(p.packet_id)
    mono[0] += 5.0
    store.request_sweep()
    await publish(nomatch(pkg, 2 * DRIVE_BATCH))
    await publish(nomatch(pkg, 2 * DRIVE_BATCH))  # the flush
    if ing is not None:
        await ing.stop()
    spy.close()
    assert_mirror_is_host(store)
    sent = [[pkt_key(p) for p in s] for _sess, s in subs]
    return {"sent": sent, "resent": sorted(resent), "counters": counters(b),
            "delta_launches": store.manager.delta_launches, "transfers": len(spy.incs),
            "full_resyncs": store.manager.full_resyncs, "live": store.table.live,
            "lanes": {k: v.copy() for k, v in store.table.device_snapshot().items()}}


def assert_drives_equal(a, b, same_riders=True):
    assert a["sent"] == b["sent"]
    assert a["resent"] == b["resent"]
    assert a["live"] == b["live"]
    for k, v in a["lanes"].items():
        np.testing.assert_array_equal(v, b["lanes"][k], err_msg=k)
    if same_riders:
        assert a["counters"] == b["counters"]
        assert (a["transfers"], a["full_resyncs"]) == (b["transfers"], b["full_resyncs"])


@pytest.mark.parametrize("mode", ["folded", "ingest1", "ingest2"])
def test_broker_drive_with_store_equals_jax(mode):
    got = {name: run_async(broker_drive, pkg, mode) for name, pkg in PKG.items()}
    p = got["port"]
    assert_drives_equal(p, got["jax"])
    assert p["delta_launches"] == got["jax"]["delta_launches"] == 0
    # every device batch one transfer: 4 publish batches, 2 x 2 no-match
    assert p["transfers"] == 8
    c = p["counters"]
    assert c["session.sweep.device"] == 1 and c["session.sweep.host"] == 0
    assert c["session.redeliveries"] == len(p["resent"]) > 8
    assert {st for _i, _p, st, _m in p["resent"]} == {P_store.ST_PUBLISH, P_store.ST_PUBREL}
    # each (session, pid) redelivered once, the rel-phase rows with no message
    assert len({(i, pid) for i, pid, _st, _m in p["resent"]}) == len(p["resent"])
    assert all((m is None) == (st == P_store.ST_PUBREL) for _i, _p, st, m in p["resent"])
    if mode == "ingest2":  # a batch launched with a rider out takes none
        assert c["session.ack.rides"] < 8
    # the three drives deliver the same packets and redeliver the same rows
    if mode != "folded":
        assert_drives_equal(p, run_async(broker_drive, PKG["port"], "folded"),
                            same_riders=mode == "ingest1")


class Stall:
    """Wraps `DeviceRouter.route_prepared` of both packages (the class
    attribute the broker calls): sleeps `delay` s before the launch, or
    raises, while armed."""

    def __init__(self, monkeypatch):
        self.delay, self.fail, self.calls = 0.0, False, 0
        for cls in (P_router.DeviceRouter, J_router.DeviceRouter):
            real = cls.route_prepared

            @functools.wraps(real)
            def wrapped(dev, *a, _real=real, **kw):
                self.calls += 1
                if self.fail:
                    raise RuntimeError("launch failed")
                if self.delay:
                    time.sleep(self.delay)
                return _real(dev, *a, **kw)

            monkeypatch.setattr(cls, "route_prepared", wrapped)


async def pubrec_stalled(pkg, stall):
    """tests/test_session_store.py:491: a PUBREC landing while the batch
    whose rider carries the QoS2 insert is stalled keeps the rel phase."""
    b = mk_broker(pkg)
    store = attach_store(pkg, b)
    sess, sent = session_sub(pkg, b, store, qos=2)
    ing = pkg["ingest"].BatchIngest(b, max_batch=8, window_us=200)
    b.ingest = ing
    ing.start()
    futs = [await b.apublish_enqueue(m) for m in msgs(pkg, 4, qos=2)]
    await asyncio.gather(*futs)
    pid = sent[0].packet_id
    stall.delay = 0.08
    futs = [await b.apublish_enqueue(m) for m in nomatch(pkg, 4)]
    await asyncio.sleep(0.02)  # the launch taken and stalled on the pool
    mid_flight = sess.pubrec(pid)
    await asyncio.gather(*futs)
    stall.delay = 0.0
    row = store.table._find(sess.store_slot, pid)
    state = int(store.table.sess_state[row])
    futs = [await b.apublish_enqueue(m) for m in nomatch(pkg, 4)]
    await asyncio.gather(*futs)
    await ing.stop()
    mstate = int(mirror(store)["sess_state"][row])
    done, _ = sess.pubcomp(pid)
    return (mid_flight, state, mstate, msg_key(done), [pkt_key(p) for p in sent],
            counters(b))


def test_pubrec_during_stalled_launch_keeps_rel_phase_as_jax(monkeypatch):
    stall = Stall(monkeypatch)
    got = {}
    for name, pkg in PKG.items():
        got[name] = run_async(pubrec_stalled, pkg, stall)
    assert got["port"] == got["jax"]
    mid, state, mstate, done, sent, _c = got["port"]
    assert mid is True and state == mstate == P_store.ST_PUBREL
    assert done is not None and done[0] == sent[0][2]


async def failed_launch(pkg, stall):
    """A launch that raises after `take_rider`: `complete()` raises, the
    rider is aborted, and the next batch's rider re-carries its writes."""
    b = mk_broker(pkg)
    store = attach_store(pkg, b)
    sess, sent = session_sub(pkg, b, store)
    await b.adispatch_batch_folded(msgs(pkg, 8))  # the first full sync
    for p in sent[:4]:
        sess.puback(p.packet_id)
    riders = []
    take = store.take_rider

    def taking():
        r = take()
        riders.append(r)
        return r

    store.take_rider = taking
    stall.fail = True
    with pytest.raises(RuntimeError, match="launch failed"):
        await b.adispatch_batch_folded(msgs(pkg, 8))
    stall.fail = False
    out_after_abort = store._rider_out
    await b.adispatch_batch_folded(nomatch(pkg, 4))
    del store.take_rider
    r1, r2 = riders
    carried = all(set(r1.idxs[k].tolist()) <= set(r2.idxs[k].tolist()) for k in r1.idxs)
    return (out_after_abort, r1.rows, r2.rows, r2.pos == r1.pos, carried, len(sent),
            counters(b), store.manager.delta_launches, mirror(store)["sess_state"].tolist(),
            store.table.sess_state.tolist())


def test_raising_launch_aborts_the_rider_as_jax(monkeypatch):
    stall = Stall(monkeypatch)
    got = {name: run_async(failed_launch, pkg, stall) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    out, rows1, rows2, same_pos, carried, n_sent, c, delta, m_state, h_state = got["port"]
    # nothing was written meanwhile: the next rider is the aborted one's suffix
    assert out is False and rows1 == rows2 > 0 and same_pos and carried
    assert n_sent == 8  # the failed batch delivered nothing
    assert c["session.ack.rides"] == 1 and delta == 0 and m_state == h_state


# -- the store's state carried across --------------------------------------------


def test_session_state_from_reference_redelivers_as_jax():
    """A JAX store with bulk-loaded and live sessions (rel phases, incoming
    QoS2 rows, expiry deadlines, freed slab entries) captured; JAX's store
    installed from the capture and the port's from its conversion redeliver
    and expire the same rows, by host sweep and by a fused sweep."""
    mono = [0.0]
    clock = lambda: mono[0]  # noqa: E731
    src = J_store.SessionStore(capacity=256, sweep_slots=16, retry_interval=1.0, clock=clock)
    shared = J_message.Message(topic="dev/offline", payload=b"m", qos=1,
                               properties={"Content-Type": "x"})
    n = 40
    src.bulk_load([f"c{i}" for i in range(n)], [shared] * n, pids=np.arange(n) + 1)
    live = []
    for i in range(6):
        s = J_session.Session(f"live{i}", J_session.SessionConfig(), store=src)
        for k in range(3):
            s.deliver(J_message.Message(topic=f"l/{i}/{k}", payload=b"%d" % k, qos=1 + k % 2))
        s.pubrec(2)
        s.puback(1)
        s.await_rel(9)
        live.append(s)
    src.set_expiry("c3", 2.0)
    src.drop_session("c5")
    mono[0] += 1.5
    state = src.capture()
    port_state = convert.session_state_from_reference(state)
    assert port_state["table"] is not state["table"]
    assert type(port_state["table"]).__module__.startswith("emqx_tpu_torch")
    assert all(m is None or type(m) is P_message.Message for m in port_state["slab"])
    # one shared message (c5's entry freed with its session)
    assert len({id(m) for m in port_state["slab"][:n] if m is not None}) == 1
    assert port_state["slab"][5] is None and port_state["free_slots"] == [5]
    stores = {
        "port": P_store.SessionStore(capacity=64, sweep_slots=16, retry_interval=1.0,
                                     clock=clock, device="cpu"),
        "jax": J_store.SessionStore(capacity=64, sweep_slots=16, retry_interval=1.0,
                                    clock=clock),
    }
    assert stores["port"].install(port_state) == stores["jax"].install(state)
    mono[0] += 5.0
    seen = {}
    for name, st in stores.items():
        rows = []
        for slot in range(len(st._slot_cid)):
            st.bind(slot, lambda pid, s_, m, slot=slot, rows=rows:
                    rows.append((slot, pid, s_, msg_key(m))) or True)
        expired = []
        st.on_expired = expired.extend
        st.request_sweep()
        rider = st.take_rider()  # the install's full upload, then the sweep
        seen[name] = [rider.sweep_k, rider.rows]
        seen[name].append(st.host_sweep())
        seen[name] += [sorted(rows), sorted(expired)]
        st.abort(rider)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2] == n - 1 + 6 * 2 and seen["port"][4] == ["c3"]
    p, j = stores["port"].table, stores["jax"].table
    for k, v in j.device_snapshot().items():
        np.testing.assert_array_equal(p.device_snapshot()[k], v, err_msg=k)
    # fused: the same store state through both routers' session stage
    routers = [P_router.DeviceRouter(*_index_tables(P_router), device="cpu"),
               J_router.DeviceRouter(*_index_tables(J_router))]
    mono[0] += 5.0
    outs = []
    for rt, st in zip(routers, stores.values()):
        st.request_sweep()
        rd = st.take_rider()
        res = rt.route_prepared(rt.prepare(), ["a/b"], session=rd)
        outs.append((rd.rows, res.session.due_count, res.session.expired_count,
                     np.asarray(res.session.due).tolist()))
        st.commit(rd, res.session)
    assert outs[0] == outs[1] and outs[0][1] == n - 1 + 6 * 2


def _index_tables(mod):
    from emqx_tpu.ops import route_index as J_ri
    from emqx_tpu_torch.ops import route_index as P_ri

    ri = P_ri if mod is P_router else J_ri
    index, subs = ri.RouteIndex(), mod.SubscriberTable(max_subscribers=64)
    subs.add(index.add("a/#"), 3)
    return index, subs


# -- chip_smoke's broker flood at a small size ------------------------------------


async def storm(pkg, state, mono, n, k):
    b = mk_broker(pkg, min_batch=chip_smoke.SESS_MIN_BATCH)
    store = attach_store(pkg, b, capacity=64, sweep_slots=k, retry_interval=1.0,
                         clock=lambda: mono[0])
    b.subscribe("drv", "drv", "drive/#", pkg["packet"].SubOpts(), lambda m, o: None)
    sink = chip_smoke.BatchSink(pkg["slab"].serialize_pub_slab)
    assert store.install(state) == n
    for slot in range(len(store._slot_cid)):
        store.bind(slot, sink.resend)
    mono[0] += 60.0
    run = await chip_smoke.storm_drive(
        b, store, pkg["ingest"].BatchIngest(b, **chip_smoke.SESS_INGEST),
        pkg["message"].Message, sink, n, 64)
    assert_mirror_is_host(store)
    return {"sweeps": run["sweeps"], "count": sink.count, "bytes": sink.bytes,
            "pids": sorted(sink.pids), "counters": counters(b),
            "uploads": store.manager.full_resyncs, "delta": store.manager.delta_launches,
            "live_ts": sorted(store.table.sess_ts[store.table.sess_slot >= 0].tolist())}


def test_broker_flood_through_both_brokers():
    """bench.py's session_storm drive (chip_smoke.storm_drive) at 2,048
    sessions, 256-row sweeps and a 1,024-entry op-log through both
    brokers: every session redelivered once through the slab serializer,
    the same sweeps, frames, counters and full uploads, and the uploads
    `flood_plan` derives."""
    n, k = 2048, 256
    mono = [0.0]
    src = J_store.SessionStore(capacity=1 << 13, sweep_slots=k, retry_interval=1.0,
                               clock=lambda: mono[0])
    shared = J_message.Message(topic="dev/offline", payload=b"m", qos=1)
    pids = (np.arange(n) % 65535) + 1
    assert (src.bulk_load([f"c{i}" for i in range(n)], [shared] * n, pids=pids) >= 0).all()
    state = src.capture()
    states = {"port": convert.session_state_from_reference(state), "jax": state}
    for st in states.values():
        st["table"].OPLOG_MAX = 1024
    got = {}
    for name, pkg in PKG.items():
        mono[0] = 0.0
        got[name] = run_async(storm, pkg, states[name], mono, n, k, timeout=300)
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["count"] == n and g["pids"] == sorted(pids.tolist())
    assert g["delta"] == 0 and g["counters"]["session.sweep.host"] == 0
    assert g["counters"]["session.sweep.device"] == g["sweeps"]
    assert (g["sweeps"], g["uploads"]) == chip_smoke.flood_plan(n, k, 1024)[:2]
    assert g["bytes"] == n * len(P_slab.serialize_pub_slab(
        [(b"dev/offline", b"m", 1, False, True, 1, None)])[0])
    assert len(set(g["live_ts"])) == 1  # every row stamped by the flood once


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["folded", "ingest1", "ingest2"])
def test_broker_drive_on_card_equals_the_twins(cuda_device, mode):
    """The drive on the card (riders launched on the pool thread, on the
    loop's stream) equals the CPU twins', and each sweep ride launches
    `session_sweep` once and each ride with writes one scatter."""
    card = dict(PKG["port"], dev={"device": "cuda"})
    kernels.reset_launches()
    got = run_async(broker_drive, card, mode)
    launches = dict(kernels.LAUNCHES)
    want = run_async(broker_drive, PKG["port"], mode)
    assert_drives_equal(got, want)
    assert got["delta_launches"] == 0
    assert launches["session_sweep"] == got["counters"]["session.sweep.device"]
    assert launches["segment_scatter"] % P_seg.SCATTER_LAUNCHES == 0
    assert 0 < launches["segment_scatter"] <= (
        got["counters"]["session.ack.rides"] * P_seg.SCATTER_LAUNCHES)
