"""The port's broker publish path against the JAX package.

The same seeded sequence of subscribes, unsubscribes and `publish_batch`
calls drives `emqx_tpu_torch`'s `Broker` (on ``device="cpu"``: the
kernels' plain twins) and `emqx_tpu`'s `Broker`, and every message's
delivered (subscriber id) multiset must be equal, as must the return
values and the broker's delivery counters. The sequence covers plain
wildcard and exact subscriptions; `$share` groups under round_robin,
random, hash_clientid and sticky (members leaving, a group emptied and
recreated, a raising member that fails over); `no_local`; a re-subscribe
with new options; rows the device flags (too deep, too long) through the
CPU fallback; a batch below `min_tpu_batch` on the CPU branch; a raising
deliverer; and dense and `auto` subscriber tables, the latter flipping to
CSR (the flip threshold `AUTO_MIN_DENSE_BYTES` lowered in both packages
so that a test-sized table crosses it). `Router` is held against the JAX
`Router` on its own. Tolerance: EXACT equality — deliveries are sets of
names and counts are integers.
"""

import collections

import numpy as np
import pytest

from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.models import router_model as J_router
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.ops import matcher as P_matcher

PORT = (P_broker, P_brouter, P_hooks, P_message, P_packet, P_matcher, {"device": "cpu"})
JAX = (J_broker, J_brouter, J_hooks, J_message, J_packet, J_matcher, {})
MIN_TPU_BATCH = 32
COUNTERS = ("messages.delivered", "messages.received", "messages.routed.device",
            "messages.routed.device_fallback", "messages.dropped.no_subscribers",
            "delivery.errors")


class Run:
    """One package's broker and the deliveries it made: (message index,
    subscriber id) pairs in delivery order."""

    def __init__(self, mods, mode, strategy):
        B, R, H, M, S, C, dev = mods
        self.M, self.S = M, S
        cfg = C.MatcherConfig(max_bytes=64, max_levels=8, sub_table=mode)
        self.broker = B.Broker(R.Router(cfg, min_tpu_batch=MIN_TPU_BATCH, **dev), H.Hooks())
        self.broker.shared.strategy = strategy
        self.log = []
        self.counts = []

    def sink(self, sid, fails=False):
        def deliver(msg, opts):
            if fails:
                raise RuntimeError(f"{sid} refuses")
            self.log.append((int(msg.payload), sid))
        return deliver

    def sub(self, sid, filter_, client=None, fails=False, **opts):
        self.broker.subscribe(sid, client or sid, filter_, self.S.SubOpts(**opts),
                              self.sink(sid, fails))

    def publish(self, batch):
        msgs = [self.M.Message(topic=t, payload=str(k).encode(), from_client=c)
                for k, t, c in batch]
        self.counts.append(self.broker.publish_batch(msgs))

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


def scenario(run: Run, seed: int):
    rng = np.random.default_rng(seed)
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
    for i in range(10):
        for m in range(4):
            run.sub(f"g{i}_{m}", f"$share/ingest/device/{i}/#", fails=(i == 2 and m == 0))
    for i in range(5):
        for m in range(3):
            run.sub(f"a{i}_{m}", f"$share/audit/device/{i}/+/1/#")
    run.publish(topic_batch(rng, 0, 96, edge=True))
    # churn: plain unsubscribes, members leaving, a group emptied, a
    # re-subscribe with new options, fresh subscriptions on new filters
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
    run.publish(topic_batch(rng, 1000, 80, edge=True))
    run.publish(topic_batch(rng, 2000, MIN_TPU_BATCH // 2))  # the CPU branch
    run.sub("a4_0", "$share/audit/device/4/+/1/#")  # the emptied group again
    run.broker.drop_session_subs("h5", ["device/5/#"])
    run.publish(topic_batch(rng, 3000, 64))
    run.publish(topic_batch(rng, 4000, 64))


def deliveries(run: Run):
    per = collections.defaultdict(collections.Counter)
    for k, sid in run.log:
        per[k][sid] += 1
    return per


@pytest.fixture
def low_flip(monkeypatch):
    """Lower the `auto` flip threshold in both packages: a test-sized
    dense table then crosses it, as a million subscriptions do."""
    for mod in (P_router, J_router):
        monkeypatch.setattr(mod.SubscriberTable, "AUTO_MIN_DENSE_BYTES", 1 << 14)


@pytest.mark.parametrize("mode,strategy", [
    ("dense", "round_robin"), ("auto", "round_robin"), ("dense", "random"),
    ("auto", "hash_clientid"), ("dense", "sticky"),
])
def test_broker_deliveries_match_jax(low_flip, mode, strategy):
    port, jax_ = Run(PORT, mode, strategy), Run(JAX, mode, strategy)
    for run in (port, jax_):
        scenario(run, seed=len(strategy))
    assert port.broker.subtab.sparse == jax_.broker.subtab.sparse == (mode == "auto")
    assert port.counts == jax_.counts
    got, want = deliveries(port), deliveries(jax_)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    assert port.counters() == jax_.counters()
    c = port.counters()
    assert c["messages.routed.device_fallback"] >= 4 and c["delivery.errors"] > 0
    assert c["messages.routed.device"] > 0
    # no_local: c3's own publish (message 0) skipped it, the re-subscribe
    # (no_local off) made message 1000 reach it
    assert "c3" not in got[0] and got[1000]["c3"] == 1
    # every matched group delivered to exactly one member a message
    groups = [s for k in want for s in want[k] if s.startswith(("g", "a"))]
    assert len(groups) > 50
    for k in want:
        topic_id = [s for s in want[k] if s.startswith("g")]
        assert len(topic_id) <= 1, (k, topic_id)
    assert port.broker.subscription_count() == jax_.broker.subscription_count()
    assert sorted(port.broker.subscriptions(), key=repr) == sorted(
        [(c_, f, P_packet.SubOpts(**vars(o))) for c_, f, o in jax_.broker.subscriptions()],
        key=repr)


def test_publish_single_message_matches_jax():
    outs = []
    for mods in (PORT, JAX):
        run = Run(mods, "dense", "round_robin")
        run.sub("p", "a/+/c")
        run.sub("q", "$share/g/a/#")
        run.sub("r", "$share/g/a/#")
        n = [run.broker.publish(run.M.Message(topic="a/b/c", payload=str(k).encode()))
             for k in range(3)]
        outs.append((n, run.log, run.broker.dispatch(["a/+/c"], run.M.Message(
            topic="a/b/c", payload=b"9")), run.counters()))
    assert outs[0] == outs[1]


def router_pair():
    filters = [f"device/{i}/+/{j}/#" for i in range(12) for j in range(6)]
    filters += ["a/b/c", "a/b/c", "a/+/c", "#", "+/x", "$SYS/#", "device/1/#"]
    cfg = dict(max_bytes=64, max_levels=8)
    pr = P_brouter.Router(P_matcher.MatcherConfig(**cfg), min_tpu_batch=16, device="cpu")
    jr = J_brouter.Router(J_matcher.MatcherConfig(**cfg), min_tpu_batch=16)
    for r in (pr, jr):
        for f in filters:
            r.add_route(f)
        r.delete_route("a/b/c")
        r.delete_route("device/1/#")
    return pr, jr


def test_router_matches_jax_router():
    pr, jr = router_pair()
    rng = np.random.default_rng(2)
    topics = [f"device/{i}/m/{j}/x" for i, j in zip(rng.integers(0, 14, 40),
                                                   rng.integers(0, 8, 40))]
    topics += ["a/b/c", "q/x", "$SYS/x", "", "device/1/a/2/b/c/d/e/f/g", "d/" + "y" * 80]
    assert pr.match_batch(topics) == jr.match_batch(topics)  # the device branch
    assert pr.match_batch(topics[:8]) == jr.match_batch(topics[:8])  # the CPU branch
    for t in topics:
        assert pr.match(t) == jr.match(t)
    assert len(pr) == len(jr) and sorted(pr.topics()) == sorted(jr.topics())
    assert pr.has_route("a/b/c") and not pr.has_route("device/1/#")
    assert pr.filter_id("a/+/c") == jr.filter_id("a/+/c")
    assert pr.matcher.subtab is None
