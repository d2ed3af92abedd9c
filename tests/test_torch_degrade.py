"""The port's fault sites and degrade ladder against the JAX package.

`emqx_tpu_torch.observe.faults`, `broker.degrade` (`Breaker`,
`DegradeController`), the broker's ladder (`Broker.dispatch_batch_folded`
and `adispatch_begin` with a controller attached), the `ingest.enqueue`
site and shed gate, and `DeviceRouter.prepare`'s epoch rollback, each
driven exactly as tests/test_degrade.py and tests/test_slo.py drive the
reference, with the same rules armed in both packages' `default_faults`
(disarmed again after every test). The port runs on ``device="cpu"`` (the
kernels' plain twins); JAX on its CPU backend.

Held equal between the packages: the injector's fire pattern and
counters, the breakers' state sequences and gauges, the retry delays of
one seed, a snapshot restored across in both directions, and for every
broker drive the per-message delivery counts, the delivered (subscriber,
topic) pairs and the `degrade.*` / `faults.*` / `router.sync.*` /
`messages.routed.device` counters. Port-only checks: a kernel build error
escapes a broker that has a controller, a `Prepared` held across a
rolled-back sync keeps its tensors, the mirrors after a rollback equal the
host tables, and the refusal of a feed or a controller on a multi-rank
mesh. Tolerance: EXACT equality (names, counts, states).
"""

import asyncio
import functools
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import degrade as J_degrade
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import ingest as J_ingest
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import metrics as J_metrics
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.broker import slo as J_slo
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.observe import faults as J_faults
from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import degrade as P_degrade
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import ingest as P_ingest
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import metrics as P_metrics
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.broker import slo as P_slo
from emqx_tpu_torch.kernels import build as P_build
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.observe import faults as P_faults
from emqx_tpu_torch.ops import matcher as P_matcher

PKG = {
    "port": dict(broker=P_broker, degrade=P_degrade, hooks=P_hooks, ingest=P_ingest,
                 message=P_message, metrics=P_metrics, router=P_brouter, slo=P_slo,
                 packet=P_packet, faults=P_faults, matcher=P_matcher,
                 dev={"device": "cpu"}),
    "jax": dict(broker=J_broker, degrade=J_degrade, hooks=J_hooks, ingest=J_ingest,
                message=J_message, metrics=J_metrics, router=J_brouter, slo=J_slo,
                packet=J_packet, faults=J_faults, matcher=J_matcher, dev={}),
}
BOTH = ("port", "jax")
TOPICS = [f"t/{i % 8}/leaf" for i in range(16)]
SERIES = ("degrade.retries", "degrade.fallback.batches", "degrade.trips.device",
          "degrade.probe.ok", "degrade.probe.fail", "faults.injected",
          "messages.routed.device", "router.sync.rollback", "router.prepare.dirty",
          "router.sync.skipped", "ingest.shed", "ingest.dispatch.errors")


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Both packages' injectors are process-global: no rule outlives its
    test, and no metrics sink either."""
    for name in BOTH:
        PKG[name]["faults"].default_faults.disarm()
    yield
    for name in BOTH:
        inj = PKG[name]["faults"].default_faults
        inj.disarm()
        inj.metrics = None


def run_async(fn, *a, timeout=60):
    return asyncio.run(asyncio.wait_for(fn(*a), timeout=timeout))


def both(fn, *a):
    """`fn(pkg, *a)` for the port, then for JAX -> the two results."""
    return [fn(PKG[name], *a) for name in BOTH]


def series(metrics) -> dict:
    return {k: metrics.get(k) for k in SERIES}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def serving_broker(pkg, deg=None, min_batch=4):
    """tests/test_degrade.py:205: 8 plain `t/{i}/#` subscribers and 8 on
    `t/+/leaf`, each recording (subscriber, topic)."""
    b = pkg["broker"].Broker(
        router=pkg["router"].Router(pkg["matcher"].MatcherConfig(), min_tpu_batch=min_batch,
                                    **pkg["dev"]),
        hooks=pkg["hooks"].Hooks())
    b.degrade = deg
    delivered = []
    for i in range(8):
        def mk(sid):
            return lambda m, o: delivered.append((sid, m.topic))
        b.subscribe(f"s{i}", f"c{i}", f"t/{i}/#", pkg["packet"].SubOpts(), mk(f"s{i}"))
        b.subscribe(f"w{i}", f"cw{i}", "t/+/leaf", pkg["packet"].SubOpts(), mk(f"w{i}"))
    return b, delivered


def wire(pkg, b, deg):
    """The controller's, its breaker's and the injector's metrics are the
    broker's (as tests/test_degrade.py wires them)."""
    deg.metrics = b.metrics
    deg.device.metrics = b.metrics
    pkg["faults"].default_faults.metrics = b.metrics


# -- fault injector ------------------------------------------------------------


def test_sites_and_modes_equal_jax():
    assert P_faults.SITES == J_faults.SITES and P_faults.MODES == J_faults.MODES


@pytest.mark.parametrize("name", BOTH)
def test_injector_validates_site_and_mode(name):
    inj = PKG[name]["faults"].FaultInjector()
    for kw in ({"site": "not.a.site"}, {"site": "device.launch", "mode": "explode"},
               {"site": "device.launch", "probability": 1.5}):
        with pytest.raises(ValueError):
            inj.arm(**kw)


def injector_script(pkg):
    """tests/test_degrade.py:78, plus a seeded probability rule: -> every
    call's outcome, the rules and the counters."""
    F = pkg["faults"]
    m = pkg["metrics"].Metrics()
    inj = F.FaultInjector(metrics=m, seed=3)
    out = [inj.hit("device.launch")]
    inj.arm("device.launch", mode="raise", nth=2, max_fires=1)
    for _ in range(4):
        try:
            out.append(inj.hit("device.launch"))
        except F.FaultError as e:
            out.append(("raised", e.site, isinstance(e, RuntimeError)))
    inj.arm("cluster.forward", mode="drop")
    out.append(inj.hit("cluster.forward"))
    inj.arm("router.delta_sync", mode="corrupt")
    out.append(inj.hit("router.delta_sync"))
    inj.arm("retained.storm", mode="drop", probability=0.5)
    out.append([inj.hit("retained.storm") for _ in range(32)])
    inj.arm("device.readback", mode="delay", delay_ms=1.0)
    out.append(inj.hit("device.readback"))
    snap = inj.snapshot()
    inj.disarm("cluster.forward")
    out.append(inj.hit("cluster.forward"))
    rules = inj.rules()
    inj.disarm()
    return out, snap, rules, inj.armed, m.get("faults.injected")


def test_injector_triggers_equal_jax():
    p, j = both(injector_script)
    assert p == j
    out, snap, _rules, armed, injected = p
    assert out[2][0] == "raised" and out[1] is None and out[3] is None
    assert snap["enabled"] and len(snap["rules"]) == 5 and not armed
    assert 0 < out[7].count("drop") < 32 and injected == snap["injected"]


# -- the breaker and the controller -----------------------------------------------


def breaker_ladder(pkg):
    """tests/test_degrade.py:115-183 in one script: the ladder, a failed
    probe restarting the dwell, a success resetting the failure streak."""
    D = pkg["degrade"]
    clk = FakeClock()
    m = pkg["metrics"].Metrics()
    br = D.Breaker("device", state_series="degrade.state.device",
                   trips_series="degrade.trips.device", metrics=m,
                   failure_threshold=2, open_secs=5.0, clock=clk)
    seen = [(br.state, br.allow())]
    br.record_failure()
    seen.append(br.state)
    br.record_failure()
    seen += [br.state, br.trips, m.gauge("degrade.state.device"),
             m.get("degrade.trips.device"), br.allow()]
    clk.advance(5.1)
    seen += [br.state, br.allow(), br.allow()]
    br.record_success()
    seen += [br.state, m.get("degrade.probe.ok"), m.gauge("degrade.state.device")]
    br2 = D.Breaker("device", metrics=m, open_secs=3.0, clock=clk)
    br2.record_failure()
    clk.advance(3.1)
    seen.append(br2.allow())
    br2.record_failure()
    seen += [br2.state, m.get("degrade.probe.fail"), br2.allow()]
    clk.advance(3.1)
    seen.append(br2.allow())
    br2.record_success()
    seen += [br2.state, br2.to_json()]
    br3 = D.Breaker("device", failure_threshold=2)
    br3.record_failure()
    br3.record_success()
    br3.record_failure()
    seen.append(br3.state)
    return seen, D.STATE_CODE, (D.CLOSED, D.HALF_OPEN, D.OPEN)


def test_breaker_ladder_equals_jax():
    p, j = both(breaker_ladder)
    assert p == j
    seen = p[0]
    assert seen[:3] == [("closed", True), "closed", "open"]
    assert seen[-1] == "closed"


def controller_snapshot(pkg, restore_from=None):
    """tests/test_degrade.py:185: snapshot, restore, half-open as
    probe-immediately; the retry delays of seed 7. `restore_from`: a
    snapshot of the OTHER package to restore instead of this one's."""
    D = pkg["degrade"]
    clk = FakeClock()
    m = pkg["metrics"].Metrics()
    deg = D.DegradeController(metrics=m, clock=clk, open_secs=7.0, seed=7)
    deg.device.record_failure()
    deg.cluster_breaker("n2").record_failure()
    snap = deg.snapshot()
    deg2 = D.DegradeController(clock=clk, open_secs=7.0)
    deg2.restore(restore_from if restore_from is not None else snap)
    seen = [deg2.device.state, deg2.device.allow(), deg2.cluster_breaker("n2").state,
            deg2.device.trips]
    clk.advance(7.1)
    seen.append(deg2.device.allow())
    deg3 = D.DegradeController(clock=clk)
    deg3.restore({"device": {"state": D.HALF_OPEN}})
    seen.append(deg3.device.allow())
    delays = list(deg.retry_delays())
    return snap, seen, delays, m.get("degrade.retries"), deg.to_json() == deg.snapshot()


def test_controller_snapshot_restore_and_retry_delays_equal_jax():
    p, j = both(controller_snapshot)
    assert p == j
    snap, seen, delays, retries, same = p
    assert snap["device"]["state"] == "open" and seen[:3] == ["open", False, "open"]
    assert len(delays) == retries == 2 and same
    # each package restores the other's snapshot into the same states
    cross_p = controller_snapshot(PKG["port"], restore_from=j[0])
    cross_j = controller_snapshot(PKG["jax"], restore_from=p[0])
    assert cross_p[1] == cross_j[1] == seen


# -- the pipelined ladder: failures -> retries -> CPU -> probe recovery ------------


async def ingest_batch(pkg, b, topics=TOPICS, enqueue=True):
    ing = pkg["ingest"].BatchIngest(b, max_batch=64, window_us=200)
    b.ingest = ing
    ing.start()
    M = pkg["message"].Message
    if enqueue:
        counts = await asyncio.gather(*[ing.enqueue(M(topic=t, payload=b"p")) for t in topics])
    else:
        futs = [await b.apublish_enqueue(M(topic=t, payload=b"p", from_client="pub"))
                for t in topics]
        counts = await asyncio.gather(*futs)
    await ing.stop()
    b.ingest = None
    return list(counts)


async def pipelined_ladder(pkg):
    """tests/test_degrade.py:224: a healthy pass, then every launch raising
    (1 launch + 2 retries, the trip, the CPU batch), a batch while open (no
    device attempt), then the fault disarmed and the dwell out: the probe
    closes the breaker."""
    b0, got0 = serving_broker(pkg)
    counts0 = await ingest_batch(pkg, b0)
    assert b0.metrics.get("messages.routed.device") == len(TOPICS)
    deg = pkg["degrade"].DegradeController(max_retries=2, backoff_base_s=0.001,
                                           open_secs=0.2)
    b1, got1 = serving_broker(pkg, deg=deg)
    wire(pkg, b1, deg)
    pkg["faults"].default_faults.arm("device.launch", mode="raise")
    counts1 = await ingest_batch(pkg, b1, enqueue=False)
    out = {"degraded": (counts1, sorted(got1), series(b1.metrics), deg.device.trips)}
    assert sorted(got0) == sorted(got1) and counts0 == counts1
    got1.clear()
    more = await ingest_batch(pkg, b1)
    out["open"] = (more, sorted(got1), series(b1.metrics), deg.device.state)
    pkg["faults"].default_faults.disarm()
    await asyncio.sleep(0.25)
    again = await ingest_batch(pkg, b1)
    out["probe"] = (again, series(b1.metrics), deg.device.state, deg.snapshot()["device"])
    out["healthy"] = (counts0, sorted(got0))
    return out


def test_launch_failures_degrade_with_identical_deliveries_as_jax():
    p, j = both(lambda pkg: run_async(pipelined_ladder, pkg))
    for k in ("degraded", "open", "healthy"):
        assert p[k] == j[k], k
    assert p["probe"][:3] == j["probe"][:3]
    counts1, _got, s, trips = p["degraded"]
    assert (s["degrade.retries"], s["faults.injected"], trips) == (2, 3, 1)
    assert s["degrade.fallback.batches"] >= 1 and s["messages.routed.device"] == 0
    assert p["open"][2]["faults.injected"] == 3 and p["open"][0] == p["healthy"][0]
    again, s, state, _dev = p["probe"]
    assert state == "closed" and s["degrade.probe.ok"] == 1
    assert s["messages.routed.device"] == len(TOPICS) and again == p["healthy"][0]


def sync_ladder(pkg):
    """tests/test_degrade.py:306: the synchronous gate, `device.readback`."""
    deg = pkg["degrade"].DegradeController(open_secs=0.05)
    b, got = serving_broker(pkg, deg=deg)
    wire(pkg, b, deg)
    M = pkg["message"].Message
    msgs = [M(topic=t, payload=b"p") for t in TOPICS]
    base = b.dispatch_batch_folded(list(msgs))
    seen = [deg.device.state, sorted(got)]
    pkg["faults"].default_faults.arm("device.readback", mode="raise")
    got.clear()
    out = b.dispatch_batch_folded(list(msgs))
    seen += [out == base, deg.device.state, series(b.metrics), sorted(got)]
    pkg["faults"].default_faults.disarm()
    seen += [b.dispatch_batch_folded(list(msgs)) == base, series(b.metrics)]
    time.sleep(0.06)
    seen += [b.dispatch_batch_folded(list(msgs)) == base, deg.device.state,
             series(b.metrics)]
    return base, seen


def test_sync_dispatch_degrades_and_recovers_as_jax():
    p, j = both(sync_ladder)
    assert p == j
    _base, seen = p
    assert seen[2:4] == [True, "open"] and seen[4]["degrade.fallback.batches"] == 1
    assert seen[1] == seen[5]  # the CPU batch delivered what the device batch did
    assert seen[7]["degrade.fallback.batches"] == 2 and seen[-2] == "closed"


async def no_controller(pkg):
    """tests/test_degrade.py:340: no controller -> a failed launch fails
    its batch's publishes; and the synchronous path raises."""
    F = pkg["faults"]
    b, _ = serving_broker(pkg, deg=None)
    ing = pkg["ingest"].BatchIngest(b, max_batch=64, window_us=200)
    b.ingest = ing
    ing.start()
    M = pkg["message"].Message
    await ing.submit(M(topic="t/0/leaf", payload=b"w"))  # warm
    F.default_faults.arm("device.launch", mode="raise")
    res = await asyncio.gather(*[ing.enqueue(M(topic=t, payload=b"p")) for t in TOPICS],
                               return_exceptions=True)
    await ing.stop()
    with pytest.raises(F.FaultError):
        b.dispatch_batch_folded([M(topic=t, payload=b"p") for t in TOPICS])
    return [type(r).__name__ for r in res], b.metrics.get("ingest.dispatch.errors") >= 1


def test_without_controller_launch_failures_still_raise_as_jax():
    p, j = both(lambda pkg: run_async(no_controller, pkg))
    assert p == j and p[1] and set(p[0]) == {"FaultError"}


# -- delta-sync rollback ---------------------------------------------------------


def rollback(pkg):
    """tests/test_degrade.py:363: a failed sync serves the last good epoch,
    the new subscription appears once the sync heals; `corrupt` rolls back
    the same way."""
    F = pkg["faults"]
    b, got = serving_broker(pkg)
    M = pkg["message"].Message
    msgs = [M(topic=t, payload=b"p") for t in TOPICS]
    base = b.dispatch_batch_folded(list(msgs))
    dev = b._device_router()
    seen = [series(b.metrics)]
    hits = []
    b.subscribe("late", "cl", "t/0/#", pkg["packet"].SubOpts(),
                lambda m, o: hits.append(m.topic))
    F.default_faults.arm("router.delta_sync", mode="raise")
    got.clear()
    out = b.dispatch_batch_folded(list(msgs))
    seen += [out == base, list(hits), series(b.metrics)]
    F.default_faults.disarm()
    out = b.dispatch_batch_folded(list(msgs))
    seen += [series(b.metrics), sorted(hits), out[0] == base[0] + 1]
    b.subscribe("late2", "cl2", "t/1/#", pkg["packet"].SubOpts(), lambda m, o: None)
    F.default_faults.arm("router.delta_sync", mode="corrupt")
    out2 = b.dispatch_batch_folded(list(msgs))
    seen += [out2 == out, series(b.metrics)]
    F.default_faults.disarm()
    prep = dev.prepare()
    seen += [prep is dev.prepare(), b.dispatch_batch_folded(list(msgs)), series(b.metrics)]
    return base, seen


def test_delta_sync_rollback_equals_jax():
    p, j = both(rollback)
    assert p == j
    _base, seen = p
    assert seen[1:3] == [True, []] and seen[3]["router.sync.rollback"] == 1
    assert seen[4]["router.prepare.dirty"] == 2 and seen[5] and seen[6]
    assert seen[7] and seen[8]["router.sync.rollback"] == 2 and seen[9]


async def no_good_epoch(pkg):
    """tests/test_degrade.py:402: a failed sync with no good epoch serves
    the batch from the CPU and opens the breaker."""
    deg = pkg["degrade"].DegradeController(max_retries=0, open_secs=60.0)
    b, got = serving_broker(pkg, deg=deg)
    wire(pkg, b, deg)
    pkg["faults"].default_faults.arm("router.delta_sync", mode="raise")
    counts = await ingest_batch(pkg, b)
    return counts, sorted(got), deg.device.state, series(b.metrics)


def test_failed_sync_with_no_good_epoch_degrades_to_cpu_as_jax():
    p, j = both(lambda pkg: run_async(no_good_epoch, pkg))
    assert p == j
    counts, _got, state, s = p
    assert all(c > 0 for c in counts) and state == "open"
    assert s["degrade.fallback.batches"] >= 1 and s["router.sync.rollback"] == 0


def test_rollback_keeps_a_held_prepared_and_a_whole_mirror():
    """Port only: a `Prepared` held across a rolled-back (`corrupt`) sync
    keeps its tensors, the rollback returns it unchanged, and the healed
    sync's mirrors equal the host tables (no op-log write lost)."""
    b, _ = serving_broker(PKG["port"])
    dev = b._device_router()
    held = dev.prepare()
    before = {k: v.clone() for k, v in held.tables.items()}
    for i in range(40):  # enough writes to scatter into every table array
        b.subscribe(f"n{i}", f"cn{i}", f"t/{i}/x/#", P_packet.SubOpts(), lambda m, o: None)
    b.unsubscribe("s3", "t/3/#")
    P_faults.default_faults.arm("router.delta_sync", mode="corrupt")
    assert dev.prepare() is held
    P_faults.default_faults.disarm()
    for k, v in held.tables.items():
        assert torch.equal(v, before[k]), k
    fresh = dev.prepare()
    assert fresh is not held and dev.prepare() is fresh
    for man, src in ((dev._shape_sync, b.router.index.shapes), (dev._bits_sync, b.subtab)):
        snap = src.device_snapshot()
        mirror = man.sync(src)
        for k, arr in snap.items():
            np.testing.assert_array_equal(
                mirror[k].numpy().view(arr.dtype).reshape(arr.shape), arr, err_msg=k)
    for k, v in held.tables.items():
        assert torch.equal(v, before[k]), k


# -- the ingest gate -------------------------------------------------------------


async def shed_open(pkg):
    """tests/test_degrade.py:420: an open breaker sheds past the bound."""
    deg = pkg["degrade"].DegradeController(shed_queue_batches=1)
    b, _ = serving_broker(pkg, deg=deg)
    deg.device.force(pkg["degrade"].OPEN, 60.0)
    ing = pkg["ingest"].BatchIngest(b, max_batch=4, olp=None)
    b.ingest = ing  # not started: the backlog stays put
    M = pkg["message"].Message
    for i in range(4):
        ing.enqueue(M(topic=f"t/{i}/leaf", payload=b"p"))
    fut = ing.enqueue(M(topic="t/5/leaf", payload=b"p"))
    with pytest.raises(pkg["degrade"].IngestShed):
        await fut
    return b.metrics.get("ingest.shed"), len(ing._pending)


async def shed_olp_and_drop(pkg):
    """tests/test_degrade.py:436: olp overload sheds; the `ingest.enqueue`
    drop fault sheds unconditionally; its raise fails the caller."""

    class FakeOlp:
        overloaded = True

        def is_overloaded(self):
            return self.overloaded

    deg = pkg["degrade"].DegradeController(shed_queue_batches=1)
    b, _ = serving_broker(pkg, deg=deg)
    olp = FakeOlp()
    ing = pkg["ingest"].BatchIngest(b, max_batch=2, olp=olp)
    M = pkg["message"].Message
    ing.enqueue(M(topic="t/0/leaf", payload=b"p"))
    ing.enqueue(M(topic="t/1/leaf", payload=b"p"))
    with pytest.raises(pkg["degrade"].IngestShed):
        await ing.enqueue(M(topic="t/2/leaf", payload=b"p"))
    olp.overloaded = False
    f = ing.enqueue(M(topic="t/3/leaf", payload=b"p"))
    queued = not f.done()
    pkg["faults"].default_faults.arm("ingest.enqueue", mode="drop")
    with pytest.raises(pkg["degrade"].IngestShed):
        await ing.enqueue(M(topic="t/4/leaf", payload=b"p"))
    pkg["faults"].default_faults.arm("ingest.enqueue", mode="raise")
    with pytest.raises(pkg["faults"].FaultError):
        ing.enqueue(M(topic="t/5/leaf", payload=b"p"))
    return queued, b.metrics.get("ingest.shed"), len(ing._pending)


def test_ingest_shed_gates_equal_jax():
    p, j = both(lambda pkg: run_async(shed_open, pkg))
    assert p == j == (1, 4)
    p, j = both(lambda pkg: run_async(shed_olp_and_drop, pkg))
    assert p == j == (True, 2, 3)


# -- the SLO ladder reads the breaker (tests/test_slo.py:162, :369) ---------------


def slo_ctl(pkg, metrics=None, **kw):
    """tests/test_slo.py:47's `_mk_ctl`."""
    cfg = dict(target_p99_ms=5.0, eval_interval_s=1.0, min_samples=4, ladder_patience=2,
               initial_window_us=1000, max_window_us=20_000)
    cfg.update(kw)
    return pkg["slo"].SloController(
        metrics if metrics is not None else pkg["metrics"].Metrics(), **cfg)


def breaker_widens(pkg):
    S = pkg["slo"]
    ctl = slo_ctl(pkg)
    w0 = ctl.window_s
    ctl.tick(backlog=0, breaker_open=True, now=0.0)
    return ctl.rung == S.RUNG_WIDEN, ctl.window_s > w0, \
        ctl.shed(S.LANE_LOW, backlog=10_000, bound=4096)


async def breaker_widens_flusher(pkg):
    m = pkg["metrics"].Metrics()
    ctl = slo_ctl(pkg, m, eval_interval_s=0.005, initial_window_us=200)
    b, _ = serving_broker(pkg)
    b.metrics = m
    b.degrade = pkg["degrade"].DegradeController(metrics=m)
    b.degrade.device.force(pkg["degrade"].OPEN, 60.0)
    ing = pkg["ingest"].BatchIngest(b, max_batch=64, window_us=200, slo=ctl)
    b.ingest = ing
    ing.start()
    await ing.enqueue(pkg["message"].Message(topic="t/a", qos=1))
    await asyncio.sleep(0.02)
    await ing.stop()
    return ctl.rung >= pkg["slo"].RUNG_WIDEN, ctl.window_s > 200e-6


def test_open_breaker_widens_the_slo_window_as_jax():
    p, j = both(breaker_widens)
    assert p == j == (True, True, False)
    p, j = both(lambda pkg: run_async(breaker_widens_flusher, pkg))
    assert p == j == (True, True)


# -- port only: build errors, the mesh refusal -------------------------------------


def test_kernel_build_error_escapes_a_broker_with_a_controller(monkeypatch):
    """A kernel library that fails to build is not a device fault: neither
    path of a broker with a controller serves the batch from the CPU. The
    launch here fails as a card's first launch does without nvcc."""

    def failing_build(self, *a, **k):
        raise P_build.KernelBuildError("nvcc failed: stand-in")

    deg = P_degrade.DegradeController(max_retries=1, backoff_base_s=0.001)
    b, got = serving_broker(PKG["port"], deg=deg)
    monkeypatch.setattr(P_router.DeviceRouter, "route_prepared", failing_build)
    msgs = [P_message.Message(topic=t, payload=b"p") for t in TOPICS]
    with pytest.raises(P_build.KernelBuildError):
        b.dispatch_batch_folded(msgs)

    async def pipelined():
        pd = b.adispatch_begin(msgs)
        with pytest.raises(P_build.KernelBuildError):
            await pd.complete()

    run_async(pipelined)
    assert not got and deg.device.state == "closed"
    assert b.metrics.get("degrade.fallback.batches") == 0
    # a failed build inside a sync is no table fault either: no rollback
    monkeypatch.undo()
    b.dispatch_batch_folded(msgs)
    b.subscribe("x", "cx", "t/9/#", P_packet.SubOpts(), lambda m, o: None)
    dev = b._device_router()
    monkeypatch.setattr(dev, "_sync_dirty", lambda *a: failing_build(None))
    with pytest.raises(P_build.KernelBuildError):
        dev.prepare()
    assert b.metrics.get("router.sync.rollback") == 0
    # and a checkout without nvcc raises the same class from the build
    monkeypatch.setattr(P_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(P_build.KernelBuildError):
        P_build.nvcc_path()


class FakeMesh:
    def __init__(self, world):
        self.world = world


def test_feed_and_controller_refused_on_a_multirank_mesh():
    from emqx_tpu_torch.broker.retained_feed import RetainedStormFeed

    feed = RetainedStormFeed(object())
    for attach in ("degrade", "retained_feed"):
        value = feed if attach == "retained_feed" else P_degrade.DegradeController()
        b = P_broker.Broker(P_brouter.Router(device="cpu"), P_hooks.Hooks())
        b.mesh = FakeMesh(4)
        with pytest.raises(NotImplementedError, match="4-rank mesh"):
            setattr(b, attach, value)
        assert getattr(b, attach) is None
        setattr(b, attach, None)  # detaching is always allowed
        # attached first, then the mesh: refused too
        b2 = P_broker.Broker(P_brouter.Router(device="cpu"), P_hooks.Hooks())
        setattr(b2, attach, value)
        with pytest.raises(NotImplementedError):
            b2.mesh = FakeMesh(2)
        assert b2.mesh is None
        # a one-rank mesh runs as one device
        b2.mesh = FakeMesh(1)
        assert getattr(b2, attach) is value
