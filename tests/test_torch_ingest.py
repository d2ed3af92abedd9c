"""The port's pipelined publish path against the JAX package.

`emqx_tpu_torch.broker.ingest.BatchIngest` with the port's `Broker.apublish`
/ `adispatch_begin` (on ``device="cpu"``: the kernels' plain twins) and
`emqx_tpu`'s, driven the same way on the CPU:

- scripted brokers (a `PendingDispatch` whose device round trip takes a
  scripted delay): the launch, device-done, fan-out and settle orders of
  the pipeline at depth 2 equal JAX's, and settlement stays FIFO; the
  same for a small CPU batch behind a slow device batch, and for a
  partial batch launched the moment the device goes idle; the
  enqueue/launch race leaves no stray waiter and `stop()` still returns;
- lane order and the anti-starvation reserve of `_take_batch`, the
  `SloController`'s windows and rungs through the same readings;
- `stop()` draining pending work, a QoS1 `apublish` resolving to its
  delivery count;
- a real-broker drive: 2,000 seeded publishes over plain, wildcard and
  round-robin `$share` subscriptions from concurrent `apublish` tasks, at
  pipeline 1 and 2 on a pinned schedule (every batch full, so batch N+1
  launches before batch N settles and batch N+2 after it, in both
  packages: the `ingest.launch` / `ingest.settle` tracepoints are
  compared), whose delivered (message, subscriber) pairs equal JAX's; at
  pipeline 1 they also equal the synchronous `publish_batch` path's;
- `DeviceRouter.prepare()` on a delta (the pipeline's loop-thread half)
  reads nothing back from the device, and the launch counts stay exact
  when threads launch at once.

The `cuda` tests (skipped without a card) run the drive on the card
against the twins, and hold `prepare()` to no stream synchronisation
(`torch.cuda.set_sync_debug_mode`, and a spin kernel still running when
it returns). Tolerance: EXACT equality — deliveries are names and counts.
"""

import asyncio
import collections
import functools
import threading
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import ingest as J_ingest
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import metrics as J_metrics
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.broker import slo as J_slo
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu.utils import tracepoints as J_tp
from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import ingest as P_ingest
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import metrics as P_metrics
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.broker import slo as P_slo
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.ops import matcher as P_matcher
from emqx_tpu_torch.utils import tracepoints as P_tp

PKG = {
    "port": dict(broker=P_broker, ingest=P_ingest, message=P_message, hooks=P_hooks,
                 router=P_brouter, packet=P_packet, matcher=P_matcher, slo=P_slo,
                 metrics=P_metrics, tp=P_tp, dev={"device": "cpu"}),
    "jax": dict(broker=J_broker, ingest=J_ingest, message=J_message, hooks=J_hooks,
                router=J_brouter, packet=J_packet, matcher=J_matcher, slo=J_slo,
                metrics=J_metrics, tp=J_tp, dev={}),
}
MIN_TPU_BATCH = 32


def run_async(fn, *a, timeout=60):
    return asyncio.run(asyncio.wait_for(fn(*a), timeout=timeout))


# -- scripted brokers: the pipeline's schedule ---------------------------------


class ScriptedBroker:
    """Scripted `adispatch_begin` (tests/test_ingest.py's stub): batches of
    at least `device_at` messages behave as device dispatches, whose
    `ready` resolves after the batch's scripted delay; smaller ones are
    CPU batches, `ready` already done and the dispatch deferred to
    `complete()`. Every step lands in `events`."""

    class router:
        min_tpu_batch = 1
        enable_tpu = True

    def __init__(self, pkg, events, delays=(), device_at=4):
        self.pending_cls = pkg["broker"].PendingDispatch
        self.events = events
        self.delays = list(delays)
        self.device_at = device_at
        self.n = 0

    def adispatch_begin(self, msgs, forward=True, batch_span=None):
        i = self.n
        self.n += 1
        loop = asyncio.get_running_loop()
        is_dev = len(msgs) >= self.device_at
        self.events.append(("launch", i, len(msgs), is_dev))
        ready = loop.create_future()
        if is_dev:
            delay = self.delays[i] if i < len(self.delays) else 0.0
            loop.call_later(delay, lambda: (self.events.append(("device_done", i)),
                                            ready.done() or ready.set_result(None)))
        else:
            ready.set_result(None)

        async def complete():
            await ready
            self.events.append(("fanout", i))
            return [1] * len(msgs)

        return self.pending_cls(ready, complete)


async def fifo_schedule(pkg):
    """tests/test_ingest.py:244: batch 0 slow, batch 1 instant, depth 2."""
    events = []
    b = ScriptedBroker(pkg, events, delays=[0.2, 0.0], device_at=4)
    ing = pkg["ingest"].BatchIngest(b, max_batch=4, window_us=0, pipeline=2)
    ing.start()
    futs = []
    for k in range(8):  # two full batches
        f = ing.enqueue(pkg["message"].Message(topic=f"p/{k}"))
        f.add_done_callback(lambda _f, _i=k // 4: events.append(("settle", _i)))
        futs.append(f)
        if k == 3:
            await asyncio.sleep(0.05)  # let batch 0 launch first
    counts = await asyncio.gather(*futs)
    await ing.stop()
    return counts, events


async def cpu_behind_device(pkg):
    """A 1-message CPU batch launched while a slow device batch is in
    flight fans out after it (tests/test_ingest.py:330)."""
    events = []
    b = ScriptedBroker(pkg, events, delays=[0.2], device_at=4)
    ing = pkg["ingest"].BatchIngest(b, max_batch=4, window_us=0, pipeline=2)
    ing.start()
    futs = [ing.enqueue(pkg["message"].Message(topic=f"p/{k}")) for k in range(4)]
    await asyncio.sleep(0.05)
    futs.append(ing.enqueue(pkg["message"].Message(topic="p/0")))
    counts = await asyncio.gather(*futs)
    await ing.stop()
    return counts, events


async def idle_partial(pkg):
    """A partial backlog waits while a full batch is on the device, and
    launches the moment its device work is done, before its fan-out
    (tests/test_ingest.py:365)."""
    events = []
    b = ScriptedBroker(pkg, events, delays=[0.1, 0.0], device_at=2)
    ing = pkg["ingest"].BatchIngest(b, max_batch=8, window_us=0, pipeline=2)
    ing.start()
    futs = [ing.enqueue(pkg["message"].Message(topic=f"p/{k}")) for k in range(8)]
    await asyncio.sleep(0.02)
    futs += [ing.enqueue(pkg["message"].Message(topic=f"q/{k}")) for k in range(3)]
    await asyncio.sleep(0.02)
    early = [e for e in events if e[0] == "launch"]
    counts = await asyncio.gather(*futs)
    await ing.stop()
    idle = ing.metrics.histogram("ingest.device.idle.seconds")
    return counts, events, early, idle.count if idle is not None else 0


def test_scripted_schedule_fifo_matches_jax():
    got = {name: run_async(fifo_schedule, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    counts, events = got["port"]
    assert counts == [1] * 8
    launches = [e[1] for e in events if e[0] == "launch"]
    fanouts = [e[1] for e in events if e[0] == "fanout"]
    settles = [e[1] for e in events if e[0] == "settle"]
    done = [e[1] for e in events if e[0] == "device_done"]
    assert launches == [0, 1] and done == [1, 0]  # batch 1's device work first
    assert fanouts == [0, 1]  # ...but the fan-out stays FIFO
    assert settles == [0] * 4 + [1] * 4
    # overlap: batch 1 launched before batch 0's device work completed
    assert events.index(("launch", 1, 4, True)) < events.index(("device_done", 0))


def test_cpu_batch_behind_device_batch_settles_fifo_as_jax():
    got = {name: run_async(cpu_behind_device, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    _counts, events = got["port"]
    launches = [e[1:] for e in events if e[0] == "launch"]
    assert launches == [(0, 4, True), (1, 1, False)]
    assert [e[1] for e in events if e[0] == "fanout"] == [0, 1]


def test_partial_batch_launches_when_the_device_idles_as_jax():
    got = {name: run_async(idle_partial, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    _counts, events, early, idle = got["port"]
    assert early == [("launch", 0, 8, True)]
    i_done0 = events.index(("device_done", 0))
    i_launch1 = events.index(("launch", 1, 3, True))
    assert i_done0 < i_launch1 < events.index(("fanout", 0))
    assert idle >= 1


async def enqueue_launch_race(pkg):
    """tests/test_ingest.py:425: park the flusher on (oldest ready, new
    enqueue) and wake it through both arms, then stop it parked there."""
    events = []
    b = ScriptedBroker(pkg, events, delays=[0.05] * 64, device_at=2)
    ing = pkg["ingest"].BatchIngest(b, max_batch=4, window_us=0, pipeline=2)
    ing.start()
    M = pkg["message"].Message
    futs = []
    for round_ in range(4):
        futs += [ing.enqueue(M(topic=f"r{round_}/{k}")) for k in range(3)]
        await asyncio.sleep(0.01)
        futs.append(ing.enqueue(M(topic=f"r{round_}/wake")))
        await asyncio.sleep(0.08)
    counts = await asyncio.gather(*futs)
    futs2 = [ing.enqueue(M(topic="final/a")), ing.enqueue(M(topic="final/b"))]
    await asyncio.sleep(0.01)
    await asyncio.wait_for(ing.stop(), 5)
    counts2 = await asyncio.gather(*futs2)
    stray = [t for t in asyncio.all_tasks() if "Event.wait" in repr(t.get_coro())]
    return counts + counts2, [e[:3] for e in events if e[0] == "launch"], stray


def test_enqueue_launch_race_leaves_no_waiter_as_jax():
    got = {name: run_async(enqueue_launch_race, pkg) for name, pkg in PKG.items()}
    for counts, _launches, stray in got.values():
        assert counts == [1] * 18
        assert stray == []
    assert got["port"][1] == got["jax"][1]


# -- lanes and the SLO controller --------------------------------------------


def lane_batches(pkg):
    """The lane-priority and anti-starvation batches of
    tests/test_slo.py:245 and :261, on a scripted broker."""
    M = pkg["message"].Message
    out = []
    ing = pkg["ingest"].BatchIngest(ScriptedBroker(pkg, []), max_batch=4, qos0_low=True)
    for i in range(3):
        ing.enqueue(M(topic=f"low/{i}", qos=0))
    for i in range(3):
        ing.enqueue(M(topic=f"norm/{i}", qos=1))
    ing.enqueue(M(topic="ctl/0", qos=2))
    ing.enqueue(M(topic="$SYS/hb", qos=0))
    for _ in range(3):
        out.append([m.topic for m, *_ in ing._take_batch(time.perf_counter())])
    lanes = [ing.lane_of(M(topic="a/b", qos=0, headers={"ingest_lane": "control"})),
             ing.lane_of(M(topic="a/b", qos=1, headers={"ingest_lane": "low"}))]
    ing2 = pkg["ingest"].BatchIngest(ScriptedBroker(pkg, []), max_batch=4, qos0_low=True)
    ing2.starvation_s = 0.0  # the low head is "old" at once
    ing2.enqueue(M(topic="low/0", qos=0))
    for i in range(100):
        ing2.enqueue(M(topic=f"norm/{i}", qos=1))
    out.append([m.topic for m, *_ in ing2._take_batch(time.perf_counter())])
    return out, lanes, ing2.metrics.get("ingest.lane.starvation.breaks")


def test_lane_order_and_starvation_reserve_match_jax():
    async def both():
        return {name: lane_batches(pkg) for name, pkg in PKG.items()}

    got = run_async(both)
    assert got["port"] == got["jax"]
    batches, lanes, breaks = got["port"]
    assert batches[0] == ["ctl/0", "$SYS/hb", "norm/0", "norm/1"]
    assert batches[1] == ["norm/2", "low/0", "low/1", "low/2"]
    assert batches[2] == []
    assert "low/0" in batches[3] and breaks == 1
    assert lanes == [P_slo.LANE_CONTROL, P_slo.LANE_LOW]


def test_slo_controller_walks_the_ladder_as_jax():
    rng = np.random.default_rng(5)
    # a storm (p99 past the 5 ms target), a calm, then a mix with an empty
    # reading and the breaker open twice
    highs = (0.02,) * 12 + (0.002,) * 16 + (0.012,) * 12
    readings = [rng.uniform(0.0001, hi, size=int(rng.integers(0, 80))) for hi in highs]
    traces = {}
    for name, pkg in PKG.items():
        m = pkg["metrics"].Metrics()
        ctl = pkg["slo"].SloController(m, target_p99_ms=5.0, eval_interval_s=1.0,
                                       min_samples=4, ladder_patience=2)
        out = [ctl.tick(now=0.0)]
        for k, vals in enumerate(readings):
            m.observe_many("ingest.settle.seconds", list(vals))
            out.append((ctl.tick(backlog=len(vals), breaker_open=k in (30, 31),
                                 now=1.0 + k), ctl.rung, ctl.last_samples,
                        ctl.defer_low(0.1), ctl.shed(2, 70, 32)))
        traces[name] = (out, ctl.to_json())
    assert traces["port"] == traces["jax"]
    assert {r for _w, r, *_ in traces["port"][0][1:]} == {0, 1, 2, 3}


# -- real brokers ---------------------------------------------------------------


class BrokerRun:
    """One package's broker over seeded subscriptions; deliveries are
    (message index, subscriber id) pairs."""

    def __init__(self, pkg, seed=0):
        self.pkg = pkg
        cfg = pkg["matcher"].MatcherConfig(max_bytes=64, max_levels=8)
        self.broker = pkg["broker"].Broker(
            pkg["router"].Router(cfg, min_tpu_batch=MIN_TPU_BATCH, **pkg["dev"]),
            pkg["hooks"].Hooks())
        self.log = []
        opts = pkg["packet"].SubOpts
        rng = np.random.default_rng(seed)
        for i in range(20):
            for j in range(6):
                self.sub(f"s{i}_{j}", f"device/{i}/+/{j}/#", opts())
        for i in range(8):
            self.sub(f"h{i}", f"device/{i}/#", opts())
        self.sub("x1", "exact/topic", opts())
        self.sub("c3", "device/3/#", opts(no_local=True))
        for i in range(10):
            for m in range(int(rng.integers(2, 5))):
                self.sub(f"g{i}_{m}", f"$share/ingest/device/{i}/#", opts())
        for i in range(4):
            for m in range(3):
                self.sub(f"a{i}_{m}", f"$share/audit/device/{i}/+/1/#", opts())

    def sub(self, sid, filter_, opts, client=None):
        self.broker.subscribe(sid, client or sid, filter_, opts,
                              lambda m, o, s=sid: self.log.append((int(m.payload), s)))

    def messages(self, n, seed=1, qos=0):
        rng = np.random.default_rng(seed)
        ids = np.minimum(rng.zipf(1.4, size=n) - 1, 23)
        nums = rng.integers(0, 8, size=n)
        out = []
        for k, (i, j) in enumerate(zip(ids, nums)):
            topic = "exact/topic" if k % 97 == 5 else f"device/{i}/mid/{j}/leaf"
            out.append(self.pkg["message"].Message(
                topic=topic, payload=str(k).encode(), qos=qos,
                from_client="c3" if k % 50 == 7 else f"pub{k % 7}"))
        return out


async def ingest_drive(pkg, n, max_batch, pipeline):
    """`n` publishes from concurrent `apublish` tasks through a running
    `BatchIngest`; -> (deliveries, counts, [(kind, batch seq)])."""
    run = BrokerRun(pkg)
    ing = pkg["ingest"].BatchIngest(run.broker, max_batch=max_batch, window_us=0,
                                    pipeline=pipeline)
    run.broker.ingest = ing
    ing.start()
    with pkg["tp"].TraceCollector() as tc:
        # every task enqueues before the flusher resumes: full batches only
        counts = await asyncio.gather(*(run.broker.apublish(m) for m in run.messages(n)))
        await ing.stop()
    sched = [(e["kind"], e["batch"]) for e in tc.events
             if e["kind"] in ("ingest.launch", "ingest.settle")]
    return sorted(run.log), list(counts), sched, run.broker.metrics


def pinned_schedule(batches, pipeline):
    """The tracepoints a run of full batches makes: batch N + pipeline - 1
    launches before batch N settles, and no later batch does."""
    out = []
    for k in range(batches):
        out.append(("ingest.launch", k))
        if k >= pipeline - 1:
            out.append(("ingest.settle", k - pipeline + 1))
    out += [("ingest.settle", k) for k in range(batches - pipeline + 1, batches)]
    return out


@pytest.mark.parametrize("pipeline", [1, 2])
def test_ingest_drive_delivers_what_jax_delivers(pipeline):
    n, max_batch = 2000, 250
    got = {name: run_async(ingest_drive, pkg, n, max_batch, pipeline, timeout=300)
           for name, pkg in PKG.items()}
    p_log, p_counts, p_sched, p_metrics = got["port"]
    j_log, j_counts, j_sched, _ = got["jax"]
    assert p_sched == j_sched == pinned_schedule(n // max_batch, pipeline)
    assert p_counts == j_counts
    assert p_log == j_log
    assert sum(p_counts) == len(p_log) > n
    assert p_metrics.get("messages.routed.device") == n
    groups = {s for _k, s in p_log if s.startswith(("g", "a"))}
    assert len(groups) > 20  # round robin spread the groups' messages
    for name in ("profile.stage.prepare.seconds", "profile.stage.host_dispatch.seconds",
                 "ingest.settle.seconds", "ingest.batch.size"):
        assert p_metrics.histogram(name).count > 0, name
    if pipeline == 1:
        # depth 1 settles each batch before the next prepares: the
        # synchronous path's deliveries, $share members included
        run = BrokerRun(PKG["port"])
        msgs = run.messages(n)
        for k in range(0, n, max_batch):
            run.broker.publish_batch(msgs[k:k + max_batch])
        assert sorted(run.log) == p_log


async def stop_drains(pkg):
    run = BrokerRun(pkg)
    ing = pkg["ingest"].BatchIngest(run.broker, window_us=50_000)
    ing.start()
    msgs = run.messages(5)
    tasks = [asyncio.ensure_future(ing.submit(m)) for m in msgs]
    await asyncio.sleep(0)  # enqueued, not yet flushed
    await ing.stop()
    return [await t for t in tasks], sorted(run.log)


def test_stop_drains_pending_work_as_jax():
    got = {name: run_async(stop_drains, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    counts, log = got["port"]
    assert sum(counts) == len(log) > 0


async def qos1_apublish(pkg):
    run = BrokerRun(pkg)
    ing = pkg["ingest"].BatchIngest(run.broker, window_us=2000)
    run.broker.ingest = ing
    ing.start()
    M = pkg["message"].Message
    one = await run.broker.apublish(M(topic="device/2/mid/3/leaf", payload=b"0", qos=1))
    none = await run.broker.apublish(M(topic="nobody/home", payload=b"1", qos=1))
    fut = await run.broker.apublish_enqueue(M(topic="exact/topic", payload=b"2", qos=1))
    queued = isinstance(fut, asyncio.Future)
    n2 = await fut
    await ing.stop()
    # detached: apublish dispatches inline on the CPU path
    inline = await run.broker.apublish(M(topic="exact/topic", payload=b"3", qos=1))
    return one, none, queued, n2, inline, sorted(run.log)


def test_qos1_apublish_resolves_to_its_delivery_count_as_jax():
    got = {name: run_async(qos1_apublish, pkg) for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    one, none, queued, n2, inline, log = got["port"]
    # device/2/mid/3/leaf: its filter's subscriber, the device/2/# one and
    # one member of the ingest group
    assert (one, none, queued, n2, inline) == (3, 0, True, 1, 1)
    assert len(log) == 5


# -- the pipeline's thread safety ----------------------------------------------


SYNCS = ("item", "tolist", "cpu", "numpy", "__int__", "__bool__", "__float__")


def test_delta_prepare_reads_nothing_back(monkeypatch):
    """`prepare()` runs on the event loop's thread while an earlier batch
    works on a pool thread; a delta sync (round-robin bases written back,
    a subscribe, a member leaving) must not read a tensor back to the host,
    or the loop would wait for that batch. Counted on the CPU by wrapping
    every tensor -> host call (the CUDA tests hold the card to it)."""
    run = BrokerRun(PKG["port"])
    msgs = run.messages(300)
    run.broker.publish_batch(msgs)  # bases written back: a delta
    run.sub("late", "device/1/+/2/#", P_packet.SubOpts())
    run.broker.unsubscribe("g1_0", "$share/ingest/device/1/#")
    dev = run.broker._device_router()
    calls = collections.Counter()

    def counted(name, fn):
        @functools.wraps(fn)
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    for name in SYNCS:
        monkeypatch.setattr(torch.Tensor, name, counted(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize", counted("synchronize", torch.cuda.synchronize))
    before = dev.segment_status()
    dev.prepare()
    monkeypatch.undo()
    after = dev.segment_status()
    assert after["groups"]["delta_launches"] == before["groups"]["delta_launches"] + 1
    assert after["bitmaps"]["delta_launches"] == before["bitmaps"]["delta_launches"] + 1
    assert sum(after[m]["full_resyncs"] - before[m]["full_resyncs"] for m in after) == 0
    assert not calls, dict(calls)


def test_launch_counts_stay_exact_across_threads(monkeypatch):
    """`kernels.launch` counts under a lock: eight threads launching at once
    lose no count (a stand-in launcher; no card needed)."""
    monkeypatch.setitem(kernels._launchers, "stand_in", lambda *a: 0)
    monkeypatch.setattr(kernels, "stream_handle", lambda _d: 0)
    kernels.reset_launches()
    per = 20_000
    start = threading.Barrier(8)

    def hammer():
        start.wait()
        for _ in range(per):
            kernels.launch("tokenize", "stand_in", torch.device("cpu"))

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.LAUNCHES["tokenize"] == 8 * per
    kernels.reset_launches()


# -- on the card (skipped without CUDA) ---------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [1, 2])
def test_ingest_drive_on_card_equals_the_twins(cuda_device, pipeline):
    """The drive on the card (pool threads launching on the loop thread's
    stream) delivers what the CPU twins deliver, on the same schedule."""
    card = dict(PKG["port"], dev={"device": "cuda"})
    kernels.reset_launches()
    got = run_async(ingest_drive, card, 2000, 250, pipeline, timeout=300)
    launches = dict(kernels.LAUNCHES)
    want = run_async(ingest_drive, PKG["port"], 2000, 250, pipeline, timeout=300)
    assert got[:3] == want[:3]
    assert launches["tokenize"] == 8 and launches["share_pick"] == 16
    assert launches["occurrence_index"] == 24


@pytest.mark.cuda
def test_delta_prepare_does_not_synchronize_on_card(cuda_device):
    run = BrokerRun(dict(PKG["port"], dev={"device": "cuda"}))
    msgs = run.messages(300)
    run.broker.publish_batch(msgs)
    dev = run.broker._device_router()
    for step in range(3):
        run.broker.publish_batch(msgs[:100])  # bases written back
        run.broker.unsubscribe(f"s{step}_1", f"device/{step}/+/1/#")  # a cleared bit
        torch.cuda.synchronize()
        before = dev.segment_status()
        torch.cuda._sleep(50_000_000)  # the stream busy for tens of ms
        torch.cuda.set_sync_debug_mode("error")
        try:
            dev.prepare()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        busy = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        after = dev.segment_status()
        assert after["groups"]["delta_launches"] == before["groups"]["delta_launches"] + 1
        assert after["bitmaps"]["delta_launches"] == before["bitmaps"]["delta_launches"] + 1
        assert all(after[m]["full_resyncs"] == before[m]["full_resyncs"] for m in after)
        assert busy, "prepare() waited for the stream"
