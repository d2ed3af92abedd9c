"""The port's retained storm feed and retainer against the JAX package.

`emqx_tpu_torch.broker.retained_feed.RetainedStormFeed`,
`emqx_tpu_torch.broker.retainer.Retainer` and the broker's storm hand-off
in `adispatch_begin`, driven as tests/test_serving_pipeline.py:230-338,
tests/test_slo.py:401-428 and tests/test_degrade.py:501 drive the
reference: a storm riding a publish launch, a quiet broker's standalone
flush, an unfusable storm, a failed launch, the SLO defer rung and its
age release, the ``retained.storm`` fault site, and a storm pending while
the degrade ladder retries a failing launch. Both packages run on the
CPU (the port on ``device="cpu"``, its kernels' plain twins), with the
same faults armed in both `default_faults`.

`CHUNK` is set small in both retained-index modules (it is read at call
time), so a store of a few hundred topics spans one chunk or several.
JAX's fused readback fails past one chunk (ROADMAP Queue 3), so the
stores held against JAX's feed fit one chunk; the multi-chunk storm is
held against the port's own standalone `match_many` (and, on the card,
in `chip_smoke.py`'s `feed_broker`).

Held equal: each waiter's topics, the retained deliveries each channel
receives through `Retainer.attach` (with ``headers["retained"]``), the
`retained.storm.*` counters, and the retainer's store through a seeded
script (`match`, `get`, `delete`, expiry, capacity, `topics`). A
reference store carried across (`convert.retained_messages_from_reference`)
answers the same matches. Tolerance: EXACT equality (topics and counts).
"""

import asyncio
import random

import pytest

from emqx_tpu.broker import broker as J_broker
from emqx_tpu.broker import degrade as J_degrade
from emqx_tpu.broker import hooks as J_hooks
from emqx_tpu.broker import ingest as J_ingest
from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import metrics as J_metrics
from emqx_tpu.broker import retained_feed as J_feed
from emqx_tpu.broker import retainer as J_retainer
from emqx_tpu.broker import router as J_brouter
from emqx_tpu.broker import slo as J_slo
from emqx_tpu.models import retained_index as J_ret
from emqx_tpu.models import router_model as J_router
from emqx_tpu.mqtt import packet as J_packet
from emqx_tpu.observe import faults as J_faults
from emqx_tpu_torch import convert
from emqx_tpu_torch.broker import broker as P_broker
from emqx_tpu_torch.broker import degrade as P_degrade
from emqx_tpu_torch.broker import hooks as P_hooks
from emqx_tpu_torch.broker import ingest as P_ingest
from emqx_tpu_torch.broker import message as P_message
from emqx_tpu_torch.broker import metrics as P_metrics
from emqx_tpu_torch.broker import retained_feed as P_feed
from emqx_tpu_torch.broker import retainer as P_retainer
from emqx_tpu_torch.broker import router as P_brouter
from emqx_tpu_torch.broker import slo as P_slo
from emqx_tpu_torch.models import retained_index as P_ret
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.mqtt import packet as P_packet
from emqx_tpu_torch.observe import faults as P_faults
from emqx_tpu_torch.ops import topics as T

PKG = {
    "port": dict(broker=P_broker, degrade=P_degrade, hooks=P_hooks, ingest=P_ingest,
                 message=P_message, metrics=P_metrics, feed=P_feed, retainer=P_retainer,
                 router=P_brouter, slo=P_slo, ret=P_ret, router_model=P_router,
                 packet=P_packet, faults=P_faults, dev={"device": "cpu"}),
    "jax": dict(broker=J_broker, degrade=J_degrade, hooks=J_hooks, ingest=J_ingest,
                message=J_message, metrics=J_metrics, feed=J_feed, retainer=J_retainer,
                router=J_brouter, slo=J_slo, ret=J_ret, router_model=J_router,
                packet=J_packet, faults=J_faults, dev={}),
}
BOTH = ("port", "jax")
SMALL_CHUNK = 256
STORM_COUNTERS = ("retained.storm.filters", "retained.storm.fused",
                  "retained.storm.flushed", "retained.storm.deferred", "faults.injected",
                  "degrade.retries", "degrade.fallback.batches")


@pytest.fixture(autouse=True)
def _small_chunk_and_no_faults(monkeypatch):
    monkeypatch.setattr(J_ret, "CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(P_ret, "CHUNK", SMALL_CHUNK)
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
    return [fn(PKG[name], *a) for name in BOTH]


def counters(m) -> dict:
    return {k: m.get(k) for k in STORM_COUNTERS}


def mk_broker(pkg, min_batch=2):
    return pkg["broker"].Broker(
        router=pkg["router"].Router(min_tpu_batch=min_batch, **pkg["dev"]),
        hooks=pkg["hooks"].Hooks())


def mk_retainer(pkg, n, threshold=10, topic=None):
    """A device-enabled retainer holding `n` retained messages
    site/{i % 4}/dev/{i} (tests/test_serving_pipeline.py:233)."""
    ret = pkg["retainer"].Retainer(device_threshold=threshold, enable_device=True,
                                   **pkg["dev"])
    for i in range(n):
        ret._insert(pkg["message"].Message(
            topic=topic(i) if topic else f"site/{i % 4}/dev/{i}", payload=b"r", retain=True))
    ret.ensure_device()
    return ret


class Chan:
    """A stub channel: records each retained delivery's topic (and that it
    carries the retained mark)."""

    def __init__(self):
        self.got = []

    def handle_deliver(self, m, o):
        self.got.append((m.topic, m.headers.get("retained")))


def sub_n(pkg, b, n):
    for i in range(n):
        b.subscribe(f"s{i}", f"c{i}", f"t/{i}/+", pkg["packet"].SubOpts(), lambda m, o: None)


def msgs(pkg, n):
    return [pkg["message"].Message(topic=f"t/{i % 8}/x", payload=b"p") for i in range(n)]


async def wait_for(pred, tries=500, dt=0.01):
    for _ in range(tries):
        if pred():
            return True
        await asyncio.sleep(dt)
    return pred()


# -- the feed's four paths (tests/test_serving_pipeline.py:230-338) ---------------


async def storm_rides(pkg, filters):
    """A storm of `filters`, submitted through `session.subscribed`, rides
    one publish launch (the window is far beyond the test: only a launch
    can answer it)."""
    b = mk_broker(pkg)
    sub_n(pkg, b, 4)
    ret = mk_retainer(pkg, 50)
    feed = pkg["feed"].RetainedStormFeed(ret._device, metrics=b.metrics, window_s=5.0)
    ret.storm_feed = feed
    b.retained_feed = feed
    ing = pkg["ingest"].BatchIngest(b, max_batch=8, window_us=200)
    b.ingest = ing
    ing.start()
    ret.attach(b.hooks)
    chans = {f: Chan() for f in filters}
    for f, ch in chans.items():
        await b.hooks.arun("session.subscribed", {}, f, pkg["packet"].SubOpts(), ch)
    await asyncio.gather(*[ing.enqueue(m) for m in msgs(pkg, 8)])
    await wait_for(lambda: all(ch.got for ch in chans.values()))
    await ing.stop()
    return {f: sorted(ch.got) for f, ch in chans.items()}, counters(b.metrics)


def test_storm_rides_a_publish_launch_as_jax():
    filters = ["site/1/#", "site/+/dev/7", "+/2/#", "site/3/dev/+"]
    p, j = both(lambda pkg: run_async(storm_rides, pkg, filters))
    assert p == j
    got, c = p
    assert c["retained.storm.fused"] == 1 and c["retained.storm.flushed"] == 0
    assert c["retained.storm.filters"] == len(filters)
    assert got["site/1/#"] == sorted((f"site/1/dev/{i}", True) for i in range(50) if i % 4 == 1)
    for f, g in got.items():
        assert g == sorted((f"site/{i % 4}/dev/{i}", True) for i in range(50)
                           if T.match(f"site/{i % 4}/dev/{i}", f)), f


async def quiet_flush(pkg):
    b = mk_broker(pkg)
    ret = mk_retainer(pkg, 40)
    feed = pkg["feed"].RetainedStormFeed(ret._device, metrics=b.metrics, window_s=0.01)
    ret.storm_feed = feed
    b.retained_feed = feed
    ret.attach(b.hooks)
    chans = [Chan(), Chan()]
    await b.hooks.arun("session.subscribed", {}, "site/2/#", pkg["packet"].SubOpts(), chans[0])
    await b.hooks.arun("session.subscribed", {}, "site/+/dev/5", pkg["packet"].SubOpts(),
                       chans[1])
    await wait_for(lambda: all(ch.got for ch in chans), tries=500, dt=0.02)
    return [sorted(ch.got) for ch in chans], counters(b.metrics)


def test_quiet_broker_storm_flushes_standalone_as_jax():
    p, j = both(lambda pkg: run_async(quiet_flush, pkg))
    assert p == j
    got, c = p
    assert c["retained.storm.flushed"] == 1 and c["retained.storm.fused"] == 0
    assert got[0] == sorted((f"site/2/dev/{i}", True) for i in range(40) if i % 4 == 2)
    assert got[1] == [("site/1/dev/5", True)]


async def unfusable(pkg):
    b = mk_broker(pkg, min_batch=1)
    ret = mk_retainer(pkg, 20, threshold=5, topic=lambda i: f"s/{i}")
    empty = pkg["ret"].DeviceRetainedIndex(**pkg["dev"])  # the feed on an EMPTY index
    feed = pkg["feed"].RetainedStormFeed(empty, metrics=b.metrics, window_s=5.0)
    ret.storm_feed = feed
    fut = feed.submit("s/#")
    job = feed.take_job()
    return job is None, await fut, counters(b.metrics)


def test_unfusable_storm_falls_back_to_cpu_walk_as_jax():
    p, j = both(lambda pkg: run_async(unfusable, pkg))
    assert p == j
    assert p[0] is True and p[1] is None


async def failed_launch(pkg):
    idx = pkg["ret"].DeviceRetainedIndex(**pkg["dev"])
    idx.bulk_add(["site/1/a"])
    feed = pkg["feed"].RetainedStormFeed(idx, window_s=5.0)
    fut = feed.submit("site/+/a")
    job = feed.take_job()
    launch = asyncio.get_running_loop().create_future()
    feed.attach(job, launch)
    launch.set_exception(RuntimeError("device died"))
    await asyncio.sleep(0)
    return job is not None, await fut


def test_failed_launch_resolves_waiters_with_fallback_as_jax():
    p, j = both(lambda pkg: run_async(failed_launch, pkg))
    assert p == j == (True, None)


# -- the SLO defer gate and the fault site -------------------------------------------


class StubIndex:
    def prepare_storm(self, filters):
        return object()

    def topic_at(self, r):
        return None


async def defer_gate(pkg):
    """tests/test_slo.py:401: on the defer rung the storm sits out until
    its age passes defer_max_s; without a controller it goes at once."""
    S = pkg["slo"]
    m = pkg["metrics"].Metrics()
    ctl = S.SloController(m, target_p99_ms=5.0, eval_interval_s=1.0, min_samples=4,
                          ladder_patience=2, initial_window_us=1000, max_window_us=20_000,
                          defer_max_s=0.25)
    ctl.rung = S.RUNG_DEFER
    feed = pkg["feed"].RetainedStormFeed(StubIndex(), metrics=m, window_s=60.0)
    feed.slo = ctl
    feed.submit("a/#")
    seen = [feed.take_job() is None, m.get("retained.storm.deferred"), len(feed)]
    feed._oldest_t -= 1.0  # starved past defer_max_s: released
    seen += [feed.take_job() is not None, len(feed)]
    feed._cancel_timer()
    plain = pkg["feed"].RetainedStormFeed(StubIndex(), window_s=60.0)
    plain.submit("a/#")
    seen.append(plain.take_job() is not None)
    plain._cancel_timer()
    return seen


def test_storm_feed_defer_rung_and_age_release_as_jax():
    p, j = both(lambda pkg: run_async(defer_gate, pkg))
    assert p == j == [True, 1, 1, True, 0, True]


async def storm_fault(pkg):
    """tests/test_degrade.py:501: the `retained.storm` site's raise sends
    the waiters to the CPU walk (None), not an exception."""

    class FakeIndex:
        def prepare_storm(self, filters):
            raise AssertionError("must not be reached when the fault fires")

        def topic_at(self, r):
            return None

    m = pkg["metrics"].Metrics()
    pkg["faults"].default_faults.metrics = m
    pkg["faults"].default_faults.arm("retained.storm", mode="raise")
    feed = pkg["feed"].RetainedStormFeed(FakeIndex(), metrics=m)
    fut = feed.submit("a/#")
    job = feed.take_job()
    return job is None, await fut, m.get("faults.injected"), len(feed)


def test_retained_storm_fault_falls_back_to_cpu_walk_as_jax():
    p, j = both(lambda pkg: run_async(storm_fault, pkg))
    assert p == j == (True, None, 1, 0)


# -- a storm pending while the ladder retries a failing launch ----------------------


async def storm_through_ladder(pkg):
    """`device.launch` raising for every launch of one batch that carries a
    storm: the storm's waiters get the CPU-fallback signal (the retainer
    then walks its trie: the same deliveries), the retries relaunch bare
    (no call after the first carries the storm), and the batch is served
    from the CPU."""
    deg = pkg["degrade"].DegradeController(max_retries=2, backoff_base_s=0.001,
                                           open_secs=60.0)
    b = mk_broker(pkg)
    b.degrade = deg
    sub_n(pkg, b, 4)
    deg.metrics = deg.device.metrics = b.metrics
    pkg["faults"].default_faults.metrics = b.metrics
    ret = mk_retainer(pkg, 50)
    feed = pkg["feed"].RetainedStormFeed(ret._device, metrics=b.metrics, window_s=5.0)
    ret.storm_feed = feed
    b.retained_feed = feed
    ret.attach(b.hooks)
    cls = pkg["router_model"].DeviceRouter
    real = cls.route_prepared
    storms = []

    def spy(self, args, topics, client_hashes=None, retained=None, *a, **k):
        storms.append(retained is not None)
        return real(self, args, topics, client_hashes, retained, *a, **k)

    cls.route_prepared = spy
    try:
        ch = Chan()
        await b.hooks.arun("session.subscribed", {}, "site/3/#", pkg["packet"].SubOpts(), ch)
        await wait_for(lambda: len(feed))  # the replay task has submitted
        pkg["faults"].default_faults.arm("device.launch", mode="raise")
        counts = await b.adispatch_begin(msgs(pkg, 8))
        await wait_for(lambda: ch.got)
    finally:
        cls.route_prepared = real
    return sorted(ch.got), counts, storms, counters(b.metrics), deg.device.state


def test_storm_pending_through_a_failed_launch_as_jax():
    p, j = both(lambda pkg: run_async(storm_through_ladder, pkg))
    assert p == j
    got, _counts, storms, c, state = p
    assert storms == [True, False, False] and state == "open"
    assert c["retained.storm.fused"] == 1 and c["faults.injected"] == 3
    assert c["degrade.fallback.batches"] == 1
    assert got == sorted((f"site/3/dev/{i}", True) for i in range(50) if i % 4 == 3)


# -- port only: a multi-chunk storm fused into a broker batch -------------------------


def test_multichunk_storm_rides_the_broker_like_match_many():
    """Past one chunk JAX's fused readback fails, so the port's fused
    storm is held against its own standalone `match_many`: 700 topics
    over three chunks of 256, a storm of 40 filters on one broker batch,
    and the standalone flush of the same storm."""
    pkg = PKG["port"]
    topics = [f"site/{i % 5}/dev/{i % 13}/ch/{i}" for i in range(700)]
    filters = [f"site/+/dev/{d}/ch/#" for d in range(13)] + \
        [f"site/{s}/#" for s in range(5)] + ["#", "nomatch/+", "site/1/dev/+/ch/+"] + \
        [f"+/{s}/dev/{d}/#" for s in range(3) for d in range(6)] + ["site/+/+/3/#"]

    async def run(fused):
        b = mk_broker(pkg)
        sub_n(pkg, b, 4)
        idx = P_ret.DeviceRetainedIndex(device="cpu")
        idx.bulk_add(topics)
        idx.remove(topics[5])
        feed = P_feed.RetainedStormFeed(idx, metrics=b.metrics,
                                        window_s=5.0 if fused else 0.01)
        b.retained_feed = feed
        futs = [feed.submit(f) for f in filters]
        if fused:
            await b.adispatch_begin(msgs(pkg, 8))
        got = await asyncio.gather(*futs)
        want = idx.match_many(filters)
        return {f: sorted(g) for f, g in zip(filters, got)}, \
            {f: sorted(idx.topic_at(int(r)) for r in want[f]) for f in filters}, \
            len(idx._host_b), counters(b.metrics)

    for fused in (True, False):
        got, want, chunks, c = run_async(run, fused)
        assert chunks == 3 and got == want
        assert (c["retained.storm.fused"], c["retained.storm.flushed"]) == \
            ((1, 0) if fused else (0, 1))
        assert topics[5] not in got["#"] and len(got["#"]) == 699


# -- port only: rows that change topic between the storm's sync and settle ---------


def test_row_reused_between_take_job_and_settle_replays_only_matches():
    """A storm taken by `adispatch_begin` is synced and launched; before
    the batch settles, a matching topic is deleted and a non-matching one
    takes its row (`DeviceRetainedIndex.add` reuses freed rows), and a
    second matching topic is deleted outright. The waiter gets only the
    topics that still match its filter (`retained.storm.stale` counts the
    row whose topic changed)."""
    pkg = PKG["port"]

    async def run():
        b = mk_broker(pkg)
        sub_n(pkg, b, 4)
        idx = P_ret.DeviceRetainedIndex(device="cpu")
        idx.bulk_add(["site/1/a", "site/2/a", "site/3/a", "other/x"])
        idx.remove("other/x")  # a row freed before the sync: never a hit
        feed = P_feed.RetainedStormFeed(idx, metrics=b.metrics, window_s=5.0)
        b.retained_feed = feed
        fut = feed.submit("site/+/a")
        pd = b.adispatch_begin(msgs(pkg, 8))  # takes the storm, launches
        row = idx._rows["site/1/a"]
        idx.remove("site/1/a")
        assert idx.add("zzz/q") and idx._rows["zzz/q"] == row
        idx.remove("site/3/a")
        await pd.complete()
        return sorted(await fut), b.metrics.get("retained.storm.stale"), \
            counters(b.metrics)

    got, stale, c = run_async(run)
    assert got == ["site/2/a"]
    assert stale == 1 and c["retained.storm.fused"] == 1


# -- port only: a kernel library that will not build is never served from the trie --


def test_build_error_in_a_storm_is_not_answered_from_the_trie(monkeypatch):
    """`KernelBuildError` out of the standalone flush's `run_storm`, out of
    `take_job`'s prepare and out of a fused launch reaches the waiters as
    the exception, not as the CPU-fallback signal: the Retainer's replay
    raises and never walks its trie. A failure of any other kind still
    answers None, counted in `retained.storm.fallback`."""
    from emqx_tpu_torch.kernels import build as P_build

    pkg = PKG["port"]

    def boom(*_a, **_k):
        raise P_build.KernelBuildError("nvcc failed: stand-in")

    async def flush(error):
        m = P_metrics.Metrics()
        ret = mk_retainer(pkg, 40)
        monkeypatch.setattr(ret._device, "run_storm",
                            boom if error else lambda job: 1 / 0)
        walks = []
        monkeypatch.setattr(ret, "match", lambda *a: walks.append(a) or [])
        ret.storm_feed = P_feed.RetainedStormFeed(ret._device, metrics=m, window_s=0.001)
        task = asyncio.ensure_future(ret._replay_batched("site/2/#", P_packet.SubOpts(),
                                                         Chan()))
        outcome = None
        try:
            await asyncio.wait_for(task, 10)
        except P_build.KernelBuildError:
            outcome = "raised"
        await asyncio.sleep(0.01)  # the flush task ends
        return outcome, len(walks), m.get("retained.storm.fallback"), \
            m.get("retained.storm.flushed")

    assert run_async(flush, True) == ("raised", 0, 0, 1)
    assert run_async(flush, False) == (None, 1, 1, 1)

    async def take(error):
        m = P_metrics.Metrics()
        ret = mk_retainer(pkg, 40)
        monkeypatch.setattr(ret._device, "prepare_storm",
                            boom if error else lambda f: 1 / 0)
        feed = P_feed.RetainedStormFeed(ret._device, metrics=m, window_s=5.0)
        fut = feed.submit("site/2/#")
        try:
            feed.take_job()
        except P_build.KernelBuildError:
            pass
        else:
            assert not error
        try:
            return await fut, len(feed), m.get("retained.storm.fallback")
        except P_build.KernelBuildError:
            return "raised", len(feed), m.get("retained.storm.fallback")

    assert run_async(take, True) == ("raised", 0, 0)
    assert run_async(take, False) == (None, 0, 1)

    async def fused():
        # through the broker: the storm's prepare raises out of
        # adispatch_begin even with a controller attached
        b = mk_broker(pkg)
        sub_n(pkg, b, 4)
        b.degrade = P_degrade.DegradeController(max_retries=1, backoff_base_s=0.001)
        ret = mk_retainer(pkg, 40)
        monkeypatch.setattr(ret._device, "prepare_storm", boom)
        feed = P_feed.RetainedStormFeed(ret._device, metrics=b.metrics, window_s=5.0)
        b.retained_feed = feed
        fut = feed.submit("site/2/#")
        with pytest.raises(P_build.KernelBuildError):
            b.adispatch_begin(msgs(pkg, 8))
        with pytest.raises(P_build.KernelBuildError):
            await fut
        # a fused launch that dies of a build error hands it on
        idx = P_ret.DeviceRetainedIndex(device="cpu")
        idx.bulk_add(["site/1/a"])
        feed = P_feed.RetainedStormFeed(idx, window_s=5.0)
        fut = feed.submit("site/+/a")
        job = feed.take_job()
        launch = asyncio.get_running_loop().create_future()
        feed.attach(job, launch)
        launch.set_exception(P_build.KernelBuildError("stand-in"))
        await asyncio.sleep(0)
        with pytest.raises(P_build.KernelBuildError):
            await fut
        return b.metrics.get("degrade.fallback.batches")

    assert run_async(fused) == 0


def test_device_index_on_a_card_loads_the_library_when_made(monkeypatch):
    """The replay index made for CUDA builds and loads the kernel library
    in its constructor (as `Broker._device_router` does), so the
    Retainer's first retained insert raises a build failure instead of a
    later storm falling back to the trie."""
    import torch

    from emqx_tpu_torch.kernels import build as P_build

    def boom():
        raise P_build.KernelBuildError("nvcc not found: stand-in")

    # a card as `convert.resolve_device` sees it; nothing here touches it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(P_build, "load", boom)
    with pytest.raises(P_build.KernelBuildError):
        P_ret.DeviceRetainedIndex()
    ret = P_retainer.Retainer(device_threshold=1, enable_device=True)
    with pytest.raises(P_build.KernelBuildError):
        ret._insert(P_message.Message(topic="a/b", payload=b"r", retain=True))
    loads = []
    monkeypatch.setattr(P_build, "load", lambda: loads.append(1))
    P_ret.DeviceRetainedIndex(device="cuda")
    P_ret.DeviceRetainedIndex(device="cpu")
    assert loads == [1]


# -- the retainer's store (the trie and the device index behind the threshold) -------


def retainer_script(pkg, enable_device: bool):
    """A seeded script of publishes (retain and not, empty payloads that
    delete, oversize payloads, $SYS topics), expiry, capacity, and the
    matches of wildcard filters (past the device threshold when
    `enable_device`, and one filter deeper than max_levels)."""
    rng = random.Random(11)
    M = pkg["message"].Message
    kw = pkg["dev"] if enable_device else {}
    ret = pkg["retainer"].Retainer(max_retained=300, max_payload=64, device_threshold=50,
                                   enable_device=enable_device, **kw)
    out = []
    for k in range(400):
        t = f"s/{rng.randrange(6)}/d/{rng.randrange(40)}"
        if rng.random() < 0.1:
            t = "$SYS/" + t
        r = rng.random()
        payload = b"" if r < 0.1 else (b"x" * 100 if r < 0.15 else b"p%d" % k)
        props = {"Message-Expiry-Interval": 5} if rng.random() < 0.2 else {}
        ret.on_publish(M(topic=t, payload=payload, retain=rng.random() < 0.9,
                         properties=props, timestamp=1000.0 + k))
    ret.on_publish(M(topic="/".join("x" * 12), payload=b"deep", retain=True))
    out.append(len(ret))
    filters = ["s/+/d/#", "s/1/#", "#", "+/+/d/3", "s/2/d/7", "$SYS/#", "+/1/#",
               "/".join("x" * 12), "x/#", "/".join(["+"] * 12)]
    for f in filters:
        out.append((f, sorted(m.topic for m in ret.match(f, now=1200.0))))
    out.append(sorted(ret.topics()))
    out.append(ret.get("s/1/d/3") is not None)
    out.append(ret.clear_expired(now=1500.0))
    out.append(len(ret))
    for f in filters:
        out.append((f, sorted(m.topic for m in ret.match(f, now=1500.0))))
    out.append(sorted(m.topic for m in ret.all_messages()))
    return out, (ret._device is not None, getattr(ret._device, "_rows", None) and
                 sorted(ret._device._rows))


@pytest.mark.parametrize("enable_device", [False, True])
def test_retainer_store_and_matches_equal_jax(enable_device):
    p, j = both(retainer_script, enable_device)
    assert p == j
    assert p[1][0] is enable_device
    assert p[0][0] > 50  # past the device threshold


def test_reference_store_carries_across():
    """A reference retainer's messages load into the port's and answer
    every match alike (device path included)."""
    ref = J_retainer.Retainer(device_threshold=20, enable_device=False)
    rng = random.Random(5)
    for k in range(120):
        ref._insert(J_message.Message(
            topic=f"a/{rng.randrange(5)}/b/{k}", payload=b"v%d" % k, retain=True, qos=k % 3,
            properties={"Message-Expiry-Interval": 30} if k % 7 == 0 else {},
            headers={"h": k}))
    port = P_retainer.Retainer(device_threshold=20, enable_device=True, device="cpu")
    port.load(convert.retained_messages_from_reference(ref.all_messages()))
    assert len(port) == len(ref) and port._device is not None and len(port._device) == 120
    for f in ("a/#", "a/+/b/+", "a/3/#", "+/1/b/7", "#"):
        want = [(m.topic, m.payload, m.qos, m.timestamp, m.properties, m.headers)
                for m in ref.match(f)]
        got = [(m.topic, m.payload, m.qos, m.timestamp, m.properties, m.headers)
               for m in port.match(f)]
        assert sorted(got, key=str) == sorted(want, key=str), f


async def hook_deliveries(pkg):
    """`Retainer.attach`'s hooks without a feed: retain publishes through
    the 'message.publish' fold, then `session.subscribed` replays (shared
    subscriptions and retain_handling 2 get none)."""
    b = mk_broker(pkg, min_batch=64)
    ret = pkg["retainer"].Retainer(device_threshold=5, enable_device=True, **pkg["dev"])
    ret.attach(b.hooks)
    M = pkg["message"].Message
    for i in range(30):
        b.publish(M(topic=f"r/{i % 3}/{i}", payload=b"v", retain=True))
    b.publish(M(topic="r/0/0", payload=b"", retain=True))  # deletes
    out = []
    for f, opts in (("r/1/#", {}), ("r/+/5", {}), ("$share/g/r/#", {}),
                    ("r/#", {"retain_handling": 2}), ("r/2/8", {})):
        ch = Chan()
        await b.hooks.arun("session.subscribed", {}, f, pkg["packet"].SubOpts(**opts), ch)
        out.append((f, sorted(ch.got)))
    return out, len(ret)


def test_retainer_hook_deliveries_equal_jax():
    p, j = both(lambda pkg: run_async(hook_deliveries, pkg))
    assert p == j
    out, n = p
    assert n == 29 and out[2][1] == [] and out[3][1] == []
    assert out[0][1] == sorted((f"r/1/{i}", True) for i in range(30) if i % 3 == 1)
