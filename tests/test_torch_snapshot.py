"""Segment-state snapshots in the port against the JAX package.

`SegmentStateSnapshot` of `emqx_tpu_torch` round-trips a port broker's
tables (its `Router` — route index with hot segments and tombstones, trie,
exact filters — its subscriber table, dense or CSR, its group table and a
session store's capture) through a pickle file into a broker shell: every
table byte-identical, no tensor and no process group in the pickled state
(a `Router` whose matcher was built and that holds a mesh included), the
same deliveries as the original broker and as JAX's broker restored from
its own snapshot. `convert.segment_state_from_reference` carries a JAX
broker's snapshot file across, refusing classes it does not map; the port
broker it restores delivers exactly as JAX's restored broker does, and its
session store redelivers the same rows. Tolerance: EXACT equality.
"""

import io
import pickle
import threading

import numpy as np
import pytest
import torch

from emqx_tpu.broker import message as J_message
from emqx_tpu.broker import session_store as J_store
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import segments as J_seg
from emqx_tpu_torch import convert
from emqx_tpu_torch.broker import session_store as P_store
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import segments as P_seg

from test_torch_broker import JAX, PORT, Run, low_flip, topic_batch  # noqa: F401

MODES = ["dense", "auto"]


def build(mods, mode):
    """A broker with plain, exact and $share subscriptions, then churn that
    leaves hot shape entries, packed tombstones and (CSR) hot pairs."""
    run = Run(mods, mode, "round_robin")
    for i in range(30):
        for j in range(8):
            run.sub(f"s{i}_{j}", f"device/{i}/+/{j}/#")
    for i in range(10):
        run.sub(f"h{i}", f"device/{i}/#")
    run.sub("x1", "exact/topic")
    for i in range(10):
        for m in range(4):
            run.sub(f"g{i}_{m}", f"$share/ingest/device/{i}/#")
    return run


def churn(run):
    for k in range(0, 240, 9):
        i, j = divmod(k, 8)
        run.broker.unsubscribe(f"s{i}_{j}", f"device/{i}/+/{j}/#")
    for i in range(12):
        run.sub(f"n{i}", f"device/{i % 5}/+/{8 + i}/#")
    run.broker.unsubscribe("g3_1", "$share/ingest/device/3/#")


def compact_shapes(run, seg):
    """Fold the shape hot segment into the packed table (a mixed state:
    the churn after it leaves hot entries and tombstones again)."""
    idx = run.broker.router.index
    man = seg.DeviceSegmentManager("cpu") if seg is P_seg else seg.DeviceSegmentManager()
    assert seg.SegmentCompactor().compact_now(
        seg.ShapeSegmentOwner(idx.shapes, man, hot_entries=1))


def tables(broker, store_table=None):
    """Every host array of the snapshot's tables, as bytes."""
    r = broker.router
    out = {}
    for name, src in (("shapes", r.index.shapes), ("nfa", r.index.nfa),
                      ("subtab", broker.subtab), ("groups", broker.grouptab),
                      ("sessions", store_table)):
        if src is None:
            continue
        for k, v in src.device_snapshot().items():
            out[f"{name}.{k}"] = (np.asarray(v).shape, np.ascontiguousarray(v).tobytes())
    out["exact"] = sorted(r._exact.items())
    out["trie"] = sorted(r._trie.filters())
    out["filters"] = sorted((f, r.filter_id(f)) for f in r.topics())
    return out


class Spy(pickle.Pickler):
    """Pickles and records every object of a torch type it meets."""

    def __init__(self, f):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.torch_objects = []

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor) or type(obj).__module__.split(".")[0] == "torch":
            self.torch_objects.append(type(obj).__name__)
        return None


def batches(seed, n=3):
    rng = np.random.default_rng(seed)
    return [topic_batch(rng, 100 * k, 96, edge=(k == 0)) for k in range(n)]


def deliveries(run, bs):
    run.log.clear()
    for b in bs:
        run.publish(b)
    return sorted(run.log), list(run.counts)


def session_store(mods_store, message, clock, **kw):
    store = mods_store.SessionStore(capacity=256, sweep_slots=16, retry_interval=1.0,
                                    clock=clock, **kw)
    shared = message.Message(topic="dev/offline", payload=b"m", qos=1)
    store.bulk_load([f"c{i}" for i in range(40)], [shared] * 40, pids=np.arange(40) + 1)
    store.set_expiry("c3", 2.0)
    store.drop_session("c5")
    return store


def redeliveries(store):
    rows = []
    for slot in range(len(store._slot_cid)):
        store.bind(slot, lambda pid, s_, m, slot=slot: rows.append(
            (slot, pid, s_, m.topic if m is not None else None)) or True)
    expired = []
    store.on_expired = expired.extend
    n = store.host_sweep()
    return n, sorted(rows), sorted(expired)


@pytest.mark.parametrize("mode", MODES)
def test_port_broker_round_trip(tmp_path, low_flip, mode):  # noqa: F811
    mono = [0.0]
    clock = lambda: mono[0]  # noqa: E731
    a, b = build(PORT, mode), build(PORT, mode)
    for run in (a, b):
        compact_shapes(run, P_seg)
        churn(run)
    assert a.broker.router.index.shapes.hot_live > 0
    assert a.broker.router.index.shapes.packed_tombstones > 0
    assert a.broker.subtab.sparse == (mode == "auto")
    store = session_store(P_store, PORT[3], clock, device="cpu")
    mono[0] += 1.5
    # the match-only router and the broker's device router hold tensors
    topics = [t for _k, t, _c in batches(5)[1]]
    a.broker.router.match_batch(topics)
    a.broker._device_router().prepare()
    assert a.broker.router._matcher is not None and a.broker._device is not None
    a.broker.router.mesh = threading.Lock()  # a mesh: never picklable

    def capture():
        return {"router": a.broker.router, "subtab": a.broker.subtab,
                "grouptab": a.broker.grouptab, "session_store": store.capture()}

    spy = Spy(io.BytesIO())
    spy.dump(capture())
    assert spy.torch_objects == []
    restored = P_store.SessionStore(capacity=64, sweep_slots=16, retry_interval=1.0,
                                    clock=clock, device="cpu")

    def install(state):
        b.broker.router = state["router"]
        b.broker.subtab = state["subtab"]
        b.broker.grouptab = state["grouptab"]
        restored.install(state["session_store"])
        b.broker._device = None  # rebuilt on the next batch

    path = str(tmp_path / "segments.pkl")
    meta = P_seg.SegmentStateSnapshot(path, capture=capture).save()
    a.broker.router.mesh = None
    assert meta["keys"] == ["grouptab", "router", "session_store", "subtab"]
    b_router = b.broker.router
    got = P_seg.SegmentStateSnapshot(path, capture=dict, install=install).load(meta)
    assert set(got) == set(meta["keys"]) and b.broker.router is not b_router
    assert b.broker.router._matcher is None and b.broker.router.mesh is None
    assert tables(b.broker, restored.table) == tables(a.broker, store.table)
    # the restored matcher rebuilds on its own device
    assert b.broker.router.match_batch(topics) == a.broker.router.match_batch(topics)
    # the first prepare is one full upload a mirror
    dev = b.broker._device_router()
    dev.prepare()
    st = dev.segment_status()
    assert all(st[m] == {"full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0}
               for m in ("shapes", "bitmaps", "groups"))
    assert st["nfa"]["full_resyncs"] == 0  # no residual filter: not mirrored
    bs = batches(5)
    assert deliveries(b, bs) == deliveries(a, bs)
    mono[0] += 5.0
    assert redeliveries(restored) == redeliveries(store)


@pytest.mark.parametrize("mode", MODES)
def test_jax_snapshot_carried_across(tmp_path, low_flip, mode):  # noqa: F811
    mono = [0.0]
    clock = lambda: mono[0]  # noqa: E731
    ja, jb, pb = build(JAX, mode), build(JAX, mode), build(PORT, mode)
    for run, seg in ((ja, J_seg), (jb, J_seg), (pb, P_seg)):
        compact_shapes(run, seg)
        churn(run)
    jstore = session_store(J_store, J_message, clock)
    mono[0] += 1.5
    topics = [t for _k, t, _c in batches(6)[1]]
    ja.broker.router.match_batch(topics)  # JAX's matcher: dropped when pickled

    path = str(tmp_path / "segments.pkl")
    meta = J_seg.SegmentStateSnapshot(path, capture=lambda: {
        "router": ja.broker.router, "subtab": ja.broker.subtab,
        "grouptab": ja.broker.grouptab, "session_store": jstore.capture()}).save()
    jrestored = J_store.SessionStore(capacity=64, sweep_slots=16, retry_interval=1.0,
                                     clock=clock)

    def j_install(state):
        jb.broker.router = state["router"]
        jb.broker.subtab = state["subtab"]
        jb.broker.grouptab = state["grouptab"]
        jrestored.install(state["session_store"])
        jb.broker._device = None

    J_seg.SegmentStateSnapshot(path, capture=dict, install=j_install).load(meta)

    state = convert.segment_state_from_reference(path, device="cpu")
    assert type(state["router"]).__module__ == "emqx_tpu_torch.broker.router"
    assert type(state["subtab"]) is P_router.SubscriberTable
    assert type(state["grouptab"]) is P_router.GroupTable
    assert state["router"]._matcher is None and state["router"].device == "cpu"
    prestored = P_store.SessionStore(capacity=64, sweep_slots=16, retry_interval=1.0,
                                     clock=clock, device="cpu")
    pb.broker.router = state["router"]
    pb.broker.subtab = state["subtab"]
    pb.broker.grouptab = state["grouptab"]
    prestored.install(state["session_store"])
    pb.broker._device = None
    assert tables(pb.broker, prestored.table) == tables(jb.broker, jrestored.table)
    assert pb.broker.router.match_batch(topics) == jb.broker.router.match_batch(topics)
    bs = batches(6)
    assert deliveries(pb, bs) == deliveries(jb, bs)
    mono[0] += 5.0
    assert redeliveries(prestored) == redeliveries(jrestored)


@pytest.mark.parametrize("mode", MODES)
def test_carried_across_from_objects_or_bytes(low_flip, mode):  # noqa: F811
    """The captured dict itself, or its pickle's bytes, convert as the
    file does."""
    ja = build(JAX, mode)
    churn(ja)
    cap = {"router": ja.broker.router, "subtab": ja.broker.subtab,
           "grouptab": ja.broker.grouptab}
    from_obj = convert.segment_state_from_reference(cap, device="cpu")
    from_bytes = convert.segment_state_from_reference(
        pickle.dumps(cap, protocol=pickle.HIGHEST_PROTOCOL), device="cpu")
    for st in (from_obj, from_bytes):
        assert sorted(st) == ["grouptab", "router", "subtab"]
        for k, v in ja.broker.subtab.device_snapshot().items():
            np.testing.assert_array_equal(st["subtab"].device_snapshot()[k], v, err_msg=k)
        assert st["router"].topics() == ja.broker.router.topics()


class _Evil:
    def __reduce__(self):
        return (print, ("refused",))


@pytest.mark.parametrize("payload", [
    {"router": _Evil()},
    {"groups": J_router.GroupTable()},  # mapped: allowed
    {"bad": J_message.Message(topic="t")},  # a message outside a session capture
])
def test_the_reference_unpickler_refuses_unmapped_classes(payload):
    data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    if "router" in payload:
        with pytest.raises(pickle.UnpicklingError, match="refused class builtins.print"):
            convert.segment_state_from_reference(data)
    else:
        out = convert.segment_state_from_reference(data)
        assert set(out) == set(payload)
    from emqx_tpu.mqtt import packet as J_packet

    with pytest.raises(pickle.UnpicklingError, match="refused class emqx_tpu.mqtt.packet"):
        convert.segment_state_from_reference(pickle.dumps({"m": J_packet.SubOpts()}))


def test_a_bound_method_outside_the_map_is_refused():
    data = pickle.dumps({"f": J_router.GroupTable().pack_fcap})
    assert callable(convert.segment_state_from_reference(data)["f"])
    with pytest.raises(pickle.UnpicklingError, match="refused getattr"):
        convert.segment_state_from_reference(
            pickle.dumps({"f": getattr(J_router.GroupTable(), "__init__")}))
