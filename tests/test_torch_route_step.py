"""The port's serving step as a whole against the JAX package.

`shape_route_step` (port) against `shape_route_step_impl` (JAX) on the
same host tables and topic bytes, and the port's `DeviceRouter.route`
against emqx_tpu's `DeviceRouter.route` across seeded subscribe /
unsubscribe churn, overflow rows included. The port runs with
``device="cpu"`` (the kernels' plain twins). Tolerance: EXACT equality for
every output — all are integers.

Also the guard rails: residual filters raise instead of routing elsewhere,
and entry points refuse to run without CUDA unless asked for the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops.matcher import MatcherConfig as JConfig
from emqx_tpu.ops.tokenizer import encode_topics
from emqx_tpu_torch import convert
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops.matcher import MatcherConfig as PConfig

KEYS = ("matched", "mcount", "flags", "slots", "slot_count", "overflow")
EDGE_TOPICS = ["", "$SYS/broker/x", "a/b/c/d/e/f/g/h/i/j", "device/3/mid/5/"]


def j_step(kslot, m_active, salt, max_levels=8):
    return jax.jit(
        lambda st, sb, bm, ln: J_router.shape_route_step_impl(
            st, None, sb, bm, ln, m_active=m_active, with_nfa=False, salt=salt,
            max_levels=max_levels, kslot=kslot,
        )
    )


def assert_step_equal(got, want, kslot):
    keys = KEYS if kslot else KEYS[:3]
    assert set(got) == {"matched", "mcount", "flags", "bitmaps", "stats"} | set(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["bitmaps"].numpy().view(np.uint32),
                                  np.asarray(want["bitmaps"]))
    for k, v in want["stats"].items():
        assert int(got["stats"][k]) == int(v), k


def port_workload():
    """`__graft_entry__._workload()` built with the port's own classes."""
    index = P_ri.RouteIndex()
    subs = P_router.SubscriberTable(max_subscribers=512)
    for i in range(96):
        subs.add(index.add(f"device/{i % 16}/+/t{i}/#"), i % 512)
    subs.add(index.add("$SYS/#"), 0)
    return index, subs


@pytest.mark.parametrize("kslot", [0, 64])
@pytest.mark.parametrize("builder", ["jax", "port"])
def test_step_matches_jax_on_entry_workload(kslot, builder):
    index, subs, bm, ln, m = G._workload()
    if builder == "port":
        p_index, p_subs = port_workload()
    else:
        p_index, p_subs = index, subs
    snap = p_index.shapes.device_snapshot()
    bits = p_subs.pack(p_index.num_filters_capacity)
    tables = convert.tables_to_device(snap, bits, device="cpu")
    got = P_router.shape_route_step(
        tables, bm, ln, m_active=p_index.shapes.m_active(), salt=p_index.salt,
        max_levels=8, kslot=kslot, device="cpu",
    )
    want = j_step(kslot, m, index.salt)(
        index.shapes.device_snapshot(), subs.pack(index.num_filters_capacity), bm, ln
    )
    assert_step_equal(got, want, kslot)
    assert int(got["stats"]["routed"]) == len(ln)


def bench_shape(seed, n_ids=60, n_nums=30, heavy=20):
    """Seeded `device/{id}/+/{num}/#` table (the reference bench shape) plus
    `device/{id}/#` overlays, the first of which carry many subscribers so
    their rows pass kslot."""
    rng = np.random.default_rng(seed)
    filters = [f"device/{i}/+/{j}/#" for i in range(n_ids) for j in range(n_nums)]
    filters += [f"device/{i}/#" for i in range(10)]
    j = J_ri.RouteIndex()
    subs = J_router.SubscriberTable(max_subscribers=512)
    fids = np.asarray(j.bulk_add(filters))
    subs.bulk_add(fids, rng.integers(0, 512, size=len(fids)))
    for s in range(heavy * 4):
        subs.add(int(fids[len(filters) - 10 + s % 3]), s * 5 % 512)
    ids = np.minimum(rng.zipf(1.3, size=500) - 1, n_ids - 1)
    nums = rng.integers(0, n_nums + 3, size=500)  # some miss every filter
    topics = EDGE_TOPICS + [f"device/{i}/mid/{k}/leaf" for i, k in zip(ids, nums)]
    return j, subs, topics


@pytest.mark.parametrize("seed,kslot", [(0, 8), (1, 64), (2, 1024)])
def test_step_matches_jax_on_bench_shape(seed, kslot):
    j, subs, topics = bench_shape(seed)
    bm, ln, _ = encode_topics(topics, 64)
    snap = j.shapes.device_snapshot()
    bits = subs.pack(j.num_filters_capacity)
    tables = convert.tables_to_device(snap, bits, device="cpu")
    got = P_router.shape_route_step(
        tables, bm, ln, m_active=j.shapes.m_active(), salt=j.salt, max_levels=8,
        kslot=kslot, device="cpu",
    )
    want = j_step(kslot, j.shapes.m_active(), j.salt)(snap, bits, bm, ln)
    assert_step_equal(got, want, kslot)
    if kslot < 64:
        assert bool(got["overflow"].any())


def slot_set(row):
    bits = np.unpackbits(np.ascontiguousarray(row).view(np.uint8), bitorder="little")
    return set(np.nonzero(bits)[0].tolist())


def recipients(res):
    out = []
    for i in range(len(res.mcount)):
        if res.slots is None:
            out.append(slot_set(res.bitmaps[i]))
        elif res.overflow[i]:
            out.append(slot_set(res.dense_rows[res.dense_index[i]]))
        else:
            out.append(set(res.slots[i][res.slots[i] >= 0].tolist()))
    return out


def assert_route_equal(p_res, j_res):
    for k in ("matched", "mcount", "flags"):
        np.testing.assert_array_equal(getattr(p_res, k), getattr(j_res, k), err_msg=k)
    assert (p_res.slots is None) == (j_res.slots is None)
    if j_res.slots is not None:
        for k in ("slots", "slot_count", "overflow"):
            np.testing.assert_array_equal(getattr(p_res, k), getattr(j_res, k), err_msg=k)
        assert p_res.dense_index == j_res.dense_index
        if j_res.dense_rows is not None:
            np.testing.assert_array_equal(p_res.dense_rows, j_res.dense_rows)
    assert recipients(p_res) == recipients(j_res)


def twin_tables(filters, max_subscribers):
    rng = np.random.default_rng(len(filters))
    slots = rng.integers(0, max_subscribers, size=len(filters))
    out = []
    for ri, st in ((P_ri.RouteIndex, P_router.SubscriberTable),
                   (J_ri.RouteIndex, J_router.SubscriberTable)):
        index, subs = ri(), st(max_subscribers=max_subscribers)
        subs.bulk_add(index.bulk_add(filters), slots)
        out.append((index, subs))
    return out


@pytest.mark.parametrize("max_subscribers", [256, 32])
def test_device_router_matches_jax_across_churn(max_subscribers):
    filters = [f"device/{i}/+/{j}/#" for i in range(40) for j in range(25)]
    filters += [f"device/{i}/#" for i in range(10)]
    (p_idx, p_subs), (j_idx, j_subs) = twin_tables(filters, max_subscribers)
    cfg = dict(max_levels=8, max_bytes=64)
    p_router = P_router.DeviceRouter(p_idx, p_subs, PConfig(**cfg), device="cpu")
    j_router = J_router.DeviceRouter(j_idx, j_subs, JConfig(**cfg))
    rng = np.random.default_rng(max_subscribers)
    ids = np.minimum(rng.zipf(1.3, size=180) - 1, 39)
    nums = rng.integers(0, 25, size=180)
    topics = EDGE_TOPICS + [f"device/{i}/mid/{k}/leaf" for i, k in zip(ids, nums)]
    topics += [f"device/3/mid/{k}/leaf" for k in range(10)]

    def both(fn):
        fn(p_idx, p_subs)
        fn(j_idx, j_subs)

    def route_both():
        p_res, j_res = p_router.route(topics), j_router.route(topics)
        assert_route_equal(p_res, j_res)
        return p_res

    route_both()

    def subscribe_overlay(index, subs):  # 100 subscribers: rows pass kslot
        fid = index.add("device/3/#")
        for s in range(100):
            subs.add(fid, s % max_subscribers)

    both(subscribe_overlay)
    res = route_both()
    if max_subscribers > 64:
        assert res.overflow.any()
    else:
        assert res.slots is None  # W*32 <= kslot: dense readback

    def warm_adds(index, subs):  # hot-overlay filters + new subscribers
        for k in range(30):
            subs.add(index.add(f"device/{k}/mid/+/leaf"), (k * 7) % max_subscribers)

    both(warm_adds)
    route_both()

    def unsubscribe(index, subs):  # tombstones + cleared bits
        fid = index.filter_id("device/3/#")
        for s in range(100):
            subs.remove(fid, s % max_subscribers)
        index.remove("device/3/#")
        for k in range(0, 30, 2):
            index.remove(f"device/{k}/mid/+/leaf")
        for f in filters[::7]:
            index.remove(f)

    both(unsubscribe)
    res = route_both()
    if res.overflow is not None:
        assert not res.overflow.any()
    assert p_router._prep_key == p_router._version_key()
    # clean tables: prepare hands back the cached upload
    assert p_router.prepare() is p_router.prepare()


def test_tables_to_device_copies_bits_exactly():
    snap = {k: np.zeros(4 * 1024 if k in ("shape_tab", "shape_hot") else 64, np.int32)
            for k in ("shape_tab", "shape_hot", "shape_mask", "shape_len", "shape_flags")}
    snap["shape_tomb"] = np.array([0xFFFFFFFF, 0x80000000, 1] + [0] * 29, np.uint32)
    bits = np.array([[0xDEADBEEF, 7]], np.uint32)
    t = convert.tables_to_device(snap, bits, device="cpu")
    np.testing.assert_array_equal(t["shape_tomb"].numpy().view(np.uint32), snap["shape_tomb"])
    np.testing.assert_array_equal(t["sub_bitmaps"].numpy().view(np.uint32), bits)
    assert all(v.dtype == torch.int32 for v in t.values())
    bits[0, 0] = 0  # the upload is a copy, not a view of live host arrays
    assert t["sub_bitmaps"][0, 0].item() == np.int32(np.uint32(0xDEADBEEF))
    with pytest.raises(TypeError, match="int32 or uint32"):
        convert.tables_to_device(snap, bits.astype(np.int64), device="cpu")


def test_prepare_raises_on_residual_filters():
    index = P_ri.RouteIndex()
    subs = P_router.SubscriberTable()
    for a in range(10):
        for b in range(10):  # 100 shapes: 36 past MAX_SHAPES are residual
            subs.add(index.add("/".join(["+"] * a + ["x"] + ["y"] * b)), a)
    assert index.residual_count == 36
    router = P_router.DeviceRouter(index, subs, device="cpu")
    with pytest.raises(NotImplementedError, match="batch_match_syms"):
        router.prepare()
    with pytest.raises(NotImplementedError, match="residual"):
        router.route(["x/y"])


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index, subs = port_workload()
    snap = index.shapes.device_snapshot()
    bits = subs.pack(index.num_filters_capacity)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_router.DeviceRouter(index, subs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.tables_to_device(snap, bits)
    tables = convert.tables_to_device(snap, bits, device="cpu")
    bm, ln, _ = encode_topics(["device/1/x/t1/y"], 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_router.shape_route_step(tables, bm, ln, m_active=4, salt=0)
