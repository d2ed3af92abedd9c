"""The port's serving step as a whole against the JAX package.

`shape_route_step` (port) against `shape_route_step_impl` (JAX) on the
same host tables and topic bytes, and the port's `DeviceRouter.route`
against emqx_tpu's `DeviceRouter.route` across seeded subscribe /
unsubscribe churn, overflow rows included. The port runs with
``device="cpu"`` (the kernels' plain twins). Tolerance: EXACT equality for
every output — all are integers.

The residual-NFA lane rides the same comparisons on a scaled-down
`mixed_10m` (its 66 shapes, a few hundred filters each): the step with
``with_nfa=True`` and the router across churn, with the mirrors' counters
held against the JAX router's. Also the guard rail: entry points refuse to
run without CUDA unless asked for the CPU.
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


def test_prepare_routes_residual_filters_like_jax():
    """`prepare` mirrors the NFA and routes residual filters as the JAX
    router does, on a 100-shape table (36 shapes past MAX_SHAPES)."""
    tabs = []
    for ri, st in ((P_ri.RouteIndex, P_router.SubscriberTable),
                   (J_ri.RouteIndex, J_router.SubscriberTable)):
        index, subs = ri(), st()
        for a in range(10):
            for b in range(10):
                subs.add(index.add("/".join(["+"] * a + ["x"] + ["y"] * b)), a)
        tabs.append((index, subs))
    (p_idx, p_subs), (j_idx, j_subs) = tabs
    assert p_idx.residual_count == j_idx.residual_count == 36
    p_router = P_router.DeviceRouter(p_idx, p_subs, PConfig(max_levels=16), device="cpu")
    args = p_router.prepare()
    assert args.nfa_tables is not None
    j_router = J_router.DeviceRouter(j_idx, j_subs, JConfig(max_levels=16))
    topics = ["/".join(["q"] * a + ["x"] + ["y"] * b) for a in range(10) for b in range(0, 10, 3)]
    topics += ["x/y", "$x/y", "x"]
    res = p_router.route(topics)
    assert_route_equal(res, j_router.route(topics))
    assert int((res.matched[:, p_idx.shapes.m_active():] >= 0).sum()) > 0


# -- the residual NFA lane: a scaled-down mixed_10m -------------------------

# the 66 shapes of chip_smoke's mixed_10m (bench.py `_build_mixed_10m`),
# at a few hundred filters per family; the last two families are residual
SMALL_IDS = (20, 50, 5, 40, 30, 20, 10)
# root wildcards, which only the residual lane holds here ($ topics skip them)
ROOT_WILD = ["#", "+/1/#", "+/+/+/+/+/+/+/+", "$SYS/#"]


def scaled_mixed_10m(seed):
    import chip_smoke

    rng = np.random.default_rng(seed)
    filters, families = chip_smoke.mixed_10m_filters(
        rng, ids=SMALL_IDS, total=20 + 100 + 64 * 150, residual_cap=150, min_family=10
    )
    residual = [filters[i] for _p, _d, lo, hi in families[62:] for i in range(lo, hi)]
    topics = chip_smoke.mixed_10m_topics(rng, 300, ids=SMALL_IDS)
    picks = [residual[i] for i in rng.integers(0, len(residual), size=200)]
    topics += chip_smoke.topics_from_filters(rng, picks, ids=SMALL_IDS)
    topics += ["", "$SYS/x", "$SYS/1/2", "$v/1/2/3", "v/1/2/3/4/5/6/7/8/9", "v/1//", "1/1/1"]
    return filters + ROOT_WILD, residual, topics


def mixed_twins(filters, max_subscribers=256):
    out = []
    for ri, st in ((P_ri.RouteIndex, P_router.SubscriberTable),
                   (J_ri.RouteIndex, J_router.SubscriberTable)):
        index, subs = ri(), st(max_subscribers=max_subscribers)
        fids = np.asarray(index.bulk_add(filters), np.int64)
        subs.bulk_add(np.repeat(fids, 2), np.arange(2 * len(fids)) % 64)
        assert index.shapes.m_active() == 64 and index.residual_count > 0
        out.append((index, subs))
    return out


@pytest.mark.parametrize("seed,kslot,frontier,max_matches", [(0, 64, 16, 16), (1, 8, 2, 2)])
def test_step_with_nfa_matches_jax(seed, kslot, frontier, max_matches):
    filters, _residual, topics = scaled_mixed_10m(seed)
    (_p, _ps), (j, subs) = mixed_twins(filters)
    bm, ln, _ = encode_topics(topics, 64)
    snap = j.shapes.device_snapshot()
    bits = subs.pack(j.num_filters_capacity)
    nfa = j.nfa.device_snapshot()
    m = j.shapes.m_active()
    cfg = dict(max_levels=8, frontier=frontier, max_matches=max_matches, probes=8, kslot=kslot)
    got = P_router.shape_route_step(
        convert.tables_to_device(snap, bits, device="cpu"), bm, ln, m_active=m,
        salt=j.salt, nfa_tables=convert.upload(nfa, device="cpu"), with_nfa=True,
        device="cpu", **cfg,
    )
    want = jax.jit(
        lambda st, nt, sb, bm, ln: J_router.shape_route_step_impl(
            st, nt, sb, bm, ln, m_active=m, with_nfa=True, salt=j.salt, **cfg
        )
    )(snap, nfa, bits, bm, ln)
    assert_step_equal(got, want, kslot)
    nfa_hits = got["matched"][:, m:] >= 0
    assert int(nfa_hits.sum()) > 50  # the residual lane really matches
    flags = got["flags"].numpy()
    assert flags[topics.index("v/1/2/3/4/5/6/7/8/9")]
    if frontier == 2:  # narrow caps: the NFA lane flags rows of its own
        assert flags.sum() > 10


def test_device_router_with_nfa_matches_jax_across_churn():
    filters, residual, topics = scaled_mixed_10m(2)
    (p_idx, p_subs), (j_idx, j_subs) = mixed_twins(filters)
    cfg = dict(max_levels=8, max_bytes=64, frontier=16, max_matches=16, probes=4)
    p_router = P_router.DeviceRouter(p_idx, p_subs, PConfig(**cfg), device="cpu")
    j_router = J_router.DeviceRouter(j_idx, j_subs, JConfig(**cfg))
    assert p_router.config.probes == 8  # clamped up to MAX_PROBES

    def both(fn):
        fn(p_idx, p_subs)
        fn(j_idx, j_subs)

    def route_both(extra=()):
        ts = topics + list(extra)
        p_res = p_router.route(ts)
        assert_route_equal(p_res, j_router.route(ts))
        j_status = {m.name: (m.full_resyncs, m.delta_launches, m.array_resyncs)
                    for m in (j_router._shape_sync, j_router._nfa_sync, j_router._bits_sync)}
        p_status = {k: (v["full_resyncs"], v["delta_launches"], v["array_resyncs"])
                    for k, v in p_router.segment_status().items()}
        assert p_status == j_status
        return p_res, p_status

    _, s0 = route_both()
    new = [f"v/+/{60 + k}/+/{k % 40}/{k % 30}/+/{k % 10}" for k in range(40)]
    new += [f"v/+/{60 + k}/{k % 5}/#" for k in range(40)]
    new_topics = [f"v/1/{60 + k}/2/{k % 40}/{k % 30}/3/{k % 10}" for k in range(40)]
    new_topics += [f"v/1/{60 + k}/{k % 5}/9" for k in range(40)]
    new_topics += [f"v/{a}/1/2/3/4/5/6" for a in range(3)]

    def subscribe(index, subs):
        for i, f in enumerate(new):
            subs.add(index.add(f), 64 + i)
        for a in range(3):
            fid = index.filter_id(f"v/{a}/#")
            for s in range(64, 164):
                subs.add(fid, s)

    both(subscribe)
    res, s1 = route_both(new_topics)
    assert s1["nfa"][0] == s0["nfa"][0] and s1["nfa"][1] > s0["nfa"][1]
    assert s1["bitmaps"][0] == s0["bitmaps"][0] and s1["bitmaps"][1] > s0["bitmaps"][1]
    assert res.overflow.any()

    def unsubscribe(index, subs):
        for i, f in enumerate(new):
            subs.remove(index.filter_id(f), 64 + i)
            index.remove(f)
        for a in range(3):
            fid = index.filter_id(f"v/{a}/#")
            for s in range(64, 164):
                subs.remove(fid, s)
        for f in residual[::3]:
            index.remove(f)

    both(unsubscribe)
    res, s2 = route_both(new_topics)
    assert not res.overflow.any()
    assert s2["nfa"][0] == s1["nfa"][0] and s2["nfa"][1] > s1["nfa"][1]

    def bump_nfa_epoch(index, subs):  # churn one filter past the op-log cap
        e0 = index.nfa.epoch
        while index.nfa.epoch == e0:
            index.add("v/+/99/+/1/1/+/1")
            index.remove("v/+/99/+/1/1/+/1")

    for idx in (p_idx, j_idx):
        idx.nfa.OPLOG_MAX = 512  # reach the cap in a few dozen cycles
    both(bump_nfa_epoch)
    _, s3 = route_both()
    assert s3["nfa"][0] == s2["nfa"][0] + 1 and s3["shapes"][0] == s2["shapes"][0]
    assert p_router.prepare() is p_router.prepare()  # clean: the cached args


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


# -- the CSR subscriber table and $share picks ------------------------------
#
# `share_10m_csr` of chip_smoke.py at a test's size: device/{i}/+/{j}/#
# filters with 8 subscribers each over a wide slot universe, device/{i}/#
# as the real filters of an `ingest` group per id and an `audit` group on
# the first ids.

N_IDS, N_NUMS, SPF = 30, 20, 8


def share_twins(mode="sparse"):
    filters = [f"device/{i}/+/{j}/#" for i in range(N_IDS) for j in range(N_NUMS)]
    filters += [f"device/{i}/#" for i in range(N_IDS)]
    out = []
    for ri, st, gt in ((P_ri.RouteIndex, P_router.SubscriberTable, P_router.GroupTable),
                       (J_ri.RouteIndex, J_router.SubscriberTable, J_router.GroupTable)):
        index = ri()
        subs = st(max_subscribers=1 << 12, mode=mode)
        groups = gt(gpf=4)
        fids = np.asarray(index.bulk_add(filters), np.int64)
        n = N_IDS * N_NUMS
        subs.bulk_add(np.repeat(fids[:n], SPF), np.arange(n * SPF) % 4096)
        for i in range(N_IDS):
            fid = index.filter_id(f"device/{i}/#")
            groups.set_len(groups.ensure_group(fid, f"device/{i}/#", "ingest"), 16)
            if i < 5:
                groups.set_len(groups.ensure_group(fid, f"device/{i}/#", "audit"), 4)
        out.append((index, subs, groups))
    return out


def share_topics(seed, n=300):
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.3, size=n) - 1, N_IDS - 1)
    nums = rng.integers(0, N_NUMS + 2, size=n)
    return EDGE_TOPICS + ["device/5", "device/0/x"] + [
        f"device/{i}/mid/{k}/leaf" for i, k in zip(ids, nums)]


@pytest.mark.parametrize("strategy", sorted(J_router.STRATEGY_IDS.values()))
@pytest.mark.parametrize("kslot,kg", [(64, 0), (4, 6)])
def test_step_with_csr_and_groups_matches_jax(strategy, kslot, kg):
    _, (j, subs, groups) = share_twins()
    topics = share_topics(strategy)
    bm, ln, _ = encode_topics(topics, 64)
    rng = np.random.default_rng(kslot)
    B = len(topics)
    ch, th, rand = (rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
                    for _ in range(3))
    subs.pack(j.num_filters_capacity)
    groups.pack_fcap(j.num_filters_capacity)
    snap = j.shapes.device_snapshot()
    csr = subs.device_snapshot()
    gsnap = groups.device_snapshot()
    m = j.shapes.m_active()
    cfg = dict(max_levels=8, kslot=kslot, kg=kg)
    tables = convert.upload({**snap, **csr}, device="cpu")
    got = P_router.shape_route_step(
        tables, bm, ln, m_active=m, salt=j.salt,
        group_tables=convert.upload(gsnap, device="cpu"), client_hash=ch,
        topic_hash=th, rand=rand, with_groups=True, share_strategy=strategy,
        device="cpu", **cfg,
    )
    want = jax.jit(
        lambda st, sb, gt, bm, ln, ch, th, rd: J_router.shape_route_step_impl(
            st, None, sb, bm, ln, gt, ch, th, rd, m_active=m, with_nfa=False,
            salt=j.salt, with_groups=True, share_strategy=strategy, **cfg,
        )
    )(snap, csr, gsnap, bm, ln, ch, th, rand)
    assert got["bitmaps"] is None and want["bitmaps"] is None
    for k in KEYS + ("pick_gid", "pick_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, v in want["stats"].items():
        assert int(got["stats"][k]) == int(v), k
    assert (got["pick_gid"] >= 0).sum() > 200
    if kslot == 4:  # 8 subscribers per row: every matched row overflows
        assert bool(got["overflow"].any())


def assert_picks_equal(p_res, j_res):
    assert (p_res.picks is None) == (j_res.picks is None)
    if j_res.picks is not None:
        for a, b in zip(p_res.picks, j_res.picks):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["round_robin", "random", "sticky"])
def test_device_router_with_csr_and_groups_matches_jax_across_churn(strategy):
    import chip_smoke  # advance_rr: the broker's round-robin base update

    (p_idx, p_subs, p_grp), (j_idx, j_subs, j_grp) = share_twins()
    cfg = dict(max_levels=8, max_bytes=64)
    p_router = P_router.DeviceRouter(p_idx, p_subs, PConfig(**cfg), grouptab=p_grp,
                                     share_strategy=strategy, device="cpu")
    j_router = J_router.DeviceRouter(j_idx, j_subs, JConfig(**cfg), grouptab=j_grp,
                                     share_strategy=strategy)
    tabs = ((p_idx, p_subs, p_grp), (j_idx, j_subs, j_grp))
    topics = share_topics(7)

    def both(fn):
        for t in tabs:
            fn(*t)

    def route_both(extra=()):
        ts = topics + list(extra)
        p_res, j_res = p_router.route(ts), j_router.route(ts)
        assert_route_equal(p_res, j_res)
        assert_picks_equal(p_res, j_res)
        if strategy == "round_robin":
            chip_smoke.advance_rr(p_grp, p_res.picks)
            chip_smoke.advance_rr(j_grp, j_res.picks)
        return p_res

    res = route_both()
    assert p_router.prepare().kslot == 64 and "csr_slots" in p_router.prepare().tables
    assert (res.picks[0] >= 0).sum() > 200
    route_both()  # the advanced round-robin bases reach the device

    def hot_subscribe(index, subs, groups):  # the hot segment; rows pass kslot
        fid = index.filter_id("device/3/#")
        for s in range(100):
            subs.add(fid, 1000 + s)
        for k in range(5):
            subs.add(index.add(f"device/{k}/mid/+/leaf"), 2000 + k)

    both(hot_subscribe)
    res = route_both(["device/3/mid/1/leaf"] * 5)
    assert res.overflow.any() and isinstance(res.dense_rows, P_router._LazyDenseRows)

    def unsubscribe(index, subs, groups):  # tombstones in packed and hot
        for i in range(0, N_IDS * N_NUMS, 3):
            for s in range(2):
                subs.remove(i, (i * SPF + s) % 4096)
        fid = index.filter_id("device/3/#")
        for s in range(0, 100, 2):
            subs.remove(fid, 1000 + s)

    both(unsubscribe)
    route_both()

    def gather_overflow(index, subs, groups):  # a packed region past kg
        subs.csr.HOT_SERVE_MAX = 40
        fid = index.filter_id("device/4/#")
        for s in range(200):
            subs.add(fid, 3000 + s)

    both(gather_overflow)
    res = route_both(["device/4/mid/1/leaf"] * 3)
    assert p_subs.csr.max_region >= 200  # absorbed at prepare
    ovf = [i for i in res.dense_index if int(res.slot_count[i]) > 128]
    assert ovf

    def group_churn(index, subs, groups):
        groups.set_len(groups.gid_of("device/0/#", "ingest"), 3)
        groups.set_len(groups.gid_of("device/1/#", "ingest"), 0)  # empty
        groups.drop_group(index.filter_id("device/2/#"), "device/2/#", "audit")
        groups.set_sticky(groups.gid_of("device/0/#", "audit"), 2)
        groups.set_sticky(groups.gid_of("device/3/#", "ingest"), 40)  # out of range

    both(group_churn)
    route_both()
    status = p_router.segment_status()
    assert set(status) == {"shapes", "nfa", "bitmaps", "groups"}
    assert status["groups"]["delta_launches"] > 0
    assert p_router.prepare() is p_router.prepare()


def test_device_router_follows_a_flip_like_jax():
    (p_idx, p_subs, p_grp), (j_idx, j_subs, j_grp) = share_twins(mode="dense")
    cfg = dict(max_levels=8, max_bytes=64)
    p_router = P_router.DeviceRouter(p_idx, p_subs, PConfig(**cfg), grouptab=p_grp,
                                     device="cpu")
    j_router = J_router.DeviceRouter(j_idx, j_subs, JConfig(**cfg), grouptab=j_grp)
    topics = share_topics(3)

    def route_both():
        p_res, j_res = p_router.route(topics), j_router.route(topics)
        assert_route_equal(p_res, j_res)
        assert_picks_equal(p_res, j_res)
        return p_res

    dense = route_both()
    assert "sub_bitmaps" in p_router.prepare().tables
    bits0 = p_router._bits_sync
    for subs in (p_subs, j_subs):
        subs.set_mode("sparse")
    sparse = route_both()
    assert p_router._bits_sync is not bits0
    assert p_router.segment_status()["bitmaps"] == {
        "full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0}
    assert set(p_router.prepare().tables) >= set(P_router.CSR_KEYS)
    assert recipients(dense) == recipients(sparse)
    for subs in (p_subs, j_subs):
        subs.set_mode("dense")
    assert recipients(route_both()) == recipients(dense)
