"""The port's CSR subscriber table against the JAX package.

The host `CsrTable` and the sparse `SubscriberTable` of `emqx_tpu_torch`
against `emqx_tpu`'s after the same seeded operations (bulk load, adds
into the hot segment and its growth, removes that tombstone packed and hot
lanes, the serve-time absorb, a compaction cycle with racing mutations,
the `auto` flip and `set_mode` both ways): device snapshots, registry
arrays, op-logs and counters must be byte-identical, and the device
mirrors of the CSR and group tables must track churn as the JAX mirrors
do. Then the plain twin
of `sparse_fanout_slots` against the JAX function on seeded tables with
holes, tombstones, zero-length regions, a hot segment, kslot overflow,
gather-window overflow and fids at and past Fcap (clamped, as JAX's
gathers clamp), and (`cuda` marker, skipped without a card) the
CUDA kernel against the twin. Tolerance: EXACT equality everywhere — every
output is an integer.
"""

import jax
import numpy as np
import pytest
import torch

from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import csr_table as J_csr
from emqx_tpu.ops import segments as J_seg
from emqx_tpu_torch import kernels
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import csr_table as P_csr
from emqx_tpu_torch.ops import segments as P_seg


def assert_same_csr(p, j):
    for k, v in j.device_snapshot().items():
        got = p.device_snapshot()[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    np.testing.assert_array_equal(p._reg_key, j._reg_key)
    np.testing.assert_array_equal(p._reg_pos, j._reg_pos)
    for attr in ("live", "packed_tombs", "hot_tombs", "max_slot", "_fcap", "_pcap",
                 "_hcap", "_hot_tail", "_reg_cap", "_reg_live", "_reg_fill",
                 "_structure_gen", "hot_fill", "max_region", "nbytes"):
        assert getattr(p, attr) == getattr(j, attr), attr


class Log:
    """The owner callbacks of a CsrTable, recorded."""

    def __init__(self):
        self.ops = []
        self.bumps = 0

    def kw(self):
        return dict(log=lambda n, i, v: self.ops.append((n, int(i), int(v))),
                    log_resync=lambda n: self.ops.append(("resync", n)),
                    bump=self.bump)

    def bump(self):
        self.bumps += 1
        self.ops.append(("bump",))


def both(fn, p, j):
    a, b = fn(p), fn(j)
    assert a == b
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_table_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pl, jl = Log(), Log()
    p, j = P_csr.CsrTable(**pl.kw()), J_csr.CsrTable(**jl.kw())
    fids = rng.integers(0, 500, 4000)
    slots = rng.integers(0, 1 << 20, 4000)
    fids[:50], slots[:50] = fids[50:100], slots[50:100]  # duplicate pairs
    p.bulk_add(fids, slots)
    j.bulk_add(fids, slots)
    assert_same_csr(p, j)
    # adds: new fids past fcap, hot growth past HOT_MIN, repeats
    for f, s in zip(rng.integers(0, 1500, 700), rng.integers(0, 1 << 20, 700)):
        both(lambda t: t.add(int(f), int(s)), p, j)
    both(lambda t: t.add(int(fids[7]), int(slots[7])), p, j)  # already live
    assert p._hcap > P_csr.CsrTable.HOT_MIN
    # removes: packed tombstones, hot tombstones, absent pairs
    for f, s in zip(fids[::9], slots[::9]):
        both(lambda t: t.remove(int(f), int(s)), p, j)
    hot = np.nonzero(p.hot_fid[0] >= 0)[0][::3]
    for h in hot:
        f, s = int(p.hot_fid[0, h]), int(p.hot_slot[0, h])
        assert both(lambda t: t.remove(f, s), p, j)
    assert not both(lambda t: t.remove(10**6, 3), p, j)
    both(lambda t: t.pack(5000), p, j)
    assert_same_csr(p, j)
    for f in (0, int(fids[3]), 1499, 10**6):
        np.testing.assert_array_equal(p.slots_of(f), j.slots_of(f))
    for a, b in zip(p.live_pairs(), j.live_pairs()):
        np.testing.assert_array_equal(a, b)
    # serve-time absorb, at a bound low enough to reach here
    for t in (p, j):
        t.HOT_SERVE_MAX = 100
    assert both(lambda t: t.maybe_absorb(), p, j)
    assert_same_csr(p, j)
    # a compaction cycle with mutations racing the build (journal replay)
    caps = [t.begin_compact() for t in (p, j)]
    for f, s in zip(rng.integers(0, 600, 50), rng.integers(0, 1 << 20, 50)):
        both(lambda t: t.add(int(f), int(s)), p, j)
    both(lambda t: t.remove(int(fids[11]), int(slots[11])), p, j)
    built_p = P_csr.CsrTable.build_compact(caps[0])
    built_j = J_csr.CsrTable.build_compact(caps[1])
    assert p.apply_compact(built_p) and j.apply_compact(built_j)
    assert_same_csr(p, j)
    # a capture invalidated by a structural rebuild aborts
    caps = [t.begin_compact() for t in (p, j)]
    p.bulk_add([1], [2])
    j.bulk_add([1], [2])
    assert not p.apply_compact(P_csr.CsrTable.build_compact(caps[0]))
    assert not j.apply_compact(J_csr.CsrTable.build_compact(caps[1]))
    assert_same_csr(p, j)
    assert pl.ops == jl.ops and pl.bumps == jl.bumps


def test_bulk_add_takes_arrays_not_tuples():
    """The port's bulk load hands its arrays to `_build` whole; the table it
    builds equals the JAX table's, whose load goes through a tuple list."""
    rng = np.random.default_rng(5)
    fids = np.repeat(np.arange(20_000, dtype=np.int64), 8)
    slots = np.arange(len(fids), dtype=np.int64) % (1 << 20)
    order = rng.permutation(len(fids))
    p, j = P_csr.CsrTable(), J_csr.CsrTable()
    p.bulk_add(fids[order], slots[order])
    j.bulk_add(fids[order], slots[order])
    assert_same_csr(p, j)
    assert p.live == 160_000 and p.csr_slots.shape == (1, 1 << 18)


def assert_same_subtab(p, j):
    assert (p.version, p.epoch, p.live, p.width_words, p.flips, p.mode, p.sparse) == (
        j.version, j.epoch, j.live, j.width_words, j.flips, j.mode, j.sparse)
    assert p.oplog == j.oplog
    ps, js = p.device_snapshot(), j.device_snapshot()
    assert sorted(ps) == sorted(js)
    for k in js:
        assert ps[k].dtype == js[k].dtype
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)
    assert p.table_bytes() == j.table_bytes()
    if j.sparse:
        assert_same_csr(p.csr, j.csr)


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_subscriber_table_matches_jax(seed):
    rng = np.random.default_rng(seed)
    p = P_router.SubscriberTable(max_subscribers=256, mode="sparse")
    j = J_router.SubscriberTable(max_subscribers=256, mode="sparse")
    assert p.sparse and p.arr is None
    tabs = (p, j)

    def each(fn):
        for t in tabs:
            fn(t)
        assert_same_subtab(p, j)

    fids = rng.integers(0, 400, 3000)
    slots = rng.integers(0, 5000, 3000)
    each(lambda t: t.bulk_add(fids, slots))
    adds = list(zip(rng.integers(0, 900, 300).tolist(), rng.integers(0, 9000, 300).tolist()))
    each(lambda t: [t.add(f, s) for f, s in adds])
    each(lambda t: [t.remove(int(f), int(s)) for f, s in zip(fids[::7], slots[::7])])
    each(lambda t: t.pack(4096))
    for f in (0, 5, 399, 899, 5000):
        rows = [np.zeros(p.width_words, np.uint32) for _ in tabs]
        for t, row in zip(tabs, rows):
            t.fill_row_bits(f, row)
        np.testing.assert_array_equal(*rows)
    each(lambda t: t.set_mode("dense"))  # CSR -> dense
    each(lambda t: t.add(7, 11))
    each(lambda t: t.set_mode("sparse"))  # dense -> CSR
    each(lambda t: t.add(7, 12))


def test_auto_mode_flips_once_like_jax():
    p = P_router.SubscriberTable(max_subscribers=64, mode="auto")
    j = J_router.SubscriberTable(max_subscribers=64, mode="auto")
    for t in (p, j):
        t.AUTO_MIN_DENSE_BYTES = 1 << 20  # reachable at a test's size
    rng = np.random.default_rng(3)
    for f, s in zip(rng.integers(0, 6000, 400), rng.integers(0, 4096, 400)):
        p.add(int(f), int(s))
        j.add(int(f), int(s))
    assert p.sparse and p.flips == 1
    assert_same_subtab(p, j)
    for f, s in zip(rng.integers(0, 9000, 100), rng.integers(0, 4000, 100)):
        p.add(int(f), int(s))
        j.add(int(f), int(s))
    assert_same_subtab(p, j)


def test_more_than_one_shard_is_refused():
    """More than one shard is the mesh's CSR layout (subscription -> shard
    slot % S), no longer refused: a table built sharded and a live table
    resharded (`CsrTable.reshard`, an epoch-bump rebuild) equal JAX's."""
    tabs = []
    for R in (P_router, J_router):
        a = R.SubscriberTable(mode="sparse", shards=2)
        b = R.SubscriberTable(mode="sparse")
        for t in (a, b):
            for f, s in ((3, 700), (9, 5), (9, 6), (40, 1023)):
                t.add(f, s)
        b.set_shards(1)  # unchanged: no rebuild
        e0 = b.epoch
        b.set_shards(4)
        assert b.epoch == e0 + 1 and b.shards == 4 and b.csr.shards == 4
        a.remove(9, 5)
        tabs.append((a, b))
    for p, j in zip(*tabs):
        assert (p.shards, p.epoch, p.version, p.oplog) == (j.shards, j.epoch, j.version, j.oplog)
        for k, v in j.device_snapshot().items():
            np.testing.assert_array_equal(p.device_snapshot()[k], v, err_msg=k)
        assert p.device_snapshot()["csr_slots"].shape[0] == p.shards


def assert_mirror(out, src):
    snap = src.device_snapshot()
    assert set(out) == set(snap)
    for k, v in snap.items():
        assert out[k].dtype == torch.int32 and tuple(out[k].shape) == v.shape, k
        np.testing.assert_array_equal(out[k].numpy().view(v.dtype), v, err_msg=k)


def counters(man):
    return (man.full_resyncs, man.delta_launches, man.array_resyncs)


def test_segment_manager_mirrors_csr_and_group_tables_like_jax():
    """`convert.upload` carries the [S, F] / [S, P] CSR arrays and the group
    arrays unchanged, and the port's manager replays their flat-index
    writes and `!resync` markers (hot growth) as the JAX manager does."""
    rng = np.random.default_rng(4)
    subs = (P_router.SubscriberTable(max_subscribers=1 << 12, mode="sparse"),
            J_router.SubscriberTable(max_subscribers=1 << 12, mode="sparse"))
    grps = (P_router.GroupTable(), J_router.GroupTable())
    sub_mans = (P_seg.DeviceSegmentManager(device="cpu"), J_seg.DeviceSegmentManager())
    grp_mans = (P_seg.DeviceSegmentManager(device="cpu"), J_seg.DeviceSegmentManager())
    fids = rng.integers(0, 200, 2000)
    slots = rng.integers(0, 4096, 2000)
    for t in subs:
        t.bulk_add(fids, slots)
    for step in range(8):
        adds = list(zip(rng.integers(0, 260, 90).tolist(), rng.integers(0, 4096, 90).tolist()))
        gone = list(zip(fids[step::11].tolist(), slots[step::11].tolist()))
        gops = [(int(rng.integers(0, 260)), f"g{int(rng.integers(0, 40))}",
                 int(rng.integers(0, 9))) for _ in range(10)]
        for t in subs:
            for f, s_ in adds:
                t.add(f, s_)
            for f, s_ in gone:
                t.remove(f, s_)
            t.pack(512)
        for g in grps:
            for fid, name, n in gops:
                gid = g.ensure_group(fid, f"r{fid}", name)
                g.set_len(gid, n)
                g.set_rr(gid, (1 << 31) - n)
            if step == 5:
                g.drop_group(gops[0][0], f"r{gops[0][0]}", gops[0][1])
        assert_mirror(sub_mans[0].sync(subs[0]), subs[0])
        sub_mans[1].sync(subs[1])
        assert_mirror(grp_mans[0].sync(grps[0]), grps[0])
        grp_mans[1].sync(grps[1])
        assert counters(sub_mans[0]) == counters(sub_mans[1]), step
        assert counters(grp_mans[0]) == counters(grp_mans[1]), step
    assert sub_mans[0].array_resyncs >= 2  # hot growth: !resync markers
    assert sub_mans[0].delta_launches >= 5 and grp_mans[0].delta_launches >= 5


# -- kernel 8: the twin against the JAX function ---------------------------


def seeded_csr(seed, n_fids=300, spf=6, hot=150):
    """A JAX CsrTable with zero-length regions (fids never subscribed),
    packed tombstones, a hot segment with tombstones, and a few long
    regions (for gather-window overflow)."""
    rng = np.random.default_rng(seed)
    fids = np.repeat(np.arange(0, n_fids, 2, dtype=np.int64), spf)  # odd fids: empty
    slots = rng.integers(0, 1 << 20, len(fids))
    long_f = np.repeat(np.array([4, 10], np.int64), 200)
    t = J_csr.CsrTable()
    t.bulk_add(np.concatenate([fids, long_f]),
               np.concatenate([slots, rng.integers(0, 1 << 20, 400)]))
    for f, s in zip(fids[::5], slots[::5]):
        t.remove(int(f), int(s))
    for f, s in zip(rng.integers(0, n_fids + 20, hot), rng.integers(0, 1 << 20, hot)):
        t.add(int(f), int(s))
    hf = np.nonzero(t.hot_fid[0] >= 0)[0]
    for h in hf[::4]:
        t.remove(int(t.hot_fid[0, h]), int(t.hot_slot[0, h]))
    return t, rng


def seeded_matched(rng, B, K, n_fids):
    m = rng.integers(0, n_fids + 20, size=(B, K)).astype(np.int32)
    m[rng.random((B, K)) < 0.3] = -1  # holes anywhere
    m[0] = -1  # a row of holes only
    if K >= 2:
        m[1, :2] = [4, 10]  # two long regions: gather-window overflow
        m[2, 0] = m[2, 1] = 8  # one fid twice: duplicates in the row
    return m


def twin(csr_np, matched, kslot, kg):
    csr = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in csr_np.items()}
    return P_csr.sparse_fanout_slots(csr, torch.from_numpy(matched), kslot, kg)


@pytest.mark.parametrize("seed,K,kslot,kg", [
    (0, 4, 64, 0), (1, 6, 8, 0), (2, 3, 16, 24), (3, 8, 256, 0), (4, 1, 4, 0),
])
def test_sparse_fanout_twin_matches_jax(seed, K, kslot, kg):
    t, rng = seeded_csr(seed)
    snap = t.device_snapshot()
    matched = seeded_matched(rng, 200, K, 300)
    want = jax.jit(lambda c, m: J_csr.sparse_fanout_slots(c, m, kslot, kg))(snap, matched)
    got = twin(snap, matched, kslot, kg)
    assert len(got) == 4
    for name, g, w in zip(("slots", "count", "overflow", "live"), got, want):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    slots, count, overflow, live = (x.numpy() for x in got)
    if K >= 2:
        assert overflow[1] and count[1] > kslot  # the gather window overflowed
    assert count[0] == live[0] == 0 and (slots[0] == -1).all()
    if kslot <= 16:
        assert (overflow & (live > kslot)).any()  # kslot overflow
    if K >= 2 and kslot >= 64:  # the duplicates became -1 mid-row
        row = slots[2]
        assert (row[1:] < 0).any() and (row[np.argmax(row >= 0):] < 0).any()


def hot_heavy_csr(seed, table, hot=1024):
    """A CsrTable of `table`'s class whose hot segment holds `hot` pairs: a
    quarter of them on one fid (6), the rest on random fids, every third
    then tombstoned; its packed part leaves the odd fids empty, so their
    zero-length regions tie their successor's start."""
    rng = np.random.default_rng(seed)
    t = table()
    fids = np.repeat(np.arange(0, 200, 2, dtype=np.int64), 3)
    t.bulk_add(fids, rng.integers(0, 1 << 20, len(fids)))
    hf = np.concatenate([np.full(hot // 4, 6), rng.integers(0, 220, hot - hot // 4)])
    hs = rng.choice(1 << 20, hot, replace=False)
    for f, s_ in zip(hf, hs):
        assert t.add(int(f), int(s_))
    for f, s_ in zip(hf[::3], hs[::3]):
        assert t.remove(int(f), int(s_))
    return t, rng


def hot_heavy_matched(rng, B, K, fcap):
    """Rows that pair an empty (odd) fid with its successor, hold fid 6 (the
    repeated hot fid), holes, and fids at and past fcap."""
    m = rng.integers(0, 220, size=(B, K)).astype(np.int32)
    m[rng.random((B, K)) < 0.2] = -1
    m[0::7, 0] = 2 * rng.integers(0, 100, len(m[0::7])) + 1  # empty, ties the next
    m[0::7, 1 % K] = m[0::7, 0] + 1
    m[1::5, K - 1] = 6
    m[2::11, 0] = fcap
    m[3::13, K - 1] = fcap + 1 + rng.integers(0, 1 << 20, len(m[3::13]))
    m[4, :] = np.int32(2**31 - 1)
    return m


@pytest.mark.parametrize("seed,K,kslot,kg", [(5, 4, 64, 128), (6, 4, 8, 0), (7, 2, 32, 16)])
def test_sparse_fanout_twin_matches_jax_on_a_hot_heavy_table(seed, K, kslot, kg):
    """A hot segment of 1,024 pairs with one fid repeated and tombstones,
    zero-length regions tying their successor and fids at and past fcap
    (both gathers clamp, as JAX's do)."""
    t, rng = hot_heavy_csr(seed, J_csr.CsrTable)
    snap = t.device_snapshot()
    assert snap["hot_fid"].shape[1] == 1024 and (snap["hot_fid"] == -1).sum() >= 1024 // 3
    fcap = snap["csr_off"].shape[1]
    matched = hot_heavy_matched(rng, 300, K, fcap)
    want = jax.jit(lambda c, m: J_csr.sparse_fanout_slots(c, m, kslot, kg))(snap, matched)
    got = twin(snap, matched, kslot, kg)
    for name, g, w in zip(("slots", "count", "overflow", "live"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    holds6 = (matched == 6).any(axis=1)
    assert holds6.sum() > 30 and got[3].numpy()[holds6].min() > 0  # fid 6's hot pairs


def test_sparse_fanout_wrapper_checks():
    t, rng = seeded_csr(0)
    csr = {k: torch.from_numpy(v.copy()) for k, v in t.device_snapshot().items()}
    m = torch.from_numpy(seeded_matched(rng, 10, 3, 300))
    with pytest.raises(ValueError, match="kslot"):
        P_csr.sparse_fanout_slots(csr, m, 0)
    with pytest.raises(TypeError, match="int32"):
        P_csr.sparse_fanout_slots(csr, m.to(torch.int64), 8)
    with pytest.raises(ValueError, match="several devices"):
        P_csr.sparse_fanout_slots(csr, m.to("meta"), 8)
    with pytest.raises(ValueError, match="pair up"):
        P_csr.sparse_fanout_slots({**csr, "hot_slot": csr["hot_slot"][:, :5].contiguous()},
                                  m, 8)
    kernels.reset_launches()
    P_csr.sparse_fanout_slots(csr, m, 8)
    assert kernels.LAUNCHES["sparse_fanout_slots"] == 0  # the twin ran


# -- on the card: the kernel against its twin (skips without CUDA) -------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


def serving_csr(rng, H, n_fids=1 << 17, per_fid=3):
    """A port CsrTable at the serving path's widths: `per_fid` slots a fid
    over 2^20 slots, packed tombstones, and H hot pairs (a quarter of them
    tombstoned, some fids repeated)."""
    t = P_csr.CsrTable()
    fids = np.repeat(np.arange(n_fids, dtype=np.int64), per_fid)
    slots = rng.integers(0, 1 << 20, len(fids))
    t.bulk_add(fids, slots)
    for f, s_ in zip(fids[::17], slots[::17]):
        t.remove(int(f), int(s_))
    hf = rng.integers(0, n_fids, H)
    hf[: H // 8] = 7
    hs = rng.choice(1 << 20, H, replace=False)
    for f, s_ in zip(hf, hs):
        t.add(int(f), int(s_))
    for f, s_ in zip(hf[::4], hs[::4]):
        t.remove(int(f), int(s_))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 1024])
def test_sparse_fanout_kernel_at_serving_shapes_on_card(cuda_device, H):
    """B = 8,192 rows, K = 4, kslot 64, kg 128 (the routers' window), over
    a hot segment of H pairs; matched fids draw from the hot fids often."""
    rng = np.random.default_rng(H)
    t = serving_csr(rng, H)
    snap = t.device_snapshot()
    assert snap["hot_fid"].shape[1] == H
    B, K = 8192, 4
    m = rng.integers(0, 1 << 17, size=(B, K)).astype(np.int32)
    hot = snap["hot_fid"][0][snap["hot_fid"][0] >= 0]
    pick = rng.random((B, K)) < 0.3
    m[pick] = rng.choice(hot, int(pick.sum()))
    m[rng.random((B, K)) < 0.2] = -1
    m[::97, :2] = [4, 4]  # one fid twice: duplicates become -1
    csr = {k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in snap.items()}
    md = torch.from_numpy(m).to(cuda_device)
    kernels.reset_launches()
    got = P_csr.sparse_fanout_slots(csr, md, 64, 128)
    want = P_csr.sparse_fanout_slots_plain(csr, md, 64, 128)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].sum()) > B and kernels.LAUNCHES["sparse_fanout_slots"] == 1


@pytest.mark.cuda
def test_sparse_fanout_kernel_matches_twin_on_card(cuda_device):
    kernels.reset_launches()
    for seed, K, kslot, kg in ((0, 4, 64, 0), (1, 6, 8, 0), (2, 3, 16, 24),
                               (3, 8, 256, 0), (4, 130, 32768, 0)):
        t, rng = seeded_csr(seed, hot=600)
        snap = t.device_snapshot()
        matched = seeded_matched(rng, 300, K, 300)
        csr = {k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in snap.items()}
        m = torch.from_numpy(matched).to(cuda_device)
        got = P_csr.sparse_fanout_slots(csr, m, kslot, kg)
        want = P_csr.sparse_fanout_slots_plain(csr, m, kslot, kg)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for seed, K, kslot, kg in ((5, 4, 64, 128), (6, 4, 8, 0), (7, 2, 32, 16), (8, 40, 128, 0),
                               (9, 12, 100, 0)):
        t, rng = hot_heavy_csr(seed, P_csr.CsrTable)
        snap = t.device_snapshot()
        matched = hot_heavy_matched(rng, 300, K, snap["csr_off"].shape[1])
        csr = {k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in snap.items()}
        m = torch.from_numpy(matched).to(cuda_device)
        got = P_csr.sparse_fanout_slots(csr, m, kslot, kg)
        want = P_csr.sparse_fanout_slots_plain(csr, m, kslot, kg)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert kernels.LAUNCHES["sparse_fanout_slots"] == 10
