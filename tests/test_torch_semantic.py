"""The port's semantic routing plane against the JAX package.

`emqx_tpu_torch.ops.semantic_table` and the semantic half of
`DeviceRouter` (port) against `emqx_tpu.ops.semantic_table` and
`emqx_tpu.models.router_model` on the same seeded inputs:

- `SemanticTable` through seeded churn (bulk load, adds, replacements of
  packed and hot entries, removes, hot growth, the inline absorb past
  `HOT_ABSORB_MAX`, op-log overflow), f32 and bf16: every lane, the
  op-log, epoch, version, registry and `device_snapshot()` byte for byte
  (bf16 bits equal to ml_dtypes');
- `semantic_match_step_plain` and `union_semantic_slots_plain` against the
  JAX functions at D = 32 and D = 384 on up to 512 entries and B = 64:
  duplicate vectors (exact ties), a table smaller than topk, rows that
  match nothing, scoped and unscoped entries, dead entries;
- the slice whole: `DeviceRouter(semtab=...).route(topics, embeds=,
  rules=)` against the JAX router (slots, slot_count, overflow, sem_count,
  rule_masks) through churn, with the mirror's full/delta/array decisions
  equal to the JAX manager's, and with a session rider;
- the scatter's float support: f32 and bf16 lanes keep their bits through
  `segment_scatter_plain` and the manager's delta path.

Tolerance. Integer outputs must equal JAX's bit for bit, except where the
float order of the D-term sums can decide: the port (torch's CPU matmul)
and XLA sum in different orders, so a row may differ only if every
difference is explained by entries whose similarity, recomputed in f64,
lies within TAU = D * 2^-23 of its threshold or of the row's k-th score
(`chip_smoke.semantic_row_ok`). Such rows are listed in the test output.
The `cuda`-marked tests hold the kernels against their twins on a card.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops import segments as J_seg
from emqx_tpu.ops import semantic_table as J_sem
from emqx_tpu.ops import session_table as J_tab
from emqx_tpu.ops import tokenizer as J_tok
from emqx_tpu.ops.matcher import MatcherConfig as JConfig
from emqx_tpu.rules import compile as J_comp
from emqx_tpu.rules import sql as J_sql
from emqx_tpu_torch import convert, kernels
from emqx_tpu_torch.broker.session_store import SessionRider
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops import segments as P_seg
from emqx_tpu_torch.ops import semantic_table as P_sem
from emqx_tpu_torch.ops import session_table as P_tab
from emqx_tpu_torch.ops.matcher import MatcherConfig as PConfig
from emqx_tpu_torch.rules import compile as P_comp
from emqx_tpu_torch.rules import sql as P_sql


def tau(dim):
    return dim * 2.0 ** -23


def host_bits(a) -> np.ndarray:
    """A snapshot array's bytes, whatever its package's type for bf16."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def assert_same_snapshot(p_snap, j_snap, dtype):
    assert sorted(p_snap) == sorted(j_snap) == sorted(P_sem.SEM_KEYS)
    for k in P_sem.SEM_KEYS:
        p, j = p_snap[k], np.asarray(j_snap[k])
        if dtype == "bfloat16" and k in ("sem_vec", "sem_hot_vec"):
            assert p.dtype == convert.BF16 and j.dtype == ml_dtypes.bfloat16, k
        else:
            assert p.dtype == j.dtype, k
        assert p.shape == j.shape, k
        np.testing.assert_array_equal(host_bits(p), host_bits(j), err_msg=k)


def assert_same_table(p, j):
    assert (p._pcap, p._hcap, p.live, p.packed_tombs, p.hot_tombs, p._hot_tail) == (
        j._pcap, j._hcap, j.live, j.packed_tombs, j.hot_tombs, j._hot_tail)
    assert (p.epoch, p.version, p._structure_gen, len(p)) == (
        j.epoch, j.version, j._structure_gen, len(j))
    assert p._reg == j._reg and p.hot_fill == j.hot_fill
    assert p.oplog == j.oplog
    assert p.entries() == j.entries()
    for a, b in zip(p.live_arrays(), j.live_arrays()):
        np.testing.assert_array_equal(a, b)
    assert_same_snapshot(p.device_snapshot(), j.device_snapshot(), p.dtype)


def clustered(rng, n, dim, cents, dup_every=0):
    """n vectors `_near` random centroids; every `dup_every`-th repeats the
    vector before it exactly (a tie in every implementation)."""
    cl = rng.integers(0, len(cents), size=n)
    v = chip_smoke.sem_vectors(rng, cents, cl)
    if dup_every:
        v[dup_every::dup_every] = v[dup_every - 1:-1:dup_every][: len(v[dup_every::dup_every])]
    return v, cl


def centroids(rng, k, dim):
    c = rng.normal(size=(k, dim)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


# -- the host table --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_matches_jax_through_churn(dtype):
    rng = np.random.default_rng(11 if dtype == "float32" else 12)
    dim = 24
    p = P_sem.SemanticTable(dim=dim, topk=4, dtype=dtype)
    j = J_sem.SemanticTable(dim=dim, topk=4, dtype=dtype)
    for t in (p, j):
        t.OPLOG_MAX = 4000
        t.HOT_ABSORB_MAX = 192
    assert_same_table(p, j)
    cents = centroids(rng, 8, dim)

    def both(name, *args):
        ra = getattr(p, name)(*args)
        rb = getattr(j, name)(*args)
        assert ra == rb, name
        assert_same_table(p, j)

    vecs, _ = clustered(rng, 150, dim, cents, dup_every=7)
    both("bulk_add", np.arange(150) * 3, vecs, rng.uniform(0.5, 0.99, 150),
         np.where(rng.random(150) < 0.5, -1, rng.integers(0, 9, 150)))
    for step in range(3):
        for _ in range(60):
            r = rng.random()
            slot = int(rng.integers(0, 700))
            if r < 0.55:
                v = rng.normal(size=dim).astype(np.float32)
                if rng.random() < 0.05:
                    v[:] = 0  # a zero vector stays zero
                both("add", slot, v, float(rng.uniform(0.0, 1.0)),
                     int(rng.integers(-1, 9)) if rng.random() < 0.8 else None)
            elif r < 0.75:  # replace an entry that exists
                live = sorted(p._reg)
                s = live[int(rng.integers(0, len(live)))]
                both("add", s, rng.normal(size=dim), 0.123456789, 3)
            else:
                both("remove", slot)
        with pytest.raises(ValueError):
            p.add(1, np.ones(dim + 1), 0.5)
    # past HOT_ABSORB_MAX a full hot segment folds inline (one epoch bump)
    e0 = p.epoch
    for s in range(1000, 1000 + 400):
        both("add", s, rng.normal(size=dim), 0.9, -1)
    assert p.epoch > e0 and p._structure_gen > 1
    assert p.status() == j.status()


def test_table_refuses_shards():
    """More than one shard is the mesh's layout (entry -> shard slot % S),
    no longer refused: a table built sharded and one resharded live
    (`reshard`, an epoch-bump rebuild) equal JAX's, byte for byte."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    tabs = []
    for S in (P_sem, J_sem):
        a = S.SemanticTable(dim=8, topk=4, shards=2)
        b = S.SemanticTable(dim=8, topk=4)
        for t in (a, b):
            t.bulk_add(np.arange(30), vecs[:30], np.full(30, 0.5), np.arange(30) % 4 - 1)
            t.add(77, vecs[30], 0.25, 3)
            t.remove(4)
        b.reshard(3)
        tabs.append((a, b))
    for p, j in zip(*tabs):
        assert p.shards == j.shards
        assert_same_table(p, j)


# -- the similarity stage ----------------------------------------------------


def sims64(snap, q, dtype):
    """float64 similarities from the inputs each implementation sees (the
    query rounded to bf16 for a bf16 table), [B, E]."""
    vecs = np.concatenate([np.asarray(snap["sem_vec"])[0], np.asarray(snap["sem_hot_vec"])[0]])
    if dtype == "bfloat16":  # the bits of either package's bf16 array
        vecs = (vecs.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    return q.astype(np.float64) @ vecs.astype(np.float64).T


def lanes_of(snap):
    return tuple(np.concatenate([np.asarray(snap[a])[0], np.asarray(snap[b])[0]])
                 for a, b in (("sem_fid", "sem_hot_fid"), ("sem_slot", "sem_hot_slot"),
                              ("sem_thresh", "sem_hot_thresh")))


def band_rows(snap, q, matched, topk, dtype, got, want, t):
    """Rows where two (sem_slots, sem_count) results differ; each must be
    explained by the f64 band (both results pass `semantic_row_ok`).
    Returns [(row, entries within t of a threshold or the k-th score)]."""
    (gs, gc), (ws, wc) = got, want
    diff = np.nonzero((gs != ws).any(axis=1) | (gc != wc))[0]
    if not len(diff):
        return []
    s64 = sims64(snap, q, dtype)
    fids, slots, ths = lanes_of(snap)
    out = []
    for r in diff:
        elig = (slots >= 0) & ((fids < 0) | np.isin(fids, matched[r][matched[r] >= 0]))
        for res_s, res_c in ((gs, gc), (ws, wc)):
            assert chip_smoke.semantic_row_ok(s64[r], elig, ths, slots, topk, res_s[r],
                                              int(res_c[r]), t), r
        ok = elig & (s64[r] >= ths)
        kth = np.sort(s64[r][ok])[::-1][min(topk, ok.sum()) - 1] if ok.any() else np.inf
        band = np.nonzero(elig & ((np.abs(s64[r] - ths) <= t) | (np.abs(s64[r] - kth) <= t)))[0]
        out.append((int(r), band.tolist()))
    print("rows inside the tau band:", out)
    return out


def sem_case(rng, dim, dtype, n_packed, n_hot, n_dead, topk, B, K=4):
    """One JAX table and the port's copy built by the same calls, plus a
    batch: queries near the entries' centroids (some zero), matched fids
    (some rows all -1)."""
    cents = centroids(rng, 6, dim)
    tabs = (P_sem.SemanticTable(dim=dim, topk=topk, dtype=dtype),
            J_sem.SemanticTable(dim=dim, topk=topk, dtype=dtype))
    vecs, _ = clustered(rng, n_packed, dim, cents, dup_every=5)
    ths = rng.uniform(0.90, 0.96, n_packed).astype(np.float32)
    ths[::9] = -1.0  # pass everything in scope: k-th ties among duplicates
    fids = np.where(rng.random(n_packed) < 0.5, -1, rng.integers(0, 8, n_packed))
    hv, _ = clustered(rng, n_hot, dim, cents)
    hot_ths = np.where(np.arange(n_hot) % 2, rng.uniform(0.9, 0.96, n_hot), 0.0)
    for t in tabs:
        if n_packed:
            t.bulk_add(np.arange(n_packed) + 1000, vecs, ths, fids)
        for i in range(n_hot):
            t.add(5000 + i, hv[i], float(hot_ths[i]),
                  int(fids[i % max(1, n_packed)]) if n_packed else -1)
        rng_dead = np.random.default_rng(5)
        for s in rng_dead.choice(n_packed, size=min(n_dead, n_packed), replace=False):
            t.remove(int(s) + 1000)
        if n_hot:
            t.remove(5000)
    assert_same_snapshot(tabs[0].device_snapshot(), tabs[1].device_snapshot(), dtype)
    q, _ = clustered(rng, B, dim, cents)
    q[::11] = 0
    matched = np.full((B, K), -1, np.int32)
    for b in range(B):
        if b % 7:
            matched[b, : b % (K + 1)] = rng.choice(8, size=b % (K + 1), replace=False)
    return tabs, q.astype(np.float32), matched


SEM_CASES = [
    # dim, dtype, packed, hot, dead, topk, B
    (32, "float32", 400, 60, 40, 8, 64),
    (384, "float32", 480, 32, 50, 16, 64),
    (32, "bfloat16", 400, 60, 40, 8, 64),
    (384, "bfloat16", 300, 20, 10, 16, 64),
    (32, "float32", 5, 0, 1, 8, 64),  # E < topk after the removal
    (384, "float32", 0, 3, 0, 16, 64),  # a hot segment only
]


@pytest.mark.parametrize("case", SEM_CASES, ids=lambda c: f"D{c[0]}-{c[1]}-P{c[2]}-H{c[3]}")
def test_match_step_plain_matches_jax(case):
    dim, dtype, n_packed, n_hot, n_dead, topk, B = case
    rng = np.random.default_rng(dim + n_packed + n_hot)
    (pt, jt), q, matched = sem_case(rng, dim, dtype, n_packed, n_hot, n_dead, topk, B)
    jsnap = jt.device_snapshot()
    js, jc = J_sem.semantic_match_step({k: np.asarray(v) for k, v in jsnap.items()},
                                       q, matched, topk)
    js, jc = np.array(js), np.array(jc)
    tsnap = convert.upload(pt.device_snapshot(), "cpu")
    qt, mt = torch.from_numpy(q), torch.from_numpy(matched)
    ps, pc = P_sem.semantic_match_step_plain(tsnap, qt, mt, topk)
    assert ps.dtype == pc.dtype == torch.int32 and tuple(ps.shape) == js.shape
    band = band_rows(jsnap, q, matched, topk, dtype, (ps.numpy(), pc.numpy()), (js, jc),
                     tau(dim))
    assert len(band) <= B // 8  # the band is thin: most rows are exact
    # the CPU wrapper is the twin
    ws, wc = P_sem.semantic_match_step(tsnap, qt, mt, topk)
    assert torch.equal(ws, ps) and torch.equal(wc, pc)
    assert (jc > 0).any() and (jc > topk).any() == (n_packed > 100)
    # union: the JAX function on the JAX winners, the twin on the same
    topic = np.full((B, 8), -1, np.int32)
    topic[:, :3] = rng.integers(0, 8, size=(B, 3))
    topic[:, 3] = js[:, 0]  # each row's first winner is a topic slot too
    ju = np.asarray(J_sem.union_semantic_slots(topic, js))
    pu = P_sem.union_semantic_slots_plain(torch.from_numpy(topic), torch.from_numpy(js))
    np.testing.assert_array_equal(pu.numpy(), ju)
    assert (ju[:, 8:] == -1).sum() > (js == -1).sum()  # the dedup fired
    np.testing.assert_array_equal(
        P_sem.union_semantic_slots(torch.from_numpy(topic), torch.from_numpy(js)).numpy(), ju)


def test_ties_break_toward_the_lower_index():
    dim = 16
    v = np.zeros((6, dim), np.float32)
    v[:, 0] = 1
    snap = {
        "sem_vec": v[None], "sem_fid": np.full((1, 6), -1, np.int32),
        "sem_slot": np.array([[10, 11, 12, 13, 14, 15]], np.int32),
        "sem_thresh": np.zeros((1, 6), np.float32),
        "sem_hot_vec": v[None, :2], "sem_hot_fid": np.full((1, 2), -1, np.int32),
        "sem_hot_slot": np.array([[20, -1]], np.int32),
        "sem_hot_thresh": np.zeros((1, 2), np.float32),
    }
    q = np.zeros((2, dim), np.float32)
    q[:, 0] = 1
    matched = np.full((2, 1), -1, np.int32)
    js, jc = J_sem.semantic_match_step(snap, q, matched, 4)
    ps, pc = P_sem.semantic_match_step_plain(
        {k: torch.from_numpy(a) for k, a in snap.items()}, torch.from_numpy(q),
        torch.from_numpy(matched), 4)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert ps[0].tolist() == [10, 11, 12, 13] and pc.tolist() == [7, 7]


def test_topk_checks():
    snap = {k: torch.from_numpy(np.asarray(v)) for k, v in
            P_sem.SemanticTable(dim=4).device_snapshot().items()}
    q = torch.zeros((2, 4))
    m = torch.full((2, 1), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="topk"):
        P_sem.semantic_match_step(snap, q, m, 0)
    with pytest.raises(ValueError, match="D = 4"):
        P_sem.semantic_match_step(snap, torch.zeros((2, 5)), m, 4)


# -- the slice whole: DeviceRouter(semtab=...).route(..., embeds=, rules=) ---


def twin_routers(dim=32, topk=8, dtype="float32", max_subscribers=256, n_sem=300, seed=0):
    rng = np.random.default_rng(seed)
    filters = [f"device/{i}/+/{j}/#" for i in range(40) for j in range(25)]
    filters += [f"device/{i}/#" for i in range(10)]
    slots = rng.integers(0, max_subscribers, size=len(filters))
    cents = centroids(rng, 6, dim)
    vecs, _ = clustered(rng, n_sem, dim, cents, dup_every=6)
    ths = rng.uniform(0.85, 0.96, n_sem)
    out = []
    for ri, st, sem, R, cfg in ((P_ri.RouteIndex, P_router.SubscriberTable, P_sem.SemanticTable,
                                 P_router, PConfig),
                                (J_ri.RouteIndex, J_router.SubscriberTable, J_sem.SemanticTable,
                                 J_router, JConfig)):
        index, subs = ri(), st(max_subscribers=max_subscribers)
        fids = index.bulk_add(filters)
        subs.bulk_add(fids, slots)
        tab = sem(dim=dim, topk=topk, dtype=dtype)
        # scoped to device/{i}/# (fids 1000..1009), to a few device/i/+/j/#, or unscoped
        scope = np.where(np.arange(n_sem) % 3 == 0, -1,
                         np.where(np.arange(n_sem) % 3 == 1, 1000 + np.arange(n_sem) % 10,
                                  np.arange(n_sem) % 50))
        # the first 32 entries take topic slots (one entry per slot): the
        # union's dedup fires
        sslots = np.where(np.arange(n_sem) < 32, np.arange(n_sem), 300 + np.arange(n_sem))
        tab.bulk_add(sslots, vecs, ths, scope)
        kw = dict(device="cpu") if R is P_router else {}
        out.append((index, subs, tab,
                    R.DeviceRouter(index, subs, cfg(max_levels=8, max_bytes=64), semtab=tab,
                                   **kw)))
    return rng, cents, out


def route_inputs(rng, cents, B, dim):
    ids = np.minimum(rng.zipf(1.3, size=B) - 1, 39)
    topics = [f"device/{i}/mid/{k}/leaf" for i, k in zip(ids, rng.integers(0, 25, B))]
    topics[:3] = ["", "$SYS/x", "device/3/mid/5/"]
    q, _ = clustered(rng, B, dim, cents)
    q[5] = 0
    return topics, q


def check_route(p_res, j_res, p_tab, j_tab, topk, q, dtype="float32"):
    """Every output equal; a row whose semantic half differs must be
    explained by the band: both winners lists (recomputed before the union
    by each package's match step) pass `semantic_row_ok`."""
    for name in ("matched", "mcount", "flags", "slot_count", "overflow"):
        np.testing.assert_array_equal(getattr(p_res, name), getattr(j_res, name), err_msg=name)
    np.testing.assert_array_equal(p_res.rule_masks, j_res.rule_masks)
    assert p_res.slots.shape == j_res.slots.shape
    kslot = p_res.slots.shape[1] - topk
    np.testing.assert_array_equal(p_res.slots[:, :kslot], j_res.slots[:, :kslot])
    same = (p_res.slots == j_res.slots).all(axis=1) & (p_res.sem_count == j_res.sem_count)
    if same.all():
        return 0
    matched = np.asarray(j_res.matched, np.int32)
    jsnap = j_tab.device_snapshot()
    js, jc = (np.asarray(a) for a in J_sem.semantic_match_step(
        {k: np.asarray(v) for k, v in jsnap.items()}, q, matched, topk))
    ps, pc = (a.numpy() for a in P_sem.semantic_match_step_plain(
        convert.upload(p_tab.device_snapshot(), "cpu"), torch.from_numpy(q),
        torch.from_numpy(matched), topk))
    np.testing.assert_array_equal(p_res.slots, np.asarray(P_sem.union_semantic_slots_plain(
        torch.from_numpy(p_res.slots[:, :kslot].copy()), torch.from_numpy(ps))))
    np.testing.assert_array_equal(p_res.sem_count, pc)
    band_rows(jsnap, q, matched, topk, dtype, (ps, pc), (js, jc), tau(q.shape[1]))
    return int((~same).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_with_semantic_and_rules_matches_jax(dtype):
    dim, topk = 32, 8
    rng, cents, ((p_idx, p_subs, p_tab, p_router), (j_idx, j_subs, j_tab, j_router)) = \
        twin_routers(dim, topk, dtype, seed=1 if dtype == "float32" else 2)
    p_rules = chip_smoke.rule_filter(chip_smoke.RULES_SQL, P_sql, P_comp)
    j_rules = chip_smoke.rule_filter(chip_smoke.RULES_SQL, J_sql, J_comp)
    differing = 0

    def route_both(B=150):
        nonlocal differing
        topics, q = route_inputs(rng, cents, B, dim)
        msgs = chip_smoke.rule_messages(rng, topics)
        pf, pv = p_rules.features(msgs)
        jf, jv = j_rules.features(msgs)
        p_res = p_router.route(topics, embeds=q, rules=(p_rules.progs, pf, pv))
        j_res = j_router.route(topics, embeds=q, rules=(j_rules.progs, jf, jv))
        assert p_res.sem_count.dtype == np.int32 and p_res.rule_masks.dtype == bool
        assert p_res.rule_masks.shape == (8, B)
        differing += check_route(p_res, j_res, p_tab, j_tab, topk, q, dtype)
        assert p_res.readback_bytes > 0
        return p_res

    res = route_both()
    assert res.sem_count.max() > topk and (res.slots[:, -topk:] >= 0).any()
    assert p_router.segment_status()["semantic"] == {
        "full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0}

    def churn(tab, seed):
        r = np.random.default_rng(seed)
        for i in range(70):  # hot growth: 64 -> 128 (array resyncs)
            tab.add(2000 + i, r.normal(size=dim), float(r.uniform(0.0, 0.5)), -1)
        for s in (300 + np.arange(0, 100, 7)).tolist() + [2001, 2003]:
            tab.remove(s)
        tab.add(305, r.normal(size=dim), 0.25, 1003)  # a packed replacement

    churn(p_tab, 9)
    churn(j_tab, 9)
    route_both()
    p_counts = p_router.segment_status()["semantic"]
    j_mgr = j_router._sem_sync
    assert p_counts == {"full_resyncs": j_mgr.full_resyncs,
                        "delta_launches": j_mgr.delta_launches,
                        "array_resyncs": j_mgr.array_resyncs}
    assert p_counts["delta_launches"] == 1 and p_counts["array_resyncs"] == 4
    # an emptied table runs no semantic stage: slots narrow to kslot again
    for tab in (p_tab, j_tab):
        for s in list(tab._reg):
            tab.remove(s)
    topics, q = route_inputs(rng, cents, 40, dim)
    p_res, j_res = p_router.route(topics, embeds=q), j_router.route(topics, embeds=q)
    assert p_res.sem_count is None and j_res.sem_count is None
    np.testing.assert_array_equal(p_res.slots, j_res.slots)
    print("rows decided inside the band:", differing)


def test_semantic_makes_compaction_mandatory():
    # 64 slots: without a semantic table the dense rows are the smaller
    # readback (kslot 0); with one, the union needs the compact rows
    rng, cents, ((p_idx, p_subs, p_tab, _), (j_idx, j_subs, j_tab, _)) = twin_routers(
        max_subscribers=32, seed=3)
    for tab, ctor, subs, idx, R, cfg, kw in (
            (p_tab, P_sem.SemanticTable, p_subs, p_idx, P_router, PConfig, {"device": "cpu"}),
            (j_tab, J_sem.SemanticTable, j_subs, j_idx, J_router, JConfig, {})):
        empty = ctor(dim=32, topk=8)
        plain = R.DeviceRouter(idx, subs, cfg(max_levels=8, max_bytes=64), semtab=empty, **kw)
        assert plain.prepare()[_kslot_pos(R)] == 0
        sem = R.DeviceRouter(idx, subs, cfg(max_levels=8, max_bytes=64), semtab=tab, **kw)
        assert sem.prepare()[_kslot_pos(R)] == 64
    topics, q = route_inputs(rng, cents, 20, 32)
    p_args = P_router.DeviceRouter(p_idx, p_subs, PConfig(max_levels=8), semtab=p_tab,
                                   device="cpu").prepare()
    with pytest.raises(ValueError, match="compact fan-out"):
        P_router.shape_route_step(
            p_args.tables, *J_tok.encode_topics(topics, 64)[:2], m_active=p_args.m_active,
            salt=p_args.salt, max_levels=8, kslot=0, sem_tables=p_args.sem_tables,
            q_vecs=q, sem_topk=8, device="cpu")


def _kslot_pos(R):
    return 4 if R is P_router else J_router._ARGS_KSLOT


def test_session_rider_composes_with_semantic_tables():
    """The session-fused call runs the semantic stage too: its unioned
    slots and counts equal the plain call's, and the JAX session step's."""
    dim, topk = 32, 8
    rng, cents, ((p_idx, p_subs, p_tab, p_router), (j_idx, j_subs, j_tab, _)) = \
        twin_routers(dim, topk, seed=4)
    topics, q = route_inputs(rng, cents, 48, dim)
    args = p_router.prepare()
    plain = p_router.route_prepared(args, topics, embeds=q)
    sess = P_tab.SessionTable(capacity=256, slots=64)
    zeros = {k: np.zeros(16, np.int32) for k in P_tab.ROW_LANES}
    rider = SessionRider(convert.upload(sess.device_snapshot(), "cpu"), zeros, zeros,
                         np.asarray([1, 10], np.int32), 0, 0, 0, 0)
    fused = p_router.route_prepared(args, topics, embeds=q, session=rider)
    np.testing.assert_array_equal(plain.slots, fused.slots)
    np.testing.assert_array_equal(plain.sem_count, fused.sem_count)
    assert fused.session is not None
    # against the JAX session step on the same tables and batch
    st = j_idx.shapes.device_snapshot()
    bits = j_subs.pack(j_idx.num_filters_capacity)
    mat, lens, _ = J_tok.encode_topics(topics, 64)
    jsess = J_tab.SessionTable(capacity=256, slots=64)
    jout = J_router.session_route_step(
        st, None, bits, mat, np.asarray(lens),
        {k: v.copy() for k, v in jsess.device_snapshot().items()}, zeros, zeros,
        np.asarray([1, 10], np.int32), None, None, None, None,
        {k: v.copy() for k, v in j_tab.device_snapshot().items()}, q, None, None,
        sweep_k=0, m_active=j_idx.shapes.m_active(), with_nfa=False, salt=j_idx.salt,
        max_levels=8, kslot=args.kslot, sem_topk=topk)
    kslot = args.kslot
    ju, jc = np.asarray(jout["slots"]), np.asarray(jout["sem_count"])
    np.testing.assert_array_equal(ju[:, :kslot], fused.slots[:, :kslot])
    # each package's union row is its own winners after the topic part;
    # the winners agree outside the band
    matched = np.asarray(jout["matched"], np.int32)
    jsnap = j_tab.device_snapshot()
    js, jc2 = (np.asarray(a) for a in J_sem.semantic_match_step(
        {k: np.asarray(v) for k, v in jsnap.items()}, q, matched, topk))
    ps, pc = P_sem.semantic_match_step_plain(
        convert.upload(p_tab.device_snapshot(), "cpu"), torch.from_numpy(q),
        torch.from_numpy(matched), topk)
    topic = torch.from_numpy(np.ascontiguousarray(ju[:, :kslot]))
    np.testing.assert_array_equal(fused.slots, P_sem.union_semantic_slots_plain(topic, ps))
    np.testing.assert_array_equal(ju, P_sem.union_semantic_slots_plain(
        topic, torch.from_numpy(js)))
    np.testing.assert_array_equal(jc, jc2)
    np.testing.assert_array_equal(fused.sem_count, pc.numpy())
    band_rows(jsnap, q, matched, topk, "float32", (ps.numpy(), pc.numpy()), (js, jc), tau(dim))


# -- the scatter's float support ---------------------------------------------


FLOATS = [0.1, 1 / 3, -0.0, 1e-40, 3.0e38, float("inf"), -2.5, 1.00390625, 1.01171875, 7]


def test_float_scatter_keeps_bits():
    n = 32
    flats = {"f": torch.arange(n, dtype=torch.float32),
             "h": torch.arange(n, dtype=torch.float32).to(torch.bfloat16),
             "i": torch.arange(n, dtype=torch.int32)}
    idx = list(range(0, 3 * len(FLOATS), 3))
    vals = {"f": FLOATS, "h": FLOATS, "i": list(range(-5, 5))}
    got = P_seg.segment_scatter_plain(flats, {k: idx for k in flats}, vals)
    wrapped = P_seg.segment_scatter(flats, {k: idx for k in flats}, vals)
    want_f = np.arange(n, dtype=np.float32)
    want_f[idx] = np.array(FLOATS, np.float32)  # what the JAX manager builds
    want_h = np.arange(n, dtype=np.float32).astype(ml_dtypes.bfloat16)
    want_h[idx] = np.array(FLOATS, dtype=ml_dtypes.bfloat16)
    for out in (got, wrapped):
        assert out["f"].dtype == torch.float32 and out["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["f"].view(torch.int32).numpy(), want_f.view(np.int32))
        np.testing.assert_array_equal(out["h"].view(torch.int16).numpy(), want_h.view(np.int16))
        assert out["i"][idx].tolist() == list(range(-5, 5))
    # the inputs are never written
    assert flats["f"][0] == 0 and flats["h"][3] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manager_float_deltas_match_jax(dtype):
    """The semantic mirror through churn: the same full/delta/array
    decisions as the JAX manager, and tensors equal to the JAX mirror's
    arrays bit for bit after every sync."""
    rng = np.random.default_rng(21)
    dim = 16
    tabs = (P_sem.SemanticTable(dim=dim, topk=4, dtype=dtype),
            J_sem.SemanticTable(dim=dim, topk=4, dtype=dtype))
    mgrs = (P_seg.DeviceSegmentManager("cpu", name="semantic"),
            J_seg.DeviceSegmentManager(name="semantic"))
    for t in tabs:
        t.OPLOG_MAX = 3000
    vecs = rng.normal(size=(100, dim))
    ths = rng.uniform(0.5, 0.9, 100)

    def sync_both():
        pm, jm = (m.sync(t) for m, t in zip(mgrs, tabs))
        for k in P_sem.SEM_KEYS:
            p = pm[k]
            j = np.asarray(jm[k])
            bits = p.view(torch.int16 if p.dtype == torch.bfloat16 else torch.int32)
            np.testing.assert_array_equal(bits.numpy().view(np.uint8).reshape(-1),
                                          j.view(np.uint8).reshape(-1), err_msg=k)
        return (mgrs[0].full_resyncs, mgrs[0].delta_launches, mgrs[0].array_resyncs) == (
            mgrs[1].full_resyncs, mgrs[1].delta_launches, mgrs[1].array_resyncs)

    steps = [
        lambda t: t.bulk_add(np.arange(100), vecs, ths),
        lambda t: [t.add(200 + i, vecs[i], 0.1 * i + 0.05, i % 3) for i in range(40)],
        lambda t: [t.add(300 + i, vecs[i], 0.77, -1) for i in range(40)],  # hot growth
        lambda t: [t.remove(s) for s in (3, 5, 201, 333)],
        lambda t: [t.add(7, vecs[9], 0.3333, 2)],  # a packed replacement
        lambda t: [t.add(400 + i, vecs[i % 100], 0.5, -1) for i in range(200)],  # log full
    ]
    seen = []
    for step in steps:
        for t in tabs:
            step(t)
        assert sync_both()
        seen.append((mgrs[0].full_resyncs, mgrs[0].delta_launches, mgrs[0].array_resyncs))
    # full upload; float and int scatters; growth as array resyncs; a bump
    assert seen[0] == (1, 0, 0) and seen[1] == (1, 1, 0)
    assert seen[2][2] > 0 and seen[3][1] == seen[2][1] + 1 and seen[5][0] == 2


def test_score_splits_fill_the_card_in_whole_waves():
    """`semantic_splits` takes the S with the fewest tile-times (waves of
    one block a multiprocessor, each ceil(tiles / S) tiles), the smaller S
    on a tie, within [1, min(tiles, SPLITS_MAX)]; and the tile it counts
    in is the kernel's (`kBM` = `kBN` = SEM_TILE in semantic_match.cu)."""
    src = (P_sem.__file__.rsplit("/ops/", 1)[0] + "/kernels/csrc/semantic_match.cu")
    text = open(src).read()
    for name in ("kBM", "kBN"):
        assert f"constexpr int {name} = {P_sem.SEM_TILE};" in text
    T = P_sem.SEM_TILE
    for B, E, sms in ((8192, 262208, 132), (8191, 1333, 132), (4096, 131072, 132),
                      (64, 512, 132), (1, 1, 132), (8192, 262208, 114), (100, 10**6, 8)):
        S = P_sem.semantic_splits(B, E, sms)
        rb, tiles = -(-B // T), -(-E // T)
        cost = lambda s: -(-rb * s // sms) * -(-tiles // s)  # noqa: E731
        assert 1 <= S <= min(tiles, P_sem.SPLITS_MAX)
        best = min(cost(s) for s in range(1, min(tiles, P_sem.SPLITS_MAX) + 1))
        assert cost(S) == best and all(cost(s) > best for s in range(1, S))
    # semantic_256k on an H100: 64 row blocks x 41 splits, 20 waves of 50 tiles
    assert P_sem.semantic_splits(8192, 262208, 132) == 41


# -- on the card: the kernels against their twins (skips without CUDA) -----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEM_CASES + [(384, "float32", 3000, 100, 100, 32, 333),
                                              (128, "bfloat16", 2000, 70, 10, 16, 1000)],
                         ids=lambda c: f"D{c[0]}-{c[1]}-P{c[2]}-H{c[3]}-B{c[6]}")
def test_semantic_kernels_match_twin_on_card(case, cuda_device):
    dim, dtype, n_packed, n_hot, n_dead, topk, B = case
    rng = np.random.default_rng(dim + n_packed)
    (pt, _jt), q, matched = sem_case(rng, dim, dtype, n_packed, n_hot, n_dead, topk, B, K=3)
    snap = pt.device_snapshot()
    dsnap = convert.upload(snap, cuda_device)
    qd = torch.from_numpy(q).to(cuda_device)
    md = torch.from_numpy(matched).to(cuda_device)
    kernels.reset_launches()
    gs, gc = P_sem.semantic_match_step(dsnap, qd, md, topk)
    ws, wc = P_sem.semantic_match_step_plain(dsnap, qd, md, topk)
    assert kernels.LAUNCHES["semantic_match"] == 2
    band_rows(snap, q, matched, topk, dtype, (gs.cpu().numpy(), gc.cpu().numpy()),
              (ws.cpu().numpy(), wc.cpu().numpy()), tau(dim))
    topic = torch.from_numpy(rng.integers(-1, 1100, size=(B, 8)).astype(np.int32)).to(cuda_device)
    u, uc = P_sem.semantic_route_stage(dsnap, qd, md, topk, topic)
    assert torch.equal(u, P_sem.union_semantic_slots_plain(topic, gs)) and torch.equal(uc, gc)
    assert torch.equal(P_sem.union_semantic_slots(topic, gs),
                       P_sem.union_semantic_slots_plain(topic, gs))
    assert kernels.LAUNCHES["semantic_match"] == 5


def ragged_table(rng, dim, dtype, P, H, device):
    """A one-shard table of P packed and H hot entries built directly (no
    capacity rounding), tie-heavy: 12 distinct vectors, so most scores tie
    exactly; a quarter of the entries dead, half scoped to fids 0-7."""
    cents = centroids(rng, 12, dim)
    E = P + H
    vecs = cents[rng.integers(0, 12, E)]
    fids = np.where(rng.random(E) < 0.5, -1, rng.integers(0, 8, E)).astype(np.int32)
    slots = np.where(rng.random(E) < 0.25, -1, np.arange(E)).astype(np.int32)
    ths = rng.uniform(0.2, 0.9, E).astype(np.float32)
    ths[::5] = -1.0
    vt = torch.from_numpy(vecs)
    if dtype == "bfloat16":
        vt = vt.to(torch.bfloat16)
    split = {"vec": vt, "fid": torch.from_numpy(fids), "slot": torch.from_numpy(slots),
             "thresh": torch.from_numpy(ths)}
    sem = {}
    for k, v in split.items():
        sem[f"sem_{k}"] = v[:P][None].contiguous().to(device)
        sem[f"sem_hot_{k}"] = v[P:][None].contiguous().to(device)
    return sem, cents


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [99, 100, 384, 640])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_semantic_kernels_at_ragged_shapes_on_card(dim, dtype, cuda_device):
    """Shapes that are no multiple of the 128 x 128 tile (B = 8,191, E =
    1,000 + 333, D = 99, 100, 384 or 640: rows copied element by element,
    in 16-byte pieces in the f32 lane only, or in 16-byte pieces in both;
    the bf16 query streamed from its scratch), a tie-heavy table and thresholds set to within tau of
    queries' own similarities: every row equal to the twin's or both
    passing the f64 band check, in both lanes."""
    rng = np.random.default_rng(dim)
    B, P, H, topk = 8191, 1000, 333, 16
    sem, cents = ragged_table(rng, dim, dtype, P, H, cuda_device)
    q = chip_smoke.sem_vectors(rng, cents, rng.integers(0, 12, B))
    snap = {k: v.cpu().numpy() if v.dtype != torch.bfloat16
            else v.cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            for k, v in sem.items()}
    s64 = sims64(snap, q, dtype)
    th = np.concatenate([sem["sem_thresh"][0].cpu().numpy(), sem["sem_hot_thresh"][0].cpu().numpy()])
    near = rng.choice(P + H, 200, replace=False)
    th[near] = (s64[rng.integers(0, B, 200), near]
                + rng.uniform(-0.5, 0.5, 200) * tau(dim)).astype(np.float32)
    sem["sem_thresh"] = torch.from_numpy(th[:P][None].copy()).to(cuda_device)
    sem["sem_hot_thresh"] = torch.from_numpy(th[P:][None].copy()).to(cuda_device)
    snap["sem_thresh"], snap["sem_hot_thresh"] = th[:P][None], th[P:][None]
    matched = np.full((B, 3), -1, np.int32)
    matched[:, :2] = rng.integers(0, 8, (B, 2))
    qd, md = torch.from_numpy(q).to(cuda_device), torch.from_numpy(matched).to(cuda_device)
    kernels.reset_launches()
    gs, gc = P_sem.semantic_match_step(sem, qd, md, topk)
    ws, wc = P_sem.semantic_match_step_plain(sem, qd, md, topk)
    assert kernels.LAUNCHES["semantic_match"] == 2
    got = (gs.cpu().numpy(), gc.cpu().numpy())
    want = (ws.cpu().numpy(), wc.cpu().numpy())
    assert (got[1] > topk).mean() > 0.5  # most rows offer more than topk
    band_rows(snap, q, matched, topk, dtype, got, want, tau(dim))


@pytest.mark.cuda
def test_float_scatter_on_card(cuda_device):
    n = 1 << 12
    flats = {"f": torch.arange(n, dtype=torch.float32, device=cuda_device),
             "h": torch.arange(n, device=cuda_device).to(torch.bfloat16),
             "i": torch.arange(n, dtype=torch.int32, device=cuda_device),
             "b": torch.zeros(n, dtype=torch.uint8, device=cuda_device)}
    rng = np.random.default_rng(3)
    idx = {k: rng.integers(0, n, 500) for k in flats}
    vals = {"f": rng.normal(size=500).tolist(), "h": rng.normal(size=500).tolist(),
            "i": rng.integers(-9, 9, 500).tolist(), "b": rng.integers(0, 255, 500).tolist()}
    got = P_seg.segment_scatter(flats, idx, vals)
    want = P_seg.segment_scatter_plain(flats, idx, vals)
    for k in flats:
        g, w = got[k], want[k]
        if g.dtype in (torch.float32, torch.bfloat16):
            g = g.view(torch.int32 if g.dtype == torch.float32 else torch.int16)
            w = w.view(g.dtype)
        assert torch.equal(g, w), k
