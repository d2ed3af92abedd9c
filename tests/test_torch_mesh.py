"""The port's ('dp', 'tp') mesh against the JAX package.

`emqx_tpu_torch.parallel` runs one process a shard: the launcher
(`python -m emqx_tpu_torch.parallel.launch`) forks four gloo ranks on the
CPU into a 2 x 2 mesh, and `rank_main` below runs every scenario in them,
so the file pays for one launch (a few seconds) and each test reads its
part of the ranks' results. A launch has its own timeout (100 s, and the
subprocess 120 s): a hung collective fails the test, it never stalls the
suite. JAX runs in this process, on the 2 x 2 slice of the virtual
8-device CPU mesh.

- (a) the dense mesh with $share groups (round robin): `MeshServingRouter`
  against JAX's `MeshServingRouter` (`dist_shape_route_step` plus the mesh
  readback) on the same tables and batches, and the step's raw blocks and
  stats against JAX's `dist_shape_route_step`, bit for bit;
- (b) a retained storm fused into the mesh call against JAX's
  `dist_fused_step` through its `MeshServingRouter`, bit for bit; a
  three-chunk storm (per-rank row blocks, gathered) against the port's
  mesh `match_many` and the host walk;
- (c) the CSR mesh (the table resharded over 'tp' by the first prepare)
  and the semantic mesh against the JAX single-device step and the host
  tables: JAX's own CSR and semantic mesh programs fail in this JAX with
  shard_map's scan-vma carry-type error (emqx_tpu/ops/csr_table.py:158;
  ROADMAP Queue 3), so the port's mesh is held to what the mesh must
  compute: recipients, picks and stats of the single-device step, and, for
  the semantic stage, JAX's `semantic_match_step` run on each shard's
  entries and unioned into that shard's slot rows as `_sem_rules_local`
  does (integers equal except rows an f64 recomputation places inside
  tau = D x 2^-23, `chip_smoke.semantic_row_ok`), `sem_count` equal to the
  single-device count, the rule masks equal;
- (d) the three mesh kernels' twins (`compact_fanout_slots_shard`,
  the group counts as `occurrence_index`'s totals, `share_pick` with dp
  offsets) against the JAX
  expressions they replace, the offsets inside `shard_map` with
  `dp_axis="dp"`, and the dp picks equal to the single-device picks;
- (e) backend/device mismatches, a failing rank and a hung collective;
- (f) every rank's mirrors equal to its slice of the host tables after
  churn, with the same full/delta/array decisions on every rank;
- (g) the NFA-only step (`dist_route_step`, JAX's `dist_step`) on bench.py's
  plus_100k recipe at a test's size: each rank's blocks of matched /
  mcount / flags / bitmaps against the single-device JAX `route_step`
  (JAX's own mesh program is not a stable oracle here, as in (c)) and the
  stats against its stats; two all-reduces a batch.

Tolerance: EXACT equality for every integer output; the semantic band as
stated above.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from emqx_tpu_torch import convert
from emqx_tpu_torch.models import retained_index as P_ret
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops import semantic_table as P_sem
from emqx_tpu_torch.ops.matcher import MatcherConfig as PConfig
from emqx_tpu_torch.ops.tokenizer import encode_topics
from emqx_tpu_torch.parallel import launch
from emqx_tpu_torch.parallel import mesh as P_mesh
from emqx_tpu_torch.rules import compile as P_comp
from emqx_tpu_torch.rules import sql as P_sql

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve()
LAUNCH_TIMEOUT = 100
DP, TP = 2, 2
SEM_DIM, SEM_TOPK = 32, 8
STORM = ["ret/+/t/#", "ret/3/#", "ret/+/+/7", "#", "nope/+"]

# -- seeded recipes, built by either package's host classes --------------------


def dense_tables(R, RI, sparse=False):
    """Filters device/{i}/+/{j}/# (2 subscribers each), device/{i}/# (the
    $share groups' real filters; device/3/# also has 90 subscribers in tp
    shard 0's lanes, so its rows overflow), '#' with one subscriber in
    shard 1's lanes, x/+/z; 256 slots. Groups: one or two a filter,
    round-robin bases near 2^31, empty groups."""
    rng = np.random.default_rng(7)
    filters = [f"device/{i}/+/{j}/#" for i in range(24) for j in range(12)]
    filters += [f"device/{i}/#" for i in range(24)] + ["#", "x/+/z"]
    index = RI.RouteIndex()
    fids = np.asarray(index.bulk_add(filters), np.int64)
    subs = R.SubscriberTable(max_subscribers=256, mode="sparse" if sparse else "dense")
    subs.bulk_add(np.repeat(fids[:288], 2), rng.integers(0, 256, 576))
    subs.bulk_add(np.full(90, fids[291]), np.arange(90))
    subs.add(int(fids[-2]), 200)
    groups = R.GroupTable(gpf=4)
    for i in range(24):
        gid = groups.ensure_group(int(fids[288 + i]), f"device/{i}/#", "g")
        groups.set_len(gid, i % 5)
        groups.set_rr(gid, (1 << 31) - 3 - i if i % 3 == 0 else i)
        if i < 6:
            groups.set_len(groups.ensure_group(int(fids[288 + i]), f"device/{i}/#", "h"), 3)
    return index, subs, groups


def topic_batch(rng, n):
    ids = np.minimum(rng.zipf(1.3, size=n) - 1, 23)
    out = [f"device/{i}/mid/{j}/leaf" for i, j in zip(ids, rng.integers(0, 12, n))]
    out[:4] = ["", "x/y/z", "$SYS/a", "device/1/" + "/".join("q" * 9)]
    return out


def stored_topics(n):
    """n distinct retained topics."""
    return [f"ret/{i % 5}/t/{i % 11}/{i}" if i % 4 else f"ret/{i % 5}/x{i}/7"
            for i in range(n)]


def unsubscribe_wave(rng, subs):
    """30 live (fid, slot) pairs removed, chosen in (fid, slot) order so
    that any shard layout removes the same ones."""
    fids, slots = subs.csr.live_pairs()
    order = np.lexsort((slots, fids))
    for k in rng.choice(len(fids), 30, replace=False):
        subs.remove(int(fids[order[k]]), int(slots[order[k]]))


def sem_entries(rng, n=240):
    cents = rng.normal(size=(6, SEM_DIM)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    vecs = chip_smoke.sem_vectors(rng, cents, rng.integers(0, 6, n))
    ths = rng.uniform(0.85, 0.96, n)
    scope = np.where(np.arange(n) % 3 == 0, -1,
                     np.where(np.arange(n) % 3 == 1, 288 + np.arange(n) % 24, np.arange(n) % 50))
    slots = np.where(np.arange(n) < 32, np.arange(n), 300 + np.arange(n))
    return cents, slots, vecs, ths, scope


def sem_queries(rng, cents, n):
    q = chip_smoke.sem_vectors(rng, cents, rng.integers(0, 6, n))
    q[5] = 0
    return q


# -- what the ranks run ---------------------------------------------------------


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _result(res) -> dict:
    out = {k: getattr(res, k) for k in ("matched", "mcount", "flags", "slots",
                                        "slot_count", "overflow", "sem_count",
                                        "rule_masks", "bitmaps")}
    out["picks"] = res.picks
    out["dense"] = ({r: np.asarray(res.dense_rows[j]) for r, j in res.dense_index.items()}
                    if res.dense_index else {})
    out["retained"] = res.retained
    return out


def _mirrors(pairs) -> dict:
    """Per mirror: equal to this rank's slice of its host table, and the
    manager's counters."""
    out = {}
    for mgr, src in pairs:
        snap = src.device_snapshot()
        ok = set(mgr._arrays) == set(snap)
        for k, t in mgr._arrays.items():
            want = convert._as_device_type(
                np.ascontiguousarray(mgr.placement.place(k, snap[k])), k)
            ok &= tuple(t.shape) == want.shape and \
                t.contiguous().cpu().numpy().tobytes() == want.tobytes()
        out[mgr.name] = {"equal": bool(ok), **mgr.counters()}
    return out


def _step(mesh, router, topics):
    """The raw sharded step on this rank's rows of `topics`."""
    args = router.prepare()
    mat, lens, _ = encode_topics(topics, 64)
    bm, ln = P_mesh.place_batch(mesh, mat, lens)
    sub = {k: v for k, v in args.tables.items() if k in P_router.CSR_KEYS} or \
        args.tables["sub_bitmaps"]
    shape = {k: v for k, v in args.tables.items()
             if k not in P_router.CSR_KEYS and k != "sub_bitmaps"}
    z = torch.zeros(len(ln), dtype=torch.int32)
    out = P_mesh.dist_shape_route_step(
        mesh, shape, args.nfa_tables, sub, bm, ln, args.group_tables, z, z, z,
        m_active=args.m_active, salt=args.salt, max_levels=8, frontier=32,
        max_matches=64, probes=8, share_strategy=1, kslot=args.kslot)
    return {"stats": {k: int(v) for k, v in out["stats"].items()},
            "slots": _np(out.get("slots")), "bitmaps": _np(out["bitmaps"]),
            "kslot": args.kslot}


def _collectives():
    out = {k: dict(v) for k, v in P_mesh.COLLECTIVES.items()}
    P_mesh.reset_collectives()
    return out


def scen_dense(mesh):
    idx, subs, groups = dense_tables(P_router, P_ri)
    router = P_router.MeshServingRouter(idx, subs, PConfig(max_levels=8, max_bytes=64),
                                        grouptab=groups, mesh=mesh)
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        topics = topic_batch(rng, 90)
        P_mesh.reset_collectives()
        res = router.route(topics)
        coll = _collectives()
        step = _step(mesh, router, topics)
        out.append({"topics": topics, "res": _result(res), "step": step, "coll": coll})
        chip_smoke.advance_rr(groups, res.picks)
    router.prepare()
    return {"batches": out, "mirrors": _mirrors([
        (router._shape_sync, idx.shapes), (router._bits_sync, subs),
        (router._group_sync, groups)]), "shard_status": router.shard_status(),
        "span": router.span_attrs()}


def scen_fused(mesh):
    idx, subs, groups = dense_tables(P_router, P_ri)
    router = P_router.MeshServingRouter(idx, subs, PConfig(max_levels=8, max_bytes=64),
                                        grouptab=groups, mesh=mesh)
    rng = np.random.default_rng(9)
    topics = topic_batch(rng, 64)
    P_ret.CHUNK = 512  # one chunk: the JAX fused mesh step takes one
    ridx = P_ret.DeviceRetainedIndex(mesh=mesh)
    for t in stored_topics(300):
        assert ridx.add(t)
    P_mesh.reset_collectives()
    one = router.route_prepared(router.prepare(), topics, retained=ridx.prepare_storm(STORM))
    coll = _collectives()
    # three chunks, built before the ranks' mesh existed, then placed
    P_ret.CHUNK = 128
    ridx3 = P_ret.DeviceRetainedIndex(device="cpu")
    ridx3.bulk_add(stored_topics(330))
    ridx3.place(mesh)
    three = router.route_prepared(router.prepare(), topics, retained=ridx3.prepare_storm(STORM))
    many = ridx3.match_many(STORM)
    # churn inside dp block 0 of chunk 0 only: the dp = 1 ranks own none of it
    for t in stored_topics(330)[5:40]:
        ridx3.remove(t)
    ridx3.add("ret/9/t/0/new")
    after = ridx3.match_many(STORM)
    return {"topics": topics, "one": _result(one), "three": _result(three),
            "many": many, "after": after, "coll": coll,
            "mirrors": _mirrors([(ridx3._seg, ridx3)])}


def scen_csr(mesh):
    idx, subs, groups = dense_tables(P_router, P_ri, sparse=True)
    router = P_router.MeshServingRouter(idx, subs, PConfig(max_levels=8, max_bytes=64),
                                        grouptab=groups, mesh=mesh)
    rng = np.random.default_rng(13)
    out, mirrors = [], []
    for step in range(3):
        topics = topic_batch(rng, 90)
        P_mesh.reset_collectives()
        res = router.route(topics)
        coll = _collectives()
        out.append({"topics": topics, "res": _result(res), "step": _step(mesh, router, topics),
                    "coll": coll, "shards": subs.shards})
        chip_smoke.advance_rr(groups, res.picks)
        if step == 0:  # a hot subscribe wave
            for f, s in zip(rng.integers(0, 300, 40), rng.integers(0, 256, 40)):
                subs.add(int(f), int(s))
        elif step == 1:  # an unsubscribe wave: packed tombstones
            unsubscribe_wave(rng, subs)
        router.prepare()
        mirrors.append(_mirrors([(router._bits_sync, subs), (router._group_sync, groups)]))
    return {"batches": out, "mirrors": mirrors, "shard_status": router.shard_status()}


def scen_semantic(mesh):
    idx, subs, _groups = dense_tables(P_router, P_ri)
    rng = np.random.default_rng(21)
    cents, slots, vecs, ths, scope = sem_entries(rng)
    tab = P_sem.SemanticTable(dim=SEM_DIM, topk=SEM_TOPK, shards=2)
    tab.bulk_add(slots, vecs, ths, scope)
    router = P_router.MeshServingRouter(idx, subs, PConfig(max_levels=8, max_bytes=64),
                                        semtab=tab, mesh=mesh)
    rules = chip_smoke.rule_filter(chip_smoke.RULES_SQL, P_sql, P_comp)
    out, mirrors = [], []
    for step in range(2):
        topics = topic_batch(rng, 80)
        q = sem_queries(rng, cents, 80)
        msgs = chip_smoke.rule_messages(rng, topics)
        feats, valid = rules.features(msgs)
        P_mesh.reset_collectives()
        res = router.route(topics, embeds=q, rules=(rules.progs, feats, valid))
        out.append({"topics": topics, "q": q, "msgs": msgs, "res": _result(res),
                    "coll": _collectives()})
        if step == 0:  # adds, a replacement, removes: one scatter a shard
            r = np.random.default_rng(3)
            for i in range(40):
                tab.add(2000 + i, r.normal(size=SEM_DIM), float(r.uniform(0.0, 0.5)), -1)
            tab.add(305, r.normal(size=SEM_DIM), 0.25, 291)
            for s in (300 + np.arange(0, 100, 7)).tolist():
                tab.remove(s)
        router.prepare()
        mirrors.append(_mirrors([(router._sem_sync, tab), (router._bits_sync, subs)]))
    return {"batches": out, "mirrors": mirrors, "entries": (slots, vecs, ths, scope)}


def nfa_filters():
    """bench.py's plus_100k recipe over small moduli (duplicates included),
    with `#` filters."""
    out = [f"org/{i % 5}/dev/{(i // 5) % 8}/ch/{(i // 40) % 6}/m/{i % 7}" for i in range(400)]
    for i in range(60):
        parts = ["org", str(i % 5), "dev", str((i // 5) % 8), "ch", str(i % 6), "m", str(i % 7)]
        parts[1 + 2 * (i % 4)] = "+"
        out.append("/".join(parts))
    return out + ["org/1/#", "#", "org/+/dev/3/#"]


def nfa_tables(nfa_cls):
    """The NFA over `nfa_filters` and a dense [Fcap, 8] uint32 bitmap table
    (1-3 seeded slots a filter id)."""
    b = nfa_cls()
    for f in nfa_filters():
        b.add(f)
    rng = np.random.default_rng(31)
    bits = np.zeros((P_router._next_pow2(b.num_filters_capacity), 8), np.uint32)
    for fid in range(b.num_filters_capacity):
        for slot in rng.integers(0, 256, rng.integers(1, 4)):
            bits[fid, slot // 32] |= np.uint32(1 << int(slot % 32))
    return b, bits


def nfa_batch(seed, n=90):
    rng = np.random.default_rng(seed)
    out = [f"org/{a}/dev/{b}/ch/{c}/m/{d}" for a, b, c, d in zip(
        rng.integers(0, 6, n), rng.integers(0, 9, n), rng.integers(0, 7, n),
        rng.integers(0, 8, n))]
    out[:3] = ["", "$SYS/a", "org/1/dev/2/ch/3/m/4/x/y"]  # the last too deep
    return out


def scen_nfa(mesh):
    from emqx_tpu_torch.ops.nfa import NfaBuilder

    builder, bits = nfa_tables(NfaBuilder)
    tables = convert.upload(builder.device_snapshot(), mesh.device,
                            P_mesh.table_placement(mesh))
    sub = convert.upload({"sub_bitmaps": bits}, mesh.device,
                         P_mesh.bitmap_placement(mesh))["sub_bitmaps"]
    out = []
    for seed in range(2):
        mat, lens, _ = encode_topics(nfa_batch(seed), 64)
        bm, ln = P_mesh.place_batch(mesh, mat, lens)
        P_mesh.reset_collectives()
        step = P_mesh.dist_route_step(mesh, tables, sub, bm, ln, salt=builder.salt,
                                      max_levels=8, frontier=16, max_matches=16, probes=8)
        out.append({"coll": _collectives(),
                    "stats": {k: int(v) for k, v in step["stats"].items()},
                    **{k: _np(step[k]) for k in ("matched", "mcount", "flags", "bitmaps")}})
    return out


def rank_main(mesh):
    """Every scenario, on every rank of a 2 x 2 gloo mesh on the CPU."""
    assert (mesh.dp, mesh.tp) == (DP, TP)
    return {"rank": mesh.rank, "coords": (mesh.axis_index("dp"), mesh.axis_index("tp")),
            "device": str(mesh.device), "dense": scen_dense(mesh),
            "fused": scen_fused(mesh), "csr": scen_csr(mesh),
            "semantic": scen_semantic(mesh), "nfa": scen_nfa(mesh)}


def rank_fails(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank one gives up")
    t = torch.ones(1)
    mesh.all_reduce(t, ("dp", "tp"), "test")  # never completes on rank 0
    return 0


def rank_hangs(mesh):
    if mesh.rank == 1:
        import time

        time.sleep(600)
    t = torch.ones(1)
    mesh.all_reduce(t, ("dp", "tp"), "test")
    return 0


# -- the launch -----------------------------------------------------------------


def run_launch(tmp, target, world=4, timeout=LAUNCH_TIMEOUT):
    out = tmp / f"{target}.pkl"
    proc = subprocess.run(
        [sys.executable, "-m", "emqx_tpu_torch.parallel.launch", "--world", str(world),
         "--tp", str(TP), "--backend", "gloo", "--device", "cpu", "--timeout", str(timeout),
         "--out", str(out), f"{HERE}:{target}"],
        # the subprocess's own limit adds interpreter start-up under load
        cwd=ROOT, capture_output=True, text=True, timeout=max(timeout + 20, 60),
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    res = pickle.loads(out.read_bytes()) if proc.returncode == 0 else None
    return proc, res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    proc, res = run_launch(tmp_path_factory.mktemp("mesh"), "rank_main")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    return res


@pytest.fixture(scope="module")
def jmesh():
    from emqx_tpu.parallel.mesh import make_mesh

    return make_mesh(DP * TP, tp=TP)


def jax_tables(sparse=False):
    from emqx_tpu.models import router_model as J_router
    from emqx_tpu.ops import route_index as J_ri

    return dense_tables(J_router, J_ri, sparse=sparse)


def jconfig():
    from emqx_tpu.ops.matcher import MatcherConfig

    return MatcherConfig(max_levels=8, max_bytes=64)


def assert_same_rows(p, j, names=("matched", "mcount", "flags")):
    for k in names:
        np.testing.assert_array_equal(p[k], np.asarray(getattr(j, k)), err_msg=k)


def recipients(res: dict, i: int) -> set:
    if res["overflow"] is not None and res["overflow"][i]:
        return chip_smoke.slot_set(res["dense"][i])
    return set(res["slots"][i][res["slots"][i] >= 0].tolist())


def j_recipients(res, i: int) -> set:
    if res.overflow is not None and res.overflow[i]:
        return chip_smoke.slot_set(np.asarray(res.dense_rows[res.dense_index[i]]))
    return set(res.slots[i][res.slots[i] >= 0].tolist())


# -- (a) the dense mesh ----------------------------------------------------------


def test_every_rank_assembles_the_same_result(ranks):
    for name in ("dense", "csr", "semantic"):
        for b in range(2):
            r0 = ranks[0][name]["batches"][b]["res"]
            for r in ranks[1:]:
                got = r[name]["batches"][b]["res"]
                for k in ("matched", "slots", "slot_count", "overflow", "sem_count", "rule_masks"):
                    if r0[k] is not None:
                        np.testing.assert_array_equal(got[k], r0[k], err_msg=(name, k))


def test_dense_mesh_router_matches_jax_mesh_router(ranks, jmesh):
    from emqx_tpu.models import router_model as J_router

    idx, subs, groups = jax_tables()
    jr = J_router.MeshServingRouter(idx, subs, jconfig(), grouptab=groups, mesh=jmesh)
    for b in ranks[0]["dense"]["batches"]:
        got = b["res"]
        want = jr.route(b["topics"])
        assert_same_rows(got, want, ("matched", "mcount", "flags", "slots",
                                     "slot_count", "overflow"))
        for a, w in zip(got["picks"], want.picks):
            np.testing.assert_array_equal(a, np.asarray(w))
        assert got["slots"].shape == (90, b["step"]["kslot"] * TP)
        ovf = np.nonzero(want.overflow)[0]
        assert len(ovf) and set(got["dense"]) == set(ovf.tolist())
        for r in ovf:
            np.testing.assert_array_equal(got["dense"][r], want.dense_rows[want.dense_index[r]])
        assert (got["picks"][0] >= 0).sum() > 40
        chip_smoke.advance_rr(groups, want.picks)


def test_dense_mesh_step_blocks_and_stats_match_jax(ranks, jmesh):
    from emqx_tpu.models import router_model as J_router
    from emqx_tpu.parallel import mesh as J_mesh

    idx, subs, groups = jax_tables()
    jr = J_router.MeshServingRouter(idx, subs, jconfig(), grouptab=groups, mesh=jmesh)
    for n, b in enumerate(ranks[0]["dense"]["batches"]):
        res = jr.route(b["topics"])
        st, nt, bits, salt, m_active, _nfa, gt, kslot, kg, _s, _k = jr._device_args()
        mat, lens, _ = encode_topics(b["topics"], 64)
        bm, ln = J_mesh.place_batch(jmesh, mat, lens)
        z = np.zeros(len(lens), np.uint32)
        out = J_mesh.dist_shape_route_step(
            jmesh, st, nt, bits, bm, ln, gt, z, z, z, m_active=m_active, salt=salt,
            max_levels=8, frontier=32, max_matches=64, probes=8, share_strategy=1,
            kslot=kslot)
        for k, v in out["stats"].items():
            for r in ranks:
                assert r["dense"]["batches"][n]["step"]["stats"][k] == int(v), k
        slots, bmaps = np.asarray(out["slots"]), np.asarray(out["bitmaps"])
        per, w_l = len(lens) // DP, bmaps.shape[1] // TP
        for r in ranks:
            d, t = r["coords"]
            step = r["dense"]["batches"][n]["step"]
            np.testing.assert_array_equal(step["slots"], slots[d * per:(d + 1) * per,
                                                              t * kslot:(t + 1) * kslot])
            np.testing.assert_array_equal(step["bitmaps"].view(np.uint32),
                                          bmaps[d * per:(d + 1) * per, t * w_l:(t + 1) * w_l])
        chip_smoke.advance_rr(groups, res.picks)


def test_dense_mesh_collectives_per_batch(ranks):
    # the step: the (count, overflow) pair over tp, the group counts over
    # dp, routed/matches over dp and fanout_bits over the mesh; the
    # readback: the packed buffers, then the overflow rows
    for r in ranks:
        for b in r["dense"]["batches"]:
            assert b["coll"] == {"dist_shape_step": {"all_reduce": 3, "all_gather": 1},
                                 "readback": {"all_reduce": 0, "all_gather": 2}}
        assert r["dense"]["span"] == {"device.mesh_shape": "2x2", "device.shard": "local"}
        st = r["dense"]["shard_status"]
        assert (st["dp"], st["tp"], st["shards"]) == (2, 2, 4)
        assert 0 < st["lane_fill_min"] <= st["lane_fill_max"] <= 1


# -- (g) the NFA-only step ----------------------------------------------------------


def test_dist_route_step_blocks_match_the_jax_route_step(ranks):
    import jax

    from emqx_tpu.models import router_model as J_router
    from emqx_tpu.ops.nfa import NfaBuilder

    builder, bits = nfa_tables(NfaBuilder)
    for n in range(2):
        mat, lens, _ = encode_topics(nfa_batch(n), 64)
        want = jax.jit(lambda t, sb, bm, ln: J_router.route_step_impl(
            t, sb, bm, ln, salt=builder.salt, max_levels=8, frontier=16, max_matches=16,
            probes=8))(builder.device_snapshot(), bits, mat, lens)
        per, w_l = len(lens) // DP, bits.shape[1] // TP
        assert np.asarray(want["flags"]).any() and int(want["stats"]["fanout_bits"]) > 0
        for r in ranks:
            d, t = r["coords"]
            got = r["nfa"][n]
            rows = slice(d * per, (d + 1) * per)
            for k in ("matched", "mcount", "flags"):
                np.testing.assert_array_equal(got[k], np.asarray(want[k])[rows], err_msg=k)
            np.testing.assert_array_equal(got["bitmaps"].view(np.uint32),
                                          np.asarray(want["bitmaps"])[rows,
                                                                      t * w_l:(t + 1) * w_l])
            assert got["stats"] == {k: int(v) for k, v in want["stats"].items()}
            # routed and matches over 'dp', fanout_bits over the mesh
            assert got["coll"] == {"dist_step": {"all_reduce": 2, "all_gather": 0}}


# -- (b) the fused storm ----------------------------------------------------------


def test_fused_storm_matches_jax_mesh_fused_step(ranks, jmesh, monkeypatch):
    from emqx_tpu.models import retained_index as J_ret
    from emqx_tpu.models import router_model as J_router

    monkeypatch.setattr(J_ret, "CHUNK", 512)
    idx, subs, groups = jax_tables()
    jr = J_router.MeshServingRouter(idx, subs, jconfig(), grouptab=groups, mesh=jmesh)
    jidx = J_ret.DeviceRetainedIndex(mesh=jmesh)
    for t in stored_topics(300):
        assert jidx.add(t)
    f = ranks[0]["fused"]
    want = jr.route_prepared(jr.prepare(), f["topics"], retained=jidx.prepare_storm(STORM))
    for r in ranks:
        got = r["fused"]["one"]
        assert_same_rows(got, want, ("matched", "mcount", "flags", "slots", "slot_count",
                                     "overflow"))
        for a, w in zip(got["picks"], want.picks):
            np.testing.assert_array_equal(a, np.asarray(w))
        assert set(got["retained"]) == set(want.retained) == set(STORM)
        for k, v in want.retained.items():
            np.testing.assert_array_equal(got["retained"][k], v, err_msg=k)
    assert len(want.retained["ret/3/#"]) == 60
    assert f["coll"]["dist_fused_step"] == {"all_reduce": 3, "all_gather": 1}


def test_three_chunk_fused_storm_equals_match_many_and_the_host(ranks):
    from emqx_tpu.ops import topics as T

    stored = stored_topics(330)
    for r in ranks:
        f = r["fused"]
        for k in STORM:
            want = np.array([i for i, t in enumerate(stored) if T.match(t, k)], np.int64)
            np.testing.assert_array_equal(np.sort(f["three"]["retained"][k]), want, err_msg=k)
            np.testing.assert_array_equal(np.sort(f["many"][k]), want, err_msg=k)
        # rows 5-39 removed; the add takes the last freed row, 39
        live = {i: t for i, t in enumerate(stored) if not 5 <= i < 40}
        live[39] = "ret/9/t/0/new"
        for k in STORM:
            want = sorted(i for i, t in live.items() if T.match(t, k))
            assert sorted(f["after"][k].tolist()) == want, k


# -- (c) the CSR and semantic meshes ------------------------------------------------


def test_csr_mesh_matches_the_single_device_jax_step_and_host(ranks):
    import jax

    from emqx_tpu.models import router_model as J_router

    idx, subs, groups = jax_tables(sparse=True)
    jr = J_router.DeviceRouter(idx, subs, jconfig(), grouptab=groups)
    rng = np.random.default_rng(13)
    batches = ranks[0]["csr"]["batches"]
    for step, b in enumerate(batches):
        assert b["shards"] == TP  # the first prepare resharded the table
        topics = topic_batch(rng, 90)
        assert topics == b["topics"]
        got, want = b["res"], jr.route(topics)
        assert_same_rows(got, want)
        for a, w in zip(got["picks"], want.picks):
            np.testing.assert_array_equal(a, np.asarray(w))
        np.testing.assert_array_equal(got["slot_count"], want.slot_count)
        # a shard past kslot overflows the row; the shards' sum past kslot
        # is the single-device rule, so mesh overflow implies it
        assert not (got["overflow"] & ~want.overflow).any()
        for i in range(len(topics)):
            rec = recipients(got, i)
            assert rec == j_recipients(want, i), i
            fids = got["matched"][i][got["matched"][i] >= 0]
            host = set()
            for fid in fids.tolist():
                host |= set(subs.csr.slots_of(fid).tolist())
            assert rec == host, i
        # the step's stats against the single-device JAX step
        ju = jr._device_args()
        mat, lens, _ = encode_topics(topics, 64)
        kw = dict(m_active=ju[4], with_nfa=False, salt=ju[3], max_levels=8,
                  with_groups=True, share_strategy=1, kslot=ju[7])
        z = np.zeros(len(lens), np.uint32)
        out = jax.jit(lambda st, sb, gt, bm, ln, zz: J_router.shape_route_step_impl(
            st, None, sb, bm, ln, gt, zz, zz, zz, **kw))(ju[0], ju[2], ju[6], mat, lens, z)
        for k, v in out["stats"].items():
            assert b["step"]["stats"][k] == int(v), k
        assert b["coll"]["sparse_dist_shape_step"] == {"all_reduce": 3, "all_gather": 1}
        chip_smoke.advance_rr(groups, want.picks)
        if step == 0:
            for f, s in zip(rng.integers(0, 300, 40), rng.integers(0, 256, 40)):
                subs.add(int(f), int(s))
        elif step == 1:
            unsubscribe_wave(rng, subs)


def test_semantic_mesh_is_the_per_shard_union_of_jax_match_steps(ranks):
    from emqx_tpu.models import router_model as J_router
    from emqx_tpu.ops import semantic_table as J_sem
    from emqx_tpu.rules import compile as J_comp
    from emqx_tpu.rules import sql as J_sql

    idx, subs, _groups = jax_tables()
    slots, vecs, ths, scope = ranks[0]["semantic"]["entries"]
    one = J_sem.SemanticTable(dim=SEM_DIM, topk=SEM_TOPK)
    two = J_sem.SemanticTable(dim=SEM_DIM, topk=SEM_TOPK, shards=2)
    for tab in (one, two):
        tab.bulk_add(slots, vecs, ths, scope)
    jr = J_router.DeviceRouter(idx, subs, jconfig(), semtab=one)
    rules = chip_smoke.rule_filter(chip_smoke.RULES_SQL, J_sql, J_comp)
    band = []
    for step, b in enumerate(ranks[0]["semantic"]["batches"]):
        got = b["res"]
        feats, valid = rules.features(b["msgs"])
        want = jr.route(b["topics"], embeds=b["q"], rules=(rules.progs, feats, valid))
        assert_same_rows(got, want, ("matched", "mcount", "flags", "rule_masks"))
        matched = np.asarray(want.matched, np.int32)
        kslot = want.slots.shape[1] - SEM_TOPK
        seg = kslot + SEM_TOPK
        assert got["slots"].shape == (80, seg * TP)
        snap = two.device_snapshot()
        counts = np.zeros(80, np.int64)
        for t in range(TP):
            shard = {k: np.asarray(v)[t:t + 1] for k, v in snap.items()}
            js, jc = (np.asarray(a) for a in J_sem.semantic_match_step(
                shard, b["q"], matched, SEM_TOPK))
            part = got["slots"][:, t * seg:(t + 1) * seg]
            topic = part[:, :kslot]
            union = np.asarray(J_sem.union_semantic_slots(topic, js))
            differ = np.nonzero((union != part).any(axis=1))[0]
            if len(differ):  # each such row must be decided inside the band
                lanes = P_sem.semantic_match_step_plain(
                    convert.upload(shard, "cpu"), torch.from_numpy(b["q"]),
                    torch.from_numpy(matched), SEM_TOPK)
                ps, pc = (a.numpy() for a in lanes)
                np.testing.assert_array_equal(part[:, kslot:], np.asarray(
                    P_sem.union_semantic_slots_plain(torch.from_numpy(topic.copy()),
                                                     torch.from_numpy(ps)))[:, kslot:])
                from test_torch_semantic import band_rows, tau

                band += band_rows(shard, b["q"], matched, SEM_TOPK, "float32", (ps, pc),
                                  (js, jc), tau(SEM_DIM))
            counts += jc
        # the topic recipients are the single-device router's
        for i in range(80):
            topic_rec = set()
            for t in range(TP):
                row = got["slots"][i, t * seg:t * seg + kslot]
                topic_rec |= set(row[row >= 0].tolist())
            if not got["overflow"][i]:
                want_rec = (chip_smoke.slot_set(want.dense_rows[want.dense_index[i]])
                            if want.overflow[i] else
                            set(want.slots[i, :kslot][want.slots[i, :kslot] >= 0].tolist()))
                assert topic_rec == want_rec, i
        # sem_count: the shards' qualifying counts sum to the single-device
        # count (a row that differs must have been decided inside the band)
        in_band = {x for x, _ in band}
        for r in np.nonzero((got["sem_count"] != want.sem_count)
                            | (got["sem_count"] != counts))[0]:
            assert r in in_band, r
        assert (got["sem_count"] > SEM_TOPK).any()
        assert b["coll"]["sem_dist_shape_step"] == {"all_reduce": 4, "all_gather": 0}
        if step == 0:
            r = np.random.default_rng(3)
            for tab in (one, two):
                r = np.random.default_rng(3)
                for i in range(40):
                    tab.add(2000 + i, r.normal(size=SEM_DIM), float(r.uniform(0.0, 0.5)), -1)
                tab.add(305, r.normal(size=SEM_DIM), 0.25, 291)
                for s in (300 + np.arange(0, 100, 7)).tolist():
                    tab.remove(s)
    print("rows decided inside the band:", band)


# -- (d) the mesh kernels' twins --------------------------------------------------


def test_compact_shard_twin_matches_the_jax_rebase():
    import jax.numpy as jnp

    from emqx_tpu.models import router_model as J_router

    rng = np.random.default_rng(1)
    bits = rng.integers(0, 1 << 32, size=(64, 4), dtype=np.uint32)
    bits[::3] &= rng.integers(0, 1 << 32, size=(22, 4), dtype=np.uint32)  # sparser rows
    bits[5] = 0
    for kslot in (8, 64):
        s, c, o = (np.asarray(a) for a in J_router.compact_fanout_slots(jnp.asarray(bits), kslot))
        for t in range(TP):
            off = t * 4 * 32
            got_s, pair = (a.numpy() for a in P_router.compact_fanout_slots_shard(
                torch.from_numpy(bits.view(np.int32)), kslot, off))
            np.testing.assert_array_equal(got_s, np.where(s >= 0, s + off, -1))
            np.testing.assert_array_equal(pair, np.stack([c, o.astype(np.int32)]))
        # lane base 0 is the single-device compaction
        base = [a.numpy() for a in P_router.compact_fanout_slots(
            torch.from_numpy(bits.view(np.int32)), kslot)]
        np.testing.assert_array_equal(base[0], s)
        np.testing.assert_array_equal(base[1], c)


def test_group_counts_twin_matches_the_jax_histogram():
    """The histogram of the mesh branch, now the totals of the
    `occurrence_index` call: its twin and the call's totals against JAX."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    gids = rng.integers(-1, 70, size=(40, 12)).astype(np.int32)  # some past gcap
    gsafe = np.maximum(gids, 0)
    want = jnp.zeros(64, jnp.int32).at[gsafe.reshape(-1)].add(
        (gids >= 0).astype(np.int32).reshape(-1), mode="drop")
    got = P_router.group_counts_plain(torch.from_numpy(gids), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    occ, tot = P_router.occurrence_index(torch.from_numpy(gids).reshape(-1), gcap=64,
                                         totals=True)
    np.testing.assert_array_equal(tot.numpy(), np.asarray(want))
    assert torch.equal(occ, P_router.occurrence_index_plain(torch.from_numpy(gids).reshape(-1)))


def test_dp_offset_picks_match_jax_dp_axis_and_single_device():
    """The round-robin mesh branch: each dp half's picks with the lower
    halves' group counts added equal JAX's `share_pick_device(dp_axis=
    "dp")` inside shard_map, and together the single-device picks of the
    whole batch; other strategies ignore the offsets."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from emqx_tpu.models import router_model as J_router
    from emqx_tpu.parallel.mesh import shard_map
    from test_torch_share import grouped_tables

    (pg, jg), rng = grouped_tables(4)
    psnap = convert.upload(pg.device_snapshot(), "cpu")
    jsnap = jg.device_snapshot()
    B, dp = 96, 4
    matched = rng.integers(-1, 120, size=(B, 6)).astype(np.int32)
    rand = rng.integers(0, 1 << 32, size=B, dtype=np.uint32)
    zeros = np.zeros(B, np.uint32)
    jmesh = Mesh(np.array(jax.devices()[:dp]), ("dp",))
    for strategy in (1, 0):
        fn = shard_map(
            lambda gt, m, ch, th, rd: J_router.share_pick_device(
                gt, m, ch, th, rd, strategy=strategy, dp_axis="dp"),
            mesh=jmesh, in_specs=(P(), P("dp", None), P("dp"), P("dp"), P("dp")),
            out_specs=(P("dp", None), P("dp", None)))
        want = [np.asarray(a) for a in jax.jit(fn)(jsnap, matched, zeros, zeros, rand)]
        per = B // dp
        halves = [torch.from_numpy(matched[d * per:(d + 1) * per]) for d in range(dp)]
        gcap = psnap["group_len"].shape[0]
        raw = [P_router._group_lanes(psnap, m)[0] for m in halves]
        all_c = torch.stack([P_router.occurrence_index(g.reshape(-1).contiguous(), gcap=gcap,
                                                       totals=True)[1] for g in raw])
        got = [P_router.share_pick(
            psnap, halves[d], *(torch.from_numpy(v[d * per:(d + 1) * per].view(np.int32))
                                for v in (zeros, zeros, rand)),
            strategy=strategy, dp_gather=lambda _c: all_c, dp_rank=d) for d in range(dp)]
        single = P_router.share_pick(psnap, torch.from_numpy(matched),
                                     *(torch.from_numpy(v.view(np.int32))
                                       for v in (zeros, zeros, rand)), strategy=strategy)
        for k in range(2):
            cat = np.concatenate([g[k].numpy() for g in got])
            np.testing.assert_array_equal(cat, want[k])
            np.testing.assert_array_equal(cat, single[k].numpy())
        assert (want[0] >= 0).sum() > 100


# -- (e) backends, failures, hangs ---------------------------------------------


def test_backend_and_device_mismatches_raise(tmp_path):
    with pytest.raises(ValueError, match="CUDA tensors only"):
        P_mesh.rank_device("nccl", 0, 4, "cpu")
    with pytest.raises(ValueError, match="one of"):
        P_mesh.rank_device("mpi", 0, 4, "cpu")
    # no card here: NCCL and a CUDA gloo mesh raise, they never fall back
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_mesh.rank_device("nccl", 0, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_mesh.rank_device("gloo", 0, 4)
    assert P_mesh.rank_device("gloo", 3, 4, "cpu") == torch.device("cpu")
    store = tmp_path / "store"
    with pytest.raises(ValueError):
        P_mesh.init_mesh(0, 4, backend="nccl", device="cpu", store_path=str(store))
    assert not store.exists()  # refused before joining anything
    with pytest.raises(ValueError, match="factor"):
        P_mesh.factor(6, 4)
    assert P_mesh.factor(4) == (2, 2) and P_mesh.factor(3) == (3, 1)


def fake_mesh():
    return P_mesh.Mesh(1, 1, 0, torch.device("cpu"), "gloo", {})


def test_placements_give_this_ranks_part():
    """Each placement, called as JAX's are, returns this rank's tensor; its
    `local_writes` maps a global flat index to the owner's local one."""
    rank3 = P_mesh.Mesh(2, 2, 3, torch.device("cpu"), "gloo", {})  # (dp 1, tp 1)
    bits = np.arange(6 * 8, dtype=np.uint32).reshape(6, 8)
    lanes = P_mesh.bitmap_placement(rank3)("sub_bitmaps", bits)
    np.testing.assert_array_equal(lanes.numpy().view(np.uint32), bits[:, 4:])
    csr = np.arange(2 * 5, dtype=np.int32).reshape(2, 5)
    assert P_mesh.csr_placement(rank3)("csr_slots", torch.from_numpy(csr)).tolist() == [csr[1].tolist()]
    rows = np.arange(8 * 4, dtype=np.uint8).reshape(8, 4)
    np.testing.assert_array_equal(P_mesh.retained_placement(rank3)("chunk_0", rows), rows[4:])
    assert P_mesh.table_placement(rank3)("shape_tab", csr).shape == (2, 5)
    keep, local = P_mesh.bitmap_placement(rank3).local_writes(
        "sub_bitmaps", bits.shape, np.array([3, 12, 47, 40]))
    assert keep.tolist() == [False, True, True, False] and local.tolist() == [4, 23]
    with pytest.raises(ValueError, match="equal blocks"):
        P_mesh.bitmap_placement(rank3)("odd", np.zeros((2, 3), np.int32))
    assert P_mesh.batch_rows(rank3, 9) == (5, 5)
    bm, ln = P_mesh.place_batch(rank3, np.ones((9, 4), np.uint8), np.arange(9, dtype=np.int32))
    assert bm.shape == (5, 4) and ln.tolist() == [5, 6, 7, 8, 0]  # padded with an empty row


def test_mesh_routers_refuse_riders_they_cannot_fuse():
    idx, subs, groups = dense_tables(P_router, P_ri)
    with pytest.raises(ValueError, match="requires"):
        P_router.MeshServingRouter(idx, subs, mesh=None)
    plain = P_router.DeviceRouter(idx, subs, PConfig(max_levels=8), mesh=fake_mesh())
    serving = P_router.MeshServingRouter(idx, subs, PConfig(max_levels=8), mesh=fake_mesh())
    assert not plain.supports_retained_fusion and serving.supports_retained_fusion
    assert not plain.supports_session_fusion and not serving.supports_session_fusion
    assert P_router.DeviceRouter(idx, subs, device="cpu").supports_session_fusion
    job = P_ret.StormJob(None, [], {}, {}, None, {}, [torch.zeros(1)], 0)
    for router in (plain, serving):
        args = router.prepare()
        with pytest.raises(RuntimeError, match="session rider"):
            router.route_prepared(args, ["a"], session=object())
    with pytest.raises(RuntimeError, match="retained storm"):
        plain.route_prepared(plain.prepare(), ["a"], retained=job)
    # the dense lanes must split over tp
    three = P_mesh.Mesh(1, 3, 0, torch.device("cpu"), "gloo", {})
    with pytest.raises(ValueError, match="divisible"):
        P_router.DeviceRouter(idx, subs, mesh=three).prepare()


def test_a_failing_rank_kills_the_launch(tmp_path):
    proc, res = run_launch(tmp_path, "rank_fails", timeout=60)
    assert proc.returncode == 1 and res is None
    assert "rank 1 failed with exit code 1" in proc.stderr
    assert "rank one gives up" in proc.stderr


def test_a_hung_collective_times_out(tmp_path):
    proc, res = run_launch(tmp_path, "rank_hangs", world=2, timeout=6)
    assert proc.returncode == 124 and res is None
    assert "timed out after 6.0 s" in proc.stderr


# -- (f) mirrors after churn -------------------------------------------------------


def test_every_rank_mirrors_its_slice_after_churn(ranks):
    for r in ranks:
        for m in r["dense"]["mirrors"].values():
            assert m["equal"]
        for step in r["csr"]["mirrors"] + r["semantic"]["mirrors"]:
            assert all(m["equal"] for m in step.values()), step
        assert r["fused"]["mirrors"]["retained"]["equal"]
    # the same decisions on every rank: a delta is a launch or a skip
    for name in ("csr", "semantic"):
        for step in range(len(ranks[0][name]["mirrors"])):
            for mirror in ranks[0][name]["mirrors"][step]:
                c = [r[name]["mirrors"][step][mirror] for r in ranks]
                assert len({(x["full_resyncs"], x["delta_launches"] + x["delta_skipped"],
                             x["array_resyncs"]) for x in c}) == 1, (name, step, mirror, c)
    # the reshard's full upload, then each wave as a delta
    csr = [r["csr"]["mirrors"][1]["bitmaps"] for r in ranks]
    assert all(c["full_resyncs"] == 1 and c["delta_launches"] == 2 for c in csr), csr
    sem = [r["semantic"]["mirrors"][0]["semantic"] for r in ranks]
    assert all(c["delta_launches"] == 1 for c in sem)
    # the retained churn touched dp block 0 only: the dp = 1 ranks skipped it
    ret = [r["fused"]["mirrors"]["retained"] for r in ranks]
    assert [c["delta_skipped"] for c in ret] == [0, 0, 1, 1]
    assert [c["delta_launches"] for c in ret] == [1, 1, 0, 0]


# -- on the card (skipped without CUDA) ---------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_kernels_match_twins_on_card(cuda_device):
    from emqx_tpu_torch import kernels
    from test_torch_share import grouped_tables

    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.integers(0, 1 << 32, size=(300, 4), dtype=np.uint32)
                            .view(np.int32)).to(cuda_device)
    kernels.reset_launches()
    for kslot, base in ((8, 0), (64, 128), (130, 384)):
        got = P_router.compact_fanout_slots_shard(bits, kslot, base)
        want = P_router.compact_fanout_slots_shard_plain(bits, kslot, base)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # lane base 0 and no pair: the single-device kernel, unchanged
    for a, b in zip(P_router.compact_fanout_slots(bits, 64),
                    P_router.compact_fanout_slots_plain(bits, 64)):
        assert torch.equal(a, b)
    (pg, _jg), rng = grouped_tables(6)
    gt = convert.upload(pg.device_snapshot(), cuda_device)
    matched = torch.from_numpy(rng.integers(-1, 120, size=(512, 6)).astype(np.int32)).to(cuda_device)
    lanes = P_router._group_lanes(gt, matched)[0].contiguous()
    gcap = gt["group_len"].shape[0]
    occ, tot = P_router.occurrence_index(lanes.reshape(-1), gcap=gcap, totals=True)
    assert torch.equal(tot, P_router.group_counts_plain(lanes, gcap))
    assert torch.equal(occ, P_router.occurrence_index_plain(lanes.reshape(-1)))
    all_c = torch.stack([P_router.group_counts_plain(lanes, gcap)] * 3)
    z = torch.zeros(512, dtype=torch.int32, device=cuda_device)
    for rank in range(3):
        for strategy in range(5):
            kw = dict(strategy=strategy, dp_gather=lambda _c: all_c, dp_rank=rank)
            got = P_router.share_pick(gt, matched, z, z, z + 77, **kw)
            want = P_router.share_pick_plain(gt, matched, z, z, z + 77, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (rank, strategy)
    # the direct call, then round robin on each rank: its histogram is the
    # totals of the occurrence call (3 launches), with no launch of its own
    assert kernels.LAUNCHES["occurrence_index"] == 3 + 3 * 3
    assert kernels.LAUNCHES["share_pick"] == 3 * (5 + 1)
    assert "group_counts" not in kernels.LAUNCHES
    assert kernels.LAUNCHES["compact_fanout_slots"] == 4


def rank_cuda(mesh):
    """The dense, fused and CSR scenarios on CUDA tensors (gloo stages them
    through the host), for comparison with the CPU ranks' results."""
    assert mesh.device.type == "cuda"
    return {"rank": mesh.rank, "dense": scen_dense(mesh), "fused": scen_fused(mesh),
            "csr": scen_csr(mesh)}


@pytest.mark.cuda
def test_gloo_mesh_on_cuda_equals_the_cpu_mesh(ranks, cuda_device, tmp_path):
    out = tmp_path / "cuda.pkl"
    proc = subprocess.run(
        [sys.executable, "-m", "emqx_tpu_torch.parallel.launch", "--world", "4", "--tp",
         str(TP), "--backend", "gloo", "--device", "cuda", "--timeout", "300", "--out",
         str(out), f"{HERE}:rank_cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=400,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = pickle.loads(out.read_bytes())
    for got, want in zip(res, ranks):
        for name in ("dense", "csr"):
            for a, b in zip(got[name]["batches"], want[name]["batches"]):
                for k in ("matched", "mcount", "flags", "slots", "slot_count", "overflow"):
                    np.testing.assert_array_equal(a["res"][k], b["res"][k], err_msg=(name, k))
                for x, y in zip(a["res"]["picks"], b["res"]["picks"]):
                    np.testing.assert_array_equal(x, y)
                assert a["step"]["stats"] == b["step"]["stats"]
        for k in STORM:
            np.testing.assert_array_equal(got["fused"]["three"]["retained"][k],
                                          want["fused"]["three"]["retained"][k])
        assert got["fused"]["mirrors"] == want["fused"]["mirrors"]
