"""The port's background compaction against the JAX package.

`DeviceSegmentManager.offer`, `SegmentCompactor` and the five owners of
`emqx_tpu_torch` (`ShapeSegmentOwner`, `BitmapGrowthOwner`,
`CsrSegmentOwner`, `SemanticSegmentOwner`, `SessionSegmentOwner`) driven
beside `emqx_tpu`'s through the same seeded churn: at every step both
owners decide `needs_compact` alike; cycles with mutations racing the build
and cycles a structural rebuild aborts leave every `device_snapshot()`
array byte-identical to the JAX table's (the bf16 vectors too), and the
port's mirror (on the CPU) equal to its host table; `SegmentCompactor.tick`
on an asyncio loop starts the same owners in the same order with the same
`runs`, `aborted` and `merged`; on `Block` placements of 2 and 4 parts
each rank's adopted mirror is its own block; and `DeviceRouter` routes
the same batches before and after a cycle, as the JAX router does after
its own. Tolerance: EXACT equality everywhere.
"""

import asyncio

import numpy as np
import pytest
import torch

from emqx_tpu.broker import metrics as J_metrics
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import csr_table as J_csr
from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops import segments as J_seg
from emqx_tpu.ops import semantic_table as J_sem
from emqx_tpu.ops import session_table as J_sess
from emqx_tpu_torch.broker import metrics as P_metrics
from emqx_tpu_torch.convert import Block
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import csr_table as P_csr
from emqx_tpu_torch.ops import matcher as P_matcher
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops import segments as P_seg
from emqx_tpu_torch.ops import semantic_table as P_sem
from emqx_tpu_torch.ops import session_table as P_sess

from test_torch_route_step import assert_route_equal


def host_bytes(arr) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def assert_same_snapshot(p_src, j_src):
    ps, js = p_src.device_snapshot(), j_src.device_snapshot()
    assert set(ps) == set(js)
    for k, v in js.items():
        v = np.asarray(v)
        assert ps[k].shape == v.shape and ps[k].dtype.itemsize == v.dtype.itemsize, k
        assert host_bytes(ps[k]) == host_bytes(v), k


def tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def assert_mirror(man, src):
    """The port mirror (CPU tensors) holds its host table's bytes: this
    rank's block of each array on a placed mirror."""
    snap = src.device_snapshot()
    assert set(man._arrays) == set(snap)
    for k, v in snap.items():
        want = v if man.placement is None else man.placement.place(k, v)
        assert tensor_bytes(man._arrays[k]) == host_bytes(want), k


# -- the five owners, each a pair of tables driven alike ---------------------


class Kind:
    """One owner kind: both packages' tables, the same seeded mutations,
    a structural event, and the owner over a manager."""

    def __init__(self, name, seed):
        self.name, self.rng = name, np.random.default_rng(seed)
        self.p, self.j = self.make(P_ri, P_router, P_sem, P_sess), self.make(
            J_ri, J_router, J_sem, J_sess)
        self.p_man = P_seg.DeviceSegmentManager("cpu", name=name)
        self.j_man = J_seg.DeviceSegmentManager(name=name)
        self.live = []
        self.n = 0

    def make(self, ri, rm, sem, sess):
        if self.name == "shapes":
            return ri.RouteIndex()
        if self.name == "csr":
            return rm.SubscriberTable(max_subscribers=64, mode="sparse")
        if self.name == "bitmaps":
            return (ri.RouteIndex(), rm.SubscriberTable(max_subscribers=64))
        if self.name.startswith("semantic"):
            dtype = "bfloat16" if self.name.endswith("bf16") else "float32"
            return sem.SemanticTable(dim=8, topk=4, dtype=dtype)
        return sess.SessionTable(capacity=64, slots=16)

    def src(self, side):
        return side[1] if self.name == "bitmaps" else (
            side.shapes if self.name == "shapes" else side)

    def owner(self, pkg, side, man, **kw):
        if self.name == "shapes":
            mod = P_seg if pkg == "p" else J_seg
            return mod.ShapeSegmentOwner(side.shapes, man, hot_entries=8, **kw)
        if self.name == "csr":
            mod = P_csr if pkg == "p" else J_csr
            return mod.CsrSegmentOwner(side, man, hot_entries=16, **kw)
        if self.name == "bitmaps":
            mod = P_seg if pkg == "p" else J_seg
            return mod.BitmapGrowthOwner(side[1], side[0], man, **kw)
        if self.name.startswith("semantic"):
            mod = P_sem if pkg == "p" else J_sem
            return mod.SemanticSegmentOwner(side, man, hot_entries=8, **kw)
        mod = P_sess if pkg == "p" else J_sess
        return mod.SessionSegmentOwner(side, man, tombstone_frac=0.05, **kw)

    def both(self, fn):
        fn(self.p)
        fn(self.j)

    def mutate(self):
        rng = self.rng
        if self.live and rng.random() < 0.4:
            k = self.live.pop(int(rng.integers(len(self.live))))
            self.both(lambda side: self.remove(side, k))
        else:
            self.n += 1
            k = self.key(self.n)
            self.live.append(k)
            self.both(lambda side: self.add(side, k))

    def key(self, n):
        rng = self.rng
        if self.name == "shapes":
            return f"dev/{n}/+/t{n % 7}" if n % 3 else f"dev/{n}/s"
        if self.name == "csr":
            return (int(rng.integers(0, 40)), n)
        if self.name == "bitmaps":
            return (f"b/{n}/+", int(rng.integers(0, 64)))
        if self.name.startswith("semantic"):
            return (n, rng.standard_normal(8).astype(np.float32),
                    float(rng.uniform(0.1, 0.9)), int(rng.integers(-1, 5)))
        return (int(rng.integers(0, 16)), n % 65535 + 1, int(rng.integers(1, 3)),
                int(rng.integers(0, 1000)))

    def add(self, side, k):
        if self.name == "shapes":
            side.add(k)
        elif self.name == "csr":
            side.add(*k)
        elif self.name == "bitmaps":
            side[1].add(side[0].add(k[0]), k[1])
        elif self.name.startswith("semantic"):
            side.add(k[0], k[1], k[2], k[3])
        else:
            side.insert(k[0], k[1], k[2], k[3], mid=k[3] % 50)

    def remove(self, side, k):
        if self.name == "shapes":
            side.remove(k)
        elif self.name == "csr":
            side.remove(*k)
        elif self.name == "bitmaps":
            side[1].remove(side[0].filter_id(k[0]), k[1])
        elif self.name.startswith("semantic"):
            side.remove(k[0])
        else:
            row = side._find(k[0], k[1])
            assert row >= 0
            side.clear(row)

    def structural(self, side):
        """An event that invalidates an open capture."""
        if self.name == "shapes":
            side.shapes._rehash(side.shapes._Tcap)
        elif self.name == "csr":
            side.bulk_add([39], [63])
        elif self.name == "bitmaps":
            side[1].add(0, side[1].width_words * 32 + 3)  # width growth
        elif self.name.startswith("semantic"):
            side.bulk_add([1000], np.ones((1, 8), np.float32), [0.5])
        else:
            side._grow(side._cap * 2)

    def check(self):
        assert_same_snapshot(self.src(self.p), self.src(self.j))
        out = self.p_man.sync(self.src(self.p))
        self.j_man.sync(self.src(self.j))
        assert set(out) == set(self.src(self.p).device_snapshot())
        assert_mirror(self.p_man, self.src(self.p))


KINDS = ["shapes", "csr", "bitmaps", "semantic", "semantic_bf16", "sessions"]


def run_cycle(kind, race: int, structural: bool = False, before_apply=None):
    """One cycle on both packages: begin, `race` racing mutations (and a
    structural event, then `before_apply` on each side), build, apply,
    offer. -> (port, JAX) applied."""
    po, jo = kind.owner("p", kind.p, kind.p_man), kind.owner("j", kind.j, kind.j_man)
    p_cap, j_cap = po.begin(), jo.begin()
    for _ in range(race):
        kind.mutate()
    if structural:
        kind.both(kind.structural)
    if before_apply is not None:
        kind.both(before_apply)
    p_app, j_app = po.apply(po.build(p_cap)), jo.apply(jo.build(j_cap))
    assert (p_app is None) == (j_app is None)
    if p_app is not None:
        assert p_app[0] == j_app[0] and p_app[2] == j_app[2] and p_app[3] == j_app[3]
        kind.p_man.offer(*p_app[:3])
        kind.j_man.offer(*j_app[:3])
    return p_app, j_app


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_owner_cycles_match_jax(name, seed):
    kind = Kind(name, seed)
    for _ in range(12):
        kind.mutate()
    kind.check()
    cycles = aborts = 0
    for step in range(160):
        kind.mutate()
        po = kind.owner("p", kind.p, kind.p_man)
        jo = kind.owner("j", kind.j, kind.j_man)
        need = po.needs_compact()
        assert need == jo.needs_compact(), step
        if step % 10 == 9:
            kind.check()
        if need and step % 3 != 1:
            p_app, _ = run_cycle(kind, race=int(kind.rng.integers(0, 6)))
            cycles += p_app is not None
            kind.check()
        if step in (70, 140):
            p_app, _ = run_cycle(kind, race=2, structural=True)
            assert p_app is None
            aborts += 1
            kind.check()
    # the dense matrix grows twice as far each cycle
    assert cycles >= (1 if name == "bitmaps" else 2) and aborts == 2
    kind.check()


@pytest.mark.parametrize("name", KINDS)
def test_an_adopted_offer_replaces_only_the_offered_arrays(name):
    kind = Kind(name, 7)
    for _ in range(40):
        kind.mutate()
    kind.check()
    before = kind.p_man.counters()
    p_app, _ = run_cycle(kind, race=5)
    assert p_app is not None
    offered = p_app[1]
    assert offered
    out = kind.p_man.sync(kind.src(kind.p))
    after = kind.p_man.counters()
    assert after["full_resyncs"] == before["full_resyncs"] + 1
    written = {a for a, _i, _v in kind.src(kind.p).oplog}
    for k, t in offered.items():
        if k not in written:
            assert out[k] is t, k  # adopted, not uploaded again
    assert_mirror(kind.p_man, kind.src(kind.p))


def test_offer_adopted_when_fresh_and_ignored_when_stale():
    """As tests/test_segments.py's offer test: the port manager adopts a
    fresh offer's tensor and drops a stale one, as the JAX manager does."""
    out = {}
    for pkg, ri, seg in (("p", P_ri, P_seg), ("j", J_ri, J_seg)):
        idx = ri.RouteIndex()
        for i in range(8):
            idx.add(f"o/{i}/+")
        man = seg.DeviceSegmentManager("cpu") if pkg == "p" else seg.DeviceSegmentManager()
        man.sync(idx.shapes)
        built = type(idx.shapes).build_compact(idx.shapes.begin_compact())
        if pkg == "p":
            dev = torch.from_numpy(built["tab"].reshape(-1).copy())
        else:
            import jax

            dev = jax.device_put(built["tab"].reshape(-1))
        epoch = idx.shapes.apply_compact(built)
        man.offer(epoch, {"shape_tab": dev}, pos=0)
        fresh = man.sync(idx.shapes)["shape_tab"] is dev
        man.offer(epoch, {"shape_tab": dev}, pos=0)
        idx.shapes._rehash(idx.shapes._Tcap)  # epoch bump: the offer is stale
        got = man.sync(idx.shapes)["shape_tab"]
        stale = got is not dev and np.array_equal(
            np.asarray(got), idx.shapes.arr_table.reshape(-1))
        out[pkg] = (fresh, stale, man.full_resyncs)
        if pkg == "p":
            assert_mirror(man, idx.shapes)
    assert out["p"] == out["j"] == (True, True, 3)


def test_a_torn_sync_with_a_waiting_offer_is_not_kept_clean():
    """The offer is consumed by the full resync; a source that moved
    during that sync leaves the mirror torn, and the next sync uploads in
    full (JAX's order)."""
    idx = P_ri.RouteIndex()
    for i in range(8):
        idx.add(f"t/{i}/+")
    man = P_seg.DeviceSegmentManager("cpu")
    man.sync(idx.shapes)
    owner = P_seg.ShapeSegmentOwner(idx.shapes, man, hot_entries=1)
    assert P_seg.SegmentCompactor().compact_now(owner)
    real = idx.shapes.device_snapshot

    def torn():
        snap = real()
        idx.add("t/raced/+")
        return snap

    idx.shapes.device_snapshot = torn
    man.sync(idx.shapes)
    idx.shapes.device_snapshot = real
    assert man._torn and man._offer is None
    n = man.full_resyncs
    man.sync(idx.shapes)
    assert man.full_resyncs == n + 1 and not man._torn
    assert_mirror(man, idx.shapes)


@pytest.mark.parametrize("name", ["shapes", "csr", "sessions"])
def test_a_replay_past_the_oplog_cap_offers_nothing(name):
    """The journal's replay bumps the epoch when it passes OPLOG_MAX; the
    host tables still equal JAX's, the port owner then offers nothing, and
    the next sync is a plain full upload equal to the host."""
    kind = Kind(name, 3)
    for _ in range(30):
        kind.mutate()
    kind.check()

    def small_log(side):  # past it, the replay bumps the epoch
        (side if name == "csr" else kind.src(side)).OPLOG_MAX = 20

    p_app, j_app = run_cycle(kind, race=25, before_apply=small_log)
    assert p_app is not None and p_app[1] == {} and j_app[1]
    assert_same_snapshot(kind.src(kind.p), kind.src(kind.j))
    kind.p_man.sync(kind.src(kind.p))
    assert_mirror(kind.p_man, kind.src(kind.p))


# -- the compactor on an asyncio loop ------------------------------------------


def test_compactor_ticks_start_the_same_owners_as_jax():
    kinds = {n: Kind(n, 11) for n in ("shapes", "csr", "semantic", "sessions")}
    started = {"p": [], "j": []}
    metrics = {"p": P_metrics.Metrics(), "j": J_metrics.Metrics()}
    comps = {"p": P_seg.SegmentCompactor(metrics=metrics["p"], interval_s=0.0),
             "j": J_seg.SegmentCompactor(metrics=metrics["j"], interval_s=0.0)}

    def owners(pkg):
        out = []
        for kind in kinds.values():
            o = kind.owner(pkg, getattr(kind, pkg), getattr(kind, f"{pkg}_man"))
            begin = o.begin

            def logged(begin=begin, key=o.key):
                started[pkg].append(key)
                return begin()

            o.begin = logged
            out.append(o)
        return out

    async def drive():
        ticks = []
        for step in range(120):
            for kind in kinds.values():
                kind.mutate()
            got = (comps["p"].tick(owners("p")), comps["j"].tick(owners("j")))
            ticks.append(got)
            assert got[0] == got[1], step
            if step % 2:
                for kind in kinds.values():  # mutations race the build
                    kind.mutate()
            while comps["p"]._busy or comps["j"]._busy:
                await asyncio.sleep(0.001)
        return ticks

    ticks = asyncio.run(drive())
    assert sum(t[0] for t in ticks) >= 6
    assert started["p"] == started["j"] and len(set(started["p"])) == 4
    assert (comps["p"].runs, comps["p"].aborted) == (comps["j"].runs, comps["j"].aborted)
    for name in ("router.compact.runs", "router.compact.merged", "router.compact.aborted"):
        assert metrics["p"].get(name) == metrics["j"].get(name), name
    assert metrics["p"].histogram("router.compact.seconds").count == comps["p"].runs
    for kind in kinds.values():
        kind.check()


def test_a_failed_cycle_is_logged_and_counted_as_aborted(caplog):
    kind = Kind("csr", 5)
    for _ in range(40):
        kind.mutate()
    comp = P_seg.SegmentCompactor(metrics=P_metrics.Metrics(), interval_s=0.0)
    owner = kind.owner("p", kind.p, kind.p_man)

    def broken(cap):
        raise RuntimeError("build failed")

    owner.build = broken

    async def drive():
        assert comp.tick([owner])
        while comp._busy:
            await asyncio.sleep(0.001)

    asyncio.run(drive())
    assert (comp.runs, comp.aborted) == (0, 1)
    assert comp.metrics.get("router.compact.aborted") == 1
    assert "segment compaction cycle failed" in caplog.text


# -- placed mirrors: each rank adopts its own block ---------------------------


def seeded_session_table(seed):
    rng = np.random.default_rng(seed)
    t = P_sess.SessionTable(capacity=256, slots=16)
    rows = []
    for n in range(150):
        rows.append(t.insert(int(rng.integers(0, 16)), n + 1, 1, int(rng.integers(0, 99)), n))
    for r in rng.choice(rows, 60, replace=False):
        t.clear(int(r))
    return t


def seeded_csr_table(seed, shards):
    rng = np.random.default_rng(seed)
    t = P_router.SubscriberTable(max_subscribers=256, mode="sparse", shards=shards)
    t.bulk_add(rng.integers(0, 60, 400), rng.integers(0, 256, 400))
    pairs = [(int(f), int(s)) for f, s in zip(rng.integers(0, 60, 300),
                                              rng.integers(0, 256, 300))]
    for f, s in pairs:
        t.add(f, s)
    for f, s in pairs[::3]:
        t.remove(f, s)
    return t


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("what", ["csr", "sessions"])
def test_each_rank_adopts_its_own_block(what, parts):
    """Every rank holds the whole host table and compacts its own copy at
    the same batch boundary; its mirror (CSR shards over 'tp' on axis 0,
    session rows over 'dp') adopts the offer as its block, and the host
    tables stay equal across ranks."""
    tables, mans = [], []
    for r in range(parts):
        place = Block(0, parts, r, "cpu")
        t = seeded_csr_table(9, parts) if what == "csr" else seeded_session_table(9)
        man = P_seg.DeviceSegmentManager("cpu", placement=place)
        man.sync(t)
        if what == "csr":
            owner = P_csr.CsrSegmentOwner(t, man, placement=place, hot_entries=1)
        else:
            owner = P_sess.SessionSegmentOwner(t, man, placement=place, tombstone_frac=0.0)
        assert owner.needs_compact()
        comp = P_seg.SegmentCompactor(metrics=P_metrics.Metrics())
        cap = owner.begin()
        if what == "csr":  # the same racing writes on every rank
            t.add(5, 7)
            t.remove(5, 7)
            t.add(6, 200)
        else:
            t.insert(3, 999, 1, 5, 1)
            t.clear(t._find(3, 999))
            t.insert(4, 998, 2, 6, 2)
        built = owner.build(cap)
        host = built if what == "csr" else built["table"].device_snapshot()
        for k, v in built["dev" if what == "csr" else "devs"].items():
            assert tuple(v.shape) == place.place(k, host[k]).shape, k
        applied = owner.apply(built)
        assert applied is not None
        comp._offer(owner, applied)
        assert comp.metrics.get("mesh.shard.compact.runs") == 1
        out = man.sync(t)
        for k, v in applied[1].items():
            assert out[k] is v or k in {n for n, _i, _v in t.oplog}
        assert_mirror(man, t)
        tables.append(t)
        mans.append(man)
    for t in tables[1:]:
        for k, v in tables[0].device_snapshot().items():
            assert host_bytes(t.device_snapshot()[k]) == host_bytes(v), k
    # the blocks tile the host table
    for k, v in tables[0].device_snapshot().items():
        got = torch.cat([m._arrays[k] for m in mans], dim=0)
        assert tensor_bytes(got) == host_bytes(v), k


# -- the router routes the same batches across a cycle ------------------------


def router_twins(mode, seed):
    rng = np.random.default_rng(seed)
    filters = [f"device/{i}/+/{j}/#" for i in range(30) for j in range(12)]
    filters += [f"device/{i}/#" for i in range(8)]
    slots = rng.integers(0, 128, size=len(filters))
    out = []
    for ri, rm, mc, kw in ((P_ri, P_router, P_matcher, {"device": "cpu"}),
                           (J_ri, J_router, J_matcher, {})):
        index, subs = ri.RouteIndex(), rm.SubscriberTable(max_subscribers=128, mode=mode)
        subs.bulk_add(index.bulk_add(filters), slots)
        groups = rm.GroupTable()
        for i in range(4):
            gid = groups.ensure_group(index.filter_id(f"device/{i}/#"), f"device/{i}/#", "g")
            groups.set_len(gid, 3)
        router = rm.DeviceRouter(index, subs, mc.MatcherConfig(max_levels=8, max_bytes=64),
                                 grouptab=groups, **kw)
        out.append((index, subs, router))
    return out


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_router_routes_alike_across_a_cycle(mode):
    (pi, ps, pr), (ji, js, jr) = router_twins(mode, 4)
    rng = np.random.default_rng(4)
    ids = np.minimum(rng.zipf(1.3, size=200) - 1, 29)
    nums = rng.integers(0, 12, size=200)
    topics = [f"device/{i}/mid/{k}/leaf" for i, k in zip(ids, nums)]
    topics += [f"hot/{k}/x" for k in range(20)]

    def churn(index, subs, k):
        for n in range(k, k + 30):
            subs.add(index.add(f"hot/{n}/+"), (n * 5) % 128)
        for n in range(0, 12, 3):
            index.remove(f"device/{k % 30}/+/{n}/#")

    before = pr.route(topics)
    assert_route_equal(before, jr.route(topics))
    churn(pi, ps, 0)
    churn(ji, js, 0)
    assert_route_equal(pr.route(topics), jr.route(topics))
    p_owners = pr.compaction_owners(hot_entries=8, tombstone_frac=0.01)
    j_owners = jr.compaction_owners(hot_entries=8, tombstone_frac=0.01)
    assert [o.key for o in p_owners] == [o.key for o in j_owners]
    assert [type(o).__name__ for o in p_owners] == [type(o).__name__ for o in j_owners]
    pc, jc = P_seg.SegmentCompactor(), J_seg.SegmentCompactor()
    for po, jo in zip(p_owners, j_owners):
        need = po.needs_compact()
        assert need == jo.needs_compact()
        if need:
            assert pc.compact_now(po) == jc.compact_now(jo)
    assert (pc.runs, pc.aborted) == (jc.runs, jc.aborted) and pc.runs >= 1
    churn(pi, ps, 40)
    churn(ji, js, 40)
    p_res = pr.route(topics)
    assert_route_equal(p_res, jr.route(topics))
    for name, man in (("shapes", pr._shape_sync), ("bitmaps", pr._bits_sync)):
        assert_mirror(man, pi.shapes if name == "shapes" else ps)
    assert_same_snapshot(pi.shapes, ji.shapes)
    assert_same_snapshot(ps, js)


def test_compaction_owners_follow_the_router_tables():
    (pi, ps, pr), _ = router_twins("sparse", 2)
    sem = P_sem.SemanticTable(dim=8, topk=4)
    router = P_router.DeviceRouter(pi, ps, P_matcher.MatcherConfig(max_levels=8),
                                   semtab=sem, device="cpu")
    owners = router.compaction_owners()
    assert [type(o).__name__ for o in owners] == ["ShapeSegmentOwner", "CsrSegmentOwner",
                                                   "SemanticSegmentOwner"]
    assert owners[0].manager is router._shape_sync and owners[1].manager is router._bits_sync
    assert owners[2].manager is router._sem_sync
    assert (owners[0].hot_entries, owners[0].tombstone_frac) == (1024, 0.25)
    match_only = P_router.DeviceRouter(pi, None, P_matcher.MatcherConfig(max_levels=8),
                                       device="cpu")
    assert [o.key for o in match_only.compaction_owners()] == ["shapes"]


@pytest.mark.parametrize("n,cap", [(0, 1024), (1, 1024), (700, 2048), (20000, 1 << 15),
                                   (60000, 1 << 17)])
def test_csr_registry_build_matches_jax(n, cap):
    """The port builds the CSR registry's probe rounds with a per-slot
    minimum instead of a sort a round: the arrays stay byte-identical to
    the reference's, at loads up to one half (sorted keys, as `_build`
    hands them, and shuffled ones)."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 52, size=n, dtype=np.int64))
    for order in ("sorted", "shuffled"):
        if order == "shuffled":
            keys = rng.permutation(keys)
        poss = rng.integers(0, 1 << 30, len(keys)).astype(np.int32)
        got = P_csr.CsrTable._reg_build_arrays(keys, poss, cap)
        want = J_csr.CsrTable._reg_build_arrays(keys, poss, cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and host_bytes(g) == host_bytes(w), order
