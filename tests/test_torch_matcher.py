"""The port's NFA-only step and its matchers against the JAX package.

- `route_step` (port) against `route_step_impl` (JAX) on the same
  `NfaBuilder` tables and topic bytes: a dense subscriber table with kslot
  0 and 64, a CSR table with kslot 8 and gather windows 0 and 12, stats
  included, at wide and at tight frontier / match caps;
- `batch_match_bytes` against JAX's, with its per-cause flags;
- `TpuMatcher.match_batch` against JAX's `TpuMatcher` through seeded
  churn, with `MatchError` rows (no fallback), fallback rows, and the
  `matcher.fallback.rows.*` counters;
- the match-only `DeviceRouter` (``subtab=None``) and its `match_batch`
  against JAX's;
- the fan-out knobs (`fanout_compact=False`, a pinned `fanout_slots`,
  `sparse_gather`) against JAX's `DeviceRouter`.

The tables are `plus_100k` of bench.py at a test's size (8-level topics,
10% single-`+` filters, duplicates included) plus `#` filters, `$` topics,
a topic past `max_levels` and one past `max_bytes`. The port runs with
``device="cpu"`` (the kernels' plain twins); the `cuda`-marked test at the
end holds the kernels against the twins on a card. Tolerance: EXACT
equality of every output — all are integers or filter names.
"""

import jax
import numpy as np
import pytest
import torch

from emqx_tpu.broker.metrics import Metrics as JMetrics
from emqx_tpu.broker.trie import TopicTrie
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import csr_table as J_csr
from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops.nfa import NfaBuilder as JNfa
from emqx_tpu.ops.tokenizer import encode_topics
from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker.metrics import Metrics as PMetrics
from emqx_tpu_torch.convert import upload
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import matcher as P_matcher
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops.nfa import NfaBuilder as PNfa

MAX_LEVELS = 8
MAX_BYTES = 64
STEP_KEYS = ("matched", "mcount", "flags", "slots", "slot_count", "overflow")


def plus_filters(n_exact=900, n_plus=100):
    """bench.py's plus_100k recipe (`build_config`) over smaller moduli:
    8-level exact filters and single-`+` filters over the same space (some
    duplicates), plus `#` filters that widen the fan-out."""
    filters = []
    for i in range(n_exact):
        a, b, c, d = i % 6, (i // 6) % 10, (i // 60) % 12, i % 7
        filters.append(f"org/{a}/dev/{b}/ch/{c}/m/{d}")
    for i in range(n_plus):
        parts = ["org", str(i % 6), "dev", str((i // 6) % 10), "ch", str(i % 12), "m", str(i % 7)]
        parts[1 + 2 * (i % 4)] = "+"
        filters.append("/".join(parts))
    return filters + ["org/1/#", "org/+/dev/2/#", "#", "+/+/dev/+/ch/+/m/+", "$SYS/#"]


def plus_topics(seed, n=200):
    rng = np.random.default_rng(seed)
    topics = [f"org/{a}/dev/{b}/ch/{c}/m/{d}" for a, b, c, d in zip(
        rng.integers(0, 7, n), rng.integers(0, 11, n), rng.integers(0, 13, n),
        rng.integers(0, 8, n))]
    return topics + ["", "$SYS/broker/x", "org/1/dev/2/ch/3/m/4/x/y",
                     "org/1/" + "z" * 80, "org/2/dev/2", "org/0/dev/0/ch/0/m/0"]


def nfa_pair(filters, removes=()):
    out = []
    for cls in (PNfa, JNfa):
        b = cls()
        for f in filters:
            b.add(f)
        for f in removes:
            b.remove(f)
        out.append(b)
    return out


def distinct(filters):
    return list(dict.fromkeys(filters))


def dense_bits(builder, w=8, seed=3):
    """[Fcap, W] uint32: every live filter id gets 1-3 random slots."""
    rng = np.random.default_rng(seed)
    fcap = P_router._next_pow2(builder.num_filters_capacity)
    arr = np.zeros((fcap, w), np.uint32)
    for fid in range(builder.num_filters_capacity):
        for s in rng.integers(0, w * 32, rng.integers(1, 4)):
            arr[fid, s // 32] |= np.uint32(1 << int(s % 32))
    return arr


def csr_snapshot(builder, seed=4):
    rng = np.random.default_rng(seed)
    n = builder.num_filters_capacity
    fids = np.repeat(np.arange(n), 3)
    slots = rng.integers(0, 4096, len(fids))
    csr = J_csr.CsrTable()
    csr.bulk_add(fids, slots)
    csr.add(0, 4095)  # a hot pair
    csr.pack(P_router._next_pow2(n))
    return {k: np.array(v) for k, v in csr.device_snapshot().items()}


def j_route_step(salt, **kw):
    return jax.jit(lambda t, sb, bm, ln: J_router.route_step_impl(
        t, sb, bm, ln, salt=salt, max_levels=MAX_LEVELS, **kw))


def assert_step_equal(got, want):
    assert set(got) == set(want)
    for k in STEP_KEYS:
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if want["bitmaps"] is None:
        assert got["bitmaps"] is None
    else:
        np.testing.assert_array_equal(got["bitmaps"].numpy().view(np.uint32),
                                      np.asarray(want["bitmaps"]))
    for k, v in want["stats"].items():
        assert int(got["stats"][k]) == int(v), k


CAPS = [(32, 64), (4, 4)]  # (frontier, max_matches): wide, and tight enough to overflow


@pytest.mark.parametrize("frontier,max_matches", CAPS)
@pytest.mark.parametrize("kslot", [0, 64])
def test_route_step_dense_matches_jax(kslot, frontier, max_matches):
    filters = plus_filters()
    pb, jb = nfa_pair(filters, removes=filters[:40:3])
    bits = dense_bits(jb)
    bm, ln, _ = encode_topics(plus_topics(kslot + frontier), MAX_BYTES)
    caps = dict(frontier=frontier, max_matches=max_matches, probes=8)
    got = P_router.route_step(upload(pb.device_snapshot(), device="cpu"),
                              torch.from_numpy(bits.view(np.int32)), bm, ln, salt=pb.salt,
                              max_levels=MAX_LEVELS, kslot=kslot, device="cpu", **caps)
    want = j_route_step(jb.salt, kslot=kslot, **caps)(jb.device_snapshot(), bits, bm, ln)
    assert_step_equal(got, want)
    assert int(got["stats"]["fanout_bits"]) > 0
    if frontier == 4:
        assert bool(got["flags"].any())


@pytest.mark.parametrize("frontier,max_matches", CAPS)
@pytest.mark.parametrize("kg", [0, 12])
def test_route_step_csr_matches_jax(kg, frontier, max_matches):
    filters = plus_filters()
    pb, jb = nfa_pair(filters)
    csr = csr_snapshot(jb)
    bm, ln, _ = encode_topics(plus_topics(kg), MAX_BYTES)
    caps = dict(frontier=frontier, max_matches=max_matches, probes=8, kslot=8, kg=kg)
    got = P_router.route_step(upload(pb.device_snapshot(), device="cpu"),
                              upload(csr, device="cpu"), bm, ln, salt=pb.salt,
                              max_levels=MAX_LEVELS, device="cpu", **caps)
    want = j_route_step(jb.salt, **caps)(jb.device_snapshot(), csr, bm, ln)
    assert_step_equal(got, want)
    assert bool(got["overflow"].any())  # the '#' rows pass kslot = 8


@pytest.mark.parametrize("frontier,max_matches", CAPS + [(2, 2)])
def test_batch_match_bytes_matches_jax_with_causes(frontier, max_matches):
    pb, jb = nfa_pair(plus_filters())
    bm, ln, _ = encode_topics(plus_topics(frontier), MAX_BYTES)
    caps = dict(max_levels=MAX_LEVELS, frontier=frontier, max_matches=max_matches, probes=8)
    got = P_matcher.batch_match_bytes(upload(pb.device_snapshot(), device="cpu"),
                                      torch.from_numpy(bm), torch.from_numpy(ln),
                                      salt=pb.salt, **caps)
    want = J_matcher.batch_match_bytes(jb.device_snapshot(), bm, ln, salt=jb.salt, **caps)
    for g, w, name in zip(got[:3], want[:3], ("matched", "mcount", "flags")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert set(got[3]) == set(want[3]) == set(P_matcher.CAUSES)
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k].numpy(), np.asarray(want[3][k]), err_msg=k)
    assert bool(got[3]["too_deep"].any())


def assert_matches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, J_matcher.MatchError):
            assert isinstance(g, P_matcher.MatchError) and g.topic == w.topic
            assert g.cause == w.cause
        else:
            assert g == w


def test_tpu_matcher_matches_jax_through_churn():
    filters = plus_filters()
    pb, jb = nfa_pair(filters)
    cfg = dict(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES, frontier=8, max_matches=4)
    pm, jm = PMetrics(), JMetrics()
    pmat = P_matcher.TpuMatcher(pb, P_matcher.MatcherConfig(**cfg), metrics=pm, device="cpu")
    jmat = J_matcher.TpuMatcher(jb, J_matcher.MatcherConfig(**cfg), metrics=jm)
    trie = TopicTrie()
    for f in distinct(filters):
        trie.insert(f)
    rng = np.random.default_rng(11)
    live = distinct(filters)
    for step in range(4):
        topics = plus_topics(100 + step, n=100 + 37 * step)  # pads to 256 and 512
        got = pmat.match_batch(topics)
        assert_matches_equal(got, jmat.match_batch(topics))
        assert any(isinstance(g, P_matcher.MatchError) for g in got)
        fb = pmat.match_batch(topics, fallback=trie.match)
        assert_matches_equal(fb, jmat.match_batch(topics, fallback=trie.match))
        for t, names in zip(topics, fb):
            assert sorted(names) == sorted(trie.match(t)), t
        # churn: removes and fresh filters, the same ops in both builders
        gone = [live[k] for k in rng.choice(len(live), 60, replace=False)]
        new = [f"org/{step}/dev/+/ch/{k}/m/{k % 7}" for k in range(30)] + [f"org/{step}/new/#"]
        for b in (pb, jb):
            for f in gone:
                b.remove(f)
            for f in new:
                b.add(f)
        for f in gone:
            trie.delete(f)
        for f in new:
            trie.insert(f)
        live = [f for f in live if f not in set(gone)] + new
    for name in ("matcher.rows", "matcher.fallback.rows", "matcher.fallback.rows.too_long",
                 "matcher.fallback.rows.too_deep", "matcher.fallback.rows.frontier_overflow",
                 "matcher.fallback.rows.match_overflow"):
        assert pm.get(name) == jm.get(name), name
    assert pm.get("matcher.fallback.rows.match_overflow") > 0
    c = pmat._sync.counters()  # the first upload, then one sync a churn step
    assert c["full_resyncs"] + c["delta_launches"] == 4 and c["delta_launches"] >= 1


def index_pair(filters):
    out = []
    for ri in (P_ri.RouteIndex, J_ri.RouteIndex):
        idx = ri()
        idx.bulk_add(filters)
        out.append(idx)
    return out


def test_match_only_router_matches_jax():
    filters = plus_filters() + [f"device/{i}/+/{j}/#" for i in range(20) for j in range(10)]
    p_idx, j_idx = index_pair(distinct(filters))
    cfg = dict(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES)
    pr = P_router.DeviceRouter(p_idx, None, P_matcher.MatcherConfig(**cfg), device="cpu")
    jr = J_router.DeviceRouter(j_idx, None, J_matcher.MatcherConfig(**cfg))
    trie = TopicTrie()
    for f in distinct(filters):
        trie.insert(f)
    topics = plus_topics(5) + [f"device/{i}/a/{j}/b" for i in range(22) for j in range(3)]
    res = pr.route(topics)
    assert res.bitmaps is None and res.slots is None and res.picks is None
    assert "bitmaps" not in pr.segment_status()
    assert_matches_equal(pr.match_batch(topics), jr.match_batch(topics))
    got = pr.match_batch(topics, fallback=trie.match)
    assert_matches_equal(got, jr.match_batch(topics, fallback=trie.match))
    for t, names in zip(topics, got):
        assert sorted(names) == sorted(trie.match(t)), t
    for f in filters[::5]:
        p_idx.remove(f)
        j_idx.remove(f)
    assert_matches_equal(pr.match_batch(topics), jr.match_batch(topics))


def twin_routers(cfg, mode="dense"):
    filters = [f"device/{i}/+/{j}/#" for i in range(30) for j in range(10)]
    filters += [f"device/{i}/#" for i in range(10)]
    rng = np.random.default_rng(17)
    slots = rng.integers(0, 256, len(filters))
    out = []
    for ri, st, dr, mc, dev in ((P_ri.RouteIndex, P_router.SubscriberTable,
                                 P_router.DeviceRouter, P_matcher.MatcherConfig, {"device": "cpu"}),
                                (J_ri.RouteIndex, J_router.SubscriberTable,
                                 J_router.DeviceRouter, J_matcher.MatcherConfig, {})):
        idx, subs = ri(), st(max_subscribers=256, mode=mode)
        fids = idx.bulk_add(filters)
        subs.bulk_add(fids, slots)
        for s in range(40):  # device/2/# passes small caps
            subs.add(fids[-8], s)
        out.append(dr(idx, subs, mc(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES, **cfg), **dev))
    return out


def knob_topics():
    rng = np.random.default_rng(23)
    ids, nums = rng.integers(0, 32, 150), rng.integers(0, 12, 150)
    return [f"device/{i}/mid/{j}/leaf" for i, j in zip(ids, nums)] + ["", "$SYS/x"]


@pytest.mark.parametrize("cfg,mode,kslot", [
    (dict(fanout_compact=False), "dense", 0),
    (dict(fanout_slots=12), "dense", 16),
    (dict(fanout_slots=8, sparse_gather=12), "sparse", 8),
    (dict(sparse_gather=130), "sparse", 64),
])
def test_fanout_knobs_match_jax_router(cfg, mode, kslot):
    pr, jr = twin_routers(cfg, mode)
    topics = knob_topics()
    p, j = pr.route(topics), jr.route(topics)
    assert pr.prepare().kslot == kslot
    for k in ("matched", "mcount", "flags"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)
    if kslot == 0:
        assert p.slots is None and j.slots is None
        assert p.bitmaps.dtype == np.uint32 and p.bitmaps[0].flags.c_contiguous
        np.testing.assert_array_equal(p.bitmaps, j.bitmaps)
        return
    for k in ("slots", "slot_count", "overflow"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)
    assert p.dense_index == j.dense_index
    assert p.overflow.any() == (kslot < 64)  # device/2/#'s 40 subscribers
    for r, k in (p.dense_index or {}).items():
        np.testing.assert_array_equal(np.asarray(p.dense_rows[k]),
                                      np.asarray(j.dense_rows[j.dense_index[r]]))


# -- on the card: the step's kernels against their twins (skips without CUDA)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_route_step_and_matcher_on_card(cuda_device):
    dev = cuda_device
    pb, _ = nfa_pair(plus_filters())
    bits = torch.from_numpy(dense_bits(pb).view(np.int32))
    topics = plus_topics(1)
    bm, ln, _ = encode_topics(topics, MAX_BYTES)
    cpu_tables = upload(pb.device_snapshot(), device="cpu")
    kw = dict(salt=pb.salt, max_levels=MAX_LEVELS, kslot=64)
    want = P_router.route_step(cpu_tables, bits, bm, ln, device="cpu", **kw)
    kernels.reset_launches()
    got = P_router.route_step(upload(pb.device_snapshot(), device=dev), bits.to(dev),
                              bm, ln, device=dev, **kw)
    for k in STEP_KEYS + ("bitmaps",):
        assert torch.equal(got[k].cpu(), want[k]), k
    for name in ("tokenize", "vocab_lookup", "nfa_walk", "fanout_bitmaps",
                 "compact_fanout_slots"):
        assert kernels.LAUNCHES[name] == 1, name
    names = P_matcher.TpuMatcher(pb, P_matcher.MatcherConfig(max_levels=MAX_LEVELS,
                                                             max_bytes=MAX_BYTES),
                                 device=dev).match_batch(topics)
    cpu_names = P_matcher.TpuMatcher(pb, P_matcher.MatcherConfig(
        max_levels=MAX_LEVELS, max_bytes=MAX_BYTES), device="cpu").match_batch(topics)
    assert [str(x) for x in names] == [str(x) for x in cpu_names]
