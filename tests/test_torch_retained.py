"""The port's retained replay storms against the JAX package.

`emqx_tpu_torch.models.retained_index` (port) against
`emqx_tpu.models.retained_index` on the same stores and storms: host state
(chunk bytes, op-log, epoch, version, row registry) through one seeded
churn, the two new kernels' plain twins against the JAX expressions they
replace, one storm launch (`retained_step` against `_retained_step`) with
and without the residual lane, `match`, `match_many` and a prepared
storm's decode, the chunk mirror's full/delta/array counters against the
JAX manager's, and a storm fused into a routed batch
(`DeviceRouter.route_prepared(..., retained=job)`) against the JAX
router's. The port runs with ``device="cpu"`` (the kernels' plain twins),
and `CHUNK` is set small in both modules so that a few hundred topics span
several chunks. The `cuda`-marked test at the end holds the kernels
against their twins on a card. Tolerance: EXACT equality (all integers
and bytes), dtypes included.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.models import retained_index as J_ret
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops.matcher import MatcherConfig as JConfig
from emqx_tpu.ops.tokenizer import encode_topics
from emqx_tpu_torch import convert, kernels
from emqx_tpu_torch.models import retained_index as P_ret
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops import segments as P_seg
from emqx_tpu_torch.ops.matcher import MatcherConfig as PConfig

SMALL_CHUNK = 64
DEEP = "/".join("x" * 12) + "/#"  # 13 levels: past max_levels 8


@pytest.fixture
def small_chunk(monkeypatch):
    """CHUNK, which both modules read at call time, set small in both."""
    monkeypatch.setattr(J_ret, "CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(P_ret, "CHUNK", SMALL_CHUNK)


def twins(max_bytes=64):
    return (P_ret.DeviceRetainedIndex(max_bytes=max_bytes, device="cpu"),
            J_ret.DeviceRetainedIndex(max_bytes=max_bytes))


def store_topic(i: int) -> str:
    return f"site/{i % 4}/dev/{i % 7}/ch/{i}"


def assert_same_host(p, j):
    assert p.bucket == j.bucket and p.epoch == j.epoch and p.version == j.version
    assert p.oplog == j.oplog
    assert p._by_row == j._by_row and p._free == j._free and p._rows == j._rows
    assert p._tombstones == j._tombstones
    ps, js = p.device_snapshot(), j.device_snapshot()
    assert list(ps) == list(js)
    for k in js:
        assert ps[k].dtype == js[k].dtype == np.uint8
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


def counters(man):
    return (man.full_resyncs, man.delta_launches, man.array_resyncs)


def assert_mirror(p):
    """The port's chunk mirror equals the host chunks byte for byte."""
    chunks = p._ensure_chunks()
    host = p._host_b
    assert len(chunks) == len(host)
    for d, h in zip(chunks, host):
        assert d.dtype == torch.uint8
        np.testing.assert_array_equal(d.numpy(), h)


def sync_both(p, j):
    assert_mirror(p)
    j._ensure_chunks()
    assert counters(p._seg) == counters(j._seg)


def test_host_state_and_mirror_track_jax_through_churn(small_chunk):
    """One seeded sequence: bulk load, adds and removes (free-row reuse),
    refused topics, bucket growth (epoch bump), a bulk load that fills a
    chunk and starts the next, a fresh chunk through `add`, and the op-log
    cap. After every step the host state is identical, the port's mirror
    equals the host chunks and the two managers took the same decisions."""
    rng = random.Random(7)
    p, j = twins()
    both = (p, j)

    def step(fn):
        out = [fn(x) for x in both]
        assert out[0] == out[1]
        assert_same_host(p, j)
        sync_both(p, j)

    short = [f"s/{i % 4}/{i}" for i in range(105)]
    step(lambda x: x.bulk_add(short[:100]))
    assert p.bucket == 16 and len(p._host_b) == 2
    step(lambda x: [x.add(t) for t in short[100:]])
    gone = rng.sample(short, 7)
    step(lambda x: [x.remove(t) for t in gone + ["not/stored"]])
    step(lambda x: [x.add(t) for t in ("a/b", "$SYS/up", "a/b", "y" * 65, DEEP)])
    assert p._tombstones == 5 and p.add("y" * 65) is False
    step(lambda x: x.add("long/" + "z" * 20))  # past the 16-byte bucket
    assert p.bucket == 32 and p.epoch == 1
    step(lambda x: x.bulk_add([f"bulk/{i}" for i in range(60)]))
    assert len(p._host_b) == 3
    step(lambda x: [x.add(f"more/{i}") for i in range(70)])  # fresh chunk via add
    assert len(p._host_b) == 4 and any(op[0] == P_seg.RESYNC for op in p.oplog)
    for x in both:
        x.OPLOG_MAX = len(x.oplog) + 40  # the cap, a row and a bit away
    step(lambda x: [x.remove(f"more/{i}") for i in range(0, 70, 3)])
    assert p.epoch == 2  # the cap bumped the epoch; later rows log afresh
    step(lambda x: [x.add(f"again/{i}") for i in range(3)])
    assert p._seg.full_resyncs == 3 and p._seg.delta_launches >= 4
    assert p._seg.array_resyncs >= 3


def test_kernel_twins_match_the_jax_expressions():
    rng = np.random.default_rng(3)
    bm = rng.integers(0, 256, size=(300, 33), dtype=np.uint8)
    bm[rng.random(bm.shape) < 0.4] = 0
    bm[:20] = 0  # padding rows
    want = jnp.sum((jnp.asarray(bm) != 0).astype(jnp.int32), axis=1)
    got = P_ret.row_lengths(torch.from_numpy(bm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m = rng.integers(-40000, 40000, size=(257, 3), dtype=np.int64).astype(np.int32)
    m[0, :] = [-1, 32766, -32768]
    got = P_ret.narrow_i16(torch.from_numpy(m))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(m).astype(jnp.int16)))
    with pytest.raises(TypeError, match="uint8"):
        P_ret.row_lengths(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        P_ret.narrow_i16(torch.zeros((2, 4), dtype=torch.int64))


def mask_storm(words):
    """Every `+`-mask of one topic's levels (2^len filters, one shape each)
    plus four hash shapes: past MAX_SHAPES, so the residual lane runs."""
    n = len(words)
    out = ["/".join("+" if mask >> k & 1 else w for k, w in enumerate(words))
           for mask in range(1 << n)]
    return out + ["#", f"{words[0]}/#", f"{words[0]}/{words[1]}/#",
                  f"{words[0]}/+/{words[2]}/+/#"]


STORMS = {
    "one_shape": [f"site/+/dev/{d}/ch/#" for d in range(7)],
    "mixed": ["#", "site/+/dev/3/ch/#", "site/1/#", "$SYS/#", "+/+/+", "nomatch/+",
              "site/2/dev/+/ch/+", "+/#"],
    "residual": mask_storm(["site", "1", "dev", "1", "ch", "1"]),
}


def chunk_bytes(topics, rows, bucket):
    """A [rows, bucket] chunk holding `topics` then zero rows (padding)."""
    bm = np.zeros((rows, bucket), np.uint8)
    mat, _lens, _ = encode_topics(topics, bucket)
    bm[: len(topics)] = mat
    return bm


@pytest.mark.parametrize("storm", sorted(STORMS))
@pytest.mark.parametrize("narrow", [True, False])
def test_retained_step_matches_jax(storm, narrow):
    filters = STORMS[storm]
    topics = [store_topic(i) for i in range(90)] + ["$SYS/up/x", "$x/1/dev/1/ch/1", "a"]
    bm = chunk_bytes(topics, 128, 32)
    bm[5] = 0  # a removed row
    p_idx, j_idx = P_ri.RouteIndex(), J_ri.RouteIndex()
    for f in filters:
        assert p_idx.add(f) == j_idx.add(f)
    with_nfa = j_idx.residual_count > 0
    assert with_nfa == (storm == "residual")
    kw = dict(m_active=j_idx.shapes.m_active(floor=1), with_nfa=with_nfa,
              salt=j_idx.salt, max_levels=8, narrow=narrow)
    snap = {k: v.copy() for k, v in j_idx.shapes.device_snapshot().items()}
    nfa = ({k: v.copy() for k, v in j_idx.nfa.device_snapshot().items()}
           if with_nfa else None)
    want = np.asarray(J_ret._get_retained_step()(snap, nfa, jnp.asarray(bm), **kw))
    p_snap = convert.upload(p_idx.shapes.device_snapshot(), "cpu")
    p_nfa = convert.upload(p_idx.nfa.device_snapshot(), "cpu") if with_nfa else None
    got = P_ret.retained_step(p_snap, p_nfa, torch.from_numpy(bm), **kw)
    assert got.dtype == (torch.int16 if narrow else torch.int32)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    plain = P_ret.retained_step_plain(p_snap, p_nfa, torch.from_numpy(bm), **kw)
    assert torch.equal(plain, got)
    assert int((want >= 0).sum()) > (20 if storm != "one_shape" else 10)


def assert_storm_equal(got, want):
    assert list(got) == list(want)
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def churned_twins():
    """Both indexes over 3+ chunks with `$` topics, removals (tombstoned
    rows) and a partly filled last chunk (padding rows)."""
    p, j = twins()
    for x in (p, j):
        x.bulk_add([store_topic(i) for i in range(150)])
        for t in ("$SYS/broker/up", "$x/1/dev/1/ch/1", "site/1", "site"):
            x.add(t)
        for i in range(0, 150, 11):
            x.remove(store_topic(i))
        x.add("site/3/dev/3/ch/late")  # reuses a freed row
    assert_same_host(p, j)
    return p, j


def live_plain(index) -> int:
    return sum(not t.startswith("$") for t in index._rows)


def test_match_and_match_many_match_jax(small_chunk):
    p, j = churned_twins()
    assert len(p._host_b) == 3 and p._tombstones > 0
    for storm in ("mixed", "residual"):
        got = p.match_many(STORMS[storm])
        assert_storm_equal(got, j.match_many(STORMS[storm]))
    got = p.match_many(STORMS["mixed"])
    assert "$SYS/broker/up" not in [p.topic_at(int(r)) for r in got["#"]]
    assert len(got["#"]) == live_plain(p)  # no `$` topic, padding or tombstone
    for f in ("#", "site/+/dev/+/ch/+", "$SYS/#", "site/1", "+"):
        assert p.match(f) == j.match(f), f
    assert p.match(DEEP) is None and j.match(DEEP) is None
    assert p.prepare_storm(["a/#", DEEP]) is None and j.prepare_storm(["a/#", DEEP]) is None
    with pytest.raises(ValueError, match="too deep"):
        p._build_tables([DEEP])
    assert p.topic_at(-1) is None and p.topic_at(10**6) is None
    p.warm(STORMS["mixed"])  # launches, reads nothing back


def jax_storm(job):
    """A JAX `StormJob` decoded through standalone `_retained_step`
    launches."""
    step = J_ret._get_retained_step()
    return job.decode([np.asarray(step(job.shape_tables, job.nfa_tables, c, **job.kwargs))
                       for c in job.chunks])


def test_prepared_storm_decodes_like_jax_with_a_removal_in_flight(small_chunk):
    p, j = churned_twins()
    filters = STORMS["mixed"] + ["site/3/#"]
    jobs = (p.prepare_storm(filters), j.prepare_storm(filters))
    assert len(jobs[0].chunks) == len(jobs[1].chunks) == 3
    assert jobs[0].nrows == jobs[1].nrows and jobs[0].kwargs == jobs[1].kwargs
    for x in (p, j):  # removed after the prepare, before the decode
        x.remove("site/3/dev/3/ch/late")
        x.remove(store_topic(3))
    want = jax_storm(jobs[1])
    job = jobs[0]
    got = job.decode([P_ret.retained_step(job.shape_tables, job.nfa_tables, c,
                                          **job.kwargs).numpy() for c in job.chunks])
    assert_storm_equal(got, want)
    stale = {p.topic_at(int(r)) for r in got["site/3/#"]}
    assert "site/3/dev/3/ch/late" not in stale and store_topic(3) not in stale


def test_empty_index_matches_jax():
    p, j = twins()
    assert p.prepare_storm(["a/#"]) is None and j.prepare_storm(["a/#"]) is None
    assert p.match("a/#") == j.match("a/#") == []
    got = p.match_many(["a/#", "#"])
    assert_storm_equal(got, j.match_many(["a/#", "#"]))


def test_mirror_counters_match_jax_through_retained_segment_churn():
    """`tests/test_segments.py::TestRetainedSegments`, both packages: row
    edits are deltas (no full upload), and only bucket growth re-uploads
    everything."""
    p, j = (P_ret.DeviceRetainedIndex(max_bytes=32, device="cpu"),
            J_ret.DeviceRetainedIndex(max_bytes=32))
    for x in (p, j):
        x.bulk_add([f"s/{i}/t" for i in range(64)])
    assert p.match("s/+/t") == j.match("s/+/t")
    assert counters(p._seg) == counters(j._seg) == (1, 0, 0)
    for x in (p, j):
        x.add("s/extra/t")
        x.remove("s/3/t")
    got = p.match("s/+/t")
    assert got == j.match("s/+/t")
    assert counters(p._seg) == counters(j._seg) == (1, 1, 0)
    assert sorted(got) == sorted([f"s/{i}/t" for i in range(64) if i != 3] + ["s/extra/t"])
    for x in (p, j):
        x.add("a/" + "x" * 30)  # past the 16-byte bucket
    assert p.match("a/+") == j.match("a/+") == ["a/" + "x" * 30]
    assert counters(p._seg) == counters(j._seg) == (2, 1, 0)
    assert_mirror(p)


def router_twins():
    filters = [f"site/{i}/dev/+/ch/#" for i in range(4)] + ["site/+/dev/1/#", "a/b"]
    out = []
    for ri, st, cfg, router in (
        (P_ri.RouteIndex, P_router.SubscriberTable, PConfig, P_router.DeviceRouter),
        (J_ri.RouteIndex, J_router.SubscriberTable, JConfig, J_router.DeviceRouter),
    ):
        index, subs = ri(), st(max_subscribers=256)
        for k, f in enumerate(filters):
            subs.add(index.add(f), (7 * k) % 256)
        kw = {"device": "cpu"} if router is P_router.DeviceRouter else {}
        out.append(router(index, subs, cfg(max_levels=8, max_bytes=64), **kw))
    return out


def assert_route_equal(p_res, j_res):
    for k in ("matched", "mcount", "flags", "slots", "slot_count", "overflow"):
        a, b = getattr(p_res, k), getattr(j_res, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    if j_res.bitmaps is not None:
        np.testing.assert_array_equal(p_res.bitmaps, j_res.bitmaps)


@pytest.mark.parametrize("chunk,narrow", [(256, True), (256, False), (64, True),
                                          (63, False), (63, True)])
def test_fused_route_matches_jax(monkeypatch, chunk, narrow):
    """A storm riding a routed batch: the route half equals the JAX
    router's and the port's own unfused route, the storm equals JAX's and
    the port's `match_many`, and the one readback carries the matrices (an
    odd-length int16 matrix padded to whole words, or int32 ones).

    A one-chunk store (chunk 256) is held against the JAX router's fused
    `route_prepared` itself. Past one chunk the JAX router's `_readback`
    raises (its loop over the extra chunks rebinds the name of its metrics
    sink: ROADMAP Queue 3), so there the storm is held against the JAX
    job decoded from standalone `_retained_step` launches and the route
    half against the JAX router's unfused `route`."""
    monkeypatch.setattr(J_ret, "CHUNK", chunk)
    monkeypatch.setattr(P_ret, "CHUNK", chunk)
    p, j = churned_twins()
    p_router, j_router = router_twins()
    assert p_router.supports_retained_fusion
    filters = ["site/+/dev/3/ch/#", "site/1/#", "#", "nomatch/+"]
    jobs = [x.prepare_storm(filters) for x in (p, j)]
    if not narrow:  # the int32 readback (storms past 2^15 - 1 filter ids)
        jobs = [job._replace(kwargs={**job.kwargs, "narrow": False}) for job in jobs]
    topics = [f"site/{i % 5}/dev/{i % 3}/ch/{i}" for i in range(40)] + ["a/b", "", "$SYS/x"]
    p_res = p_router.route_prepared(p_router.prepare(), topics, None, jobs[0])
    if len(jobs[1].chunks) == 1:
        j_res = j_router.route_prepared(j_router.prepare(), topics, None, jobs[1])
        want = j_res.retained
    else:
        j_res = j_router.route(topics)
        want = jax_storm(jobs[1])
    assert_route_equal(p_res, j_res)
    assert_storm_equal(p_res.retained, want)
    assert_storm_equal(p_res.retained, p.match_many(filters))
    plain = p_router.route(topics)
    assert_route_equal(p_res, plain)
    assert plain.retained is None
    lanes = jobs[0].kwargs["m_active"]  # one lane per shape, no residual lane
    width = 2 if narrow else 4
    storm_bytes = len(jobs[0].chunks) * -(-chunk * lanes * width // 4) * 4
    assert p_res.readback_bytes == plain.readback_bytes + storm_bytes
    assert len(p_res.retained["#"]) == live_plain(p)


# -- on the card: the kernels against their twins (skips without CUDA) ------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_retained_kernels_match_twins_on_card(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(11)
    kernels.reset_launches()
    for cols in (32, 33):
        bm = rng.integers(0, 256, size=(5001, cols), dtype=np.uint8)
        bm[rng.random(bm.shape) < 0.3] = 0
        for t in (torch.from_numpy(bm).to(dev), torch.from_numpy(bm).to(dev)[1:]):
            assert torch.equal(P_ret.row_lengths(t), P_ret.row_lengths_plain(t))
    m = torch.from_numpy(rng.integers(-70000, 70000, size=(4097, 3)).astype(np.int32)).to(dev)
    assert torch.equal(P_ret.narrow_i16(m), P_ret.narrow_i16_plain(m))
    flats = {"b": torch.from_numpy(bm).to(dev),
             "w": torch.zeros(1 << 12, dtype=torch.int32, device=dev)}
    idxs = {"b": rng.integers(0, bm.size, size=3000), "w": rng.integers(0, 1 << 12, size=900)}
    vals = {"b": rng.integers(0, 256, size=3000), "w": rng.integers(-(1 << 31), 1 << 31, size=900)}
    got = P_seg.segment_scatter(flats, idxs, vals)
    want = P_seg.segment_scatter_plain(flats, idxs, vals)
    for k in flats:
        assert got[k].dtype == flats[k].dtype and torch.equal(got[k], want[k])
    assert kernels.LAUNCHES["row_lengths"] == 4 and kernels.LAUNCHES["narrow_i16"] == 1
    assert kernels.LAUNCHES["segment_scatter"] == P_seg.SCATTER_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 7, 8, (1 << 20) + 3])
def test_narrow_i16_matches_twin_on_card(cuda_device, n, offset):
    """8 elements a thread with a scalar tail: counts off a multiple of 8,
    and (offset 1) an input 4 bytes off a 16-byte boundary."""
    dev = cuda_device
    vals = np.random.default_rng(n + offset).integers(
        -(1 << 31), 1 << 31, size=n + offset, dtype=np.int64).astype(np.int32)
    m = torch.from_numpy(vals).to(dev)[offset:].view(n, 1)
    kernels.reset_launches()
    got = P_ret.narrow_i16(m)
    torch.cuda.synchronize()
    assert got.dtype == torch.int16 and torch.equal(got, P_ret.narrow_i16_plain(m))
    assert kernels.LAUNCHES["narrow_i16"] == 1
