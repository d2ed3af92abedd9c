"""Each kernel's plain PyTorch twin against the JAX function it replaces.

The port has four hand-written CUDA kernels (tokenize, shape_match,
fanout_bitmaps, compact_fanout_slots). On the CPU their wrappers run the
plain twins, which the card run (chip_smoke.py, and the `cuda`-marked
tests below) holds the kernels against. Here the twins are held against
`tokenize_device`, `shape_match_device`, `fanout_bitmaps` + `popcount32`
and `compact_fanout_slots` on the same seeded numpy inputs. Tolerance:
EXACT equality — every output is an integer. The `shape_match` kernel
ends a probe chain at its first never-written row; the chain tests walk
both packages' host tables after churn for the invariant that makes
that exact.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops import shape_index as J_shape
from emqx_tpu.ops import tokenizer as J_tok
from emqx_tpu_torch import kernels
from emqx_tpu_torch.convert import tables_to_device
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import shape_index as P_shape
from emqx_tpu_torch.ops import tokenizer as P_tok

# the JAX references, jitted once per shape (eager op-by-op dispatch
# compiles every primitive separately and is several times slower)
j_tokenize = jax.jit(J_tok.tokenize_device, static_argnums=(2, 3))
j_shape_match = jax.jit(J_shape.shape_match_device, static_argnums=(1,))
j_shape_match_probes = jax.jit(J_shape.shape_match_device, static_argnums=(1, 6))
j_compact = jax.jit(J_router.compact_fanout_slots, static_argnums=(1,))


@jax.jit
def j_fanout(sub, matched):
    bits = J_router.fanout_bitmaps(sub, matched)
    return bits, jnp.sum(J_router.popcount32(bits).astype(jnp.int32), axis=1)


EDGE_TOPICS = [
    "", "/", "//", "a", "/a", "a/", "/a//b/", "$", "$SYS", "$SYS/broker/x",
    "$SYS/1/y", "a/b/c/d/e/f/g/h/i/j", "device/3/mid/5/", "device/3/x/5/y",
    "device/7", "x/" * 40, "ünï/1", "sensor/4/state/9", "deep/" + "x/" * 35 + "x",
]


def seeded_topics(rng, n):
    out = list(EDGE_TOPICS)
    while len(out) < n:
        i, j = (int(x) for x in rng.integers(0, 40, size=2))
        kind = int(rng.integers(0, 6))
        out.append([
            f"device/{i}/mid/{j}/leaf",
            f"device/{i}/m/{j}",
            f"sensor/{i}/state/{j}",
            f"q/{i}/x",
            f"$SYS/{i}/up",
            f"a/b/{i}/{j}",
        ][kind])
    return out


def cpu(a):
    return torch.from_numpy(np.array(a))


def as_u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("salt,max_levels,max_bytes", [(0, 8, 64), (3, 4, 32), (9, 16, 128)])
def test_tokenize_plain_matches_jax(salt, max_levels, max_bytes):
    topics = seeded_topics(np.random.default_rng(salt), 300)
    mat, lens, _ = J_tok.encode_topics(topics, max_bytes)
    want = j_tokenize(jnp.asarray(mat), jnp.asarray(lens), salt, max_levels)
    got = P_tok.tokenize(cpu(mat), cpu(lens), salt, max_levels)
    np.testing.assert_array_equal(as_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(as_u32(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool


def seeded_filters(rng, n):
    """Shape-fit wildcard and exact filters, root wildcards, `$` filters."""
    out = []
    for _ in range(n):
        i, j = (int(x) for x in rng.integers(0, 40, size=2))
        out.append([
            f"device/{i}/+/{j}/#", f"device/{i}/#", f"sensor/{i}/state/{j}",
            f"+/{i}/x", "#", f"$SYS/{i}/#", f"a/+/+/{j}",
        ][int(rng.integers(0, 7))])
    return out


def churned_index(seed, max_shapes=J_ri.MAX_SHAPES):
    """A JAX RouteIndex whose shape tables carry packed rows, packed
    tombstones, hot-overlay rows and hot tombstones."""
    rng = np.random.default_rng(seed)
    j = J_ri.RouteIndex(max_shapes=max_shapes)
    cold = seeded_filters(rng, 500)
    j.bulk_add(cold)
    for f in cold[::5]:
        j.remove(f)  # packed tombstones
    hot = [f"q/{k}/x" for k in range(40)] + [f"$SYS/{k}/+" for k in range(40)]
    for f in hot:
        j.add(f)  # hot overlay
    for f in hot[::7]:
        j.remove(f)  # hot tombstones
    assert j.shapes.packed_tombstones > 0 and j.shapes.hot_live > 0
    return j


@pytest.mark.parametrize("seed,max_levels", [(0, 8), (1, 16), (2, 4)])
def test_shape_match_plain_matches_jax(seed, max_levels):
    j = churned_index(seed)
    topics = seeded_topics(np.random.default_rng(seed + 10), 400)
    mat, lens, _ = J_tok.encode_topics(topics, 128)
    h1, h2, nw, dl = j_tokenize(jnp.asarray(mat), jnp.asarray(lens), j.salt, max_levels)
    snap = {k: v.copy() for k, v in j.shapes.device_snapshot().items()}
    m = j.shapes.m_active()
    want = np.asarray(j_shape_match(
        {k: jnp.asarray(v) for k, v in snap.items()}, m, h1, h2, nw, dl
    ))
    tables = tables_to_device(snap, np.zeros((64, 2), np.uint32), device="cpu")
    got = P_shape.shape_match(
        tables, m, cpu(np.asarray(h1).view(np.int32)),
        cpu(np.asarray(h2).view(np.int32)), cpu(np.asarray(nw)), cpu(np.asarray(dl)),
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 50  # the batch really matches


# -- the probe chains the shape_match kernel walks -------------------------
#
# The kernel ends a chain at its first never-written row (fid -1). That is
# exact only while no live key sits behind such a row in its own chain;
# the tests below walk every live key's chain after seeded churn.

M32 = 0xFFFFFFFF


def chain_walk(tab, probes=P_shape.MAX_PROBES):
    """Each live row of a [cap, 4] int32 table (fid >= 0) -> (its position
    in its own probe chain, or -1 when it sits off the chain's first
    `probes` rows; whether a never-written row (fid -1) precedes it)."""
    cap = tab.shape[0]
    live = np.nonzero(tab[:, 2] >= 0)[0]
    c1 = tab[live, 0].view(np.uint32).astype(np.uint64)
    c2 = tab[live, 1].view(np.uint32).astype(np.uint64)
    home = (c1 * P_shape.SLOT_MUL) & M32
    home ^= home >> P_shape.SLOT_SHIFT
    step = c2 | 1
    pos = np.full(len(live), -1)
    empty_before = np.zeros(len(live), bool)
    for p in range(probes):
        idx = ((home + p * step) & (cap - 1)).astype(np.int64)
        here = (idx == live) & (pos < 0)
        pos[here] = p
        empty_before |= (tab[idx, 2] == -1) & (pos < 0)
    return pos, empty_before


def assert_chains_unbroken(shapes):
    """Every live packed and hot row of a ShapeIndex (either package's)
    sits on its chain with no fid -1 row before it."""
    for name, tab in (("packed", shapes.arr_table), ("hot", shapes.arr_hot)):
        pos, empty_before = chain_walk(tab)
        assert (pos >= 0).all(), f"{name}: {(pos < 0).sum()} rows off their chain"
        assert not empty_before.any(), (
            f"{name}: {empty_before.sum()} live rows behind a never-written row")


def churn_shapes(index_cls, seed):
    """A RouteIndex of either package through seeded churn: a cold bulk
    load, a warm bulk load into the hot overlay, single adds, packed and
    hot removals (hot tombstones up to a hot rebuild), hot slot reuse, a
    compaction cycle with journaled mutations, and a salt rebuild. The
    chains are checked after every stage. -> the index."""
    rng = np.random.default_rng(seed)
    ri = index_cls()
    cold = list(dict.fromkeys(seeded_filters(rng, 3000)))
    ri.bulk_add(cold)
    assert_chains_unbroken(ri.shapes)
    warm = [f"w/{k}/+/{int(x)}/#" for k, x in enumerate(rng.integers(0, 50, size=600))]
    ri.bulk_add(warm)
    assert_chains_unbroken(ri.shapes)
    singles = [f"q/{k}/x" for k in range(300)] + [f"$SYS/{k}/+" for k in range(100)]
    for f in singles:
        ri.add(f)
    for f in cold[::4] + warm[::3] + singles[::2]:
        ri.remove(f)  # packed and hot tombstones (and a hot rebuild)
    assert ri.shapes.packed_tombstones > 0
    assert_chains_unbroken(ri.shapes)
    for f in singles[::2]:
        ri.add(f)  # hot slots reused over tombstones
    assert_chains_unbroken(ri.shapes)
    cap = ri.shapes.begin_compact()
    for f in warm[1::3][:50]:
        ri.remove(f)  # journaled: replayed at apply
    for k in range(60):
        ri.add(f"late/{k}/+")
    built = ri.shapes.build_compact(cap)
    assert ri.shapes.apply_compact(built) is not None
    assert_chains_unbroken(ri.shapes)
    for k in range(200):
        ri.add(f"after/{k}/#")
    for k in range(0, 200, 3):
        ri.remove(f"after/{k}/#")
    assert_chains_unbroken(ri.shapes)
    ri.shapes.rebuild(ri.shapes.salt + 1)
    assert_chains_unbroken(ri.shapes)
    for f in singles[1::2]:
        ri.remove(f)
    for k in range(100):
        ri.add(f"final/{k}/+/+")
    assert_chains_unbroken(ri.shapes)
    return ri


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("package", ["torch", "jax"])
def test_shape_chains_hold_no_empty_row_before_a_live_key(package, seed):
    """The host tables of both packages (the port's mirrors, and the JAX
    tables the card tests upload) keep every live key's chain free of
    never-written rows through every kind of churn."""
    from emqx_tpu_torch.ops import route_index as P_ri

    ri = churn_shapes(P_ri.RouteIndex if package == "torch" else J_ri.RouteIndex, seed)
    assert ri.shapes.hot_live > 0 and len(ri.shapes) > 1000


@pytest.mark.parametrize("load", [0.5, 0.8, 0.95])
def test_build_table_kicks_keep_chains_unbroken(load):
    """`_build_table` at a load that forces cuckoo kicks (and, at 0.95,
    table doublings) still leaves no never-written row before a key."""
    rng = np.random.default_rng(int(load * 100))
    T_cap = 1 << 12
    n = int(load * T_cap)
    c1 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    c2 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    sid = rng.integers(0, 64, size=n).astype(np.int64)
    fid = np.arange(n, dtype=np.int64)
    tab, cap = P_shape.ShapeIndex._build_table(sid, c1, c2, fid, T_cap)
    pos, empty_before = chain_walk(tab)
    assert len(pos) == n and (pos >= 0).all() and not empty_before.any()
    if load >= 0.8:
        assert (pos >= 4).any()  # deep placements: kicks and late rounds ran


def early_stop_match(snap, M, h1, h2, nw, dl, probes):
    """numpy model of the kernel's chains: each ends at its first fid -1
    row; the first live hit in probe order wins, packed before hot."""
    from emqx_tpu_torch.ops.shape_index import FOLD1, FOLD2, _mix32_np, level_mul

    B, L = h1.shape
    mask = snap["shape_mask"][:M].astype(np.int64)
    plen = snap["shape_len"][:M].astype(np.int64)
    flags = snap["shape_flags"][:M].astype(np.int64)
    s1 = np.zeros((B, M), np.uint64)
    s2 = np.zeros((B, M), np.uint64)
    for l in range(L):
        bit = ((mask >> l) & 1).astype(np.uint64)
        s1 = (s1 + h1[:, l : l + 1].astype(np.uint64) * (bit * level_mul(l, 1))) & M32
        s2 = (s2 + h2[:, l : l + 1].astype(np.uint64) * (bit * level_mul(l, 2))) & M32
    sid = np.arange(M, dtype=np.uint64)
    c1 = _mix32_np((s1 ^ ((sid * FOLD1) & M32)).astype(np.uint32)).astype(np.uint64)
    c2 = _mix32_np((s2 ^ ((sid * FOLD2) & M32)).astype(np.uint32)).astype(np.uint64)
    nwc = nw.astype(np.int64)[:, None]
    ok_len = np.where((flags & 1 != 0)[None, :], nwc >= plen, nwc == plen)
    valid = ok_len & (plen >= 0)[None, :] & ~(dl[:, None] & (flags & 2 != 0)[None, :])
    home = (c1 * P_shape.SLOT_MUL) & M32
    home ^= home >> P_shape.SLOT_SHIFT
    step = c2 | 1
    out = np.full((B, M), -1, np.int64)
    found = np.zeros((B, M), bool)
    tomb = snap["shape_tomb"].view(np.uint32)
    for key, masked in (("shape_tab", True), ("shape_hot", False)):
        tab = snap[key].reshape(-1, 4)
        probing = valid & ~found
        for p in range(probes):
            idx = ((home + p * step) & (tab.shape[0] - 1)).astype(np.int64)
            row = tab[idx]
            hit = (probing & (row[..., 2] >= 0)
                   & (row[..., 0].view(np.uint32) == c1) & (row[..., 1].view(np.uint32) == c2)
                   & (row[..., 3] == sid.astype(np.int64)))
            if masked:
                hit &= ((tomb[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1) == 0
            out[hit] = row[..., 2][hit]
            found |= hit
            probing &= ~hit & (row[..., 2] != -1)
    return out.astype(np.int32)


@pytest.mark.parametrize("seed,probes", [(3, 8), (4, 8), (5, 1)])
def test_early_stop_chains_match_jax_on_churned_tables(seed, probes):
    """The kernel's chain rule, modelled in numpy on the port's churned
    tables, equals JAX's `shape_match_device` (which walks every probe)
    lane for lane."""
    from emqx_tpu_torch.ops import route_index as P_ri

    ri = churn_shapes(P_ri.RouteIndex, seed)
    rng = np.random.default_rng(seed + 20)
    topics = seeded_topics(rng, 300) + [f"after/{k}/x/y" for k in range(0, 200, 2)] \
        + [f"final/{k}/a/b" for k in range(50)] + [f"q/{k}/x" for k in range(60)]
    mat, lens, _ = J_tok.encode_topics(topics, 64)
    h1, h2, nw, dl = (np.asarray(x) for x in j_tokenize(
        jnp.asarray(mat), jnp.asarray(lens), ri.salt, 8))
    snap = {k: v.copy() for k, v in ri.shapes.device_snapshot().items()}
    m = ri.shapes.m_active()
    want = np.asarray(j_shape_match_probes({k: jnp.asarray(v) for k, v in snap.items()}, m,
                                    jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(nw),
                                    jnp.asarray(dl), probes))
    got = early_stop_match(snap, m, h1, h2, nw, dl, probes)
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 100


@pytest.mark.parametrize("W,K", [(2, 1), (8, 4), (16, 6), (1, 3), (3, 64), (5, 17),
                                 (33, 64), (4096, 64)])
def test_fanout_plain_matches_jax(W, K):
    rng = np.random.default_rng(W * 10 + K)
    B = 200 if W <= 64 else 4  # the twin expands every bit: B x W x 32 int64
    sub = rng.integers(0, 1 << 32, size=(64, W), dtype=np.uint64).astype(np.uint32)
    sub[::3] = 0  # all-zero bitmap rows
    sub[1, 0] = 0xFFFFFFFF
    matched = rng.integers(-1, 64, size=(B, K)).astype(np.int32)
    holes = max(1, B // 20)
    matched[:holes] = -1  # rows with no match at all
    matched[holes] = np.arange(K) % 5 + 1  # every lane valid, fids repeated
    want, want_pop = j_fanout(jnp.asarray(sub), jnp.asarray(matched))
    got, pop = P_router.fanout_bitmaps(cpu(sub.view(np.int32)), cpu(matched))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    np.testing.assert_array_equal(pop.numpy(), np.asarray(want_pop))


# the kernel's regime edges: teams of 1-32 lanes up to W = 128 words, a
# warp a row past it, rounds of 128 x 4 words; kslot under, at and past a
# 16-byte group of slots
COMPACT_EDGES = [(W, kslot) for W in (1, 3, 4, 5, 31, 32, 33, 128, 129, 512)
                 for kslot in (1, 64, 300)]


@pytest.mark.parametrize("W,kslot", [(2, 1), (8, 7), (8, 64), (8, 256), (4, 200), (64, 64)]
                         + COMPACT_EDGES)
def test_compact_plain_matches_jax(W, kslot):
    rng = np.random.default_rng(W + kslot)
    B = 120
    dens = rng.choice([0.0, 0.01, 0.1, 0.6], size=B)
    bits = rng.random((B, W * 32)) < dens[:, None]
    bm = np.packbits(bits, axis=1, bitorder="little").view(np.uint32).copy()
    bm[0] = 0
    bm[1] = 0xFFFFFFFF  # W*32 set bits: past any kslot < W*32
    bm[2] = 0
    bm[2, -1] = 0x80000001  # set only in the last word
    want = j_compact(jnp.asarray(bm), kslot)
    got = P_router.compact_fanout_slots(cpu(bm.view(np.int32)), kslot)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    if kslot < W * 32:
        assert bool(got[2][1])


def test_cpu_wrappers_run_the_twins_and_count_no_launch():
    kernels.reset_launches()
    mat, lens, _ = P_tok.encode_topics(EDGE_TOPICS, 64)
    out = P_tok.tokenize(cpu(mat), cpu(lens), 0, 8)
    twin = P_tok.tokenize_plain(cpu(mat), cpu(lens), 0, 8)
    for a, b in zip(out, twin):
        assert torch.equal(a, b)
    bits = torch.tensor([[5, 0], [-1, 3]], dtype=torch.int32)
    assert torch.equal(P_router.compact_fanout_slots(bits, 4)[0],
                       P_router.compact_fanout_slots_plain(bits, 4)[0])
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wrappers_check_their_inputs():
    mat, lens, _ = P_tok.encode_topics(["a/b"], 16)
    with pytest.raises(TypeError, match="int32"):
        P_tok.tokenize(cpu(mat), cpu(lens).to(torch.int64), 0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        P_router.compact_fanout_slots(torch.zeros((4, 8), dtype=torch.int32).t(), 4)
    with pytest.raises(ValueError, match="kslot"):
        P_router.compact_fanout_slots(torch.zeros((4, 8), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="2 dims"):
        P_router.fanout_bitmaps(torch.zeros(8, dtype=torch.int32),
                                torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="devices"):
        kernels.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


def test_launch_path_raises_counts_and_resolves_every_launcher(monkeypatch):
    """`kernels.launch` through a stand-in library: a nonzero launch code
    raises with the kernel's name and the runtime's message and counts
    nothing; a zero code counts one; every C launcher of the signature
    table resolves once, into the cache that later launches use."""
    from emqx_tpu_torch.kernels import build

    calls, rc = [], [700]
    lib = types.SimpleNamespace(emqx_cuda_error_string=lambda code: b"an illegal access")
    for name in build._SIGNATURES:
        setattr(lib, name, lambda *a, _n=name: calls.append((_n, a)) or rc[0])
    streams = []
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(kernels, "_launchers", {})
    monkeypatch.setattr(kernels, "_raw_stream", lambda index: streams.append(index) or 4321)
    kernels.reset_launches()
    dev = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match=r"^narrow_i16: .*\(700: an illegal access\)"):
        kernels.launch("narrow_i16", "emqx_narrow_i16", dev, 11, 22, 3)
    assert calls == [("emqx_narrow_i16", (11, 22, 3, 4321))] and streams == [0]
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    rc[0] = 0
    kernels.launch("fanout_bitmaps", "emqx_fanout_bitmaps", dev, *range(9))
    assert calls[-1] == ("emqx_fanout_bitmaps", (*range(9), 4321))
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"fanout_bitmaps": 1}
    for name in build._SIGNATURES:
        assert kernels.launcher(name) is getattr(lib, name)
    assert set(kernels._launchers) == set(build._SIGNATURES)
    # resolved once: later launches never go back to the library
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "library_path", lambda: pytest.fail("library reloaded"))
    kernels.launch("narrow_i16", "emqx_narrow_i16", dev, 1, 2, 3)
    assert kernels.LAUNCHES["narrow_i16"] == 1
    kernels.reset_launches()


def test_every_c_launcher_matches_its_ctypes_signature():
    """Each `build._SIGNATURES` entry names an exported launcher of
    `csrc/` with as many parameters (a ctypes call with too few or too
    many arguments would reach the card unchecked)."""
    from emqx_tpu_torch.kernels import build

    exported = {}
    for src in build.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r"EMQX_EXPORT\s+\w+\s+(emqx_\w+)\s*\(([^)]*)\)", text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            exported[m.group(1)] = len(params)
    for name, argtypes in build._SIGNATURES.items():
        assert exported.get(name) == len(argtypes), name


# -- on the card: each kernel against its twin (skips without CUDA) -------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_twins_on_card(cuda_device):
    dev = cuda_device
    j = churned_index(5)
    topics = seeded_topics(np.random.default_rng(5), 1000)
    mat, lens, _ = P_tok.encode_topics(topics, 64)
    bm, ln = cpu(mat).to(dev), cpu(lens).to(dev)
    kernels.reset_launches()
    tok = P_tok.tokenize(bm, ln, j.salt, 8)
    twin = P_tok.tokenize_plain(bm, ln, j.salt, 8)
    for a, b in zip(tok, twin):
        assert torch.equal(a, b)
    sub = np.random.default_rng(1).integers(
        0, 1 << 32, size=(j.num_filters_capacity + 64, 8), dtype=np.uint64
    ).astype(np.uint32)
    tables = tables_to_device(j.shapes.device_snapshot(), sub, device=dev)
    m = j.shapes.m_active()
    matched = P_shape.shape_match(tables, m, *tok)
    assert torch.equal(matched, P_shape.shape_match_plain(tables, m, *tok))
    fan = P_router.fanout_bitmaps(tables["sub_bitmaps"], matched)
    for a, b in zip(fan, P_router.fanout_bitmaps_plain(tables["sub_bitmaps"], matched)):
        assert torch.equal(a, b)
    for kslot in (1, 64, 300):
        for a, b in zip(P_router.compact_fanout_slots(fan[0], kslot),
                        P_router.compact_fanout_slots_plain(fan[0], kslot)):
            assert torch.equal(a, b)
    assert kernels.LAUNCHES == {"tokenize": 1, "shape_match": 1,
                                "fanout_bitmaps": 1, "compact_fanout_slots": 3,
                                "vocab_lookup": 0, "nfa_walk": 0, "segment_scatter": 0,
                                "sparse_fanout_slots": 0, "share_pick": 0,
                                "occurrence_index": 0, "row_lengths": 0, "narrow_i16": 0,
                                "session_sweep": 0, "semantic_match": 0, "rule_masks": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("K", [1, 4, 64])
@pytest.mark.parametrize("W", [1, 3, 4, 8, 33, 2048, 4096])
def test_fanout_kernel_matches_twin_on_card(cuda_device, W, K, offset):
    """Both teams (a warp a row up to W = 128, a block past it), both store
    policies, 16-byte and scalar words: a table whose base lies 4 bytes off
    a 16-byte boundary (offset 1) takes the scalar words at every W."""
    dev = cuda_device
    rng = np.random.default_rng(W * 1000 + K * 10 + offset)
    F = 300
    B = 512 if W <= 128 else 64  # the twin expands every bit: B x W x 32 int64
    sub = rng.integers(0, 1 << 32, size=(F, W), dtype=np.uint64).astype(np.uint32)
    sub[::3] = 0
    base = torch.empty(F * W + offset, dtype=torch.int32, device=dev)
    table = base[offset:].view(F, W)
    table.copy_(torch.from_numpy(sub.view(np.int32)))
    dens = rng.choice([0.0, 0.01, 0.3, 1.0], size=B)
    matched = np.where(rng.random((B, K)) < dens[:, None],
                       rng.integers(0, F, size=(B, K)), -1).astype(np.int32)
    matched[1] = np.arange(K) % 5 + 1  # every lane valid, fids repeated
    m = torch.from_numpy(matched).to(dev)
    kernels.reset_launches()
    want = P_router.fanout_bitmaps_plain(table, m)
    for streaming in (False, True):
        got = P_router.fanout_bitmaps(table, m, streaming=streaming)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert kernels.LAUNCHES["fanout_bitmaps"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("W", [1, 3, 4, 7, 8, 33, 128, 129, 4096])
def test_compact_kernel_matches_twin_on_card(cuda_device, W, offset):
    """Both regimes (a team of T lanes a row up to W = 128, a warp a row
    past it), 16-byte and scalar words (a base 4 bytes off a 16-byte
    boundary, offset 1, takes the scalar words at every W), slots padded
    with 16-byte stores (kslot 64) and scalar ones (1, 300), lane bases 0
    and W x 32 through the shard form; one launch a call."""
    dev = cuda_device
    rng = np.random.default_rng(W * 10 + offset)
    B = 1000 if W <= 128 else 64  # the twin expands every bit: B x W x 32 int64
    dens = rng.choice([0.0, 0.0005, 0.01, 0.3], size=B)
    bits = rng.random((B, W * 32)) < dens[:, None]
    bm = np.packbits(bits, axis=1, bitorder="little").view(np.uint32).copy()
    bm[1] = 0xFFFFFFFF
    bm[2] = 0
    bm[2, -1] = 0x80000001
    base = torch.empty(B * W + offset, dtype=torch.int32, device=dev)
    table = base[offset:].view(B, W)
    table.copy_(torch.from_numpy(bm.view(np.int32)))
    kernels.reset_launches()
    calls = 0
    for kslot in (1, 64, 300):
        got = P_router.compact_fanout_slots(table, kslot)
        want = P_router.compact_fanout_slots_plain(table, kslot)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for lane_base in (0, W * 32):
            got = P_router.compact_fanout_slots_shard(table, kslot, lane_base)
            want = P_router.compact_fanout_slots_shard_plain(table, kslot, lane_base)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)
        calls += 3
    assert kernels.LAUNCHES["compact_fanout_slots"] == calls


def ragged_topic_rows(rng, B, MB):
    """B topic rows for a width MB, with their lengths: edge topics, `$`
    topics, rows deeper than any L, rows cut short of their bytes (so
    '/' and word bytes lie past the length), and lengths below 0 and past
    MB; bytes past each topic are seeded noise, '/' among them."""
    topics = EDGE_TOPICS + ["$", "$a/b", "/" * 40, "a" * 200, ""] \
        + ["/".join(str(k) for k in range(d)) for d in range(1, 40)]
    topics += seeded_topics(rng, B - len(topics))
    mat, lens, _ = P_tok.encode_topics(topics[:B], MB)
    noise = rng.choice(np.frombuffer(b"ab/$x/", np.uint8), size=mat.shape)
    past = np.arange(MB)[None, :] >= lens[:, None]
    mat = np.where(past, noise, mat).astype(np.uint8)
    lens = lens.astype(np.int32)
    cut = rng.random(B) < 0.15
    lens[cut] = (lens[cut] * rng.random(cut.sum())).astype(np.int32)
    lens[5::41] = -int(rng.integers(1, 9))
    lens[7::43] = MB + int(rng.integers(1, 9))
    return mat, lens


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 4, 8, 16, 17])
@pytest.mark.parametrize("MB", [16, 32, 33, 64, 128])
def test_tokenize_kernel_at_ragged_shapes_on_card(cuda_device, MB, L):
    """Every instance of the kernel (L = 4, 8, 16 and the generic L; whole
    rows preloaded at MB = 32 and 64 on an aligned base, bytes at any other
    width or base) against the twin, on an aligned base and on one 1-15
    bytes off a 16-byte boundary (the byte path at every MB)."""
    dev = cuda_device
    rng = np.random.default_rng(MB * 100 + L)
    B = 700
    mat, lens = ragged_topic_rows(rng, B, MB)
    ln = torch.from_numpy(lens).to(dev)
    kernels.reset_launches()
    for off in (0, 1 + (MB * 7 + L) % 15):
        raw = torch.empty(B * MB + off + 16, dtype=torch.uint8, device=dev)
        bm = raw[off : off + B * MB].view(B, MB)
        bm.copy_(torch.from_numpy(mat))
        assert (bm.data_ptr() % 16 == 0) == (off == 0)
        got = P_tok.tokenize(bm, ln, 3, L)
        want = P_tok.tokenize_plain(bm, ln, 3, L)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert kernels.LAUNCHES["tokenize"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 17])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("probes", [1, 8])
@pytest.mark.parametrize("M", [1, 4, 64, 68])
def test_shape_match_kernel_on_churned_tables_on_card(cuda_device, M, probes, offset, L):
    """The kernel against its twin on `churned_index` tables (packed and
    hot tombstones, hot rows), M past the live shapes (dead shapes), one
    probe and eight, h1/h2 on a base 4 bytes off a 16-byte boundary
    (offset 1: the word path)."""
    dev = cuda_device
    j = churned_index(11, max_shapes=128)
    topics = seeded_topics(np.random.default_rng(M + probes), 900)
    mat, lens, _ = P_tok.encode_topics(topics, 64)
    tok = P_tok.tokenize_plain(cpu(mat), cpu(lens), j.salt, L)
    B = len(topics)
    hs = []
    for h in tok[:2]:
        raw = torch.empty(B * L + offset + 4, dtype=torch.int32, device=dev)
        v = raw[offset : offset + B * L].view(B, L)
        v.copy_(h)
        hs.append(v)
    nw, dl = tok[2].to(dev), tok[3].to(dev)
    tables = tables_to_device(j.shapes.device_snapshot(), np.zeros((64, 2), np.uint32),
                              device=dev)
    assert j.shapes.m_active() < 68 <= tables["shape_len"].shape[0]
    kernels.reset_launches()
    got = P_shape.shape_match(tables, M, *hs, nw, dl, probes)
    want = P_shape.shape_match_plain(tables, M, *hs, nw, dl, probes)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert kernels.LAUNCHES["shape_match"] == 1
    if M >= 4 and probes == 8:
        assert (want >= 0).sum() > 50
