"""Each kernel's plain PyTorch twin against the JAX function it replaces.

The port has four hand-written CUDA kernels (tokenize, shape_match,
fanout_bitmaps, compact_fanout_slots). On the CPU their wrappers run the
plain twins, which the card run (chip_smoke.py, and the `cuda`-marked
tests below) holds the kernels against. Here the twins are held against
`tokenize_device`, `shape_match_device`, `fanout_bitmaps` + `popcount32`
and `compact_fanout_slots` on the same seeded numpy inputs. Tolerance:
EXACT equality — every output is an integer.
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


def churned_index(seed):
    """A JAX RouteIndex whose shape tables carry packed rows, packed
    tombstones, hot-overlay rows and hot tombstones."""
    rng = np.random.default_rng(seed)
    j = J_ri.RouteIndex()
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


@pytest.mark.parametrize("W,kslot", [(2, 1), (8, 7), (8, 64), (8, 256), (4, 200), (64, 64)])
def test_compact_plain_matches_jax(W, kslot):
    rng = np.random.default_rng(W + kslot)
    B = 120
    dens = rng.choice([0.0, 0.01, 0.1, 0.6], size=B)
    bits = rng.random((B, W * 32)) < dens[:, None]
    bm = np.packbits(bits, axis=1, bitorder="little").view(np.uint32).copy()
    bm[0] = 0
    bm[1] = 0xFFFFFFFF  # W*32 set bits: past any kslot < W*32
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
                                "session_sweep": 0, "semantic_match": 0, "rule_masks": 0,
                                "group_counts": 0}


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
