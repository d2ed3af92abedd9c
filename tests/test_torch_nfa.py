"""The residual-NFA lane of the port against the JAX package.

`vocab_lookup` (port) against `vocab_lookup_device`, and `batch_match_syms`
(port) against `emqx_tpu.ops.matcher.batch_match_syms`, on the same NFA
tables (an `emqx_tpu` `NfaBuilder`'s `device_snapshot()`, uploaded with
`convert.upload`) and the same topic bytes. The cases are those of
`tests/test_matcher.py`. The port runs on the CPU (the kernels' plain
twins); the `cuda`-marked tests at the end hold the kernels against the
twins on a card. Tolerance: EXACT equality of every output, the order of
`matched` included — all are integers.

The chain tests walk every live edge's probe chain in both packages' NFA
builders through seeded churn (growth, a tombstone-heavy phase, an
in-place compaction): no never-written slot (-1) may lie before a live
edge within `MAX_PROBES` slots. `nfa_walk.cu` ends a chain at its first
-1 slot, which is exact only while that holds.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.ops import matcher as J_matcher
from emqx_tpu.ops import nfa as J_nfa
from emqx_tpu.ops import tokenizer as J_tok
from emqx_tpu.ops import topics as J_topics
from emqx_tpu.ops.nfa import NfaBuilder
from emqx_tpu_torch import kernels
from emqx_tpu_torch.convert import upload
from emqx_tpu_torch.ops import matcher as P_matcher
from emqx_tpu_torch.ops import nfa as P_nfa
from emqx_tpu_torch.ops import tokenizer as P_tok

j_tokenize = jax.jit(J_tok.tokenize_device, static_argnums=(2, 3))
j_vocab = jax.jit(J_tok.vocab_lookup_device, static_argnums=(3,))


def cpu(a):
    return torch.from_numpy(np.array(a))


def builder_for(filters, removes=(), readds=()):
    b = NfaBuilder()
    for f in filters:
        b.add(f)
    for f in removes:
        b.remove(f)
    for f in readds:
        b.add(f)
    return b


def tokenized(builder, topics, max_levels, max_bytes=64):
    mat, lens, _ = J_tok.encode_topics(topics, max_bytes)
    return j_tokenize(jnp.asarray(mat), jnp.asarray(lens), builder.salt, max_levels)


def assert_match_equal(got, want):
    for g, w, name in zip(got[:3], want[:3], ("matched", "mcount", "flags")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k].numpy(), np.asarray(want[3][k]), err_msg=k)


def run_both(builder, topics, max_levels=16, frontier=32, max_matches=64, probes=8):
    """JAX: tokenize -> vocab_lookup_device -> batch_match_syms; port: the
    same syms (checked equal) -> vocab_lookup -> batch_match_syms."""
    snap = builder.device_snapshot()
    h1, h2, nw, dl = tokenized(builder, topics, max_levels)
    j_tables = {k: jnp.asarray(v) for k, v in snap.items()}
    j_syms = j_vocab(j_tables, h1, h2, probes)
    want = J_matcher.batch_match_syms(
        j_tables, j_syms, nw, dl, frontier=frontier, max_matches=max_matches, probes=probes
    )
    tables = upload(snap, device="cpu")
    p_h1 = cpu(np.asarray(h1).view(np.int32))
    p_h2 = cpu(np.asarray(h2).view(np.int32))
    syms = P_tok.vocab_lookup(tables, p_h1, p_h2, probes)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(j_syms))
    got = P_matcher.batch_match_syms(
        tables, syms, cpu(np.asarray(nw)), cpu(np.asarray(dl)),
        frontier=frontier, max_matches=max_matches, probes=probes,
    )
    assert_match_equal(got, want)
    return got


def random_case(seed):
    rng = random.Random(seed)
    words = ["a", "b", "c", "d", "sensor", "dev", "", "long-word-x"]
    filters = set()
    for _ in range(400):
        ws = ["+" if rng.random() < 0.15 else rng.choice(words)
              for _ in range(rng.randint(1, 7))]
        if rng.random() < 0.2:
            ws.append("#")
        f = "/".join(ws)
        try:
            J_topics.validate(f)
            filters.add(f)
        except J_topics.TopicValidationError:
            pass
    filters = sorted(filters)
    topics = []
    for _ in range(500):
        ws = [rng.choice(words) for _ in range(rng.randint(1, 8))]
        if rng.random() < 0.1:
            ws[0] = "$" + ws[0]
        topics.append("/".join(ws))
    removes = [f for f in filters if rng.random() < 0.5]
    return filters, removes, topics


def grid_filters():
    return [f"{a}/{b}/{c}" for a in "+ab" for b in "+ab" for c in "+ab"]


# (filters, removes, re-adds, topics, config): tests/test_matcher.py's cases
CASES = {
    "basic": (
        ["a/b/c", "a/+/c", "a/#", "#", "+/b/c", "a/b/+", "x/y"], [], [],
        ["a/b/c", "a/b", "a", "x/y", "x/z", "q", "a/q/c", "a/b/q"], {},
    ),
    "hash_parent": (["a/#", "a", "a/b/#"], [], [], ["a", "a/b", "a/b/c", "b"], {}),
    "dollar": (
        ["#", "+/x", "$SYS/#", "$SYS/+", "$share-ish/x"], [], [],
        ["$SYS/x", "$SYS", "n/x", "$share-ish/x", "$other/x", "$SYS/a/b"], {},
    ),
    "empty_levels_oov": (
        ["a/+/c", "a//c", "+/+", "//#"], [], [],
        ["a//c", "a/zz/c", "/", "//", "a/", "/a", "never/seen", ""], {},
    ),
    "plus_only_root_hash": (
        ["+", "#", "+/+"], [], [], ["a", "a/b", "a/b/c", "$sys", "$sys/b"], {},
    ),
    "delete": (
        ["a/+", "a/b", "b/#"], ["a/+", "b/#"], ["a/+"],
        ["a/b", "a/x", "b/q", "b"], {},
    ),
    "too_deep": (
        ["a/#", "a/+/+/+"], [], [], ["a/" + "/".join("x" * 10), "a/b", "a/b/c/d/e"],
        {"max_levels": 4},
    ),
    "frontier_overflow": (
        grid_filters(), [], [], ["a/b/a", "b/b/b", "a/a/a", "c/c/c"], {"frontier": 2},
    ),
    "match_overflow": (
        ["a/#", "a/+", "a/b", "#", "+/b"], [], [], ["a/b", "c/d"], {"max_matches": 2},
    ),
    "literal_plus_in_topic": (["a/+", "a/#"], [], [], ["a/+", "a/#", "a/b"], {}),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["random-1", "random-2", "random-3"])
def test_batch_match_syms_matches_jax(case):
    if case.startswith("random-"):
        seed = int(case.split("-")[1])
        filters, removes, topics = random_case(seed)
        # seed 2 with narrow caps (overflow rows), seed 3 with a frontier
        # wider than one warp (the kernel's chunk loop)
        cfg = {1: {}, 2: {"frontier": 4, "max_matches": 6},
               3: {"frontier": 40, "max_matches": 40}}[seed]
        builder = builder_for(filters)
        run_both(builder, topics, max_levels=8, **cfg)
        for f in removes:
            builder.remove(f)
        got = run_both(builder, topics, max_levels=8, **cfg)
    else:
        filters, removes, readds, topics, cfg = CASES[case]
        got = run_both(builder_for(filters, removes, readds), topics, **cfg)
    flags, causes = got[2], got[3]
    if case == "too_deep":
        assert bool(causes["too_deep"][0]) and not bool(flags[1])
    elif case == "frontier_overflow":
        assert bool(causes["frontier_overflow"].any())
    elif case == "match_overflow":
        assert bool(causes["match_overflow"][0])
    elif case in ("basic", "random-1"):
        assert int(got[1].sum()) > 0 and not bool(flags.any())


def test_vocab_lookup_matches_jax_with_tombstones_and_oov():
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(300)]
    filters = [f"{rng.choice(words)}/+/{rng.choice(words)}/#" for _ in range(400)]
    builder = builder_for(filters, removes=filters[::3])
    assert (builder.arr_vocab_sym == -3).any()  # tombstoned vocab slots
    topics = [f"{rng.choice(words)}/x/{rng.choice(words)}" for _ in range(300)]
    topics += ["never/seen/words", "", "w1", "$w2/w3"]
    h1, h2, _, _ = tokenized(builder, topics, 8)
    snap = builder.device_snapshot()
    for probes in (8, 3):
        want = np.asarray(j_vocab({k: jnp.asarray(v) for k, v in snap.items()}, h1, h2, probes))
        got = P_tok.vocab_lookup(
            upload(snap, device="cpu"), cpu(np.asarray(h1).view(np.int32)),
            cpu(np.asarray(h2).view(np.int32)), probes,
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want == -1).any()


def test_nfa_wrappers_check_their_inputs_and_count_no_cpu_launch():
    builder = builder_for(["a/+", "b/#"])
    tables = upload(builder.device_snapshot(), device="cpu")
    syms = torch.zeros((2, 4), dtype=torch.int32)
    nw = torch.ones(2, dtype=torch.int32)
    dl = torch.zeros(2, dtype=torch.bool)
    kernels.reset_launches()
    P_matcher.batch_match_syms(tables, syms, nw, dl, frontier=4, max_matches=4)
    P_tok.vocab_lookup(tables, syms, syms, 8)
    assert kernels.LAUNCHES["nfa_walk"] == 0 and kernels.LAUNCHES["vocab_lookup"] == 0
    with pytest.raises(ValueError, match="frontier"):
        P_matcher.batch_match_syms(tables, syms, nw, dl, frontier=0)
    with pytest.raises(TypeError, match="int32"):
        P_matcher.batch_match_syms(tables, syms.to(torch.int64), nw, dl)
    bad = dict(tables, edge_node=tables["edge_node"][:3].contiguous())
    with pytest.raises(ValueError, match="power of two"):
        P_matcher.batch_match_syms(bad, syms, nw, dl)
    with pytest.raises(ValueError, match="batch"):
        P_matcher.batch_match_syms(tables, syms, nw[:1].contiguous(), dl)


# -- probe chains under churn: the early exit's precondition ---------------


def churn_filters(seed, n):
    rng = random.Random(seed)
    words = [f"w{i}" for i in range(40)] + ["a", "b", "c", "d"]
    out = set()
    while len(out) < n:
        ws = ["+" if rng.random() < 0.2 else rng.choice(words)
              for _ in range(rng.randint(1, 6))]
        if rng.random() < 0.15:
            ws.append("#")
        out.add("/".join(ws))
    return sorted(out)


def churn_steps(seed):
    """Both packages' `NfaBuilder`s through the same seeded churn: 1,200
    filters added (the edge table grows), eight rounds that remove the 300
    oldest and add 300 new ones (tombstones left and reused; a growth
    rehash on the way), then removals 50 at a time down to 100 live
    filters (tombstone-heavy, up to the in-place compaction), and 300
    added back. Yields (label, jax builder, port builder, the port
    builder's edge rehashes) after each step."""
    builders = (J_nfa.NfaBuilder(), P_nfa.NfaBuilder())
    rehash = {"grow": 0, "compact": 0, "tombstones_dropped": 0}
    port = builders[1]
    orig = port._edge_rehash

    def counted(newE):
        rehash["grow" if newE > port._E else "compact"] += 1
        rehash["tombstones_dropped"] += int((port.arr_edge_node == P_nfa.EDGE_TOMB).sum())
        orig(newE)

    port._edge_rehash = counted

    def apply(op, filters):
        for f in filters:
            for b in builders:
                getattr(b, op)(f)

    pool = churn_filters(seed, 6000)
    live, nxt = pool[:1200], 1200
    apply("add", live)
    yield "added", builders[0], port, rehash
    for r in range(8):
        apply("remove", live[:300])
        yield f"round {r} removed", builders[0], port, rehash
        apply("add", pool[nxt:nxt + 300])
        live, nxt = live[300:] + pool[nxt:nxt + 300], nxt + 300
        yield f"round {r} added", builders[0], port, rehash
    while len(live) > 100:
        apply("remove", live[:50])
        live = live[50:]
        yield f"{len(live)} live", builders[0], port, rehash
    apply("add", pool[:150] + pool[nxt:nxt + 150])
    yield "added back", builders[0], port, rehash


def chain_breaks(builder, hash_fn):
    """The live edges (node, sym) whose probe chain meets a never-written
    slot (-1) before the edge's own slot, or misses it, within
    `MAX_PROBES` slots."""
    E = builder._E
    en, es = builder.arr_edge_node, builder.arr_edge_sym
    bad = []
    for node, sym in builder._edges:
        slot = hash_fn(node, sym) & (E - 1)
        for p in range(P_nfa.MAX_PROBES):
            idx = (slot + p) & (E - 1)
            if en[idx] == node and es[idx] == sym:
                break
            if en[idx] == -1:
                bad.append((node, sym))
                break
        else:
            bad.append((node, sym))
    return bad


def tombstones(builder) -> float:
    return float((builder.arr_edge_node == P_nfa.EDGE_TOMB).mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_chains_hold_no_empty_slot_before_a_live_edge(seed):
    most = 0.0
    for label, j, p, rehash in churn_steps(seed):
        assert chain_breaks(j, J_nfa.edge_slot_hash) == [], label
        assert chain_breaks(p, P_nfa.edge_slot_hash) == [], label
        js, ps = j.device_snapshot(), p.device_snapshot()
        for k in ("edge_node", "edge_sym", "edge_child"):
            np.testing.assert_array_equal(ps[k], js[k], err_msg=f"{label}: {k}")
        most = max(most, tombstones(p))
    assert rehash["grow"] >= 1 and rehash["compact"] >= 1, rehash
    assert rehash["tombstones_dropped"] > 0 and most > 0.2, (rehash, most)


def vocab_chain_breaks(builder):
    """The live words whose vocab probe chain meets a never-written slot
    (vocab_sym -1) before the word's own slot, or misses it, within
    `MAX_PROBES` slots."""
    V = builder._V
    h1a, h2a, syma = builder.arr_vocab_h1, builder.arr_vocab_h2, builder.arr_vocab_sym
    bad = []
    for word, (sym, _refs, h1, h2) in builder._vocab.items():
        slot = P_nfa.vocab_slot_hash(h1) & (V - 1)
        for p in range(P_nfa.MAX_PROBES):
            idx = (slot + p) & (V - 1)
            if syma[idx] == sym and h1a[idx] == np.uint32(h1) and h2a[idx] == np.uint32(h2):
                break
            if syma[idx] == -1:
                bad.append(word)
                break
        else:
            bad.append(word)
    return bad


def vocab_churn_steps(seed):
    """Both packages' `NfaBuilder`s through seeded word churn: filters of
    two fresh words each (`w{i}/x{i}`) and a shared tail word, 900 added
    (the vocab grows past 1,024 slots), then twelve rounds that remove 150
    random live filters and add 150 new ones (their words' last filter
    goes: tombstones, reused by later inserts, and the tombstone-clearing
    rehash), then removals down to 40 live filters. Yields (label, jax
    builder, port builder) after each step."""
    rng = random.Random(seed)
    builders = (J_nfa.NfaBuilder(), P_nfa.NfaBuilder())
    nxt = 0

    def fresh(n):
        nonlocal nxt
        out = [f"w{i}/x{i}/{rng.choice('abc')}" for i in range(nxt, nxt + n)]
        nxt += n
        return out

    def apply(op, filters):
        for f in filters:
            for b in builders:
                getattr(b, op)(f)

    yield "empty", builders[0], builders[1]
    live = fresh(900)
    apply("add", live)
    yield "added", builders[0], builders[1]
    for r in range(12):
        gone = set(rng.sample(range(len(live)), 150))
        apply("remove", [live[i] for i in sorted(gone)])
        live = [f for i, f in enumerate(live) if i not in gone]
        yield f"round {r} removed", builders[0], builders[1]
        new = fresh(150)
        apply("add", new)
        live += new
        yield f"round {r} added", builders[0], builders[1]
    while len(live) > 40:
        apply("remove", live[:60])
        live = live[60:]
        yield f"{len(live)} live", builders[0], builders[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_vocab_chains_hold_no_empty_slot_before_a_live_word(seed):
    """`vocab_lookup.cu` ends a lane's probe chain at its first
    never-written slot: exact only while no live word sits behind a -1
    within `MAX_PROBES` slots. Both packages' builders through word churn
    (tombstones, their reuse, growth and the tombstone-clearing rehash),
    every live word walked after every step."""
    tombs = 0
    grown = set()
    for label, j, p in vocab_churn_steps(seed):
        assert J_nfa.vocab_slot_hash(12345) == P_nfa.vocab_slot_hash(12345)
        assert vocab_chain_breaks(j) == [], label
        assert vocab_chain_breaks(p) == [], label
        for k in ("vocab_h1", "vocab_h2", "vocab_sym"):
            np.testing.assert_array_equal(p.device_snapshot()[k], j.device_snapshot()[k],
                                          err_msg=f"{label}: {k}")
        tombs = max(tombs, int((p.arr_vocab_sym == P_nfa.VOCAB_TOMB).sum()))
        grown.add(p._V)
    assert tombs > 0 and len(grown) > 1, (tombs, grown)


def walk_topics(seed, n):
    """Topics over the churn's words: `$` topics, rows deeper than 8
    levels, and the all-`a` topics that open the widest frontiers."""
    rng = random.Random(seed)
    words = [f"w{i}" for i in range(40)] + ["a", "b", "c", "d", "zz"]
    topics = []
    for _ in range(n):
        ws = [rng.choice(words) for _ in range(rng.randint(1, 10))]
        if rng.random() < 0.1:
            ws[0] = "$" + ws[0]
        topics.append("/".join(ws))
    return topics + ["/".join("a" * k) for k in range(1, 10)] + ["$a/a", "a/a/a/a/a/a/a"]


def tombstone_heavy(seed):
    """The churn's (jax, port) builders at the first step past 18%
    tombstones (before the compaction), then wide-frontier filters: every
    7-level filter over {a, +}, a frontier of 2^k states at level k of
    a/a/a/a/a/a/a."""
    for _label, j, p, _rehash in churn_steps(seed):
        if tombstones(p) > 0.18:
            break
    else:
        raise AssertionError("the churn never passed 18% tombstones")
    for m in range(1 << 7):
        f = "/".join("+" if m >> i & 1 else "a" for i in range(7))
        j.add(f)
        p.add(f)
    assert tombstones(p) > 0.15
    return j, p


@pytest.mark.parametrize("cfg", [{}, {"frontier": 4, "max_matches": 6, "probes": 1},
                                 {"frontier": 200, "max_matches": 64}])
def test_batch_match_syms_matches_jax_on_a_tombstone_heavy_table(cfg):
    j, _p = tombstone_heavy(2)
    got = run_both(j, walk_topics(3, 300), max_levels=8, **cfg)
    assert bool(got[3]["too_deep"].any()) and int(got[1].sum()) > 0


# -- on the card: each kernel against its twin (skips without CUDA) -------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nfa_kernels_match_twins_on_card(cuda_device):
    dev = cuda_device
    filters, removes, topics = random_case(5)
    builder = builder_for(filters, removes)
    tables = upload(builder.device_snapshot(), device=dev)
    h1, h2, nw, dl = (cpu(np.asarray(a)) for a in tokenized(builder, topics, 8))
    h1, h2 = h1.view(torch.int32).to(dev), h2.view(torch.int32).to(dev)
    nw, dl = nw.to(dev), dl.to(dev)
    kernels.reset_launches()
    syms = P_tok.vocab_lookup(tables, h1, h2, 8)
    assert torch.equal(syms, P_tok.vocab_lookup_plain(tables, h1, h2, 8))
    for frontier, k in ((32, 64), (4, 6), (40, 40), (2, 2)):
        got = P_matcher.batch_match_syms(tables, syms, nw, dl, frontier=frontier,
                                         max_matches=k, probes=8)
        want = P_matcher.batch_match_syms_plain(tables, syms, nw, dl, frontier=frontier,
                                                max_matches=k, probes=8)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        for name in want[3]:
            assert torch.equal(got[3][name], want[3][name])
    assert kernels.LAUNCHES["vocab_lookup"] == 1 and kernels.LAUNCHES["nfa_walk"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [1, 8])
def test_nfa_walk_matches_twin_on_card_at_every_width(cuda_device, probes):
    """Both instances (a team of 8 lanes a row up to F = 64, a warp past
    it) on a tombstone-heavy table: `$` topics, rows deeper than L, rows
    that overflow F and K."""
    dev = cuda_device
    _j, p = tombstone_heavy(4)
    tables = upload(p.device_snapshot(), device=dev)
    mat, lens, _ = P_tok.encode_topics(walk_topics(5, 2000), 64)
    h1, h2, nw, dl = P_tok.tokenize(cpu(mat).to(dev), cpu(lens).to(dev), p.salt, 8)
    syms = P_tok.vocab_lookup(tables, h1, h2, probes)
    kernels.reset_launches()
    seen = dict.fromkeys(P_matcher.CAUSES, False)
    calls = 0
    for frontier in (1, 2, 4, 32, 33, 40, 65, 200):
        for k in (2, 6, 64):
            got = P_matcher.batch_match_syms(tables, syms, nw, dl, frontier=frontier,
                                             max_matches=k, probes=probes)
            want = P_matcher.batch_match_syms_plain(tables, syms, nw, dl,
                                                    frontier=frontier, max_matches=k,
                                                    probes=probes)
            torch.cuda.synchronize()
            for a, b, name in zip(got[:3], want[:3], ("matched", "mcount", "flags")):
                assert torch.equal(a, b), (frontier, k, name)
            for name in want[3]:
                assert torch.equal(got[3][name], want[3][name]), (frontier, k, name)
                seen[name] |= bool(want[3][name].any())
            calls += 1
    assert all(seen.values()), seen
    assert kernels.LAUNCHES["nfa_walk"] == calls  # one launch a call


# -- vocab_lookup on the card at the edges of its probe window -------------

M32 = 0xFFFFFFFF


def slots_of(a, V):
    """`vocab_slot_hash(a) & (V - 1)` over a uint32 array."""
    h = (a.astype(np.uint64) * P_nfa.VOCAB_H_MUL) & M32
    return ((h ^ (h >> P_nfa.VOCAB_H_SHIFT)) & (V - 1)).astype(np.int64)


def key_at(rng, V, slot):
    """A random h1 whose chain starts at `slot`."""
    while True:
        a = rng.integers(1, 1 << 32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
        hit = np.nonzero(slots_of(a, V) == slot)[0]
        if hit.size:
            return int(a[hit[0]])


class VocabSim:
    """A vocab table kept as the `NfaBuilder` keeps it (insert at the first
    -1 or tombstone of the chain, delete to a tombstone), so no live word
    sits behind a -1 within its window, plus slots written directly."""

    def __init__(self, V):
        self.V = V
        self.h1 = np.zeros(V, np.uint32)
        self.h2 = np.zeros(V, np.uint32)
        self.sym = np.full(V, -1, np.int32)

    def insert(self, a, b, s) -> bool:
        start = int(slots_of(np.array([a], np.uint32), self.V)[0])
        for p in range(P_nfa.MAX_PROBES):
            i = (start + p) % self.V
            if self.sym[i] in (-1, P_nfa.VOCAB_TOMB):
                self.put(i, a, b, s)
                return True
        return False

    def put(self, i, a, b, s):
        self.h1[i % self.V], self.h2[i % self.V], self.sym[i % self.V] = a, b, s

    def delete(self, a, b):
        hit = np.nonzero((self.h1 == a) & (self.h2 == b) & (self.sym >= 0))[0]
        self.sym[hit] = P_nfa.VOCAB_TOMB

    def tables(self, dev):
        return {"vocab_h1": torch.from_numpy(self.h1.view(np.int32).copy()).to(dev),
                "vocab_h2": torch.from_numpy(self.h2.view(np.int32).copy()).to(dev),
                "vocab_sym": torch.from_numpy(self.sym.copy()).to(dev)}


def vocab_edge_case(name, rng):
    """-> (VocabSim, query pairs [n, 2] uint32): one edge of the probe
    window a case; each table stays one an NfaBuilder could make."""
    if name in ("wrap", "tombstone_before_hit", "hit_at_probe_7", "past_probe_8"):
        V = 64
        sim = VocabSim(V)
        start = V - 2 if name == "wrap" else 5
        a = key_at(rng, V, start)
        at = {"wrap": 3, "tombstone_before_hit": 2, "hit_at_probe_7": 7, "past_probe_8": 8}[name]
        for p in range(at):  # the slots before: stale copies, or live words of the same chain
            if name == "tombstone_before_hit":
                sim.put(start + p, a, 77, P_nfa.VOCAB_TOMB)
            else:
                sim.put(start + p, key_at(rng, V, start), rng.integers(1, 1 << 32), 100 + p)
        sim.put(start + at, a, 77, 42)
        queries = [(a, 77), (a, 78), (a + 1, 77)]
        queries += [(int(sim.h1[i]), int(sim.h2[i])) for i in range(V) if sim.sym[i] >= 0]
        return sim, np.array(queries, np.uint32)
    if name == "all_past_depth":  # every lane asks for (0, 0); one table holds it
        sim = VocabSim(8)
        sim.insert(0, 0, 5)
        sim.insert(3, 4, 6)
        return sim, np.zeros((40, 2), np.uint32)
    V = int(name.split("_")[1])  # "V_1", "V_2", "V_8": windows that wrap round
    sim = VocabSim(V)
    pairs = rng.integers(1, 1 << 32, size=(3 * V + 4, 2), dtype=np.uint64).astype(np.uint32)
    placed = [p for i, p in enumerate(pairs) if sim.insert(int(p[0]), int(p[1]), i)]
    for p in placed[::3]:
        sim.delete(p[0], p[1])
    if placed:
        sim.insert(int(placed[0][0]), int(placed[0][1]), 99)  # a re-add into a tombstone
    queries = np.concatenate([pairs, np.zeros((2, 2), np.uint32)])
    return sim, queries


VOCAB_EDGES = ["wrap", "tombstone_before_hit", "hit_at_probe_7", "past_probe_8",
               "all_past_depth", "V_1", "V_2", "V_8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", VOCAB_EDGES)
def test_vocab_lookup_kernel_at_the_window_edges_on_card(cuda_device, name):
    """The kernel against its twin at the edges of a lane's probe window: a
    window wrapping past V - 1, tombstones (stale copies of the pair) before
    the hit, a hit at probe 7, a pair only past probe 8 (found with 9 or
    more probes), every lane asking for (0, 0), V = 1, 2 and 8; each over
    ragged B x L shapes of the same queries and probes 1, 3, 8, 9, 16."""
    rng = np.random.default_rng(VOCAB_EDGES.index(name))
    sim, queries = vocab_edge_case(name, rng)
    tables = sim.tables(cuda_device)
    kernels.reset_launches()
    calls = 0
    for B, L in ((1, 1), (3, 5), (len(queries), 1), (257, 7), (1000, 8)):
        pick = rng.integers(0, len(queries), size=B * L)
        q = torch.from_numpy(queries[pick].view(np.int32)).to(cuda_device)
        h1, h2 = q[:, 0].reshape(B, L).contiguous(), q[:, 1].reshape(B, L).contiguous()
        for probes in (1, 3, 8, 9, 16):
            got = P_tok.vocab_lookup(tables, h1, h2, probes)
            want = P_tok.vocab_lookup_plain(tables, h1, h2, probes)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, B, L, probes)
            calls += 1
    assert kernels.LAUNCHES["vocab_lookup"] == calls
    if name in ("wrap", "tombstone_before_hit", "hit_at_probe_7", "past_probe_8"):
        at = {"wrap": 3, "tombstone_before_hit": 2, "hit_at_probe_7": 7, "past_probe_8": 8}[name]
        one = torch.from_numpy(queries[:1].view(np.int32)).to(cuda_device)
        for probes in (at, at + 1):
            got = P_tok.vocab_lookup(tables, one[:, :1].contiguous(), one[:, 1:].contiguous(),
                                     probes)
            assert int(got[0, 0]) == (42 if probes > at else -1), (name, probes)
