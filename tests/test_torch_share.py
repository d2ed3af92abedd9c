"""The port's $share pick stage against the JAX package.

`GroupTable` (host, byte-identical snapshots and op-logs after the same
seeded operations), `stable_hash`, the plain twins of `share_pick` against
`share_pick_device` under all five strategies (with `group_rr` near 2^31,
empty groups, out-of-range sticky indices and -1 holes) and of
`occurrence_index` against `_occurrence_index` (with and without the
`gcap` range the CUDA kernel needs); the twin at GPF 1-5 and 8 (raw tables),
with `filter_groups` gids at and past Gcap, and the 32-bit size rule; then (`cuda` marker, skipped without a card)
both CUDA kernels against their twins.
Tolerance: EXACT equality — every output is an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.broker.shared_sub import stable_hash as j_stable_hash
from emqx_tpu.models import router_model as J_router
from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker.shared_sub import stable_hash as p_stable_hash
from emqx_tpu_torch.models import router_model as P_router


def test_stable_hash_matches():
    for s in (None, "", "a", "device/1/mid/2/leaf", "ünï/$share", "x" * 1000):
        assert p_stable_hash(s) == j_stable_hash(s)


def grouped_tables(seed, n_groups=300, n_fids=120):
    """The same seeded GroupTable in both packages: recycled gids, a GPF
    growth, empty groups, round-robin bases near 2^31, sticky indices in
    and out of range."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_groups):
        fid = int(rng.integers(0, n_fids))
        ops.append(("ensure", fid, f"r{fid}", f"g{i}"))
        ops.append(("len", int(rng.integers(0, 6))))
        ops.append(("rr", int((1 << 31) - 1 - rng.integers(0, 40)) if i % 2 else i))
        ops.append(("sticky", int(rng.integers(-2, 8))))
    for fid in (3, 3, 3, 3, 3):  # five groups on one fid: GPF grows
        ops.append(("ensure", fid, "r3", f"extra{len(ops)}"))
        ops.append(("len", 3))
    tabs = []
    for cls in (P_router.GroupTable, J_router.GroupTable):
        t = cls(gpf=4)
        gid = None
        for op in ops:
            if op[0] == "ensure":
                gid = t.ensure_group(*op[1:])
            elif op[0] == "len":
                t.set_len(gid, op[1])
            elif op[0] == "rr":
                t.set_rr(gid, op[1])
            else:
                t.set_sticky(gid, op[1])
        for i in range(0, n_groups, 17):  # drops, then recycled gids
            fid = ops[4 * i][1]
            t.drop_group(fid, f"r{fid}", f"g{i}")
        for i in range(5):
            g = t.ensure_group(i, f"r{i}", f"late{i}")
            t.set_len(g, 2)
        t.repin(t.gid_of("r0", "late0"), ["a", "b"], "b")
        t.pack_fcap(300)
        tabs.append(t)
    return tabs, rng


def test_group_table_matches_jax():
    (p, j), _ = grouped_tables(0)
    assert p.gpf == j.gpf == 8
    assert p.oplog == j.oplog and (p.epoch, p.version, len(p)) == (j.epoch, j.version, len(j))
    for k, v in j.device_snapshot().items():
        got = p.device_snapshot()[k]
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert p.gid_of("r0", "late0") == j.gid_of("r0", "late0")
    assert p.info(3) == j.info(3)


def u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def as_t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def pick_inputs(seed, B=160, K=3):
    (p, j), rng = grouped_tables(seed)
    matched = rng.integers(0, 130, size=(B, K)).astype(np.int32)  # some fids past
    matched[rng.random((B, K)) < 0.25] = -1  # holes
    matched[:40, 0] = 3  # a long run of the same groups
    return p, j, matched, u32(rng, B), u32(rng, B), u32(rng, B)


@pytest.mark.parametrize("strategy", sorted(J_router.STRATEGY_IDS.values()))
@pytest.mark.parametrize("seed", [0, 1])
def test_share_pick_twin_matches_jax(strategy, seed):
    p, j, matched, ch, th, rand = pick_inputs(seed)
    want = J_router.share_pick_device(
        j.device_snapshot(), jnp.asarray(matched), jnp.asarray(ch), jnp.asarray(th),
        jnp.asarray(rand), strategy=strategy,
    )
    snap = {k: torch.from_numpy(v.copy()) for k, v in p.device_snapshot().items()}
    got = P_router.share_pick(snap, torch.from_numpy(matched), as_t(ch), as_t(th),
                              as_t(rand), strategy=strategy)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gid, idx = (x.numpy() for x in got)
    assert ((gid >= 0) == (idx >= 0)).all() and (gid >= 0).sum() > 100
    if strategy == 1:
        # bases near 2^31 wrap negative; the floored modulo keeps idx >= 0
        rr = p.group_rr[np.maximum(gid, 0)].astype(np.int64)
        assert (rr[gid >= 0] > (1 << 31) - 200).any()


# jitted once per shape and strategy (eager dispatch of round robin's
# occurrence index runs its scan primitive by primitive, several times slower)
j_share_pick = jax.jit(J_router.share_pick_device, static_argnames=("strategy",))


def raw_group_tables(rng, gpf, fcap=90, gcap=200):
    """Group tables of any GPF written directly (a `GroupTable` only
    doubles its GPF): about a third of the fids carry groups in some of
    their slots, fid 5's row is all -1, bases near 2^31 on every third
    group, empty groups, sticky indices in and out of range."""
    fg = np.full((fcap, gpf), -1, np.int32)
    live = rng.random((fcap, gpf)) < 0.35
    fg[live] = rng.integers(0, gcap, int(live.sum()))
    fg[5] = -1
    glen = rng.integers(0, 9, gcap).astype(np.int32)
    rr = rng.integers(0, 1000, gcap).astype(np.int32)
    rr[::3] = (1 << 31) - 1 - rng.integers(0, 8, rr[::3].size)
    sticky = rng.integers(-2, 10, gcap).astype(np.int32)
    return {"filter_groups": fg, "group_len": glen, "group_rr": rr, "group_sticky": sticky}


@pytest.mark.parametrize("strategy", sorted(J_router.STRATEGY_IDS.values()))
@pytest.mark.parametrize("K", [1, 4, 64])
@pytest.mark.parametrize("gpf", [1, 2, 3, 4, 5, 8])
def test_share_pick_twin_matches_jax_at_every_gpf(gpf, K, strategy):
    """The kernel's instances: a thread a pair with 16-byte filter_groups
    words (GPF 4 and 8, the widths `GroupTable` grows through), a thread a
    lane (any other GPF); rows of fid 5 (all -1), of
    fids past Fcap (clamped) and -1 holes, one fid repeated down a column
    (long round-robin runs)."""
    rng = np.random.default_rng(gpf * 100 + K * 10 + strategy)
    tabs = raw_group_tables(rng, gpf)
    B = max(8, 1200 // K)
    matched = rng.integers(-1, 100, size=(B, K)).astype(np.int32)  # 90-99 past Fcap
    matched[::7, 0] = 5
    matched[:30, -1] = 11
    ch, th, rand = u32(rng, B), u32(rng, B), u32(rng, B)
    want = j_share_pick(
        {k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(matched),
        jnp.asarray(ch), jnp.asarray(th), jnp.asarray(rand), strategy=strategy)
    got = P_router.share_pick({k: torch.from_numpy(v) for k, v in tabs.items()},
                              torch.from_numpy(matched), as_t(ch), as_t(th), as_t(rand),
                              strategy=strategy)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (B, K * gpf)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] >= 0).sum() > 50


def tables_past_gcap(rng, gpf=4, gcap=200):
    """`raw_group_tables` whose live lanes also name groups at and past
    Gcap: gcap itself, gcap + 1, 4 * gcap and 2^31 - 1, each about 5% of
    the live lanes, and one fid whose every lane is past Gcap."""
    tabs = raw_group_tables(rng, gpf, gcap=gcap)
    fg = tabs["filter_groups"]
    past = (fg >= 0) & (rng.random(fg.shape) < 0.2)
    fg[past] = rng.choice([gcap, gcap + 1, 4 * gcap, (1 << 31) - 1], int(past.sum()))
    fg[7] = gcap + 3
    return tabs


def past_gcap_inputs(seed, K):
    rng = np.random.default_rng(seed)
    tabs = tables_past_gcap(rng)
    B = max(8, 1200 // K)
    matched = rng.integers(-1, 90, size=(B, K)).astype(np.int32)
    matched[::5, 0] = 7  # a long run of the all-past-Gcap fid
    ch, th, rand = u32(rng, B), u32(rng, B), u32(rng, B)
    return tabs, matched, ch, th, rand


@pytest.mark.parametrize("strategy", sorted(J_router.STRATEGY_IDS.values()))
@pytest.mark.parametrize("K", [1, 4])
def test_share_pick_twin_matches_jax_with_gids_past_gcap(K, strategy):
    """A `filter_groups` gid at or past Gcap (raw tables; a `GroupTable`
    never uploads one): JAX clamps the gathers of its group arrays and
    ranks it among its own kind under round robin; the twin does the same."""
    tabs, matched, ch, th, rand = past_gcap_inputs(70 + K, K)
    want = j_share_pick(
        {k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(matched),
        jnp.asarray(ch), jnp.asarray(th), jnp.asarray(rand), strategy=strategy)
    got = P_router.share_pick({k: torch.from_numpy(v) for k, v in tabs.items()},
                              torch.from_numpy(matched), as_t(ch), as_t(th), as_t(rand),
                              strategy=strategy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gid = got[0].numpy()
    assert (gid >= 200).sum() > 20 and (gid == 203).sum() > 20


@pytest.mark.parametrize("what", ["lanes", "fcap"])
def test_share_pick_refuses_indices_past_int32(what):
    """The kernel indexes in 32 bits: B x K x GPF or Fcap x GPF at 2^31
    raises before anything runs, on either device (meta tensors hold no
    memory)."""
    meta = torch.device("meta")
    fcap = 1 << 29 if what == "fcap" else 64
    B = 1 << 27 if what == "lanes" else 8
    tabs = {"filter_groups": torch.empty((fcap, 4), dtype=torch.int32, device=meta)}
    for k in ("group_len", "group_rr", "group_sticky"):
        tabs[k] = torch.empty(64, dtype=torch.int32, device=meta)
    matched = torch.empty((B, 4), dtype=torch.int32, device=meta)
    hashes = [torch.empty(B, dtype=torch.int32, device=meta) for _ in range(3)]
    with pytest.raises(ValueError, match="2\\^31"):
        P_router.share_pick(tabs, matched, *hashes, strategy=1)


def test_share_pick_unknown_strategy_picks_as_random():
    p, j, matched, ch, th, rand = pick_inputs(2)
    snap = {k: torch.from_numpy(v.copy()) for k, v in p.device_snapshot().items()}
    args = (snap, torch.from_numpy(matched), as_t(ch), as_t(th), as_t(rand))
    for a, b in zip(P_router.share_pick(*args, strategy=9),
                    P_router.share_pick(*args, strategy=0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,n,space", [(0, 5000, 20), (1, 3000, 3), (2, 1, 5),
                                          (3, 0, 5), (4, 20000, 4000)])
def test_occurrence_index_twin_matches_jax(seed, n, space):
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, space, size=n).astype(np.int32)
    if n > 100:
        g[10:90] = 2  # a long run
    got = P_router.occurrence_index(torch.from_numpy(g))
    want = np.asarray(J_router._occurrence_index(jnp.asarray(g)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,n,space", [(5, 20000, 16384), (6, 4096, 1)])
def test_occurrence_index_twin_with_gcap_matches_jax(seed, n, space):
    """Every gid -1 or below gcap = space, as `share_pick` calls it."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, space, size=n).astype(np.int32)
    g[100:400] = space - 1  # a long run of the last gid
    got = P_router.occurrence_index(torch.from_numpy(g), gcap=space)
    want = np.asarray(J_router._occurrence_index(jnp.asarray(g)))
    np.testing.assert_array_equal(got.numpy(), want)


TOTALS_CASES = ("past-gcap", "below-minus-one", "single-tile", "gcap-not-32")


def totals_case(case, rng):
    """-> (gids int32 [n], gcap) of one case of `occurrence_index`'s totals
    (the histogram of the mesh branch)."""
    if case == "past-gcap":  # a fifth of the lanes at or past gcap
        return rng.integers(-1, 5000, size=20_000).astype(np.int32), 4000
    if case == "below-minus-one":
        g = rng.integers(-40, 300, size=9000).astype(np.int32)
        g[::13] = np.iinfo(np.int32).min
        return g, 300
    if case == "single-tile":  # one tile of the kernel's count matrix
        return rng.integers(-1, 50, size=P_router.OCC_SUB - 5).astype(np.int32), 50
    g = rng.integers(-1, 45, size=7000).astype(np.int32)  # 46 columns: 2 blocks
    g[:200] = 44
    return g, 45


def jax_histogram(g, gcap):
    """The `dp_axis` histogram of `share_pick_device`
    (emqx_tpu/models/router_model.py:944-947)."""
    return np.asarray(jnp.zeros(gcap, jnp.int32).at[jnp.maximum(g, 0)].add(
        (g >= 0).astype(jnp.int32), mode="drop"))


@pytest.mark.parametrize("case", TOTALS_CASES)
def test_occurrence_totals_match_the_jax_histogram(case):
    """``occurrence_index(..., totals=True)``: the ranks as without it,
    and the per-group counts equal to `group_counts_plain` and to JAX's
    histogram (a gid past gcap dropped, one below 0 adding nothing)."""
    g, gcap = totals_case(case, np.random.default_rng(TOTALS_CASES.index(case)))
    occ, tot = P_router.occurrence_index(torch.from_numpy(g), gcap=gcap, totals=True)
    want = jax_histogram(jnp.asarray(g), gcap)
    assert tot.dtype == torch.int32 and tot.shape == (gcap,)
    np.testing.assert_array_equal(tot.numpy(), want)
    np.testing.assert_array_equal(P_router.group_counts_plain(torch.from_numpy(g), gcap).numpy(),
                                  want)
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(J_router._occurrence_index(jnp.asarray(g))))
    with pytest.raises(ValueError, match="gcap"):
        P_router.occurrence_index(torch.from_numpy(g), totals=True)


def test_share_pick_wrapper_checks():
    p, _j, matched, ch, th, rand = pick_inputs(0, B=10)
    snap = {k: torch.from_numpy(v.copy()) for k, v in p.device_snapshot().items()}
    with pytest.raises(ValueError, match="client_hash"):
        P_router.share_pick(snap, torch.from_numpy(matched), as_t(ch[:5]), as_t(th),
                            as_t(rand), strategy=1)
    with pytest.raises(TypeError, match="int32"):
        P_router.occurrence_index(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="one length"):
        P_router.share_pick({**snap, "group_rr": snap["group_rr"][:3].contiguous()},
                            torch.from_numpy(matched), as_t(ch), as_t(th), as_t(rand),
                            strategy=1)
    kernels.reset_launches()
    P_router.share_pick(snap, torch.from_numpy(matched), as_t(ch), as_t(th), as_t(rand),
                        strategy=1)
    assert kernels.LAUNCHES["share_pick"] == kernels.LAUNCHES["occurrence_index"] == 0


# -- on the card: each kernel against its twin (skips without CUDA) ---------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_share_kernels_match_twins_on_card(cuda_device):
    dev = cuda_device
    kernels.reset_launches()
    p, _j, matched, ch, th, rand = pick_inputs(1, B=3000, K=4)
    snap = {k: torch.from_numpy(v.copy()).to(dev) for k, v in p.device_snapshot().items()}
    ins = [torch.from_numpy(matched).to(dev)] + [as_t(x).to(dev) for x in (ch, th, rand)]
    for strategy in range(5):
        got = P_router.share_pick(snap, *ins, strategy=strategy)
        want = P_router.share_pick_plain(snap, *ins, strategy=strategy)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    rng = np.random.default_rng(9)
    sizes = (1, 2047, 2048, 2049, 131_072, 300_001)
    for n, space in zip(sizes, (3, 5, 5, 7, 11_000, 50)):
        g = torch.from_numpy(rng.integers(-1, space, size=n).astype(np.int32)).to(dev)
        assert torch.equal(P_router.occurrence_index(g, gcap=space),
                           P_router.occurrence_index_plain(g))
    assert kernels.LAUNCHES["share_pick"] == 6  # round_robin launches it twice
    # 3 launches a call (in-tile ranks and counts, the prefix over tiles,
    # the add): the round_robin pick's and the six above
    assert kernels.LAUNCHES["occurrence_index"] == 3 * (1 + len(sizes))


@pytest.mark.cuda
@pytest.mark.parametrize("gpf", [1, 2, 3, 4, 5, 8])
def test_share_pick_kernel_at_every_gpf_on_card(cuda_device, gpf):
    """Every instance of the pick kernel (a thread a pair with 16-byte
    words at GPF 4 and 8, a thread a lane otherwise, and a filter_groups
    base 4 bytes off, which takes the thread-a-lane form at every GPF) under all five
    strategies and an unknown id, K 1 / 4 / 64, up to 2^20 lanes; round
    robin with dp ranks 0-3 over a seeded `all_counts` (counts near 2^31
    in rank 0's row); launches counted."""
    dev = cuda_device
    rng = np.random.default_rng(40 + gpf)
    kernels.reset_launches()
    picks = occs = 0
    for K, B, offset in ((1, 3000, 0), (4, (1 << 20) // (4 * gpf), 0), (64, 500, 1)):
        tabs = raw_group_tables(rng, gpf, fcap=5000, gcap=3000)
        fg = tabs["filter_groups"]
        base = torch.empty(fg.size + offset, dtype=torch.int32, device=dev)
        snap = {k: torch.from_numpy(v).to(dev) for k, v in tabs.items()}
        snap["filter_groups"] = base[offset:].view(fg.shape)
        snap["filter_groups"].copy_(torch.from_numpy(fg))
        matched = rng.integers(-1, 5100, size=(B, K)).astype(np.int32)
        matched[:40, 0] = 11
        ins = [torch.from_numpy(matched).to(dev)] + [
            as_t(u32(rng, B)).to(dev) for _ in range(3)]
        for strategy in range(6):
            got = P_router.share_pick(snap, *ins, strategy=strategy)
            want = P_router.share_pick_plain(snap, *ins, strategy=strategy)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            picks += 2 if strategy == 1 else 1
            occs += 3 if strategy == 1 else 0
        gcap = snap["group_len"].shape[0]
        for dp in range(1, 5):
            all_c = torch.from_numpy(rng.integers(0, 1 << 16, (dp, gcap)).astype(np.int32))
            all_c[0, :9] = (1 << 31) - 5
            all_c = all_c.to(dev)
            for rank in range(dp):
                kw = dict(strategy=1, dp_gather=lambda c, a=all_c: a, dp_rank=rank)
                got = P_router.share_pick(snap, *ins, **kw)
                want = P_router.share_pick_plain(snap, *ins, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
                picks += 2
                occs += 3
    assert kernels.LAUNCHES["share_pick"] == picks
    assert kernels.LAUNCHES["occurrence_index"] == occs
    # a dp call's histogram (for dp_gather) is the occurrence call's totals:
    # 2 share_pick and 3 occurrence_index launches, and nothing else
    assert "group_counts" not in kernels.LAUNCHES
    assert sum(kernels.LAUNCHES.values()) == picks + occs


OCC_CASES = ("space-1", "space-3", "space-50", "space-11000", "gcap-16384-all-live",
             "all-none", "one-gid")


def occ_case(case, n, rng):
    """-> (gids, gcap) of one `occurrence_index` case at n lanes."""
    if case.startswith("space-"):
        space = int(case.split("-")[1])
        return rng.integers(-1, space, size=n).astype(np.int32), max(space, 16_384)
    if case == "gcap-16384-all-live":
        g = rng.integers(0, 16_384, size=n).astype(np.int32)
        g[:min(n, 16_384)] = rng.permutation(16_384)[:min(n, 16_384)]
        return g, 16_384
    if case == "all-none":
        return np.full(n, -1, np.int32), 16_384
    return np.full(n, 7, np.int32), 8  # one gid in every lane


@pytest.mark.cuda
@pytest.mark.parametrize("case", OCC_CASES)
def test_occurrence_index_matches_twin_on_card(cuda_device, case):
    dev = cuda_device
    sub = P_router.OCC_SUB
    sizes = sorted({1, 2047, 2048, 2049, sub - 1, sub, sub + 1, 65_536, 131_072, 300_001})
    rng = np.random.default_rng(OCC_CASES.index(case))
    for n in sizes:
        g, gcap = occ_case(case, n, rng)
        gt = torch.from_numpy(g).to(dev)
        kernels.reset_launches()
        got = P_router.occurrence_index(gt, gcap=gcap)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["occurrence_index"] == 3, n
        assert torch.equal(got, P_router.occurrence_index_plain(gt)), (case, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TOTALS_CASES)
def test_occurrence_totals_match_twin_on_card(cuda_device, case):
    """The totals the prefix launch writes, at the CPU cases' inputs and
    tiled to several tiles, and at no lanes: equal to the twin, with the
    ranks, in the call's 3 launches."""
    dev = cuda_device
    g, gcap = totals_case(case, np.random.default_rng(TOTALS_CASES.index(case)))
    for gg in (g, np.tile(g, 300_001 // len(g) + 1)[:300_001], g[:0]):
        gt = torch.from_numpy(np.ascontiguousarray(gg)).to(dev)
        kernels.reset_launches()
        occ, tot = P_router.occurrence_index(gt, gcap=gcap, totals=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["occurrence_index"] == (3 if len(gg) else 0)
        assert torch.equal(tot, P_router.group_counts_plain(gt, gcap)), (case, len(gg))
        assert torch.equal(occ, P_router.occurrence_index_plain(gt)), (case, len(gg))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 100_000, 300_001])
def test_occurrence_index_tiles_of_several_sub_tiles_on_card(cuda_device, monkeypatch, n):
    """A count matrix capped at two rows: each of the two tiles takes
    several sub-tiles and carries its running counts across them."""
    dev = cuda_device
    monkeypatch.setattr(P_router, "OCC_MAX_COUNTS", 2 * 4100)
    sub, tiles, _ = P_router.occurrence_plan(n, 4096)
    assert sub > 1 and tiles == 2
    g = np.random.default_rng(n).integers(-1, 4096, size=n).astype(np.int32)
    g[: n // 3] = 5  # a gid heavy across sub-tiles
    gt = torch.from_numpy(g).to(dev)
    assert torch.equal(P_router.occurrence_index(gt, gcap=4096),
                       P_router.occurrence_index_plain(gt))


@pytest.mark.cuda
def test_occurrence_index_range_rule_on_card(cuda_device):
    """On CUDA a call needs gcap; a gid below -1 or at or past gcap takes
    the add launch's scan and is ranked exactly, as the twin ranks it, and
    nothing is read or written out of bounds."""
    dev = cuda_device
    rng = np.random.default_rng(11)
    g = rng.integers(-5, 40, size=50_000).astype(np.int32)
    g[::7] = np.iinfo(np.int32).max
    g[::11] = np.iinfo(np.int32).min
    gt = torch.from_numpy(g).to(dev)
    with pytest.raises(ValueError, match="gcap"):
        P_router.occurrence_index(gt)
    for gcap in (30, 0, 1):
        got = P_router.occurrence_index(gt, gcap=gcap)
        torch.cuda.synchronize()
        assert torch.equal(got, P_router.occurrence_index_plain(gt)), gcap


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_share_pick_kernel_with_gids_past_gcap_on_card(cuda_device, K):
    """The tables of `test_share_pick_twin_matches_jax_with_gids_past_gcap`
    (and at 2^20 lanes, several occurrence tiles) on the card: the kernel
    equals the twin under every strategy, round robin with dp offsets too."""
    dev = cuda_device
    for seed, reps in ((70 + K, 1), (80 + K, 64)):
        tabs, matched, ch, th, rand = past_gcap_inputs(seed, K)
        matched = np.tile(matched, (reps, 1))
        ch, th, rand = (np.tile(x, reps) for x in (ch, th, rand))
        snap = {k: torch.from_numpy(v).to(dev) for k, v in tabs.items()}
        ins = [torch.from_numpy(matched).to(dev)] + [as_t(x).to(dev) for x in (ch, th, rand)]
        for strategy in range(5):
            got = P_router.share_pick(snap, *ins, strategy=strategy)
            want = P_router.share_pick_plain(snap, *ins, strategy=strategy)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (seed, strategy)
        gcap = tabs["group_len"].shape[0]
        counts = torch.from_numpy(
            np.random.default_rng(seed).integers(0, 50, (3, gcap)).astype(np.int32)).to(dev)
        for dp_rank in (0, 2):
            got = P_router.share_pick(snap, *ins, strategy=1, dp_gather=lambda c: counts,
                                      dp_rank=dp_rank)
            want = P_router.share_pick_plain(snap, *ins, strategy=1,
                                             dp_gather=lambda c: counts, dp_rank=dp_rank)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (seed, dp_rank)
