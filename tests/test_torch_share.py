"""The port's $share pick stage against the JAX package.

`GroupTable` (host, byte-identical snapshots and op-logs after the same
seeded operations), `stable_hash`, the plain twins of `share_pick` against
`share_pick_device` under all five strategies (with `group_rr` near 2^31,
empty groups, out-of-range sticky indices and -1 holes) and of
`occurrence_index` against `_occurrence_index`; then (`cuda` marker,
skipped without a card) both CUDA kernels against their twins.
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
        assert torch.equal(P_router.occurrence_index(g), P_router.occurrence_index_plain(g))
    assert kernels.LAUNCHES["share_pick"] == 6  # round_robin launches it twice
    # a tile sort, the merge passes and the rank scatter per call; the
    # round_robin pick ranks its B * K * GPF lanes
    lanes = matched.size * snap["filter_groups"].shape[1]
    assert kernels.LAUNCHES["occurrence_index"] == sum(
        2 + len(P_router.occurrence_merge_runs(n)) for n in (lanes,) + sizes)
