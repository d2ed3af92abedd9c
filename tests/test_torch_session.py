"""The port's device session store against the JAX package.

`emqx_tpu_torch.ops.session_table`, `emqx_tpu_torch.broker.session_store`
and the session half of `DeviceRouter.route_prepared` (port) against
`emqx_tpu.ops.session_table`, `emqx_tpu.broker.session_store` and
`emqx_tpu.models.router_model` on the same inputs:

- the host table through one seeded churn (inserts, upserts, state
  changes, touches, double clears, expiry-lane growth, bulk loads, row
  growth, op-log overflow): lanes, op-log, epoch, version, counts, lookups
  and both host sweeps;
- the fused stage's plain twin (`session_ack_plain`) against
  `session_ack_impl`, with and without a sweep, a sweep narrower than its
  hits and wider than the table, and clocks whose `now - ts` wraps int32;
- the mirror's rider handoff (`peek_delta`, `adopt`) against the JAX
  manager's, every refusal included;
- the store driven by one op script with frozen clocks: rider fields,
  commits, aborts, redelivery calls, expiries, capture/install;
- the fused route (`route_prepared(..., session=rider)`) against the JAX
  router's, and a small redelivery flood through both routers.

The port runs with ``device="cpu"`` (the kernels' plain twins). The
`cuda`-marked test at the end holds the `session_sweep` kernel against its
twin on a card. Tolerance: EXACT equality (all integers), dtypes included.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.broker import session_store as J_store
from emqx_tpu.models import retained_index as J_ret
from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops import segments as J_seg
from emqx_tpu.ops import session_table as J_tab
from emqx_tpu.ops.matcher import MatcherConfig as JConfig
from emqx_tpu_torch import kernels
from emqx_tpu_torch.broker import session_store as P_store
from emqx_tpu_torch.models import retained_index as P_ret
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops import segments as P_seg
from emqx_tpu_torch.ops import session_table as P_tab
from emqx_tpu_torch.ops.matcher import MatcherConfig as PConfig

class Msg:
    """A stand-in message: the JAX slab calls `own_buffers` on it."""

    def __init__(self, tag):
        self.tag = tag

    def own_buffers(self):
        pass


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_arrays(p: dict, j: dict):
    assert sorted(p) == sorted(j)  # a jitted program returns its dict sorted
    for k in j:
        a, b = host(p[k]), host(j[k])
        assert a.dtype == b.dtype == np.int32, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# -- the host table --------------------------------------------------------


def assert_same_table(p, j, rng):
    assert (p._cap, p._scap, p.live, p.tombstones) == (j._cap, j._scap, j.live, j.tombstones)
    assert (p.epoch, p.version, p._structure_gen) == (j.epoch, j.version, j._structure_gen)
    assert p.oplog == j.oplog
    assert_same_arrays(p.device_snapshot(), j.device_snapshot())
    slots = rng.integers(0, 300, size=200)
    pids = rng.integers(1, 40, size=200)
    np.testing.assert_array_equal(p.lookup_batch(slots, pids), j.lookup_batch(slots, pids))
    for now, retry in ((0, 1), (50, 10), (2**31 - 1, 5), (-(2**31) + 7, 3)):
        np.testing.assert_array_equal(p.due_rows(now, retry), j.due_rows(now, retry))
        np.testing.assert_array_equal(p.expired_slots(now), j.expired_slots(now))


def both(tables, fn):
    return [fn(t) for t in tables]


@pytest.mark.parametrize("seed", [0, 1])
def test_host_table_tracks_jax_through_seeded_churn(seed):
    rng = np.random.default_rng(seed)
    check = np.random.default_rng(seed + 100)
    p, j = P_tab.SessionTable(capacity=64, slots=64), J_tab.SessionTable(capacity=64, slots=64)
    tabs = (p, j)
    for t in tabs:
        t.OPLOG_MAX = 120
    keys = []
    for i in range(30):  # inserts, then upserts of half of them
        slot, pid = int(rng.integers(0, 60)), int(rng.integers(1, 30))
        st, ts = int(rng.integers(1, 4)), int(rng.integers(-5, 100))
        rows = both(tabs, lambda t: t.insert(slot, pid, st, ts, i))
        assert rows[0] == rows[1]
        keys.append((slot, pid))
    for slot, pid in keys[::2]:
        both(tabs, lambda t: t.insert(slot, pid, 2, 77, -1))
    assert_same_table(p, j, check)
    live = np.nonzero(p.sess_slot >= 0)[0]
    for r in live[:6]:
        both(tabs, lambda t: t.set_state(int(r), P_tab.ST_PUBREL, 9))
    for r in live[6:9]:
        both(tabs, lambda t: t.set_state(int(r), P_tab.ST_PUBLISH, 11, mid=4))
    for r in live[9:12]:
        both(tabs, lambda t: t.touch(int(r), 2**31 - 2))
    both(tabs, lambda t: t.touch_many(live[12:20], 33))
    for r in live[:4]:  # double clears: the second is a no-op returning -1
        mids = both(tabs, lambda t: (t.clear(int(r)), t.clear(int(r))))
        assert mids[0] == mids[1] and mids[0][1] == -1
    assert_same_table(p, j, check)
    both(tabs, lambda t: t.set_expiry(5, 40))
    both(tabs, lambda t: t.set_expiry(100, 3))  # grows the slot lane: `!resync`
    assert (P_tab.RESYNC, "slot_expiry", 0) in p.oplog
    assert_same_table(p, j, check)
    # the op-log at OPLOG_MAX: touch_many overflows into an epoch bump, and
    # a slot-lane growth right at the limit is covered by the bump too
    while len(p.oplog) < p.OPLOG_MAX:
        both(tabs, lambda t: t.touch(int(live[-1]), 5))
    e0 = p.epoch
    both(tabs, lambda t: t.set_expiry(700, 555))
    assert p.epoch == e0 + 1 and p.oplog == [("slot_expiry", 700, 555)]
    both(tabs, lambda t: t.touch_many(live[:200], 8))
    assert_same_table(p, j, check)
    for t in tabs:
        t.OPLOG_MAX = 4
    both(tabs, lambda t: t.touch_many(live[:5], 6))  # past the limit: a bump
    assert p.oplog == [] and p.epoch == e0 + 2
    for t in tabs:
        t.OPLOG_MAX = 262144
    n = 80  # a bulk load, then inserts past 3/4 load: row growth
    slots = rng.permutation(np.arange(200, 200 + n))
    pids = rng.integers(1, 65535, size=n)
    rows = both(tabs, lambda t: t.bulk_insert(slots, pids, np.full(n, 1), np.arange(n),
                                              np.arange(n)))
    np.testing.assert_array_equal(rows[0], rows[1])
    assert (rows[0] >= 0).all()
    cap0 = p._cap
    for k in range(120):
        both(tabs, lambda t: t.insert(400 + k, 1, 1, k, -1))
    assert p._cap > cap0
    assert_same_table(p, j, check)
    # the compaction journal, which insert and clear write
    caps = both(tabs, lambda t: t.begin_compact())
    both(tabs, lambda t: t.insert(3, 3, 1, 1, -1))
    both(tabs, lambda t: t.clear(int(np.nonzero(t.sess_slot >= 0)[0][0])))
    built = [P_tab.SessionTable.build_compact(caps[0]), J_tab.SessionTable.build_compact(caps[1])]
    assert p.apply_compact(built[0]) == j.apply_compact(built[1])
    assert p.tombstones == 1  # the journal's replayed clear
    assert_same_table(p, j, check)
    np.testing.assert_array_equal(p.rows_of_slot(3), j.rows_of_slot(3))


# -- kernel 12: the fused stage's twin ---------------------------------------


def seeded_lanes(rng, cap=256, scap=64):
    t = {
        "sess_slot": rng.integers(-2, 50, cap),
        "sess_pid": rng.integers(1, 100, cap),
        "sess_state": rng.integers(0, 4, cap),
        "sess_ts": rng.integers(-(2**31), 2**31, cap, dtype=np.int64),
        "sess_mid": rng.integers(-1, 9, cap),
        "slot_expiry": rng.integers(0, 100, scap),
    }
    t = {k: v.astype(np.int32) for k, v in t.items()}
    t["slot_expiry"][:8] = 0  # no deadline
    t["sess_slot"][:4] = [P_tab.EMPTY, P_tab.TOMB, P_tab.EMPTY, P_tab.TOMB]
    t["sess_state"][4:8] = P_tab.ST_AWAIT_REL  # never due
    return t


def jax_ack(tables, idxs, vals, clock, sweep_k):
    return J_tab.session_ack_impl({k: jnp.asarray(v) for k, v in tables.items()}, idxs, vals,
                                  jnp.asarray(clock), sweep_k=sweep_k)


def assert_ack_equal(p: dict, j: dict):
    assert set(p) == set(j)
    assert_same_arrays(p["tables"], j["tables"])
    for k in ("due", "due_count", "expired", "expired_count"):
        if k in j:
            a, b = host(p[k]), np.asarray(j[k])
            assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("sweep_k", [0, 16, 300])
@pytest.mark.parametrize("now", [50, 2**31 - 5, -(2**31) + 3])
def test_session_ack_twin_matches_jax(sweep_k, now):
    """sweep_k 16 is below the hit counts (uncapped counts above it), 300
    above the 256-row table (-1 padding past the table); the extreme clocks
    make `now - ts` wrap int32 for most rows."""
    rng = np.random.default_rng(now % 1000 + sweep_k)
    tables = seeded_lanes(rng)
    idxs = {"sess_ts": np.array([3, 5, 9, 9], np.int32),
            "sess_state": np.array([9, 10, 11, 11], np.int32),
            "slot_expiry": np.array([1, 2, 60, 60], np.int32)}
    vals = {"sess_ts": np.array([now, 11, 12, 12], np.int32),
            "sess_state": np.array([1, 0, 2, 2], np.int32),
            "slot_expiry": np.array([0, 5, 7, 7], np.int32)}
    clock = np.array([now, 10], np.int32)
    args = (idxs, vals, clock)
    p_tabs = {k: torch.from_numpy(v.copy()) for k, v in tables.items()}
    got = P_tab.session_ack_plain(p_tabs, *args, sweep_k=sweep_k)
    assert_ack_equal(got, jax_ack(tables, *args, sweep_k))
    for k, v in p_tabs.items():  # the inputs stay as they were
        np.testing.assert_array_equal(v.numpy(), tables[k])
    assert got["tables"]["sess_pid"] is p_tabs["sess_pid"]  # untouched: passed through
    if sweep_k == 16:
        assert int(got["due_count"]) > 16 and (host(got["due"]) >= 0).all()
    if sweep_k == 300:
        assert (host(got["due"])[256:] == -1).all()
    # the wrapper on CPU tensors is the twin and launches nothing
    kernels.reset_launches()
    assert_ack_equal(P_tab.session_ack(p_tabs, *args, sweep_k=sweep_k), got)
    assert not any(kernels.LAUNCHES.values())


def sweep_case(case, rng):
    """Lanes for one edge of the sweep: cap 3 x 4,096 + 37 rows (a multiple
    of no block span), 2 x 4,096 + 5 slots."""
    cap, scap = 3 * 4096 + 37, 2 * 4096 + 5
    t = seeded_lanes(rng, cap, scap)
    now, k = 50, 64
    if case == "last_block_only":  # hits only in the last (ragged) block
        t["sess_state"][: cap - 30] = P_tab.FREE
        t["slot_expiry"][: scap - 3] = 0
    elif case == "none_due":
        t["sess_state"][:] = P_tab.ST_AWAIT_REL
        t["slot_expiry"][:] = 0
    elif case == "k_past_hits":
        t["sess_state"][::5] = P_tab.FREE
        t["slot_expiry"][100:] = 0
        k = cap + 1000
    elif case == "now_wraps":  # now - ts wraps int32 for most rows
        now = -(2**31) + 7
        t["sess_ts"][::3] = 2**31 - 1 - rng.integers(0, 100, len(t["sess_ts"][::3]))
    return t, now, k


@pytest.mark.parametrize("case", ["last_block_only", "none_due", "k_past_hits", "now_wraps",
                                  "dense"])
def test_session_sweep_edges_match_jax(case):
    rng = np.random.default_rng(len(case))
    t, now, k = sweep_case(case, rng)
    clock = np.array([now, 10], np.int32)
    got = P_tab.session_ack_plain({n: torch.from_numpy(v) for n, v in t.items()}, {}, {}, clock,
                                  sweep_k=k)
    assert_ack_equal(got, jax_ack(t, {}, {}, clock, k))
    due, n_due = host(got["due"]), int(got["due_count"])
    if case == "last_block_only":
        assert 0 < n_due <= 30 and due[0] >= len(t["sess_slot"]) - 30
        assert int(got["expired_count"]) <= 3
    if case == "none_due":
        assert n_due == int(got["expired_count"]) == 0 and (due == -1).all()
    if case == "k_past_hits":
        assert n_due < k and (due[n_due:] == -1).all() and (due[:n_due] >= 0).all()


def test_session_sweep_wrapper_launches_once_a_call(monkeypatch):
    """The CUDA path's host side through stand-ins: one launch a call, one
    output allocation (the four results are views of it), the look-back
    scratch zeroed once and reused, tickets counted on, a fresh epoch each
    call, and the buffer zeroed again only when the epochs run out."""
    calls = []
    lib = types.SimpleNamespace(emqx_sweep_blocks=lambda cap, scap: -(-cap // 4096)
                                + -(-scap // 4096))
    monkeypatch.setattr(kernels.build, "load", lambda: lib)
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: 77)
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(P_tab, "_sweep_scratch", {})
    z = torch.zeros(5000, dtype=torch.int32)
    e = torch.zeros(9000, dtype=torch.int32)
    due, n_due, exp, n_exp = P_tab.session_sweep(z, z, z, e, 0, 1, 16)
    assert [c[:2] for c in calls] == [("session_sweep", "emqx_session_sweep")]
    assert due.shape == exp.shape == (16,) and n_due.shape == n_exp.shape == ()
    assert due.untyped_storage().data_ptr() == n_exp.untyped_storage().data_ptr()
    (sc,) = P_tab._sweep_scratch.values()
    assert sc.buf.numel() == 3 + 2 + 3 and not sc.buf.any()
    args = calls[-1][3:]
    assert args[8] == sc.buf.data_ptr() and args[9:11] == (0, 1) and sc.base == 5
    P_tab.session_sweep(z[:100], z[:100], z[:100], e[:10], 0, 1, 16)  # fewer blocks: reused
    assert P_tab._sweep_scratch[(None, 77)] is sc and calls[-1][3:][9:11] == (5, 2)
    sc.epoch = P_tab._EPOCHS
    sc.buf.fill_(3)
    P_tab.session_sweep(z, z, z, e, 0, 1, 16)
    assert calls[-1][3:][9:11] == (0, 1) and not sc.buf.any() and sc.base == 5
    big = torch.zeros(5 * 4096, dtype=torch.int32)
    P_tab.session_sweep(big, big, big, e, 0, 1, 16)  # more blocks: a new scratch
    (sc2,) = P_tab._sweep_scratch.values()
    assert sc2 is not sc and sc2.buf.numel() == 3 + 5 + 3 and calls[-1][3:][9:11] == (0, 1)
    assert len(calls) == 4


def test_session_sweep_reads_the_scattered_lanes():
    """A row cleared and a row made due by the same rider are seen as the
    scatter leaves them: the sweep never reads the rider's input lanes."""
    tables = {k: np.zeros(64, np.int32) for k in P_tab.ROW_LANES}
    tables["sess_slot"][:] = P_tab.EMPTY
    tables["sess_slot"][:2] = [7, 8]
    tables["sess_state"][:2] = P_tab.ST_PUBLISH
    tables["slot_expiry"] = np.zeros(64, np.int32)
    idxs = {"sess_slot": np.array([0], np.int32), "sess_ts": np.array([1], np.int32)}
    vals = {"sess_slot": np.array([P_tab.TOMB], np.int32), "sess_ts": np.array([100], np.int32)}
    clock = np.array([100, 10], np.int32)
    got = P_tab.session_ack_plain({k: torch.from_numpy(v) for k, v in tables.items()},
                                  idxs, vals, clock, sweep_k=4)
    assert_ack_equal(got, jax_ack(tables, idxs, vals, clock, 4))
    assert int(got["due_count"]) == 0 and (host(got["due"]) == -1).all()


def test_session_sweep_checks_its_inputs():
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        P_tab.session_sweep(z.to(torch.int64), z, z, z, 0, 1, 4)
    with pytest.raises(ValueError, match="differ"):
        P_tab.session_sweep(z, z[:4], z, z, 0, 1, 4)
    with pytest.raises(ValueError, match="sweep_k"):
        P_tab.session_sweep(z, z, z, z, 0, 1, 0)
    with pytest.raises(ValueError, match="int32"):
        P_tab.session_sweep(z, z, z, z, 2**31, 1, 4)


# -- the mirror's rider handoff ----------------------------------------------


class Tearing:
    """A source whose snapshot moves it (a sync that races a mutation)."""

    def __init__(self, table):
        self.table = table

    def __getattr__(self, name):
        return getattr(self.table, name)

    def device_snapshot(self):
        self.table.touch(int(np.nonzero(self.table.sess_slot >= 0)[0][0]), 1)
        return self.table.device_snapshot()


def test_manager_peek_delta_and_adopt_match_jax():
    p_tab, j_tab = P_tab.SessionTable(capacity=64, slots=64), J_tab.SessionTable(capacity=64, slots=64)
    tabs = (p_tab, j_tab)
    pm = P_seg.DeviceSegmentManager(device="cpu", name="sessions")
    jm = J_seg.DeviceSegmentManager(name="sessions")
    mans = ((pm, p_tab), (jm, j_tab))

    def peeks():
        out = [m.peek_delta(t) for m, t in mans]
        assert (out[0] is None) == (out[1] is None)
        if out[0] is not None:
            assert out[0][1:] == out[1][1:]  # per-array writes, pos, epoch
            assert_same_arrays(out[0][0], out[1][0])
        return out

    def counters():
        c = [(m.full_resyncs, m.delta_launches, m.array_resyncs) for m, _t in mans]
        assert c[0] == c[1]
        return c[0]

    assert peeks()[0] is None and not pm.has_mirror() and not jm.has_mirror()
    for k in range(5):
        both(tabs, lambda t: t.insert(k, 1, 1, k, k))
    for m, t in mans:
        m.sync(t)
    assert pm.has_mirror() and counters() == (1, 0, 0)
    assert peeks()[0][1] == {}
    both(tabs, lambda t: t.insert(9, 2, 1, 3, 4))
    both(tabs, lambda t: t.clear(int(t._find(0, 1))))
    pk = peeks()
    assert set(pk[0][1]) == {"sess_slot", "sess_pid", "sess_state", "sess_ts", "sess_mid"}
    # the rider's scatter, then adopt: accepted once, refused behind the mirror
    outs = [
        P_tab.session_ack_plain(pk[0][0], *rider_vectors(pk[0][1]), np.array([0, 1], np.int32)),
        J_tab.session_ack_impl(pk[1][0], *rider_vectors(pk[1][1]), jnp.asarray([0, 1])),
    ]
    assert [m.adopt(o["tables"], pk[i][2], pk[i][3]) for i, (o, (m, _t)) in
            enumerate(zip(outs, mans))] == [True, True]
    for (m, t) in mans:
        assert_same_arrays({k: host(v) for k, v in m._arrays.items()}, t.device_snapshot())
    assert [m.adopt(o["tables"], pk[i][2] - 1, pk[i][3]) for i, (o, (m, _t)) in
            enumerate(zip(outs, mans))] == [False, False]
    assert [m.adopt(o["tables"], pk[i][2], pk[i][3] + 1) for i, (o, (m, _t)) in
            enumerate(zip(outs, mans))] == [False, False]
    # a `!resync` marker in the suffix: None, and sync re-uploads the array
    both(tabs, lambda t: t.set_expiry(300, 9))
    assert peeks()[0] is None
    for m, t in mans:
        m.sync(t)
    assert counters() == (1, 0, 1)
    assert peeks()[0][1] == {}
    # an epoch bump: None until a full resync
    both(tabs, lambda t: t.bulk_insert(np.arange(40, 50), np.ones(10), np.ones(10),
                                       np.zeros(10), np.zeros(10)))
    assert peeks()[0] is None
    pk = [(m.sync(t), m.peek_delta(t))[1] for m, t in mans]
    assert counters() == (2, 0, 1)
    # a torn full upload: None and refused until the next sync
    both(tabs, lambda t: t.bulk_insert(np.arange(60, 62), np.ones(2), np.ones(2),
                                       np.zeros(2), np.zeros(2)))
    for m, t in mans:
        m.sync(Tearing(t))
    assert peeks()[0] is None
    assert [m.adopt(m._arrays, len(t.oplog), t.epoch) for m, t in mans] == [False, False]
    for m, t in mans:
        m.sync(t)
    assert counters() == (4, 0, 1) and peeks()[0] is not None
    # a delta the manager scatters itself
    both(tabs, lambda t: t.touch(int(t._find(9, 2)), 99))
    for m, t in mans:
        m.sync(t)
    assert counters() == (4, 1, 1)


def rider_vectors(per):
    """{name: {index: value}} -> (idxs, vals) int32 vectors."""
    idxs = {k: np.fromiter(w.keys(), np.int64).astype(np.int32) for k, w in per.items()}
    vals = {k: np.fromiter(w.values(), np.int64).astype(np.int32) for k, w in per.items()}
    return idxs, vals


# -- the store ---------------------------------------------------------------


class Sink:
    """A channel-shaped resend sink: all of its due rows in one call."""

    def __init__(self):
        self.items = []

    def resend(self, pid, st, msg):  # bound per slot; the batch path is taken
        raise AssertionError("the batch path must be taken")

    def _store_resend_batch(self, items):
        self.items.extend((pid, st, msg.tag if msg is not None else None)
                          for pid, st, msg in items)
        return [True] * len(items)


class Twins:
    """The same store in both packages, with one frozen clock each and the
    same sinks."""

    def __init__(self, capacity=64, sweep_slots=16, retry=1.0):
        self.mono = [0.0]
        clock = lambda: self.mono[0]  # noqa: E731
        self.p = P_store.SessionStore(capacity=capacity, sweep_slots=sweep_slots,
                                      retry_interval=retry, clock=clock, device="cpu")
        self.j = J_store.SessionStore(capacity=capacity, sweep_slots=sweep_slots,
                                      retry_interval=retry, clock=clock)
        self.calls = ([], [])
        self.sinks = (Sink(), Sink())
        self.expired = ([], [])
        for s, ex in zip(self.stores, self.expired):
            s.on_expired = ex.extend

    @property
    def stores(self):
        return (self.p, self.j)

    def do(self, fn):
        return [fn(s) for s in self.stores]

    def bind(self, slots, batch: bool):
        for i, s in enumerate(self.stores):
            for slot in slots:
                if batch:
                    s.bind(slot, self.sinks[i].resend)
                else:
                    s.bind(slot, self.legacy(i, slot))

    def legacy(self, i, slot):
        def resend(pid, st, msg):
            self.calls[i].append((slot, pid, st, msg.tag if msg is not None else None))
            return True
        return resend

    def riders(self):
        r = self.do(lambda s: s.take_rider())
        assert (r[0] is None) == (r[1] is None)
        if r[0] is not None:
            assert_same_rider(*r)
        return r

    def commit(self, riders, outs):
        self.p.commit(riders[0], outs[0])
        self.j.commit(riders[1], outs[1])
        self.check()

    def check(self):
        p, j = self.stores
        assert self.calls[0] == self.calls[1]
        assert self.sinks[0].items == self.sinks[1].items
        assert self.expired[0] == self.expired[1]
        assert p.status() == j.status()
        assert (p._want_sweep, p._rider_out) == (j._want_sweep, j._rider_out)
        assert p.table.oplog == j.table.oplog and p.table.epoch == j.table.epoch
        assert_same_arrays(p.table.device_snapshot(), j.table.device_snapshot())
        if p.manager.has_mirror():
            # the mirror equals the host lanes once nothing is pending
            pk = p.manager.peek_delta(p.table)
            if pk is not None and not pk[1]:
                assert_same_arrays({k: host(v) for k, v in pk[0].items()},
                                   p.table.device_snapshot())


def assert_same_rider(p, j):
    assert (p.pos, p.epoch, p.sweep_k, p.rows) == (j.pos, j.epoch, j.sweep_k, j.rows)
    assert p.clock.dtype == j.clock.dtype and np.array_equal(p.clock, j.clock)
    assert list(p.idxs) == list(j.idxs) and list(p.vals) == list(j.vals)
    for k in j.idxs:
        for a, b in ((p.idxs[k], j.idxs[k]), (p.vals[k], j.vals[k])):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert_same_arrays(p.arrays, j.arrays)


def step_outs(riders):
    """Each rider through its own package's fused stage (no router)."""
    p, j = riders
    po = P_tab.session_ack(p.arrays, p.idxs, p.vals, p.clock, sweep_k=p.sweep_k)
    jo = J_tab.session_ack_impl(j.arrays, j.idxs, j.vals, jnp.asarray(j.clock),
                                sweep_k=j.sweep_k)
    assert_ack_equal(po, jo)
    if not p.sweep_k:
        return (P_store.SessionStepOut(po["tables"], None, 0, None, 0),
                J_store.SessionStepOut(jo["tables"], None, 0, None, 0))
    return (P_store.SessionStepOut(po["tables"], po["due"].numpy(), int(po["due_count"]),
                                   po["expired"].numpy(), int(po["expired_count"])),
            J_store.SessionStepOut(jo["tables"], np.asarray(jo["due"]), int(jo["due_count"]),
                                   np.asarray(jo["expired"]), int(jo["expired_count"])))


def test_store_riders_commits_and_aborts_match_jax():
    tw = Twins(capacity=64, sweep_slots=16)
    cids = [f"c{i}" for i in range(40)]
    slots = tw.do(lambda s: [s.attach(c) for c in cids])
    assert slots[0] == slots[1]
    tw.bind(range(0, 20), batch=True)
    tw.bind(range(20, 36), batch=False)  # 36..39 stay unbound (offline)
    assert tw.riders() == [None, None]  # nothing to ride: the first upload only
    for i, c in enumerate(cids):
        tw.do(lambda s: s.inflight_insert(i, 1, Msg(i), "publish"))
        tw.do(lambda s: s.inflight_insert(i, 2, Msg(100 + i), "pubrel" if i % 3 else "publish"))
    assert tw.riders() == [None, None]  # row growth: a full upload holds the writes
    assert tw.p.manager.full_resyncs == tw.j.manager.full_resyncs == 2
    tw.check()
    tw.do(lambda s: s.await_rel(3, 7))
    tw.do(lambda s: s.set_expiry("c5", 2.0))
    tw.do(lambda s: s.set_expiry("c6", 50.0))
    r = tw.riders()
    assert r[0] is not None and r[0].sweep_k == 0 and r[0].rows == 7
    assert tw.riders() == [None, None]  # one rider outstanding
    tw.commit(r, step_outs(r))
    # an aborted rider leaves the mirror as it was; its writes ride the next
    tw.do(lambda s: s.inflight_delete(1, 1))
    tw.do(lambda s: s.inflight_phase(2, 1, "pubrel"))
    tw.do(lambda s: s.release_rel(3, 7))
    r = tw.riders()
    before = dict(tw.p.manager._arrays)
    snap = {k: v.clone() for k, v in before.items()}
    step_outs(r)  # launched, then the launch "failed"
    tw.p.abort(r[0])
    tw.j.abort(r[1])
    assert all(tw.p.manager._arrays[k] is v and torch.equal(v, snap[k])
               for k, v in before.items())
    r2 = tw.riders()
    for k in r[0].idxs:
        assert np.array_equal(r2[0].idxs[k], r[0].idxs[k])
        assert np.array_equal(r2[0].vals[k], r[0].vals[k])
    tw.commit(r2, step_outs(r2))
    # the clock moves: a sweep redelivers through both sink kinds, expires
    # c5, and overflows its 16 slots (re-armed)
    tw.mono[0] += 3.0
    tw.do(lambda s: s.request_sweep())
    r = tw.riders()
    assert r[0].sweep_k == 16
    outs = step_outs(r)
    assert outs[0].due_count > 16
    tw.commit(r, outs)
    assert tw.p._want_sweep and tw.expired[0] == ["c5"]
    assert len(tw.sinks[0].items) > 0 and len(tw.calls[0]) > 0
    for _ in range(8):  # drain: each rider carries the previous one's touches
        r = tw.riders()
        if r[0] is None:
            break
        tw.commit(r, step_outs(r))
    assert not tw.p._want_sweep
    assert tw.p.manager.delta_launches == 0  # every write rode a rider
    # drop a session; the host sweep (the idle path) agrees too
    tw.do(lambda s: s.drop_session("c7"))
    tw.mono[0] += 2.0
    sent = tw.do(lambda s: s.host_sweep())
    assert sent[0] == sent[1] > 0
    tw.check()
    tw.do(lambda s: s.tick(fused_path=False))
    tw.check()
    # capture/install into fresh stores: one full upload on the next rider,
    # the clock rebased
    state = tw.do(lambda s: s.capture())
    tw2 = Twins(capacity=64, sweep_slots=16)
    tw2.mono[0] = 500.0
    assert tw2.p.install(state[0]) == tw2.j.install(state[1]) == 39
    assert tw2.p.now_ds() == tw2.j.now_ds()
    tw2.bind(range(0, 40), batch=True)
    tw2.mono[0] += 10.0
    tw2.do(lambda s: s.request_sweep())
    r = tw2.riders()
    tw2.commit(r, step_outs(r))
    assert tw2.p.manager.full_resyncs == tw2.j.manager.full_resyncs == 1
    assert tw2.p.manager.delta_launches == 0


def test_host_sweep_and_tick_match_jax():
    tw = Twins(capacity=64, sweep_slots=16)
    for i in range(30):
        tw.do(lambda s: s.attach(f"c{i}"))
        tw.do(lambda s: s.inflight_insert(i, 1 + i % 3, Msg(i), "publish"))
    tw.bind(range(30), batch=False)
    tw.do(lambda s: s.set_expiry("c2", 1.0))
    tw.mono[0] += 5.0
    sent = tw.do(lambda s: s.host_sweep())
    assert sent[0] == sent[1] == 30
    tw.check()
    assert tw.expired[0] == ["c2"]
    tw.mono[0] += 5.0
    tw.do(lambda s: s.tick())  # no ride for a while: the host path
    tw.check()
    assert tw.p.manager.full_resyncs == tw.j.manager.full_resyncs == 1


def test_put_msg_takes_any_object():
    """The slab holds any object that can own its buffers, not only a
    `Message`: the stand-in `Msg` is kept as it is, after one
    `own_buffers` call, as the JAX store does. An object without
    `own_buffers` (a bare str) is refused in both packages."""
    s = P_store.SessionStore(device="cpu")
    assert s._put_msg(None) == -1
    owned = []
    m = Msg("payload")
    m.own_buffers = lambda: owned.append(m.tag)
    assert s._put_msg(m) == 0 and s._get_msg(0) is m and owned == ["payload"]
    s._drop_mid(0)
    assert s._put_msg(Msg(b"x")) == 0
    for store in (s, J_store.SessionStore()):
        with pytest.raises(AttributeError):
            store._put_msg("payload")


# -- the fused route ---------------------------------------------------------


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


TOPICS = [f"site/{i % 5}/dev/{i % 3}/ch/{i}" for i in range(20)] + ["a/b", "", "$SYS/x"]


def assert_route_equal(p_res, j_res):
    for k in ("matched", "mcount", "flags", "slots", "slot_count", "overflow"):
        a, b = getattr(p_res, k), getattr(j_res, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    if j_res.bitmaps is not None:
        np.testing.assert_array_equal(p_res.bitmaps, j_res.bitmaps)


def assert_step_equal(p, j):
    assert_same_arrays(p.arrays, j.arrays)
    assert (p.due is None) == (j.due is None)
    assert (p.due_count, p.expired_count) == (j.due_count, j.expired_count)
    if j.due is not None:
        for a, b in ((p.due, j.due), (p.expired, j.expired)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def loaded_twins(n=24):
    """Both stores with n sessions, their first upload made, and a wave of
    writes pending (a clear, a rel phase, an expiry) at clock 2 s."""
    tw = Twins(capacity=64, sweep_slots=16)
    for i in range(n):
        tw.do(lambda s: s.attach(f"c{i}"))
        tw.do(lambda s: s.inflight_insert(i, 1, Msg(i), "publish"))
    tw.bind(range(n), batch=True)
    tw.do(lambda s: s.manager.sync(s.table))
    tw.mono[0] += 2.0
    tw.do(lambda s: s.set_expiry("c1", 0.1))
    tw.do(lambda s: s.inflight_delete(0, 1))
    tw.do(lambda s: s.inflight_phase(2, 1, "pubrel"))
    return tw


@pytest.mark.parametrize("sweep", [False, True])
def test_fused_route_matches_jax(sweep):
    tw = loaded_twins()
    routers = router_twins()
    assert routers[0].supports_session_fusion and routers[1].supports_session_fusion
    tw.mono[0] += 1.0
    if sweep:
        tw.do(lambda s: s.request_sweep())
    r = tw.riders()
    res = [rt.route_prepared(rt.prepare(), TOPICS, session=rd) for rt, rd in zip(routers, r)]
    assert_route_equal(*res)
    assert_step_equal(res[0].session, res[1].session)
    plain = [rt.route(TOPICS) for rt in routers]
    assert_route_equal(res[0], plain[0])
    assert plain[0].session is None
    extra = [a.readback_bytes - b.readback_bytes for a, b in zip(res, plain)]
    assert extra[0] == extra[1] == (8 * 16 + 8 if sweep else 0)
    if sweep:  # at 3 s: 22 publish-phase rows of 0 s, the rel phase of 2 s, one expiry
        assert res[0].session.due_count == 23 and res[0].session.expired_count == 1
    lanes = {k: v.copy() for k, v in tw.p.table.device_snapshot().items()}
    tw.commit(r, [x.session for x in res])
    # the adopted tensors are the host lanes as the rider left them (the
    # commit's redelivery stamps ride the next rider)
    assert all(tw.p.manager._arrays[k] is v for k, v in res[0].session.arrays.items())
    assert_same_arrays({k: host(v) for k, v in tw.p.manager._arrays.items()}, lanes)


def test_a_rider_takes_precedence_over_a_storm_as_in_jax():
    tw = loaded_twins()
    routers = router_twins()
    stores = (P_ret.DeviceRetainedIndex(max_bytes=64, device="cpu"),
              J_ret.DeviceRetainedIndex(max_bytes=64))
    for st in stores:
        for i in range(10):
            st.add(f"site/{i % 4}/dev/{i % 3}/ch/{i}")
    jobs = [st.prepare_storm(["site/+/dev/1/ch/#", "#"]) for st in stores]
    tw.mono[0] += 1.0
    tw.do(lambda s: s.request_sweep())
    r = tw.riders()
    res = [rt.route_prepared(rt.prepare(), TOPICS, None, job, session=rd)
           for rt, job, rd in zip(routers, jobs, r)]
    assert res[0].retained is None and res[1].retained is None
    assert_route_equal(*res)
    assert_step_equal(res[0].session, res[1].session)
    plain = [rt.route(TOPICS) for rt in routers]
    assert [a.readback_bytes - b.readback_bytes for a, b in zip(res, plain)] == [136, 136]
    tw.commit(r, [x.session for x in res])


def test_mini_flood_through_both_routers():
    """bench.py's session_storm at N = 4,096 sessions, 256-row sweeps and a
    1,024-entry op-log: a flood of 16 sweeps that crosses several op-log
    bumps, each session redelivered exactly once, the same sweeps and full
    resyncs in both packages."""
    n, k = 4096, 256
    stores = []
    mono = [0.0]
    for mod, kw in ((P_store, {"device": "cpu"}), (J_store, {})):
        s = mod.SessionStore(capacity=1 << 13, sweep_slots=k, retry_interval=1.0,
                             clock=lambda: mono[0], **kw)
        shared = Msg("m")
        rows = s.bulk_load([f"c{i}" for i in range(n)], [shared] * n,
                           pids=(np.arange(n) % 65535) + 1)
        assert (rows >= 0).all()
        s2 = mod.SessionStore(capacity=64, sweep_slots=k, retry_interval=1.0,
                              clock=lambda: mono[0], **kw)
        assert s2.install(s.capture()) == n
        s2.table.OPLOG_MAX = 1024
        stores.append(s2)
    sinks = (Sink(), Sink())
    for s, sink in zip(stores, sinks):
        for slot in range(n):
            s._bind[slot] = sink.resend
    mono[0] += 60.0
    routers = router_twins()
    args = [rt.prepare() for rt in routers]
    sweeps = 0
    seen = []
    while len(sinks[0].items) < n:
        assert sweeps < 40
        riders = []
        for s in stores:
            s.request_sweep()
            riders.append(s.take_rider())
        assert_same_rider(*riders)
        oracle = stores[0].table.due_rows(stores[0].now_ds(), stores[0].retry_ds)
        res = [rt.route_prepared(a, TOPICS, session=rd)
               for rt, a, rd in zip(routers, args, riders)]
        assert_route_equal(*res)
        assert_step_equal(res[0].session, res[1].session)
        due = res[0].session.due
        assert res[0].session.due_count == len(oracle)
        np.testing.assert_array_equal(due[due >= 0], oracle[:k])
        seen.append(due[due >= 0])
        for s, rd, x in zip(stores, riders, res):
            s.commit(rd, x.session)
        assert sinks[0].items == sinks[1].items
        sweeps += 1
    rows = np.concatenate(seen)
    assert len(rows) == len(np.unique(rows)) == n == len(sinks[0].items)
    assert sorted(stores[0].table.sess_slot[rows]) == list(range(n))
    assert sorted(p for p, _st, _m in sinks[0].items) == sorted((np.arange(n) % 65535) + 1)
    c = [(s.manager.full_resyncs, s.manager.delta_launches) for s in stores]
    assert c[0] == c[1] and c[0][1] == 0
    # 16 sweeps; a bump at the commit of sweeps 5, 10 and 15 (the log holds
    # four sweeps' touches), so full uploads at sweeps 1, 6, 11 and 16: what
    # chip_smoke's flood_plan derives for the card's flood
    assert sweeps == 16 and c[0][0] == 4
    import chip_smoke

    assert chip_smoke.flood_plan(n, k, 1024) == (16, 4, len(stores[0].table.oplog))


# -- on the card: the kernel against its twin (skips without CUDA) ---------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_session_sweep_matches_twin_on_card(cuda_device):
    dev = cuda_device
    kernels.reset_launches()
    calls = 0
    for cap, scap, k, seed in ((256, 64, 16, 0), (256, 64, 300, 1), (1 << 16, 1 << 12, 100, 2),
                               (5000, 3001, 4096, 3), ((1 << 21) + 7, 1 << 20, 16384, 4)):
        rng = np.random.default_rng(seed)
        lanes = seeded_lanes(rng, cap, scap)
        t = {n: torch.from_numpy(v).to(dev) for n, v in lanes.items()}
        for now in (50, 2**31 - 5, -(2**31) + 3):
            args = (t["sess_slot"], t["sess_state"], t["sess_ts"], t["slot_expiry"], now, 10, k)
            got = P_tab.session_sweep(*args)
            want = P_tab.session_sweep_plain(*args)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
                assert torch.equal(a, b)
            calls += 1
        idxs = {"sess_ts": np.array([3, 5], np.int32)}
        vals = {"sess_ts": np.array([7, 8], np.int32)}
        fused = P_tab.session_ack(t, idxs, vals, np.array([60, 10], np.int32), sweep_k=k)
        plain = P_tab.session_ack_plain(t, idxs, vals, np.array([60, 10], np.int32), sweep_k=k)
        for name in ("due", "due_count", "expired", "expired_count"):
            assert torch.equal(fused[name], plain[name])
        for name in t:
            assert torch.equal(fused["tables"][name], plain["tables"][name])
        calls += 1
    assert kernels.LAUNCHES["session_sweep"] == calls  # one launch a call
    assert kernels.LAUNCHES["segment_scatter"] == 5 * P_seg.SCATTER_LAUNCHES


@pytest.mark.cuda
def test_session_sweep_at_the_flood_table_on_card(cuda_device):
    """The flood's shape (2^22 rows, 2^20 slots, sweep_k 16,384) with a
    dense due set, the edge cases of the CPU tests, and lanes that are views
    whose base is 4 bytes past a 16-byte boundary (the scalar path)."""
    dev = cuda_device
    rng = np.random.default_rng(13)
    cap, scap, k = 1 << 22, 1 << 20, 16384
    lanes = {
        "sess_slot": rng.integers(-2, 1 << 20, cap + 1).astype(np.int32),
        "sess_state": rng.integers(0, 3, cap + 1).astype(np.int32),
        "sess_ts": rng.integers(0, 400, cap + 1).astype(np.int32),
        "slot_expiry": rng.integers(0, 4000, scap + 1).astype(np.int32),
    }
    t = {n: torch.from_numpy(v).to(dev) for n, v in lanes.items()}
    kernels.reset_launches()
    calls = 0
    for off in (0, 1):
        args = [t[n][off : off + (scap if n == "slot_expiry" else cap)] for n in t]
        assert all(a.is_contiguous() for a in args)
        assert all((a.data_ptr() % 16 == 0) == (off == 0) for a in args)
        for now, kk in ((600, k), (600, 3), (-(2**31) + 5, k), (100, 1 << 21)):
            got = P_tab.session_sweep(*args, now, 300, kk)
            want = P_tab.session_sweep_plain(*args, now, 300, kk)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
                assert torch.equal(a, b)
            calls += 1
        assert int(P_tab.session_sweep_plain(*args, 600, 300, k)[1]) > cap // 4
    for case in ("last_block_only", "none_due", "k_past_hits", "now_wraps", "dense"):
        lanes, now, kk = sweep_case(case, np.random.default_rng(len(case)))
        args = [torch.from_numpy(lanes[n]).to(dev) for n in
                ("sess_slot", "sess_state", "sess_ts", "slot_expiry")]
        got = P_tab.session_sweep(*args, now, 10, kk)
        want = P_tab.session_sweep_plain(*args, now, 10, kk)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        calls += 1
    assert kernels.LAUNCHES["session_sweep"] == calls
