"""The port's device mirror against the JAX package and the host tables.

`segment_scatter` (port) against `segment_scatter_impl` on the same arrays
and deltas (int32 words and uint8 bytes), and the port's `DeviceSegmentManager` against the host
`device_snapshot()` of each source it mirrors (`ShapeIndex`, `NfaBuilder`,
`SubscriberTable`, the port's own copies) after seeded churn, with its
counters held against the `emqx_tpu` manager driven through the same
churn on the `emqx_tpu` sources. The port runs on the CPU (the kernel's
plain twin); the `cuda`-marked test at the end holds the kernel against
the twin on a card. Tolerance: EXACT equality (all integers).
"""

import random

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import nfa as J_nfa
from emqx_tpu.ops import segments as J_seg
from emqx_tpu.ops import shape_index as J_shape
from emqx_tpu.ops import topics as J_topics
from emqx_tpu_torch import convert, kernels
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import nfa as P_nfa
from emqx_tpu_torch.ops import segments as P_seg
from emqx_tpu_torch.ops import shape_index as P_shape


def assert_mirror(out, src):
    snap = src.device_snapshot()
    assert set(out) == set(snap)
    for k, v in snap.items():
        assert out[k].dtype == torch.int32 and tuple(out[k].shape) == v.shape, k
        np.testing.assert_array_equal(out[k].numpy().view(v.dtype), v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_scatter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    flats = {
        "a": rng.integers(-(1 << 31), 1 << 31, size=4096, dtype=np.int64).astype(np.int32),
        "b": rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32),
        "c": np.full(64, -1, np.int32),
    }
    idxs = {k: rng.choice(v.size, size=n, replace=False)
            for (k, v), n in zip(flats.items(), (700, 1000, 1))}
    vals = {
        "a": rng.integers(-(1 << 31), 1 << 31, size=700, dtype=np.int64).astype(np.int32),
        "b": rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32),
        "c": np.array([7], np.int32),
    }
    want = jax.jit(J_seg.segment_scatter_impl)(
        {k: jnp.asarray(v) for k, v in flats.items()},
        {k: jnp.asarray(v.astype(np.int32)) for k, v in idxs.items()},
        {k: jnp.asarray(v) for k, v in vals.items()},
    )
    inputs = {k: torch.from_numpy(v.view(np.int32).copy()) for k, v in flats.items()}
    before = {k: t.clone() for k, t in inputs.items()}
    got = P_seg.segment_scatter(inputs, idxs, vals)
    for k in flats:
        np.testing.assert_array_equal(got[k].numpy().view(flats[k].dtype),
                                      np.asarray(want[k]), err_msg=k)
        assert torch.equal(inputs[k], before[k])  # fresh buffers, inputs untouched


@pytest.mark.parametrize("seed", [0, 1])
def test_byte_scatter_matches_jax(seed):
    """uint8 arrays (the retained topic chunks) beside an int32 one, in
    one call: each keeps its type and takes its values' low byte."""
    rng = np.random.default_rng(seed)
    flats = {
        "chunk_0": rng.integers(0, 256, size=(512, 32), dtype=np.uint8),
        "chunk_1": np.zeros((64, 32), np.uint8),
        "w": rng.integers(-(1 << 31), 1 << 31, size=300, dtype=np.int64).astype(np.int32),
    }
    idxs = {k: rng.choice(v.size, size=n, replace=False)
            for (k, v), n in zip(flats.items(), (2000, 33, 40))}
    vals = {k: rng.integers(0, 256, size=len(v)).astype(flats[k].dtype) for k, v in idxs.items()}
    want = jax.jit(J_seg.segment_scatter_impl)(
        {k: jnp.asarray(v.reshape(-1)) for k, v in flats.items()},
        {k: jnp.asarray(v.astype(np.int32)) for k, v in idxs.items()},
        {k: jnp.asarray(v) for k, v in vals.items()},
    )
    inputs = {k: torch.from_numpy(v.copy()) for k, v in flats.items()}
    got = P_seg.segment_scatter(inputs, idxs, vals)
    for k, v in flats.items():
        assert got[k].dtype == inputs[k].dtype and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy().reshape(-1), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(inputs[k].numpy(), v)  # inputs untouched


def test_upload_keeps_bytes_as_bytes():
    snap = {"chunk_0": np.arange(64, dtype=np.uint8).reshape(4, 16),
            "bits": np.array([0xFFFFFFFF, 3], np.uint32)}
    t = convert.upload(snap, device="cpu")
    assert t["chunk_0"].dtype == torch.uint8 and t["bits"].dtype == torch.int32
    np.testing.assert_array_equal(t["chunk_0"].numpy(), snap["chunk_0"])
    snap["chunk_0"][0, 0] = 99  # a copy, not a view of the live host array
    assert int(t["chunk_0"][0, 0]) == 0
    with pytest.raises(TypeError, match="int32 or uint32"):
        convert.upload({"x": np.zeros(4, np.int16)}, device="cpu")


def test_segment_scatter_keeps_the_last_write_per_slot():
    flat = {"x": torch.zeros((4, 2), dtype=torch.int32)}
    # one slot written three times and another twice, in program order
    idx = {"x": np.array([5, 1, 5, 3, 1, 5])}
    val = {"x": np.array([10, 11, 12, 13, 0xFFFFFFFF, -4])}
    got = P_seg.segment_scatter(flat, idx, val)["x"]
    assert got.shape == (4, 2)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), [0, -1, 0, 13, 0, -4, 0, 0])
    with pytest.raises(IndexError, match="outside"):
        P_seg.segment_scatter(flat, {"x": np.array([8])}, {"x": np.array([1])})
    # float32 and bfloat16 arrays are the semantic table's; float64 is no table's
    with pytest.raises(TypeError, match="int32"):
        P_seg.segment_scatter({"x": torch.zeros(4, dtype=torch.float64)}, {"x": [0]}, {"x": [1]})


def dup_heavy_delta(rng, case):
    """Seeded deltas where one slot is written many times: arrays of the
    four types the kernel writes, in program order. `case`: "one_slot" (a
    few slots, hundreds of writes each), "across" (the same flat indices
    in every array), "bytes" (byte writes into shared 4-byte words, every
    byte of some words), "empty" (no entries; one array with none)."""
    flats = {
        "w": rng.integers(-(1 << 31), 1 << 31, size=300, dtype=np.int64).astype(np.int32),
        "b": rng.integers(0, 256, size=(64, 8), dtype=np.uint8),
        "f": rng.normal(size=200).astype(np.float32),
        "h": rng.normal(size=96).astype(np.float32),  # a bfloat16 array
    }
    if case == "empty":
        return flats, {k: [] for k in flats}, {k: [] for k in flats}
    if case == "one_slot":
        idxs = {k: rng.choice([3, 7, 11], size=400) for k in flats}
    elif case == "across":
        common = rng.integers(0, 96, size=150)
        idxs = {k: np.concatenate([common, common[::-1]]) for k in flats}
    else:
        words = rng.choice(128, size=20, replace=False)
        ib = (4 * words[:, None] + np.arange(4)).reshape(-1)
        ib = np.concatenate([ib, rng.permutation(ib), rng.integers(0, 512, 100)])
        idxs = {"b": ib, "w": rng.integers(0, 300, 50), "f": np.array([5, 5, 5]),
                "h": np.array([], np.int64)}
    vals = {
        "w": [int(v) for v in rng.integers(-(1 << 31), 1 << 32, size=len(idxs["w"]))],
        "b": [int(v) for v in rng.integers(0, 256, size=len(idxs["b"]))],
        "f": rng.normal(size=len(idxs["f"])).tolist(),
        "h": rng.normal(size=len(idxs["h"])).tolist(),
    }
    return flats, {k: [int(i) for i in v] for k, v in idxs.items()}, vals


def torch_flats(flats, device="cpu"):
    out = {k: torch.from_numpy(v.copy()) for k, v in flats.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return {k: t.to(device) for k, t in out.items()}


def as_bits(t):
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return (t.view(view) if view is not None else t).cpu().numpy().reshape(-1)


@pytest.mark.parametrize("case", ["one_slot", "across", "bytes", "empty"])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_entries_and_device_dedup_twin(case, seed):
    """`pack_entries` keeps every entry in program order, and
    `last_write_mask_plain` (the twin of the claim/store passes) keeps
    exactly the entries `_last_writes` keeps; the wrapper's result equals
    `segment_scatter_plain` and JAX's `segment_scatter_impl` (bf16 lanes
    as their bits) in all four types."""
    rng = np.random.default_rng(seed)
    flats, idxs, vals = dup_heavy_delta(rng, case)
    tf = torch_flats(flats)
    names, offsets, idx, bits = P_seg.pack_entries(tf, idxs, vals)
    assert names == list(tf) and offsets[0] == 0 and offsets[-1] == len(idx) == len(bits)
    keep = P_seg.last_write_mask_plain(offsets, idx).numpy()
    for a, k in enumerate(names):
        lo, hi = offsets[a], offsets[a + 1]
        np.testing.assert_array_equal(idx[lo:hi], np.asarray(idxs[k], np.int64))
        np.testing.assert_array_equal(bits[lo:hi], P_seg._value_bits(vals[k], tf[k].dtype))
        want_ix, want_bits = P_seg._last_writes(idxs[k], vals[k], tf[k].dtype)
        sel = np.nonzero(keep[lo:hi])[0]
        order = np.argsort(idx[lo:hi][sel])
        np.testing.assert_array_equal(idx[lo:hi][sel][order], want_ix)
        np.testing.assert_array_equal(bits[lo:hi][sel][order], want_bits)
    got = P_seg.segment_scatter(tf, idxs, vals)
    plain = P_seg.segment_scatter_plain(tf, idxs, vals)
    # JAX's scatter takes one write a slot (its manager keeps the last in
    # a dict): hand it the entries the twin kept
    jflats = {k: jnp.asarray(v.reshape(-1)) for k, v in flats.items()}
    jflats["h"] = jnp.asarray(flats["h"].astype(ml_dtypes.bfloat16))
    as_type = {"w": lambda b: b.view(np.int32), "b": lambda b: b.astype(np.uint8),
               "f": lambda b: b.view(np.float32),
               "h": lambda b: b.astype(np.uint16).view(ml_dtypes.bfloat16)}
    jidx, jvals = {}, {}
    for a, k in enumerate(names):
        sel = slice(offsets[a], offsets[a + 1])
        kept = keep[sel]
        jidx[k] = jnp.asarray(idx[sel][kept].astype(np.int32))
        jvals[k] = jnp.asarray(as_type[k](bits[sel][kept]))
    want = jax.jit(J_seg.segment_scatter_impl)(jflats, jidx, jvals)
    for k in flats:
        assert got[k].dtype == tf[k].dtype and got[k].shape == tf[k].shape
        np.testing.assert_array_equal(as_bits(got[k]), as_bits(plain[k]), err_msg=k)
        jbits = np.asarray(want[k]).reshape(-1)
        jbits = jbits.view({4: np.int32, 2: np.int16, 1: np.uint8}[jbits.itemsize])
        np.testing.assert_array_equal(as_bits(got[k]), jbits, err_msg=k)


def test_pack_entries_refuses_bad_deltas():
    x = {"x": torch.zeros(8, dtype=torch.int32)}
    with pytest.raises(IndexError, match="outside"):
        P_seg.pack_entries(x, {"x": [1, 8]}, {"x": [0, 0]})
    with pytest.raises(IndexError, match="outside"):
        P_seg.pack_entries(x, {"x": [-1]}, {"x": [0]})
    with pytest.raises(ValueError, match="2 indices but 1 values"):
        P_seg.pack_entries(x, {"x": [1, 2]}, {"x": [0]})
    with pytest.raises(ValueError, match="contiguous"):
        P_seg.pack_entries({"x": torch.zeros((4, 4), dtype=torch.int32).T}, {"x": [0]},
                           {"x": [0]})


class ScatterSpy:
    """Records each delta replay's touched arrays (both packages)."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        real_p, real_j = P_seg.segment_scatter, J_seg._segment_scatter

        def spy_p(flats, idxs, vals):
            self.port.append(sorted(flats))
            return real_p(flats, idxs, vals)

        def spy_j(flats, idxs, vals):
            self.jax.append(sorted(flats))
            return real_j(flats, idxs, vals)

        monkeypatch.setattr(P_seg, "segment_scatter", spy_p)
        monkeypatch.setattr(J_seg, "_segment_scatter", spy_j)


def counters(man):
    return (man.full_resyncs, man.delta_launches, man.array_resyncs)


def nfa_churn(rng, builders, live, n_add, n_del):
    words = [f"w{i}" for i in range(30)] + ["+", "#"]
    for _ in range(n_add):
        f = "/".join(rng.choice(words) for _ in range(rng.randint(1, 5)))
        try:
            J_topics.validate(f)
        except J_topics.TopicValidationError:
            continue
        for b in builders:
            b.add(f)
        live.append(f)
    for _ in range(n_del):
        if live:
            f = live.pop(rng.randrange(len(live)))
            for b in builders:
                b.remove(f)


@pytest.mark.parametrize("seed", [3, 8])
def test_nfa_mirror_tracks_churn_like_jax(seed, monkeypatch):
    spy = ScatterSpy(monkeypatch)
    rng = random.Random(seed)
    pb, jb = P_nfa.NfaBuilder(), J_nfa.NfaBuilder()
    pm = P_seg.DeviceSegmentManager(device="cpu", name="nfa")
    jm = J_seg.DeviceSegmentManager(name="nfa")
    live = []
    for step in range(25):
        # step 12 grows past the first node/edge/vocab capacity (epoch bump)
        nfa_churn(rng, (pb, jb), live, 400 if step == 12 else rng.randint(1, 9),
                  rng.randint(0, 6))
        out = pm.sync(pb)
        jm.sync(jb)
        assert_mirror(out, pb)
        assert counters(pm) == counters(jm), step
    assert spy.port == spy.jax  # the same arrays in the same launches
    assert pm.full_resyncs >= 2 and pm.delta_launches >= 10
    # every delta replay is ONE launch, whatever mix of arrays it touched
    assert max(len(names) for names in spy.port) >= 3


def shape_pair():
    return P_shape.ShapeIndex(), J_shape.ShapeIndex()


def test_shape_mirror_multi_array_suffix_is_one_launch(monkeypatch):
    spy = ScatterSpy(monkeypatch)
    srcs = shape_pair()
    mans = (P_seg.DeviceSegmentManager(device="cpu"), J_seg.DeviceSegmentManager())
    for s in srcs:
        s.add("a/+/c", 0)
    for m, s in zip(mans, srcs):
        m.sync(s)
    assert spy.port == []
    for s in srcs:
        s.add("x/y/#", 1)
        s.add("q/+", 2)
        s.remove("a/+/c")
    out = mans[0].sync(srcs[0])
    mans[1].sync(srcs[1])
    assert len(spy.port) == 1 and len(spy.port[0]) >= 2
    assert spy.port == spy.jax
    assert_mirror(out, srcs[0])
    # a clean sync launches nothing and hands back the same tensors
    again = mans[0].sync(srcs[0])
    assert len(spy.port) == 1 and all(again[k] is out[k] for k in out)


def test_shape_resync_marker_reuploads_only_that_array():
    si = P_shape.ShapeIndex()
    man = P_seg.DeviceSegmentManager(device="cpu")
    for i in range(4):
        si.add(f"s/{i}/+", i)
    out0 = man.sync(si)
    si._rebuild_hot(min_cap=si._Hcap * 2)  # "!resync shape_hot" marker
    assert si.epoch == 0 and si.oplog[-1][0] == P_seg.RESYNC
    # a new shape after the marker: its hot row rides the re-upload, its
    # shape meta rides one scatter
    si.add("n/+/+/z", 9)
    out1 = man.sync(si)
    assert man.array_resyncs == 1 and man.delta_launches == 1
    assert out1["shape_tab"] is out0["shape_tab"]  # the packed mirror stays
    assert out1["shape_hot"].shape[0] == si._Hcap * 4
    assert_mirror(out1, si)


def test_array_without_marker_uploads_in_full():
    class Src:
        epoch, version = 0, 0

        def __init__(self):
            self.arrays = {"a": np.zeros(8, np.int32)}
            self.oplog = []

        def device_snapshot(self):
            return self.arrays

    src = Src()
    man = P_seg.DeviceSegmentManager(device="cpu")
    man.sync(src)
    src.arrays["b"] = np.arange(4, dtype=np.uint32)
    src.arrays["a"][2] = 5
    src.oplog += [("b", 1, 1), ("a", 2, 5)]
    out = man.sync(src)
    assert man.array_resyncs == 1 and man.delta_launches == 1
    assert_mirror(out, src)


def test_oplog_cap_forces_an_epoch_resync():
    b = P_nfa.NfaBuilder()
    b.OPLOG_MAX = 64  # tiny, to reach the cap fast
    man = P_seg.DeviceSegmentManager(device="cpu")
    man.sync(b)
    epoch0 = b.epoch
    for i in range(60):
        b.add(f"c/{i}/#")
    assert b.epoch > epoch0
    out = man.sync(b)
    assert counters(man) == (2, 0, 0)
    assert_mirror(out, b)


def test_torn_sync_is_never_cached_clean():
    si = P_shape.ShapeIndex()
    si.add("a/+", 0)
    man = P_seg.DeviceSegmentManager(device="cpu")
    real = si.device_snapshot

    def torn_snapshot():
        out = real()
        si.add("raced/+", 99)  # a mutation lands mid-upload
        return out

    si.device_snapshot = torn_snapshot
    man.sync(si)
    si.device_snapshot = real
    assert man._torn
    out = man.sync(si)  # the next sync uploads in full again
    assert man.full_resyncs == 2 and not man._torn
    assert_mirror(out, si)


def test_subscriber_mirror_tracks_churn_and_growth():
    rng = np.random.default_rng(2)
    tabs = (P_router.SubscriberTable(max_subscribers=64),
            J_router.SubscriberTable(max_subscribers=64))
    mans = (P_seg.DeviceSegmentManager(device="cpu"), J_seg.DeviceSegmentManager())
    for step in range(12):
        ops = [(int(rng.integers(0, 48 if step < 6 else 300)), int(rng.integers(0, 64)),
                bool(rng.random() < 0.3)) for _ in range(int(rng.integers(1, 30)))]
        for t in tabs:
            for fid, slot, rm in ops:
                (t.remove if rm else t.add)(fid, slot)
        out = mans[0].sync(tabs[0])
        mans[1].sync(tabs[1])
        assert_mirror(out, tabs[0])
        assert counters(mans[0]) == counters(mans[1]), step
    assert mans[0].full_resyncs >= 2 and mans[0].delta_launches >= 5


def test_manager_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_seg.DeviceSegmentManager()
    kernels.reset_launches()
    man = P_seg.DeviceSegmentManager(device="cpu")
    t = P_router.SubscriberTable()
    man.sync(t)
    t.add(3, 5)
    man.sync(t)
    assert man.delta_launches == 1 and kernels.LAUNCHES["segment_scatter"] == 0


# -- on the card: the kernel against its twin (skips without CUDA) --------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_segment_scatter_kernel_matches_twin_on_card(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(9)
    flats = {"a": torch.from_numpy(rng.integers(-9, 9, size=(1000, 8)).astype(np.int32)).to(dev),
             "b": torch.zeros(1 << 16, dtype=torch.int32, device=dev)}
    idxs = {"a": rng.integers(0, 8000, size=3000), "b": rng.integers(0, 1 << 16, size=5000)}
    vals = {k: rng.integers(-(1 << 31), 1 << 32, size=len(v)) for k, v in idxs.items()}
    before = {k: t.clone() for k, t in flats.items()}
    kernels.reset_launches()
    got = P_seg.segment_scatter(flats, idxs, vals)
    want = P_seg.segment_scatter_plain(flats, idxs, vals)
    for k in flats:
        assert torch.equal(got[k], want[k]) and torch.equal(flats[k], before[k])
    assert kernels.LAUNCHES["segment_scatter"] == P_seg.SCATTER_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_slot", "across", "bytes", "empty"])
def test_dup_heavy_scatter_matches_twin_on_card(case, cuda_device):
    """The claim/store passes on duplicate-heavy deltas: bit for bit the
    twin's result in all four types, the inputs untouched, and the launch
    count (none for an empty delta)."""
    rng = np.random.default_rng(17)
    for _ in range(3):
        flats, idxs, vals = dup_heavy_delta(rng, case)
        tf = torch_flats(flats, cuda_device)
        before = {k: t.clone() for k, t in tf.items()}
        kernels.reset_launches()
        got = P_seg.segment_scatter(tf, idxs, vals)
        torch.cuda.synchronize()
        launched = kernels.LAUNCHES["segment_scatter"]
        want = P_seg.segment_scatter_plain(tf, idxs, vals)
        for k in tf:
            assert got[k].dtype == tf[k].dtype
            np.testing.assert_array_equal(as_bits(got[k]), as_bits(want[k]), err_msg=k)
            assert torch.equal(tf[k], before[k])
        assert launched == (0 if case == "empty" else P_seg.SCATTER_LAUNCHES)
