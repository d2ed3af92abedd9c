#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (`emqx_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA card with CUDA and nvcc; exits non-zero, printing no
result, anywhere else. It drives the port only (no JAX, nothing of
emqx_tpu), in phases, each of which either passes or ends the run:

1. card and toolchain: card name and power limit, versions, kernel build;
2. tables at full size: the `mixed_1m` configuration (BASELINE config 3:
   filters device/{i}/+/{j}/# for i, j < 1000 plus device/{i}/# for
   i < 100; SubscriberTable(max_subscribers=256), slot = filter index mod
   256) built with the port's own RouteIndex.bulk_add and uploaded;
3. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes (B = 8192 Zipf topics, MAX_BYTES 64, max_levels 8,
   kslot 64) on the real tables: outputs must be EQUAL (all integers);
   warm times are medians of >= 20 CUDA-event samples;
4. routing: DeviceRouter.route over 3 batches of 8192 topics plus edge
   topics, every row's recipient set held against a host oracle, then
   subscribe/unsubscribe churn that pushes rows past kslot onto the
   dense-row path; the launch counters are zeroed before this phase and
   every kernel must have launched in it;
5. one JSON line {"kernels": [...]}: per kernel its launches in phase 4,
   kernel and plain-twin times, and the least time the card could take
   (bytes moved over 3.35 TB/s, or integer operations over the 67 T/s
   scalar rate, whichever is larger);
6. last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 8192
MAX_BYTES = 64
MAX_LEVELS = 8
MAX_SUBSCRIBERS = 256
KSLOT = 64
ROUTE_BATCHES = 3
TIMING_REPS = 25  # >= 20 samples per median
TIMING_INNER = 10  # launches per sample (the mean of a back-to-back run)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

EDGE_TOPICS = ["", "$SYS/broker/x", "a/b/c/d/e/f/g/h/i/j", "device/3/mid/5/"]


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    from emqx_tpu_torch.kernels import build

    out = subprocess.run(
        [build.nvcc_path(), "--version"], check=True, capture_output=True, text=True
    ).stdout
    return out.strip().splitlines()[-1]


def zipf_ids(rng, n, k):
    """n Zipf(1.3) ids in [0, k), as bench.py's mixed_1m draws them."""
    return np.minimum(rng.zipf(1.3, size=n) - 1, k - 1)


def topic_batch(rng, n):
    ids = zipf_ids(rng, n, 1000)
    nums = rng.integers(0, 1000, size=n)
    return [f"device/{i}/mid/{j}/leaf" for i, j in zip(ids, nums)]


def build_tables():
    from emqx_tpu_torch.models.router_model import SubscriberTable
    from emqx_tpu_torch.ops.route_index import RouteIndex

    filters = [f"device/{i}/+/{j}/#" for i in range(1000) for j in range(1000)]
    filters += [f"device/{i}/#" for i in range(100)]
    index = RouteIndex()
    fids = np.asarray(index.bulk_add(filters), np.int64)
    subtab = SubscriberTable(max_subscribers=MAX_SUBSCRIBERS)
    subtab.bulk_add(fids, np.arange(len(fids)) % MAX_SUBSCRIBERS)
    return index, subtab


def slot_set(row: np.ndarray) -> set:
    bits = np.unpackbits(np.ascontiguousarray(row).view(np.uint8), bitorder="little")
    return set(np.nonzero(bits)[0].tolist())


class Oracle:
    """Host reference: invert each live shape against the topic, look the
    resulting filter up in the RouteIndex (as bench.py `_expected_matches`
    does), and union the SubscriberTable rows of the filters found."""

    def __init__(self, index, subtab):
        self.index = index
        self.subtab = subtab

    def fids(self, topic: str) -> set:
        ws = topic.split("/")
        nw = len(ws)
        dollar = topic.startswith("$")
        out = set()
        for (mask, plen, hh), _sid in self.index.shapes._shape_ids.items():
            if (nw < plen) if hh else (nw != plen):
                continue
            rootwild = (plen == 0 and hh) or (plen > 0 and not (mask & 1))
            if dollar and rootwild:
                continue
            parts = [ws[l] if (mask >> l) & 1 else "+" for l in range(plen)]
            if hh:
                parts.append("#")
            fid = self.index.filter_id("/".join(parts))
            if fid is not None:
                out.add(fid)
        return out

    def slots(self, fids) -> set:
        out = set()
        for f in fids:
            out |= slot_set(self.subtab.arr[f])
        return out


def check_batch(res, topics, oracle) -> dict:
    """Every non-flagged row's matched fids and recipient slots equal the
    oracle's; flagged rows are exactly the topics deeper than MAX_LEVELS
    (the host routes those)."""
    n_ovf = n_flag = n_bits = 0
    for i, t in enumerate(topics):
        deep = len(t.split("/")) > MAX_LEVELS
        if bool(res.flags[i]) != deep:
            raise AssertionError(f"row {i} {t!r}: flag {res.flags[i]} != deep {deep}")
        if deep:
            n_flag += 1
            continue
        want_f = oracle.fids(t)
        got_f = set(res.matched[i][res.matched[i] >= 0].tolist())
        if got_f != want_f or int(res.mcount[i]) != len(want_f):
            raise AssertionError(f"row {i} {t!r}: fids {got_f} != {want_f}")
        if res.overflow[i]:
            n_ovf += 1
            got = slot_set(res.dense_rows[res.dense_index[i]])
        else:
            got = set(res.slots[i][res.slots[i] >= 0].tolist())
        want = oracle.slots(want_f)
        if got != want or int(res.slot_count[i]) != len(want):
            raise AssertionError(f"row {i} {t!r}: slots {sorted(got)} != {sorted(want)}")
        n_bits += len(want)
    return {"rows": len(topics), "flagged": n_flag, "overflow_rows": n_ovf,
            "recipients": n_bits}


def time_ms(fn, torch) -> float:
    """Median over TIMING_REPS samples of the mean time of TIMING_INNER
    back-to-back calls, between CUDA events (after two warm calls)."""
    fn()
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMING_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TIMING_INNER):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / TIMING_INNER)
    return float(np.median(samples))


KERNEL_SYMBOLS = {  # CUDA kernel name inside each launcher
    "tokenize": "tokenize_kernel",
    "shape_match": "shape_match_kernel",
    "fanout_bitmaps": "fanout_kernel",
    "compact_fanout_slots": "compact_kernel",
}


def profiled(torch, fn, reps: int):
    """Run fn reps times under torch.profiler (CPU + CUDA activity) ->
    (key_averages, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def device_ms(torch, name: str, fn):
    """Mean device time of one launch of kernel `name`, from the CUPTI
    trace of 20 launches; None when the trace holds no device time."""
    events, _ = profiled(torch, fn, 20)
    hits = [e for e in events if KERNEL_SYMBOLS[name] in e.key and e.count]
    total = sum(e.self_device_time_total for e in hits)
    count = sum(e.count for e in hits)
    return total / count / 1e3 if total > 0 else None


def max_abs_err(got, want, torch) -> int:
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w, torch) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape}/{got.dtype} != {want.shape}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_vs_plain(torch, args, rng):
    """Phase 3: each kernel against its twin on the card, on the real tables."""
    from emqx_tpu_torch.models import router_model as R
    from emqx_tpu_torch.ops import shape_index as S
    from emqx_tpu_torch.ops import tokenizer as T

    tables, salt, m_active, kslot = args
    dev = tables["shape_tab"].device
    mat, lens, _ = T.encode_topics(topic_batch(rng, BATCH), MAX_BYTES)
    bm = torch.from_numpy(mat).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    B, MB, L, M = BATCH, MAX_BYTES, MAX_LEVELS, m_active

    tok = T.tokenize(bm, ln, salt, L)
    h1, h2, nw, dl = tok
    matched = S.shape_match(tables, M, h1, h2, nw, dl)
    bits, pop = R.fanout_bitmaps(tables["sub_bitmaps"], matched)
    W = bits.shape[1]
    comp = R.compact_fanout_slots(bits, KSLOT)
    torch.cuda.synchronize()

    # least bytes each function must move at these inputs; ops are a
    # per-element count of its integer instructions
    plen = tables["shape_len"][:M]
    flags = tables["shape_flags"][:M]
    nwl = nw.to(torch.int64)[:, None]
    ok_len = torch.where((flags & 1 != 0)[None, :], nwl >= plen[None, :], nwl == plen[None, :])
    valid = ok_len & (plen >= 0)[None, :] & ~(dl[:, None] & (flags & 2 != 0)[None, :])
    n_valid = int(valid.sum())
    n_hit = int((matched >= 0).sum())
    fids = matched[matched >= 0].unique().numel()
    nbytes = int(ln.clamp(0, MB).sum())
    kinds = {
        "tokenize": dict(
            kernel=lambda: T.tokenize(bm, ln, salt, L),
            plain=lambda: T.tokenize_plain(bm, ln, salt, L),
            out=tok,
            source="emqx_tpu_torch/kernels/csrc/tokenize.cu",
            replaces="emqx_tpu/ops/tokenizer.py:147",
            bytes=B * MB + 4 * B + 2 * 4 * B * L + 4 * B + B,
            ops=6 * nbytes + 12 * B * L,
        ),
        "shape_match": dict(
            kernel=lambda: S.shape_match(tables, M, h1, h2, nw, dl),
            plain=lambda: S.shape_match_plain(tables, M, h1, h2, nw, dl),
            out=matched,
            source="emqx_tpu_torch/kernels/csrc/shape_match.cu",
            replaces="emqx_tpu/ops/shape_index.py:1108",
            # inputs + one packed row and tombstone word per hit, one
            # packed and one hot row per valid lane that misses, output
            bytes=2 * 4 * B * L + 5 * B + 3 * 4 * M
            + 20 * n_hit + 36 * (n_valid - n_hit) + 4 * B * M,
            ops=B * M * 12 + n_valid * (6 * L + 30),
        ),
        "fanout_bitmaps": dict(
            kernel=lambda: R.fanout_bitmaps(tables["sub_bitmaps"], matched),
            plain=lambda: R.fanout_bitmaps_plain(tables["sub_bitmaps"], matched),
            out=(bits, pop),
            source="emqx_tpu_torch/kernels/csrc/fanout.cu",
            replaces="emqx_tpu/models/router_model.py:52",
            bytes=4 * B * M + 4 * W * fids + 4 * B * W + 4 * B,
            ops=B * W * (3 * M + 2),
        ),
        "compact_fanout_slots": dict(
            kernel=lambda: R.compact_fanout_slots(bits, KSLOT),
            plain=lambda: R.compact_fanout_slots_plain(bits, KSLOT),
            out=comp,
            source="emqx_tpu_torch/kernels/csrc/compact.cu",
            replaces="emqx_tpu/models/router_model.py:77",
            bytes=4 * B * W + 4 * B * KSLOT + 4 * B + B,
            ops=B * W * 12 + int(pop.sum()) * 4,
        ),
    }
    report = {}
    for name, k in kinds.items():
        want = k["plain"]()
        torch.cuda.synchronize()
        err = max_abs_err(k["out"], want, torch)
        if err:
            raise AssertionError(f"{name}: kernel != plain twin (max |diff| {err})")
        ms = time_ms(k["kernel"], torch)
        plain_ms = time_ms(k["plain"], torch)
        dev_ms = device_ms(torch, name, k["kernel"])
        bound_ms, bound_by = bound(k["bytes"], k["ops"])
        report[name] = {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            # the kernel alone on the device (CUPTI), without the launch
            # path that `ms` includes
            "device_ms": dev_ms,
        }
        phase("kernel", kernel=name, equal=True, ms=ms, device_ms=dev_ms,
              plain_ms=plain_ms, bound_ms=bound_ms, bytes=k["bytes"], ops=k["ops"])
    phase("kernel_inputs", batch=B, max_bytes=MB, max_levels=L, m_active=M,
          width_words=W, kslot=KSLOT, valid_lanes=n_valid, hits=n_hit,
          distinct_fids=fids, fanout_bits=int(pop.sum()))
    return report


def route_breakdown(torch, router, rng, n_batches: int = 5) -> dict:
    """Where one routed batch's time goes, medians over n_batches (host
    clock, each stage ending in a synchronize): host encode, host->device
    copy of the topic bytes, the four launches up to their completion,
    and the readback; then a whole route() of the same batch. Plus the
    device's busy share of n_batches profiled route() calls."""
    from emqx_tpu_torch.models.router_model import shape_route_step
    from emqx_tpu_torch.ops.tokenizer import encode_topics

    tables, salt, m_active, kslot = router.prepare()
    dev = router.device
    names = ("encode", "h2d", "kernels", "readback", "route")
    samples = {k: [] for k in names}
    batches = [topic_batch(rng, BATCH) for _ in range(n_batches)]
    for topics in batches:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mat, lens, too_long = encode_topics(topics, MAX_BYTES)
        t.append(time.perf_counter())
        bm = torch.from_numpy(mat).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = shape_route_step(tables, bm, ln, m_active=m_active, salt=salt,
                               max_levels=MAX_LEVELS, kslot=kslot, device=dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        router._readback(out, len(topics), too_long, kslot)
        t.append(time.perf_counter())
        router.route(topics)
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            samples[k].append(1e3 * (b - a))
    med = {f"{k}_ms": float(np.median(v)) for k, v in samples.items()}
    it = iter(batches * 2)
    events, wall = profiled(torch, lambda: router.route(next(it)), n_batches)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    med["device_busy_share"] = busy / wall if busy > 0 else None
    med["topics_per_s"] = BATCH / (med["route_ms"] / 1e3)
    return med


def route_phase(torch, index, subtab, router, rng):
    """Phase 4: the main path through DeviceRouter.route, checked row by row."""
    from emqx_tpu_torch import kernels

    oracle = Oracle(index, subtab)
    batches = []
    for _ in range(ROUTE_BATCHES):
        topics = topic_batch(rng, BATCH)
        topics[: len(EDGE_TOPICS)] = EDGE_TOPICS
        batches.append(topics)
    churn_topics = topic_batch(rng, BATCH)
    churn_topics[: 64] = [f"device/7/mid/{j}/leaf" for j in range(64)]

    kernels.reset_launches()
    summary = []
    for topics in batches:
        t0 = time.perf_counter()
        res = router.route(topics)
        wall = time.perf_counter() - t0
        summary.append({"route_ms": wall * 1e3, "readback_bytes": res.readback_bytes,
                        **check_batch(res, topics, oracle)})
    # churn: extra subscribers on device/7/# push its rows past kslot
    fid = index.add("device/7/#")
    churn_slots = [s for s in range(100) if s not in slot_set(subtab.arr[fid])]
    for s in churn_slots:
        subtab.add(fid, s)
    res = router.route(churn_topics)
    after_sub = check_batch(res, churn_topics, oracle)
    if after_sub["overflow_rows"] == 0:
        raise AssertionError("churn produced no overflow rows")
    for s in churn_slots:
        subtab.remove(fid, s)
    index.remove("device/7/#")
    res = router.route(churn_topics)
    after_unsub = check_batch(res, churn_topics, oracle)
    if after_unsub["overflow_rows"] != 0:
        raise AssertionError("overflow rows remain after unsubscribe")
    launches = dict(kernels.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    phase("route", batches=summary, churn_subscribe=after_sub,
          churn_unsubscribe=after_unsub, launches=launches)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from emqx_tpu_torch.kernels import build
    from emqx_tpu_torch.models.router_model import DeviceRouter
    from emqx_tpu_torch.ops.matcher import MatcherConfig

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load()
    phase("toolchain", card=card, python=sys.version.split()[0],
          torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version(),
          build_seconds=time.perf_counter() - t0)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    index, subtab = build_tables()
    host_s = time.perf_counter() - t0
    router = DeviceRouter(
        index, subtab, MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
        device="cuda",
    )
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if index.residual_count != 0 or args[3] != KSLOT:
        raise AssertionError(f"residual {index.residual_count}, kslot {args[3]}")
    phase("tables", filters=len(index), residual_count=index.residual_count,
          m_active=args[2], kslot=args[3], host_build_seconds=host_s,
          upload_seconds=upload_s,
          device_bytes={k: t.numel() * t.element_size() for k, t in args[0].items()})

    report = kernels_vs_plain(torch, args, rng)
    launches = route_phase(torch, index, subtab, router, rng)
    phase("route_breakdown", **route_breakdown(torch, router, rng))
    for name, n in launches.items():
        report[name]["launches"] = n
    print(card, flush=True)
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
