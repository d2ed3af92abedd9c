"""The port's host-table copies against emqx_tpu's originals.

`emqx_tpu_torch` keeps its own copies of the host builders (RouteIndex,
ShapeIndex, NfaBuilder, SubscriberTable, the topic encoder and the numpy
tokenizer). Fed the same seeded inputs, both packages must hand out
byte-identical device arrays, the same fids, salts, shape counts and
residual sets. Tolerance: EXACT equality everywhere — every output is an
integer or a byte array.

Also here: the import guard rails (the port imports neither jax nor
anything of emqx_tpu).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from emqx_tpu.models import router_model as J_router
from emqx_tpu.ops import nfa as J_nfa
from emqx_tpu.ops import route_index as J_ri
from emqx_tpu.ops import tokenizer as J_tok
from emqx_tpu.ops import topics as J_topics
from emqx_tpu_torch.models import router_model as P_router
from emqx_tpu_torch.ops import nfa as P_nfa
from emqx_tpu_torch.ops import route_index as P_ri
from emqx_tpu_torch.ops import tokenizer as P_tok
from emqx_tpu_torch.ops import topics as P_topics

ROOT = pathlib.Path(__file__).resolve().parents[1]


def seeded_filters(rng, n, non_ascii=False):
    """A mix of every shape family the index treats differently: shape-fit
    wildcard filters, exact filters, root wildcards, `$` filters, filters
    too deep for a shape (residual), and duplicates."""
    out = []
    for _ in range(n):
        kind = int(rng.integers(0, 9))
        i, j = (int(x) for x in rng.integers(0, 40, size=2))
        if kind == 0:
            out.append(f"device/{i}/+/{j}/#")
        elif kind == 1:
            out.append(f"device/{i}/#")
        elif kind == 2:
            out.append(f"sensor/{i}/state/{j}")
        elif kind == 3:
            out.append(f"+/{i}/x")
        elif kind == 4:
            out.append("#")
        elif kind == 5:
            out.append(f"$SYS/{i}/#")
        elif kind == 6:
            out.append(f"a/+/+/{j}")
        elif kind == 7:
            out.append("deep/" + "/".join(["x"] * (33 + i % 3)))
        else:
            out.append(f"ünï/{i}" if non_ascii else f"u/{i}//{j}")
    return out


def assert_same_index(p, j):
    for name, snap_p, snap_j in (
        ("shapes", p.shapes.device_snapshot(), j.shapes.device_snapshot()),
        ("nfa", p.nfa.device_snapshot(), j.nfa.device_snapshot()),
    ):
        assert snap_p.keys() == snap_j.keys(), name
        for k in snap_j:
            assert snap_p[k].dtype == snap_j[k].dtype, (name, k)
            np.testing.assert_array_equal(snap_p[k], snap_j[k], err_msg=f"{name}.{k}")
    assert p.salt == j.salt
    assert p.shapes.m_active() == j.shapes.m_active()
    assert p.residual_count == j.residual_count
    assert len(p) == len(j)
    assert p.num_filters_capacity == j.num_filters_capacity
    assert p.version == j.version
    assert p.shapes.epoch == j.shapes.epoch
    assert p.shapes.oplog == j.shapes.oplog


@pytest.mark.parametrize("seed,non_ascii", [(0, False), (1, False), (2, True)])
def test_cold_bulk_add_matches(seed, non_ascii):
    filters = seeded_filters(np.random.default_rng(seed), 600, non_ascii)
    p, j = P_ri.RouteIndex(), J_ri.RouteIndex()
    assert p.bulk_add(filters) == j.bulk_add(filters)
    assert j.residual_count > 0  # the deep filters
    assert_same_index(p, j)


@pytest.mark.parametrize("seed", [0, 3])
def test_warm_adds_and_removes_match(seed):
    rng = np.random.default_rng(seed)
    cold = seeded_filters(rng, 400)
    p, j = P_ri.RouteIndex(), J_ri.RouteIndex()
    assert p.bulk_add(cold) == j.bulk_add(cold)
    # single adds: fresh filters (hot segment) and refcount bumps
    for f in seeded_filters(rng, 60) + cold[:20]:
        assert p.add(f) == j.add(f)
    assert_same_index(p, j)
    # warm batch: a mix of live and fresh filters
    warm = seeded_filters(rng, 200) + [f"warm/{k}/+" for k in range(50)]
    assert p.bulk_add(warm) == j.bulk_add(warm)
    assert_same_index(p, j)
    # removes: packed tombstones, hot tombstones, residual removals, misses
    for f in cold[::3] + warm[::4] + ["never/added"]:
        assert p.remove(f) == j.remove(f)
    assert_same_index(p, j)
    for fid in range(j.num_filters_capacity):
        assert p.filter_name(fid) == j.filter_name(fid)


def test_shape_overflow_goes_residual():
    # 100 distinct shapes: the first 64 fit, the rest go to the NFA
    filters = [
        "/".join(["+"] * a + ["x"] + ["y"] * b) for a in range(10) for b in range(10)
    ]
    p, j = P_ri.RouteIndex(), J_ri.RouteIndex()
    assert p.bulk_add(filters) == j.bulk_add(filters)
    assert j.residual_count == 100 - 64
    assert_same_index(p, j)
    p2, j2 = P_ri.RouteIndex(), J_ri.RouteIndex()
    for f in filters:
        assert p2.add(f) == j2.add(f)
    assert_same_index(p2, j2)


def test_subscriber_table_matches():
    rng = np.random.default_rng(7)
    p = P_router.SubscriberTable(max_subscribers=256)
    j = J_router.SubscriberTable(max_subscribers=256)
    fids = rng.integers(0, 300, size=500)
    slots = rng.integers(0, 256, size=500)
    p.bulk_add(fids, slots)
    j.bulk_add(fids, slots)
    for f, s in zip(rng.integers(0, 2000, size=50), rng.integers(0, 600, size=50)):
        p.add(int(f), int(s))
        j.add(int(f), int(s))
    for f, s in zip(fids[::3], slots[::3]):
        p.remove(int(f), int(s))
        j.remove(int(f), int(s))
    for cap in (1000, 5000):
        a, b = p.pack(cap), j.pack(cap)
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
    assert (p.version, p.epoch, p.live, p.width_words) == (
        j.version, j.epoch, j.live, j.width_words)
    assert p.oplog == j.oplog


def test_subscriber_table_refuses_sparse_modes_across_shards():
    """The sparse and auto modes across more than one shard (the mesh's
    layout) are no longer refused: built sharded, or resharded live, they
    equal JAX's tables."""
    for mode in ("sparse", "auto"):
        tabs = []
        for R in (P_router, J_router):
            a = R.SubscriberTable(mode=mode, shards=2)
            b = R.SubscriberTable(mode=mode)
            for t in (a, b):
                t.add(3, 700)
                t.add(9, 5)
            b.set_shards(4)
            tabs.append((a, b))
        for p, j in zip(*tabs):
            assert (p.shards, p.sparse, p.version, p.epoch, p.oplog) == (
                j.shards, j.sparse, j.version, j.epoch, j.oplog)
            for k, v in j.device_snapshot().items():
                np.testing.assert_array_equal(p.device_snapshot()[k], v)


def test_subscriber_table_sparse_modes_match_jax():
    for mode in ("sparse", "auto"):
        p = P_router.SubscriberTable(mode=mode)
        j = J_router.SubscriberTable(mode=mode)
        for t in (p, j):
            t.add(3, 700)
            t.add(9, 5)
        assert (p.sparse, p.mode, p.version, p.epoch, p.oplog) == (
            j.sparse, j.mode, j.version, j.epoch, j.oplog)
        for k, v in j.device_snapshot().items():
            np.testing.assert_array_equal(p.device_snapshot()[k], v)


TOPICS = ["", "/", "a", "a/b", "/a//b/", "$SYS/x/y", "x/" * 40, "ünï/ok",
          "a/b/c/d/e/f/g/h/i/j", "device/3/mid/5/"]


def test_encode_and_tokenize_host_np_match():
    for mb in (8, 64):
        got = P_tok.encode_topics(TOPICS, mb)
        want = J_tok.encode_topics(TOPICS, mb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for salt, L in ((0, 4), (5, 16)):
            for g, w in zip(P_tok.tokenize_host_np(got[0], got[1], salt, L),
                            J_tok.tokenize_host_np(want[0], want[1], salt, L)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_word_hashes_and_topic_algebra_match():
    for w in ["", "a", "device", "ünï", "x" * 300]:
        for salt in (0, 1, 77):
            assert P_nfa.word_hash_pair(w, salt) == J_nfa.word_hash_pair(w, salt)
    pairs = [("a/b", "a/+"), ("$SYS/x", "#"), ("a", "a/#"), ("a/b/c", "+/+")]
    for name, flt in pairs:
        assert P_topics.match(name, flt) == J_topics.match(name, flt)
    assert P_topics.parse_share("$share/g/a/b") == J_topics.parse_share("$share/g/a/b")
    with pytest.raises(P_topics.TopicValidationError):
        P_topics.validate("a/#/b")


# -- guard rails: the port imports neither jax nor emqx_tpu ----------------


def port_modules():
    pkg = ROOT / "emqx_tpu_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )


def test_importing_the_port_loads_no_jax():
    assert {"emqx_tpu_torch.ops.csr_table", "emqx_tpu_torch.broker.shared_sub",
            "emqx_tpu_torch.parallel.mesh", "emqx_tpu_torch.parallel.launch",
            "emqx_tpu_torch.models.router_model",
            "emqx_tpu_torch.models.retained_index",
            "emqx_tpu_torch.ops.session_table",
            "emqx_tpu_torch.broker.session_store",
            "emqx_tpu_torch.ops.semantic_table",
            "emqx_tpu_torch.rules.sql",
            "emqx_tpu_torch.rules.compile",
            "emqx_tpu_torch.broker.broker", "emqx_tpu_torch.broker.router",
            "emqx_tpu_torch.broker.trie", "emqx_tpu_torch.broker.hooks",
            "emqx_tpu_torch.broker.message", "emqx_tpu_torch.broker.metrics",
            "emqx_tpu_torch.broker.ingest", "emqx_tpu_torch.broker.slo",
            "emqx_tpu_torch.broker.degrade", "emqx_tpu_torch.utils.tracepoints",
            "emqx_tpu_torch.mqtt.packet", "emqx_tpu_torch.mqtt.frame",
            "emqx_tpu_torch.mqtt.slab_serializer", "emqx_tpu_torch.broker.inflight",
            "emqx_tpu_torch.broker.mqueue", "emqx_tpu_torch.broker.session",
            "emqx_tpu_torch.broker.semantic", "emqx_tpu_torch.rules.engine",
            "emqx_tpu_torch.rules.runtime", "emqx_tpu_torch.rules.funcs",
            "emqx_tpu_torch.rules.events", "emqx_tpu_torch.utils.placeholder",
            "emqx_tpu_torch.utils.node", "emqx_tpu_torch.ops.segments",
            "emqx_tpu_torch.ops.shape_index", "emqx_tpu_torch.convert",
            "emqx_tpu_torch.observe.faults", "emqx_tpu_torch.broker.retained_feed",
            "emqx_tpu_torch.broker.retainer",
            # the app and everything it boots (the wire codec, channels,
            # transports, config, durable state, the entry point)
            "emqx_tpu_torch.app", "emqx_tpu_torch.__main__",
            "emqx_tpu_torch.mqtt.reason_codes", "emqx_tpu_torch.mqtt.client",
            "emqx_tpu_torch.broker.mountpoint", "emqx_tpu_torch.broker.channel",
            "emqx_tpu_torch.broker.cm", "emqx_tpu_torch.transport.connection",
            "emqx_tpu_torch.transport.listener", "emqx_tpu_torch.broker.limiter",
            "emqx_tpu_torch.broker.olp", "emqx_tpu_torch.transport.congestion",
            "emqx_tpu_torch.broker.banned", "emqx_tpu_torch.broker.delayed",
            "emqx_tpu_torch.broker.authz", "emqx_tpu_torch.config.schema",
            "emqx_tpu_torch.storage.kv", "emqx_tpu_torch.storage.codec",
            "emqx_tpu_torch.storage.wal",
            "emqx_tpu_torch.broker.persistent_session"} <= set(port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'emqx_tpu' or m.startswith('emqx_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


def test_no_jax_or_emqx_tpu_import_in_port_sources():
    files = sorted((ROOT / "emqx_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # the pipelined publish path's, the session half's, the semantic
    # plane's, the rule engine's, the compaction and snapshot modules, the
    # fault sites, the retained feed, the retainer and the app's modules
    # are scanned too
    assert {ROOT / "emqx_tpu_torch" / p for p in (
        "broker/ingest.py", "broker/slo.py", "broker/degrade.py",
        "utils/tracepoints.py", "broker/inflight.py", "broker/mqueue.py",
        "broker/session.py", "mqtt/frame.py", "mqtt/slab_serializer.py",
        "broker/semantic.py", "rules/engine.py", "rules/runtime.py", "rules/funcs.py",
        "rules/events.py", "utils/placeholder.py", "utils/node.py",
        "ops/segments.py", "ops/csr_table.py", "ops/semantic_table.py",
        "ops/session_table.py", "ops/shape_index.py", "convert.py", "broker/router.py",
        "broker/session_store.py", "models/router_model.py", "observe/faults.py",
        "broker/retained_feed.py", "broker/retainer.py",
        "app.py", "__main__.py", "mqtt/reason_codes.py", "mqtt/packet.py",
        "mqtt/client.py", "broker/mountpoint.py", "broker/channel.py", "broker/cm.py",
        "transport/connection.py", "transport/listener.py", "broker/limiter.py",
        "broker/olp.py", "transport/congestion.py", "broker/banned.py",
        "broker/delayed.py", "broker/authz.py", "config/schema.py", "storage/kv.py",
        "storage/codec.py", "storage/wal.py",
        "broker/persistent_session.py")} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                # ml_dtypes too: the port keeps bf16 as its own bits
                assert root not in ("jax", "jaxlib", "emqx_tpu", "ml_dtypes"), (path, name)
