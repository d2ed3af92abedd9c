"""The port's app (`emqx_tpu_torch.app.BrokerApp`, `__main__`, the config
schema, channels, listeners) against the reference's on the CPU.

Both apps boot in one event loop on port 0, the reference with
`JAX_PLATFORMS=cpu`, the port with ``device="cpu"`` (each kernel's plain
twin) and the device route on (`min_tpu_batch` 1, so every batch goes
through the device router). The same client script (the port's
`mqtt.client`, which records every packet it receives) runs against each
app, and the received packets, in order, must be equal, apart from the
server-assigned client ids, which are compared by shape. The scenarios
are `tests/test_broker_e2e.py`'s; where a batch window could regroup a
scenario's publishes (and so its round-robin picks), the script publishes
at QoS 1 and waits for each ack. Config loading, the refusals, the
housekeeping tick, the warmup and the entry point follow.
"""

import asyncio
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

import emqx_tpu.app as J_app
import emqx_tpu.config.schema as J_schema
import emqx_tpu_torch.app as P_app
import emqx_tpu_torch.config.schema as P_schema
from emqx_tpu_torch.mqtt import frame as P_frame
from emqx_tpu_torch.mqtt import packet as pkt
from emqx_tpu_torch.mqtt.client import Client

ROOT = Path(__file__).resolve().parents[1]

# every section the port's app refuses, switched off, so the reference's
# app and the port's run the same configuration
OFF = {
    "dashboard": {"enable": False},
    "observe": {
        "sys_mon_enable": False, "os_mon_enable": False, "vm_mon_enable": False,
        "slow_subs": {"enable": False}, "tpu_fallback_alarm_enable": False,
        "retrace_alarm_enable": False, "trace_spans_enable": False,
        "event_message": {f.name: False for f in dataclasses.fields(
            P_schema.EventMessageConfig)},
    },
    "slo": {"alarm_enable": False},
}


def merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def app_config(**over):
    return merge(merge(OFF, {
        "listeners": [{"bind": "127.0.0.1", "port": 0}],
        "router": {"min_tpu_batch": 1},
        "session": {"retry_interval": 0.5},
    }), over)


def make_app(which, cfg):
    if which == "ref":
        return J_app.BrokerApp(J_schema.load_config(cfg))
    return P_app.BrokerApp(P_schema.load_config(cfg), device="cpu")


ASSIGNED = re.compile(r"emqx_tpu_[0-9a-f]{16}")


def norm(p):
    """A received packet -> (type name, fields), a server-assigned client
    id replaced by its shape."""
    d = dataclasses.asdict(p)
    props = d.get("properties") or {}
    if "Assigned-Client-Identifier" in props:
        cid = props["Assigned-Client-Identifier"]
        props["Assigned-Client-Identifier"] = (
            "<assigned>" if ASSIGNED.fullmatch(cid) else cid)
    return type(p).__name__, d


class Rec(Client):
    """The port's client, logging every packet it receives in order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def _handle(self, p):
        self.log.append(norm(p))
        super()._handle(p)


class Bed:
    """One app on an ephemeral port and the clients of one scenario."""

    def __init__(self, app):
        self.app = app
        self.clients = {}

    @property
    def port(self):
        return next(iter(self.app.listeners.list().values())).port

    async def client(self, name, cls=Rec, **kw):
        c = cls(client_id=name, **kw)
        await c.connect("127.0.0.1", self.port)
        self.clients.setdefault(name, []).append(c)
        return c

    def transcript(self):
        return {name: [c.log for c in cs] for name, cs in self.clients.items()}


async def run_scenario(which, scenario, cfg):
    app = make_app(which, cfg)
    await app.start()
    bed = Bed(app)
    try:
        extra = await asyncio.wait_for(scenario(bed), 30)
    finally:
        for cs in bed.clients.values():
            for c in cs:
                await c.close()
        await app.stop()
    return bed.transcript(), extra


def both(scenario, cfg=None):
    cfg = cfg or app_config()

    async def go():
        return (await run_scenario("ref", scenario, cfg),
                await run_scenario("port", scenario, cfg))

    return asyncio.run(go())


# -- the scenarios of tests/test_broker_e2e.py ---------------------------------
async def connect_ping(bed):
    c = await bed.client("c1")
    await c.ping()
    await c.disconnect()


async def qos0_pubsub(bed):
    sub = await bed.client("sub1")
    await sub.subscribe("t/0")
    publ = await bed.client("pub1")
    await publ.publish("t/0", b"hello")
    await sub.recv()
    await sub.disconnect()
    await publ.disconnect()


async def qos1_pubsub(bed):
    sub = await bed.client("s1")
    await sub.subscribe("t/1", qos=1)
    publ = await bed.client("p1", version=pkt.MQTT_V5)
    for i in range(3):
        await publ.publish("t/1", b"m%d" % i, qos=1)
        await sub.recv()
    await publ.publish("t/none", b"x", qos=1)  # no subscribers: rc 0x10 on v5
    await sub.disconnect()
    await publ.disconnect()


async def qos2_handshake(bed):
    sub = await bed.client("s2", version=pkt.MQTT_V5)
    await sub.subscribe("t/2", qos=2)
    publ = await bed.client("p2")
    await publ.publish("t/2", b"m2", qos=2)
    await sub.recv()
    await asyncio.sleep(0.1)  # the subscriber's PUBREC -> PUBREL -> PUBCOMP
    await sub.disconnect()
    await publ.disconnect()


async def qos_downgrade(bed):
    sub = await bed.client("sd")
    await sub.subscribe("t/down", qos=0)
    publ = await bed.client("pd")
    await publ.publish("t/down", b"x", qos=2)
    await sub.recv()
    await sub.disconnect()
    await publ.disconnect()


async def wildcard_unsubscribe(bed):
    sub = await bed.client("w1")
    await sub.subscribe([("a/+/c", pkt.SubOpts(qos=0)), ("a/#", pkt.SubOpts(qos=0))])
    publ = await bed.client("w2")
    await publ.publish("a/b/c", b"1", qos=1)
    for _ in range(2):
        await sub.recv()
    await sub.unsubscribe("a/#")
    await sub.unsubscribe("never/subscribed")
    await publ.publish("a/b/c", b"2", qos=1)
    await sub.recv()
    await sub.disconnect()
    await publ.disconnect()


async def no_local_v5(bed):
    c = await bed.client("nl", version=pkt.MQTT_V5)
    await c.subscribe([("self/t", pkt.SubOpts(qos=0, no_local=True))])
    await c.publish("self/t", b"own", qos=1)
    other = await bed.client("nl2", version=pkt.MQTT_V5)
    await other.publish("self/t", b"theirs", qos=1)
    await c.recv()
    await c.disconnect()
    await other.disconnect()


async def will_on_abnormal_close(bed):
    watcher = await bed.client("watcher")
    await watcher.subscribe("will/t")
    dying = await bed.client("dying", will=pkt.Will(topic="will/t", payload=b"gone"))
    dying._writer.close()
    await watcher.recv()
    await watcher.disconnect()


async def no_will_on_normal_disconnect(bed):
    watcher = await bed.client("watcher2")
    await watcher.subscribe("will/t2")
    polite = await bed.client("polite", will=pkt.Will(topic="will/t2", payload=b"bye"))
    await polite.disconnect()
    await watcher.publish("will/t2", b"marker", qos=1)
    await watcher.recv()
    await asyncio.sleep(0.1)
    await watcher.disconnect()


async def takeover_offline_queue(bed):
    c1 = await bed.client("take1", clean_start=False)
    await c1.subscribe("q/t", qos=1)
    c1._writer.close()
    await c1.closed.wait()
    await asyncio.sleep(0.05)
    publ = await bed.client("qpub")
    for i in range(3):
        await publ.publish("q/t", b"m%d" % i, qos=1)
    c2 = await bed.client("take1", clean_start=False)
    for _ in range(3):
        await c2.recv()
    await c2.disconnect()
    await publ.disconnect()


async def clean_start_discards(bed):
    c1 = await bed.client("cs1", clean_start=False)
    await c1.subscribe("cs/t", qos=1)
    c1._writer.close()
    await c1.closed.wait()
    await asyncio.sleep(0.05)
    c2 = await bed.client("cs1", clean_start=True)
    publ = await bed.client("cspub")
    await publ.publish("cs/t", b"x", qos=1)
    await asyncio.sleep(0.1)
    await c2.disconnect()
    await publ.disconnect()


async def takeover_kicks_live(bed):
    c1 = await bed.client("dup", version=pkt.MQTT_V5, clean_start=False)
    await c1.subscribe("dup/t", qos=1)
    c2 = await bed.client("dup", version=pkt.MQTT_V5, clean_start=False)
    await c1.closed.wait()
    publ = await bed.client("duppub")
    await publ.publish("dup/t", b"after", qos=1)
    await c2.recv()
    await c2.disconnect()
    await publ.disconnect()


async def shared_round_robin(bed):
    a = await bed.client("sha")
    b = await bed.client("shb")
    await a.subscribe("$share/g1/sh/t", qos=0)
    await b.subscribe("$share/g1/sh/t", qos=0)
    publ = await bed.client("shpub")
    for i in range(6):
        await publ.publish("sh/t", b"%d" % i, qos=1)
    await asyncio.sleep(0.2)
    await a.disconnect()
    await b.disconnect()
    await publ.disconnect()


async def wildcard_publish_is_protocol_error(bed):
    c = await bed.client("badpub")
    c._writer.write(P_frame.serialize(pkt.Publish(topic="a/+", payload=b"x"), c.version))
    await c.closed.wait()


async def connect_must_be_first(bed):
    reader, writer = await asyncio.open_connection("127.0.0.1", bed.port)
    writer.write(P_frame.serialize(pkt.PingReq(), 4))
    data = await reader.read(100)
    writer.close()
    return {"read": data}


async def second_connect_is_protocol_error(bed):
    c = await bed.client("twice", version=pkt.MQTT_V5)
    c._send(pkt.Connect(proto_ver=pkt.MQTT_V5, client_id="twice"))
    await c.closed.wait()


async def v5_assigned_client_id(bed):
    c = await bed.client("", version=pkt.MQTT_V5)
    await c.disconnect()


async def keepalive_timeout_closes(bed):
    c = await bed.client("ka", keepalive=1)
    await asyncio.wait_for(c.closed.wait(), timeout=5)


async def qos1_retry_on_missing_ack(bed):
    class NoAck(Rec):
        def _handle(self, p):
            if p.type == pkt.PUBLISH and p.qos == 1:
                self.log.append(norm(p))
                return  # no PUBACK
            super()._handle(p)

    sub = await bed.client("retry1", cls=NoAck)
    await sub.subscribe("r/t", qos=1)
    publ = await bed.client("retry2")
    await publ.publish("r/t", b"again", qos=1)
    for _ in range(40):
        if sum(1 for t, _ in sub.log if t == "Publish") >= 2:
            break
        await asyncio.sleep(0.1)
    publishes = [d for t, d in sub.log if t == "Publish"][:2]
    sub.log[:] = [(t, d) for t, d in sub.log if t != "Publish"]
    await sub.close()
    await publ.disconnect()
    return {"first_two": publishes}


async def retained_replay(bed):
    publ = await bed.client("rpub", version=pkt.MQTT_V5)
    for i in range(4):
        await publ.publish(f"ret/{i}", b"r%d" % i, qos=1, retain=True)
    sub = await bed.client("rsub", version=pkt.MQTT_V5)
    await sub.subscribe("ret/+", qos=1)
    got = sorted([(await sub.recv()).topic for _ in range(4)])
    sub.log.sort(key=lambda e: (e[0], e[1].get("topic", "")))
    await sub.disconnect()
    await publ.disconnect()
    return {"topics": got}


SCENARIOS = {f.__name__: f for f in (
    connect_ping, qos0_pubsub, qos1_pubsub, qos2_handshake, qos_downgrade,
    wildcard_unsubscribe, no_local_v5, will_on_abnormal_close,
    no_will_on_normal_disconnect, takeover_offline_queue, clean_start_discards,
    takeover_kicks_live, shared_round_robin, wildcard_publish_is_protocol_error,
    connect_must_be_first, second_connect_is_protocol_error, v5_assigned_client_id,
    keepalive_timeout_closes, qos1_retry_on_missing_ack, retained_replay)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_session_flows_receive_equal_packets(name):
    ref, port = both(SCENARIOS[name])
    assert port == ref
    transcript, _ = port
    assert any(transcript.values()) or name == "connect_must_be_first"


# the flows that touch the QoS 1/2 windows, with the device session store
STORE_SCENARIOS = ("qos1_pubsub", "qos2_handshake", "takeover_offline_queue",
                   "takeover_kicks_live", "shared_round_robin")


@pytest.mark.parametrize("name", STORE_SCENARIOS)
def test_session_flows_equal_with_the_device_session_store(name):
    cfg = app_config(session={"retry_interval": 0.5, "device_store": True})
    ref, port = both(SCENARIOS[name], cfg)
    assert port == ref


def test_shared_round_robin_alternates_members():
    _, (transcript, _) = both(shared_round_robin)
    got = {name: [d["payload"] for t, d in logs[0] if t == "Publish"]
           for name, logs in transcript.items() if name in ("sha", "shb")}
    assert sorted(got["sha"] + got["shb"]) == [b"%d" % i for i in range(6)]
    assert len(got["sha"]) == len(got["shb"]) == 3


def test_device_route_serves_the_flows():
    """Every batch of the flows goes through the device router (plain
    twins on the CPU): nothing falls back."""
    async def go():
        app = make_app("port", app_config())
        await app.start()
        bed = Bed(app)
        await qos1_pubsub(bed)
        m = app.broker.metrics
        routed = m.get("messages.routed.device")
        for cs in bed.clients.values():
            for c in cs:
                await c.close()
        await app.stop()
        return routed, m.get("degrade.fallback.batches"), m.get("messages.routed.device_fallback")

    routed, fallback, flagged = asyncio.run(go())
    assert routed >= 4 and not fallback and not flagged


# -- config ----------------------------------------------------------------------
CONFIG_TEXT = """
# a comment line, as the reference's loader allows
{
  "node": {"name": "n1@host"},
  "listeners": [{"name": "a", "bind": "127.0.0.1", "port": 0, "mountpoint": "m/"},
                {"name": "b", "type": "tcp", "port": 1884}],
  "mqtt": {"max_qos_allowed": 1, "max_packet_size": 4096},
  "session": {"max_inflight": 8, "device_store": true, "store_capacity": 128},
  "router": {"min_tpu_batch": 8, "sub_table": "sparse", "ingest_max_batch": 512},
  "retainer": {"storm_ride": true, "max_retained_messages": 100},
  "authz": {"no_match": "deny", "rules": [{"permit": "allow", "who": "clientid:c1",
            "action": "publish", "topics": ["a/#"]}]},
  "limiter": {"message_routing": {"rate": 10, "burst": 10}},
  "faults": {"rules": [{"site": "device.readback", "mode": "raise", "nth": 3}]},
  "rules": [{"id": "r1", "sql": "SELECT * FROM \\"t/#\\"",
             "outputs": [{"function": "republish", "args": {"topic": "out"}}]}],
  "durability": {"enable": true, "data_dir": "/tmp/x", "segment_snapshot": true}
}
"""

ENV = {"EMQX_TPU__MQTT__MAX_CLIENTID_LEN": "64",
       "EMQX_TPU__ROUTER__INGEST_WINDOW_US": "250",
       "EMQX_TPU__SESSION__RETRY_INTERVAL": "2.5",
       "EMQX_TPU__RETAINER__ENABLE": "false",
       "EMQX_TPU__DASHBOARD__ENABLE": "0"}


def test_config_file_and_environment_load_equal(tmp_path, monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(CONFIG_TEXT)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    want = dataclasses.asdict(J_schema.load_file(str(path)))
    got = dataclasses.asdict(P_schema.load_file(str(path)))
    assert got == want
    assert got["router"]["ingest_window_us"] == 250 and got["retainer"]["enable"] is False
    assert dataclasses.asdict(P_schema.load_file(None)) == dataclasses.asdict(
        J_schema.load_file(None))


BAD_CONFIGS = {
    "no_listener": {"listeners": []},
    "dup_listener": {"listeners": [{"name": "x"}, {"name": "x"}]},
    "listener_type": {"listeners": [{"type": "quic"}]},
    "ssl_without_cert": {"listeners": [{"type": "ssl"}]},
    "shared_strategy": {"shared_subscription": {"strategy": "lottery"}},
    "authz_no_match": {"authz": {"no_match": "maybe"}},
    "log_formatter": {"log": {"formatter": "xml"}},
    "log_level": {"log": {"level": "loud"}},
    "mesh_len": {"router": {"mesh_shape": [1]}},
    "mesh_half": {"router": {"mesh_shape": [0, 2]}},
    "mesh_tp_pow2": {"router": {"mesh_shape": [1, 3]}},
    "fanout_slots": {"router": {"fanout_slots": -1}},
    "sub_table": {"router": {"sub_table": "tree"}},
    "sparse_needs_compact": {"router": {"sub_table": "sparse", "fanout_compact": False}},
    "sparse_gather": {"router": {"sparse_gather": -1}},
    "jit_cache_max": {"router": {"jit_cache_max": -1}},
    "compact_hot": {"router": {"compact_hot_entries": 0}},
    "compact_interval": {"router": {"compact_interval_s": -1}},
    "compact_tomb": {"router": {"compact_tombstone_frac": 0}},
    "storm_window": {"retainer": {"storm_window_us": -1}},
    "sem_dim": {"semantic": {"dim": 0}},
    "sem_topk": {"semantic": {"topk": 2000}},
    "sem_threshold": {"semantic": {"threshold": 2}},
    "sem_dtype": {"semantic": {"dtype": "f16"}},
    "sem_needs_compact": {"semantic": {"enable": True}, "router": {"fanout_compact": False}},
    "store_capacity": {"session": {"store_capacity": 8}},
    "store_sweep_slots": {"session": {"store_sweep_slots": 4}},
    "store_sweep_interval": {"session": {"store_sweep_interval": 0}},
    "fault_site": {"faults": {"rules": [{"site": "nowhere"}]}},
    "fault_mode": {"faults": {"rules": [{"site": "device.readback", "mode": "x"}]}},
    "fault_probability": {"faults": {"rules": [{"site": "device.readback",
                                                "probability": 2}]}},
    "degrade_retries": {"degrade": {"max_retries": -1}},
    "degrade_threshold": {"degrade": {"failure_threshold": 0}},
    "degrade_open": {"degrade": {"open_secs": -1}},
    "degrade_shed": {"degrade": {"shed_queue_batches": 0}},
    "slo_target": {"slo": {"target_p99_ms": 0}},
    "slo_min_window": {"slo": {"min_window_us": -1}},
    "slo_window_order": {"slo": {"min_window_us": 10, "max_window_us": 5}},
    "slo_gain": {"slo": {"gain": 1}},
    "slo_hysteresis": {"slo": {"hysteresis": 2}},
    "slo_patience": {"slo": {"ladder_patience": 0}},
    "slo_shed_mult": {"slo": {"shed_hard_mult": 0.5}},
    "slo_eval": {"slo": {"eval_interval_ms": 0}},
    "slo_alarm": {"slo": {"alarm_threshold": 0}},
    "cluster_retries": {"cluster": {"send_retries": -1}},
    "shard_slice": {"cluster": {"shard_slice": [2, 2]}},
    "limiter_type": {"limiter": {"bytes_out": {"rate": 1}}},
    "deny_action": {"authz": {"deny_action": "shout"}},
    "fallback_threshold": {"observe": {"tpu_fallback_alarm_threshold": 0}},
    "trace_rate": {"observe": {"trace_sample_rate": 2}},
    "trace_client_rate": {"observe": {"trace_sample_clients": {"c": -1}}},
    "retrace_threshold": {"observe": {"retrace_alarm_threshold": 0}},
    "max_qos": {"mqtt": {"max_qos_allowed": 3}},
    "rule_needs_sql": {"rules": [{"id": "r"}]},
    "rule_bad_sql": {"rules": [{"id": "r", "sql": "SELEKT"}]},
    "rule_output": {"rules": [{"id": "r", "sql": "SELECT * FROM \"t\"",
                               "outputs": [{"function": "bridge"}]}]},
    "unknown_key": {"router": {"warp_drive": True}},
    "bad_int": {"mqtt": {"max_packet_size": "big"}},
    "bad_float": {"session": {"retry_interval": "soon"}},
    "bad_object": {"router": 3},
    "bad_list": {"listeners": {"name": "x"}},
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_errors_raise_in_both(case):
    with pytest.raises(J_schema.ConfigError) as want:
        J_schema.load_config(BAD_CONFIGS[case])
    with pytest.raises(P_schema.ConfigError) as got:
        P_schema.load_config(BAD_CONFIGS[case])
    assert str(got.value) == str(want.value)


def test_unknown_environment_override_raises_in_both(monkeypatch):
    monkeypatch.setenv("EMQX_TPU__ROUTER__WARP", "1")
    for schema in (J_schema, P_schema):
        with pytest.raises(schema.ConfigError, match="unknown config env override"):
            schema.load_config({})


# -- refusals --------------------------------------------------------------------
REFUSED = {
    "router.mesh_shape": {"router": {"mesh_shape": [2, 1]}},
    "dashboard.enable": {"dashboard": {"enable": True}},
    "cluster.enable": {"cluster": {"enable": True}},
    "gateways": {"gateways": [{"type": "stomp"}]},
    "bridges": {"bridges": [{"id": "http:x"}]},
    "exhook": {"exhook": [{"name": "e", "url": "http://127.0.0.1:1"}]},
    "plugins.start": {"plugins": {"start": ["p-1.0"]}},
    "authn.enable": {"authn": {"enable": True}},
    "authn.scram_enable": {"authn": {"scram_enable": True}},
    "psk.enable": {"psk": {"enable": True}},
    "authz.http_url": {"authz": {"http_url": "http://127.0.0.1:1"}},
    "authz.acl_file": {"authz": {"acl_file": "acl.conf"}},
    "license.key": {"license": {"key": "k"}},
    "rewrite": {"rewrite": [{"action": "all", "source_topic": "a", "re": "a",
                             "dest_topic": "b"}]},
    "auto_subscribe": {"auto_subscribe": [{"topic": "a"}]},
    "listeners[0].workers": {"listeners": [{"port": 0, "workers": 2}]},
    "listeners[0].type=ws": {"listeners": [{"port": 0, "type": "ws"}]},
    "observe.telemetry.enable": {"observe": {"telemetry": {"enable": True}}},
    "observe.statsd.enable": {"observe": {"statsd": {"enable": True}}},
    "observe.trace_spans_enable": {"observe": {"trace_spans_enable": True}},
    "observe.sys_mon_enable": {"observe": {"sys_mon_enable": True}},
    "observe.os_mon_enable": {"observe": {"os_mon_enable": True}},
    "observe.vm_mon_enable": {"observe": {"vm_mon_enable": True}},
    "observe.slow_subs.enable": {"observe": {"slow_subs": {"enable": True}}},
    "observe.tpu_fallback_alarm_enable": {"observe": {"tpu_fallback_alarm_enable": True}},
    "observe.retrace_alarm_enable": {"observe": {"retrace_alarm_enable": True}},
    "slo.alarm_enable": {"slo": {"alarm_enable": True}},
    "log": {"log": {"level": "debug", "formatter": "json"}},
    **{f"observe.event_message.{f.name}": {"observe": {"event_message": {f.name: True}}}
       for f in dataclasses.fields(P_schema.EventMessageConfig)},
}


def refused_keys(err):
    return re.findall(r"([\w.\[\]=]+) \(ROADMAP item 10\.3[bcde]\)", str(err))


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_each_section_not_carried_is_refused_alone(key):
    cfg = P_schema.load_config(app_config(**REFUSED[key]))
    with pytest.raises(NotImplementedError) as e:
        P_app.BrokerApp(cfg, device="cpu")
    assert refused_keys(e.value) == [key]
    assert P_app.unsupported(cfg) == [s for s in P_app.unsupported(cfg) if key in s]


def test_every_refused_section_is_named_in_one_error():
    cfg = app_config()
    for over in REFUSED.values():
        cfg = merge(cfg, over)
    cfg["listeners"] = [{"port": 0, "workers": 2}, {"name": "w", "port": 0, "type": "ws"}]
    with pytest.raises(NotImplementedError) as e:
        P_app.BrokerApp(P_schema.load_config(cfg), device="cpu")
    keys = set(refused_keys(e.value))
    assert keys == (set(REFUSED) - {"listeners[0].type=ws"}) | {"listeners[1].type=ws"}


def test_default_config_is_refused_naming_the_dashboard_and_observability():
    with pytest.raises(NotImplementedError) as e:
        P_app.BrokerApp(P_schema.AppConfig(), device="cpu")
    keys = refused_keys(e.value)
    assert "dashboard.enable" in keys
    assert {"observe.trace_spans_enable", "observe.sys_mon_enable",
            "observe.slow_subs.enable", "slo.alarm_enable",
            "observe.event_message.client_connected"} <= set(keys)
    assert all(k == "dashboard.enable" or k.startswith(("observe.", "slo."))
               for k in keys)


def test_a_one_by_one_mesh_runs_as_one_device():
    app = P_app.BrokerApp(P_schema.load_config(app_config(router={"mesh_shape": [1, 1]})),
                          device="cpu")
    assert app.broker.mesh is None


def test_the_app_needs_cuda_unless_told_otherwise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = P_schema.load_config(app_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P_app.BrokerApp(cfg)
    cfg.router.enable_tpu = False
    app = P_app.BrokerApp(cfg)  # the CPU trie, as the caller asked
    assert app.device is None and app.segment_compactor is None


# -- the warmup ------------------------------------------------------------------
def test_a_kernel_build_error_escapes_the_warmup(monkeypatch):
    from emqx_tpu_torch.kernels.build import KernelBuildError
    from emqx_tpu_torch.models import router_model

    def broken(self):
        raise KernelBuildError("nvcc failed")

    monkeypatch.setattr(router_model.DeviceRouter, "prepare", broken)

    async def go():
        app = make_app("port", app_config())
        try:
            with pytest.raises(KernelBuildError):
                await app.start()
            assert not app.listeners.list()  # never served
        finally:
            await app.stop()

    asyncio.run(go())


def test_another_warmup_failure_is_logged_and_the_app_serves(monkeypatch, caplog):
    from emqx_tpu_torch.models import router_model

    calls = []
    real = router_model.DeviceRouter.route_prepared

    def flaky(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("warmup only")
        return real(self, *a, **kw)

    monkeypatch.setattr(router_model.DeviceRouter, "route_prepared", flaky)

    async def go():
        app = make_app("port", app_config())
        await app.start()
        bed = Bed(app)
        try:
            await qos1_pubsub(bed)
        finally:
            for cs in bed.clients.values():
                for c in cs:
                    await c.close()
            await app.stop()
        return bed.transcript()

    transcript = asyncio.run(go())
    assert "device route warmup failed" in caplog.text
    assert [t for t, _ in transcript["s1"][0]].count("Publish") == 3


def test_the_restored_heap_is_frozen_until_stop(tmp_path):
    """`start()` restores with the collector off and freezes the heap after
    the restore (the port's deviation: a full collection over a restored
    million-filter table would land on the first batches); `stop()` thaws
    it and the collector is on again."""
    import gc

    seen = []

    async def go():
        app = make_app("port", app_config(durability={
            "enable": True, "data_dir": str(tmp_path), "segment_snapshot": True}))
        real = app.durable_state.restore

        def restore():
            seen.append(gc.isenabled())
            return real()

        app.durable_state.restore = restore
        gc.unfreeze()
        await app.start()
        try:
            frozen = gc.get_freeze_count()
        finally:
            await app.stop()
        return frozen, gc.get_freeze_count(), gc.isenabled()

    frozen, after, collecting = asyncio.run(go())
    assert seen == [False]
    assert frozen > 0 and after == 0 and collecting


# -- the housekeeping tick -------------------------------------------------------
def test_one_housekeeping_tick_compacts_like_the_reference(monkeypatch):
    """One `_housekeeping` iteration (its sleep patched) with hot shape
    entries and CSR churn past the compaction thresholds: the compactor
    runs the same owners in both apps, and a batch after it adopts them."""
    cfg = app_config(router={"compact_hot_entries": 1, "compact_interval_s": 0,
                             "sub_table": "sparse"},
                     session={"retry_interval": 0.5, "device_store": True})
    real_sleep = asyncio.sleep

    async def go(which):
        app = make_app(which, cfg)
        await app.start()
        from emqx_tpu_torch.broker.message import Message as PM
        from emqx_tpu.broker.message import Message as JM

        Msg = JM if which == "ref" else PM
        subopts = pkt.SubOpts()
        for i in range(40):
            app.broker.subscribe(f"s{i}", f"c{i}", f"hk/{i}/+", subopts, lambda m, o: None)
        app.broker.unsubscribe("s3", "hk/3/+")
        await app.broker.apublish(Msg(topic="hk/1/x", payload=b"."))
        for t in app._tasks:
            t.cancel()
        ticks = []

        async def one_tick(delay, *a, **kw):
            if ticks:
                raise asyncio.CancelledError
            ticks.append(delay)

        monkeypatch.setattr(asyncio, "sleep", one_tick)
        try:
            with pytest.raises(asyncio.CancelledError):
                await app._housekeeping()
        finally:
            monkeypatch.setattr(asyncio, "sleep", real_sleep)
        for _ in range(200):  # the builds run on the compaction executor
            if not app.segment_compactor._busy:
                break
            await real_sleep(0.01)
        n = await app.broker.apublish(Msg(topic="hk/2/x", payload=b"."))
        m = app.broker.metrics
        out = {
            "ticks": ticks, "runs": app.segment_compactor.runs,
            "aborted": app.segment_compactor.aborted, "delivered": n,
            "gauges": {k: m.gauge(k) for k in (
                "router.segment.hot.fill", "router.segment.hot.capacity",
                "router.segment.tombstones", "router.sparse.fill",
                "router.sparse.tombstones", "router.sparse.hot.fill")},
            "hot_live": app.broker.router.index.shapes.hot_live,
        }
        await app.stop()
        return out

    async def both_apps():
        return await go("ref"), await go("port")

    ref, port = asyncio.run(both_apps())
    assert port == ref
    assert port["runs"] >= 1 and port["ticks"] == [1.0]


# -- the entry point -------------------------------------------------------------
def entry_config(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(app_config(router={"min_tpu_batch": 1})))
    return str(path)


def test_entry_point_serves_a_round_trip_and_exits_on_sigterm(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch", "--no-tpu", "-c", entry_config(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.fullmatch(r"emqx_tpu_torch listener tcp:default on 127\.0\.0\.1:(\d+)\n", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(m.group(1))

        async def round_trip():
            sub, pub = Rec("sub"), Rec("pub")
            await sub.connect("127.0.0.1", port)
            await sub.subscribe("e/t", qos=1)
            await pub.connect("127.0.0.1", port)
            ack = await pub.publish("e/t", b"hi", qos=1)
            got = await sub.recv()
            await sub.disconnect()
            await pub.disconnect()
            return ack, got

        ack, got = asyncio.run(round_trip())
        assert ack.type == pkt.PUBACK and (got.topic, got.payload, got.qos) == ("e/t", b"hi", 1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_entry_point_without_cuda_refuses_to_serve(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "emqx_tpu_torch", "-c", entry_config(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
    assert "listener" not in run.stdout
