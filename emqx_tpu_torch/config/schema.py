"""Config schema: one typed dataclass tree, one loader, env overrides.
The port's copy of `emqx_tpu/config/schema.py`, whole, so that one config
file and one environment load to equal values in both packages.

The reference's config plane is HOCON text checked against typerefl schemas
and stored in persistent_term with env overrides under `EMQX_`
(apps/emqx/src/emqx_config.erl:199-218, emqx_schema.erl,
bin/emqx:31 HOCON_ENV_OVERRIDE_PREFIX). Here the single source of truth is
this dataclass tree: it gives defaults, types, validation and JSON
round-trip.

Files are JSON (optionally with #-comments). Env overrides use
EMQX_TPU__SECTION__FIELD=value paths, e.g.
EMQX_TPU__MQTT__MAX_PACKET_SIZE=2097152.

The schema describes every section the reference's app carries; the
port's app (app.py) refuses, when it is built, every enabled section it
does not carry yet (`app.unsupported`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, get_args, get_origin

from emqx_tpu_torch.broker.session import SessionConfig
from emqx_tpu_torch.broker.channel import MqttCaps

ENV_PREFIX = "EMQX_TPU__"


@dataclass
class NodeConfig:
    name: str = ""
    cookie: str = "emqxtpusecret"


@dataclass
class ClusterSeed:
    node: str = ""  # peer node name, e.g. "n2@127.0.0.1"
    host: str = "127.0.0.1"
    port: int = 0  # the peer's cluster bus port


@dataclass
class ClusterConfig:
    """Config-driven clustering (ekka/mria autocluster analog): the app
    starts a TcpBus + ClusterNode around its broker, dials the seeds,
    and joins the first reachable one. Routes replicate and publishes
    forward over the bus (cluster/node.py)."""

    enable: bool = False
    bind: str = "127.0.0.1"
    listen_port: int = 0  # 0 = ephemeral (printed at boot)
    seeds: List[ClusterSeed] = field(default_factory=list)
    # cluster send robustness (tcp_transport.py): each send retries up
    # to send_retries times with bounded exponential backoff before the
    # dead-letter counter takes it; send_deadline_s bounds the WHOLE
    # attempt train (0 = timeout * (retries + 1))
    send_retries: int = 2
    send_backoff_ms: float = 50.0
    send_deadline_s: float = 0.0
    # scale-out sharded serving (docs/scale_out.md): this node's slice
    # of the global subscriber-lane space, [index, total]. With
    # router.mesh_shape set, the node advertises the slice on join
    # (ShardOwnership) and publishes reroute to the rendezvous
    # successor when an owner dies. [0, 1] = the whole space (default).
    shard_slice: List[int] = field(default_factory=lambda: [0, 1])


@dataclass
class ListenerSpec:
    name: str = "default"
    type: str = "tcp"  # tcp | ssl | ws | wss
    bind: str = "0.0.0.0"
    port: int = 1883
    max_connections: int = 1_024_000
    ssl_certfile: Optional[str] = None
    ssl_keyfile: Optional[str] = None
    ssl_cacertfile: Optional[str] = None
    ssl_verify: bool = False
    # topic namespace prefix for clients of this listener; supports
    # ${clientid}/${username} placeholders (emqx_mountpoint.erl parity)
    mountpoint: Optional[str] = None
    # >0: serve this (tcp-only) listener from N connection-worker
    # PROCESSES on a shared SO_REUSEPORT socket, speaking the batched
    # fabric protocol to the router process (transport/workers.py) —
    # the host-data-plane analog of the reference's process-per-
    # connection parallelism (emqx_connection.erl:173-176)
    workers: int = 0


@dataclass
class RouterConfig:
    enable_tpu: bool = True
    min_tpu_batch: int = 64
    max_levels: int = 16
    frontier: int = 32
    max_matches: int = 64
    max_bytes: int = 256
    # sparse fan-out compaction (docs/observability.md "readback
    # budget"): read back O(matches) compact slot lists per batch
    # instead of dense [B, W] subscriber bitmaps; rows whose fan-out
    # exceeds the cap fall back to a masked dense transfer
    fanout_compact: bool = True
    # per-row compact-slot cap Kslot: 0 = auto-size from the
    # dispatch.fanout histogram p99 (grow-only, pow2); > 0 pins it
    fanout_slots: int = 0
    # subscriber-table representation (docs/serving_pipeline.md
    # "subscriber-table memory budget"): dense = the [Fcap, W] bitmap
    # matrix (O(filters x slots) memory; the degrade fallback),
    # sparse = CSR slot lists (O(total subscriptions) — what makes 1M
    # distinct single-subscriber topics possible), auto = start dense,
    # flip once when occupancy x width says the matrix is mostly zeros
    sub_table: str = "auto"
    # sparse-mode gather-window bound per routed row (0 = 2 x Kslot);
    # rows past it rebuild their fan-out on host like Kslot overflow
    sparse_gather: int = 0
    # ingest-side adaptive batch window (broker/ingest.py): collect
    # concurrent publishes into one device route_step
    ingest_enable: bool = True
    ingest_window_us: int = 1000
    ingest_max_batch: int = 4096
    # device dispatches in flight at once (batch N+1's upload/launch
    # overlaps batch N's readback); settlement stays FIFO for ordering
    ingest_pipeline: int = 2
    # donate per-batch input buffers (token bytes/lengths) to the
    # serving jit: steady-state batches reuse them for outputs instead
    # of allocating fresh device buffers every launch
    donate_buffers: bool = True
    # bound on cached compiled programs per serving jit entry (table
    # growth compiles fresh programs; a long-lived process must not
    # accumulate every shape it ever served). 0 = unbounded.
    jit_cache_max: int = 64
    # SPMD serving over a device mesh: [dp, tp] axis sizes. [0, 0] (the
    # default) = single-device serving; set e.g. [4, 2] on an 8-chip
    # host to run dist_shape_route_step on the live dispatch path.
    mesh_shape: List[int] = field(default_factory=lambda: [0, 0])
    # segmented update path (docs/update_path.md): background compaction
    # merges the shape-index hot segment into the packed table once it
    # holds this many live entries (housekeeping-driven, built + pre-
    # uploaded on the segment-compact executor)
    compact_hot_entries: int = 1024
    # minimum seconds between background compaction cycles per table
    compact_interval_s: float = 5.0
    # also compact when this fraction of the packed table is tombstoned
    # (mass unsubscribe reclaim)
    compact_tombstone_frac: float = 0.25


@dataclass
class SemanticConfig:
    """Semantic routing plane (docs/semantic_routing.md): embedding-
    filter subscriptions answered by a similarity matmul fused into the
    serving launch, plus device-compiled rule WHERE predicates. The
    whole plane is one opt-in; `rule_predicates` can switch the rule
    half off independently."""

    enable: bool = False
    # embedding dimensionality; every filter and message embedding
    # must match it exactly
    dim: int = 64
    # per-message semantic fan-out bound: route to the topk most
    # similar qualifying subscribers (per 'tp' shard on a mesh)
    topk: int = 16
    # default cosine-similarity threshold for filters that don't pin
    # their own via the semantic-threshold user property
    threshold: float = 0.75
    # device storage dtype for the embedding matrix: float32, or
    # bfloat16 to halve HBM + double MXU throughput (quantized at
    # upload; host keeps f32)
    dtype: str = "float32"
    # compile eligible rule-engine WHERE clauses to in-launch masks
    # (rules/compile.py); off = rules stay on the host hook path
    rule_predicates: bool = True


@dataclass
class RetainerConfig:
    enable: bool = True
    max_retained_messages: int = 1_000_000
    max_payload_size: int = 1024 * 1024
    msg_clear_interval: float = 60.0
    # device replay index for wildcard storms over big stores; engages at
    # device_threshold topics when the TPU path is enabled
    device_threshold: int = 10_000
    # batch wildcard-subscribe replays through the serving pipeline:
    # pending storms fuse into the next publish launch
    # (fused_route_retained_step) or flush standalone after storm_window
    storm_ride: bool = True
    storm_window_us: int = 2000


@dataclass
class DelayedConfig:
    enable: bool = True
    max_delayed_messages: int = 0  # 0 = unlimited


@dataclass
class RewriteRuleSpec:
    action: str = "all"
    source_topic: str = ""
    re: str = ""
    dest_topic: str = ""


@dataclass
class AuthUser:
    user_id: str = ""
    password: str = ""
    is_superuser: bool = False


@dataclass
class AuthnConfig:
    enable: bool = False
    allow_anonymous: bool = True
    user_id_type: str = "username"
    password_hash: str = "pbkdf2"
    users: List[AuthUser] = field(default_factory=list)
    jwt_secret: str = ""
    jwt_verify_claims: Dict[str, str] = field(default_factory=dict)
    # HTTP authn provider (emqx_authn_http analog)
    http_url: str = ""
    http_method: str = "POST"
    http_timeout: float = 5.0
    # JWKS RS256 provider (emqx_authn_jwt jwks mode)
    jwks_endpoint: str = ""
    jwks_refresh_interval: float = 300.0
    jwks_verify_claims: Dict[str, str] = field(default_factory=dict)
    # SCRAM-SHA-256 enhanced auth (emqx enhanced_authn scram)
    scram_enable: bool = False
    scram_iterations: int = 4096
    scram_users: List[AuthUser] = field(default_factory=list)


@dataclass
class PskConfig:
    """TLS-PSK identity store (emqx_psk analog); wired into ssl/wss
    listeners when the interpreter's ssl module supports PSK."""

    enable: bool = False
    identities: Dict[str, str] = field(default_factory=dict)  # id -> hex
    file: str = ""  # identity:hexsecret lines


@dataclass
class AclRuleSpec:
    permit: str = "allow"
    who: str = "all"  # all | clientid:<x> | username:<x> | ipaddr:<prefix>
    action: str = "all"
    topics: List[str] = field(default_factory=list)


@dataclass
class AuthzConfig:
    no_match: str = "allow"
    deny_action: str = "ignore"  # 'ignore' | 'disconnect' (reference knob)
    rules: List[AclRuleSpec] = field(default_factory=list)
    # file source: JSON-lines ACL rules (emqx_authz_file analog)
    acl_file: str = ""
    # HTTP source (emqx_authz_http analog)
    http_url: str = ""
    http_method: str = "POST"
    http_timeout: float = 5.0


@dataclass
class FlappingConfig:
    enable: bool = True
    max_count: int = 15
    window_time: float = 60.0
    ban_time: float = 300.0


@dataclass
class SharedSubConfig:
    strategy: str = "round_robin"


@dataclass
class SysConfig:
    sys_msg_interval: float = 60.0  # $SYS heartbeat
    sys_heartbeat_interval: float = 30.0


@dataclass
class DashboardConfig:
    enable: bool = True
    bind: str = "127.0.0.1"
    port: int = 18083
    api_key: str = ""  # empty => no auth (dev mode)
    # admin users for JWT login (emqx_dashboard_admin analog); password
    # accepted in plain here, hashed at app assembly
    admins: Dict[str, str] = field(default_factory=dict)  # user -> password
    jwt_ttl: float = 3600.0
    # live monitor sampling (emqx_dashboard_monitor analog)
    monitor_interval: float = 5.0
    monitor_history: int = 360  # samples kept for monitor_current charts


@dataclass
class ExhookServerSpec:
    name: str = ""
    url: str = ""  # e.g. 127.0.0.1:9000
    timeout: float = 0.5
    failed_action: str = "deny"  # deny | ignore


@dataclass
class DurabilityConfig:
    """Persistent sessions + durable broker state (retained/delayed/banned).
    Reference: emqx_persistent_session backends + mnesia disc tables."""

    enable: bool = False
    data_dir: str = "data"
    flush_interval: float = 5.0
    fsync: bool = False
    # checkpoint the device-table host state (route index + hot
    # segments + subscriber bitmaps) as a sidecar pickle so a rolling
    # upgrade restores million-entry tables instead of replaying every
    # subscribe (ops/segments.SegmentStateSnapshot)
    segment_snapshot: bool = False


@dataclass
class OlpConfig:
    enable: bool = False
    lag_watermark_ms: float = 500.0
    cooldown: float = 5.0


@dataclass
class SloConfig:
    """SLO-driven adaptive batching (broker/slo.py): the ingest window
    as a controlled variable holding a p99 target, priority lanes, and
    the graded backpressure ladder (widen -> defer -> shed) replacing
    the binary shed cliff. docs/robustness.md "SLO controller"."""

    enable: bool = True
    target_p99_ms: float = 5.0
    # window bounds the controller adapts inside; the initial value is
    # router.ingest_window_us (continuity with the fixed-window era)
    min_window_us: int = 0
    max_window_us: int = 20000
    eval_interval_ms: float = 50.0  # one look per flush-cycle stretch
    min_samples: int = 32  # settles needed to judge a tail
    gain: float = 0.25  # multiplicative widen/narrow step
    hysteresis: float = 0.7  # hold inside [hysteresis*target, target]
    ladder_patience: int = 3  # consecutive readings to move a rung
    defer_max_ms: float = 250.0  # low-lane defer age bound (starvation)
    starvation_ms: float = 50.0  # lane-fairness reserve trigger
    shed_hard_mult: float = 4.0  # absolute backlog valve (x shed bound)
    qos0_low_lane: bool = True  # QoS0 publishes ride the low lane
    # sustained-miss alarm (observe/alarm.py SloViolationWatch)
    alarm_enable: bool = True
    alarm_threshold: float = 0.5  # violating fraction of eval windows
    alarm_window: float = 10.0
    alarm_min_windows: int = 4


# Every injectable fault site (observe/faults.py). These literals MUST
# stay in lockstep with faults.SITES — the FT checker in tools/analysis
# statically cross-checks the two, so a site added to the injector
# without config awareness fails the lint, not a midnight soak.
FAULT_SITES = frozenset({
    "ingest.enqueue",
    "device.launch",
    "device.readback",
    "router.delta_sync",
    "retained.storm",
    "cluster.forward",
    "exhook.call",
})

FAULT_MODES = ("raise", "delay", "drop", "corrupt")


@dataclass
class FaultRuleSpec:
    """One armed fault behavior (observe/faults.py FaultRule). Default
    off at the root (`faults.enable`); rules also arm at runtime via
    GET/POST /api/v5/faults for soak testing."""

    site: str = ""
    mode: str = "raise"  # raise | delay | drop | corrupt
    probability: float = 1.0
    nth: int = 0  # fire on every nth eligible call (0 = every)
    max_fires: int = 0  # stop after this many fires (0 = unlimited, 1 = one-shot)
    delay_ms: float = 0.0


@dataclass
class FaultsConfig:
    enable: bool = False
    rules: List[FaultRuleSpec] = field(default_factory=list)


@dataclass
class DegradeConfig:
    """Graceful-degradation ladder knobs (broker/degrade.py): bounded
    retry/backoff before a batch degrades, breaker trip threshold, open
    dwell before the half-open probe, and the ingest shed bound."""

    enable: bool = True
    max_retries: int = 2
    backoff_base_ms: float = 20.0
    backoff_max_ms: float = 2000.0
    failure_threshold: int = 1  # exhausted-retry batches to trip open
    open_secs: float = 5.0  # open dwell before a half-open probe
    probe_successes: int = 1  # probes needed to close from half-open
    # ingest sheds enqueues past shed_queue_batches * ingest_max_batch
    # pending messages while overloaded or the device breaker is open
    shed_queue_batches: int = 8


@dataclass
class ForceGcConfig:
    enable: bool = True
    count: int = 16000
    bytes: int = 16 * 1024 * 1024


@dataclass
class SlowSubsConfig:
    enable: bool = True
    threshold_ms: float = 500.0
    top_k_num: int = 10
    expire_interval: float = 300.0


@dataclass
class StatsdConfig:
    enable: bool = False
    server_host: str = "127.0.0.1"
    server_port: int = 8125
    flush_interval: float = 30.0


@dataclass
class EventMessageConfig:
    client_connected: bool = True
    client_disconnected: bool = True
    session_subscribed: bool = True
    session_unsubscribed: bool = True
    message_delivered: bool = False
    message_acked: bool = False
    message_dropped: bool = False


@dataclass
class TelemetryConfig:
    """Opt-in anonymized usage reporting (emqx_telemetry analog)."""

    enable: bool = False
    url: str = ""
    interval: float = 604800.0  # weekly


@dataclass
class PluginsConfig:
    """Runtime-installable plugins (emqx_plugins analog)."""

    install_dir: str = "plugins"
    start: List[str] = field(default_factory=list)  # name-version refs


@dataclass
class ObserveConfig:
    slow_subs: SlowSubsConfig = field(default_factory=SlowSubsConfig)
    statsd: StatsdConfig = field(default_factory=StatsdConfig)
    event_message: EventMessageConfig = field(
        default_factory=EventMessageConfig
    )
    trace_dir: str = "trace"
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    alarm_size_limit: int = 1000
    alarm_validity_period: float = 24 * 3600.0
    os_mon_enable: bool = True
    vm_mon_enable: bool = True
    sys_mon_enable: bool = True
    # hot-path flight recorder: alarm when the TPU route path's
    # fallback-row rate (device-flagged rows routed by the CPU trie)
    # exceeds the threshold over a sliding window — sustained fallback
    # means the fast path has degraded to per-message CPU matching
    # (observe/alarm.py FallbackRateWatch)
    tpu_fallback_alarm_enable: bool = True
    tpu_fallback_alarm_threshold: float = 0.2
    tpu_fallback_alarm_window: float = 10.0
    tpu_fallback_alarm_min_rows: int = 64
    # causal span tracing (observe/spans.py): head-based sampling at the
    # publish entry; one flow samples deterministically (seeded hash of
    # client+topic), so repeated runs trace the same clients. Clients
    # matched by an active TraceSpec always sample at 100%.
    trace_spans_enable: bool = True
    trace_sample_rate: float = 0.01  # base fraction of publish flows
    # per-client / per-topic-filter rate overrides (most specific wins)
    trace_sample_clients: Dict[str, float] = field(default_factory=dict)
    trace_sample_topics: Dict[str, float] = field(default_factory=dict)
    trace_sample_seed: int = 0
    trace_span_ring: int = 2048  # recent spans kept for /trace/spans
    trace_span_file: str = ""  # OTLP-shaped JSON lines sink ("" = off)
    # on-demand device profiling (observe/profiler.py): REST-armed
    # jax.profiler trace captures, bounded by wall clock AND by on-disk
    # bytes — an armed capture can never fill the data disk
    profile_trace_dir: str = "profile_traces"
    profile_max_seconds: float = 30.0
    profile_max_bytes: int = 64 << 20
    # device runtime telemetry (observe/device_watch.py): alarm when the
    # jit compile rate stays nonzero after warmup (retrace storm)
    retrace_alarm_enable: bool = True
    retrace_alarm_threshold: int = 1  # compiles per window that count
    retrace_alarm_window: float = 10.0
    retrace_alarm_warmup: float = 60.0  # boot compiles never alarm
    retrace_alarm_sustain: int = 2  # consecutive hot windows to trip


@dataclass
class AutoSubscribeSpec:
    topic: str = ""
    qos: int = 0


@dataclass
class RuleOutputSpec:
    function: str = "console"  # console | republish | bridge
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class BridgeSpec:
    """One data bridge (emqx_bridge config analog). id = `type:name`
    (http:alarm, mqtt:site_a); connector options in `opts` (url/method/
    body for http; host/port/remote_topic/ingress_filter for mqtt;
    local_topic binds an automatic egress)."""

    id: str = ""
    enable: bool = True
    opts: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RuleSpec:
    id: str = ""
    sql: str = ""
    enable: bool = True
    description: str = ""
    outputs: List[RuleOutputSpec] = field(default_factory=list)


@dataclass
class LicenseConfig:
    """Enterprise license (lib-ee/emqx_license analog). `key` is the
    signed license string; `pubkey_n`/`pubkey_e` override the verifier
    key (hex n). Empty key => community/unlimited."""

    key: str = ""
    pubkey_n: str = ""
    pubkey_e: int = 65537


@dataclass
class LogConfig:
    """Structured logging (``log`` config root; emqx_logger_jsonfmt /
    textfmt analog). formatter switches at runtime via /configs/log."""

    level: str = "info"  # debug|info|warning|error
    formatter: str = "text"  # text | json
    to_file: str = ""  # empty = stderr


@dataclass
class GatewaySpec:
    """One protocol gateway instance (emqx_gateway config analog).
    type: stomp | mqttsn | exproto | coap | lwm2m; options go in `opts`
    (bind/port/mountpoint/predefined/handler/notify_type/lifetime...)."""

    type: str = "stomp"
    name: Optional[str] = None  # defaults to type
    enable: bool = True
    opts: Dict[str, Any] = field(default_factory=dict)


# Every key a gateway may read from `GatewaySpec.opts` (the free-form
# dict above). The gateways read these with `self.config.get("key")`;
# tools/analysis (CK002) statically rejects reads of undeclared keys, so
# a typo'd opt surfaces at lint time instead of silently hitting the
# default. Add new keys HERE when a gateway grows a knob.
GATEWAY_OPT_KEYS = frozenset({
    # shared listener plumbing
    "bind", "port", "mountpoint", "transport", "psk",
    # mqtt-sn
    "predefined", "gateway_id",
    # lwm2m
    "qos", "lifetime", "lifetime_min", "lifetime_max",
    # stomp
    "heartbeat_ms",
    # coap
    "heartbeat", "notify_type", "max_block_size", "retainer",
    # exproto
    "node", "adapter_bind",
})


@dataclass
class AppConfig:
    node: NodeConfig = field(default_factory=NodeConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    listeners: List[ListenerSpec] = field(default_factory=lambda: [ListenerSpec()])
    mqtt: MqttCaps = field(default_factory=MqttCaps)
    session: SessionConfig = field(default_factory=SessionConfig)
    router: RouterConfig = field(default_factory=RouterConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    retainer: RetainerConfig = field(default_factory=RetainerConfig)
    delayed: DelayedConfig = field(default_factory=DelayedConfig)
    rewrite: List[RewriteRuleSpec] = field(default_factory=list)
    authn: AuthnConfig = field(default_factory=AuthnConfig)
    authz: AuthzConfig = field(default_factory=AuthzConfig)
    flapping: FlappingConfig = field(default_factory=FlappingConfig)
    shared_subscription: SharedSubConfig = field(default_factory=SharedSubConfig)
    sys: SysConfig = field(default_factory=SysConfig)
    observe: ObserveConfig = field(default_factory=ObserveConfig)
    # {type: {rate, burst, client: {rate, burst}}}; types: bytes_in,
    # message_in, connection, message_routing (emqx_limiter schema analog)
    limiter: Dict[str, Any] = field(default_factory=dict)
    olp: OlpConfig = field(default_factory=OlpConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    faults: FaultsConfig = field(default_factory=FaultsConfig)
    degrade: DegradeConfig = field(default_factory=DegradeConfig)
    force_gc: ForceGcConfig = field(default_factory=ForceGcConfig)
    durability: DurabilityConfig = field(default_factory=DurabilityConfig)
    exhook: List[ExhookServerSpec] = field(default_factory=list)
    dashboard: DashboardConfig = field(default_factory=DashboardConfig)
    auto_subscribe: List[AutoSubscribeSpec] = field(default_factory=list)
    rules: List[RuleSpec] = field(default_factory=list)
    gateways: List[GatewaySpec] = field(default_factory=list)
    bridges: List[BridgeSpec] = field(default_factory=list)
    psk: PskConfig = field(default_factory=PskConfig)
    plugins: PluginsConfig = field(default_factory=PluginsConfig)
    license: LicenseConfig = field(default_factory=LicenseConfig)
    log: LogConfig = field(default_factory=LogConfig)


class ConfigError(ValueError):
    pass


def _coerce(tp, value, path):
    origin = get_origin(tp)
    if is_dataclass(tp):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected object, got {value!r}")
        return _from_dict(tp, value, path)
    if origin is list:
        (item_t,) = get_args(tp)
        if not isinstance(value, list):
            raise ConfigError(f"{path}: expected list")
        return [_coerce(item_t, v, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin is dict:
        return dict(value)
    if tp is Optional[str] or tp == Optional[str]:
        return None if value is None else str(value)
    if origin is not None:  # other Optionals / unions: pass through
        return value
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if tp is int:
        try:
            return int(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{path}: expected integer, got {value!r}")
    if tp is float:
        try:
            return float(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{path}: expected number, got {value!r}")
    if tp is str:
        return str(value)
    return value


def _from_dict(cls, data: Dict, path: str = ""):
    import typing

    known = {f.name for f in fields(cls)}
    for k in data:
        if k not in known:
            raise ConfigError(f"{path or cls.__name__}: unknown key {k!r}")
    # field types are strings under `from __future__ import annotations`
    hints = typing.get_type_hints(cls)
    kwargs = {
        name: _coerce(hints[name], data[name], f"{path}.{name}")
        for name in known
        if name in data
    }
    return cls(**kwargs)


def to_dict(cfg) -> Dict:
    return dataclasses.asdict(cfg)


_COMMENT_RE = re.compile(r"^\s*#.*$", re.M)


def load_config(data: Dict) -> AppConfig:
    cfg = _from_dict(AppConfig, data)
    _apply_env_overrides(cfg)
    _validate(cfg)
    return cfg


def load_file(path: Optional[str]) -> AppConfig:
    if path is None:
        return load_config({})
    with open(path) as f:
        text = _COMMENT_RE.sub("", f.read())
    return load_config(json.loads(text) if text.strip() else {})


def _apply_env_overrides(cfg: AppConfig) -> None:
    """EMQX_TPU__MQTT__MAX_QOS_ALLOWED=1 style deep overrides."""
    import typing

    for key, raw in os.environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        parts = [p.lower() for p in key[len(ENV_PREFIX) :].split("__")]
        obj = cfg
        ok = True
        for p in parts[:-1]:
            if not hasattr(obj, p):
                ok = False
                break
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not ok or not hasattr(obj, leaf):
            raise ConfigError(f"unknown config env override: {key}")
        hints = typing.get_type_hints(type(obj))
        setattr(obj, leaf, _coerce(hints[leaf], raw, key))


def _validate(cfg: AppConfig) -> None:
    if not cfg.listeners:
        raise ConfigError("at least one listener is required")
    seen = set()
    for l in cfg.listeners:
        key = (l.type, l.name)
        if key in seen:
            raise ConfigError(f"duplicate listener {key}")
        seen.add(key)
        if l.type not in ("tcp", "ssl", "ws", "wss"):
            raise ConfigError(f"unsupported listener type {l.type!r}")
        if l.type in ("ssl", "wss") and not (l.ssl_certfile and l.ssl_keyfile):
            raise ConfigError(f"{l.type} listener requires certfile and keyfile")
    if cfg.shared_subscription.strategy not in (
        "random", "round_robin", "sticky", "hash_clientid", "hash_topic",
    ):
        raise ConfigError(
            f"unknown shared sub strategy {cfg.shared_subscription.strategy!r}"
        )
    if cfg.authz.no_match not in ("allow", "deny"):
        raise ConfigError("authz.no_match must be allow|deny")
    if cfg.log.formatter not in ("text", "json"):
        raise ConfigError("log.formatter must be text|json")
    if cfg.log.level.upper() not in ("DEBUG", "INFO", "WARNING", "ERROR"):
        raise ConfigError("log.level must be debug|info|warning|error")
    ms = cfg.router.mesh_shape
    if len(ms) != 2 or any(not isinstance(x, int) or x < 0 for x in ms):
        raise ConfigError("router.mesh_shape must be [dp, tp] with ints >= 0")
    dp, tp = ms
    if (dp == 0) != (tp == 0):
        raise ConfigError(
            "router.mesh_shape: dp and tp must both be 0 (off) or both >= 1"
        )
    if tp and (tp & (tp - 1)):
        raise ConfigError(
            "router.mesh_shape: tp must be a power of two (subscriber "
            "bitmap lanes are power-of-two words)"
        )
    if cfg.router.fanout_slots < 0:
        raise ConfigError(
            "router.fanout_slots must be >= 0 (0 = auto-size)"
        )
    if cfg.router.sub_table not in ("auto", "dense", "sparse"):
        raise ConfigError(
            "router.sub_table must be one of auto|dense|sparse"
        )
    if cfg.router.sub_table == "sparse" and not cfg.router.fanout_compact:
        raise ConfigError(
            "router.sub_table=sparse requires router.fanout_compact "
            "(the CSR table serves through the compact readback)"
        )
    if cfg.router.sparse_gather < 0:
        raise ConfigError(
            "router.sparse_gather must be >= 0 (0 = 2 x Kslot)"
        )
    if cfg.router.jit_cache_max < 0:
        raise ConfigError(
            "router.jit_cache_max must be >= 0 (0 = unbounded)"
        )
    if cfg.router.compact_hot_entries < 1:
        raise ConfigError("router.compact_hot_entries must be >= 1")
    if cfg.router.compact_interval_s < 0:
        raise ConfigError("router.compact_interval_s must be >= 0")
    if not (0.0 < cfg.router.compact_tombstone_frac <= 1.0):
        raise ConfigError(
            "router.compact_tombstone_frac must be in (0, 1]"
        )
    if cfg.retainer.storm_window_us < 0:
        raise ConfigError("retainer.storm_window_us must be >= 0")
    if not 1 <= cfg.semantic.dim <= 4096:
        raise ConfigError("semantic.dim must be in 1..4096")
    if not 1 <= cfg.semantic.topk <= 1024:
        raise ConfigError("semantic.topk must be in 1..1024")
    if not -1.0 <= cfg.semantic.threshold <= 1.0:
        raise ConfigError(
            "semantic.threshold must be in [-1, 1] (cosine similarity)"
        )
    if cfg.semantic.dtype not in ("float32", "bfloat16"):
        raise ConfigError("semantic.dtype must be float32|bfloat16")
    if cfg.semantic.enable and not cfg.router.fanout_compact:
        raise ConfigError(
            "semantic.enable requires router.fanout_compact (semantic "
            "winners union into the compact slot readback)"
        )
    if cfg.session.store_capacity < 64:
        raise ConfigError("session.store_capacity must be >= 64")
    if cfg.session.store_sweep_slots < 16:
        raise ConfigError("session.store_sweep_slots must be >= 16")
    if cfg.session.store_sweep_interval <= 0:
        raise ConfigError("session.store_sweep_interval must be > 0")
    for i, fr in enumerate(cfg.faults.rules):
        if fr.site not in FAULT_SITES:
            raise ConfigError(
                f"faults.rules[{i}].site {fr.site!r} is not a registered "
                f"fault site (one of {sorted(FAULT_SITES)})"
            )
        if fr.mode not in FAULT_MODES:
            raise ConfigError(
                f"faults.rules[{i}].mode {fr.mode!r} must be one of "
                f"{FAULT_MODES}"
            )
        if not 0.0 <= fr.probability <= 1.0:
            raise ConfigError(
                f"faults.rules[{i}].probability must be in [0, 1]"
            )
    if cfg.degrade.max_retries < 0:
        raise ConfigError("degrade.max_retries must be >= 0")
    if cfg.degrade.failure_threshold < 1:
        raise ConfigError("degrade.failure_threshold must be >= 1")
    if cfg.degrade.open_secs < 0:
        raise ConfigError("degrade.open_secs must be >= 0")
    if cfg.degrade.shed_queue_batches < 1:
        raise ConfigError("degrade.shed_queue_batches must be >= 1")
    if cfg.slo.target_p99_ms <= 0:
        raise ConfigError("slo.target_p99_ms must be > 0")
    if cfg.slo.min_window_us < 0:
        raise ConfigError("slo.min_window_us must be >= 0")
    if cfg.slo.max_window_us < cfg.slo.min_window_us:
        raise ConfigError(
            "slo.max_window_us must be >= slo.min_window_us"
        )
    if not 0.0 < cfg.slo.gain < 1.0:
        raise ConfigError("slo.gain must be in (0, 1)")
    if not 0.0 <= cfg.slo.hysteresis <= 1.0:
        raise ConfigError("slo.hysteresis must be in [0, 1]")
    if cfg.slo.ladder_patience < 1:
        raise ConfigError("slo.ladder_patience must be >= 1")
    if cfg.slo.shed_hard_mult < 1.0:
        raise ConfigError("slo.shed_hard_mult must be >= 1.0")
    if cfg.slo.eval_interval_ms <= 0:
        raise ConfigError("slo.eval_interval_ms must be > 0")
    if not 0.0 < cfg.slo.alarm_threshold <= 1.0:
        raise ConfigError("slo.alarm_threshold must be in (0, 1]")
    if cfg.cluster.send_retries < 0:
        raise ConfigError("cluster.send_retries must be >= 0")
    ss = cfg.cluster.shard_slice
    if (
        len(ss) != 2
        or not all(isinstance(v, int) for v in ss)
        or ss[1] < 1
        or not 0 <= ss[0] < ss[1]
    ):
        raise ConfigError(
            "cluster.shard_slice must be [index, total] with "
            "0 <= index < total"
        )
    from emqx_tpu_torch.broker.limiter import TYPES as _LIMITER_TYPES

    for lt in cfg.limiter:
        if lt not in _LIMITER_TYPES:
            raise ConfigError(
                f"unknown limiter type {lt!r} (one of {_LIMITER_TYPES})"
            )
    if cfg.authz.deny_action not in ("ignore", "disconnect"):
        raise ConfigError("authz.deny_action must be ignore|disconnect")
    if not 0.0 < cfg.observe.tpu_fallback_alarm_threshold <= 1.0:
        raise ConfigError(
            "observe.tpu_fallback_alarm_threshold must be in (0, 1]"
        )
    for name, rate in [
        ("observe.trace_sample_rate", cfg.observe.trace_sample_rate),
        *(
            (f"observe.trace_sample_clients[{k!r}]", v)
            for k, v in cfg.observe.trace_sample_clients.items()
        ),
        *(
            (f"observe.trace_sample_topics[{k!r}]", v)
            for k, v in cfg.observe.trace_sample_topics.items()
        ),
    ]:
        if not 0.0 <= float(rate) <= 1.0:
            raise ConfigError(f"{name} must be in [0, 1]")
    if cfg.observe.retrace_alarm_threshold < 1:
        raise ConfigError("observe.retrace_alarm_threshold must be >= 1")
    if not 0 <= cfg.mqtt.max_qos_allowed <= 2:
        raise ConfigError("mqtt.max_qos_allowed must be 0..2")
    for r in cfg.rules:
        if not r.id or not r.sql:
            raise ConfigError("each rule needs an id and sql")
        from emqx_tpu_torch.rules.sql import SqlParseError, parse_sql

        try:
            parse_sql(r.sql)
        except SqlParseError as e:
            raise ConfigError(f"rule {r.id}: bad sql: {e}") from e
        for o in r.outputs:
            if o.function not in ("console", "republish"):
                raise ConfigError(
                    f"rule {r.id}: unknown output {o.function!r}"
                )
