#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (`emqx_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA card with CUDA and nvcc; exits non-zero, printing no
result, anywhere else. It drives the port only (no JAX, nothing of
emqx_tpu), in phases, each of which either passes or ends the run. Each
phase prints one JSON line.

The `mixed_1m` path (the shape-only step):
1. `toolchain`: card name and power limit, versions, kernel build;
2. `tables`: the `mixed_1m` configuration (BASELINE config 3: filters
   device/{i}/+/{j}/# for i, j < 1000 plus device/{i}/# for i < 100;
   SubscriberTable(max_subscribers=256), slot = filter index mod 256)
   built with the port's own RouteIndex.bulk_add and uploaded;
3. `kernel` x4: tokenize, shape_match, fanout_bitmaps and
   compact_fanout_slots against their plain PyTorch twins on the card at
   the path's shapes (B = 8192 Zipf topics, MAX_BYTES 64, max_levels 8,
   kslot 64), plus the ragged cases `fanout_bitmaps/ragged` (W = 7 on a
   base 4 bytes off) and `tokenize/ragged` (MB = 33 on a base 1 byte
   off): outputs must be EQUAL (all integers); every compact_fanout_slots
   case also prints `lanes_over_8`, the share of the kernel's lanes that
   place more than 8 bits (past 8 in a warp it deals positions round the
   lanes: mixed_10m's Zipf rows do, mixed_1m's and plus_100k's do not);
4. `route`: DeviceRouter.route over 3 batches plus edge topics, every
   row's recipient set held against a host oracle, then churn that pushes
   rows past kslot onto the dense-row path; launch counters are zeroed
   before and read after, and every kernel of the path must have launched;
5. `route_breakdown`: where one routed batch's time goes;
5b. `flip_1m`: the same table flipped to the CSR representation: the
   bitmaps mirror must swap to a fresh manager whose only work is one
   full upload, and the same batches must reach the same recipients
   through `sparse_fanout_slots`.

The `mixed_10m` path (the residual NFA lane and the O(delta) mirror), the
configuration `bench.py` builds in `_build_mixed_10m`, unchanged: 10M
filters in 66 wildcard shapes (2 dense overlays, 64 sparse families of
`+`/`#` masks over 8 levels), of which the last two families overflow the
64-shape table into the residual NFA; 2 subscribers per filter;
`frontier` 16, `max_matches` 16, `probes` 8:
6. `tables_10m`: vectorised build, m_active, residual_count, device bytes
   per mirror, and the cuts (`reduced`: none);
7. `route_10m` then `churn_10m`, with the launch counters zeroed before
   the first and read after the last: 3 Zipf batches plus edge topics and
   one batch built from residual filters, every unflagged row against the
   host oracle; then an NFA epoch bump (op-log cap) that must cost one
   full resync of that mirror alone, a subscribe wave and an unsubscribe
   wave that must reach the card as scatters (mirrors copied back and
   compared bit for bit with the host tables), routing checked after
   each; delta sync timed against a full upload;
8. `kernel` x7 at mixed_10m shapes (the scatter on the subscribe wave's
   own deltas), each against its twin, with its times and its bound;
9. `route_breakdown_10m`.

The `share_10m_csr` path (the sparse CSR subscriber table and $share
picks): BASELINE config 4 as bench.py builds it (`share_10m`: device/{i}/
+/{j}/# for i < 10,000 and j < 1,000, 8 subscribers each) over a 2^20-slot
client universe (subscription n -> slot n mod 2^20) in
`SubscriberTable(mode="sparse")`, plus device/{i}/# as the real filters of
11,000 groups ($share/ingest/device/{i}/# with 16 members for every i,
$share/audit/device/{i}/# with 4 for i < 1,000), round_robin:
10. `tables_share`: build seconds per stage, device bytes per mirror,
    m_active, residual_count (0), `reduced` (none);
11. `route_share` then `churn_share`, counters zeroed before the first
    and read after the last: 3 Zipf batches plus edge topics and one
    hash_clientid batch with seeded client hashes; every unflagged
    recipient set against the host oracle (the union of
    `CsrTable.slots_of` over the host-matched fids, counts by the
    kernel's rules) and every pick against a numpy round-robin oracle
    over the host `GroupTable`, the bases advanced after each batch as
    the broker does; then a hot subscribe wave (one scatter), an
    unsubscribe wave (packed tombstones), a storm past `HOT_SERVE_MAX`
    that the prepare folds into a full rebuild (rows past the gather
    window, built on the host) and group changes (`set_len`, an empty
    group, `drop_group`, a recycled gid), mirrors compared after each;
    `sparse_fanout_slots`, `share_pick` and `occurrence_index` must have
    launched and `fanout_bitmaps` / `compact_fanout_slots` not;
12. `kernel` for tokenize, shape_match, `sparse_fanout_slots`,
    `occurrence_index` and `share_pick` under each of the five strategies
    at this path's shapes, each against its twin;
13. `route_breakdown_share`;
14. `composite_bounds`: the serving composite's bound per batch (the sum
    of its kernels' bounds) on the mixed_10m and share_10m_csr paths;
The `retained_5m` path (the retained replay storm): BASELINE config 5 as
bench.py builds it (`bench_retained`): 5,000,000 topics site/{i % 2048}/
dev/{i % 100003}/ch/{i} in DeviceRetainedIndex(max_bytes=64,
max_levels=8), 5 chunks of 2^20 rows x 32 bytes on the card; the storm
site/+/dev/{d}/ch/# for d < 8,192 (filter d matches 50 rows):
15. `tables_retained`: build seconds per stage, chunks, bucket, bytes on
    the card, `reduced` (none);
16. `storm_retained`, `churn_retained` and `fused_retained`, counters
    zeroed before the first and read after the last: `match_many` of the
    storm, every filter's rows equal to the numpy oracle (409,600 pairs),
    timed by stage; a second storm of 68 shapes (the 64 `+`-masks of one
    stored topic and four `#` shapes) that runs the residual lane, against
    its oracle from the ids; churn (1,000 adds with three `$` topics and
    1,000 removes as one byte scatter; a 300,000-topic bulk load that
    re-uploads chunks 4 and 5 alone; a topic past the 32-byte bucket that
    costs exactly one full resync), after each step the chunk mirrors
    compared bit for bit with the host chunks and the storm (plus `#`)
    against the oracle; then the storm fused into one B = 8192 batch of
    the mixed_1m router: the route half equal to the unfused route, the
    storm equal to `match_many`, one device->host copy (profiler), and
    its times beside the unfused route and the standalone storm;
17. `kernel` for row_lengths and narrow_i16, tokenize and shape_match at
    the chunk's shape (2^20 rows; shape_match also at the wide storm's 64
    table shapes, `shape_match/wide_chunk`) and the byte scatter on the
    churn's own deltas, each against its twin (plain twins from
    RET_PLAIN_REPS samples);
18. `retained_seconds`: the path's time;
The `session_1m` path (the device session store): bench.py's
`session_storm` as `bench_session_storm` builds it: 1,000,000 sessions
c{i}, each one QoS1 publish-phase row (pid i mod 65535 + 1, one shared
message dev/offline) bulk-loaded into SessionStore(capacity 2^21,
sweep_slots 16,384, retry 1 s, a frozen clock; the bulk placement grows
the table to 2^22 rows) and captured. The capture is installed twice: into
a fresh store whose sweeps ride B = 64 batches of mixed_1m topics straight
through the mixed_1m router (the retained path's), and, as bench.py does,
into the store of a fresh `Broker(router=Router(min_tpu_batch=32))` with
one subscription on drive/#, whose sweeps ride the broker's own batches:
19. `tables_session`: build seconds per stage (the broker's among them),
    the table's capacity and bytes, `reduced` (none);
20. `flood_session`, `churn_session` and `fused_session`, counters zeroed
    before the first and read after the last: request_sweep -> take_rider
    -> route_prepared(..., session=rider) -> commit until every session is
    redelivered, each (slot, pid) exactly once, every rider's due list and
    count equal to the host oracle taken before its launch, the route half
    equal to the unfused route, no host sweep and no scatter of the
    manager's own, and the full uploads the op-log's length limit implies
    (`flood_plan`); churn: a resume of the drained store, then ride A
    (20,000 clears, 10,000 rel phases, 5,000 incoming QoS2 rows; first an
    aborted launch that must leave the mirror as it was) and ride B
    (expiry armed on 100,000 sessions, growing the slot lane to 2^20: one
    array resync, no full upload, no scatter; an expiry sweep past 16,384
    and a second due overflow), the mirror equal to the host lanes after
    every commit; then one rider-carrying call under the profiler (one
    device->host copy);
20b. `flood_broker_session` and `live_session_broker`, counters zeroed
    before the first and read after the last (`launches_session_broker`):
    the session store's broker half. The flood is bench.py's drive: the
    state installed into the broker's store, every slot bound to a
    `BatchSink` building the dup PUBLISH frames with `serialize_pub_slab`,
    the clock 60 s on, a warm `submit`, then `request_sweep()` and 64
    drive/{i} publishes through `BatchIngest(max_batch=256,
    window_us=200)` until all are redelivered (each sweep rides its batch
    through `adispatch_begin` and commits on the loop), and a flush
    batch; each (slot, pid) exactly once, no scatter of the store's own,
    one `session_sweep` launch a sweep ride and `segment_scatter`'s
    launches in each ride with writes, the full uploads `flood_plan`
    derives, one device->host copy a device batch, the mirror equal to the
    host lanes. The live phase: 65,536 `Session`s (max_inflight 32) over a
    broker with the store attached, each QoS1 on sess/{i}; 8 batches of
    8,192 publishes through `BatchIngest(max_batch=8192)` at pipeline 1,
    every window PUBACKed, then at pipeline 2, half PUBACKed, 2 no-match
    batches to carry the acks; then the clocks 60 s on, a sweep and 2
    batches: every publish delivered once, 32,768 rows live, the riders'
    rows equal to the op-log's, the mirror equal to the host lanes, and
    the 32,768 unacked (slot, pid) pairs redelivered exactly once, the set
    `Session.retry()` picks on storeless sessions fed the same drive. Both
    freeze the heap and print one full collection's time; both print
    rates, the p50 `take_rider` and `commit` ms and the launches a ride;
21. `kernel` for session_sweep at the flood's table (2^22 rows, 2^20
    slots) against its twin, with `torch.nonzero` of the precomputed masks
    as the nearest library call;
22. `session_seconds`: the path's time;
The `semantic_256k` path (the semantic routing plane and the compiled rule
masks): a SemanticTable(dim=384, topk=16) of 2^18 entries over the
mixed_1m router's index and subscriber table. D = 384 is the output width
of the public sentence-embedding model all-MiniLM-L6-v2; the vectors are
bench.py agentic_fabric's `_near` draws (c + 0.25 n, normalised) around
256 unit centroids, thresholds uniform in [0.90, 0.96] (through the
same-cluster band, about 0.94), half the entries unscoped and half scoped
to device/{d}/# or device/{d}/+/{j}/# (d < 100); entry slots 256 + i,
except 256 entries that are the centroids themselves on slots 0-255, the
topic slots, so the union's dedup fires. Each topic of a B = 8192 batch
carries an embedding near the centroid of its topic slot, and a seeded
JSON payload for the rule set `RULES_SQL` (eight WHERE clauses over
device/#, all 20 opcodes). The path runs twice, with an f32 table (the
main path) and a bf16 table (201 MB instead of 402 MB):
23. `tables_semantic`: build seconds, capacities, bytes on the card;
24. `kernel` for semantic_match (and, in the f32 pass, rule_masks): the
    fused call (scores, then merge + union) against the plain twin run in
    row chunks; integer outputs must be equal outside the tau band (tau =
    D x 2^-23): the rows that differ, and 64 sampled rows, are recomputed
    in f64 on the host and must pass `semantic_row_ok`; the band census is
    printed. rule_masks must equal its twin and the numpy host masks, and
    its programs must be uploaded 0, 0, 1, 0 times by a repeated call, a
    refresh over the same rules, a changed rule set and its repeat
    (`call_uploads`); its call finds them on the card, and
    `uncached_call_ms` times one that encodes and uploads them.
    semantic_match's times: the call (7 samples of 3), CUPTI device time and the TFLOP/s
    it makes, the twin (3 samples), torch.matmul with TF32 off alone and
    with torch.topk (5 samples each), and the bound (operations: 2 B E D
    flops at 67 TFLOP/s in f32, at 989 TFLOP/s for bf16); and the largest
    |score - f64 score| over every candidate the score launch keeps for
    the batch, as a multiple of tau (`candidate_err_tau`);
25. `route_semantic` and `churn_semantic`, counters zeroed before the
    first and read after the last: 3 batches through route(topics,
    embeds=, rules=): every topic half against the host oracle, the
    semantic half against the twin's winners after the union (a differing
    row must hold the kernel's own winners and pass the f64 band check),
    sem_count likewise, the rule masks equal to the twin and the numpy
    host masks; semantic_match must launch twice a call and rule_masks
    once; then churn: step A (100 adds, 50 replacements of packed entries,
    100 removes: one scatter of f32 or bf16 lanes plus 4 hot-array
    re-uploads), step B (900 adds and 900 removes, past the op-log cap: one
    full upload), the mirror compared bit for bit with the host table after
    each, and a checked batch;
26. `route_breakdown_semantic` (f32): encode, h2d, launches, readback and
    whole route;
27. `semantic_seconds`: the path's time; the scatter of churn step A
    (float32 and bfloat16 lanes) against its twin, with its times and its
    split (as every recorded scatter's: host prep, pinned fill, copy,
    clones, launches; `kernel_inputs_*`);
The `broker_1m` path (the broker's publish paths): BASELINE
config 3 loaded through `Broker.subscribe` into a port
`Broker(Router(MatcherConfig(max_bytes=64, max_levels=8),
min_tpu_batch=64), Hooks())`: one client a filter subscribing
device/{i}/+/{j}/# (i, j < 1000) and device/{i}/# (i < 100), 1,000,100
plain subscriptions, one slot each, then $share/ingest/device/{i}/# with
16 members for i < 100 (round_robin); stub deliverers record (message,
subscriber id):
28. `tables_broker`: the subscribe loop's seconds, the `auto` flip (the
    table must be CSR), kslot, bytes on the card, `reduced` (none);
29. `publish_broker`, `churn_broker`, `match_only_broker` and
    `breakdown_broker`, the launch counters zeroed before each batch and
    read after it: 3 batches of B = 8192 mixed_1m topics (seed 0) through
    `publish_batch`, every message's plain recipients equal to the
    subscribers of the router's exact and trie matches, every matched
    group's one delivery to the member `pick_oracle` names, the bases
    written back as `advance_rr` would, no row on the CPU; tokenize,
    shape_match and sparse_fanout_slots launched once a batch, share_pick
    twice and occurrence_index three times (one round-robin pick),
    nfa_walk, fanout_bitmaps and compact_fanout_slots not; churn (1,000
    plain unsubscribes on filters the next batch hits, 1,000 subscribes
    on fresh filters of the table's shape, one member leaving each of 10
    groups) synced with at most one scatter a mirror,
    a full upload only where an epoch moved, every mirror equal to its
    host table, and the next batch, checked the same way, showing each
    change; `Router.match_batch` (the match-only router: tokenize and
    shape_match) equal to `Router.match` per topic; 3 more batches for
    the breakdown (prepare, route(), host dispatch, the whole call,
    messages/s and deliveries/s), and one more traced for the device's
    busy share of a publish_batch;
30. `ingest_broker`, the pipelined publish path: 6 more batches' worth
    of seeded topics (49,152) through `publish_batch`, then the same
    publishes from concurrent `Broker.apublish` tasks through
    `BatchIngest(broker, max_batch=8192, pipeline=2)` and then
    `pipeline=1`, each from the same round-robin bases and with the
    launch counters zeroed before and read after: the `ingest.launch` /
    `ingest.settle` schedule of full batches (at depth 2 batch N + 1
    launches before batch N settles), 1 tokenize, shape_match and
    sparse_fanout_slots, 2 share_pick and 3 occurrence_index launches a
    batch; every message's plain recipients equal to the synchronous
    path's, each matched group delivering each message once, and at
    depth 1 every delivery, members included, the synchronous path's; a
    delta `prepare()` returning while a spin kernel still runs. One full
    garbage collection of the broker's heap is timed first, and the heap
    is frozen for the three runs (a full collection of it takes seconds
    and would land in whichever run crosses the threshold). Prints,
    with the card's name and power limit: batches, how many batches
    launched before the previous one's readback ended (CUDA events on
    the stream, and the host clock), the device's idle gaps
    (`ingest.device.idle.seconds`), messages/s and the p50/p99
    enqueue->settle latency at each depth;
31. `kernel` for tokenize, shape_match, sparse_fanout_slots,
    occurrence_index and share_pick (round_robin) at broker_1m's shapes,
    each against its twin (their `broker_1m` cases in the kernels line);
31a. the retained feed and the degrade ladder on the same broker, after
    `broker_launches`, the heap frozen, the injector's metrics on the
    broker's (`feed_ladder_broker`): `feed_broker`: retained_5m's storm
    over the retained path's churned store (about 5.3M topics in 6 chunks
    of 2^20 x 64 bytes, handed over by `retained_path`) submitted to a
    `RetainedStormFeed(window_s=30)` and answered by one B = 8192 batch
    through `adispatch_begin` at depth 1: every filter's topics equal to a
    standalone `match_many` of the storm, the deliveries equal to the same
    batch's without a storm (from the same round-robin bases),
    `retained.storm.fused` 1 and `flushed` 0, one storm launch train a
    chunk beside the route half; the fused batch's time beside the bare
    batch's and the standalone storm's. `flush_broker`: the same storm
    with no publish (window 10 ms): one standalone flush answers it, the
    topics equal, `flushed` 1. `retainer_broker`: a port `Retainer(
    enable_device=True, device_threshold=10,000)` holding 65,536 retained
    messages (`reduced` says why) on the broker's hooks with a feed on its
    device index: 256 `session.subscribed` calls with stub channels (255
    storm filters, one past max_levels that walks the trie), one batch:
    each channel's retained deliveries equal the host oracle over
    `Retainer.topics()`, each marked retained. These three (and every
    phase after the fault phases) count no degraded batch, no injected
    fault, no rollback, and every row they route on the device.
    `degrade_broker`: `DegradeController(max_retries=2, open_secs=1.5)`,
    `device.launch` raising: 2 full batches through `BatchIngest` at
    pipeline 1 with a 64-filter storm pending: 2 retries, 1 trip, 3
    injected faults, both batches from the CPU path (the second with no
    device attempt), plain deliveries equal the healthy run's and each
    matched group delivering each message once, the storm's waiters
    answered with the CPU-fallback signal and the storm on no retry; the
    fault disarmed and the dwell out, a probe batch launches the kernels,
    closes the breaker and delivers as the healthy batch did; then the
    synchronous gate (`device.readback` on `publish_batch`) the same way;
    each CPU-fallback batch's time beside the device batch's.
    `rollback_broker`: 16 fresh subscriptions, `router.delta_sync` armed
    `raise` then `corrupt`: the batch delivers as before the subscribes
    (`router.sync.rollback` 1), the next batch, disarmed, delivers to the
    fresh subscriptions; mirrors equal to the host tables after;
31b. the semantic plane and the rule engine on the same broker, which
    `broker_build` made with an empty `SemanticRouting(dim=384, topk=16,
    threshold=0.90)` and a `RuleEngine` whose device plane is attached
    (with the table empty and no rule, every phase above launches what it
    launched without them: `broker_launches`), the heap frozen:
    `tables_semantic_broker`: 65,536 of semantic_256k's filters (`reduced`
    says why) through `Broker.subscribe(sid, ..., embedding=v,
    sem_threshold=th)`, scoped `#` (half), device/{d}/# (3/8) or
    device/{d}/+/{j}/# (1/8) for d < 100, and the eight RULES_SQL clauses
    as rules over device/# with a recording `FunctionOutput` (all must
    compile); the subscribe seconds, `status()`, the first prepare's full
    semantic upload (one full resync, the mirror equal to the host table);
    `publish_semantic_broker`: 2 batches of B = 8192 mixed_1m publishes,
    each with an embedding in headers["semantic_embedding"] and a RULES_SQL
    payload, through `publish_batch`: plain and $share deliveries against
    the oracles, each message's semantic deliveries equal to its routed
    row's winners and those against the plain twin on the card (a
    differing row must pass the f64 band check), the fired rule rows equal
    to a host `apply_query` replay, each once, but for at most 4 rows a
    batch that a check independent of the rule compiler shows to be f32
    boundary cases (`rule_fired_check`, printed as `f32_dropped_rows`);
    one `rules.device.batches` a batch, no `rules.host.batches`, 2
    semantic_match and 1 rule_masks launches a batch; messages/s,
    deliveries/s and the stages (prepare, route(), rule firing, host
    fan-out); `ingest_semantic_broker`: the same
    publishes through `BatchIngest(max_batch=8192)` at pipeline 2 and 1,
    the deliveries and fired rows the synchronous pass's;
    `agentic_fabric_broker`: bench.py's `bench_agentic_fabric` at its own
    sizes on a broker of its own (D 32, topk 16, threshold 0.70, 1,024
    plain and 384 semantic subscriptions, 8,192 messages, max_batch 2,048,
    the rule WHERE payload.p = 1), fan_out and fan_in, the device pass
    against the host-filter pass with bench.py's check (plain deliveries
    equal, semantic within max(8, n // 200)), both passes' messages/s;
The `plus_100k` path (the NFA-only step, `route_step`): BASELINE config 2
as bench.py builds it (100,000 filters, 95,480 distinct, 10% single-'+',
8-level topics) in an `NfaBuilder`, one subscriber slot a distinct
filter, in a dense `SubscriberTable` (W = 4,096 words, 2.1 GB on the
card) and a CSR one; `MatcherConfig(max_bytes=64, max_levels=8)`:
32. `tables_plus`: build seconds per stage, bytes on the card, `reduced`
    (none);
33. `matcher_plus`, `route_step_plus` and `churn_plus`, the counters
    zeroed before the first and read after the last: `TpuMatcher.match_batch`
    on 3 batches of bench.py's topics equal to `TopicTrie.match` per
    topic, flagged rows counted by cause; `route_step` dense with kslot 0
    and 64 and CSR with kslot 64, every row's fids, bitmap row or slot
    list and the stats against the host oracle (the OR of the trie's
    filters' host rows); churn: 1,000 filters removed and 1,000 added
    through the NFA mirror and the dense table's mirror (a full upload
    exactly where an epoch moved; mirrors equal to the host tables), then
    a checked batch of their topics; tokenize, vocab_lookup, nfa_walk,
    fanout_bitmaps and compact_fanout_slots launched, shape_match not;
    the launches a batch (`launches_per_batch_plus`);
34. `kernel` for tokenize, vocab_lookup, nfa_walk, fanout_bitmaps and
    compact_fanout_slots at plus_100k's shapes, each against its twin
    (their `plus_100k` cases; vocab_lookup's, here and at mixed_10m, with
    `in_vocab_lanes`, `past_depth_share` and the table's slots, live words
    and tombstones), the composite's bound, and
    `route_breakdown_plus` (encode, h2d, launches, readback, route, and a
    `TpuMatcher` batch);
The mesh paths (`emqx_tpu_torch.parallel`): a 2 x 2 ('dp', 'tp') mesh of
four ranks, NCCL with one GPU a rank when the host shows four, else four
gloo ranks sharing cuda:0 (`reduced` says so: gloo stages the collectives
through the host, so NVLink is not measured). They run in a process of
their own (`python3 chip_smoke.py --mesh BACKEND GPUS`, started by this
one right after the build: a process that has used CUDA cannot fork ranks
that use it), which builds every path's host tables once while this
process runs the paths above, then, asked to, forks the ranks
(`parallel.launch`); rank 0 prints the phases, every rank its counters.
`python3 chip_smoke.py --mesh nccl 4 --now` runs the mesh paths alone on
a four-GPU host (no kernels line, no last line):
35. `mesh_share_2x2`: share_10m_csr as `share_path` builds it, the CSR
    table in two slot-owner shards over 'tp', B = 8192 over 'dp' (4,096
    rows a rank): 3 round-robin batches and one hash_clientid batch, every
    recipient set against a per-shard host oracle (`MeshOracle`) and every
    pick against `pick_oracle` over the whole batch in flat order; the
    step's stats; a subscribe wave on shard 0's slots and an unsubscribe
    wave on shard 1's, each one scatter on the owning ranks and a skip on
    the others, every rank's mirrors equal to their host slices after
    each; sparse_fanout_slots, occurrence_index and share_pick launched
    on every rank, 2 + 3 a round-robin step (the group counts are the
    occurrence call's totals), compact_fanout_slots not; occurrence_index
    with its totals and share_pick with rank offsets against their twins,
    a round-robin call with dp offsets making exactly 5 launches;
    the breakdown (encode, h2d, step, collectives, assembly, route);
36. `mesh_1m_2x2`: mixed_1m dense (4 of 8 lane words a tp rank): 3
    batches against the host oracle, the raw outputs against the same
    step run on CPU copies of each rank's tables (the twins, over gloo);
    the retained_5m store (chunk rows over 'dp') and its 8,192-filter
    storm fused into one batch, equal to `match_many` and the oracle;
    semantic_256k f32 (2^17 entries a tp rank) with `RULES_SQL`: each
    rank's block against the twin on its shard's entries (the union of
    per-shard top-k, as JAX's mesh computes it), sem_count against the
    shards' summed counts, the masks against twin and numpy; churn (rows
    past kslot, their dense rows through the second gather; semantic step
    A), mirrors after each; compact_fanout_slots with its lane base
    against its twin; the composite bounds of the dense, semantic and
    fused steps on a rank (`composite_bounds_mesh_1m`); the breakdown;
37. `mesh_1m_nccl1`: one NCCL rank, its MeshServingRouter equal to
    DeviceRouter.route on the same batches bit for bit;
38. `mesh_plus_2x2`: plus_100k's dense table (2,048 of 4,096 lane words a
    tp rank) through `dist_route_step`, B = 8192 over 'dp': 3 batches,
    every rank's blocks of matched, mcount, flags and bitmaps ([4,096,
    2,048] uint32) against the host oracle's slice, the reduced stats
    equal on every rank and to the single-device `route_step`'s (run by
    rank 0 before the counters are zeroed), two all-reduces a batch (`COLLECTIVES['dist_step']`), tokenize,
    vocab_lookup, nfa_walk and fanout_bitmaps launched on every rank;
    the breakdown (encode, h2d, step, collectives, readback, route);
39. `tables_mesh_broker`: built with the other paths' tables, before any
    fork: broker_1m's broker (`broker_build`, 1,000,100 subscriptions, 100
    round-robin groups of 16, the CSR flip) and session_1m's 1,000,000
    sessions bulk-loaded into 2^22 rows (host lanes only); build seconds,
    flips, `residual_count`, the mirror bytes a rank will hold; then the
    heap frozen (`mesh_heap`) and, asked, `mesh_build_overlap` (the build's
    end against the time this process asked for the paths);
    `mesh_broker_2x2` on every rank: `Broker.mesh` and `Router.mesh` set,
    the first prepare (the CSR resharded over 'tp') timed, then broker_1m's
    first ROUTE_BATCHES batches (the same draws of `default_rng(SEED)`)
    through `publish_batch`, each checked as `broker_publish` checks it,
    with its messages/s, prepare / route / host-dispatch ms, collectives
    and their ms, peak RSS and a `delivery_digest`;
    `mesh_ingest_broker_2x2`: the same batches through `adispatch_begin`
    at depth 1 (the synchronous digests) and 2 (those of `depth2_members`),
    messages/s and settle p50 / p99; `mesh_session_2x2`: a
    `SessionStore(mesh=...)` installing the loaded sessions (its mirror
    the rank's 'dp' block), its first full sync timed, a wave of 16,384
    rows to the rel phase as one delta, `tick(fused_path=False)`
    redelivering exactly the wave, each rank's mirror against its block
    after every sync; `mesh_broker_digests` (this process): every rank's
    digests equal to broker_1m's single-device `publish_batch` digests;
    the mesh paths run when asked, beside broker_1m's subscribe loop (host
    work only), and are joined before its first prepare;
39b. background compaction and segment-state snapshots, each phase on a
    path's own tables: `compact_bitmaps` (mixed_1m, before `flip_1m`),
    `compact_share` (the end of the share path), `compact_session`
    (after `fused_session`), `compact_broker` (broker_1m, before its
    semantic phases), `compact_semantic` (after `ingest_semantic_broker`),
    `snapshot_broker` (the end of the broker path; its data dir the app
    phases' below), and in the mesh
    process `mesh_compact_broker_2x2` and `mesh_session_2x2`'s `compact`:
    a `SegmentCompactor` cycle (ticked on an asyncio loop, or
    `compact_now` at one batch boundary on every rank), its build and
    upload on the compaction thread, the adopting prepare uploading none
    of the offered arrays, mirrors equal to host (each rank's block),
    checked batches before, during and after; `runs` and `aborted` 0
    asserted; `mesh_compact_broker_digests` (this process): every rank's
    digests after its cycle equal to broker_1m's;
39c. the app (`emqx_tpu_torch.app.BrokerApp`) over TCP, after
    `snapshot_broker`, whose data dir (`DurableState(FileKv(dir),
    segments=...)`: broker_1m's tables and session_1m's store) it boots
    from (`app_path`; the config `app_config` writes: one listener on
    127.0.0.1:0, the refused sections off, durability with the segment
    snapshot, the device session store, storms riding batches):
    `app_boot`: the restore and the warmup timed, no subscribe replayed,
    the restored tables byte-identical to broker_1m's; `app_clients`: 304
    connections of the port's `mqtt/client.py` (half v5) from a process of
    their own (`python3 chip_smoke.py --app-clients`, driven line by line):
    192 plain subscribers on broker_1m's two shapes (restored filters and
    new ones), one `$share` group of 16 on its own subtree, 16 on
    residual-shape filters (the shape table filled first, so the NFA lane
    runs) and 16 wildcard subscribers over 4,096 retained messages stored
    first (their storm rides a batch); 64 publishers send 65,536 publishes
    (half QoS 1) in rounds of 4,096, the config's `ingest_max_batch`, 64
    from each publisher in one socket write (below a channel's
    `PUB_PIPELINE_MAX`),
    every PUBACK of a round awaited before the next: every delivery equal
    to the host oracle, each `$share` message to one member, every PUBACK,
    the retained replays flagged, after every batch no degraded batch and
    no injected fault, `messages.routed.device` the rows of the device
    batches, at least `APP_DEVICE_SHARE` of the rounds' rows in device
    batches, every kernel of `APP_KERNELS` launched
    (the kernels line's `app_launches`); `app_restart`: `stop()` with its
    final flush, a second app from the same dir (no subscribe replayed but
    the 32 persistent sessions'), their resume, and 8,192 publishes in two
    rounds, at least `APP_DEVICE_SHARE` of them and of the sessions'
    deliveries in device batches, whose deliveries equal the host model of the fan-out for the device batches
    (`app_slot_prediction`, held to the oracle in `app_clients`), which
    after this restore need not be the oracle (ROADMAP Queue 3), and the
    oracle for a batch below `min_tpu_batch` (the CPU path delivers by
    filter); `app_main`: `python -m emqx_tpu_torch -c
    small.json --no-dashboard` in a subprocess: its listener line, one
    QoS 1 round trip, exit 0 on SIGTERM;
40. one JSON line {"kernels": [...]}: the fifteen kernels, each with its
    launches on its path (the seven of mixed_10m there; the CSR gather,
    the picks (round_robin) and the occurrence index on share_10m_csr;
    row_lengths and narrow_i16 on retained_5m, with
    `broker_1m_storm_launches` (theirs, tokenize's and shape_match's) from
    the broker batches that carried a storm; session_sweep on
    session_1m, the direct rides' and the broker phases'; semantic_match (f32 table) and rule_masks on
    semantic_256k, with `broker_1m_launches` from the broker's semantic
    phases; the `mesh` cases of occurrence_index (with the totals
    mesh_share_2x2's round-robin branch all-gathers), of its rank-offset
    share_pick and of mesh_1m_2x2's lane-based compact_fanout_slots;
    `mesh_broker_launches` on the kernels the mesh broker launched;
    `compact_launches`, each kernel's launches by compaction or snapshot
    phase; `app_launches`, each kernel's launches while the app served its
    clients (`app_clients`); the broker_1m and
    plus_100k cases of the kernels those paths launch, with their
    launches there),
    its wrapper-call, device (CUPTI; CUDA events around calls queued
    behind a spin where the trace held none: `device_via`), plain-twin
    and library-call times and the
    least time the card could take (bytes moved over 3.35 TB/s, or
    operations over the 67 T/s scalar rate, 989 T/s for a bf16 product,
    the larger), after `composite_bounds_nfa` (the bounds of `route_step`
    a batch and of `dist_step` a rank); then the card line; then, last,
    {"ok": true, "device": ...}.
"""

from __future__ import annotations

import collections
import gc
import itertools
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
TIMING_REPS = 21  # >= 20 samples per median
TIMING_INNER = 5  # launches per sample (the mean of a back-to-back run)
PLAIN_INNER = 1

# mixed_10m, as bench.py defines it (CFG and _build_mixed_10m)
NFA_CFG = dict(frontier=16, max_matches=16, probes=8)
MIXED_10M_IDS = (10_000, 500, 100, 400, 300, 200, 100)  # levels 1..7
MIXED_10M_TOTAL = 10_000_000
RESIDUAL_CAP = 50_000  # the last two families' size cap
SUBS_PER_FILTER = 2

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores

EDGE_TOPICS = ["", "$SYS/broker/x", "a/b/c/d/e/f/g/h/i/j", "device/3/mid/5/"]
EDGE_TOPICS_10M = ["", "$SYS/broker/x", "$v/1/2/3/4/5/6/7",
                   "v/1/2/3/4/5/6/7/8/9", "v/1//", "v"]

# the kernels of the mixed_10m path (dense table, residual NFA lane, mirror)
MIXED_10M_KERNELS = ("tokenize", "shape_match", "vocab_lookup", "nfa_walk",
                     "fanout_bitmaps", "compact_fanout_slots", "segment_scatter")

# share_10m_csr: BASELINE config 4 as bench.py builds it (share_10m: 10M
# device/{i}/+/{j}/# filters, 8 subscriber slots each) over a 2^20-slot
# universe, plus the $share groups on device/{i}/#
SHARE_IDS = 10_000
SHARE_NUMS = 1000
SHARE_SPF = 8
SHARE_SLOTS = 1 << 20
SHARE_GPF = 4
SHARE_GROUPS = (("ingest", 16, SHARE_IDS), ("audit", 4, 1000))  # name, members, ids
EDGE_TOPICS_SHARE = ["device/5", "$SYS/x", "device/1/2/3/4/5/6/7/8/9", ""]

# retained_5m: BASELINE config 5 as bench.py builds it (`bench_retained`,
# bench.py:1192-1243): N topics site/{i % 2048}/dev/{i % 100003}/ch/{i} in
# DeviceRetainedIndex(max_bytes=64, max_levels=8), a storm of
# site/+/dev/{d}/ch/# for d < 8,192
RET_N = 5_000_000
RET_STORM = 8192
RET_SITES = 2048
RET_DEVIDS = 100003
RET_MAX_BYTES = 64
RET_BULK = 300_000  # churn: a bulk load that fills chunk 4 and starts chunk 5
RET_PLAIN_REPS = 5  # samples of a plain twin at a million rows

# session_1m: bench.py's session_storm (bench_session_storm)
SESS_N = 1_000_000
SESS_SWEEP = 16384
SESS_RETRY = 1.0  # seconds
SESS_BATCH = 64  # topics of the mixed_1m batch each direct sweep rides
SESS_ACKS, SESS_RELS, SESS_AWAITS = 20000, 10000, 5000  # churn ride A
SESS_EXPIRY = 100000  # churn ride B: sessions with an expiry deadline
# the broker's drive (bench.py:2886-2965): Router(min_tpu_batch=32), one
# subscription on drive/#, BatchIngest(max_batch=256, window_us=200), 64
# drive/{i} publishes a sweep
SESS_MIN_BATCH = 32
SESS_DRIVE = 64
SESS_INGEST = dict(max_batch=256, window_us=200)
# live store-backed sessions: 65,536 Session objects (max_inflight 32), one
# QoS1 subscription sess/{i} each, 8 batches of 8,192 publishes a depth
LIVE_SESSIONS = 65536
LIVE_BATCH = 8192
LIVE_INFLIGHT = 32
LIVE_FLUSH = 2  # no-match batches that carry the acks' writes

# semantic_256k: 2^18 embedding filters at D = 384 (the output width of the
# public sentence-embedding model all-MiniLM-L6-v2), top-16, over the
# mixed_1m router; vectors as bench.py's agentic_fabric `_near` draws them
SEM_N = 1 << 18
SEM_DIM = 384
SEM_TOPK = 16
SEM_CENTROIDS = 256
SEM_THRESH = (0.90, 0.96)  # cuts through the same-cluster band (~0.94)
SEM_SCOPE_DEVICES = 100  # scoped entries: device/{d}/# or device/{d}/+/{j}/#
SEM_TOPIC_SLOTS = 256  # entries that take slots 0-255, topic slots too
SEM_TAU = SEM_DIM * 2.0 ** -23  # the float-order band: D ulps of 1 at 2^-23
SEM_ROUTE_BATCHES = 3
SEM_CHURN = (100, 900)  # adds and removes per churn step
SEM_CHECK_ROWS = 64  # rows recomputed in f64 beside every differing row
SEM_CHUNK = 256  # rows per chunk of the plain twin on the card

# the compiled rule set of the semantic_256k path: EMQX rule SQL over
# device/#, together all 20 opcodes of the rule_masks kernel
RULES_SQL = (
    "payload.temp + payload.base > 30",
    "payload.temp >= 20 AND payload.hum < 60",
    "qos = 1 OR qos = 2 OR false",
    "payload.level IN (1, 3, -5)",
    "NOT (payload.temp - payload.base) * 2 <= 10",
    "payload.count div 3 = 1 AND payload.count mod 4 != 0",
    "topic(2) = '42'",
    "payload.a / payload.b > 1 OR payload.flag",
)
# the clauses of RULES_SQL that compare a sum or difference of payload
# floats with a constant, which f32 and f64 can put on opposite sides of
# it (two-decimal values compared or divided alone keep their order):
# {index: (the keys, the compared expression, the constant)}; each clause
# passes where the expression is above the constant
RULES_F32_COMPARED = {
    0: (("temp", "base"), lambda t, b: t + b, 30),
    4: (("temp", "base"), lambda t, b: (t - b) * 2, 10),
}
# the most rows of a batch the f32 masks may drop at a boundary (about one
# in 10,000 rows sums or differs to a constant exactly)
RULE_F32_DROP_MAX = 4


T_START = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One phase's JSON line; `t_s`: seconds since this process started."""
    print(json.dumps({"phase": name, **fields, "t_s": time.perf_counter() - T_START}),
          flush=True)


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
    """n Zipf(1.3) ids in [0, k), as bench.py draws them."""
    return np.minimum(rng.zipf(1.3, size=n) - 1, k - 1)


# -- workloads ---------------------------------------------------------------


def rule_messages(rng, topics) -> list:
    """One event context per topic for `extract_features`: a seeded QoS and
    JSON payload; each key is missing about 10% of the time and a string
    about 2% (the row turns suspect), and `b` is 0 or 0.5 about 5%."""
    keys = ("temp", "hum", "base", "level", "count", "a", "b", "flag")
    out = []
    for t in topics:
        payload = {}
        for k in keys:
            r = rng.random()
            if r < 0.10:
                continue
            if r < 0.12:
                payload[k] = "n/a"
            elif k == "b" and r < 0.17:
                payload[k] = [0, 0.5][int(rng.integers(0, 2))]
            elif k in ("level", "count", "flag"):
                payload[k] = int(rng.integers(0, {"level": 7, "count": 13, "flag": 2}[k]))
            else:
                payload[k] = round(float(rng.uniform(-5, 50)), 2)
        out.append({"qos": int(rng.integers(0, 3)), "topic": t,
                    "payload": json.dumps(payload).encode()})
    return out


def rule_filter(sql_wheres, sql, compiler):
    """A `DeviceRuleFilter` of the given package (`sql`, `compiler`: its
    `rules.sql` and `rules.compile` modules) over one enabled rule per
    WHERE clause, selecting device/#."""
    from types import SimpleNamespace

    rules = [SimpleNamespace(id=f"r{i}", enabled=True,
                             query=sql.parse_sql(f'SELECT * FROM "device/#" WHERE {w}'))
             for i, w in enumerate(sql_wheres)]
    f = compiler.DeviceRuleFilter()
    f.refresh(rules)
    return f


def sem_centroids():
    """semantic_256k's SEM_CENTROIDS unit centroids at SEM_DIM (seeded)."""
    cents = np.random.default_rng(SEED + 7).normal(size=(SEM_CENTROIDS, SEM_DIM))
    return (cents / np.linalg.norm(cents, axis=1, keepdims=True)).astype(np.float32)


def sem_vectors(rng, cents, cluster):
    """`_near` of bench.py's agentic_fabric, vectorised: c + 0.25 n (n a
    unit normal), normalised, float32."""
    n = rng.normal(size=(len(cluster), cents.shape[1])).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v = cents[cluster] + np.float32(0.25) * n
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def semantic_row_ok(sims64, elig, ths, slots, topk, got, got_count, tau) -> bool:
    """Can one row's semantic winners `got` (slots, score order, -1 holes)
    and count come from its similarities `sims64` (float64, recomputed
    from the same f32 or bf16 inputs) when every similarity may be off by
    up to `tau`? `elig` marks the live, in-scope entries, `ths` their
    thresholds, `slots` their slots (one entry per live slot). It holds
    when: the count lies between the entries surely and possibly at or
    above threshold; the winners are min(topk, count) possible entries in
    score order (within 2 tau); and no sure entry is missing that either
    fits in a short list or beats the last winner by more than 2 tau."""
    sure = elig & (sims64 >= ths + tau)
    maybe = elig & (sims64 >= ths - tau)
    if not int(sure.sum()) <= got_count <= int(maybe.sum()):
        return False
    win = [int(s) for s in got if s >= 0]
    if len(win) != min(topk, got_count) or len(set(win)) != len(win):
        return False
    ent = []
    for s in win:
        hit = np.nonzero((slots == s) & maybe)[0]
        if len(hit) != 1:
            return False
        ent.append(int(hit[0]))
    sc = sims64[ent]
    if np.any(sc[1:] > sc[:-1] + 2 * tau):
        return False
    missing = sure.copy()
    missing[ent] = False
    if len(win) < topk:
        return not missing.any()
    return not np.any(missing & (sims64 > sc.min() + 2 * tau))



def format_rows(parts, n: int) -> list:
    """n strings, row i the concatenation of each part's row i: a part is a
    str (the same for every row) or (ids int array [n], id space). One
    numpy pass: each id is looked up in a table of its decimal bytes,
    NUL-padded; the rows are joined into one buffer, the padding dropped,
    and the buffer split."""
    mats = []
    for p in parts:
        if isinstance(p, str):
            b = np.frombuffer(p.encode(), np.uint8)
            mats.append(np.broadcast_to(b, (n, len(b))))
        else:
            ids, space = p
            tab = np.array([str(i).encode() for i in range(space)])
            mats.append(tab.view(np.uint8).reshape(space, -1)[ids])
    mats.append(np.full((n, 1), ord("\n"), np.uint8))
    text = np.concatenate(mats, axis=1).tobytes().decode("ascii")
    return text.replace("\0", "").split("\n")[:-1]


def mixed_10m_masks():
    """The 64 sparse families of bench.py `_build_mixed_10m`: ((plus
    levels), depth), in its order."""
    cands = []
    for plus_pos in (1, 2, 3, 4, 5, 6):
        for depth in (4, 5, 6, 7, 8):
            cands.append(((plus_pos,), depth))
    for combo in ((1, 3), (2, 4), (1, 4), (2, 5), (3, 5), (1, 5), (3, 6),
                  (4, 6), (2, 6), (1, 6)):
        for depth in (6, 7, 8):
            cands.append((combo, depth))
    for combo in ((1, 3, 5), (2, 4, 6), (1, 2, 4), (3, 4, 6), (1, 4, 6),
                  (2, 3, 5), (1, 3, 6), (2, 4, 5), (1, 2, 5), (2, 3, 6)):
        for depth in (7, 8):
            cands.append((combo, depth))
    seen = {(frozenset((2,)), 4)}  # dense overlay 2's shape
    masks = []
    for plus, depth in cands:
        key = (frozenset(plus), depth)
        if max(plus) < depth and key not in seen:
            seen.add(key)
            masks.append((tuple(plus), depth))
    return masks[:64]


def family_parts(plus, depth, cols, ids):
    """format_rows parts of one family: v/<lvl 1>/.../<lvl depth-1>[/#]."""
    parts = ["v"]
    for lvl in range(1, depth):
        parts += ["/+"] if lvl in plus else ["/", (cols[lvl], ids[lvl - 1])]
    if depth < 8:
        parts.append("/#")
    return parts


def mixed_10m_filters(rng, ids=MIXED_10M_IDS, total=MIXED_10M_TOTAL,
                      residual_cap=RESIDUAL_CAP, min_family=1000):
    """bench.py's mixed_10m filter set, built with numpy instead of a
    per-filter loop -> (filters, families): families[i] = (plus, depth, lo,
    hi), the family's filters being filters[lo:hi]. The first 64 shapes to
    appear (overlays 1 and 2, then families 0..61) fill the device table;
    families 62 and 63 go to the residual NFA. Smaller `ids` and `total`
    give the same 66 shapes at a test's size."""
    A, C = ids[0], ids[2]
    a = np.arange(A)
    filters = format_rows(["v/", (a, A), "/#"], A)  # dense overlay 1
    filters += format_rows(  # dense overlay 2
        ["v/", (np.repeat(a, C), A), "/+/", (np.tile(np.arange(C), A), C), "/#"],
        A * C,
    )
    masks = mixed_10m_masks()
    budget = total - len(filters)
    per_family = budget // 64
    spaces = []
    for plus, depth in masks:
        sp = 1
        for lvl in range(1, depth):
            if lvl not in plus:
                sp *= ids[lvl - 1]
        spaces.append(sp)
    sizes = [min(per_family, max(min_family, sp // 2)) for sp in spaces]
    shortfall = budget - sum(sizes)
    roomy = [i for i, sp in enumerate(spaces) if sp > 20 * per_family]
    for i in roomy:
        sizes[i] += shortfall // len(roomy)
    sizes[62] = min(sizes[62], residual_cap)
    sizes[63] = min(sizes[63], residual_cap)
    families = []
    for (plus, depth), sz in zip(masks, sizes):
        cols = {lvl: rng.integers(0, ids[lvl - 1], size=sz)
                for lvl in range(1, depth) if lvl not in plus}
        lo = len(filters)
        filters += format_rows(family_parts(plus, depth, cols, ids), sz)
        families.append((plus, depth, lo, len(filters)))
    return filters, families


def mixed_10m_topics(rng, n, ids=MIXED_10M_IDS):
    """v/{zipf a}/{b}/{c}/{d}/{e}/{f}/{g}, as bench.py draws them."""
    parts = ["v/", (zipf_ids(rng, n, ids[0]), ids[0])]
    for space in ids[1:]:
        parts += ["/", (rng.integers(0, space, size=n), space)]
    return format_rows(parts, n)


def topics_from_filters(rng, filters, ids=MIXED_10M_IDS):
    """One topic per filter that the filter matches: each `+` filled with
    an id of its level's space, `#` with one or two levels."""
    out = []
    for f in filters:
        ws = f.split("/")
        for lvl, w in enumerate(ws):
            if w == "+":
                ws[lvl] = str(rng.integers(0, ids[min(lvl, 7) - 1]))
        if ws[-1] == "#":
            ws[-1:] = [str(rng.integers(0, 100)) for _ in range(int(rng.integers(1, 3)))]
        out.append("/".join(ws))
    return out


def shape_of(filter_: str):
    """(literal-level mask, prefix length, trailing #) of a filter."""
    ws = filter_.split("/")
    hh = ws[-1] == "#"
    if hh:
        ws = ws[:-1]
    return sum(1 << l for l, w in enumerate(ws) if w != "+"), len(ws), hh


def build_mixed_1m():
    from emqx_tpu_torch.models.router_model import SubscriberTable
    from emqx_tpu_torch.ops.route_index import RouteIndex

    filters = [f"device/{i}/+/{j}/#" for i in range(1000) for j in range(1000)]
    filters += [f"device/{i}/#" for i in range(100)]
    index = RouteIndex()
    fids = np.asarray(index.bulk_add(filters), np.int64)
    subtab = SubscriberTable(max_subscribers=MAX_SUBSCRIBERS)
    subtab.bulk_add(fids, np.arange(len(fids)) % MAX_SUBSCRIBERS)
    return index, subtab


def build_mixed_10m(rng, **kw):
    """-> (index, subtab, families, seconds per build stage)."""
    from emqx_tpu_torch.models.router_model import SubscriberTable
    from emqx_tpu_torch.ops.route_index import RouteIndex

    t0 = time.perf_counter()
    filters, families = mixed_10m_filters(rng, **kw)
    t1 = time.perf_counter()
    index = RouteIndex()
    fids = np.asarray(index.bulk_add(filters), np.int64)
    t2 = time.perf_counter()
    subtab = SubscriberTable(max_subscribers=MAX_SUBSCRIBERS)
    # bench.py: SUBS_PER_FILTER slots per filter, slot = i mod (spf * 32)
    spf = SUBS_PER_FILTER
    subtab.bulk_add(np.repeat(fids, spf), np.arange(len(fids) * spf) % (spf * 32))
    t3 = time.perf_counter()
    secs = {"filter_strings": t1 - t0, "route_index": t2 - t1,
            "subscriber_table": t3 - t2}
    return index, subtab, filters, families, secs


# -- the host oracle ---------------------------------------------------------


def slot_set(row: np.ndarray) -> set:
    bits = np.unpackbits(np.ascontiguousarray(row).view(np.uint8), bitorder="little")
    return set(np.nonzero(bits)[0].tolist())


class Oracle:
    """Host reference: invert every shape the table holds against the
    topic (the device shapes, and the residual filters' shapes parsed from
    their strings), look each resulting filter up in the RouteIndex
    registry (as bench.py `_expected_matches` does, without a 10M-entry
    trie), and union the SubscriberTable rows of the filters found."""

    def __init__(self, index, subtab, extra_shapes=()):
        self.index = index
        self.subtab = subtab
        self.shapes = sorted(set(index.shapes._shape_ids) | set(extra_shapes))

    def candidates(self, topic: str) -> list:
        ws = topic.split("/")
        nw = len(ws)
        dollar = topic.startswith("$")
        out = []
        for mask, plen, hh in self.shapes:
            if (nw < plen) if hh else (nw != plen):
                continue
            rootwild = (plen == 0 and hh) or (plen > 0 and not (mask & 1))
            if dollar and rootwild:
                continue
            parts = [ws[l] if (mask >> l) & 1 else "+" for l in range(plen)]
            if hh:
                parts.append("#")
            out.append("/".join(parts))
        return out

    def fids(self, topics) -> list:
        """Per topic, the set of matching live filter ids: every candidate
        of the batch resolved in one vectorised registry probe, each hit
        confirmed by exact name."""
        cands = [self.candidates(t) for t in topics]
        flat = [c for cs in cands for c in cs]
        got = self.index._hash_lookup_batch(flat)[0] if flat else []
        out, o = [], 0
        for cs in cands:
            found = set()
            for name, fid in zip(cs, got[o : o + len(cs)]):
                if fid >= 0 and self.index.filter_name(int(fid)) == name:
                    found.add(int(fid))
            o += len(cs)
            out.append(found)
        return out

    def region_total(self, fids) -> int:
        """Allocated packed-region length over the fids of a CSR table."""
        ln = self.subtab.csr.csr_len[0]
        return sum(int(ln[f]) for f in fids if f < len(ln))

    def slot_count(self, fids) -> int:
        """Live (fid, slot) pairs over the fids of a CSR table."""
        return sum(len(self.subtab.csr.slots_of(f)) for f in fids)

    def slots(self, fids) -> set:
        out = set()
        for f in fids:
            if self.subtab.sparse:
                out |= set(self.subtab.csr.slots_of(f).tolist())
            else:
                out |= slot_set(self.subtab.arr[f])
        return out

    def count(self, fids, want: set, kslot: int):
        """-> (the slot_count the kernel reports, whether a row passed the
        gather window). A CSR row counts every matched fid's slots, a slot
        that two of its filters share twice; the bitmap OR counts it once.
        A row whose packed regions pass the gather window (2 x kslot) has
        its count forced to max(their allocated length, kslot + 1)."""
        if not self.subtab.sparse:
            return len(want), False
        total = self.region_total(fids)
        if total > 2 * kslot:
            return max(total, kslot + 1), True
        return self.slot_count(fids), False


class MeshOracle(Oracle):
    """The host reference of a mesh whose CSR table is split over 'tp': each
    shard (subscription -> shard slot % S) gathers, windows and counts its
    own slots, and the row's count is the sum over the shards."""

    def count(self, fids, want: set, kslot: int):
        if not self.subtab.sparse:
            return len(want), False
        csr = self.subtab.csr
        n, window = 0, False
        for s in range(csr.shards):
            ln = csr.csr_len[s]
            total = sum(int(ln[f]) for f in fids if f < len(ln))
            if total > 2 * kslot:
                n += max(total, kslot + 1)
                window = True
            else:
                n += sum(int((csr.slots_of(f) % csr.shards == s).sum()) for f in fids)
        return n, window


def check_batch(res, topics, oracle, exact_flags=True, kslot=None) -> dict:
    """Every unflagged row's matched fids and recipient slots equal the
    oracle's. Topics deeper than MAX_LEVELS must be flagged; with
    `exact_flags` no other row may be, else other flagged rows (NFA
    frontier or match overflow, which the host routes) are counted. The
    recipient count must equal the oracle's too (on a CSR table, with the
    kernel's count rules, `Oracle.count`; the router's gather window is the
    default 2 * kslot). `kslot`: the router's cap, when the slot rows are
    wider (a mesh's tp segments side by side)."""
    n_ovf = n_flag = n_bits = n_other_flag = n_window = 0
    if kslot is None:
        kslot = res.slots.shape[1] if res.slots is not None else 0
    want_fids = oracle.fids(topics)
    for i, t in enumerate(topics):
        deep = len(t.split("/")) > MAX_LEVELS
        if deep and not res.flags[i]:
            raise AssertionError(f"row {i} {t!r}: too deep but not flagged")
        if res.flags[i]:
            n_flag += 1
            if not deep:
                if exact_flags:
                    raise AssertionError(f"row {i} {t!r}: flagged")
                n_other_flag += 1
            continue
        want_f = want_fids[i]
        got_f = set(res.matched[i][res.matched[i] >= 0].tolist())
        if got_f != want_f or int(res.mcount[i]) != len(want_f):
            raise AssertionError(f"row {i} {t!r}: fids {got_f} != {want_f}")
        if res.overflow[i]:
            n_ovf += 1
            got = slot_set(res.dense_rows[res.dense_index[i]])
        else:
            got = set(res.slots[i][res.slots[i] >= 0].tolist())
        want = oracle.slots(want_f)
        count = int(res.slot_count[i])
        want_count, window = oracle.count(want_f, want, kslot)
        if got != want or count != want_count:
            raise AssertionError(f"row {i} {t!r}: slots {sorted(got)} != {sorted(want)}")
        n_window += int(window)
        n_bits += len(want)
    out = {"rows": len(topics), "flagged": n_flag, "flagged_not_deep": n_other_flag,
           "overflow_rows": n_ovf, "recipients": n_bits}
    if oracle.subtab.sparse:
        out["gather_window_rows"] = n_window
    return out


# -- measurement -------------------------------------------------------------


def time_ms(fn, torch, inner=TIMING_INNER, reps=TIMING_REPS) -> float:
    """Median over `reps` samples of the mean time of `inner` back-to-back
    calls, between CUDA events (after two warm calls)."""
    fn()
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return float(np.median(samples))


def host_ms(fn, torch, reps=5) -> float:
    """Median host-clock time of fn() ending in a synchronize."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(samples))


KERNEL_SYMBOLS = {  # the CUDA kernels each wrapper launches
    "tokenize": "tokenize_kernel",
    "shape_match": "shape_match_kernel",
    "fanout_bitmaps": "fanout_kernel",
    "compact_fanout_slots": "compact_kernel",
    "vocab_lookup": "vocab_lookup_kernel",
    "nfa_walk": "nfa_walk_kernel",
    "segment_scatter": ("scatter_claim_kernel", "scatter_store_kernel"),
    "sparse_fanout_slots": "sparse_fanout_",  # sparse_fanout_warp<E, KR> or _block
    "share_pick": "share_pick_kernel",
    "occurrence_index": ("occ_count_kernel", "occ_scan_kernel", "occ_add_kernel"),
    "row_lengths": "row_lengths_kernel",
    "narrow_i16": "narrow_i16_kernel",
    "session_sweep": "sweep_kernel",
    "semantic_match": ("scores_", "semantic_merge_kernel"),  # scores_f32_ or scores_bf16_
    "rule_masks": "rule_masks_kernel",
}

SOURCES = {  # kernel -> (source in the repo, the JAX function it replaces)
    "tokenize": ("emqx_tpu_torch/kernels/csrc/tokenize.cu",
                 "emqx_tpu/ops/tokenizer.py:147"),
    "shape_match": ("emqx_tpu_torch/kernels/csrc/shape_match.cu",
                    "emqx_tpu/ops/shape_index.py:1108"),
    "fanout_bitmaps": ("emqx_tpu_torch/kernels/csrc/fanout.cu",
                       "emqx_tpu/models/router_model.py:52"),
    "compact_fanout_slots": ("emqx_tpu_torch/kernels/csrc/compact.cu",
                             "emqx_tpu/models/router_model.py:77"),
    "vocab_lookup": ("emqx_tpu_torch/kernels/csrc/vocab_lookup.cu",
                     "emqx_tpu/ops/tokenizer.py:294"),
    "nfa_walk": ("emqx_tpu_torch/kernels/csrc/nfa_walk.cu",
                 "emqx_tpu/ops/matcher.py:139"),
    "segment_scatter": ("emqx_tpu_torch/kernels/csrc/segment_scatter.cu",
                        "emqx_tpu/ops/segments.py:73"),
    "sparse_fanout_slots": ("emqx_tpu_torch/kernels/csrc/sparse_fanout.cu",
                            "emqx_tpu/ops/csr_table.py:84"),
    "share_pick": ("emqx_tpu_torch/kernels/csrc/share_pick.cu",
                   "emqx_tpu/models/router_model.py:904"),
    "occurrence_index": ("emqx_tpu_torch/kernels/csrc/occurrence_index.cu",
                         "emqx_tpu/models/router_model.py:885"),
    "row_lengths": ("emqx_tpu_torch/kernels/csrc/retained.cu",
                    "emqx_tpu/models/retained_index.py:69"),
    "narrow_i16": ("emqx_tpu_torch/kernels/csrc/retained.cu",
                   "emqx_tpu/models/retained_index.py:82"),
    "session_sweep": ("emqx_tpu_torch/kernels/csrc/session_sweep.cu",
                      "emqx_tpu/ops/session_table.py:76"),
    "semantic_match": ("emqx_tpu_torch/kernels/csrc/semantic_match.cu",
                       "emqx_tpu/ops/semantic_table.py:104"),
    "rule_masks": ("emqx_tpu_torch/kernels/csrc/rule_masks.cu",
                   "emqx_tpu/rules/compile.py:222"),
}


def profiled(torch, fn, reps: int):
    """Run fn reps times under torch.profiler (CPU + CUDA activity) ->
    (key_averages, wall seconds). `acc_events=True` keeps the events of
    every profiling cycle: without it the trace may report only the last
    cycle's and lose a kernel's device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def queued_ms(torch, fn, calls: int = 20) -> float:
    """Device time of one call from CUDA events around `calls` calls queued
    behind a spin kernel on the stream, so that the host's launch path opens
    no gaps between them on the device."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # about 50 ms of spinning: longer than queueing the calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(torch, name: str, fn, per_call=None):
    """Device time of one call of kernel `name`, and where it came from.
    From the CUPTI trace of 20 calls ("cupti"): per CUDA kernel of the
    launcher (`KERNEL_SYMBOLS`), its mean time per launch times its
    launches per call (`per_call`, 1 where not given), summed. A trace that
    lost every event of one of them is taken once more; when neither holds
    device time for all, from `queued_ms` ("events")."""
    syms = KERNEL_SYMBOLS[name]
    syms = (syms,) if isinstance(syms, str) else syms
    per_call = per_call or {}
    for _ in range(2):
        events, _ = profiled(torch, fn, 20)
        ms = 0.0
        for sym in syms:
            hits = [e for e in events if sym in e.key and e.count]
            total = sum(e.self_device_time_total for e in hits)
            count = sum(e.count for e in hits)
            if total <= 0:
                break
            ms += total / count / 1e3 * per_call.get(sym, 1)
        else:
            return ms, "cupti"
    return queued_ms(torch, fn), "events"


def max_abs_err(got, want, torch) -> int:
    if isinstance(got, dict):
        if set(got) != set(want):
            raise AssertionError(f"keys {sorted(got)} != {sorted(want)}")
        return max([max_abs_err(got[k], want[k], torch) for k in got] or [0])
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w, torch) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape}/{got.dtype} != {want.shape}/{want.dtype}")
    if got.numel() == 0:
        return 0
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(got.dtype)
    if bits is not None:  # float lanes written as bits: compared as bits
        got, want = got.view(bits), want.view(bits)
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def bound(bytes_moved: float, ops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nfa_work(torch, tables, syms, nwords, dollar, F):
    """Live (row, level, state) visits of the NFA walk on these inputs, and
    the states alive at the end of the rows that finish: the walk's
    data-dependent work, for its bound. Runs the plain twin's scan with a
    tally."""
    from emqx_tpu_torch.ops import matcher as Mt

    B, L = syms.shape
    fr = torch.full((B, F), -1, dtype=torch.int32, device=syms.device)
    fr[:, 0] = 0
    visits = 0
    for lvl in range(L):
        active = lvl < nwords
        act = (fr >= 0) & active[:, None]
        visits += int(act.sum())
        wild = act & ~(dollar & (lvl == 0))[:, None]
        lit = Mt._probe_edges(tables, torch.where(act, fr, -1),
                              syms[:, lvl : lvl + 1].expand(B, F), NFA_CFG["probes"])
        plus = torch.where(wild, tables["plus_child"][fr.clamp(min=0)], -1)
        newf, _ = Mt._compact(torch.cat([lit, plus], dim=1), F)
        fr = torch.where(active[:, None], newf, fr)
    final = int(((fr >= 0) & (nwords <= L)[:, None]).sum())
    return visits, final


def kernel_report(torch, kinds, plain_reps=TIMING_REPS) -> dict:
    """Each kernel against its twin (must be equal), then its times; the
    twin's from `plain_reps` samples."""
    report = {}
    for name, k in kinds.items():
        kname = k.get("name", name)  # several kinds may time one kernel
        want = k["plain"]()
        torch.cuda.synchronize()
        err = max_abs_err(k["out"], want, torch)
        if err:
            raise AssertionError(f"{name}: kernel != plain twin (max |diff| {err})")
        ms = time_ms(k["kernel"], torch)
        plain_ms = time_ms(k["plain"], torch, inner=PLAIN_INNER, reps=plain_reps)
        lib_ms = time_ms(k["library"], torch) if k.get("library") else None
        dev_ms, dev_via = device_ms(torch, kname, k["kernel"], k.get("per_call"))
        # a cross-check a trace cannot lose records of: CUDA events around
        # 20 calls queued behind a spin, the launches' gaps included (an
        # aged process's trace printed rule_masks below its launch floor)
        ev_ms = queued_ms(torch, k["kernel"])
        bound_ms, bound_by = bound(k["bytes"], k["ops"])
        src, replaces = SOURCES[kname]
        report[name] = {
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            # the kernel alone on the device, without the launch path that
            # `ms` includes
            "device_ms": dev_ms, "device_via": dev_via, "events_ms": ev_ms,
            **k.get("notes", {}),
        }
        phase("kernel", kernel=kname, case=name, equal=True, ms=ms, device_ms=dev_ms,
              device_via=dev_via, events_ms=ev_ms,
              plain_ms=plain_ms, plain_samples=plain_reps, library_ms=lib_ms,
              bound_ms=bound_ms, bytes=k["bytes"], ops=k["ops"], **k.get("notes", {}))
    return report


def launch_path_costs(torch, n: int = 2000) -> dict:
    """Host microseconds a call of the launch path's parts, the mean of `n`
    calls (host clock): the two ways to read the current stream's handle,
    `on_cuda` of one tensor, a resolved launcher's lookup, a whole
    `narrow_i16` call at [2^20, 1] beside `.to(torch.int16)`, and the
    device time of either (`queued_ms`)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models import retained_index as RI

    dev = torch.device("cuda", torch.cuda.current_device())
    m = torch.zeros((1 << 20, 1), dtype=torch.int32, device=dev)
    parts = {
        "current_stream_cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "on_cuda_one": lambda: kernels.on_cuda(m),
        "launcher_cached": lambda: kernels.launcher("emqx_narrow_i16"),
        "narrow_i16_call": lambda: RI.narrow_i16(m),
        "to_int16_call": lambda: m.to(torch.int16),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[f"{name}_us"] = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    out["narrow_i16_device_ms"] = queued_ms(torch, parts["narrow_i16_call"])
    out["to_int16_device_ms"] = queued_ms(torch, parts["to_int16_call"])
    return out


def lanes_over_8(torch, bits, kslot: int) -> float:
    """The share of compact.cu's lanes (a row's 4-word groups) that place
    more than 8 bits (its kSerialMax) in this input: bits within the row's
    first kslot. Past 8 in any lane of a warp, the kernel deals the
    warp's positions round its lanes; a case with 0 takes only the path
    where each lane places its own."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)], device=bits.device)
    B, W = bits.shape
    G = (W + 3) // 4
    over = 0
    for lo in range(0, B, 1024):
        x = bits[lo:lo + 1024]
        pad = torch.zeros((x.shape[0], 4 * G), dtype=torch.int32, device=bits.device)
        pad[:, :W] = x
        c = lut[pad.view(torch.uint8).view(x.shape[0], G, 16).long()].sum(-1)
        mine = torch.clamp(torch.minimum(c, kslot - (torch.cumsum(c, 1) - c)), min=0)
        over += int((mine > 8).sum())
    return over / (B * G)


def vocab_notes(torch, syms, nwords, tables) -> dict:
    """What a vocab_lookup case's time depends on: the lanes found, the
    share of lanes past their row's depth (hash pair (0, 0)), and the
    table's slots and fill."""
    B, L = syms.shape
    past = int((torch.arange(L, device=syms.device)[None, :] >= nwords[:, None]).sum())
    vsym = tables["vocab_sym"]
    return {"in_vocab_lanes": int((syms >= 0).sum()), "past_depth_share": past / (B * L),
            "vocab_slots": int(vsym.numel()), "vocab_live": int((vsym >= 0).sum()),
            "vocab_tombstones": int((vsym == -3).sum())}


def serving_work(name: str, *, B: int, L: int = 0, MB: int = 0, nbytes: int = 0, P: int = 0,
                 in_vocab: int = 0, K: int = 0, visits: int = 0, final: int = 0,
                 lanes: int = 0, hits: int = 0, fids: int = 0, W: int = 0, kslot: int = 0,
                 pop: int = 0) -> dict:
    """The least bytes and the integer operations of one serving kernel at
    one batch's counts, for its bound; every path that times the kernel
    takes them from here. B rows, L levels, MB topic bytes (nbytes of them
    live), P probes, in_vocab lanes found, K match columns, the NFA's
    visits and final states, `lanes` fan-out columns (hits of them
    matched, fids distinct), W words a row, kslot slots, pop bits set."""
    if name == "tokenize":
        return dict(bytes=B * MB + 4 * B + 2 * 4 * B * L + 4 * B + B,
                    ops=6 * nbytes + 12 * B * L)
    if name == "vocab_lookup":
        # the hash pairs in, the symbols out, one 12-byte vocab slot per
        # lane found and one 4-byte symbol word per lane not found
        return dict(bytes=3 * 4 * B * L + 12 * in_vocab + 4 * (B * L - in_vocab),
                    ops=B * L * (6 + 8 * P))
    if name == "nfa_walk":
        # symbols, depth and `$` in; matched, count and four flags out;
        # per live state and level its `#` and `+` words and one 12-byte
        # edge slot; per final state its terminal and `#` words
        return dict(bytes=4 * B * L + 5 * B + 4 * B * K + 4 * B + 4 * B
                    + 20 * visits + 8 * final,
                    ops=visits * (16 + 8 * P) + B * (L * 8 + K))
    if name == "fanout_bitmaps":
        # the lanes in, each distinct fid's row read once, the rows and
        # counts out; one OR a word of each matched lane's row, a popcount
        # and an add a word out, a check a lane
        return dict(bytes=4 * B * lanes + 4 * W * fids + 4 * B * W + 4 * B,
                    ops=hits * W + 2 * B * W + B * lanes)
    if name == "compact_fanout_slots":
        return dict(bytes=4 * B * W + 4 * B * kslot + 4 * B + B, ops=B * W * 12 + pop * 4)
    raise KeyError(name)


def match_kinds(torch, tables, m_active, bm, ln, salt, L=MAX_LEVELS):
    """tokenize and shape_match on one batch of topic bytes (uint8 [B, MB]
    and lengths on the card): their kinds, outputs, and the lane counts
    their bounds need."""
    from emqx_tpu_torch.ops import shape_index as S
    from emqx_tpu_torch.ops import tokenizer as T

    B, MB = bm.shape
    M = m_active
    tok = T.tokenize(bm, ln, salt, L)
    h1, h2, nw, dl = tok
    matched = S.shape_match(tables, M, h1, h2, nw, dl)
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
    nbytes = int(ln.clamp(0, MB).sum())
    kinds = {
        "tokenize": dict(
            kernel=lambda: T.tokenize(bm, ln, salt, L),
            plain=lambda: T.tokenize_plain(bm, ln, salt, L),
            out=tok,
            **serving_work("tokenize", B=B, MB=MB, L=L, nbytes=nbytes),
        ),
        "shape_match": dict(
            kernel=lambda: S.shape_match(tables, M, h1, h2, nw, dl),
            plain=lambda: S.shape_match_plain(tables, M, h1, h2, nw, dl),
            out=matched,
            # inputs + the table bytes read (a packed row and tombstone
            # word per valid lane, a hot row per valid lane that misses;
            # each table counted at most once whole, as a lane that reads
            # a row another lane read moves nothing new) + output
            bytes=2 * 4 * B * L + 5 * B + 3 * 4 * M
            + min(16 * n_valid, tables["shape_tab"].numel() * 4)
            + min(4 * n_valid, tables["shape_tomb"].numel() * 4)
            + min(16 * (n_valid - n_hit), tables["shape_hot"].numel() * 4)
            + 4 * B * M,
            ops=B * M * 12 + n_valid * (6 * L + 30),
        ),
    }
    return kinds, tok, matched, {"valid_lanes": n_valid, "shape_hits": n_hit}


def serving_kinds(torch, args, topics, nfa_cfg=None, ragged=False):
    """The six serving kernels on one batch: inputs, outputs and work. With
    `ragged`, two more cases: the fan-out over the table's first W - 1
    words, copied to a base 4 bytes off a 16-byte boundary (the kernel's
    scalar words), and tokenize over the rows' first 33 bytes on a base 1
    byte off (its byte path)."""
    from emqx_tpu_torch.models import router_model as R
    from emqx_tpu_torch.ops import matcher as Mt
    from emqx_tpu_torch.ops import tokenizer as T

    tables, nfa_tables, salt, m_active, kslot = args[:5]
    dev = tables["shape_tab"].device
    mat, lens, _ = T.encode_topics(topics, MAX_BYTES)
    bm = torch.from_numpy(mat).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    B, MB, L, M = len(topics), MAX_BYTES, MAX_LEVELS, m_active

    match, tok, matched, counts = match_kinds(torch, tables, M, bm, ln, salt, L)
    h1, h2, nw, dl = tok
    kinds = {}
    inputs = {"batch": B, "max_bytes": MB, "max_levels": L, "m_active": M, "kslot": kslot}
    if nfa_tables is not None:
        P = nfa_cfg["probes"]
        F, K = nfa_cfg["frontier"], nfa_cfg["max_matches"]
        syms = T.vocab_lookup(nfa_tables, h1, h2, P)
        nfa_out = Mt.batch_match_syms(nfa_tables, syms, nw, dl, frontier=F,
                                      max_matches=K, probes=P)
        matched_all = torch.cat([matched, nfa_out[0]], dim=1)
        in_vocab = int((syms >= 0).sum())
        visits, final = nfa_work(torch, nfa_tables, syms, nw, dl, F)
        nfa_hits = int((nfa_out[0] >= 0).sum())
        inputs.update(frontier=F, max_matches=K, probes=P, in_vocab_lanes=in_vocab,
                      nfa_state_visits=visits, nfa_final_states=final, nfa_hits=nfa_hits)
        kinds["vocab_lookup"] = dict(
            kernel=lambda: T.vocab_lookup(nfa_tables, h1, h2, P),
            plain=lambda: T.vocab_lookup_plain(nfa_tables, h1, h2, P),
            out=syms,
            notes=vocab_notes(torch, syms, nw, nfa_tables),
            **serving_work("vocab_lookup", B=B, L=L, P=P, in_vocab=in_vocab),
        )
        kinds["nfa_walk"] = dict(
            kernel=lambda: Mt.batch_match_syms(nfa_tables, syms, nw, dl, frontier=F,
                                               max_matches=K, probes=P),
            plain=lambda: Mt.batch_match_syms_plain(nfa_tables, syms, nw, dl, frontier=F,
                                                    max_matches=K, probes=P),
            out=nfa_out,
            **serving_work("nfa_walk", B=B, L=L, P=P, K=K, visits=visits, final=final),
        )
    else:
        matched_all = matched
    dense = "sub_bitmaps" in tables  # else a CSR table: see share_kinds
    if dense:
        bits, pop = R.fanout_bitmaps(tables["sub_bitmaps"], matched_all)
        W = bits.shape[1]
        Mall = matched_all.shape[1]
        comp = R.compact_fanout_slots(bits, kslot)
    torch.cuda.synchronize()

    fids = matched_all[matched_all >= 0].unique().numel()
    hits = int((matched_all >= 0).sum())
    inputs.update(**counts, distinct_fids=fids, matched_lanes=hits)
    kinds.update(match)
    if not dense:
        return kinds, inputs
    inputs.update(width_words=W, fanout_bits=int(pop.sum()))
    kinds.update({
        "fanout_bitmaps": dict(
            kernel=lambda: R.fanout_bitmaps(tables["sub_bitmaps"], matched_all),
            plain=lambda: R.fanout_bitmaps_plain(tables["sub_bitmaps"], matched_all),
            out=(bits, pop),
            **serving_work("fanout_bitmaps", B=B, lanes=Mall, hits=hits, fids=fids, W=W),
        ),
        "compact_fanout_slots": dict(
            kernel=lambda: R.compact_fanout_slots(bits, kslot),
            plain=lambda: R.compact_fanout_slots_plain(bits, kslot),
            out=comp,
            notes=dict(lanes_over_8=lanes_over_8(torch, bits, kslot)),
            **serving_work("compact_fanout_slots", B=B, W=W, kslot=kslot, pop=int(pop.sum())),
        ),
    })
    if ragged:
        sub = tables["sub_bitmaps"]
        fcap = sub.shape[0]
        rag = torch.empty(fcap * (W - 1) + 1, dtype=torch.int32, device=dev)[1:]
        rag = rag.view(fcap, W - 1)
        rag.copy_(sub[:, :W - 1])
        rag_out = R.fanout_bitmaps(rag, matched_all)
        kinds["fanout_bitmaps/ragged"] = dict(
            name="fanout_bitmaps",
            kernel=lambda: R.fanout_bitmaps(rag, matched_all),
            plain=lambda: R.fanout_bitmaps_plain(rag, matched_all),
            out=rag_out,
            **serving_work("fanout_bitmaps", B=B, lanes=Mall, hits=hits, fids=fids, W=W - 1),
        )
        inputs["ragged_width_words"] = W - 1
        inputs["ragged_base_mod_16"] = rag.data_ptr() % 16
        rmb = 33
        raw = torch.empty(B * rmb + 1, dtype=torch.uint8, device=dev)
        rbm = raw[1:].view(B, rmb)
        rbm.copy_(bm[:, :rmb])
        rln = ln.clamp(max=rmb)
        kinds["tokenize/ragged"] = dict(
            name="tokenize",
            kernel=lambda: T.tokenize(rbm, rln, salt, L),
            plain=lambda: T.tokenize_plain(rbm, rln, salt, L),
            out=T.tokenize(rbm, rln, salt, L),
            **serving_work("tokenize", B=B, MB=rmb, L=L, nbytes=int(rln.sum())),
        )
        inputs["ragged_tokenize"] = {"max_bytes": rmb, "base_mod_16": rbm.data_ptr() % 16}
    return kinds, inputs


def scatter_kind(torch, call):
    """The segment_scatter kernel on one recorded main-path call (flats,
    idxs, vals; int32, uint8, float32 or bfloat16 arrays): against its
    twin, and index_put_ of the last write per slot on the clones as the
    library yardstick (a float lane takes its values' bits through the
    integer view of its width); with the call's split, each part timed
    alone: host prep (`pack_entries`: conversion, bounds, concatenation),
    the pinned buffer's fill, its copy, the fresh-output clones and the
    two launches (with the hash table's memset)."""
    from emqx_tpu_torch.ops import segments as G

    flats, idxs, vals = call
    dev = next(iter(flats.values())).device
    out = G.segment_scatter(flats, idxs, vals)
    bits = {torch.float32: (torch.int32, np.int32), torch.bfloat16: (torch.int16, np.int16)}
    dvec = {}
    for k in flats:
        ix, vv = G._last_writes(idxs[k], vals[k], flats[k].dtype)
        view, np_dt = bits.get(flats[k].dtype, (flats[k].dtype, None))
        vv = torch.from_numpy(vv.astype(np_dt) if np_dt is not None else vv)
        dvec[k] = (torch.from_numpy(ix).to(dev), vv.to(device=dev, dtype=view), view)

    def library():
        res = {}
        for k, flat in flats.items():
            res[k] = flat.clone()
            res[k].view(dvec[k][2]).view(-1).index_put_((dvec[k][0],), dvec[k][1])
        return res

    names, offsets, idx, vbits = G.pack_entries(flats, idxs, vals)
    outs = [flats[k].clone() for k in names]
    host = G.pinned_entries(outs, offsets, idx, vbits)
    dbuf = host.to(dev)
    n_raw = len(idx)
    split = {
        "call_ms": host_ms(lambda: G.segment_scatter(flats, idxs, vals), torch, reps=9),
        "host_prep_ms": host_ms(lambda: G.pack_entries(flats, idxs, vals), torch, reps=9),
        "pin_ms": host_ms(lambda: G.pinned_entries(outs, offsets, idx, vbits), torch, reps=9),
        "copy_ms": time_ms(lambda: host.to(dev, non_blocking=True), torch),
        "clone_ms": time_ms(lambda: [flats[k].clone() for k in names], torch),
        "launches_ms": time_ms(lambda: G.launch_scatter(dbuf, len(names), n_raw), torch),
    }
    del outs, host, dbuf
    kept = sum(len(v[0]) for v in dvec.values())
    table_bytes = sum(t.numel() * t.element_size() for t in flats.values())
    info = {"arrays": {k: [int(t.numel()), len(dvec[k][0]), str(t.dtype)]
                       for k, t in flats.items()},
            "entries": n_raw, "entries_kept": kept, "cloned_bytes": table_bytes,
            "split": split}
    return dict(
        kernel=lambda: G.segment_scatter(flats, idxs, vals),
        plain=lambda: G.segment_scatter_plain(flats, idxs, vals),
        library=library,
        out=out,
        # fresh outputs: every touched array read once and written once,
        # each entry's 8-byte index and 4-byte value read, each kept
        # entry's element written
        bytes=2 * table_bytes + 12 * n_raw
        + sum(t.element_size() * len(dvec[k][0]) for k, t in flats.items()),
        ops=2 * n_raw,
    ), info


# -- the mixed_1m path -------------------------------------------------------


def topic_batch_1m(rng, n):
    ids = zipf_ids(rng, n, 1000)
    nums = rng.integers(0, 1000, size=n)
    return [f"device/{i}/mid/{j}/leaf" for i, j in zip(ids, nums)]


def route_breakdown(torch, router, batches, extras=None) -> dict:
    """Where one routed batch's time goes, medians over the batches (host
    clock, each stage ending in a synchronize): host encode, host->device
    copy of the topic bytes, the launches up to their completion (the pick
    inputs' host draw and copy included, when the router has groups), and
    the readback; then a whole route() of the same batch. Plus the
    device's busy share of profiled route() calls. `extras`: per batch an
    (embeddings, rules) pair for the semantic stage and the rule masks,
    whose arrays join the encode and copy stages (the rule features come
    from the caller, as `DeviceRuleFilter` extracts them broker-side)."""
    from emqx_tpu_torch.models.router_model import shape_route_step
    from emqx_tpu_torch.ops.tokenizer import encode_topics

    args = router.prepare()
    cfg = router.config
    dev = router.device
    extras = extras or [(None, None)] * len(batches)
    names = ("encode", "h2d", "kernels", "readback", "route")
    samples = {k: [] for k in names}
    for topics, (q, rules) in zip(batches, extras):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mat, lens, too_long = encode_topics(topics, MAX_BYTES)
        arrays = [mat, lens]
        if q is not None:
            arrays += [np.ascontiguousarray(q, np.float32),
                       np.ascontiguousarray(rules[1], np.float32),
                       np.ascontiguousarray(rules[2], bool)]
        t.append(time.perf_counter())
        ins = [torch.from_numpy(a).to(dev) for a in arrays]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        kw = {}
        if args.group_tables is not None:
            ch, th, rand = router._pick_inputs(topics, None)
            kw = dict(group_tables=args.group_tables, client_hash=ch,
                      topic_hash=th, rand=rand, with_groups=True,
                      share_strategy=router.share_strategy)
        if q is not None:
            kw.update(sem_tables=args.sem_tables, q_vecs=ins[2], sem_topk=args.sem_topk,
                      rule_progs=tuple(rules[0]), rule_feats=ins[3], rule_valid=ins[4])
        out = shape_route_step(
            args.tables, ins[0], ins[1], m_active=args.m_active, salt=args.salt,
            nfa_tables=args.nfa_tables, with_nfa=args.nfa_tables is not None,
            max_levels=cfg.max_levels, frontier=cfg.frontier,
            max_matches=cfg.max_matches, probes=cfg.probes, kslot=args.kslot,
            device=dev, **kw)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        router._readback(out, len(topics), too_long, args.kslot)
        t.append(time.perf_counter())
        router.route(topics, embeds=q, rules=rules)
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            samples[k].append(1e3 * (b - a))
    med = {f"{k}_ms": float(np.median(v)) for k, v in samples.items()}
    it = iter(list(zip(batches, extras)) * 2)

    def one():
        topics, (q, rules) = next(it)
        router.route(topics, embeds=q, rules=rules)

    events, wall = profiled(torch, one, len(batches))
    busy = sum(e.self_device_time_total for e in events) / 1e6
    med["device_busy_share"] = busy / wall if busy > 0 else None
    med["topics_per_s"] = BATCH / (med["route_ms"] / 1e3)
    return med


def mixed_1m_path(torch, rng):
    """Phases 2-5: the shape-only path at mixed_1m."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import DeviceRouter
    from emqx_tpu_torch.ops.matcher import MatcherConfig

    t0 = time.perf_counter()
    index, subtab = build_mixed_1m()
    host_s = time.perf_counter() - t0
    router = DeviceRouter(
        index, subtab, MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
        device="cuda",
    )
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if index.residual_count != 0 or args.kslot != KSLOT:
        raise AssertionError(f"residual {index.residual_count}, kslot {args.kslot}")
    phase("tables", filters=len(index), residual_count=index.residual_count,
          m_active=args.m_active, kslot=args.kslot, host_build_seconds=host_s,
          upload_seconds=upload_s,
          device_bytes={k: t.numel() * t.element_size() for k, t in args.tables.items()})

    kinds, inputs = serving_kinds(torch, args, topic_batch_1m(rng, BATCH), ragged=True)
    report = kernel_report(torch, kinds)
    phase("kernel_inputs", **inputs)

    oracle = Oracle(index, subtab)
    batches = []
    for _ in range(ROUTE_BATCHES):
        topics = topic_batch_1m(rng, BATCH)
        topics[: len(EDGE_TOPICS)] = EDGE_TOPICS
        batches.append(topics)
    churn_topics = topic_batch_1m(rng, BATCH)
    churn_topics[:64] = [f"device/7/mid/{j}/leaf" for j in range(64)]

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
    path = ("tokenize", "shape_match", "fanout_bitmaps", "compact_fanout_slots")
    if not all(launches[k] for k in path):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    phase("route", batches=summary, churn_subscribe=after_sub,
          churn_unsubscribe=after_unsub, launches=launches,
          segment_status=router.segment_status())
    brk = [topic_batch_1m(rng, BATCH) for _ in range(3)]
    phase("route_breakdown", **route_breakdown(torch, router, brk))
    phase("compact_bitmaps", **compact_bitmaps(torch, router, index, subtab, oracle,
                                               batches[:2]))
    flip_1m(torch, router, oracle, batches[:2])
    return report


def recipient_sets(res) -> list:
    out = []
    for i in range(len(res.mcount)):
        if res.overflow[i]:
            out.append(slot_set(res.dense_rows[res.dense_index[i]]))
        else:
            out.append(set(res.slots[i][res.slots[i] >= 0].tolist()))
    return out


def flip_1m(torch, router, oracle, batches):
    """Phase 5b: the mixed_1m table flipped to the CSR representation. The
    bitmaps mirror must swap to a fresh manager whose only work is one full
    upload, and the same batches must reach the same recipients."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.ops.csr_table import CSR_KEYS

    subtab = router.subtab
    before = [router.route(t) for t in batches]
    old_sync = router._bits_sync
    t0 = time.perf_counter()
    subtab.set_mode("sparse")
    flip_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    counters = router._bits_sync.counters()
    if router._bits_sync is old_sync or counters != {
            "full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0}:
        raise AssertionError(f"flip: the bitmaps mirror did not swap ({counters})")
    if "sub_bitmaps" in args.tables or not set(CSR_KEYS) <= set(args.tables):
        raise AssertionError(f"flip: tables {sorted(args.tables)}")
    kernels.reset_launches()
    checked = []
    for topics, res0 in zip(batches, before):
        res = router.route(topics)
        if recipient_sets(res) != recipient_sets(res0) or not np.array_equal(
                res.flags, res0.flags):
            raise AssertionError("flip: recipient sets differ from the dense table's")
        checked.append(check_batch(res, topics, oracle))
    launches = dict(kernels.LAUNCHES)
    if launches["sparse_fanout_slots"] != len(batches) or launches["fanout_bitmaps"] \
            or launches["compact_fanout_slots"]:
        raise AssertionError(f"flip: launches {launches}")
    phase("flip_1m", flip_seconds=flip_s, first_sync_seconds=upload_s,
          bits_mirror=counters, csr_bytes=mirror_bytes({k: args.tables[k] for k in CSR_KEYS}),
          subscriptions=subtab.live, kslot=args.kslot, routed=checked,
          launches=launches)


# -- the mixed_10m path ------------------------------------------------------


def mirror_bytes(tensors) -> dict:
    return {k: t.numel() * t.element_size() for k, t in tensors.items()}


def check_mirrors(torch, router) -> dict:
    """Copy every mirror back and compare it bit for bit with the host
    table it mirrors (the subscriber table in its active representation;
    the NFA and the group table where the router mirrors them)."""
    args = router.prepare()
    sub_keys = set(router.subtab.device_snapshot())
    pairs = [
        ("shapes", {k: v for k, v in args.tables.items() if k not in sub_keys},
         router.index.shapes),
        ("bitmaps", {k: args.tables[k] for k in sub_keys}, router.subtab),
    ]
    if args.nfa_tables is not None:
        pairs.append(("nfa", args.nfa_tables, router.index.nfa))
    if args.group_tables is not None:
        pairs.append(("groups", args.group_tables, router.grouptab))
    checked = {}
    for name, dev_tabs, src in pairs:
        snap = src.device_snapshot()
        if set(snap) != set(dev_tabs):
            raise AssertionError(f"{name}: arrays {sorted(dev_tabs)} != {sorted(snap)}")
        for k, host in snap.items():
            got = dev_tabs[k].cpu().numpy()
            if got.shape != host.shape or not np.array_equal(got.view(host.dtype), host):
                raise AssertionError(f"mirror {name}/{k} differs from the host table")
        checked[name] = sorted(snap)
    return checked


def mirror_counts(router):
    return {k: dict(v) for k, v in router.segment_status().items()}


def moved(before, after, key):
    return {m: after[m][key] - before[m][key] for m in after}


def route_checked(router, batches, oracle):
    out = []
    for topics in batches:
        t0 = time.perf_counter()
        res = router.route(topics)
        wall = time.perf_counter() - t0
        m = res.matched.shape[1] - router.config.max_matches
        nfa_hits = int((res.matched[:, m:] >= 0).sum())
        out.append({"route_ms": wall * 1e3, "nfa_hits": nfa_hits,
                    "readback_bytes": res.readback_bytes,
                    **check_batch(res, topics, oracle, exact_flags=False)})
    return out


def mixed_10m_path(torch, rng):
    """Phases 6-9: the residual NFA lane and the O(delta) mirror at
    mixed_10m. -> (kernel report, launches on the path)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.convert import upload
    from emqx_tpu_torch.models.router_model import DeviceRouter
    from emqx_tpu_torch.ops import segments as G
    from emqx_tpu_torch.ops.matcher import MatcherConfig

    t0 = time.perf_counter()
    index, subtab, filters, families, secs = build_mixed_10m(rng)
    build_s = time.perf_counter() - t0
    if index.shapes.m_active() != 64 or index.residual_count <= 0:
        raise AssertionError(f"m_active {index.shapes.m_active()}, "
                             f"residual {index.residual_count}")
    residual_families = families[62:]
    residual_shapes = {shape_of(filters[lo]) for _p, _d, lo, _hi in residual_families}
    router = DeviceRouter(
        index, subtab,
        MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES, **NFA_CFG),
        device="cuda",
    )
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    shape_b = mirror_bytes({k: v for k, v in args.tables.items() if k != "sub_bitmaps"})
    nfa_b = mirror_bytes(args.nfa_tables)
    bits_b = mirror_bytes({"sub_bitmaps": args.tables["sub_bitmaps"]})
    phase("tables_10m", filters=len(index), subscriptions=subtab.live,
          m_active=args.m_active, residual_count=index.residual_count,
          residual_families=[[list(p), d, hi - lo] for p, d, lo, hi in residual_families],
          kslot=args.kslot, build_seconds=build_s, build_stage_seconds=secs,
          upload_seconds=upload_s,
          device_bytes={"shapes": shape_b, "nfa": nfa_b, "bitmaps": bits_b,
                        "total": sum(shape_b.values()) + sum(nfa_b.values())
                        + sum(bits_b.values())},
          reduced=[])
    oracle = Oracle(index, subtab, residual_shapes)

    def zipf_batch():
        return mixed_10m_topics(rng, BATCH)

    def residual_batch(extra=()):
        picks = []
        for _p, _d, lo, hi in residual_families:
            picks += [filters[i] for i in rng.integers(lo, hi, size=BATCH // 2)]
        topics = topics_from_filters(rng, picks)
        topics[: len(extra)] = list(extra)
        return topics

    batches = [zipf_batch() for _ in range(ROUTE_BATCHES)]
    for b in batches:
        b[: len(EDGE_TOPICS_10M)] = EDGE_TOPICS_10M
    batches.append(residual_batch(EDGE_TOPICS_10M))

    # -- route_10m: the counters are zeroed here and read after churn_10m
    kernels.reset_launches()
    routed = route_checked(router, batches, oracle)
    after_route = dict(kernels.LAUNCHES)
    for k in ("vocab_lookup", "nfa_walk", "tokenize", "shape_match"):
        if after_route[k] != len(batches):
            raise AssertionError(f"{k}: {after_route[k]} launches for {len(batches)} batches")
    if routed[-1]["nfa_hits"] == 0:
        raise AssertionError("the residual batch found no NFA hits")
    phase("route_10m", batches=routed, launches=after_route)

    # -- churn_10m
    scatter_calls = []
    real_scatter = G.segment_scatter

    def recording_scatter(flats, idxs, vals):
        scatter_calls.append((dict(flats), dict(idxs), dict(vals)))
        return real_scatter(flats, idxs, vals)

    churn = {}
    # (a) the NFA's op-log cap: churn one residual filter until its epoch
    # bumps; that mirror alone must re-upload, in full
    c0 = mirror_counts(router)
    e0 = index.nfa.epoch
    f = "v/+/600/+/1/1/+/1"
    for cycles in range(1, 100_000):
        index.add(f)
        index.remove(f)
        if index.nfa.epoch != e0:
            break
    else:
        raise AssertionError("the NFA epoch never moved")
    t0 = time.perf_counter()
    router.prepare()
    torch.cuda.synchronize()
    churn["epoch_bump"] = {"cycles": cycles, "prepare_ms": 1e3 * (time.perf_counter() - t0)}
    c1 = mirror_counts(router)
    full = moved(c0, c1, "full_resyncs")
    if full != {"shapes": 0, "nfa": 1, "bitmaps": 0}:
        raise AssertionError(f"epoch bump: full resyncs {full}")
    churn["epoch_bump"]["full_resyncs"] = full

    def epochs_now():
        return {"shapes": index.shapes.epoch, "nfa": index.nfa.epoch,
                "bitmaps": subtab.epoch}

    def check_scatter_wave(what, before, after, e0, e1):
        wave = check_wave(what, before, after, e0, e1)
        if not any(wave["delta_launches"].values()):
            raise AssertionError(f"{what}: no scatter launched")
        return wave

    # (b) a subscribe wave: new residual and shape-family filters (ids past
    # the generator's spaces, so every one is new), their subscribers, and
    # extra subscribers on popular overlays that push rows past kslot
    n_new = 300
    k = np.arange(n_new)
    new_res = format_rows(["v/+/", (500 + k, 500 + n_new), "/+/", (k % 400, 400), "/",
                           (k % 300, 300), "/+/", (k % 100, 100)], n_new)
    new_shape = format_rows(["v/+/", (500 + k, 500 + n_new), "/", (k % 100, 100), "/#"],
                            n_new)
    if shape_of(new_res[0]) not in residual_shapes:
        raise AssertionError("the new residual filters have a device shape")
    epochs = epochs_now()
    added = []
    for i, name in enumerate(new_res + new_shape):
        fid = index.add(name)
        for s in (i % 64, 64 + i % 192):
            subtab.add(fid, s)
            added.append((fid, s))
    hot = [index.filter_id(f"v/{a}/#") for a in range(4)]
    for fid in hot:
        for s in range(64, 164):
            if not (subtab.arr[fid, s // 32] >> np.uint32(s % 32)) & 1:
                subtab.add(fid, s)
                added.append((fid, s))
    G.segment_scatter = recording_scatter
    try:
        c1 = mirror_counts(router)
        t0 = time.perf_counter()
        router.prepare()
        torch.cuda.synchronize()
        delta_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        G.segment_scatter = real_scatter
    c2 = mirror_counts(router)
    wave = check_scatter_wave("subscribe wave", c1, c2, epochs, epochs_now())
    mirrors = check_mirrors(torch, router)
    churn_topics = [zipf_batch(), residual_batch(
        topics_from_filters(rng, new_res + new_shape)
        + [f"v/{a}/1/2/3/4/5/6" for a in range(4) for _ in range(16)])]
    after_sub = route_checked(router, churn_topics, oracle)
    if not any(b["overflow_rows"] for b in after_sub):
        raise AssertionError("the subscribe wave produced no rows past kslot")
    churn["subscribe"] = {"filters": 2 * n_new, "bits": len(added), "prepare_ms": delta_ms,
                          **wave, "mirrors_equal": mirrors, "routed": after_sub}

    # (c) the unsubscribe wave undoes all of it
    epochs = epochs_now()
    for fid, s in added:
        subtab.remove(fid, s)
    for name in new_res + new_shape:
        index.remove(name)
    t0 = time.perf_counter()
    router.prepare()
    torch.cuda.synchronize()
    unsub_ms = 1e3 * (time.perf_counter() - t0)
    c3 = mirror_counts(router)
    wave = check_scatter_wave("unsubscribe wave", c2, c3, epochs, epochs_now())
    mirrors = check_mirrors(torch, router)
    after_unsub = route_checked(router, churn_topics, oracle)
    if any(b["overflow_rows"] for b in after_unsub):
        raise AssertionError("rows past kslot remain after the unsubscribe wave")
    churn["unsubscribe"] = {"prepare_ms": unsub_ms, **wave,
                            "mirrors_equal": mirrors, "routed": after_unsub}
    launches = dict(kernels.LAUNCHES)
    if not all(launches[k] for k in MIXED_10M_KERNELS):
        raise AssertionError(f"a kernel never launched on the mixed_10m path: {launches}")

    # delta sync against the full re-upload of every mirror
    def full_upload():
        upload(index.shapes.device_snapshot(), "cuda")
        upload(index.nfa.device_snapshot(), "cuda")
        upload(subtab.device_snapshot(), "cuda")

    churn["full_upload_ms"] = host_ms(full_upload, torch, reps=3)
    churn["delta_sync_ms"] = delta_ms
    phase("churn_10m", **churn, launches=launches, segment_status=mirror_counts(router))

    # -- kernels at mixed_10m shapes
    args = router.prepare()
    kinds, inputs = serving_kinds(torch, args, batches[-1], NFA_CFG)
    bits_call = next(c for c in scatter_calls if "sub_bitmaps" in c[0])
    kinds["segment_scatter"], scatter_info = scatter_kind(torch, bits_call)
    inputs["segment_scatter"] = scatter_info
    inputs["segment_scatter_calls"] = [
        {k: len(v) for k, v in c[1].items()} for c in scatter_calls]
    report = kernel_report(torch, kinds)
    phase("kernel_inputs_10m", **inputs)

    brk = [zipf_batch() for _ in range(3)] + [residual_batch()]
    phase("route_breakdown_10m", **route_breakdown(torch, router, brk))
    return report, launches


# -- the share_10m_csr path -------------------------------------------------


def share_filters(n_ids, n_nums) -> list:
    """bench.py's share_10m filters, device/{i}/+/{j}/#, then the groups'
    real filters device/{i}/#."""
    i = np.repeat(np.arange(n_ids), n_nums)
    j = np.tile(np.arange(n_nums), n_ids)
    filters = format_rows(["device/", (i, n_ids), "/+/", (j, n_nums), "/#"], n_ids * n_nums)
    filters += format_rows(["device/", (np.arange(n_ids), n_ids), "/#"], n_ids)
    return filters


def build_share(shards=1):
    """-> (index, subtab, grouptab, seconds per build stage). `shards`: the
    CSR table's slot-owner shards (2 for a tp = 2 mesh). Subscription
    n of the SHARE_SPF per device/{i}/+/{j}/# filter goes to slot n mod
    SHARE_SLOTS; each (name, members, ids) of SHARE_GROUPS is a
    `$share/name/device/{i}/#` subscription group for every i < ids."""
    from emqx_tpu_torch.models.router_model import GroupTable, SubscriberTable
    from emqx_tpu_torch.ops.route_index import RouteIndex

    n_ids, n_nums, n_slots = SHARE_IDS, SHARE_NUMS, SHARE_SLOTS
    t = [time.perf_counter()]
    filters = share_filters(n_ids, n_nums)
    t.append(time.perf_counter())
    index = RouteIndex()
    fids = np.asarray(index.bulk_add(filters), np.int64)
    del filters
    t.append(time.perf_counter())
    n = n_ids * n_nums
    subtab = SubscriberTable(max_subscribers=n_slots, mode="sparse", shards=shards)
    subtab.bulk_add(np.repeat(fids[:n], SHARE_SPF),
                    np.arange(n * SHARE_SPF, dtype=np.int64) % n_slots)
    t.append(time.perf_counter())
    grouptab = GroupTable(gpf=SHARE_GPF)
    for gname, members, ids in SHARE_GROUPS:
        for i in range(min(ids, n_ids)):
            gid = grouptab.ensure_group(int(fids[n + i]), f"device/{i}/#", gname)
            grouptab.set_len(gid, members)
    t.append(time.perf_counter())
    names = ("filter_strings", "route_index", "csr_table", "group_table")
    return index, subtab, grouptab, {k: b - a for k, a, b in zip(names, t, t[1:])}


def topic_batch_share(rng, n) -> list:
    """device/{zipf(1.3) i}/mid/{j}/leaf, as bench.py draws share_10m's."""
    n_ids, n_nums = SHARE_IDS, SHARE_NUMS
    return format_rows(["device/", (zipf_ids(rng, n, n_ids), n_ids), "/mid/",
                        (rng.integers(0, n_nums, size=n), n_nums), "/leaf"], n)


def pick_oracle(grouptab, matched, strategy, client_hashes=None):
    """The $share picks the host table gives for these matched rows: each
    live group lane of (row, column, slot) in flat order; round_robin picks
    (group_rr + the lane's rank among its group's earlier lanes) mod the
    member count, hash_clientid the client hash mod the member count; -1
    where the lane has no group or the group no member."""
    fg = grouptab.filter_groups
    B, M = matched.shape
    lanes = np.where((matched >= 0)[:, :, None], fg[np.maximum(matched, 0)], -1)
    lanes = lanes.reshape(B, M * fg.shape[1]).astype(np.int64)
    lens = grouptab.group_len[np.maximum(lanes, 0)].astype(np.int64)
    ok = (lanes >= 0) & (lens > 0)
    if strategy == "round_robin":
        occ = np.zeros(lanes.size, np.int64)
        seen = {}
        for i, g in enumerate(lanes.reshape(-1).tolist()):
            if g >= 0:
                occ[i] = seen.get(g, 0)
                seen[g] = occ[i] + 1
        base = grouptab.group_rr[np.maximum(lanes, 0)].astype(np.int64)
        idx = (base + occ.reshape(B, -1)) % np.maximum(lens, 1)
    elif strategy == "hash_clientid":
        idx = np.asarray(client_hashes, np.int64)[:, None] % np.maximum(lens, 1)
    else:
        raise ValueError(strategy)
    return np.where(ok, lanes, -1), np.where(ok, idx, -1)


def advance_rr(grouptab, picks) -> None:
    """What the broker does once per batch after delivering the picks
    (`SharedSub.dispatch_picked` advances a group's rr_index per delivered
    pick, `Broker._sync_group_counters` writes it back)."""
    gid = picks[0][picks[0] >= 0]
    for g, c in zip(*np.unique(gid, return_counts=True)):
        grouptab.set_rr(int(g), int(grouptab.group_rr[g]) + int(c))


def route_share_checked(router, batches, oracle, strategy="round_robin",
                        client_hashes=None) -> list:
    """Route each batch; every unflagged recipient set against the host
    oracle and every pick against `pick_oracle`; then advance the
    round-robin bases as the broker would."""
    out = []
    for topics in batches:
        t0 = time.perf_counter()
        res = router.route(topics, client_hashes=client_hashes)
        wall = time.perf_counter() - t0
        rec = check_batch(res, topics, oracle)
        want = pick_oracle(router.grouptab, res.matched, strategy, client_hashes)
        for got, w, what in zip(res.picks, want, ("pick_gid", "pick_idx")):
            if got.shape != w.shape or not np.array_equal(got, w):
                bad = np.argwhere(got != w)[:3].tolist()
                raise AssertionError(f"{strategy}: {what} differs from the oracle at {bad}")
        picked = res.picks[0][res.picks[0] >= 0]
        runs = np.unique(picked, return_counts=True)[1]
        if strategy == "round_robin":
            advance_rr(router.grouptab, res.picks)
        out.append({"strategy": strategy, "route_ms": wall * 1e3,
                    "readback_bytes": res.readback_bytes, **rec,
                    "picks": int(picked.size), "groups_picked": int(runs.size),
                    "longest_group_run": int(runs.max()) if runs.size else 0})
    return out


def check_wave(what, before, after, e0, e1, touched=None) -> dict:
    """A wave reaches each mirror whose host table moved (`touched`, by
    mirror; every mirror when not given) as scatters, or, for a rebuilt
    small array such as a hot segment, a re-upload of that array alone: a
    full resync exactly where the table's epoch moved (growth, rehash, an
    absorb). A mirror whose table did not move is not touched at all."""
    full = moved(before, after, "full_resyncs")
    deltas = moved(before, after, "delta_launches")
    arrays = moved(before, after, "array_resyncs")
    grown = {m: e1[m] != e0[m] for m in e0}
    for m in full:
        t = touched is None or touched[m]
        if full[m] != int(grown[m]) or (t and not grown[m] and deltas[m] + arrays[m] < 1) \
                or (not t and full[m] + deltas[m] + arrays[m]):
            raise AssertionError(f"{what}: {m} full {full[m]}, delta {deltas[m]}, "
                                 f"arrays {arrays[m]}, epoch moved {grown[m]}, "
                                 f"table moved {t}")
    return {"full_resyncs": full, "delta_launches": deltas, "array_resyncs": arrays,
            "epoch_moved": grown}


def sparse_work(torch, csr, matched, kslot, kg):
    """Per batch, the packed slot words the window gathers, the matched
    fids, the hot entries and the live candidates: the CSR gather's
    data-dependent work, for its bound."""
    ln = csr["csr_len"][0].to(torch.int64)
    has = matched >= 0
    fl = torch.where(has, ln[matched.clamp(min=0)], torch.zeros_like(matched, dtype=torch.int64))
    total = fl.sum(dim=1)
    return {"window_words": int(total.clamp(max=kg).sum()), "fids": int(has.sum()),
            "hot_entries": int(csr["hot_fid"].shape[1]),
            "rows_past_window": int((total > kg).sum())}


def share_kinds(torch, router, args, topics):
    """The share path's kernels on one batch: tokenize and shape_match (for
    the composite's bound), sparse_fanout_slots, occurrence_index, and
    share_pick under each of the five strategies."""
    from emqx_tpu_torch.models import router_model as R
    from emqx_tpu_torch.ops import csr_table as C
    from emqx_tpu_torch.ops import shape_index as S
    from emqx_tpu_torch.ops import tokenizer as T

    kinds, inputs = serving_kinds(torch, args, topics)
    dev = router.device
    kslot = args.kslot
    kg = 2 * kslot  # the router's gather window
    mat, lens, _ = T.encode_topics(topics, MAX_BYTES)
    h1, h2, nw, dl = T.tokenize(torch.from_numpy(mat).to(dev),
                                torch.from_numpy(lens).to(dev), args.salt, MAX_LEVELS)
    matched = S.shape_match(args.tables, args.m_active, h1, h2, nw, dl)
    csr = {k: args.tables[k] for k in C.CSR_KEYS}
    B, K = matched.shape
    sp = C.sparse_fanout_slots(csr, matched, kslot, kg)
    work = sparse_work(torch, csr, matched, kslot, kg)
    live = int(sp[3].sum())
    H = work["hot_entries"]
    kinds["sparse_fanout_slots"] = dict(
        kernel=lambda: C.sparse_fanout_slots(csr, matched, kslot, kg),
        plain=lambda: C.sparse_fanout_slots_plain(csr, matched, kslot, kg),
        out=sp,
        # fids in, two region words per live fid, the gathered slot words,
        # the hot pairs once, slots + count + overflow + live out
        bytes=4 * B * K + 8 * work["fids"] + 4 * work["window_words"] + 8 * H
        + 4 * B * kslot + 9 * B,
        # K start compares per window position and per hot entry, and the
        # kslot-wide bitonic sort
        ops=B * (kg + H) * (K + 2) + B * kslot * int(np.log2(kslot)) ** 2,
    )
    gt = args.group_tables
    gpf = gt["filter_groups"].shape[1]
    n = B * K * gpf
    lanes, _ = R._group_lanes(gt, matched)
    flat = lanes.reshape(-1).contiguous()
    live_lanes = int((lanes >= 0).sum())
    gcap = gt["group_len"].shape[0]
    occ = R.occurrence_index(flat, gcap=gcap)
    kinds["occurrence_index"] = dict(
        kernel=lambda: R.occurrence_index(flat, gcap=gcap),
        plain=lambda: R.occurrence_index_plain(flat),
        out=occ,
        bytes=8 * n,  # a gid in and a rank out per lane
        ops=4 * n,  # a range check, a count, a prefix and an add per lane
    )
    rng = np.random.default_rng(SEED + 1)
    pick_in = [torch.from_numpy(rng.integers(0, 1 << 32, B, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)
               for _ in range(3)]
    fids_live = int((matched >= 0).sum())
    for sname, sid in R.STRATEGY_IDS.items():
        out = R.share_pick(gt, matched, *pick_in, strategy=sid)
        kinds[f"share_pick/{sname}"] = dict(
            name="share_pick",
            # round_robin launches the kernel for the group lanes first
            per_call={"share_pick_kernel": 2 if sid == 1 else 1},
            kernel=lambda sid=sid: R.share_pick(gt, matched, *pick_in, strategy=sid),
            plain=lambda sid=sid: R.share_pick_plain(gt, matched, *pick_in, strategy=sid),
            out=out,
            # fids and the three per-row inputs in, one filter_groups row
            # per live fid, two group words per live lane (three for
            # round_robin: its rank), both outputs
            bytes=4 * B * K + 12 * B + 4 * gpf * fids_live
            + (12 if sid == 1 else 8) * live_lanes + 8 * n,
            ops=12 * n,
        )
    torch.cuda.synchronize()
    inputs.update(kg=kg, group_lanes=n, live_group_lanes=live_lanes,
                  live_candidates=live, **work)
    return kinds, inputs


# the wave cut from churn_share: its rebuild is the compaction's build
SHARE_ABSORB_CUT = (
    "churn_share's storm past HOT_SERVE_MAX (the prepare folding the 80M-pair table inline) "
    "is not run: compact_share rebuilds the same table on the compaction thread instead, "
    "and the script's 1,200 s do not hold both rebuilds")


def share_path(torch, rng):
    """Phases 10-13: the CSR subscriber table and the $share picks at
    share_10m_csr. -> (kernel report, launches on the path)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import STRATEGY_IDS, DeviceRouter
    from emqx_tpu_torch.ops.csr_table import CSR_KEYS
    from emqx_tpu_torch.ops.matcher import MatcherConfig

    t0 = time.perf_counter()
    index, subtab, grouptab, secs = build_share()
    build_s = time.perf_counter() - t0
    router = DeviceRouter(
        index, subtab, MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
        grouptab=grouptab, share_strategy="round_robin", device="cuda",
    )
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if (index.residual_count != 0 or index.shapes.num_active_shapes() != 2
            or args.kslot != KSLOT or args.group_tables is None
            or not set(CSR_KEYS) <= set(args.tables)):
        raise AssertionError(f"share_10m_csr: residual {index.residual_count}, "
                             f"shapes {index.shapes.num_active_shapes()}, kslot {args.kslot}")
    shape_b = mirror_bytes({k: v for k, v in args.tables.items() if k not in CSR_KEYS})
    csr_b = mirror_bytes({k: args.tables[k] for k in CSR_KEYS})
    group_b = mirror_bytes(args.group_tables)
    phase("tables_share", filters=len(index), subscriptions=subtab.live,
          slot_universe=SHARE_SLOTS, groups=len(grouptab), gpf=grouptab.gpf,
          m_active=args.m_active, residual_count=index.residual_count, kslot=args.kslot,
          kg=2 * args.kslot, build_seconds=build_s, build_stage_seconds=secs,
          upload_seconds=upload_s,
          device_bytes={"shapes": shape_b, "csr": csr_b, "groups": group_b,
                        "total": sum(shape_b.values()) + sum(csr_b.values())
                        + sum(group_b.values())},
          reduced=[])
    oracle = Oracle(index, subtab)
    batches = [topic_batch_share(rng, BATCH) for _ in range(ROUTE_BATCHES)]
    for b in batches:
        b[: len(EDGE_TOPICS_SHARE)] = EDGE_TOPICS_SHARE

    # -- route_share: the counters are zeroed here and read after churn_share
    kernels.reset_launches()
    routed = route_share_checked(router, batches, oracle)
    router.share_strategy = STRATEGY_IDS["hash_clientid"]
    client_hashes = rng.integers(0, 1 << 32, BATCH, dtype=np.uint64).astype(np.uint32)
    routed += route_share_checked(router, batches[:1], oracle, "hash_clientid", client_hashes)
    router.share_strategy = STRATEGY_IDS["round_robin"]
    phase("route_share", batches=routed, launches=dict(kernels.LAUNCHES))

    # -- churn_share
    def state():
        return (mirror_counts(router),
                {"shapes": index.shapes.version, "nfa": index.nfa.version,
                 "bitmaps": subtab.version, "groups": grouptab.version},
                {"shapes": index.shapes.epoch, "nfa": index.nfa.epoch,
                 "bitmaps": subtab.epoch, "groups": grouptab.epoch})

    def wave(what, mutate, topics_extra):
        router.prepare()  # the last batch's round-robin bases reach the card
        c0, v0, e0 = state()
        mutate()
        t0 = time.perf_counter()
        router.prepare()
        torch.cuda.synchronize()
        sync_ms = 1e3 * (time.perf_counter() - t0)
        c1, v1, e1 = state()
        moves = check_wave(what, c0, c1, e0, e1, {m: v1[m] != v0[m] for m in v0})
        mirrors = check_mirrors(torch, router)
        topics = topic_batch_share(rng, BATCH)
        topics[: len(topics_extra)] = topics_extra
        routed = route_share_checked(router, [topics], oracle)
        return {"prepare_ms": sync_ms, **moves, "mirrors_equal": mirrors,
                "routed": routed, "hot_fill": subtab.csr.hot_fill,
                "packed_tombstones": subtab.csr.packed_tombs}

    def fid_of(i, j=None):
        return index.filter_id(f"device/{i}/#" if j is None else f"device/{i}/+/{j}/#")

    churn = {}
    hot_i = 7
    # 100 subscribers on one group filter (its rows pass kslot) and 120 on
    # bench filters: 220 pairs, inside the hot segment's 256, so the wave
    # reaches the card as one scatter
    hot_adds = [(fid_of(hot_i), 500_000 + s) for s in range(100)]
    ij = rng.integers(0, [50, SHARE_NUMS], size=(120, 2))
    hot_adds += [(fid_of(int(i), int(j)), int(s)) for (i, j), s in
                 zip(ij, rng.integers(0, SHARE_SLOTS, 120))]

    def subscribe():
        for f, s in hot_adds:
            subtab.add(f, s)

    row_topics = [f"device/{hot_i}/mid/{j}/leaf" for j in range(64)]
    row_topics += [f"device/{i}/mid/{j}/leaf" for i, j in ij]
    churn["subscribe"] = wave("subscribe wave", subscribe, row_topics)
    if not churn["subscribe"]["routed"][0]["overflow_rows"]:
        raise AssertionError("the subscribe wave produced no rows past kslot")

    n_subs = SHARE_IDS * SHARE_NUMS * SHARE_SPF
    gone = rng.choice(n_subs, size=1000, replace=False)
    gone_pairs = [(int(n // SHARE_SPF), int(n % SHARE_SLOTS)) for n in gone]

    def unsubscribe():
        for f, s in gone_pairs:
            subtab.remove(f, s)
        for f, s in hot_adds[::2]:
            subtab.remove(f, s)

    gone_topics = []
    for f, _s in gone_pairs[:300]:
        i, _plus, j = index.filter_name(f).split("/")[1:4]
        gone_topics.append(f"device/{i}/mid/{j}/leaf")
    churn["unsubscribe"] = wave("unsubscribe wave", unsubscribe, gone_topics + row_topics)
    if churn["unsubscribe"]["packed_tombstones"] < len(gone_pairs):
        raise AssertionError("the unsubscribe wave left no packed tombstones")

    def regroup():
        for i in range(50):
            grouptab.set_len(grouptab.gid_of(f"device/{i}/#", "ingest"), 8)
        grouptab.set_len(grouptab.gid_of("device/1/#", "ingest"), 0)  # empty group
        grouptab.drop_group(fid_of(3), "device/3/#", "audit")
        late = grouptab.ensure_group(fid_of(11), "device/11/#", "late")  # a recycled gid
        grouptab.set_len(late, 2)

    churn["groups"] = wave("group changes", regroup,
                           [f"device/{i}/mid/{j}/leaf" for i in (0, 1, 3, 11) for j in range(16)])
    launches = dict(kernels.LAUNCHES)
    path = ("tokenize", "shape_match", "sparse_fanout_slots", "share_pick", "occurrence_index")
    if not all(launches[k] for k in path) or launches["fanout_bitmaps"] \
            or launches["compact_fanout_slots"] or launches["occurrence_index"] % 3:
        raise AssertionError(f"share_10m_csr launches: {launches}")
    phase("churn_share", **churn, launches=launches, segment_status=mirror_counts(router),
          reduced=[SHARE_ABSORB_CUT])

    # -- kernels at share_10m_csr shapes
    args = router.prepare()
    kinds, inputs = share_kinds(torch, router, args, batches[0])
    report = kernel_report(torch, kinds)
    phase("kernel_inputs_share", **inputs)
    brk = [topic_batch_share(rng, BATCH) for _ in range(3)]
    phase("route_breakdown_share", **route_breakdown(torch, router, brk))
    # the background compaction of this table: the CSR cycle off the
    # serving path, adopted by the next prepare
    phase("compact_share", **compact_share(torch, router, index, subtab, oracle, rng))
    return report, launches


# -- the retained_5m path ----------------------------------------------------


def retained_topics(ids) -> list:
    """bench.py `bench_retained`'s topic of each stored id."""
    return [f"site/{i % RET_SITES}/dev/{i % RET_DEVIDS}/ch/{i}" for i in ids]


def mask_storm(i0: int) -> list:
    """The >64-shape storm over the store: the 64 `+`-masks of stored topic
    i0's six levels (mask 0b111111 is +/+/+/+/+/+), then four `#` shapes
    that overflow the 64-shape table into the residual NFA."""
    words = retained_topics([i0])[0].split("/")
    masks = ["/".join("+" if m >> k & 1 else w for k, w in enumerate(words))
             for m in range(64)]
    return masks + ["#", "site/#", f"site/{i0 % RET_SITES}/#", "site/+/dev/+/#"]


def mask_oracle(i0: int, n: int) -> dict:
    """Each filter of `mask_storm(i0)` -> the ids of the first n stored
    topics it matches, from the ids alone (site = i % 2048, dev = i %
    100003, ch = i; the `site`, `dev` and `ch` levels match every topic)."""
    ids = np.arange(n)
    lit = {1: ids % RET_SITES == i0 % RET_SITES, 3: ids % RET_DEVIDS == i0 % RET_DEVIDS,
           5: ids == i0}
    out = {}
    for m, f in enumerate(mask_storm(i0)[:64]):
        keep = np.ones(n, bool)
        for level, ok in lit.items():
            if not m >> level & 1:
                keep &= ok
        out[f] = np.nonzero(keep)[0]
    out.update({"#": ids, "site/#": ids, "site/+/dev/+/#": ids,
                f"site/{i0 % RET_SITES}/#": np.nonzero(lit[1])[0]})
    return out


class RetainedOracle:
    """The live store, kept apart from the index: the bulk-loaded ids (a
    removed mask) and the topics added later, by device id."""

    def __init__(self, n: int):
        self.n = n
        self.removed = np.zeros(n, bool)
        self.extra = {}  # device id -> topics added after the bulk load
        self.n_extra = 0
        self.dollar = []  # `$` topics, which no wildcard at the root matches

    def add(self, topic: str) -> None:
        if topic.startswith("$"):
            self.dollar.append(topic)
            return
        self.extra.setdefault(int(topic.split("/")[3]), []).append(topic)
        self.n_extra += 1

    def live_plain(self) -> int:
        return self.n - int(self.removed.sum()) + self.n_extra

    def check(self, index, res, storm) -> int:
        """Every `site/+/dev/{d}/ch/#` of the storm holds exactly the live
        topics with device id d, and `#` (when asked) every live topic but
        the `$` ones: compared as topic sets through the index's rows, so a
        padding, removed or reused row cannot pass. -> matched pairs."""
        pairs = 0
        for f in storm:
            rows = res[f]
            got = [index.topic_at(int(r)) for r in rows]
            if f == "#":
                if (len(rows) != self.live_plain() or None in got
                        or any(t.startswith("$") for t in got)
                        or len(np.unique(rows)) != len(rows)):
                    raise AssertionError(f"#: {len(rows)} rows for {self.live_plain()} topics")
            else:
                d = int(f.split("/")[3])
                base = np.arange(d, self.n, RET_DEVIDS)
                want = set(retained_topics(base[~self.removed[base]]))
                want.update(self.extra.get(d, ()))
                if len(got) != len(want) or set(got) != want:
                    raise AssertionError(f"{f}: {len(got)} rows, not the oracle's {len(want)}")
            pairs += len(rows)
        return pairs


def check_chunk_mirrors(torch, index) -> int:
    """Copy every chunk mirror back and compare it bit for bit with the
    host chunk. -> bytes compared."""
    chunks = index._ensure_chunks()
    if len(chunks) != len(index._host_b):
        raise AssertionError(f"{len(chunks)} chunk mirrors for {len(index._host_b)} chunks")
    for c, (dev, host) in enumerate(zip(chunks, index._host_b)):
        got = dev.cpu().numpy()
        if got.dtype != np.uint8 or not np.array_equal(got, host):
            raise AssertionError(f"chunk mirror {c} differs from the host chunk")
    return sum(h.nbytes for h in index._host_b)


def storm_stages(torch, index, filters):
    """One `match_many`, call by call, each stage ending in a synchronize
    (host clock): the storm's table build and upload, the chunk sync, the
    launches to completion, the readback and the host decode. -> (result,
    {stage: ms}, shape tables, launch kwargs)."""
    from emqx_tpu_torch.models.retained_index import retained_step

    t = [time.perf_counter()]
    _idx, fids, tables, nfa_tables, kw = index._build_tables(filters, floor=1)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    chunks = index._ensure_chunks()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    outs = [retained_step(tables, nfa_tables, d, **kw) for d in chunks]
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    mats = [m.cpu().numpy() for m in outs]
    t.append(time.perf_counter())
    res = index._decode_storm(fids, filters, mats, len(index._by_row))
    t.append(time.perf_counter())
    names = ("table_build", "chunk_sync", "launches", "readback", "decode")
    return res, {f"{k}_ms": 1e3 * (b - a) for k, a, b in zip(names, t, t[1:])}, tables, kw


def storms_equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(np.array_equal(a[f], b[f]) for f in a)


def retained_kinds(torch, chunks, tables, kw, scatter_call, wide):
    """The storm's kernels on the store's chunks (uint8 [CHUNK, 32]) and its
    8,192-filter table, shape_match on the wide storm's table (`wide`: its
    shape tables and launch kwargs; 64 table shapes, the other four in the
    residual lane), and the byte scatter on a churn's deltas.
    row_lengths is timed over the chunks in turn, as a storm reads them:
    each read once, cold in the 50 MB L2 (the other kernels on chunk 0)."""
    from emqx_tpu_torch.models import retained_index as RI

    bm = chunks[0]
    N, MB = bm.shape
    ln = RI.row_lengths(bm)
    turn = itertools.cycle(chunks)
    match, _tok, matched, counts = match_kinds(torch, tables, kw["m_active"], bm, ln,
                                               kw["salt"], kw["max_levels"])
    wide_tables, wide_kw = wide
    wide_match, _wtok, _wm, wide_counts = match_kinds(
        torch, wide_tables, wide_kw["m_active"], bm, ln, wide_kw["salt"],
        wide_kw["max_levels"])
    narrow = RI.narrow_i16(matched)
    n = matched.numel()
    kinds = {
        "row_lengths": dict(
            kernel=lambda: RI.row_lengths(next(turn)),
            plain=lambda: RI.row_lengths_plain(bm),
            library=lambda: torch.count_nonzero(next(turn), dim=1),
            out=ln,
            bytes=N * MB + 4 * N,
            ops=N * MB,
        ),
        "tokenize/chunk": {**match["tokenize"], "name": "tokenize"},
        "shape_match/chunk": {**match["shape_match"], "name": "shape_match"},
        "shape_match/wide_chunk": {**wide_match["shape_match"], "name": "shape_match"},
        "narrow_i16": dict(
            kernel=lambda: RI.narrow_i16(matched),
            plain=lambda: RI.narrow_i16_plain(matched),
            library=lambda: matched.to(torch.int16),
            out=narrow,
            bytes=6 * n,
            ops=n,
        ),
    }
    kinds["segment_scatter/uint8"], scatter_info = scatter_kind(torch, scatter_call)
    kinds["segment_scatter/uint8"]["name"] = "segment_scatter"
    inputs = {"rows": N, "bucket": MB, "row_lengths_chunks": len(chunks),
              "m_active": kw["m_active"], "narrow": kw["narrow"],
              "topic_bytes": int(ln.sum()), **counts, "segment_scatter": scatter_info,
              "wide": {"m_active": wide_kw["m_active"], **wide_counts}}
    return kinds, inputs


def retained_path(torch, rng):
    """Phases 15-18: the retained replay storm at BASELINE config 5.
    -> (kernel report, launches on the path, the mixed_1m router it built,
    the churned store, which broker_1m's feed phases ride)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.retained_index import (
        CHUNK,
        DeviceRetainedIndex,
        retained_step,
        retained_step_plain,
    )
    from emqx_tpu_torch.models.router_model import DeviceRouter
    from emqx_tpu_torch.ops import segments as G
    from emqx_tpu_torch.ops.matcher import MatcherConfig

    n = RET_N
    t = [time.perf_counter()]
    topics = retained_topics(range(n))
    t.append(time.perf_counter())
    index = DeviceRetainedIndex(max_bytes=RET_MAX_BYTES, max_levels=MAX_LEVELS,
                                device="cuda")
    if index.bulk_add(topics) != n:
        raise AssertionError("bulk_add refused topics")
    t.append(time.perf_counter())
    chunks = index._ensure_chunks()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    del topics
    first_chunks = chunks  # this generation stays [CHUNK, 32] for the kernel phases
    dev_bytes = sum(c.numel() * c.element_size() for c in chunks)
    # the longest topic has 31 bytes: a 32-byte bucket, 5 x 2^20 x 32 bytes
    n_chunks = -(-n // CHUNK)
    if (index.bucket, len(chunks), dev_bytes) != (32, n_chunks, n_chunks * CHUNK * 32):
        raise AssertionError(f"bucket {index.bucket}, {len(chunks)} chunks, {dev_bytes} B")
    phase("tables_retained", topics=len(index), chunks=len(chunks), chunk_rows=CHUNK,
          bucket=index.bucket, device_bytes=dev_bytes,
          build_stage_seconds={k: b - a for k, a, b in zip(
              ("topic_strings", "bulk_add", "first_sync"), t, t[1:])},
          segment_status=index._seg.counters(), reduced=[])

    # -- storm_retained: the counters are zeroed here and read after
    # fused_retained
    storm = [f"site/+/dev/{d}/ch/#" for d in range(RET_STORM)]
    oracle = RetainedOracle(n)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = index.match_many(storm)
    storm_ms = 1e3 * (time.perf_counter() - t0)
    for d, f in enumerate(storm):
        if not np.array_equal(res[f], np.arange(d, n, RET_DEVIDS)):
            raise AssertionError(f"{f}: rows differ from the oracle's")
    pairs = sum(len(v) for v in res.values())
    # 50 rows for each d < 8,192: 409,600 pairs
    if pairs != sum(len(range(d, n, RET_DEVIDS)) for d in range(RET_STORM)) \
            or oracle.check(index, res, storm) != pairs:
        raise AssertionError(f"{pairs} matched pairs")
    res2, stages, storm_tables, storm_kw = storm_stages(torch, index, storm)
    if not storms_equal(res2, res) or not storm_kw["narrow"]:
        raise AssertionError("the staged storm differs from match_many's")
    i0 = 12345
    wide = mask_storm(i0)
    _idx, _f, wide_tables, wide_nfa, wide_kw = index._build_tables(wide, floor=1)
    if wide_nfa is None or _idx.residual_count != 4 or not wide_kw["with_nfa"]:
        raise AssertionError(f"the wide storm has no residual lane: {wide_kw}")
    t0 = time.perf_counter()
    wres = index.match_many(wide)
    wide_ms = 1e3 * (time.perf_counter() - t0)
    want = mask_oracle(i0, n)
    for f in wide:
        if not np.array_equal(wres[f], want[f]):
            raise AssertionError(f"wide storm {f}: {len(wres[f])} rows, oracle {len(want[f])}")
    phase("storm_retained", filters=RET_STORM, pairs=pairs, match_many_ms=storm_ms,
          stages=stages, m_active=storm_kw["m_active"], narrow=storm_kw["narrow"],
          wide_storm={"filters": len(wide), "shapes": 68, "residual": _idx.residual_count,
                      "lanes": wide_kw["m_active"] + 64, "pairs": sum(map(len, wres.values())),
                      "match_many_ms": wide_ms},
          launches=dict(kernels.LAUNCHES))
    del wres, want, res2, _idx

    # -- churn_retained: after each step the store answers the storm (plus
    # `#`) as the oracle says, and every chunk mirror equals its host chunk
    recheck = storm + ["#"]
    churn = {}
    scatter_calls = []
    real_scatter = G.segment_scatter

    def recording_scatter(flats, idxs, vals):
        scatter_calls.append((dict(flats), dict(idxs), dict(vals)))
        return real_scatter(flats, idxs, vals)

    def churn_step(what, mutate, want_moves, record=False):
        c0 = index._seg.counters()
        s0 = kernels.LAUNCHES["segment_scatter"]
        before = index._ensure_chunks()
        t0 = time.perf_counter()
        mutate()
        mutate_ms = 1e3 * (time.perf_counter() - t0)
        if record:
            G.segment_scatter = recording_scatter
        try:
            t0 = time.perf_counter()
            after = index._ensure_chunks()
            torch.cuda.synchronize()
            sync_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            G.segment_scatter = real_scatter
        c1 = index._seg.counters()
        moves = {k: c1[k] - c0[k] for k in c0}
        moves["segment_scatter_launches"] = kernels.LAUNCHES["segment_scatter"] - s0
        if moves != want_moves:
            raise AssertionError(f"{what}: {moves}, expected {want_moves}")
        kept = [c for c, (a, b) in enumerate(zip(before, after)) if a is b]
        checked = check_chunk_mirrors(torch, index)
        t0 = time.perf_counter()
        res = index.match_many(recheck)
        recheck_ms = 1e3 * (time.perf_counter() - t0)
        step_pairs = oracle.check(index, res, recheck)
        churn[what] = {"mutate_ms": mutate_ms, "sync_ms": sync_ms, **moves,
                       "chunks_kept": kept, "chunks": len(after), "bucket": index.bucket,
                       "mirror_bytes_compared": checked, "recheck_ms": recheck_ms,
                       "pairs": step_pairs}
        return res

    # (a) 1,000 adds (three `$` topics) and 1,000 removes: row deltas, one
    # byte scatter over the touched chunks
    adds = [f"site/{k % RET_SITES}/dev/{k % RET_STORM}/ch/n{k}" for k in range(997)]
    adds += ["$SYS/broker/retained", "$SYS/site/1/dev/1/ch/1", "$x/1/dev/1/ch/1"]
    laps = (n - RET_STORM) // RET_DEVIDS
    gone = rng.permutation(np.unique(rng.integers(0, RET_STORM, size=4000)
                                     + RET_DEVIDS * rng.integers(0, laps, size=4000)))[:1000]
    if len(gone) != 1000:
        raise AssertionError("fewer than 1,000 distinct topics to remove")

    def add_and_remove():
        for tp in adds:
            if not index.add(tp):
                raise AssertionError(f"add refused {tp!r}")
            oracle.add(tp)
        for tp in retained_topics(gone):
            index.remove(tp)
        oracle.removed[gone] = True

    churn_step("add_remove_1000", add_and_remove,
               {"full_resyncs": 0, "delta_launches": 1, "array_resyncs": 0,
                "segment_scatter_launches": G.SCATTER_LAUNCHES}, record=True)
    if len(scatter_calls) != 1 \
            or any(t.dtype != torch.uint8 for t in scatter_calls[0][0].values()):
        raise AssertionError(f"the scatter touched {[sorted(c[0]) for c in scatter_calls]}")
    churn["add_remove_1000"]["scatter_arrays"] = sorted(scatter_calls[0][0])

    # (b) a bulk load that fills chunk 4 and starts chunk 5: those two
    # chunks re-upload alone
    bulk = [f"site/{k % RET_SITES}/dev/{k % RET_STORM}/ch/b{k}" for k in range(RET_BULK)]

    def bulk_add():
        index.bulk_add(bulk)
        for tp in bulk:
            oracle.add(tp)

    first = len(index._by_row) // CHUNK  # chunk 4, which the load fills
    last = (len(index._by_row) + RET_BULK - 1) // CHUNK  # chunk 5, which it starts
    if last != first + 1:
        raise AssertionError(f"the bulk load spans chunks {first}..{last}")
    churn_step("bulk_add", bulk_add,
               {"full_resyncs": 0, "delta_launches": 0, "array_resyncs": 2,
                "segment_scatter_launches": 0})
    if churn["bulk_add"]["chunks_kept"] != list(range(first)) or len(index._host_b) != last + 1:
        raise AssertionError(f"bulk add: {churn['bulk_add']}")

    # (c) one topic past the 32-byte bucket: the bucket doubles, and that
    # costs exactly one full resync
    long_topic = f"site/1/dev/{RET_STORM - 1}/ch/" + "x" * 24

    def grow():
        if not index.add(long_topic):
            raise AssertionError("the long topic was refused")
        oracle.add(long_topic)

    res = churn_step("grow_bucket", grow,
                     {"full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0,
                      "segment_scatter_launches": 0})
    if index.bucket != 64:
        raise AssertionError(f"bucket {index.bucket} after the long topic")
    phase("churn_retained", **churn, topics=len(index),
          device_bytes=sum(c.numel() for c in index._ensure_chunks()),
          segment_status=index._seg.counters(), launches=dict(kernels.LAUNCHES))

    # -- fused_retained: the storm rides one routed batch of the mixed_1m
    # router (BASELINE config 3, as its path builds it)
    t0 = time.perf_counter()
    r_index, subtab = build_mixed_1m()
    build_s = time.perf_counter() - t0
    router = DeviceRouter(
        r_index, subtab, MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
        device="cuda",
    )
    args = router.prepare()
    topics = topic_batch_1m(rng, BATCH)
    topics[: len(EDGE_TOPICS)] = EDGE_TOPICS
    job = index.prepare_storm(recheck)
    torch.cuda.synchronize()
    fused = []
    events, _wall = profiled(
        torch, lambda: fused.append(router.route_prepared(args, topics, None, job)), 1)
    d2h = [(e.key, e.count) for e in events if "Memcpy DtoH" in e.key]
    if sum(c for _k, c in d2h) != 1:
        raise AssertionError(f"the fused call copied device->host {d2h}")
    got = fused[0]
    plain = router.route_prepared(args, topics)
    for k in ("matched", "mcount", "flags", "bitmaps", "slots", "slot_count", "overflow"):
        a, b = getattr(got, k), getattr(plain, k)
        if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
            raise AssertionError(f"fused route half: {k} differs from the unfused route")
    if got.dense_index != plain.dense_index or plain.retained is not None:
        raise AssertionError("fused route half: dense rows differ")
    alone = index.match_many(recheck)
    if not storms_equal(got.retained, alone) or not storms_equal(alone, res):
        raise AssertionError("the fused storm differs from match_many's")
    launches = dict(kernels.LAUNCHES)
    path = ("row_lengths", "narrow_i16", "tokenize", "shape_match", "vocab_lookup",
            "nfa_walk", "segment_scatter", "fanout_bitmaps", "compact_fanout_slots")
    if not all(launches[k] for k in path):
        raise AssertionError(f"a kernel never launched on the retained path: {launches}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # three calls of each, host clock, each ending in a synchronize
    fused_ms = [timed(lambda: router.route_prepared(args, topics, None, job))[1]
                for _ in range(3)]
    route_ms = [timed(lambda: router.route_prepared(args, topics))[1] for _ in range(3)]
    alone_ms = [timed(lambda: index.match_many(recheck))[1] for _ in range(3)]
    _r, alone_stages, _t, _k = storm_stages(torch, index, recheck)
    phase("fused_retained", batch=BATCH, chunks=len(job.chunks), storm_filters=len(recheck),
          router_build_seconds=build_s, d2h_copies=d2h,
          readback_bytes=got.readback_bytes, route_readback_bytes=plain.readback_bytes,
          pairs=sum(map(len, got.retained.values())), fused_ms=fused_ms,
          route_ms=route_ms, match_many_ms=alone_ms, match_many_stages=alone_stages,
          launches=launches)
    del r_index, subtab, args, job, alone, res, got, fused, _r
    gc.collect()
    torch.cuda.empty_cache()

    # -- kernels on the store's first chunk, at its first generation's shape
    kinds, inputs = retained_kinds(torch, first_chunks, storm_tables, storm_kw,
                                   scatter_calls[0], (wide_tables, wide_kw))
    # and one whole storm launch against the plain twins' composition, for
    # both storms (the wide one through the residual lane at 2^20 rows)
    for what, tabs, nfa_tabs, kw in (("storm", storm_tables, None, storm_kw),
                                     ("wide_storm", wide_tables, wide_nfa, wide_kw)):
        got = retained_step(tabs, nfa_tabs, first_chunks[0], **kw)
        want = retained_step_plain(tabs, nfa_tabs, first_chunks[0], **kw)
        err = max_abs_err(got, want, torch)
        if err:
            raise AssertionError(f"{what}: retained_step != its plain composition ({err})")
        inputs[f"{what}_step_equal_plain"] = {"lanes": got.shape[1], "dtype": str(got.dtype),
                                              "hits": int((got >= 0).sum())}
    report = kernel_report(torch, kinds, plain_reps=RET_PLAIN_REPS)
    phase("kernel_inputs_retained", **inputs)
    return report, launches, router, index


# -- the session_1m path -----------------------------------------------------


class Counters:
    """The store's metrics sink (`inc`, `gauge_set`), read by the checks."""

    def __init__(self):
        self.values = {}

    def inc(self, name, n=1):
        self.values[name] = self.values.get(name, 0) + n

    def gauge_set(self, name, v):
        self.values[name] = v

    def get(self, name):
        return self.values.get(name, 0)


class FloodSink:
    """A channel-shaped resend sink: the store hands it every due row of its
    sessions in one call (`_store_resend_batch`); it records the packet
    ids and the time of its first call."""

    def __init__(self):
        self.pids = []
        self.first = None

    def resend(self, pid, st, msg):  # bound per slot; the batch path is taken
        raise AssertionError("the store must take the batch path")

    def _store_resend_batch(self, items):
        if self.first is None:
            self.first = time.perf_counter()
        self.pids.extend(pid for pid, _st, _m in items)
        return [True] * len(items)


def flood_plan(n: int, k: int, oplog_max: int):
    """-> (sweeps, full uploads, op-log length after the last commit) of a
    redelivery flood of n due sessions, k a sweep, derived from the store's
    code: the install's epoch bump makes the first rider upload in full;
    each commit appends its sweep's touches to the op-log (`touch_many`),
    unless that would pass oplog_max, when it bumps the epoch instead and
    the next rider uploads in full."""
    sweeps = -(-n // k)
    uploads, log, bump = 0, 0, True
    for s in range(sweeps):
        if bump:
            uploads, log, bump = uploads + 1, 0, False
        touched = min(k, n - s * k)
        if log + touched > oplog_max:
            bump, log = True, 0
        else:
            log += touched
    return sweeps, uploads, log


def check_session_mirror(torch, store) -> dict:
    """The sessions mirror against the host lanes, bit for bit, once the
    op-log suffix it has not taken yet (the last commit's redelivery
    stamps, which ride the next rider) is applied to a host copy of it."""
    from emqx_tpu_torch.ops.session_table import RESYNC

    torch.cuda.synchronize()
    mirror = {k: v.cpu().numpy().copy() for k, v in store.manager._arrays.items()}
    suffix = store.table.oplog[store.manager._pos :]
    if any(name == RESYNC or name != "sess_ts" for name, _i, _v in suffix):
        raise AssertionError("the pending suffix holds more than redelivery stamps")
    if suffix:
        idx = np.fromiter((i for _n, i, _v in suffix), np.int64, len(suffix))
        mirror["sess_ts"][idx] = np.fromiter((v for _n, _i, v in suffix), np.int64,
                                             len(suffix))
    host = store.table.device_snapshot()
    if sorted(mirror) != sorted(host):
        raise AssertionError(f"mirror lanes {sorted(mirror)}")
    for k, v in host.items():
        if mirror[k].dtype != v.dtype or not np.array_equal(mirror[k], v):
            raise AssertionError(f"the sessions mirror differs from the host lane {k}")
    return {"lanes": len(host), "bytes": sum(v.nbytes for v in host.values()),
            "pending_stamps": len(suffix)}


def traced_complete(torch, fn, pad_s: float):
    """fn() once under torch.profiler, `pad_s` seconds of host sleep on
    each side of it inside the trace. -> (its result, the trace's
    "Memcpy DtoH" events as (key, count), whether the trace is complete:
    it holds a device event for every kernel launch fn made, by
    `kernels.LAUNCHES` and `KERNEL_SYMBOLS`). Late in a long process a
    trace loses its first device records (kernel and copy records apart,
    the more the older the process; PERF.md), so a short trace can lose
    them all and a caller retakes an incomplete trace."""
    from torch.profiler import ProfilerActivity, profile

    from emqx_tpu_torch import kernels

    syms = {s for v in KERNEL_SYMBOLS.values() for s in ((v,) if isinstance(v, str) else v)}
    n0 = sum(kernels.LAUNCHES.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    launched = sum(kernels.LAUNCHES.values()) - n0
    events = prof.key_averages()
    seen = sum(e.count for e in events
               if e.self_device_time_total > 0 and any(s in e.key for s in syms))
    d2h = [(e.key, e.count) for e in events if "Memcpy DtoH" in e.key]
    return out, d2h, seen == launched > 0


def session_ride(torch, store, router, args, topics, profile=False) -> dict:
    """One rider through `route_prepared(..., session=rider)`: the sweep
    lists against the host oracle taken just before the launch, the route
    half against the unfused route of the same batch, then the commit and
    the mirror check. -> stage times and counts."""
    t0 = time.perf_counter()
    rider = store.take_rider()
    t1 = time.perf_counter()
    if rider is None:
        raise AssertionError("no rider")
    now, retry = int(rider.clock[0]), int(rider.clock[1])
    due_want = store.table.due_rows(now, retry)
    exp_want = store.table.expired_slots(now)
    d2h = None
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if profile:
        # the CUPTI trace counts the call's device->host copies; a trace
        # that lost a kernel's events, or shows no copy, is taken again
        # (the same call on the same rider) with longer pads; more than
        # one copy fails at once, and so does a fifth incomplete trace
        for attempts, pad in enumerate((0.5, 1.0, 2.0, 4.0, 4.0), 1):
            res, d2h, complete = traced_complete(
                torch, lambda: router.route_prepared(args, topics, session=rider), pad)
            copies = sum(c for _k, c in d2h)
            if copies > 1 or (complete and copies == 1):
                break
        if not complete or copies != 1:
            raise AssertionError(f"the rider-carrying call copied device->host {d2h}; "
                                 f"trace {attempts} complete: {complete}")
    else:
        res = router.route_prepared(args, topics, session=rider)
    t3 = time.perf_counter()
    plain = router.route_prepared(args, topics)
    t4 = time.perf_counter()
    for k in ("matched", "mcount", "flags", "bitmaps", "slots", "slot_count", "overflow"):
        a, b = getattr(res, k), getattr(plain, k)
        if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
            raise AssertionError(f"fused route half: {k} differs from the unfused route")
    if res.dense_index != plain.dense_index:
        raise AssertionError("fused route half: dense rows differ")
    out = res.session
    K = rider.sweep_k
    if K:
        for what, got, count, want in (("due", out.due, out.due_count, due_want),
                                       ("expired", out.expired, out.expired_count, exp_want)):
            head = want[:K]
            if got.dtype != np.int32 or got.shape != (K,) or count != len(want) \
                    or not np.array_equal(got[: len(head)], head) \
                    or (got[len(head):] != -1).any():
                raise AssertionError(f"{what}: {count} listed against the oracle's {len(want)}")
    elif out.due is not None:
        raise AssertionError("a sweep-less rider returned sweep lists")
    t5 = time.perf_counter()
    store.commit(rider, out)
    t6 = time.perf_counter()
    return {
        "rider": rider, "out": out, "due": out.due, "d2h": d2h,
        "trace_attempts": attempts if profile else 0,
        "writes": {k: int(len(v)) for k, v in rider.idxs.items()}, "rows": rider.rows,
        "sweep_k": K, "due_count": out.due_count, "expired_count": out.expired_count,
        "readback_bytes": res.readback_bytes, "route_readback_bytes": plain.readback_bytes,
        "ms": {"take_rider": 1e3 * (t1 - t0), "fused": 1e3 * (t3 - t2),
               "route": 1e3 * (t4 - t3), "commit": 1e3 * (t6 - t5)},
    }


class BatchSink:
    """bench.py's BatchSink (bench.py:2894-2928): a channel-shaped resend
    sink. The store hands it all of its sessions' due rows in one call
    (`_store_resend_batch`), and it pays the real per-row serialization:
    one `serialize` pass (the port's `mqtt.slab_serializer.
    serialize_pub_slab`) building every dup PUBLISH frame. It records the
    count, the frame bytes, the packet ids and the time of its first call."""

    def __init__(self, serialize):
        self.serialize = serialize
        self.count = 0
        self.bytes = 0
        self.first = None
        self.pids = []

    def resend(self, pid, st, msg):  # bound per slot; the batch path is taken
        raise AssertionError("the store must take the batch path")

    def _store_resend_batch(self, items):
        pubs = [(m.topic_bytes(), m.payload_view(), m.qos, m.retain, True, pid, None)
                for pid, _st, m in items]
        slab, _offs = self.serialize(pubs)
        self.count += len(items)
        self.bytes += len(slab)
        self.pids.extend(pid for pid, _st, _m in items)
        if self.first is None:
            self.first = time.perf_counter()
        return [True] * len(items)


def copy_capture(state: dict) -> dict:
    """A store capture with copies of its table, slab and registry:
    `install` takes a capture's objects as its own, and a store installed
    from one mutates them."""
    import copy

    table = copy.copy(state["table"])
    for name in table.device_snapshot():
        setattr(table, name, getattr(table, name).copy())
    table.oplog = list(table.oplog)
    return {**state, "table": table, "slab": list(state["slab"]),
            "free_mids": list(state["free_mids"]), "slots": dict(state["slots"]),
            "slot_cid": list(state["slot_cid"]), "free_slots": list(state["free_slots"])}


async def storm_drive(broker, store, ingest, message, sink, n: int, max_sweeps: int) -> dict:
    """bench.py's session_storm flood (bench.py:2938-2965) through a broker
    with `store` attached: `ingest` (a `BatchIngest` of the broker, not yet
    started) is attached and started, one `submit` warms (a one-message
    batch, below `min_tpu_batch`: a CPU batch, which takes no rider, as in
    bench.py; the first sweep's rider makes the full upload, the segment
    replay), then until `sink` has seen n redeliveries:
    `request_sweep()`, SESS_DRIVE drive/{i} enqueues, `gather`. One batch
    of SESS_DRIVE more, with no sweep asked, then carries the last commit's
    redelivery stamps, and the ingest stops. Takes either package's
    objects. -> sweeps and the flood loop's wall seconds."""
    import asyncio

    broker.ingest = ingest
    ingest.start()
    await ingest.submit(message(topic="drive/warm", payload=b"w", qos=0))
    t0 = time.perf_counter()
    sweeps = 0
    while sink.count < n:
        if sweeps >= max_sweeps:
            raise AssertionError(f"{sweeps} sweeps redelivered {sink.count} of {n}")
        store.request_sweep()
        await asyncio.gather(*[ingest.enqueue(message(topic=f"drive/{i}", payload=b"p"))
                               for i in range(SESS_DRIVE)])
        sweeps += 1
    wall = time.perf_counter() - t0
    await asyncio.gather(*[ingest.enqueue(message(topic=f"drive/{i}", payload=b"f"))
                           for i in range(SESS_DRIVE)])
    await ingest.stop()
    broker.ingest = None
    return {"sweeps": sweeps, "wall_s": wall}


class RideProbe:
    """Wraps a store's `take_rider` and `commit` (instance attributes over
    the methods the broker calls): each call's milliseconds, and per ride
    the rows and sweep it carried and the launches of the stage's kernels
    between its take and its commit (`kernels.LAUNCHES` deltas, exact
    while one batch is in flight); and the row writes of every rider
    counted from the op-log suffix it takes (distinct (lane, index) pairs
    since the mirror's position), to hold the rider's own count against."""

    names = ("session_sweep", "segment_scatter")

    def __init__(self, store):
        from emqx_tpu_torch import kernels
        from emqx_tpu_torch.ops.session_table import RESYNC

        names = self.names
        self.store = store
        self.take_ms, self.commit_ms, self.rides = [], [], []
        self.suffix_rows = 0
        self._at = None
        take, commit = store.take_rider, store.commit

        def take_rider():
            m, t = store.manager, store.table
            suffix = t.oplog[m._pos:] if m._epoch == t.epoch else []
            if any(name == RESYNC for name, _i, _v in suffix):
                raise AssertionError("an array resync in a rider's suffix")
            t0 = time.perf_counter()
            rider = take()
            self.take_ms.append(1e3 * (time.perf_counter() - t0))
            if rider is not None:
                # a take that resynced (an epoch moved) carries no writes
                if rider.epoch == m._epoch and suffix:
                    self.suffix_rows += len({(name, i) for name, i, _v in suffix})
                self._at = {k: kernels.LAUNCHES[k] for k in names}
            return rider

        def commit_(rider, out):
            self.rides.append({"rows": rider.rows, "sweep": bool(rider.sweep_k),
                               **{k: kernels.LAUNCHES[k] - self._at[k] for k in names}})
            t0 = time.perf_counter()
            commit(rider, out)
            self.commit_ms.append(1e3 * (time.perf_counter() - t0))

        store.take_rider, store.commit = take_rider, commit_

    def close(self) -> None:
        del self.store.take_rider, self.store.commit

    def per_ride(self) -> dict:
        """{kernel: {launches in a ride: rides}}."""
        out = {}
        for k in self.names:
            c = collections.Counter(r[k] for r in self.rides)
            out[k] = {str(v): c[v] for v in sorted(c)}
        return out

    def p50(self) -> dict:
        return {"take_rider_ms": float(np.median(self.take_ms)),
                "commit_ms": float(np.median(self.commit_ms))}


def session_broker(clock):
    """bench.py's resumed broker (bench.py:2886-2891): `Broker(router=
    Router(min_tpu_batch=32), hooks=Hooks())` with a fresh store attached
    (capacity 64, sweep_k 16,384, retry 1 s, the frozen `clock`, the
    broker's metrics) and one subscription, drv on drive/#.
    -> (broker, store)."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.hooks import Hooks
    from emqx_tpu_torch.broker.router import Router
    from emqx_tpu_torch.broker.session_store import SessionStore
    from emqx_tpu_torch.mqtt import packet as pkt

    b = Broker(router=Router(min_tpu_batch=SESS_MIN_BATCH), hooks=Hooks())
    store = SessionStore(capacity=64, sweep_slots=SESS_SWEEP, retry_interval=SESS_RETRY,
                         metrics=b.metrics, clock=clock, device="cuda")
    b.session_store = store
    b.subscribe("drv", "drv", "drive/#", pkt.SubOpts(), lambda m, o: None)
    return b, store


class BatchLog:
    """Wraps a broker's `adispatch_begin` and its metrics' `inc` (instance
    attributes): the size of every batch it is handed, and how many times
    `device.transfer.bytes` is counted (once a device readback)."""

    def __init__(self, broker):
        self.broker, self.sizes, self.transfers = broker, [], 0
        begin, inc = broker.adispatch_begin, broker.metrics.inc

        def adispatch_begin(msgs):
            self.sizes.append(len(msgs))
            return begin(msgs)

        def inc_(name, n=1):
            if name == "device.transfer.bytes":
                self.transfers += 1
            return inc(name, n)

        broker.adispatch_begin, broker.metrics.inc = adispatch_begin, inc_

    def close(self) -> None:
        del self.broker.adispatch_begin, self.broker.metrics.inc

    def device_batches(self) -> int:
        return sum(1 for n in self.sizes if n >= self.broker.router.min_tpu_batch)


def frozen_heap() -> dict:
    """One full garbage collection timed, then the heap frozen (every object
    so far out of the collector's reach): a full collection of a big heap
    takes seconds and would land in whichever timed batch crosses the
    oldest generation's threshold. The caller unfreezes (`gc.unfreeze`).
    -> the collection's ms and the objects it tracked."""
    gc.collect()
    t0 = time.perf_counter()
    gc.collect()
    heap = {"full_collection_ms": 1e3 * (time.perf_counter() - t0),
            "tracked_objects": len(gc.get_objects())}
    gc.freeze()
    return heap


def flood_broker_session(torch, broker, store, state, mono, pids) -> None:
    """`flood_broker_session`: bench.py's session_storm drive through the
    port's broker. The captured 1,000,000-session state is installed into
    the broker's store, every slot bound to a `BatchSink` that builds the
    dup PUBLISH frames with `serialize_pub_slab`, the clock 60 s on; then
    `storm_drive` (a `BatchIngest(max_batch=256, window_us=200)`: 64
    drive/{i} publishes a sweep, the sweep riding their batch through
    `adispatch_begin`, committed on the loop). Fails unless every (slot,
    pid) is redelivered exactly once (the sink's count is n, its packet
    ids are the loaded ones, and every row's stamp is the flood's), no
    scatter of the store's own ran, each sweep launched `session_sweep`
    once, the full uploads are `flood_plan`'s, no host sweep ran, one
    device->host copy a device batch, and, after the flush batch, the
    mirror equals the host lanes bit for bit."""
    import asyncio

    from emqx_tpu_torch.broker.ingest import BatchIngest
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.mqtt.slab_serializer import serialize_pub_slab
    from emqx_tpu_torch.ops import segments as SG

    n = SESS_N
    sweeps_want, uploads_want, _log = flood_plan(n, SESS_SWEEP, state["table"].OPLOG_MAX)
    metrics = broker.metrics
    sink = BatchSink(serialize_pub_slab)
    heap = frozen_heap()
    probe = batches = None
    try:
        t_install = time.perf_counter()
        if store.install(state) != n:
            raise AssertionError("install restored fewer sessions")
        for slot in range(len(store._slot_cid)):
            store.bind(slot, sink.resend)
        install_ms = 1e3 * (time.perf_counter() - t_install)
        mono[0] += 60.0  # every window is long past its retry interval
        probe, batches = RideProbe(store), BatchLog(broker)
        run = asyncio.run(storm_drive(broker, store, BatchIngest(broker, **SESS_INGEST),
                                      Message, sink, n, sweeps_want))
        torch.cuda.synchronize()
    finally:
        gc.unfreeze()
        for p in (probe, batches):
            if p is not None:
                p.close()
    sweeps = run["sweeps"]
    table = store.table
    live = table.sess_slot >= 0
    stamped = int(np.count_nonzero(table.sess_ts[live] == store.now_ds()))
    if sink.count != n or stamped != n or int(live.sum()) != n \
            or not np.array_equal(np.sort(np.asarray(sink.pids)), np.sort(pids)):
        raise AssertionError(f"{sink.count} redelivered, {stamped} of {int(live.sum())} rows "
                             "stamped: not every (slot, pid) exactly once")
    seg = store.manager.counters()
    want = {"session.sweep.device": sweeps, "session.sweep.host": 0,
            "session.redeliveries": n}
    got = {k: metrics.get(k) for k in want}
    sweep_launches = sum(r["session_sweep"] for r in probe.rides)
    scatter_bad = [r for r in probe.rides
                   if r["segment_scatter"] != (SG.SCATTER_LAUNCHES if r["rows"] else 0)]
    if sweeps != sweeps_want or got != want or metrics.get("session.ack.rides") < sweeps \
            or seg["delta_launches"] or seg["full_resyncs"] != uploads_want \
            or sweep_launches != sweeps or scatter_bad:
        raise AssertionError(f"{sweeps} sweeps (derived {sweeps_want}), {got}, {seg}, "
                             f"{uploads_want} full uploads derived, {sweep_launches} sweep "
                             f"launches, rides off the scatter rule {scatter_bad[:3]}")
    device_batches = batches.device_batches()
    if batches.transfers != device_batches or device_batches != sweeps + 1:
        raise AssertionError(f"{batches.transfers} transfers for {device_batches} device "
                             f"batches ({sweeps} sweeps and a flush)")
    mirror = check_session_mirror(torch, store)
    if mirror["pending_stamps"]:
        raise AssertionError("the flush batch left redelivery stamps behind")
    phase("flood_broker_session", card=card_line(), sessions=n, sweeps=sweeps,
          redelivered=sink.count, redelivery_rps=n / run["wall_s"], loop_seconds=run["wall_s"],
          resume_visibility_ms=1e3 * (sink.first - t_install), install_ms=install_ms,
          redelivery_frame_bytes=sink.bytes,
          batches=dict(sorted(collections.Counter(batches.sizes).items())),
          device_batches=device_batches, transfers=batches.transfers,
          rides=len(probe.rides), ride_p50_ms=probe.p50(),
          ride_max_ms={"take_rider": max(probe.take_ms), "commit": max(probe.commit_ms)},
          launches_per_ride=probe.per_ride(), full_resyncs_derived=uploads_want,
          segment_status=seg, store_counters={k: metrics.get(k) for k in (
              "session.ack.rides", "session.ack.rows", "session.sweep.device",
              "session.sweep.due", "session.sweep.host", "session.redeliveries")},
          mirror=mirror, gc=heap)


def live_sessions(n: int, clock):
    """A `Broker(router=Router(min_tpu_batch=32), hooks=Hooks())` with a
    store attached (sweep_k 16,384, retry 1 s, `clock`, the broker's
    metrics) and n `Session("s{i}", SessionConfig(max_inflight=32),
    store=store)` objects, each subscribed QoS1 to sess/{i} with its
    `deliver`; and n plain `Session`s (no store) fed the same messages by
    `feed`. -> (broker, store, sessions, plain)."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.hooks import Hooks
    from emqx_tpu_torch.broker.router import Router
    from emqx_tpu_torch.broker.session import Session, SessionConfig
    from emqx_tpu_torch.broker.session_store import SessionStore
    from emqx_tpu_torch.mqtt import packet as pkt

    b = Broker(router=Router(min_tpu_batch=SESS_MIN_BATCH), hooks=Hooks())
    store = SessionStore(capacity=4 * n, sweep_slots=SESS_SWEEP, retry_interval=SESS_RETRY,
                         metrics=b.metrics, clock=clock)
    b.session_store = store
    cfg = SessionConfig(max_inflight=LIVE_INFLIGHT)
    sessions, plain = [], []
    for i in range(n):
        s = Session(f"s{i}", cfg, store=store)
        b.subscribe(f"s{i}", f"s{i}", f"sess/{i}", pkt.SubOpts(qos=1), s.deliver)
        sessions.append(s)
        plain.append(Session(f"s{i}", cfg))
    return b, store, sessions, plain


def live_messages(n: int, tag: bytes, prefix: str = "sess") -> list:
    """n QoS1 publishes, prefix/{i} for i < n (one a session)."""
    from emqx_tpu_torch.broker.message import Message

    return [Message(topic=f"{prefix}/{i}", payload=tag + b"%d" % i, qos=1) for i in range(n)]


async def live_run(broker, msgs, batch: int, pipeline: int) -> dict:
    """`msgs` from concurrent `apublish` tasks through a running
    `BatchIngest(broker, max_batch=batch, pipeline=pipeline)`. -> the
    delivery counts, the wall seconds and the enqueue->settle samples."""
    import asyncio

    from emqx_tpu_torch.broker.ingest import BatchIngest

    m = broker.metrics
    settle = []
    obs_many = m.observe_many
    m.observe_many = lambda name, vs: (
        settle.extend(vs) if name == "ingest.settle.seconds" else None, obs_many(name, vs))[1]
    try:
        ing = BatchIngest(broker, max_batch=batch, pipeline=pipeline)
        broker.ingest = ing
        ing.start()
        t0 = time.perf_counter()
        counts = await asyncio.gather(*(broker.apublish(msg) for msg in msgs))
        wall = time.perf_counter() - t0
        await ing.stop()
        broker.ingest = None
    finally:
        del m.observe_many
    return {"counts": list(counts), "wall_s": wall, "settle_s": settle}


def live_session_broker(torch) -> None:
    """`live_session_broker`: write-through from live store-backed sessions
    at scale. 65,536 `Session`s (max_inflight 32, each QoS1 on sess/{i})
    over a broker with the store attached; at pipeline 1 and then at
    pipeline 2, 8 batches of 8,192 QoS1 publishes (one a session) from
    concurrent `apublish` tasks through `BatchIngest(max_batch=8192)`; the
    depth 1 windows all PUBACKed between the runs, half the depth 2 ones
    after, then 2 batches of 8,192 no-match publishes to carry the acks.
    The inflight and session clocks (`time.monotonic` as those modules see
    it) and the store's are frozen, the heap frozen. Fails unless every
    publish is delivered once, 32,768 rows stay live, no scatter of the
    store's own ran, `session.ack.rows` equals the row writes the riders
    took from the op-log, one device->host copy a device batch, and the
    mirror equals the host lanes bit for bit. Then the clocks move 60 s
    on, a sweep is asked and 2 no-match batches ride: each of the 32,768
    unacked (slot, pid) pairs must be redelivered exactly once, and their
    set must be what `Session.retry()` picks on plain (storeless) sessions
    fed the same messages and acks."""
    import asyncio
    import types

    from emqx_tpu_torch.broker import inflight as INF
    from emqx_tpu_torch.broker import session as SES
    from emqx_tpu_torch.broker.session_store import PID_SPACE
    from emqx_tpu_torch.mqtt import packet as pkt

    n, B = LIVE_SESSIONS, LIVE_BATCH
    opts = pkt.SubOpts(qos=1)
    mono = [0.0]
    clock = lambda: mono[0]  # noqa: E731 — the frozen clock of every party
    frozen = types.SimpleNamespace(monotonic=clock, time=time.time)
    saved = INF.time, SES.time
    INF.time = SES.time = frozen
    t0 = time.perf_counter()
    broker, store, sessions, plain = live_sessions(n, clock)
    build_s = time.perf_counter() - t0
    heap = frozen_heap()
    probe, batches = RideProbe(store), BatchLog(broker)
    depths = {}
    try:
        for pipeline, tag in ((1, b"a"), (2, b"b")):
            msgs = live_messages(n, tag)
            for i, msg in enumerate(msgs):  # as the broker delivers it
                plain[i].deliver(msg, opts)
            r0 = len(probe.rides)
            b0 = len(batches.sizes)
            run = asyncio.run(live_run(broker, msgs, B, pipeline))
            torch.cuda.synchronize()
            if run["counts"] != [1] * n:
                raise AssertionError(f"pipeline {pipeline}: deliveries {collections.Counter(run['counts'])}")
            settle = np.asarray(run["settle_s"]) * 1e3
            rides = probe.rides[r0:]
            depths[pipeline] = {
                "messages_per_s": n / run["wall_s"], "wall_s": run["wall_s"],
                "batches": batches.sizes[b0:], "rides": len(rides),
                "rider_rows": [r["rows"] for r in rides],
                "settle_p50_ms": float(np.percentile(settle, 50)),
                "settle_p99_ms": float(np.percentile(settle, 99))}
            # the acks, on the loop's thread: depth 1's every window, depth
            # 2's on the even sessions
            for i in range(0, n, 1 if pipeline == 1 else 2):
                for s in (sessions[i], plain[i]):
                    pid = next(iter(s.inflight._d))
                    if s.puback(pid)[0] is None:
                        raise AssertionError(f"session {i}: PUBACK {pid} found nothing")
        flush = asyncio.run(live_run(broker, live_messages(LIVE_FLUSH * B, b"f", "none"), B, 1))
        torch.cuda.synchronize()
        table = store.table
        if flush["counts"] != [0] * (LIVE_FLUSH * B) or table.live != n // 2:
            raise AssertionError(f"after the acks: {table.live} rows live")
        seg = store.manager.counters()
        rows, rows_taken = broker.metrics.get("session.ack.rows"), probe.suffix_rows
        if seg["delta_launches"] or rows != rows_taken \
                or batches.transfers != batches.device_batches():
            raise AssertionError(f"{seg}, {rows} rows ridden against {rows_taken} "
                                 f"taken, {batches.transfers} transfers for "
                                 f"{batches.device_batches()} device batches")
        mirror = check_session_mirror(torch, store)
        if mirror["pending_stamps"]:
            raise AssertionError("the flush left writes behind")
        # -- the retry: both clocks 60 s on, a sweep, 2 batches to ride
        mono[0] += 60.0
        resent = []
        for slot in range(n):
            store.bind(slot, lambda pid, st, msg, slot=slot: resent.append((slot, pid, st)) or True)
        store.request_sweep()
        due = len(table.due_rows(store.now_ds(), store.retry_ds))
        r0 = len(probe.rides)
        retry = asyncio.run(live_run(broker, live_messages(2 * B, b"r", "none"), B, 1))
        torch.cuda.synchronize()
        want = sorted((i, p.packet_id) for i, s in enumerate(plain) for p in s.retry()
                      if p.packet_id < PID_SPACE)
        got = sorted((slot, pid) for slot, pid, _st in resent)
        sweep_rides = [r for r in probe.rides[r0:] if r["sweep"]]
        if due != n // 2 or len(got) != len(set(got)) or got != want \
                or len(sweep_rides) != -(-due // store.sweep_slots) > 0 \
                or any(r["session_sweep"] != 1 for r in sweep_rides) \
                or retry["counts"] != [0] * (2 * B):
            raise AssertionError(f"retry: {due} due, {len(got)} redelivered "
                                 f"({len(set(got))} distinct), the plain sessions' retry "
                                 f"{len(want)}, sweep rides {sweep_rides}")
    finally:
        INF.time, SES.time = saved
        gc.unfreeze()
        probe.close()
        batches.close()
    phase("live_session_broker", card=card_line(), sessions=n, batch=B,
          build_seconds=build_s, depths={str(k): v for k, v in depths.items()},
          live_after_acks=n // 2, rows_ridden=rows, rows_taken=rows_taken,
          device_batches=batches.device_batches(), transfers=batches.transfers,
          ride_p50_ms=probe.p50(), launches_per_ride=probe.per_ride(),
          segment_status=seg, mirror=mirror,
          retry={"due": due, "redelivered": len(got), "equal_to_plain_retry": True,
                 "sweep_rides": len(sweep_rides)},
          store_counters={k: broker.metrics.get(k) for k in (
              "session.ack.rides", "session.ack.rows", "session.sweep.device",
              "session.redeliveries", "session.sweep.host")}, gc=heap)


def session_path(torch, rng, router=None):
    """Phases 19-22: the device session store at bench.py's session_storm,
    ridden directly through `route_prepared` (then `compact_session`) and
    then through the broker. -> (kernel report, launches on the path, a
    copy of the bulk-loaded store's capture for `snapshot_broker`)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.session_store import PID_SPACE, SessionStore
    from emqx_tpu_torch.models.router_model import DeviceRouter
    from emqx_tpu_torch.ops import segments as SG
    from emqx_tpu_torch.ops import session_table as ST
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.ops.nfa import _next_pow2

    n, K = SESS_N, SESS_SWEEP
    mono = [0.0]
    clock = lambda: mono[0]  # noqa: E731 — the frozen store clock
    t = [time.perf_counter()]
    cids = [f"c{i}" for i in range(n)]
    t.append(time.perf_counter())
    store1 = SessionStore(capacity=_next_pow2(2 * n), sweep_slots=K,
                          retry_interval=SESS_RETRY, clock=clock, device="cuda")
    # one shared message object (the slab stores references); pids cycle
    # the 16-bit space
    shared = Message(topic="dev/offline", payload=b"m", qos=1)
    pids = (np.arange(n) % 65535) + 1
    rows = store1.bulk_load(cids, [shared] * n, pids=pids)
    t.append(time.perf_counter())
    lost = int((rows < 0).sum())
    if lost:
        raise AssertionError(f"{lost} rows lost in bulk placement")
    state = store1.capture()  # the mass disconnect: the state IS the table
    t.append(time.perf_counter())
    # the broker's store installs the same state: a copy, as install takes
    # the capture's objects as its own (and one more for snapshot_broker)
    state_b = copy_capture(state)
    state_c = copy_capture(state)
    t.append(time.perf_counter())
    metrics = Counters()
    store = SessionStore(capacity=64, sweep_slots=K, retry_interval=SESS_RETRY,
                         metrics=metrics, clock=clock, device="cuda")
    expired_cids = []
    store.on_expired = expired_cids.extend
    sink = FloodSink()
    t_install = time.perf_counter()
    if store.install(state) != n:
        raise AssertionError("install restored fewer sessions")
    t.append(time.perf_counter())
    for slot in range(len(store._slot_cid)):
        store.bind(slot, sink.resend)
    t.append(time.perf_counter())
    del store1, state
    table = store.table
    cap = table._cap
    host_bytes = sum(v.nbytes for v in table.device_snapshot().values())
    # the bulk placement grows the table once when its 16 probe rounds leave
    # keys unplaced (a 1M load into 2^21 rows does): cap 2^21 or 2^22
    if cap not in (_next_pow2(2 * n), 2 * _next_pow2(2 * n)) \
            or len(table.slot_expiry) != 256 or host_bytes != 5 * 4 * cap + 4 * 256:
        raise AssertionError(f"table cap {cap}, {host_bytes} B")
    if router is None:
        r_index, subtab = build_mixed_1m()
        router = DeviceRouter(
            r_index, subtab, MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
            device="cuda",
        )
    args = router.prepare()
    t.append(time.perf_counter())
    broker, bstore = session_broker(clock)
    t.append(time.perf_counter())
    phase("tables_session", sessions=n, table_capacity=cap, row_lanes=5,
          host_table_bytes=host_bytes, sweep_k=K, retry_ds=store.retry_ds,
          oplog_max=table.OPLOG_MAX, batch=SESS_BATCH, drive=SESS_DRIVE, ingest=SESS_INGEST,
          build_stage_seconds={k: b - a for k, a, b in zip(
              ("client_ids", "bulk_load", "capture", "copy", "install", "bind", "router",
               "broker"), t, t[1:])},
          reduced=[])

    # -- flood_session: the counters are zeroed here and read after
    # fused_session
    sweeps_want, uploads_want, log_left = flood_plan(n, K, table.OPLOG_MAX)
    kernels.reset_launches()
    mono[0] += 60.0  # every window is long past its retry interval
    stages = {k: [] for k in ("take_rider", "fused", "route", "commit")}
    swept = []
    sweeps = 0
    t0 = time.perf_counter()
    while len(sink.pids) < n:
        if sweeps > sweeps_want:
            raise AssertionError(f"{sweeps} sweeps without draining the flood")
        store.request_sweep()
        r = session_ride(torch, store, router, args, topic_batch_1m(rng, SESS_BATCH))
        for k, v in r["ms"].items():
            stages[k].append(v)
        swept.append(r["due"][r["due"] >= 0])
        sweeps += 1
        if sweeps == 1:
            first_ride = r
    wall = time.perf_counter() - t0
    rows = np.concatenate(swept)
    if len(rows) != n or len(np.unique(rows)) != n \
            or not np.array_equal(np.sort(table.sess_slot[rows]), np.arange(n)) \
            or not np.array_equal(np.sort(np.asarray(sink.pids)), np.sort(pids)):
        raise AssertionError("the flood did not redeliver every (slot, pid) exactly once")
    seg = store.manager.counters()
    if sweeps != sweeps_want or seg != {"full_resyncs": uploads_want, "delta_launches": 0,
                                        "array_resyncs": 0}:
        raise AssertionError(f"{sweeps} sweeps, {seg}: expected {sweeps_want} sweeps, "
                             f"{uploads_want} full uploads and no scatter")
    if metrics.get("session.sweep.host") or metrics.get("session.sweep.device") != sweeps \
            or metrics.get("session.redeliveries") != n:
        raise AssertionError(f"store counters {metrics.values}")
    if len(table.oplog) != log_left:
        raise AssertionError(f"op-log {len(table.oplog)} after the flood, derived {log_left}")
    drain_ms = sum(sum(stages[k]) for k in ("take_rider", "fused", "commit"))
    mirror = check_session_mirror(torch, store)
    phase("flood_session", sessions=n, sweeps=sweeps, redelivered=len(sink.pids),
          redelivery_rps=n / (drain_ms / 1e3), loop_seconds=wall,
          resume_visibility_ms=1e3 * (sink.first - t_install),
          first_sweep_ms=first_ride["ms"],
          stage_ms_median={k: float(np.median(v)) for k, v in stages.items()},
          stage_ms_total={k: float(np.sum(v)) for k, v in stages.items()},
          stage_ms_max={k: float(np.max(v)) for k, v in stages.items()},
          readback_bytes=first_ride["readback_bytes"],
          route_readback_bytes=first_ride["route_readback_bytes"],
          full_resyncs_derived=uploads_want, segment_status=seg, oplog_after=log_left,
          store_counters=dict(metrics.values), mirror=mirror,
          device_bytes={k: v.numel() * v.element_size()
                        for k, v in store.manager._arrays.items()},
          launches=dict(kernels.LAUNCHES))
    del swept, rows

    # -- churn_session. The flood leaves log_left touch entries in the
    # op-log (OPLOG_MAX counts the log since its epoch began); at
    # session_storm ride A's wave on top would pass OPLOG_MAX and bump the
    # epoch. So the drained store is checkpointed and resumed first
    # (capture -> install: ride 0 is the one full upload), and each ride's
    # wave starts on an empty log.
    churn = {}
    perm = rng.permutation(n)
    a1, a2, a3 = SESS_ACKS, SESS_ACKS + SESS_RELS, SESS_ACKS + SESS_RELS + SESS_AWAITS
    dels, rels, awaits = perm[:a1], perm[a1:a2], perm[a2:a3]
    # a clear logs 3 writes, a rel phase 3, an insert 5
    wave_a = 3 * len(dels) + 3 * len(rels) + 5 * len(awaits)
    c0 = store.manager.counters()
    store.install(store.capture())
    store.request_sweep()
    r0 = session_ride(torch, store, router, args, topic_batch_1m(rng, SESS_BATCH))
    c1 = store.manager.counters()
    if r0["due_count"] or c1["full_resyncs"] - c0["full_resyncs"] != 1 or r0["rows"]:
        raise AssertionError(f"ride 0: {r0['due_count']} due, {c0} -> {c1}")
    churn["resume_ride0"] = {"ms": r0["ms"], "segment_moves": {k: c1[k] - c0[k] for k in c1},
                             "flood_oplog": log_left, "wave_a_oplog": wave_a,
                             "past_oplog_max_without": log_left + wave_a > table.OPLOG_MAX,
                             "mirror": check_session_mirror(torch, store)}

    # ride A: 20,000 acks (clears), 10,000 PUBRECs (rel phase), 5,000
    # incoming QoS2 rows awaiting PUBREL; an aborted launch first
    t0 = time.perf_counter()
    for i in dels:
        store.inflight_delete(int(i), int(pids[i]))
    for i in rels:
        store.inflight_phase(int(i), int(pids[i]), "pubrel")
    for i in awaits:
        store.await_rel(int(i), 7)
    mutate_ms = 1e3 * (time.perf_counter() - t0)
    if len(table.oplog) != wave_a or table.OPLOG_MAX <= wave_a:
        raise AssertionError(f"ride A's wave logged {len(table.oplog)}, derived {wave_a}")
    c0 = store.manager.counters()
    s0 = kernels.LAUNCHES["segment_scatter"]
    before = dict(store.manager._arrays)
    kept = {k: v.cpu().numpy().copy() for k, v in before.items()}
    store.request_sweep()
    rider = store.take_rider()
    aborted = router.route_prepared(args, topic_batch_1m(rng, SESS_BATCH), session=rider)
    store.abort(rider)
    torch.cuda.synchronize()
    if any(store.manager._arrays[k] is not v or not np.array_equal(v.cpu().numpy(), kept[k])
           for k, v in before.items()) \
            or not any(aborted.session.arrays[k] is not v for k, v in before.items()):
        raise AssertionError("the aborted rider changed the mirror")
    store.request_sweep()
    ra = session_ride(torch, store, router, args, topic_batch_1m(rng, SESS_BATCH))
    c1 = store.manager.counters()
    if ra["writes"] != {k: len(v) for k, v in rider.idxs.items()} or ra["due_count"] \
            or c1 != c0 or kernels.LAUNCHES["segment_scatter"] - s0 != 2 * SG.SCATTER_LAUNCHES:
        raise AssertionError(f"ride A: {ra['writes']}, {ra['due_count']} due, {c0} -> {c1}")
    mirror = check_session_mirror(torch, store)
    st = table.sess_state
    if mirror["pending_stamps"] or int(np.count_nonzero(st == ST.ST_AWAIT_REL)) != len(awaits) \
            or int(np.count_nonzero(table.sess_pid >= PID_SPACE)) != len(awaits) \
            or int(np.count_nonzero(st == ST.ST_PUBREL)) != len(rels) \
            or table.live != n - len(dels) + len(awaits):
        raise AssertionError(f"ride A left the table wrong: {mirror}, live {table.live}")
    churn["ride_a"] = {"mutate_ms": mutate_ms, "oplog": wave_a, "rows": ra["rows"],
                       "writes": ra["writes"], "ms": ra["ms"], "aborted_then_recarried": True,
                       "segment_moves": {k: c1[k] - c0[k] for k in c1},
                       "segment_scatter_launches": kernels.LAUNCHES["segment_scatter"] - s0,
                       "mirror": mirror}

    # ride B: session expiry armed on 100,000 sessions in random slot order,
    # deadlines 1-100 s out; the slot lane grows to 2^20 through `!resync`,
    # so the rider's sync re-uploads that lane alone. Then 50 s pass.
    armed = rng.permutation(perm[a3:])[:SESS_EXPIRY]
    deadlines = rng.uniform(1.0, 100.0, size=len(armed))
    t0 = time.perf_counter()
    for i, d in zip(armed, deadlines):
        store.set_expiry(cids[i], float(d))
    mutate_ms = 1e3 * (time.perf_counter() - t0)
    mono[0] += 50.0
    if len(table.slot_expiry) != _next_pow2(int(armed.max()) + 1) \
            or len(table.oplog) >= table.OPLOG_MAX:
        raise AssertionError(f"slot lane {len(table.slot_expiry)}, op-log {len(table.oplog)}")
    c0 = store.manager.counters()
    s0 = kernels.LAUNCHES["segment_scatter"]
    if store.manager.peek_delta(table) is not None:
        raise AssertionError("the grown slot lane must be synced before the ride")
    store.request_sweep()
    rb = session_ride(torch, store, router, args, topic_batch_1m(rng, SESS_BATCH))
    c1 = store.manager.counters()
    moves = {k: c1[k] - c0[k] for k in c1}
    now = int(rb["rider"].clock[0])
    exp_want = table.expired_slots(now)
    if moves != {"full_resyncs": 0, "delta_launches": 0, "array_resyncs": 1} \
            or kernels.LAUNCHES["segment_scatter"] != s0 or rb["rows"]:
        raise AssertionError(f"ride B: {moves}, {rb['rows']} rows riding")
    if rb["expired_count"] <= K or rb["due_count"] <= K or not store._want_sweep \
            or expired_cids != [cids[s] for s in exp_want[:K]]:
        raise AssertionError(f"ride B: {rb['expired_count']} expired, {rb['due_count']} due")
    churn["ride_b"] = {"mutate_ms": mutate_ms, "armed": len(armed),
                       "slot_lane": len(table.slot_expiry), "ms": rb["ms"],
                       "expired_count": rb["expired_count"], "due_count": rb["due_count"],
                       "on_expired": len(expired_cids), "rearmed": store._want_sweep,
                       "segment_moves": moves, "mirror": check_session_mirror(torch, store)}
    phase("churn_session", **churn, segment_status=store.manager.counters(),
          launches=dict(kernels.LAUNCHES))

    # -- fused_session: the next rider (ride B's redelivery stamps, and the
    # re-armed sweep) under the profiler: one device->host copy
    rf = session_ride(torch, store, router, args, topic_batch_1m(rng, SESS_BATCH),
                      profile=True)
    launches = dict(kernels.LAUNCHES)
    path = ("tokenize", "shape_match", "fanout_bitmaps", "compact_fanout_slots",
            "segment_scatter", "session_sweep")
    if not all(launches[k] for k in path) or rf["writes"] != {"sess_ts": K}:
        raise AssertionError(f"session path: launches {launches}, writes {rf['writes']}")
    phase("fused_session", batch=SESS_BATCH, d2h_copies=rf["d2h"],
          trace_attempts=rf["trace_attempts"], writes=rf["writes"],
          due_count=rf["due_count"], expired_count=rf["expired_count"], ms=rf["ms"],
          readback_bytes=rf["readback_bytes"], route_readback_bytes=rf["route_readback_bytes"],
          mirror=check_session_mirror(torch, store), launches=launches)

    # -- compact_session: ride A's acks purged by the background compaction
    phase("compact_session", **compact_session(torch, store, router, args, rng))

    # -- the broker's phases: counters zeroed before the first, read after
    # the last
    kernels.reset_launches()
    flood_broker_session(torch, broker, bstore, state_b, mono, pids)
    del broker, bstore, state_b
    live_session_broker(torch)
    broker_launches = dict(kernels.LAUNCHES)
    for k in ("tokenize", "shape_match", "fanout_bitmaps", "segment_scatter",
              "session_sweep"):
        if not broker_launches.get(k):
            raise AssertionError(f"the broker's session phases: launches {broker_launches}")
    phase("launches_session_broker", **broker_launches)

    # -- the kernel at the flood's table (its rows, the 2^20-slot lane)
    lanes = store.manager._arrays
    now, retry = int(rf["rider"].clock[0]), store.retry_ds
    sweep_args = (lanes["sess_slot"], lanes["sess_state"], lanes["sess_ts"],
                  lanes["slot_expiry"], now, retry, K)
    got = ST.session_sweep(*sweep_args)
    due_mask = ((lanes["sess_slot"] >= 0)
                & ((lanes["sess_state"] == 1) | (lanes["sess_state"] == 2))
                & (ST._wrap_i32(now - lanes["sess_ts"].to(torch.int64)) >= retry))
    ex_mask = (lanes["slot_expiry"] > 0) & (lanes["slot_expiry"] <= now)
    cap, scap = lanes["sess_slot"].numel(), lanes["slot_expiry"].numel()
    kinds = {"session_sweep": dict(
        kernel=lambda: ST.session_sweep(*sweep_args),
        plain=lambda: ST.session_sweep_plain(*sweep_args),
        # the nearest single PyTorch call: torch.nonzero of each mask,
        # precomputed (no cap, no -1 padding, int64 out)
        library=lambda: (torch.nonzero(due_mask), torch.nonzero(ex_mask)),
        out=got,
        # three row lanes and the slot lane read once, two lists and two
        # counts written
        bytes=12 * cap + 4 * scap + 2 * 4 * K + 8,
        ops=10 * cap + 4 * scap,
    )}
    report = kernel_report(torch, kinds, plain_reps=RET_PLAIN_REPS)
    phase("kernel_inputs_session", rows=cap, slots=scap, sweep_k=K,
          due_count=int(got[1]), expired_count=int(got[3]), now_ds=now, retry_ds=retry,
          library="torch.nonzero of the precomputed due and expiry masks (the nearest "
                  "single call: no cap, no padding)")
    # the path's launches: the direct rides' and the broker phases'; and
    # the capture snapshot_broker installs
    return (report, dict(collections.Counter(launches) + collections.Counter(broker_launches)),
            state_c)


# -- the semantic_256k path --------------------------------------------------


class SemHost:
    """The host side of one semantic table for the f64 checks: its lanes
    (packed then hot) and its vectors as float64, bf16 widened. `shard`:
    which slot-owner shard (a mesh's 'tp' rank holds one)."""

    def __init__(self, sem, shard=0):
        from emqx_tpu_torch.convert import BF16

        snap = sem.device_snapshot()
        cat = lambda a, b: np.concatenate([snap[a][shard], snap[b][shard]])  # noqa: E731
        vecs = cat("sem_vec", "sem_hot_vec")
        self.bf16 = vecs.dtype == BF16
        if self.bf16:
            vecs = (vecs.view(np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)
        self.vecs64 = vecs.astype(np.float64)
        self.fids = cat("sem_fid", "sem_hot_fid")
        self.slots = cat("sem_slot", "sem_hot_slot")
        self.ths = cat("sem_thresh", "sem_hot_thresh")

    def sims(self, q):
        """float64 similarities of query rows q (f32 [R, D]), the query
        rounded to bf16 first for a bf16 table, as the kernel does."""
        from emqx_tpu_torch.convert import bf16_bits

        if self.bf16:
            q = (bf16_bits(q).astype(np.uint32) << np.uint32(16)).view(np.float32)
        return q.astype(np.float64) @ self.vecs64.T

    def check(self, q, matched, rows, results, topk) -> int:
        """Every (slots [B, topk], count [B]) result in `results` must pass
        `semantic_row_ok` on each of `rows`; -> rows checked."""
        rows = np.asarray(sorted(rows), np.int64)
        for lo in range(0, len(rows), 64):
            part = rows[lo : lo + 64]
            s64 = self.sims(q[part])
            for i, r in enumerate(part):
                m = matched[r][matched[r] >= 0]
                elig = (self.slots >= 0) & ((self.fids < 0) | np.isin(self.fids, m))
                for got, count in results:
                    if not semantic_row_ok(s64[i], elig, self.ths, self.slots, topk,
                                           got[r], int(count[r]), SEM_TAU):
                        raise AssertionError(f"semantic row {r}: outside the tau band")
        return len(rows)


def sem_twin(torch, sem_t, q, matched, topk, census=True):
    """The plain twin in row chunks of SEM_CHUNK (it materialises [rows, E]),
    plus, with `census`, the tau-band census from f32 similarities: entries
    within SEM_TAU of their threshold, and qualifying entries within
    SEM_TAU of the row's k-th score (the k-th itself not counted)."""
    from emqx_tpu_torch.ops import semantic_table as ST

    vecs, fids, slots, ths = ST._lanes(sem_t)
    vecs = vecs.float()
    outs, counts = [], []
    thr_band = kth_band = band_rows = 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, q.shape[0], SEM_CHUNK):
            qc, mc = q[lo : lo + SEM_CHUNK], matched[lo : lo + SEM_CHUNK]
            s, c = ST.semantic_match_step_plain(sem_t, qc, mc, topk)
            outs.append(s)
            counts.append(c)
            if not census:
                continue
            qq = qc.to(torch.bfloat16).float() if sem_t["sem_vec"].dtype == torch.bfloat16 else qc
            sims = qq @ vecs.T
            memb = torch.zeros_like(sims, dtype=torch.bool)
            for k in range(mc.shape[1]):
                memb |= mc[:, k, None] == fids[None, :]
            elig = (slots >= 0)[None, :] & ((fids < 0)[None, :] | memb)
            tb = elig & ((sims - ths[None, :]).abs() <= SEM_TAU)
            ok = elig & (sims >= ths[None, :])
            score = torch.where(ok, sims, torch.full_like(sims, -np.inf))
            kth = torch.topk(score, topk, dim=1).values[:, -1:]
            kb = ok & ((score - kth).abs() <= SEM_TAU) & (kth > -np.inf)
            full = c >= topk
            kb_n = kb.sum(dim=1) - full.to(torch.int64)  # the k-th itself
            thr_band += int(tb.sum())
            kth_band += int(torch.where(full, kb_n, 0).sum())
            band_rows += int(((tb.sum(dim=1) > 0) | (full & (kb_n > 0))).sum())
            del sims, memb, elig, tb, ok, score, kb
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    found = {"threshold_band_entries": thr_band, "kth_band_entries": kth_band,
             "rows_with_band_entries": band_rows, "tau": SEM_TAU}
    return torch.cat(outs), torch.cat(counts), found


def build_semantic(rng, index, dtype, cents, shards=1):
    """The semantic_256k table: SEM_N entries `_near` SEM_CENTROIDS unit
    centroids, thresholds uniform in SEM_THRESH, half unscoped and half
    scoped to device/{d}/# (3/4) or device/{d}/+/{j}/# (1/4) for d <
    SEM_SCOPE_DEVICES, slots 256 + i, except SEM_TOPIC_SLOTS random entries
    that take slots 0-255: entry s is centroid s itself, unscoped, at the
    lowest threshold, so it leads the rows of cluster s, which `sem_batch`
    gives the topics whose topic slot is s, and the union deduplicates
    it; one bulk_add. -> (table, seconds per stage)."""
    from emqx_tpu_torch.ops.semantic_table import SemanticTable

    n = SEM_N
    t = [time.perf_counter()]
    vecs = sem_vectors(rng, cents, rng.integers(0, SEM_CENTROIDS, n))
    ths = rng.uniform(*SEM_THRESH, n).astype(np.float32)
    d = rng.integers(0, SEM_SCOPE_DEVICES, n)
    j = rng.integers(0, 1000, n)
    kind = rng.random(n)  # < 0.5 unscoped, < 0.875 device/{d}/#, else device/{d}/+/{j}/#
    names = [f"device/{a}/#" if k < 0.875 else f"device/{a}/+/{b}/#"
             for a, b, k in zip(d.tolist(), j.tolist(), kind.tolist())]
    fids = index._hash_lookup_batch(names)[0]
    if (fids < 0).any():
        raise AssertionError("a scope filter is not in the table")
    fids = np.where(kind < 0.5, -1, fids)
    slots = 256 + np.arange(n)
    lead = rng.choice(n, SEM_TOPIC_SLOTS, replace=False)
    slots[lead] = np.arange(SEM_TOPIC_SLOTS)
    vecs[lead] = cents[np.arange(SEM_TOPIC_SLOTS) % SEM_CENTROIDS]
    ths[lead] = SEM_THRESH[0]
    fids[lead] = -1
    t.append(time.perf_counter())
    sem = SemanticTable(dim=SEM_DIM, topk=SEM_TOPK, dtype=dtype, shards=shards)
    sem.bulk_add(slots, vecs, ths, fids)
    t.append(time.perf_counter())
    return sem, {"vectors": t[1] - t[0], "bulk_add": t[2] - t[1]}


def sem_batch(rng, cents, n, edge=False):
    """One routed batch: Zipf mixed_1m topics device/{i}/mid/{j}/leaf (with
    `edge`, EDGE_TOPICS first), each with an embedding near the centroid of
    its topic slot (filter device/{i}/+/{j}/# has fid 1000 i + j and slot
    fid mod 256 in `build_mixed_1m`), and one seeded message per topic for
    the rule set. -> (topics, embeddings, messages)."""
    ids = zipf_ids(rng, n, 1000)
    nums = rng.integers(0, 1000, size=n)
    topics = [f"device/{i}/mid/{j}/leaf" for i, j in zip(ids, nums)]
    if edge:
        topics[: len(EDGE_TOPICS)] = EDGE_TOPICS
    q = sem_vectors(rng, cents, (ids * 1000 + nums) % MAX_SUBSCRIBERS % SEM_CENTROIDS)
    return topics, q, rule_messages(rng, topics)


def check_sem_mirror(torch, args, sem) -> int:
    """The semantic mirror equals the host table bit for bit (bf16 as its
    bits) -> bytes compared."""
    from emqx_tpu_torch.convert import BF16

    n = 0
    for k, host in sem.device_snapshot().items():
        dev = args.sem_tables[k]
        if host.dtype == BF16:
            got, want = dev.view(torch.int16).cpu().numpy().view(np.uint16), host.view(np.uint16)
        elif host.dtype == np.float32:
            got, want = dev.view(torch.int32).cpu().numpy(), host.view(np.int32)
        else:
            got, want = dev.cpu().numpy(), host
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"semantic mirror {k} differs from the host table")
        n += want.nbytes
    return n


def take_launches(path: dict) -> dict:
    """Add the launch counts so far to `path` and set them to 0: read just
    after a part of a path, before a check that launches kernels of its
    own (a kernel again, to compare it with its twin), whose launches the
    `kernels.reset_launches()` after it drops. -> path"""
    from emqx_tpu_torch import kernels

    for k, v in kernels.LAUNCHES.items():
        path[k] = path.get(k, 0) + v
    kernels.reset_launches()
    return path


def sem_route_checked(torch, router, host, oracle, filt, path, topics, q, msgs) -> dict:
    """One routed batch with embeddings and the rule set's masks, checked:
    the topic half of every row against the host oracle; the semantic half
    against the twin's winners after the union (a differing row must hold
    the kernel's own winners, recomputed for its rows, and those must pass
    the f64 band check); sem_count likewise; the rule masks bit-equal to
    the twin and to `filt.host_masks` (numpy). The launch counts are added
    to `path` just after the route (`take_launches`); the check's own
    launches are dropped."""
    from emqx_tpu_torch.rules import compile as RC

    rules = (filt.progs, *filt.features(msgs))
    t0 = time.perf_counter()
    res = router.route(topics, embeds=q, rules=rules)
    wall = time.perf_counter() - t0
    take_launches(path)
    args = router.prepare()
    kslot, topk = args.kslot, args.sem_topk
    topic_part = res._replace(slots=np.ascontiguousarray(res.slots[:, :kslot]))
    checked = check_batch(topic_part, topics, oracle)
    half = sem_half_checked(torch, args, lambda: host, res, q)
    ws, want, census, diff = half["twin"], half["want"], half["band"], half["diff"]
    progs, feats, valid = rules
    plain = RC.eval_rule_masks_plain(progs, torch.from_numpy(feats),
                                     torch.from_numpy(valid)).numpy()
    if not (np.array_equal(res.rule_masks, plain)
            and np.array_equal(plain, filt.host_masks(msgs))):
        raise AssertionError("rule masks differ from the twin or the numpy host masks")
    sem_part = res.slots[:, kslot:]
    return {**checked, "route_ms": 1e3 * wall, "readback_bytes": res.readback_bytes,
            "semantic_recipients": int((sem_part >= 0).sum()),
            "deduplicated": int(((want[:, kslot:] < 0) & (ws.cpu().numpy() >= 0)).sum()),
            "sem_count_mean": float(res.sem_count.mean()),
            "rows_differing_from_twin": int(len(diff)), "band": census,
            "rule_passes": res.rule_masks.sum(axis=1).tolist()}


def sem_half_checked(torch, args, host_of, res, q) -> dict:
    """The semantic half of one routed batch `res` (query rows `q`, f32
    [B, D]) against the twin on the card, on the `prepare()` snapshot
    `args` it ran on: the slots after the union and sem_count must equal
    the twin's, or a differing row must hold the kernel's own winners
    (recomputed for its rows; the launches of that call are dropped) and
    those, like the twin's, must pass the f64 band check of `host_of()`'s
    `SemHost` (built only when a row differs). -> the twin's winners
    (torch), the union it implies (numpy), the band census and the rows
    that differ."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.ops import semantic_table as ST

    kslot, topk = args.kslot, args.sem_topk
    B = len(q)
    if res.slots.shape != (B, kslot + topk):
        raise AssertionError(f"slots {res.slots.shape}, kslot {kslot}, topk {topk}")
    topic_slots = np.ascontiguousarray(res.slots[:, :kslot])
    dev = args.sem_tables["sem_vec"].device
    qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev)
    md = torch.from_numpy(np.ascontiguousarray(res.matched)).to(dev)
    ws, wc, census = sem_twin(torch, args.sem_tables, qd, md, topk)
    want = ST.union_semantic_slots_plain(torch.from_numpy(topic_slots), ws.cpu()).numpy()
    wc = wc.cpu().numpy()
    diff = np.nonzero((res.slots != want).any(axis=1) | (res.sem_count != wc))[0]
    if len(diff):
        sel = torch.from_numpy(diff).to(dev)
        ks, kc = ST.semantic_match_step(args.sem_tables, qd[sel].contiguous(),
                                        md[sel].contiguous(), topk)
        kernels.reset_launches()
        ks, kc = ks.cpu().numpy(), kc.cpu().numpy()
        u = ST.union_semantic_slots_plain(torch.from_numpy(topic_slots[diff]),
                                          torch.from_numpy(ks)).numpy()
        if not (np.array_equal(u, res.slots[diff]) and np.array_equal(kc, res.sem_count[diff])):
            raise AssertionError("routed semantic rows differ from the kernel's own winners")
        full_ks = np.full((B, topk), -1, np.int32)
        full_kc = np.zeros(B, np.int32)
        full_ks[diff], full_kc[diff] = ks, kc
        host_of().check(q, res.matched, diff, [(full_ks, full_kc), (ws.cpu().numpy(), wc)],
                        topk)
    return {"twin": ws, "want": want, "band": census, "diff": diff}


def sem_kernel_report(torch, args, host, q, matched, topic, dtype) -> dict:
    """semantic_match at the path's shapes (B = 8192 rows of the routed
    batch, E = 2^18, D = 384): the fused call against the twin (integer
    outputs equal outside the tau band: differing rows and 64 sampled rows
    checked in f64), then its times, its bound (operations: 2 B E D flops
    at the f32 rate, or the bf16 tensor-core rate for a bf16 table) and
    the nearest library calls (torch.matmul with TF32 off, then topk)."""
    from emqx_tpu_torch.ops import semantic_table as ST

    sem_t, topk = args.sem_tables, args.sem_topk
    B, D = q.shape
    E = sem_t["sem_vec"].shape[1] + sem_t["sem_hot_vec"].shape[1]
    kslot = topic.shape[1]
    got_u, got_c = ST.semantic_route_stage(sem_t, q, matched, topk, topic)
    got_s, got_c2 = ST.semantic_match_step(sem_t, q, matched, topk)
    torch.cuda.synchronize()
    if not (torch.equal(got_u, ST.union_semantic_slots_plain(topic, got_s))
            and torch.equal(got_c, got_c2)):
        raise AssertionError("semantic_route_stage != its two halves")
    ws, wc, census = sem_twin(torch, sem_t, q, matched, topk)
    gs, gc = got_s.cpu().numpy(), got_c.cpu().numpy()
    wsn, wcn = ws.cpu().numpy(), wc.cpu().numpy()
    diff = np.nonzero((gs != wsn).any(axis=1) | (gc != wcn))[0]
    sample = np.random.default_rng(SEED).choice(B, SEM_CHECK_ROWS, replace=False)
    qn, mn = q.cpu().numpy(), matched.cpu().numpy()
    host.check(qn, mn, sample, [(gs, gc)], topk)
    n_checked = host.check(qn, mn, diff, [(gs, gc), (wsn, wcn)], topk)
    err = int(np.abs(gs.astype(np.int64) - wsn).max()) if len(diff) else 0
    uni = ST.union_semantic_slots(topic, got_s)  # the standalone union kernel
    if not torch.equal(uni, got_u):
        raise AssertionError("union_semantic_slots != the fused union")
    cand_err = sem_candidate_err(torch, sem_t, q, matched, topk, dtype)

    fused = lambda: ST.semantic_route_stage(sem_t, q, matched, topk, topic)  # noqa: E731
    ms = time_ms(fused, torch, inner=3, reps=7)
    plain_ms = time_ms(lambda: sem_twin(torch, sem_t, q, matched, topk, census=False), torch,
                       inner=1, reps=3)
    dev_ms, dev_via = device_ms(torch, "semantic_match", fused)
    vecs = torch.cat([sem_t["sem_vec"][0], sem_t["sem_hot_vec"][0]]).float()
    qq = q.to(torch.bfloat16).float() if dtype == "bfloat16" else q
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_mm = time_ms(lambda: torch.matmul(qq, vecs.T), torch, inner=1, reps=5)
        lib_ms = time_ms(lambda: torch.topk(torch.matmul(qq, vecs.T), topk, dim=1), torch,
                         inner=1, reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del vecs, qq
    torch.cuda.empty_cache()
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (4 * B * D + elem * E * D + 12 * E + 4 * matched.numel() + 4 * B * kslot
              + 4 * B * (kslot + topk) + 4 * B)
    flops = 2 * B * E * D
    bound_ms, bound_by = bound(nbytes, flops, BF16_OPS_PER_S if dtype == "bfloat16"
                               else SCALAR_OPS_PER_S)
    src, replaces = SOURCES["semantic_match"]
    tflops = flops / dev_ms / 1e9
    rep = {"name": "semantic_match", "route": "cuda", "source": src, "replaces": replaces,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms, "device_ms": dev_ms,
           "device_via": dev_via, "tflops": tflops, "candidate_err_tau": cand_err}
    phase("kernel", kernel="semantic_match", case=f"semantic_256k/{dtype}", rows=B, entries=E,
          dim=D, topk=topk, kslot=kslot, splits=ST.semantic_splits(
              B, E, torch.cuda.get_device_properties(q.device).multi_processor_count),
          rows_differing_from_twin=int(len(diff)), rows_checked_f64=n_checked + len(sample),
          band=census, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, plain_samples=3,
          kernel_samples="7 x 3", library_matmul_ms=lib_mm, library_matmul_topk_ms=lib_ms,
          library_samples=5, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
          tflops=tflops, candidate_err_tau=cand_err)
    return rep


def sem_candidate_err(torch, sem_t, q, matched, topk, dtype, rows=64) -> float:
    """The largest |score - f64 score| over every candidate the score
    kernel keeps for one batch (each split's top-k of every row), as a
    multiple of SEM_TAU; the f64 score from the same inputs (the query
    rounded to bf16 for a bf16 table), on the card in row chunks."""
    from emqx_tpu_torch.ops import semantic_table as ST

    cand_s, cand_i, _part = ST._scores(sem_t, q, matched, topk)
    vecs = torch.cat([sem_t["sem_vec"][0], sem_t["sem_hot_vec"][0]]).double()
    q64 = (q.to(torch.bfloat16) if dtype == "bfloat16" else q).double()
    worst = 0.0
    for lo in range(0, q.shape[0], rows):
        ci = cand_i[lo : lo + rows].reshape(-1, cand_i.shape[1] * topk).long()
        cs = cand_s[lo : lo + rows].reshape(ci.shape).double()
        ref = torch.einsum("rd,rcd->rc", q64[lo : lo + rows], vecs[ci.clamp(min=0)])
        diff = torch.where(ci >= 0, (cs - ref).abs(), torch.zeros_like(ref))
        worst = max(worst, float(diff.max()))
    del vecs, q64, cand_s, cand_i
    torch.cuda.empty_cache()
    return worst / SEM_TAU


def rule_uploads(torch, RC, calls) -> list:
    """-> the `rule_code` uploads (each after one `encode_progs`) that each
    of `calls` (zero-argument calls of `eval_rule_masks`) made, in order."""
    out = []
    for call in calls:
        before = RC.RULE_CODE_COUNTS["uploads"]
        call()
        out.append(RC.RULE_CODE_COUNTS["uploads"] - before)
    torch.cuda.synchronize()
    return out


def rule_kind(torch, filt, msgs, dev):
    """rule_masks at the path's batch: against its twin and the numpy host
    masks, EQUAL; bound by bytes (features and validity read once, masks
    written). The call (`ms`) finds the programs on the device; a repeated
    call must upload nothing, and one after a refresh that changes the
    rule set (the same rules in another order) exactly once. Notes: the
    uploads of those calls, and the call's time when the
    programs are not cached (encoded and uploaded every call, as before
    `rule_code` kept them)."""
    from emqx_tpu_torch.rules import compile as RC
    from emqx_tpu_torch.rules import sql as RS

    progs = filt.progs
    f_np, v_np = filt.features(msgs)
    feats, valid = torch.from_numpy(f_np).to(dev), torch.from_numpy(v_np).to(dev)
    out = RC.eval_rule_masks(progs, feats, valid)
    if not np.array_equal(out.cpu().numpy(), filt.host_masks(msgs)):
        raise AssertionError("rule_masks != the numpy host masks")
    refreshed = rule_filter(RULES_SQL, RS, RC)  # a refresh over the same rules
    changed = rule_filter(RULES_SQL[::-1], RS, RC)
    cf, cv = (torch.from_numpy(x).to(dev) for x in changed.features(msgs))
    counts = rule_uploads(torch, RC, [
        lambda: RC.eval_rule_masks(filt.progs, feats, valid),
        lambda: RC.eval_rule_masks(refreshed.progs, feats, valid),
        lambda: RC.eval_rule_masks(changed.progs, cf, cv),
        lambda: RC.eval_rule_masks(changed.progs, cf, cv)])
    if counts != [0, 0, 1, 0]:
        raise AssertionError(f"rule_code uploads {counts}: want a repeated call to "
                             "upload nothing and a changed rule set once")

    def uncached():
        RC._rule_code.clear()
        return RC.eval_rule_masks(progs, feats, valid)

    uncached_ms = time_ms(uncached, torch)
    RC.eval_rule_masks(progs, feats, valid)
    B, F = feats.shape
    n_ops = sum(len(p) for p in progs)
    return dict(
        kernel=lambda: RC.eval_rule_masks(progs, feats, valid),
        plain=lambda: RC.eval_rule_masks_plain(progs, feats, valid),
        out=out,
        bytes=5 * B * F + len(progs) * B,
        ops=B * n_ops * 4,
        notes=dict(call_uploads=counts, uncached_call_ms=uncached_ms),
    ), {"rules": len(progs), "features": F, "ops": n_ops, "device": str(dev),
        "depth": RC.rule_code(progs, dev)[0].depth, "passes": out.sum(dim=1).tolist()}


def sem_churn(rng, sem, cents, index, n_add, n_replace, n_remove, base):
    """n_add new entries (slots base + i), n_replace replacements of live
    packed entries, n_remove removes of live entries: one op-logged write
    each, D + 3 per add and replacement."""
    live = np.fromiter(sem._reg.keys(), np.int64, len(sem._reg))
    pick = rng.choice(live, n_replace + n_remove, replace=False)
    vecs = sem_vectors(rng, cents, rng.integers(0, SEM_CENTROIDS, n_add + n_replace))
    ths = rng.uniform(*SEM_THRESH, n_add + n_replace)
    scope = index._hash_lookup_batch(
        [f"device/{d}/#" for d in rng.integers(0, SEM_SCOPE_DEVICES, n_add + n_replace)])[0]
    scope = np.where(rng.random(n_add + n_replace) < 0.5, -1, scope)
    for i in range(n_add):
        sem.add(base + i, vecs[i], float(ths[i]), int(scope[i]))
    for i, s in enumerate(pick[:n_replace]):
        sem.add(int(s), vecs[n_add + i], float(ths[n_add + i]), int(scope[n_add + i]))
    for s in pick[n_replace:]:
        sem.remove(int(s))


def semantic_path(torch, rng, router_1m):
    """Phases 23-27: the semantic routing plane and the compiled rule masks
    at semantic_256k, over the mixed_1m router's index and subscriber
    table; a float32 pass (the main path) and a bfloat16 pass.
    -> (kernels-line entries, launches on the f32 pass)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import DeviceRouter
    from emqx_tpu_torch.ops import segments as G
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.rules import compile as RC
    from emqx_tpu_torch.rules import sql as RS

    index, subtab = router_1m.index, router_1m.subtab
    filt = rule_filter(RULES_SQL, RS, RC)
    ops = {op[0] for p in filt.progs for op in p}
    if len(filt.progs) != len(RULES_SQL) or ops != set(RC.OPCODES):
        raise AssertionError(f"the rule set compiles to {len(filt.progs)} programs over {ops}")
    cents = sem_centroids()
    oracle = Oracle(index, subtab)
    report = {}
    launches = None
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        sem, stages = build_semantic(rng, index, dtype, cents)
        router = DeviceRouter(index, subtab,
                              MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
                              semtab=sem, device="cuda")
        t1 = time.perf_counter()
        args = router.prepare()
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t1
        host = SemHost(sem)
        sem_bytes = {k: t.numel() * t.element_size() for k, t in args.sem_tables.items()}
        phase("tables_semantic", dtype=dtype, entries=len(sem), packed_capacity=sem._pcap,
              hot_capacity=sem._hcap, dim=SEM_DIM, topk=sem.topk, kslot=args.kslot,
              sparse_subscribers=subtab.sparse, build_stage_seconds=stages,
              router_seconds=t1 - t0, upload_seconds=upload_s, device_bytes=sem_bytes,
              segment_status=router.segment_status()["semantic"], reduced="none")
        if args.kslot <= 0 or sem_bytes["sem_vec"] != SEM_N * SEM_DIM * (
                4 if dtype == "float32" else 2):
            raise AssertionError(f"kslot {args.kslot}, sem_vec {sem_bytes['sem_vec']} B")

        # 1. the kernels against their twins, at the routed batch's shapes
        topics, q, msgs = sem_batch(rng, cents, BATCH)
        res = router.route(topics, embeds=q, rules=(filt.progs, *filt.features(msgs)))
        dev = router.device
        qd = torch.from_numpy(q).to(dev)
        md = torch.from_numpy(np.ascontiguousarray(res.matched)).to(dev)
        topic = torch.from_numpy(np.ascontiguousarray(res.slots[:, :args.kslot])).to(dev)
        report[f"semantic_match/{dtype}"] = sem_kernel_report(torch, args, host, qd, md,
                                                              topic, dtype)
        if dtype == "float32":
            kind, info = rule_kind(torch, filt, msgs, dev)
            report.update(kernel_report(torch, {"rule_masks": kind}))
            phase("kernel_inputs_rules", **info, rules_sql=list(RULES_SQL))
        gc.collect()
        torch.cuda.empty_cache()

        # 2. routed batches, then 3. churn, counters zeroed before and read after
        kernels.reset_launches()
        routed, path = [], {}
        for _ in range(SEM_ROUTE_BATCHES):
            batch = sem_batch(rng, cents, BATCH, edge=True)
            routed.append(sem_route_checked(torch, router, host, oracle, filt, path, *batch))
        after_route = dict(path)
        if after_route["semantic_match"] != 2 * SEM_ROUTE_BATCHES \
                or after_route["rule_masks"] != SEM_ROUTE_BATCHES:
            raise AssertionError(f"launches on the routed batches: {after_route}")
        phase("route_semantic", dtype=dtype, batches=routed, launches=after_route)

        churn = {}
        base = 1 << 20
        scatter_calls = []
        real_scatter = G.segment_scatter

        def recording_scatter(flats, idxs, vals):
            scatter_calls.append((dict(flats), dict(idxs), dict(vals)))
            return real_scatter(flats, idxs, vals)

        for step, (n_add, n_rep, n_rem) in (("a", (SEM_CHURN[0], 50, SEM_CHURN[0])),
                                            ("b", (SEM_CHURN[1], 0, SEM_CHURN[1]))):
            c0 = router.segment_status()["semantic"]
            t0 = time.perf_counter()
            sem_churn(rng, sem, cents, index, n_add, n_rep, n_rem, base)
            base += n_add
            t1 = time.perf_counter()
            G.segment_scatter = recording_scatter if step == "a" else real_scatter
            try:
                args = router.prepare()
                torch.cuda.synchronize()
            finally:
                G.segment_scatter = real_scatter
            t2 = time.perf_counter()
            c1 = router.segment_status()["semantic"]
            moved = {k: c1[k] - c0[k] for k in c0}
            want = ({"full_resyncs": 0, "delta_launches": 1, "array_resyncs": 4} if step == "a"
                    else {"full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0})
            if moved != want:
                raise AssertionError(f"churn {step}: mirror moved {moved}, want {want}")
            churn[step] = {"adds": n_add, "replacements": n_rep, "removes": n_rem,
                           "host_seconds": t1 - t0, "sync_ms": 1e3 * (t2 - t1),
                           "mirror": moved, "oplog": len(sem.oplog), "epoch": sem.epoch,
                           "hot_capacity": sem._hcap, "live": len(sem),
                           "mirror_bytes_equal": check_sem_mirror(torch, args, sem)}
        host = SemHost(sem)
        churn["route"] = sem_route_checked(torch, router, host, oracle, filt, path,
                                           *sem_batch(rng, cents, BATCH))
        after = take_launches(path)
        path = ("tokenize", "shape_match", "semantic_match", "rule_masks", "segment_scatter")
        if not all(after[k] for k in path):
            raise AssertionError(f"a kernel never launched on the semantic path: {after}")
        phase("churn_semantic", dtype=dtype, **churn, launches=after,
              segment_status=router.segment_status()["semantic"])
        # row 8's float lanes: the scatter of churn step A against its twin
        # (after the path's launches were read: these launches do not count)
        if len(scatter_calls) != 1:
            raise AssertionError(f"churn a: {len(scatter_calls)} scatter calls")
        kind, info = scatter_kind(torch, scatter_calls[0])
        kind["name"] = "segment_scatter"
        report[f"segment_scatter/{dtype}"] = kernel_report(
            torch, {f"segment_scatter/{dtype}": kind})[f"segment_scatter/{dtype}"]
        phase("kernel_inputs_scatter_semantic", dtype=dtype, **info)
        del scatter_calls, kind
        if dtype == "float32":
            launches = after
            brk = [sem_batch(rng, cents, BATCH) for _ in range(3)]
            phase("route_breakdown_semantic", **route_breakdown(
                torch, router, [b[0] for b in brk],
                [(q, (filt.progs, *filt.features(m))) for _t, q, m in brk]))
        del router, args, sem, host, res, qd, md, topic, msgs
        gc.collect()
        torch.cuda.empty_cache()
    entries = {"semantic_match": report["semantic_match/float32"],
               "rule_masks": report["rule_masks"],
               "segment_scatter_lanes": {"float32": report["segment_scatter/float32"],
                                         "bfloat16": report["segment_scatter/bfloat16"]}}
    phase("kernel_semantic_bf16", entry=report["semantic_match/bfloat16"])
    return entries, launches


# -- the broker_1m path (the broker's publish path) -------------------------------

BROKER_IDS, BROKER_NUMS, BROKER_HOT = 1000, 1000, 100  # mixed_1m's filters
BROKER_GROUPS, BROKER_MEMBERS = 100, 16  # $share/ingest/device/{i}/#, i < 100
BROKER_MIN_BATCH = 64
BROKER_CHURN = 1000  # plain unsubscribes, and subscribes on fresh filters
BROKER_LEAVE = 10  # groups that lose a member


class Deliveries:
    """The stub deliverers: each records (message, subscriber id)."""

    def __init__(self):
        self.log = []

    def record(self, sid, msg, _opts):
        self.log.append((msg, sid))

    def sink(self, sid):
        import functools

        return functools.partial(self.record, sid)


def broker_build():
    """BASELINE config 3 through `Broker.subscribe`: one client a filter for
    device/{i}/+/{j}/# (i, j < 1000) and device/{i}/# (i < 100), 1,000,100
    plain subscriptions, then 16 members in each of 100 round-robin groups
    $share/ingest/device/{i}/#. Before any of it, as the reference's app
    wires a broker (emqx_tpu/app.py:218-229, :392-401), an empty
    `SemanticRouting` (semantic_256k's D, top-k and lowest threshold) and a
    `RuleEngine` on the hooks with its device plane attached: the device
    router binds the semantic table when it is built, and with the table
    empty and no rule no batch carries a semantic or rule stage. Host work
    only (no CUDA call, no torch operation), so the mesh process builds it
    before it forks its ranks. -> (broker, deliveries, seconds)."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.hooks import Hooks
    from emqx_tpu_torch.broker.router import Router
    from emqx_tpu_torch.broker.semantic import SemanticRouting
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.rules.engine import RuleEngine

    rec = Deliveries()
    broker = Broker(Router(MatcherConfig(max_bytes=MAX_BYTES, max_levels=MAX_LEVELS),
                           min_tpu_batch=BROKER_MIN_BATCH), Hooks())
    broker.semantic = SemanticRouting(dim=SEM_DIM, topk=SEM_TOPK, threshold=SEM_THRESH[0],
                                      metrics=broker.metrics)
    engine = RuleEngine(broker)
    engine.attach(broker.hooks)
    engine.attach_device()
    opts = SubOpts()
    t0 = time.perf_counter()
    for i in range(BROKER_IDS):
        for j in range(BROKER_NUMS):
            sid = f"c{i}_{j}"
            broker.subscribe(sid, sid, f"device/{i}/+/{j}/#", opts, rec.sink(sid))
    for i in range(BROKER_HOT):
        sid = f"h{i}"
        broker.subscribe(sid, sid, f"device/{i}/#", opts, rec.sink(sid))
    t1 = time.perf_counter()
    for i in range(BROKER_GROUPS):
        for m in range(BROKER_MEMBERS):
            sid = f"g{i}_{m}"
            broker.subscribe(sid, sid, f"$share/ingest/device/{i}/#", opts, rec.sink(sid))
    t2 = time.perf_counter()
    return broker, rec, {"plain": t1 - t0, "groups": t2 - t1}


class BrokerTimer:
    """Host-clock spans of one `publish_batch` (each ending in a
    synchronize): the DeviceRouter's prepare and route() (which includes
    the prepare), and the broker's host dispatch
    (`_dispatch_device_results`), wrapped on the instances; `extra`: more
    (object, attribute, name) spans. `last[name]`: the latest span's
    result (route(): the batch's `RouteResult`)."""

    def __init__(self, torch, broker, extra=()):
        self.torch = torch
        dev = broker._device_router()
        self.spans = ((dev, "_device_args", "prepare"), (dev, "route", "route"),
                      (broker, "_dispatch_device_results", "host_dispatch"), *extra)
        self.samples = {name: [] for _o, _a, name in self.spans}
        self.last = {}
        for obj, attr, name in self.spans:
            setattr(obj, attr, self.wrap(getattr(obj, attr), name))

    def wrap(self, fn, name):
        def run(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.samples[name].append(1e3 * (time.perf_counter() - t0))
            self.last[name] = r
            return r
        return run

    def take(self) -> dict:
        out = {f"{k}_ms": v[-1] for k, v in self.samples.items()}
        for v in self.samples.values():
            v.clear()
        return out

    def remove(self, broker) -> None:
        """Take the wrappers (and their synchronizes) off the instances."""
        for obj, attr, _name in self.spans:
            delattr(obj, attr)
        self.last.clear()


# -- the broker_1m ingest phase (the pipelined publish path) ----------------------

INGEST_BATCHES = 6  # full batches a depth
INGEST_MAX_BATCH = BATCH


class OverlapProbe:
    """CUDA events around each routed batch of the pipeline: one recorded
    on the launching thread's stream right before the batch's first kernel
    (`shape_route_step`), one right after its readback returned
    (`DeviceRouter._readback`), with the host clock beside each. Batch
    N+1's launches began before batch N's readback ended when its first
    event precedes N's last one on the stream."""

    def __init__(self, torch, dev):
        import threading

        from emqx_tpu_torch.models import router_model as R

        self.torch, self.dev, self.R = torch, dev, R
        self.rows = []
        self.lock = threading.Lock()
        self.local = threading.local()
        step, readback = R.shape_route_step, dev._readback

        def probed_step(*a, **k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.local.start = (time.perf_counter(), ev)
            return step(*a, **k)

        def probed_readback(*a, **k):
            out = readback(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            with self.lock:
                self.rows.append((*self.local.start, ev, time.perf_counter()))
            return out

        self.step = step
        R.shape_route_step = probed_step
        dev._readback = probed_readback

    def close(self) -> dict:
        """Unwrap; -> the overlap counts over consecutive batches."""
        self.R.shape_route_step = self.step
        del self.dev._readback
        self.torch.cuda.synchronize()
        rows = sorted(self.rows, key=lambda r: r[0])  # in launch order
        if not rows:  # every batch served from the CPU (degrade_broker)
            return {"routed_batches": 0, "launch_before_prev_readback_end": 0,
                    "launch_before_prev_readback_end_host": 0}
        ref = rows[0][1]
        start = [ref.elapsed_time(r[1]) for r in rows]
        end = [ref.elapsed_time(r[2]) for r in rows]
        pairs = range(len(rows) - 1)
        return {"routed_batches": len(rows),
                "launch_before_prev_readback_end": sum(start[k + 1] < end[k] for k in pairs),
                "launch_before_prev_readback_end_host": sum(rows[k + 1][0] < rows[k][3]
                                                            for k in pairs)}


def ingest_rr_state(broker) -> dict:
    """{(filter, group): round-robin base} of every $share group."""
    return {(real, gname): g.rr_index for real, groups in broker.shared._table.items()
            for gname, g in groups.items()}


def ingest_rr_restore(broker, state) -> None:
    """Put every group's base back, on the host group and in the group
    table (a delta the next prepare syncs)."""
    for (real, gname), v in state.items():
        broker.shared.group(real, gname).rr_index = v
        broker.grouptab.set_rr(broker.grouptab.gid_of(real, gname), v)


def ingest_drive(torch, broker, rec, topics, pipeline: int, msgs=None, feed=None,
                 filters=()) -> dict:
    """`topics` (or the messages `msgs`) from concurrent `apublish` tasks
    through a running `BatchIngest(broker, max_batch=INGEST_MAX_BATCH,
    pipeline=pipeline)`, with `filters` submitted to `feed` first, the
    launch counters zeroed before and read after. -> the run's deliveries
    [(message index, subscriber)], its schedule, its figures and each
    filter's answer."""
    import asyncio

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.ingest import BatchIngest
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.utils.tracepoints import TraceCollector

    if msgs is None:
        msgs = [Message(topic=t, payload=b"%d" % k, from_client="ingest")
                for k, t in enumerate(topics)]
    index = {id(msg): k for k, msg in enumerate(msgs)}
    m = broker.metrics
    raw = collections.defaultdict(list)
    obs, obs_many = m.observe, m.observe_many
    m.observe = lambda name, v: (raw[name].append(v), obs(name, v))[1]
    m.observe_many = lambda name, vs: (raw[name].extend(vs), obs_many(name, vs))[1]
    probe = OverlapProbe(torch, broker._device_router())
    rec.log.clear()
    gc0 = [g["collections"] for g in gc.get_stats()]

    async def run():
        futs = [feed.submit(f) for f in filters]
        ing = BatchIngest(broker, max_batch=INGEST_MAX_BATCH, pipeline=pipeline)
        broker.ingest = ing
        ing.start()
        t0 = time.perf_counter()
        counts = await asyncio.gather(*(broker.apublish(msg) for msg in msgs))
        wall = time.perf_counter() - t0
        await ing.stop()
        broker.ingest = None
        return counts, wall, await asyncio.gather(*futs)

    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        with TraceCollector() as tc:
            counts, wall, answers = asyncio.run(run())
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        del m.observe, m.observe_many
        overlap = probe.close()
    gc_runs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    if sum(counts) != len(rec.log):
        raise AssertionError(f"pipeline {pipeline}: {sum(counts)} counted, "
                             f"{len(rec.log)} deliveries recorded")
    sched = [(e["kind"], e["batch"]) for e in tc.events
             if e["kind"] in ("ingest.launch", "ingest.settle")]
    settle = np.asarray(raw["ingest.settle.seconds"]) * 1e3
    idle = np.asarray(raw["ingest.device.idle.seconds"]) * 1e3
    sizes = raw["ingest.batch.size"]

    def p50_ms(name):  # None where no batch reached the stage
        return 1e3 * float(np.median(raw[name])) if raw[name] else None

    return {
        "deliveries": [(index[id(msg)], sid) for msg, sid in rec.log],
        "answers": answers,
        "schedule": sched,
        "figures": {
            "pipeline": pipeline, "messages": len(msgs), "batches": len(sizes),
            "batch_sizes": sorted(set(sizes)), **overlap,
            "messages_per_s": len(msgs) / wall, "wall_s": wall,
            "deliveries_per_s": len(rec.log) / wall,
            "settle_p50_ms": float(np.percentile(settle, 50)),
            "settle_p99_ms": float(np.percentile(settle, 99)),
            "device_idle": {"gaps": len(idle), "total_ms": float(idle.sum()),
                            "p50_ms": float(np.percentile(idle, 50)) if len(idle) else None,
                            "max_ms": float(idle.max()) if len(idle) else None},
            "prepare_p50_ms": p50_ms("profile.stage.prepare.seconds"),
            "host_dispatch_p50_ms": p50_ms("profile.stage.host_dispatch.seconds"),
            "launches": launches,
            "gc_collections_by_generation": gc_runs,
        },
    }


def pinned_schedule(batches: int, pipeline: int) -> list:
    """The `ingest.launch` / `ingest.settle` tracepoints of a run of full
    batches: batch N + pipeline - 1 launches before batch N settles, and no
    later batch does (so at depth 2 batch N + 1 is prepared before batch
    N's round-robin bases are written back, as in the reference)."""
    out = []
    for k in range(batches):
        out.append(("ingest.launch", k))
        if k >= pipeline - 1:
            out.append(("ingest.settle", k - pipeline + 1))
    return out + [("ingest.settle", k) for k in range(batches - pipeline + 1, batches)]


def ingest_check(tag: str, got, want, members: bool) -> dict:
    """The run's deliveries against the synchronous path's: every message's
    plain recipients equal; each matched $share group delivering it once
    (its member the same one too when `members`)."""
    def per_message(log):
        out = collections.defaultdict(lambda: ([], []))
        for k, sid in log:
            out[k][sid.startswith("g")].append(sid)
        return out

    g, w = per_message(got), per_message(want)
    if set(g) != set(w):
        raise AssertionError(f"{tag}: messages delivered differ from the synchronous path's")
    shared = 0
    for k, (plain, grp) in w.items():
        gp, gg = g[k]
        if sorted(gp) != sorted(plain):
            raise AssertionError(f"{tag}: message {k} plain {sorted(gp)} != {sorted(plain)}")
        groups = sorted(s.split("_")[0] for s in gg)
        if groups != sorted(s.split("_")[0] for s in grp) or len(set(groups)) != len(groups):
            raise AssertionError(f"{tag}: message {k} group deliveries {gg} against {grp}")
        if members and sorted(gg) != sorted(grp):
            raise AssertionError(f"{tag}: message {k} members {gg} != {grp}")
        shared += len(gg)
    return {"messages_delivered_to": len(w),
            "plain_deliveries": sum(len(v[0]) for v in w.values()),
            "group_deliveries": shared, "members_equal": sorted(got) == sorted(want)}


def broker_ingest(torch, broker, rec, rng) -> tuple:
    """The pipelined publish path on broker_1m: INGEST_BATCHES full batches
    of seeded mixed_1m topics through `publish_batch` (the synchronous
    path), then the same publishes from concurrent `apublish` tasks
    through `BatchIngest` at pipeline 2 and at pipeline 1, each from the
    same round-robin bases. Fails unless every message's plain recipients
    equal the synchronous path's, each matched group delivers each message
    once, and at depth 1 every delivery is the synchronous path's; and
    unless a delta `prepare()` (the loop thread's half of a launch)
    returns while a spin kernel still runs on the stream.

    The broker's 1,000,100 subscriptions are millions of objects the
    garbage collector tracks, and one full collection of them takes
    seconds: it lands in whichever run crosses the oldest generation's
    threshold. So the phase times one full collection, then freezes the
    heap (`gc.freeze()`, every object so far out of the collector's
    reach) for the three runs, which then compare the paths and not the
    collector, and unfreezes it after; each run prints its collections
    by generation. -> (the phase's record, its launches)."""
    from emqx_tpu_torch.broker.message import Message

    dev = broker._device_router()
    topics = topic_batch_1m(rng, INGEST_BATCHES * INGEST_MAX_BATCH)
    dev.prepare()
    rr0 = ingest_rr_state(broker)
    rec.log.clear()
    heap = frozen_heap()
    try:
        record, launches = ingest_runs(torch, broker, rec, dev, topics, rr0)
    finally:
        gc.unfreeze()
    return {**record, "gc": heap}, launches


def ingest_runs(torch, broker, rec, dev, topics, rr0) -> tuple:
    """`broker_ingest`'s runs and checks on a frozen heap."""
    from emqx_tpu_torch.broker.message import Message

    gc0 = [g["collections"] for g in gc.get_stats()]
    t0 = time.perf_counter()
    for k in range(0, len(topics), INGEST_MAX_BATCH):
        broker.publish_batch([Message(topic=t, payload=b"%d" % (k + j), from_client="ingest")
                              for j, t in enumerate(topics[k:k + INGEST_MAX_BATCH])])
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    sync_gc = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    want = [(int(msg.payload), sid) for msg, sid in rec.log]
    runs, checks = {}, {}
    launches = collections.Counter()
    for pipeline in (2, 1):
        ingest_rr_restore(broker, rr0)
        run = ingest_drive(torch, broker, rec, topics, pipeline)
        n = INGEST_BATCHES
        if run["schedule"] != pinned_schedule(n, pipeline):
            raise AssertionError(f"pipeline {pipeline}: schedule {run['schedule']}")
        got_l = run["figures"]["launches"]
        want_l = {"tokenize": n, "shape_match": n, "sparse_fanout_slots": n,
                  "share_pick": 2 * n, "occurrence_index": 3 * n}
        if any(got_l.get(k, 0) != v for k, v in want_l.items()) or got_l.get("nfa_walk"):
            raise AssertionError(f"pipeline {pipeline}: launches {got_l}")
        launches.update(got_l)
        checks[pipeline] = ingest_check(f"pipeline {pipeline}", run["deliveries"], want,
                                        members=pipeline == 1)
        runs[pipeline] = run["figures"]
    # the loop thread's half of a launch must not wait for the stream: a
    # delta prepare (the bases put back) while a spin kernel runs
    ingest_rr_restore(broker, rr0)
    c0 = dev.segment_status()["groups"]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    dev.prepare()
    prep_ms = 1e3 * (time.perf_counter() - t0)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    c1 = dev.segment_status()["groups"]
    if not busy or c1["delta_launches"] != c0["delta_launches"] + 1:
        raise AssertionError(f"delta prepare waited for the stream ({prep_ms} ms) or "
                             f"did not scatter ({c0} -> {c1})")
    rec.log.clear()
    record = {"card": card_line(), "max_batch": INGEST_MAX_BATCH,
              "batches_per_depth": INGEST_BATCHES, "sync_publish_batch_s": sync_s,
              "sync_messages_per_s": len(topics) / sync_s,
              "sync_gc_collections_by_generation": sync_gc,
              "depths": {str(p): {**runs[p], **checks[p]} for p in (2, 1)},
              "delta_prepare_under_spin": {"ms": prep_ms, "stream_still_busy": busy}}
    return record, dict(launches)


def broker_publish(torch, broker, rec, timer, topics, tag: int, msgs=None, got_out=None,
                   want_extra=None) -> dict:
    """One checked `publish_batch` of `topics` (or of the messages `msgs`):
    every message's plain recipients against the CPU oracle (the
    subscribers of the router's exact and trie matches, embedding-filtered
    ones apart), and every matched group's one delivery against
    `pick_oracle` (taken before the batch, the bases it reads advanced as
    `advance_rr` would after it). `got_out`: a list that receives each
    message's recipients; `want_extra`: more exact launch counts. -> the
    batch's record."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.message import Message

    r = broker.router
    gt = broker.grouptab
    if msgs is None:
        msgs = [Message(topic=t, payload=b"%d" % k, from_client=f"pub{tag}") for k, t in
                enumerate(topics)]
    gfid = np.full((len(topics), 1), -1, np.int64)
    for k, t in enumerate(topics):
        ws = t.split("/")
        if len(ws) > 1 and ws[1].isdigit() and int(ws[1]) < BROKER_GROUPS:
            fid = r.filter_id(f"device/{ws[1]}/#")
            gfid[k, 0] = -1 if fid is None else fid
    lanes, idx = pick_oracle(gt, gfid, "round_robin")
    rr0 = gt.group_rr.copy()
    rec.log.clear()
    fb0 = broker.metrics.get("messages.routed.device_fallback")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = broker.publish_batch(msgs)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    got = [[] for _ in msgs]
    pos = {id(m): k for k, m in enumerate(msgs)}
    for m, sid in rec.log:
        got[pos[id(m)]].append(sid)
    if n != len(rec.log):
        raise AssertionError(f"publish_batch returned {n}, {len(rec.log)} deliveries recorded")
    plain_n = group_n = 0
    counts = collections.Counter()
    plain_of = {}  # filter -> its plain subscribers ('#' holds many semantic ones)

    def plain_subs(f):
        got_f = plain_of.get(f)
        if got_f is None:
            got_f = plain_of[f] = {sid for sid, sub in broker._subs.get(f, {}).items()
                                   if not sub.semantic}
        return got_f

    for k, t in enumerate(topics):
        want = set().union(*(plain_subs(f) for f in r.match(t)))
        plain = [s for s in got[k] if not s.startswith(("g", "e"))]
        grp = [s for s in got[k] if s.startswith("g")]
        if len(plain) != len(set(plain)) or set(plain) != want:
            raise AssertionError(f"message {k} {t!r}: plain {sorted(plain)} != {sorted(want)}")
        g = int(lanes[k, 0])
        if g < 0:
            if grp:
                raise AssertionError(f"message {k} {t!r}: group deliveries {grp}")
        else:
            real, gname = gt.info(g)
            members = list(broker.shared.group(real, gname).members)
            if grp != [members[int(idx[k, 0])]]:
                raise AssertionError(f"message {k} {t!r}: group got {grp}, oracle "
                                     f"{members[int(idx[k, 0])]}")
            counts[g] += 1
        plain_n += len(plain)
        group_n += len(grp)
    for g, c in counts.items():  # the bases the broker wrote back
        if int(gt.group_rr[g]) != int(rr0[g]) + c:
            raise AssertionError(f"group {g}: rr {int(gt.group_rr[g])} != {int(rr0[g]) + c}")
    fell = broker.metrics.get("messages.routed.device_fallback") - fb0
    if fell:
        raise AssertionError(f"{fell} rows fell back to the CPU")
    want_launch = {"tokenize": 1, "shape_match": 1, "sparse_fanout_slots": 1,
                   "share_pick": 2, "occurrence_index": 3, "nfa_walk": 0,
                   "fanout_bitmaps": 0, "compact_fanout_slots": 0, "semantic_match": 0,
                   "rule_masks": 0, **(want_extra or {})}
    if any(launches[k] != v for k, v in want_launch.items()):
        raise AssertionError(f"broker batch launches {launches}")
    if got_out is not None:
        got_out[:] = got
    return {"messages": len(msgs), "deliveries": n, "plain": plain_n, "group": group_n,
            "groups_matched": len(counts), "publish_batch_ms": wall,
            "launches": {k: v for k, v in launches.items() if v}, **timer.take()}


def delivery_digest(got) -> str:
    """One batch's deliveries as the sha256 of its sorted (subscriber id,
    message index) pairs; `got[k]`: message k's recipients."""
    import hashlib

    pairs = sorted((sid, k) for k, sids in enumerate(got) for sid in sids)
    return hashlib.sha256(repr(pairs).encode()).hexdigest()


def broker_path(torch, rng, sess_capture=None, mesh_proc=None, ret_index=None):
    """broker_1m: BASELINE config 3 loaded through `Broker.subscribe`, with
    100 $share groups, published through `publish_batch`; its background
    compaction (`compact_broker`) and, with `sess_capture` (session_1m's
    store capture), its segment-state snapshot (`snapshot_broker`). With
    `mesh_proc`, the mesh paths run while the subscribe loop (no card
    work) builds the broker, and are joined before the first prepare. ->
    (the path's kernel cases, its launches, the `delivery_digest`s of its
    first ROUTE_BATCHES batches, which the mesh broker must reproduce, and
    the mesh report or None, the launches of its storm-carrying batches).
    With `ret_index` (the retained path's churned store) the retained feed
    and the degrade ladder run on the broker (`feed_ladder_broker`)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.ops import segments as G
    from emqx_tpu_torch.ops.csr_table import CSR_KEYS

    asked = mesh_ask(torch, mesh_proc) if mesh_proc is not None else None
    t0 = time.perf_counter()
    broker, rec, secs = broker_build()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    mesh = mesh_join(asked) if asked is not None else None
    mesh_wait_s = time.perf_counter() - t1
    subtab = broker.subtab
    n_subs = BROKER_IDS * BROKER_NUMS + BROKER_HOT + BROKER_GROUPS * BROKER_MEMBERS
    if not subtab.sparse or broker.subscription_count() != n_subs:
        raise AssertionError(f"broker_1m: sparse {subtab.sparse}, "
                             f"{broker.subscription_count()} subscriptions")
    dev = broker._device_router()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = dev.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    phase("tables_broker", subscriptions=broker.subscription_count(), filters=len(broker.router),
          slots=len(broker._slot_subs), groups=len(broker.grouptab),
          sub_table="csr" if subtab.sparse else "dense", flips=subtab.flips,
          kslot=args.kslot, kg=args.kg, m_active=args.m_active,
          residual_count=broker.router.index.residual_count,
          subscribe_seconds=secs, subscribes_per_s=n_subs / build_s,
          mesh_paths_beside=asked is not None, mesh_wait_after_build_s=mesh_wait_s,
          first_prepare_seconds=upload_s,
          device_bytes={"shapes": sum(mirror_bytes({k: v for k, v in args.tables.items()
                                                    if k not in CSR_KEYS}).values()),
                        "csr": sum(mirror_bytes({k: args.tables[k] for k in CSR_KEYS})
                                   .values()),
                        "groups": sum(mirror_bytes(args.group_tables).values())},
          reduced=[])
    timer = BrokerTimer(torch, broker)
    batches = [topic_batch_1m(rng, BATCH) for _ in range(ROUTE_BATCHES)]
    launches = collections.Counter()
    published, digests = [], []
    for k, topics in enumerate(batches):
        got = []
        published.append(broker_publish(torch, broker, rec, timer, topics, k, got_out=got))
        digests.append(delivery_digest(got))
        launches.update(published[-1]["launches"])
    phase("publish_broker", batches=published, sub_table="csr", kslot=dev.prepare().kslot,
          digests=digests)

    # churn: 1,000 plain unsubscribes on filters the next batch hits, 1,000
    # subscribes on fresh filters (device/{i}/+/{j}/# for j >= 1000, of the
    # table's shape) that it hits too, one member leaving each of 10 groups
    nxt = topic_batch_1m(rng, BATCH)
    pairs = [(i, j) for i, j in dict.fromkeys((t.split("/")[1], t.split("/")[3])
                                              for t in nxt[:BATCH - BROKER_CHURN])
             if int(i) < BROKER_IDS and int(j) < BROKER_NUMS]
    gone = pairs[:BROKER_CHURN]
    fresh = [(str(i), str(BROKER_NUMS + j)) for j, i in enumerate(
        zipf_ids(rng, BROKER_CHURN, BROKER_IDS))]
    for k, (i, j) in enumerate(fresh):
        nxt[BATCH - 1 - k] = f"device/{i}/mid/{j}/leaf"

    def state():
        # the semantic mirror too: the broker's router was built with the
        # (still empty) semantic table, which the churn does not touch
        idx, sem = broker.router.index, broker.semantic.table
        return (mirror_counts(dev),
                {"shapes": idx.shapes.version, "nfa": idx.nfa.version,
                 "bitmaps": subtab.version, "groups": broker.grouptab.version,
                 "semantic": sem.version},
                {"shapes": idx.shapes.epoch, "nfa": idx.nfa.epoch, "bitmaps": subtab.epoch,
                 "groups": broker.grouptab.epoch, "semantic": sem.epoch})

    dev.prepare()  # the last batch's round-robin bases reach the card
    c0, v0, e0 = state()
    for i, j in gone:
        if not broker.unsubscribe(f"c{i}_{j}", f"device/{i}/+/{j}/#"):
            raise AssertionError(f"unsubscribe c{i}_{j} refused")
    for i, j in fresh:
        sid = f"n{i}_{j}"
        broker.subscribe(sid, sid, f"device/{i}/+/{j}/#", SubOpts(), rec.sink(sid))
    for i in range(BROKER_LEAVE):
        broker.unsubscribe(f"g{i}_0", f"$share/ingest/device/{i}/#")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.prepare()
    torch.cuda.synchronize()
    sync_ms = 1e3 * (time.perf_counter() - t0)
    sync_launches = kernels.LAUNCHES["segment_scatter"]
    c1, v1, e1 = state()
    moves = check_wave("broker churn", c0, c1, e0, e1, {m: v1[m] != v0[m] for m in v0})
    mirrors = check_mirrors(torch, dev)
    if sync_launches != G.SCATTER_LAUNCHES * sum(moves["delta_launches"].values()) or \
            any(v > 1 for v in moves["delta_launches"].values()):
        raise AssertionError(f"churn sync: {sync_launches} scatters, moves {moves}")
    after = broker_publish(torch, broker, rec, timer, nxt, 9)
    launches.update(after["launches"])
    # each change shows: the gone subscribers get nothing, the fresh ones
    # their rows, the members that left nothing
    got = {sid for m, sid in rec.log}
    left = {f"g{i}_0" for i in range(BROKER_LEAVE)}
    if got & ({f"c{i}_{j}" for i, j in gone} | left):
        raise AssertionError("a removed subscription still received")
    if not {f"n{i}_{j}" for i, j in fresh} <= got:
        raise AssertionError("a fresh subscription received nothing")
    phase("churn_broker", unsubscribed=len(gone), subscribed=len(fresh),
          members_left=BROKER_LEAVE, prepare_ms=sync_ms, scatter_launches=sync_launches,
          **moves, mirrors_equal=mirrors, batch=after, segment_status=mirror_counts(dev))

    # the match-only router: Router.match_batch against Router.match
    topics = topic_batch_1m(rng, BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = broker.router.match_batch(topics)
    match_ms = 1e3 * (time.perf_counter() - t0)
    match_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for t, names in zip(topics, got):
        if sorted(names) != sorted(broker.router.match(t)):
            raise AssertionError(f"Router.match_batch {t!r}: {names}")
    if match_launches != {"tokenize": 1, "shape_match": 1}:
        raise AssertionError(f"match-only launches {match_launches}")
    phase("match_only_broker", topics=len(topics), match_batch_ms=match_ms,
          matches=sum(len(n) for n in got), launches=match_launches,
          segment_status=broker.router.matcher.segment_status())

    # where a broker batch's time goes: 3 more checked batches
    brk = [broker_publish(torch, broker, rec, timer, topic_batch_1m(rng, BATCH), 20 + k)
           for k in range(3)]
    for b in brk:
        launches.update(b["launches"])
    med = {k: float(np.median([b[k] for b in brk])) for k in
           ("publish_batch_ms", "prepare_ms", "route_ms", "host_dispatch_ms")}
    med["deliveries"] = float(np.median([b["deliveries"] for b in brk]))
    med["messages_per_s"] = BATCH / (med["publish_batch_ms"] / 1e3)
    med["deliveries_per_s"] = med["deliveries"] / (med["publish_batch_ms"] / 1e3)
    med["route_share"] = med["route_ms"] / med["publish_batch_ms"]
    med["host_dispatch_share"] = med["host_dispatch_ms"] / med["publish_batch_ms"]
    # the device's busy share of one more publish_batch, from its trace (a
    # trace that came back without device events is taken again, on a
    # fresh batch, up to three times)
    for attempt in range(1, 4):
        msgs = [Message(topic=t, payload=b"%d" % k, from_client=f"pub{30 + attempt}")
                for k, t in enumerate(topic_batch_1m(rng, BATCH))]
        events, wall = profiled(torch, lambda: broker.publish_batch(msgs), 1)
        busy = sum(e.self_device_time_total for e in events) / 1e6
        rec.log.clear()
        timer.take()
        if busy > 0:
            break
    med.update(traced_publish_batch_ms=1e3 * wall, traced_device_ms=1e3 * busy,
               device_busy_share=busy / wall if busy > 0 else None, trace_attempts=attempt)
    phase("breakdown_broker", subscribe_seconds=secs, first_batch=published[0],
          **med)

    # the pipelined publish path: BatchIngest at depths 2 and 1 against the
    # synchronous path, from the same bases (the timer's synchronizes off)
    timer.remove(broker)
    ingest, ingest_launches = broker_ingest(torch, broker, rec, rng)
    launches.update(ingest_launches)
    phase("ingest_broker", **ingest)

    # the path's kernels at broker_1m shapes, against their twins
    args = dev.prepare()
    kinds, inputs = share_kinds(torch, dev, args, batches[0])
    keep = ("tokenize", "shape_match", "sparse_fanout_slots", "occurrence_index",
            "share_pick/round_robin")
    report = kernel_report(torch, {k: kinds[k] for k in keep})
    phase("kernel_inputs_broker", **inputs)
    phase("broker_launches", launches=dict(launches))

    # the retained feed and the degrade ladder on this broker
    storm_launches, fault_after = {}, None
    if ret_index is not None:
        storm_launches, fault_after = feed_ladder_broker(torch, broker, rec, ret_index)

    # the shape and CSR tables' background compaction
    phase("compact_broker", **compact_broker(torch, broker, rec, rng))

    # the semantic plane and the rule engine's device attach on this broker
    t0 = time.perf_counter()
    sem_launches = semantic_broker(torch, broker, rec, rng)
    launches.update(sem_launches)
    phase("semantic_broker_seconds", seconds=time.perf_counter() - t0,
          launches=dict(sem_launches))
    app_launches = None
    if sess_capture is not None:
        import shutil

        fields, data_dir, want_tables = snapshot_broker(torch, broker, rec, rng, sess_capture)
        phase("snapshot_broker", **fields)
        try:
            # the app boots from the data dir the snapshot wrote (no full
            # collection here: over the brokers' millions of objects it
            # costs seconds, and nothing below needs the memory back)
            broker._device = None
            torch.cuda.empty_cache()
            app_launches = app_path(torch, data_dir, want_tables, rng)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
    if fault_after is not None and fault_series(broker) != {
            **fault_after, "messages.routed.device": broker.metrics.get(
                "messages.routed.device")}:
        # no phase after the fault phases degraded a batch or met a fault
        raise AssertionError(f"broker_1m after the fault phases: {fault_series(broker)} "
                             f"against {fault_after}")
    del broker, rec, dev, timer
    gc.collect()
    torch.cuda.empty_cache()
    return report, dict(launches), digests, mesh, storm_launches, app_launches


# -- the broker_1m retained feed and degrade ladder phases -----------------------

FEED_WINDOW_S = 30.0  # past the phase: only a device batch can answer the storm
FLUSH_WINDOW_S = 0.01  # flush_broker: the standalone flush's window
RETAINER_N = 1 << 16  # retainer_broker: retained messages in the port's Retainer
RETAINER_THRESHOLD = 10_000
RETAINER_REDUCED = [
    "retained messages 65,536 (+16 deep topics) of retained_5m's 5,000,000 in the "
    "Retainer: its Python trie at 5M would cost minutes of host inserts; feed_broker "
    "and flush_broker ride the full 5.3M-topic store"]
RETAINER_DEEP = 16  # deep/1/2/3/4/5/6/{k}: 8 levels, under a 9-level filter
# the breaker's open window: longer than the tripped batch's CPU fallback
# takes on a slow host (0.5 s read half-open there before the check)
DEGRADE_OPEN_S = 1.5
DEGRADE_BATCHES = 2  # full batches through BatchIngest while launches fail
LADDER_STORM = 64  # storm filters pending while the launches fail
ROLLBACK_SUBS = 16  # fresh subscriptions each rollback round
FAULT_SERIES = ("degrade.retries", "degrade.fallback.batches", "degrade.trips.device",
                "degrade.probe.ok", "degrade.probe.fail", "faults.injected",
                "router.sync.rollback", "messages.routed.device")


class NoTimer:
    """`broker_publish`'s timer once `BrokerTimer` is off: no spans."""

    def take(self) -> dict:
        return {}


class Chan:
    """A stub channel: each retained delivery's (topic, retained mark)."""

    def __init__(self):
        self.got = []

    def handle_deliver(self, msg, _opts):
        self.got.append((msg.topic, msg.headers.get("retained")))


def broker_msgs(topics, tag: str) -> list:
    from emqx_tpu_torch.broker.message import Message

    return [Message(topic=t, payload=b"%d" % k, from_client=f"pub{tag}")
            for k, t in enumerate(topics)]


def per_message(rec, msgs) -> list:
    """The recorded deliveries -> each message's recipients, in order."""
    pos = {id(m): k for k, m in enumerate(msgs)}
    got = [[] for _ in msgs]
    for m, sid in rec.log:
        got[pos[id(m)]].append(sid)
    return got


def as_pairs(got) -> list:
    return [(k, sid) for k, sids in enumerate(got) for sid in sids]


def fault_series(broker) -> dict:
    return {k: broker.metrics.get(k) for k in FAULT_SERIES}


def series_moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def healthy_series(what: str, moved: dict, rows: int) -> dict:
    """A phase without a fault: no degraded batch, no injected fault, no
    rollback, and every row it routed on the device."""
    want = {k: 0 for k in FAULT_SERIES}
    want["messages.routed.device"] = rows
    if moved != want:
        raise AssertionError(f"{what}: {moved}, expected {want}")
    return moved


def timed_batch(torch, broker, rec, msgs, feed=None, filters=(), sync=False) -> tuple:
    """One batch, the launch counters zeroed before and read after: through
    `adispatch_begin` and `complete()` (depth 1), with `filters` submitted
    to `feed` just before it, or (`sync`) through `publish_batch`. -> (each
    message's recipients, the batch's ms, its launches, each filter's
    answer)."""
    import asyncio

    from emqx_tpu_torch import kernels

    async def run():
        futs = [feed.submit(f) for f in filters]
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sync:
            counts = broker.publish_batch(msgs)
        else:
            counts = await broker.adispatch_begin(msgs).complete()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        return counts, ms, launches, await asyncio.gather(*futs)

    rec.log.clear()
    counts, ms, launches, answers = asyncio.run(run())
    total = counts if sync else sum(counts)  # publish_batch returns the total
    if total != len(rec.log):
        raise AssertionError(f"{total} counted, {len(rec.log)} deliveries recorded")
    return per_message(rec, msgs), ms, launches, answers


def ladder_ingest(torch, broker, rec, msgs, feed=None, filters=()) -> tuple:
    """`ingest_drive` at pipeline 1 over `msgs` (full batches, each settled
    before the next launches). -> (deliveries [(message index,
    subscriber)], the run's ms, its launches, each filter's answer)."""
    run = ingest_drive(torch, broker, rec, None, 1, msgs=msgs, feed=feed, filters=filters)
    fig = run["figures"]
    return run["deliveries"], 1e3 * fig["wall_s"], fig["launches"], run["answers"]


def storm_topics(index, rows) -> list:
    return sorted(index.topic_at(int(r)) for r in rows)


def storm_launch_want(chunks: int) -> dict:
    """A B-row broker_1m batch carrying a storm over `chunks` chunks: one
    storm launch train a chunk beside the route half's launches."""
    return {"row_lengths": chunks, "narrow_i16": chunks, "tokenize": 1 + chunks,
            "shape_match": 1 + chunks, "sparse_fanout_slots": 1, "share_pick": 2,
            "occurrence_index": 3}


def feed_broker(torch, broker, rec, rng, index) -> tuple:
    """retained_5m's storm (the churned 5.3M-topic store of the retained
    path) submitted to a `RetainedStormFeed` on broker_1m's broker and
    answered by one B = 8192 batch through `adispatch_begin`: every
    filter's topics equal to a standalone `match_many` of the storm, the
    batch's deliveries equal to the same batch's without a storm (from the
    same round-robin bases), `retained.storm.fused` 1. -> (record, the
    fused batch's launches)."""
    from emqx_tpu_torch.broker.retained_feed import RetainedStormFeed

    storm = [f"site/+/dev/{d}/ch/#" for d in range(RET_STORM)]
    topics = topic_batch_1m(rng, BATCH)
    dev = broker._device_router()
    dev.prepare()
    rr0 = ingest_rr_state(broker)
    s0 = fault_series(broker)
    m = broker.metrics
    c0 = {k: m.get(f"retained.storm.{k}") for k in ("filters", "fused", "flushed")}
    bare, bare_ms, bare_launches, _ = timed_batch(torch, broker, rec, broker_msgs(topics, "f"))
    ingest_rr_restore(broker, rr0)
    feed = RetainedStormFeed(index, metrics=m, window_s=FEED_WINDOW_S)
    broker.retained_feed = feed
    try:
        fused, fused_ms, launches, answers = timed_batch(
            torch, broker, rec, broker_msgs(topics, "f"), feed, storm)
    finally:
        broker.retained_feed = None
    moved = healthy_series("feed_broker", series_moved(s0, fault_series(broker)), 2 * BATCH)
    counts = {k: m.get(f"retained.storm.{k}") - c0[k] for k in c0}
    if counts != {"filters": RET_STORM, "fused": 1, "flushed": 0}:
        raise AssertionError(f"feed_broker: storm counters {counts}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone = index.match_many(storm)
    alone_ms = 1e3 * (time.perf_counter() - t0)
    pairs = 0
    for f, got in zip(storm, answers):
        want = storm_topics(index, alone[f])
        if got is None or sorted(got) != want:
            raise AssertionError(f"feed_broker {f}: the fused storm's topics differ from "
                                 "match_many's")
        pairs += len(want)
    if delivery_digest(fused) != delivery_digest(bare):
        raise AssertionError("feed_broker: the fused batch delivered otherwise than the bare one")
    chunks = len(index._host_b)
    want = storm_launch_want(chunks)
    if any(launches.get(k) != v for k, v in want.items()):
        raise AssertionError(f"feed_broker: launches {launches}, expected {want}")
    return {"filters": RET_STORM, "pairs": pairs, "chunks": chunks, "topics": len(index),
            "bucket": index.bucket, "storm_counters": counts, "series": moved,
            "digest": delivery_digest(fused), "fused_publish_ms": fused_ms,
            "bare_publish_ms": bare_ms, "standalone_match_many_ms": alone_ms,
            "launches": launches, "bare_launches": bare_launches}, \
        {k: launches[k] for k in ("row_lengths", "narrow_i16", "tokenize", "shape_match")}


def flush_broker(torch, broker, index) -> dict:
    """The same storm with no publish: the feed's window (10 ms) elapses
    and one standalone pass answers every filter (the chunk sync on the
    loop thread, the launches and readback on the dispatch pool): the
    topics equal to `match_many`'s, `retained.storm.flushed` 1."""
    import asyncio

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.retained_feed import RetainedStormFeed

    storm = [f"site/+/dev/{d}/ch/#" for d in range(RET_STORM)]
    m = broker.metrics
    s0 = fault_series(broker)
    c0 = {k: m.get(f"retained.storm.{k}") for k in ("filters", "fused", "flushed")}
    feed = RetainedStormFeed(index, metrics=m, window_s=FLUSH_WINDOW_S)
    broker.retained_feed = feed

    async def run():
        t0 = time.perf_counter()
        answers = await asyncio.gather(*[feed.submit(f) for f in storm])
        return answers, 1e3 * (time.perf_counter() - t0)

    kernels.reset_launches()
    try:
        answers, ms = asyncio.run(run())
    finally:
        broker.retained_feed = None
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    moved = healthy_series("flush_broker", series_moved(s0, fault_series(broker)), 0)
    counts = {k: m.get(f"retained.storm.{k}") - c0[k] for k in c0}
    if counts != {"filters": RET_STORM, "fused": 0, "flushed": 1}:
        raise AssertionError(f"flush_broker: storm counters {counts}")
    alone = index.match_many(storm)
    for f, got in zip(storm, answers):
        if got is None or sorted(got) != storm_topics(index, alone[f]):
            raise AssertionError(f"flush_broker {f}: the flushed topics differ from match_many's")
    chunks = len(index._host_b)
    want = {"row_lengths": chunks, "narrow_i16": chunks, "tokenize": chunks,
            "shape_match": chunks}
    if launches != want:
        raise AssertionError(f"flush_broker: launches {launches}, expected {want}")
    return {"filters": RET_STORM, "window_s": FLUSH_WINDOW_S, "storm_counters": counts,
            "series": moved, "submit_to_answer_ms": ms, "launches": launches}


class RetainedWords:
    """A host oracle over the stored topics (`Retainer.topics()`): a
    filter's matches are the topics `topics.match` accepts among those
    that carry its rarest literal word at its position."""

    def __init__(self, topics):
        self.topics = topics
        self.at = collections.defaultdict(list)
        for t in topics:
            for pos, w in enumerate(t.split("/")):
                self.at[(pos, w)].append(t)

    def match(self, filter_: str) -> list:
        from emqx_tpu_torch.ops import topics as T

        lit = [(pos, w) for pos, w in enumerate(filter_.split("/")) if w not in ("+", "#")]
        cands = min((self.at.get(k, []) for k in lit), key=len) if lit else self.topics
        return sorted(t for t in cands if T.match(t, filter_))


def retainer_broker(torch, broker, rec, rng) -> tuple:
    """A port `Retainer(enable_device=True, device_threshold=10,000)` with
    65,536 retained messages of retained_5m's topics (and 16 deep ones),
    attached to broker_1m's hooks with a feed on its device index: 256
    `session.subscribed` hook calls (255 storm filters and one filter past
    max_levels, which takes the trie walk), then one broker_1m batch that
    carries the storm. Each channel's retained deliveries equal the host
    oracle over `Retainer.topics()`, each marked retained. -> (record, the
    batch's launches)."""
    import asyncio

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.retained_feed import RetainedStormFeed
    from emqx_tpu_torch.broker.retainer import Retainer
    from emqx_tpu_torch.mqtt.packet import SubOpts

    t0 = time.perf_counter()
    retainer = Retainer(enable_device=True, device_threshold=RETAINER_THRESHOLD)
    stored = retained_topics(range(RETAINER_N)) + \
        [f"deep/1/2/3/4/5/6/{k}" for k in range(RETAINER_DEEP)]
    retainer.load(Message(topic=t, payload=b"r%d" % k, retain=True)
                  for k, t in enumerate(stored))
    load_s = time.perf_counter() - t0
    index = retainer._device
    if len(retainer) != len(stored) or len(index) != len(stored) or retainer._device_unfit:
        raise AssertionError(f"retainer: {len(retainer)} stored, {len(index)} on the device")
    filters = [f"site/{s}/#" for s in range(128)] + \
        [f"site/{s}/dev/+/ch/+" for s in range(128, 192)] + \
        [f"site/+/dev/{d}/ch/#" for d in range(63)]
    deep = "deep/1/2/3/4/5/+/+/#"  # 9 levels: past max_levels, the trie walk
    feed = RetainedStormFeed(index, metrics=broker.metrics, window_s=FEED_WINDOW_S)
    retainer.storm_feed = feed
    if not all(retainer._storm_eligible(f) for f in filters) or retainer._storm_eligible(deep):
        raise AssertionError("retainer: the storm filters' eligibility is not as planned")
    hooks = broker.hooks
    saved = {k: list(v) for k, v in hooks._table.items()}
    m = broker.metrics
    s0 = fault_series(broker)
    c0 = {k: m.get(f"retained.storm.{k}") for k in ("filters", "fused", "flushed")}
    msgs = broker_msgs(topic_batch_1m(rng, BATCH), "r")
    chans = {f: Chan() for f in filters + [deep]}

    async def run():
        for f, ch in chans.items():
            await hooks.arun("session.subscribed", {}, f, SubOpts(), ch)
        for _ in range(1000):  # the replay tasks submit to the feed
            if len(feed) == len(filters):
                break
            await asyncio.sleep(0)
        pending = len(feed)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = await broker.adispatch_begin(msgs).complete()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for _ in range(2000):  # the replay tasks deliver
            if all(ch.got for ch in chans.values()):
                break
            await asyncio.sleep(0.005)
        return pending, counts, ms, launches

    broker.retained_feed = feed
    retainer.attach(hooks)
    rec.log.clear()
    try:
        pending, counts, ms, launches = asyncio.run(run())
    finally:
        hooks._table.clear()
        hooks._table.update(saved)
        broker.retained_feed = None
    if sum(counts) != len(rec.log):
        raise AssertionError(f"retainer_broker: {sum(counts)} counted, {len(rec.log)} recorded")
    moved = healthy_series("retainer_broker", series_moved(s0, fault_series(broker)), BATCH)
    storm_counts = {k: m.get(f"retained.storm.{k}") - c0[k] for k in c0}
    if pending != len(filters) or storm_counts != {"filters": len(filters), "fused": 1,
                                                     "flushed": 0}:
        raise AssertionError(f"retainer_broker: {pending} pending, counters {storm_counts}")
    want = storm_launch_want(1)
    if any(launches.get(k) != v for k, v in want.items()):
        raise AssertionError(f"retainer_broker: launches {launches}, expected {want}")
    oracle = RetainedWords(retainer.topics())
    deliveries = 0
    for f, ch in chans.items():
        got = sorted(ch.got)
        if got != [(t, True) for t in oracle.match(f)] or not got:
            raise AssertionError(f"retainer_broker {f}: {len(got)} deliveries against the "
                                 "oracle's")
        deliveries += len(got)
    return {"retained": len(retainer), "device_threshold": RETAINER_THRESHOLD,
            "load_seconds": load_s, "subscribes": len(chans), "storm_filters": len(filters),
            "trie_walk_filter": deep, "retained_deliveries": deliveries,
            "storm_counters": storm_counts, "series": moved, "batch_publish_ms": ms,
            "launches": launches, "reduced": RETAINER_REDUCED}, \
        {k: launches[k] for k in ("row_lengths", "narrow_i16", "tokenize", "shape_match")}


def degrade_broker(torch, broker, rec, rng, index) -> dict:
    """`DegradeController(max_retries=2, open_secs=1.5)` on broker_1m, the
    `device.launch` fault armed: 2 full batches through `BatchIngest` at
    pipeline 1, a 64-filter storm pending on the feed: batch 1 fails its
    launch and 2 bare retries and is served from the CPU (the breaker
    trips), batch 2 makes no device attempt; plain deliveries equal the
    healthy run's, each matched group delivers each message once, the
    storm's waiters get the CPU-fallback signal and the storm rides no
    retry. Disarmed, the dwell out, one probe batch: the kernels launch,
    the breaker closes, the deliveries are the healthy batch's. Then the
    synchronous gate with `device.readback` on `publish_batch`."""
    from emqx_tpu_torch.broker.degrade import CLOSED, OPEN, DegradeController
    from emqx_tpu_torch.broker.retained_feed import RetainedStormFeed
    from emqx_tpu_torch.observe import faults

    m = broker.metrics
    inj = faults.default_faults
    deg = DegradeController(metrics=m, max_retries=2, open_secs=DEGRADE_OPEN_S, seed=SEED)
    topics = topic_batch_1m(rng, DEGRADE_BATCHES * BATCH)
    dev = broker._device_router()
    dev.prepare()
    rr0 = ingest_rr_state(broker)
    s0 = fault_series(broker)
    healthy, healthy_ms, healthy_launches, _ = ladder_ingest(
        torch, broker, rec, broker_msgs(topics, "d"))
    healthy_series("degrade_broker (healthy)", series_moved(s0, fault_series(broker)),
                   DEGRADE_BATCHES * BATCH)
    if healthy_launches.get("tokenize") != DEGRADE_BATCHES:
        raise AssertionError(f"degrade_broker healthy launches {healthy_launches}")
    out = {"healthy": {"batches": DEGRADE_BATCHES, "ms": healthy_ms,
                       "ms_per_batch": healthy_ms / DEGRADE_BATCHES,
                       "launches": healthy_launches}}

    # the ladder: every launch raises
    broker.degrade = deg
    ingest_rr_restore(broker, rr0)
    feed = RetainedStormFeed(index, metrics=m, window_s=FEED_WINDOW_S)
    broker.retained_feed = feed
    calls, cpu_ms = [], []
    real_route, real_cpu = dev.route_prepared, broker._dispatch_cpu_batch

    def spy(args, topics_, client_hashes=None, retained=None, *a, **k):
        calls.append(retained is not None)
        return real_route(args, topics_, client_hashes, retained, *a, **k)

    def timed_cpu(msgs_):
        t0 = time.perf_counter()
        res = real_cpu(msgs_)
        cpu_ms.append(1e3 * (time.perf_counter() - t0))
        return res

    dev.route_prepared, broker._dispatch_cpu_batch = spy, timed_cpu
    s0 = fault_series(broker)
    inj.arm("device.launch", mode="raise")
    try:
        got, ms, launches, answers = ladder_ingest(
            torch, broker, rec, broker_msgs(topics, "d"), feed,
            [f"site/+/dev/{d}/ch/#" for d in range(LADDER_STORM)])
    finally:
        inj.disarm()
        del dev.route_prepared, broker._dispatch_cpu_batch
        broker.retained_feed = None
    moved = series_moved(s0, fault_series(broker))
    want = {"degrade.retries": 2, "degrade.fallback.batches": DEGRADE_BATCHES,
            "degrade.trips.device": 1, "degrade.probe.ok": 0, "degrade.probe.fail": 0,
            "faults.injected": 3, "router.sync.rollback": 0, "messages.routed.device": 0}
    if moved != want or deg.device.trips != 1 or deg.device.state != OPEN:
        raise AssertionError(f"degrade_broker: {moved} ({deg.device.state}), expected {want}")
    # the prepares' group-table deltas scatter (the bases put back); no
    # route kernel launches: every launch raised at its fault site first
    if calls != [True, False, False] or set(launches) - {"segment_scatter"} or \
            any(a is not None for a in answers):
        raise AssertionError(f"degrade_broker: route_prepared calls {calls} (storm-carrying "
                             f"True), launches {launches}, storm answers "
                             f"{sorted(set(map(type, answers)), key=str)}")
    if len(cpu_ms) != DEGRADE_BATCHES:
        raise AssertionError(f"degrade_broker: {len(cpu_ms)} CPU batches")
    check = ingest_check("degrade_broker", got, healthy, members=False)
    out["ladder"] = {"series": moved, "route_prepared_calls": calls,
                     "storm_filters": LADDER_STORM, "storm_answers_fallback": len(answers),
                     "ms": ms, "cpu_batch_ms": cpu_ms, **check}

    # the probe: disarmed, the dwell out, one batch re-closes the breaker
    time.sleep(DEGRADE_OPEN_S + 0.05)
    ingest_rr_restore(broker, rr0)
    s0 = fault_series(broker)
    probe, probe_ms, probe_launches, _ = ladder_ingest(
        torch, broker, rec, broker_msgs(topics[:BATCH], "d"))
    moved = series_moved(s0, fault_series(broker))
    if deg.device.state != CLOSED or moved["degrade.probe.ok"] != 1 or \
            moved["messages.routed.device"] != BATCH or moved["faults.injected"]:
        raise AssertionError(f"degrade_broker probe: {moved} ({deg.device.state})")
    if any(probe_launches.get(k) != v for k, v in
           {"tokenize": 1, "shape_match": 1, "sparse_fanout_slots": 1}.items()):
        raise AssertionError(f"degrade_broker probe launches {probe_launches}")
    if sorted(probe) != sorted(p for p in healthy if p[0] < BATCH):
        raise AssertionError("degrade_broker: the probe batch delivered otherwise than "
                             "the healthy batch")
    out["probe"] = {"series": moved, "ms": probe_ms, "launches": probe_launches,
                    "state": deg.device.state, "digest_equal": True}

    # the synchronous gate: `device.readback` on publish_batch
    ingest_rr_restore(broker, rr0)
    sync_ok, sync_ms, _l, _a = timed_batch(torch, broker, rec,
                                           broker_msgs(topics[:BATCH], "s"), sync=True)
    ingest_rr_restore(broker, rr0)
    s0 = fault_series(broker)
    inj.arm("device.readback", mode="raise")
    try:
        sync_bad, bad_ms, bad_launches, _a = timed_batch(
            torch, broker, rec, broker_msgs(topics[:BATCH], "s"), sync=True)
    finally:
        inj.disarm()
    moved = series_moved(s0, fault_series(broker))
    if (moved["degrade.fallback.batches"], moved["faults.injected"],
            moved["degrade.trips.device"], moved["messages.routed.device"]) != (1, 1, 1, 0) \
            or deg.device.state != OPEN:
        raise AssertionError(f"degrade_broker sync: {moved} ({deg.device.state})")
    sync_check = ingest_check("degrade_broker sync", as_pairs(sync_bad), as_pairs(sync_ok),
                              members=False)
    time.sleep(DEGRADE_OPEN_S + 0.05)
    ingest_rr_restore(broker, rr0)
    s1 = fault_series(broker)
    sync_probe, sync_probe_ms, sync_probe_launches, _a = timed_batch(
        torch, broker, rec, broker_msgs(topics[:BATCH], "s"), sync=True)
    moved_probe = series_moved(s1, fault_series(broker))
    if deg.device.state != CLOSED or moved_probe["degrade.probe.ok"] != 1 or \
            sync_probe_launches.get("tokenize") != 1 or \
            delivery_digest(sync_probe) != delivery_digest(sync_ok):
        raise AssertionError(f"degrade_broker sync probe: {moved_probe} ({deg.device.state})")
    broker.degrade = None
    out["sync"] = {"device_batch_ms": sync_ms, "cpu_fallback_batch_ms": bad_ms,
                   "failed_batch_launches": bad_launches, "series": moved,
                   "probe_ms": sync_probe_ms, "probe_launches": sync_probe_launches,
                   **sync_check}
    out["controller"] = deg.snapshot()
    return out


def rollback_broker(torch, broker, rec, rng) -> dict:
    """Two rounds, `router.delta_sync` armed `raise` then `corrupt`: 16
    fresh subscriptions whose topics the batch carries, the sync failing:
    the batch's deliveries equal the pre-subscribe batch's (the last good
    epoch serves), `router.sync.rollback` 1; disarmed, the next batch
    (checked as `broker_publish` checks) delivers to every fresh
    subscription; the mirrors equal the host tables after."""
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.observe import faults

    inj = faults.default_faults
    dev = broker._device_router()
    out = {}
    for r, mode in enumerate(("raise", "corrupt")):
        topics = topic_batch_1m(rng, BATCH)
        fresh = [(100 * r + k, 3000 + 100 * r + k) for k in range(ROLLBACK_SUBS)]
        for k, (i, j) in enumerate(fresh):
            topics[BATCH - 1 - k] = f"device/{i}/mid/{j}/leaf"
        dev.prepare()
        rr0 = ingest_rr_state(broker)
        pre, pre_ms, _l, _a = timed_batch(torch, broker, rec, broker_msgs(topics, "b"),
                                          sync=True)
        sids = {f"rb{i}_{j}" for i, j in fresh}
        for i, j in fresh:
            broker.subscribe(f"rb{i}_{j}", f"rb{i}_{j}", f"device/{i}/+/{j}/#", SubOpts(),
                             rec.sink(f"rb{i}_{j}"))
        ingest_rr_restore(broker, rr0)
        s0 = fault_series(broker)
        inj.arm("router.delta_sync", mode=mode)
        try:
            stale, stale_ms, stale_launches, _a = timed_batch(
                torch, broker, rec, broker_msgs(topics, "b"), sync=True)
        finally:
            inj.disarm()
        moved = series_moved(s0, fault_series(broker))
        if moved["router.sync.rollback"] != 1 or moved["messages.routed.device"] != BATCH or \
                moved["degrade.fallback.batches"] or \
                delivery_digest(stale) != delivery_digest(pre) or \
                sids & {s for g in stale for s in g}:
            raise AssertionError(f"rollback_broker {mode}: {moved}, digest equal "
                                 f"{delivery_digest(stale) == delivery_digest(pre)}")
        ingest_rr_restore(broker, rr0)
        got = []
        healed = broker_publish(torch, broker, rec, NoTimer(), topics, 40 + r, got_out=got)
        if not sids <= {s for g in got for s in g}:
            raise AssertionError(f"rollback_broker {mode}: a fresh subscription got nothing")
        out[mode] = {"subscribed": len(fresh), "series": moved, "pre_ms": pre_ms,
                     "rolled_back_batch_ms": stale_ms, "rolled_back_launches": stale_launches,
                     "healed": healed}
    out["mirrors_equal"] = check_mirrors(torch, dev)
    for r in range(2):
        for k in range(ROLLBACK_SUBS):
            i, j = 100 * r + k, 3000 + 100 * r + k
            broker.unsubscribe(f"rb{i}_{j}", f"device/{i}/+/{j}/#")
    return out


def feed_ladder_broker(torch, broker, rec, index) -> dict:
    """The retained feed and the degrade ladder on broker_1m: `feed_broker`,
    `flush_broker`, `retainer_broker`, then the fault phases
    `degrade_broker` and `rollback_broker`, on a frozen heap, with the
    injector's metrics on the broker's. -> the launches of the batches
    that carried a storm (`broker_1m_storm_launches`)."""
    from emqx_tpu_torch.observe import faults

    rng = np.random.default_rng(SEED + 22)
    faults.default_faults.metrics = broker.metrics
    heap = frozen_heap()
    t0 = time.perf_counter()
    storm_launches = collections.Counter()
    try:
        rec_feed, launches = feed_broker(torch, broker, rec, rng, index)
        storm_launches.update(launches)
        phase("feed_broker", **rec_feed, gc=heap, card=card_line())
        phase("flush_broker", **flush_broker(torch, broker, index), card=card_line())
        rec_ret, launches = retainer_broker(torch, broker, rec, rng)
        storm_launches.update(launches)
        phase("retainer_broker", **rec_ret, card=card_line())
        phase("degrade_broker", **degrade_broker(torch, broker, rec, rng, index),
              card=card_line())
        phase("rollback_broker", **rollback_broker(torch, broker, rec, rng), card=card_line())
    finally:
        faults.default_faults.disarm()
        broker.degrade = None
        broker.retained_feed = None
        gc.unfreeze()
    after = fault_series(broker)
    phase("feed_ladder_seconds", seconds=time.perf_counter() - t0, series=after,
          storm_launches=dict(storm_launches))
    return dict(storm_launches), after


# -- the broker_1m semantic phases (the semantic plane and the rule engine) ------

# semantic_256k's filters bound through Broker.subscribe, cut to a quarter:
# a semantic subscribe costs 0.27-0.45 ms on the card's host CPU (this
# phase at 262,144 took 71.3-117.2 s), which would take the whole script
# past 1,100 s of its 1,200 s limit. The semantic_256k path keeps all
# 262,144 entries, so both kernels are still held at full scale there.
SEM_BROKER_N = 1 << 16
SEM_BROKER_REDUCED = [
    "semantic subscriptions 65,536 of semantic_256k's 262,144: a subscribe "
    "takes 0.27-0.45 ms on the host (the table logs D = 384 op-log entries a "
    "vector); 262,144 took 71.3-117.2 s and would take the script past 1,100 s"]
SEM_BROKER_BATCHES = 2  # B = 8192 batches a pass
# bench.py's agentic_fabric (`bench_agentic_fabric`) at its own sizes
AF_DIM, AF_TOPK, AF_THRESH = 32, 16, 0.70
AF_ROOMS, AF_PLAIN, AF_SEM, AF_MSGS, AF_MAX_BATCH = 8, 1024, 384, 8192, 2048


def sem_broker_filters(rng, n):
    """semantic_256k's generator as subscriptions: vectors `_near` the
    path's centroids, thresholds in SEM_THRESH, scopes: half '#', 3/8
    device/{d}/# and 1/8 device/{d}/+/{j}/# (d < 100, j < 1000: filters
    broker_1m routes). -> (filters, vectors, thresholds)."""
    vecs = sem_vectors(rng, sem_centroids(), rng.integers(0, SEM_CENTROIDS, n))
    ths = rng.uniform(*SEM_THRESH, n).astype(np.float32)
    d = rng.integers(0, SEM_SCOPE_DEVICES, n).tolist()
    j = rng.integers(0, 1000, n).tolist()
    kind = rng.random(n).tolist()
    filters = ["#" if k < 0.5 else f"device/{a}/#" if k < 0.875 else f"device/{a}/+/{b}/#"
               for a, b, k in zip(d, j, kind)]
    return filters, vecs, ths


def sem_broker_traffic(rng, n):
    """n publishes of mixed_1m's Zipf topics device/{i}/mid/{j}/leaf, each
    with an embedding near centroid (1000 i + j) mod 256 and a seeded
    RULES_SQL payload and QoS (`rule_messages`). -> (topics, embeddings,
    [(payload, qos)])."""
    ids = zipf_ids(rng, n, 1000)
    nums = rng.integers(0, 1000, size=n)
    topics = [f"device/{i}/mid/{j}/leaf" for i, j in zip(ids, nums)]
    q = sem_vectors(rng, sem_centroids(), (ids * 1000 + nums) % SEM_CENTROIDS)
    return topics, q, [(c["payload"], c["qos"]) for c in rule_messages(rng, topics)]


def sem_broker_messages(traffic, tag) -> list:
    """Fresh `Message`s of `traffic`: the embedding in
    headers["semantic_embedding"], the broker's copy-free intake."""
    from emqx_tpu_torch.broker.message import Message

    topics, q, pq = traffic
    out = []
    for k, t in enumerate(topics):
        m = Message(topic=t, payload=pq[k][0], qos=pq[k][1], from_client=f"sem{tag}")
        m.headers["semantic_embedding"] = q[k]
        out.append(m)
    return out


def rule_replay(engine, msgs) -> collections.Counter:
    """{(rule id, message index): 1} of every rule of `engine` that a host
    replay through `apply_query` passes (the scalar evaluator on each
    message's event context, as the hook path fires it)."""
    from emqx_tpu_torch.ops import topics as T
    from emqx_tpu_torch.rules import events as EV
    from emqx_tpu_torch.rules.runtime import apply_query

    want = collections.Counter()
    for k, m in enumerate(msgs):
        ctx = EV.message_publish(m)
        for rule in engine.rules():
            if not any(T.match(m.topic, t) for t in rule.query.topics):
                continue
            try:
                rows = apply_query(rule.query, dict(ctx))
            except Exception:  # noqa: BLE001 - the rule fails, as fire_settled counts it
                continue
            if rows:
                want[(rule.id, k)] += 1
    return want


def rule_f32_boundary(i, payload) -> bool:
    """Whether RULES_SQL[i] on this JSON payload is a row the f32 device
    masks rightly drop: its compared expression (`RULES_F32_COMPARED`),
    computed from the payload alone in np.float32 and in float64, is above
    the rule's constant in f64 and not in f32. The check shares nothing
    with the rule compiler or its features."""
    spec = RULES_F32_COMPARED.get(i)
    if spec is None:
        return False
    keys, expr, const = spec
    p = json.loads(payload)
    vals = [p.get(k) for k in keys]
    if not all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
        return False
    with np.errstate(all="ignore"):
        f32 = expr(*map(np.float32, vals)) > np.float32(const)
        f64 = expr(*map(np.float64, vals)) > np.float64(const)
    return bool(f64) and not bool(f32)


def rule_fired_check(got, want, msgs, what) -> int:
    """The device-fired rule rows `got` against the scalar replay `want`
    (`rule_replay`), both {(rule id "sem{i}", message index): count}: each
    fired once, none the replay does not pass, and every row the replay
    passes fired, except at most RULE_F32_DROP_MAX rows that
    `rule_f32_boundary` shows to be f32 boundary cases (the device masks
    are f32 programs and the engine re-verifies only the rows they pass;
    ROADMAP Queue 3). -> how many such rows were left out."""
    extra = got - want
    if extra or any(v != 1 for v in got.values()):
        raise AssertionError(f"{what}: fired rows the host replay does not pass or "
                             f"fired twice: {sorted(extra)[:8]}")
    missing = sorted(want - got)
    bad = [(r, k) for r, k in missing
           if not rule_f32_boundary(int(r.removeprefix("sem")), msgs[k].payload)]
    if bad or len(missing) > RULE_F32_DROP_MAX:
        raise AssertionError(f"{what}: {len(missing)} rows the host replay passes did not "
                             f"fire, {len(bad)} of them not f32 boundary cases: {bad[:8]}")
    return len(missing)


def semantic_broker(torch, broker, rec, rng) -> collections.Counter:
    """The broker's semantic plane and the rule engine's device attach on
    broker_1m's broker (`broker_build` attached both, empty):
    `tables_semantic_broker`, `publish_semantic_broker`,
    `ingest_semantic_broker` and `agentic_fabric_broker`. The heap is
    frozen for the phases (as `broker_ingest` freezes it): a full
    collection of broker_1m's objects takes seconds and would land in
    whichever step crosses the threshold. -> the launches of the phases
    on broker_1m's broker (the agentic_fabric broker's print in its
    phase)."""
    gc.freeze()
    try:
        launches, fired = sem_broker_tables(torch, broker, rec, rng)
        traffic = [sem_broker_traffic(rng, BATCH) for _ in range(SEM_BROKER_BATCHES)]
        rr0 = ingest_rr_state(broker)
        sync, sync_launches = sem_broker_publish(torch, broker, rec, traffic, fired)
        launches.update(sync_launches)
        launches.update(sem_broker_ingest(torch, broker, rec, traffic, fired, rr0, sync))
        phase("compact_semantic", **compact_semantic(torch, broker, rec, rng, fired))
        # a broker of its own: its launches print in its phase, not here
        agentic_fabric_broker(torch)
    finally:
        gc.unfreeze()
    return launches


def sem_broker_tables(torch, broker, rec, rng) -> collections.Counter:
    """`tables_semantic_broker`: SEM_BROKER_N embedding-filter subscriptions
    through `Broker.subscribe(sid, ..., embedding=v, sem_threshold=th)`;
    the eight RULES_SQL clauses as rules ``SELECT * FROM "device/#" WHERE
    ...`` with a recording `FunctionOutput`, which must all compile; then
    the first `prepare()`: one full upload of the semantic mirror (no
    scatter), its bytes equal to the host table's. -> (its launches, the
    list the rules record their fired rows in)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.rules.engine import FunctionOutput

    sem, dev = broker.semantic, broker._device_router()
    n = SEM_BROKER_N
    filters, vecs, ths = sem_broker_filters(rng, n)
    opts = SubOpts()
    subs0 = broker.subscription_count()
    at = {}  # seconds after each 65,536 subscribes
    t0 = time.perf_counter()
    for i, f in enumerate(filters):
        sid = f"e{i}"
        broker.subscribe(sid, sid, f, opts, rec.sink(sid), embedding=vecs[i],
                         sem_threshold=float(ths[i]))
        if (i + 1) % 65536 == 0:
            at[i + 1] = time.perf_counter() - t0
    sub_s = time.perf_counter() - t0
    if len(sem) != n or broker.subscription_count() != subs0 + n or \
            broker.metrics.get("semantic.subscribe.rejected"):
        raise AssertionError(f"{len(sem)} semantic entries for {n} subscribes")
    fired = []  # (rule id, message id) a fired row
    for i, w in enumerate(RULES_SQL):
        broker.rule_hook.create_rule(f"sem{i}", f'SELECT * FROM "device/#" WHERE {w}', [
            FunctionOutput(lambda row, ctx, r=f"sem{i}": fired.append((r, ctx["id"])))])
    compiled = len(broker.rule_hook.device_filter.compiled)
    if compiled != len(RULES_SQL):
        raise AssertionError(f"{compiled} of the {len(RULES_SQL)} rules compiled")
    c0 = dev.segment_status()["semantic"]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = dev.prepare()
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    launches = collections.Counter({k: v for k, v in kernels.LAUNCHES.items() if v})
    c1 = dev.segment_status()["semantic"]
    moved = {k: c1[k] - c0[k] for k in c0}
    if moved != {"full_resyncs": 1, "delta_launches": 0, "array_resyncs": 0}:
        raise AssertionError(f"the first semantic prepare moved {moved}")
    sem_bytes = {k: t.numel() * t.element_size() for k, t in args.sem_tables.items()}
    scopes = collections.Counter("#" if f == "#" else "device/{d}/#" if f.count("/") == 2
                                 else "device/{d}/+/{j}/#" for f in filters)
    phase("tables_semantic_broker", semantic_subscriptions=n,
          subscriptions=broker.subscription_count(), subscribe_seconds=sub_s,
          subscribe_us=1e6 * sub_s / n, subscribe_seconds_at=at, scopes=dict(scopes),
          status=sem.status(),
          first_prepare_seconds=prep_s, semantic_upload_bytes=sum(sem_bytes.values()),
          device_bytes=sem_bytes, mirror=moved, oplog=len(sem.table.oplog),
          mirror_bytes_equal=check_sem_mirror(torch, args, sem.table), kslot=args.kslot,
          sem_topk=args.sem_topk, compiled_rules=compiled, launches=dict(launches),
          card=card_line(), reduced=SEM_BROKER_REDUCED)
    return launches, fired


def sem_broker_publish(torch, broker, rec, traffic, fired,
                       name="publish_semantic_broker") -> tuple:
    """`publish_semantic_broker`: each batch of `traffic` through
    `publish_batch`, checked three ways: plain and $share deliveries
    against the host oracle (`broker_publish`); each message's semantic
    deliveries equal to its routed row's winners, and those against the
    plain twin on the card (`sem_half_checked`: a differing row must pass
    the f64 band check); the fired rule rows equal to a host replay
    through `apply_query` (`rule_replay`), each exactly once, but for the
    few f32 boundary rows `rule_fired_check` allows; one
    `rules.device.batches` a batch, no `rules.host.batches`, 2
    semantic_match and 1 rule_masks launches a batch. -> ({"log": the
    deliveries, "fired": the fired rows, by global message index}, the
    launches)."""
    engine, sem, dev = broker.rule_hook, broker.semantic, broker._device_router()
    m = broker.metrics
    timer = BrokerTimer(torch, broker, extra=((engine, "fire_settled", "rule_fire"),))
    host = []
    launches = collections.Counter()
    log, fired_all, out = [], collections.Counter(), []

    def host_of():
        if not host:
            host.append(SemHost(sem.table))
        return host[0]

    try:
        for b, tr in enumerate(traffic):
            msgs = sem_broker_messages(tr, b)
            index = {str(x.mid): k for k, x in enumerate(msgs)}
            fired.clear()
            d0, h0 = m.get("rules.device.batches"), m.get("rules.host.batches")
            got = []
            t0 = time.perf_counter()
            brec = broker_publish(torch, broker, rec, timer, tr[0], 100 + b, msgs=msgs,
                                  got_out=got, want_extra={"semantic_match": 2, "rule_masks": 1})
            wall = time.perf_counter() - t0
            launches.update(brec["launches"])
            res = timer.last["route"]
            args = dev.prepare()
            kslot = res.slots.shape[1] - args.sem_topk
            slot_subs = broker._slot_subs
            sem_n = 0
            for k in range(len(msgs)):
                want = sorted(slot_subs[s].sid for s in res.slots[k, kslot:].tolist() if s >= 0)
                gotk = sorted(x for x in got[k] if x.startswith("e"))
                if gotk != want:
                    raise AssertionError(f"message {k}: semantic deliveries {gotk} != {want}")
                sem_n += len(gotk)
            # the queries the batch carried: the broker's own intake
            # (`embed_batch` normalises each embedding again, which may
            # move a last bit)
            half = sem_half_checked(torch, args, host_of, res, sem.embed_batch(msgs))
            got_f = collections.Counter((r, index[i]) for r, i in fired)
            f32_dropped = rule_fired_check(got_f, rule_replay(engine, msgs), msgs, f"batch {b}")
            dd, dh = m.get("rules.device.batches") - d0, m.get("rules.host.batches") - h0
            if (dd, dh) != (1, 0):
                raise AssertionError(f"batch {b}: rules.device.batches +{dd}, host +{dh}")
            log += [(b * BATCH + k, sid) for k, row in enumerate(got) for sid in row]
            fired_all.update({(r, b * BATCH + k): v for (r, k), v in got_f.items()})
            hd, rf = brec["host_dispatch_ms"], brec["rule_fire_ms"]
            pub_s = brec["publish_batch_ms"] / 1e3
            out.append({**brec, "checked_ms": 1e3 * wall, "messages_per_s": len(msgs) / pub_s,
                        "deliveries_per_s": brec["deliveries"] / pub_s,
                        "semantic_deliveries": sem_n, "rows_differing_from_twin": len(half["diff"]),
                        "band": half["band"], "fired_rows": sum(got_f.values()),
                        "f32_dropped_rows": f32_dropped,
                        "host_fanout_ms": hd - rf, "sem_count_mean": float(res.sem_count.mean()),
                        "readback_bytes": res.readback_bytes})
    finally:
        timer.remove(broker)
    med = {k: float(np.median([r[k] for r in out])) for k in (
        "publish_batch_ms", "prepare_ms", "route_ms", "rule_fire_ms", "host_fanout_ms",
        "host_dispatch_ms", "messages_per_s", "deliveries_per_s")}
    phase(name, batches=out, median=med, card=card_line(),
          rules_device_batches=m.get("rules.device.batches"),
          rules_host_batches=m.get("rules.host.batches"),
          semantic_hits=m.get("semantic.hits"),
          semantic_topk_truncated=m.get("semantic.topk.truncated"))
    rec.log.clear()
    return {"log": sorted(log), "fired": fired_all}, launches


def sem_broker_ingest(torch, broker, rec, traffic, fired, rr0, sync) -> collections.Counter:
    """`ingest_semantic_broker`: the same traffic from concurrent `apublish`
    tasks through `BatchIngest(max_batch=8192)` at pipeline 2 and 1, each
    from the same round-robin bases (`ingest_drive`): the schedule of full
    batches, 1 rule_masks and 2 semantic_match launches a batch, every
    message's plain and semantic recipients the synchronous pass's and
    each matched group delivering it once (`ingest_check`), the fired rows
    the synchronous pass's, one `rules.device.batches` a batch and no
    `rules.host.batches`. The members are not compared: the traffic mixes
    QoS 0-2 (a rule reads it), and the ingest's lanes put a batch's QoS 1
    and 2 publishes first, so the round-robin order differs. -> the
    launches."""
    m = broker.metrics
    n = len(traffic)
    topics = [t for tr in traffic for t in tr[0]]
    launches = collections.Counter()
    runs = {}
    for pipeline in (2, 1):
        ingest_rr_restore(broker, rr0)
        msgs = [x for b, tr in enumerate(traffic) for x in sem_broker_messages(tr, b)]
        index = {str(x.mid): k for k, x in enumerate(msgs)}
        fired.clear()
        d0, h0 = m.get("rules.device.batches"), m.get("rules.host.batches")
        run = ingest_drive(torch, broker, rec, topics, pipeline, msgs=msgs)
        if run["schedule"] != pinned_schedule(n, pipeline):
            raise AssertionError(f"pipeline {pipeline}: schedule {run['schedule']}")
        got_l = run["figures"]["launches"]
        want_l = {"tokenize": n, "shape_match": n, "sparse_fanout_slots": n,
                  "semantic_match": 2 * n, "rule_masks": n}
        if any(got_l.get(k, 0) != v for k, v in want_l.items()):
            raise AssertionError(f"pipeline {pipeline}: launches {got_l}")
        launches.update(got_l)
        check = ingest_check(f"semantic pipeline {pipeline}", run["deliveries"], sync["log"],
                             members=False)
        got_f = collections.Counter((r, index[i]) for r, i in fired)
        if got_f != sync["fired"]:
            raise AssertionError(f"pipeline {pipeline}: fired rows differ from the "
                                 "synchronous pass's")
        dd, dh = m.get("rules.device.batches") - d0, m.get("rules.host.batches") - h0
        if (dd, dh) != (n, 0):
            raise AssertionError(f"pipeline {pipeline}: rules.device.batches +{dd}, host +{dh}")
        runs[str(pipeline)] = {**run["figures"], **check, "fired_rows": sum(got_f.values())}
    rec.log.clear()
    phase("ingest_semantic_broker", depths=runs, card=card_line())
    return launches


def agentic_fabric_broker(torch) -> collections.Counter:
    """`agentic_fabric_broker`: bench.py's `bench_agentic_fabric` at its own
    sizes on a fresh broker (D 32, topk 16, threshold 0.70, 1,024 plain and
    384 semantic subscriptions, 8,192 messages, `BatchIngest(max_batch=
    2048, window_us=500)`, the rule WHERE payload.p = 1), both scenarios:
    the device pass (embeddings and the rule's masks in the route launch)
    against the host-filter pass (no plane; the host twin after dispatch),
    with bench.py's check: plain deliveries equal, semantic deliveries
    within max(8, n // 200). -> the device passes' launches."""
    import asyncio

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.hooks import Hooks
    from emqx_tpu_torch.broker.ingest import BatchIngest
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.router import Router
    from emqx_tpu_torch.broker.semantic import SemanticRouting
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.rules.engine import FunctionOutput, RuleEngine

    rng = np.random.default_rng(2209)
    cents = rng.normal(size=(AF_ROOMS, AF_DIM)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)

    def near(c):
        v = rng.normal(size=AF_DIM).astype(np.float32)
        v = cents[c] + 0.25 * (v / np.linalg.norm(v))
        return (v / np.linalg.norm(v)).astype(np.float32)

    scen_msgs = {
        "fan_out": [(f"agents/room/{i % AF_ROOMS}/evt", near(i % AF_ROOMS), i % 4)
                    for i in range(AF_MSGS)],
        "fan_in": [(f"agents/dev/{int(rng.integers(0, 4096))}/out", near(i % AF_ROOMS), i % 4)
                   for i in range(AF_MSGS)],
    }
    sem_specs = {"fan_out": [(f"agents/room/{i % AF_ROOMS}/#", near(i % AF_ROOMS))
                             for i in range(AF_SEM)],
                 "fan_in": [("#", near(i % AF_ROOMS)) for i in range(AF_SEM)]}
    plain_specs = {"fan_out": [f"agents/room/{i % AF_ROOMS}/#" for i in range(AF_PLAIN)],
                   "fan_in": ["agents/dev/+/out" for _ in range(16)]}
    rule_sql = 'SELECT qos FROM "agents/#" WHERE payload.p = 1'

    def build(scen, semantic):
        b = Broker(Router(MatcherConfig(), min_tpu_batch=64), Hooks())
        counts = {"plain": 0, "sem": 0}

        def mk(kind):
            def deliver(_m, _o):
                counts[kind] += 1
            return deliver

        if semantic:
            b.semantic = SemanticRouting(dim=AF_DIM, topk=AF_TOPK, threshold=AF_THRESH,
                                         metrics=b.metrics)
        sid = 0
        for f in plain_specs[scen]:
            b.subscribe(f"p{sid}", f"p{sid}", f, SubOpts(), mk("plain"))
            sid += 1
        if semantic:
            for f, vec in sem_specs[scen]:
                b.subscribe(f"s{sid}", f"s{sid}", f, SubOpts(), mk("sem"), embedding=vec,
                            sem_threshold=AF_THRESH)
                sid += 1
        eng = RuleEngine(b)
        eng.attach(b.hooks)
        fired = [0]
        eng.create_rule("agentic", rule_sql, [FunctionOutput(
            lambda row, ctx: fired.__setitem__(0, fired[0] + 1))])
        return b, eng, counts, fired

    def messages(scen):
        out = []
        for t, e, pv in scen_msgs[scen]:
            msg = Message(topic=t, payload=b'{"p": %d}' % pv, from_client="pub")
            msg.headers["semantic_embedding"] = e
            out.append(msg)
        return out

    async def serve(b, msgs):
        ing = BatchIngest(b, max_batch=AF_MAX_BATCH, window_us=500)
        b.ingest = ing
        ing.start()
        await ing.submit(Message(topic="agents/room/0/warm"))
        t0 = time.perf_counter()
        futs = []
        for msg in msgs:
            r = await b.apublish_enqueue(msg)
            if not isinstance(r, int):
                futs.append(r)
        cnt = await asyncio.gather(*futs)
        return ing, cnt, t0

    async def device_pass(scen):
        b, eng, counts, fired = build(scen, semantic=True)
        eng.attach_device()
        msgs = messages(scen)
        kernels.reset_launches()
        torch.cuda.synchronize()
        ing, cnt, t0 = await serve(b, msgs)
        wall = time.perf_counter() - t0
        await ing.stop()
        torch.cuda.synchronize()
        lc = {k: v for k, v in kernels.LAUNCHES.items() if v}
        return {"msgs_per_s": AF_MSGS / wall, "deliveries": int(sum(cnt)),
                "plain_deliveries": counts["plain"], "sem_deliveries": counts["sem"],
                "sem_hits": b.metrics.get("semantic.hits"), "rule_fired": fired[0],
                "rule_device_batches": b.metrics.get("rules.device.batches"),
                "rule_host_batches": b.metrics.get("rules.host.batches"),
                "device_batches": b.metrics.get("messages.routed.device"),
                "launches": lc}

    async def host_filter_pass(scen):
        b, _eng, counts, fired = build(scen, semantic=False)
        hostsem = SemanticRouting(dim=AF_DIM, topk=AF_TOPK, threshold=AF_THRESH)
        for slot, (f, vec) in enumerate(sem_specs[scen]):
            hostsem.attach(f"h{slot}", slot, vec, AF_THRESH, fid=-1, scope=f)
        msgs = messages(scen)
        ing, _cnt, t0 = await serve(b, msgs)
        sem_n = sum(len(r) for lo in range(0, AF_MSGS, AF_MAX_BATCH)
                    for r in hostsem.host_route(msgs[lo:lo + AF_MAX_BATCH]))
        wall = time.perf_counter() - t0
        await ing.stop()
        return {"msgs_per_s": AF_MSGS / wall, "plain_deliveries": counts["plain"],
                "sem_deliveries": sem_n, "rule_fired": fired[0]}

    launches = collections.Counter()
    out = {}
    for scen in ("fan_out", "fan_in"):
        dev = asyncio.run(device_pass(scen))
        host = asyncio.run(host_filter_pass(scen))
        tol = max(8, dev["sem_deliveries"] // 200)
        if dev["plain_deliveries"] != host["plain_deliveries"] or \
                abs(dev["sem_deliveries"] - host["sem_deliveries"]) > tol or \
                dev["rule_fired"] != host["rule_fired"]:
            raise AssertionError(f"agentic_fabric {scen}: device {dev} against host {host}")
        lc, nb = dev["launches"], dev["rule_device_batches"]
        if not nb or lc.get("semantic_match") != 2 * nb or lc.get("rule_masks") != nb:
            raise AssertionError(f"agentic_fabric {scen}: launches {lc}, {nb} device batches")
        launches.update(lc)
        out[scen] = {"device": dev, "host_filter": host, "semantic_tolerance": tol}
    rps = [out[s]["device"]["msgs_per_s"] for s in out]
    hrps = [out[s]["host_filter"]["msgs_per_s"] for s in out]
    phase("agentic_fabric_broker", scenarios=out, dim=AF_DIM, topk=AF_TOPK,
          threshold=AF_THRESH, semantic_filters=AF_SEM, plain_subs=AF_PLAIN,
          messages_per_scenario=AF_MSGS, semantic_routing_rps=sum(rps) / len(rps),
          semantic_vs_host_filter_x=sum(rps) / sum(hrps), card=card_line())
    return launches


# -- the plus_100k path (the NFA-only step) ---------------------------------------

PLUS_CHURN = 1000  # filters added and removed through the NFA mirror


def plus_100k_filters() -> list:
    """bench.py's plus_100k (`build_config`): 90,000 exact 8-level filters
    and 10,000 single-'+' filters over the same space."""
    filters = []
    for i in range(90_000):
        a, b, c, d = i % 30, (i // 30) % 50, (i // 1500) % 60, i // 90_000 + i % 7
        filters.append(f"org/{a}/dev/{b}/ch/{c}/m/{d}")
    for i in range(10_000):
        a, b, c = i % 30, (i // 30) % 50, i % 60
        parts = ["org", str(a), "dev", str(b), "ch", str(c), "m", str(i % 7)]
        parts[1 + 2 * (i % 4)] = "+"
        filters.append("/".join(parts))
    return filters


def plus_topics(rng, n) -> list:
    """bench.py's plus_100k topic draw."""
    return [f"org/{a}/dev/{b}/ch/{c}/m/{d}" for a, b, c, d in zip(
        rng.integers(0, 30, n), rng.integers(0, 50, n), rng.integers(0, 60, n),
        rng.integers(0, 7, n))]


def build_plus():
    """The NFA over plus_100k, one subscriber slot per distinct filter (its
    index among them) in a dense table (W = 4,096 words) and in a CSR
    table, and the trie oracle. -> dict."""
    from emqx_tpu_torch.broker.trie import TopicTrie
    from emqx_tpu_torch.models.router_model import SubscriberTable
    from emqx_tpu_torch.ops.nfa import NfaBuilder

    t = [time.perf_counter()]
    filters = plus_100k_filters()
    builder = NfaBuilder()
    for f in filters:
        builder.add(f)
    t.append(time.perf_counter())
    distinct = list(dict.fromkeys(filters))
    fids = np.array([builder.filter_id(f) for f in distinct], np.int64)
    slots = np.arange(len(distinct), dtype=np.int64)
    trie = TopicTrie()
    for f in distinct:
        trie.insert(f)
    t.append(time.perf_counter())
    dense = SubscriberTable(max_subscribers=len(distinct), mode="dense")
    dense.bulk_add(fids, slots)
    dense.pack(builder.num_filters_capacity)
    t.append(time.perf_counter())
    csr = SubscriberTable(max_subscribers=len(distinct), mode="sparse")
    csr.bulk_add(fids, slots)
    csr.pack(builder.num_filters_capacity)
    t.append(time.perf_counter())
    names = ("nfa", "trie", "dense_table", "csr_table")
    return {"filters": len(filters), "builder": builder, "trie": trie, "dense": dense,
            "csr": csr, "slot_of": dict(zip(fids.tolist(), slots.tolist())),
            "seconds": {k: b - a for k, a, b in zip(names, t, t[1:])}}


class PlusOracle:
    """The host reference of the NFA-only step: the trie's filters of each
    topic, their ids in the builder, and the OR of their rows of the dense
    host table."""

    def __init__(self, st):
        self.builder, self.trie, self.dense = st["builder"], st["trie"], st["dense"]

    def fids(self, topics) -> list:
        fid = self.builder.filter_id
        return [{fid(f) for f in self.trie.match(t)} for t in topics]

    def rows(self, fids, lanes=None) -> np.ndarray:
        """[len(fids), W] uint32 expected bitmap rows (a lane slice with
        `lanes`), gathered in chunks."""
        arr = self.dense.arr if lanes is None else self.dense.arr[:, lanes]
        out = np.zeros((len(fids), arr.shape[1]), np.uint32)
        for k, fs in enumerate(fids):
            for f in fs:
                out[k] |= arr[f]
        return out


def check_plus(out, topics, oracle, kslot, lanes=None) -> dict:
    """One route_step result (dict of host arrays) against the oracle: every
    row's matched fids and count, the dense bitmap rows (kslot 0) or the
    slot lists and counts, and the stats. No row may be flagged."""
    want = oracle.fids(topics)
    if out["flags"].any():
        raise AssertionError(f"{int(out['flags'].sum())} plus_100k rows flagged")
    for i, w in enumerate(want):
        row = out["matched"][i]
        if set(row[row >= 0].tolist()) != w or int(out["mcount"][i]) != len(w):
            raise AssertionError(f"row {i} {topics[i]!r}: matched != {sorted(w)}")
    rows = oracle.rows(want, lanes)
    bits = int(sum(int(np.unpackbits(r.view(np.uint8)).sum()) for r in rows))
    if out.get("bitmaps") is not None:
        if not np.array_equal(out["bitmaps"].view(np.uint32), rows):
            raise AssertionError("bitmap rows differ from the oracle's OR")
    if "slots" in out:
        for i in range(len(topics)):
            got = out["slots"][i]
            if set(got[got >= 0].tolist()) != slot_set(rows[i]) or \
                    int(out["slot_count"][i]) != len(slot_set(rows[i])):
                raise AssertionError(f"row {i} {topics[i]!r}: slots differ")
        if out["overflow"].any():
            raise AssertionError("plus_100k rows overflowed kslot")
    if "stats" in out:
        st = {k: int(v) for k, v in out["stats"].items()}
        want_st = {"routed": sum(1 for w in want if w), "matches": sum(map(len, want)),
                   "fanout_bits": bits}
        if st != want_st:
            raise AssertionError(f"stats {st} != {want_st}")
    return {"rows": len(topics), "matches": sum(map(len, want)), "recipients": bits}


def plus_step(torch, tables, bits, topics, salt, kslot, cfg):
    """encode -> h2d -> route_step -> one readback -> host dict."""
    from emqx_tpu_torch.models.router_model import route_step
    from emqx_tpu_torch.ops.tokenizer import encode_topics

    dev = next(iter(tables.values())).device
    mat, lens, _ = encode_topics(topics, MAX_BYTES)
    out = route_step(tables, bits, torch.from_numpy(mat).to(dev),
                     torch.from_numpy(lens).to(dev), salt=salt, kslot=kslot, device=dev,
                     **cfg)
    return plus_readback(torch, out)


def plus_readback(torch, out) -> dict:
    """A route_step output -> host arrays, in one device->host copy (the
    dense rows only when there is no compaction, as `DeviceRouter` reads
    them)."""
    skip = {"bitmaps"} if "slots" in out else set()
    keys = [k for k in ("matched", "mcount", "flags", "bitmaps", "slots", "slot_count",
                        "overflow") if out.get(k) is not None and k not in skip]
    flat = torch.cat([out[k].reshape(-1).to(torch.int32) for k in keys]
                     + [torch.stack([v.to(torch.int32) for v in out["stats"].values()])])
    host = flat.cpu().numpy()
    res, o = {}, 0
    for k in keys:
        n = out[k].numel()
        res[k] = host[o:o + n].reshape(tuple(out[k].shape))
        o += n
    for k in ("flags", "overflow"):
        if k in res:
            res[k] = res[k].astype(bool)
    res["stats"] = dict(zip(out["stats"], host[o:].tolist()))
    return res


def plus_kinds(torch, tables, bits, topics, salt, cfg, kslot):
    """The NFA-only step's five kernels on one batch: inputs, outputs and
    work (`serving_work`; the compaction twin in row chunks: its bit
    expansion at W = 4,096 would take 34 GB at once)."""
    from emqx_tpu_torch.models import router_model as R
    from emqx_tpu_torch.ops import matcher as Mt
    from emqx_tpu_torch.ops import tokenizer as T

    dev = bits.device
    mat, lens, _ = T.encode_topics(topics, MAX_BYTES)
    bm, ln = torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)
    B, MB, L = len(topics), MAX_BYTES, MAX_LEVELS
    P, F, K = cfg["probes"], cfg["frontier"], cfg["max_matches"]
    tok = T.tokenize(bm, ln, salt, L)
    h1, h2, nw, dl = tok
    syms = T.vocab_lookup(tables, h1, h2, P)
    nfa_out = Mt.batch_match_syms(tables, syms, nw, dl, frontier=F, max_matches=K, probes=P)
    matched = nfa_out[0]
    fb = R.fanout_bitmaps(bits, matched)
    comp = R.compact_fanout_slots(fb[0], kslot)
    torch.cuda.synchronize()
    W = bits.shape[1]
    in_vocab = int((syms >= 0).sum())
    visits, final = nfa_work(torch, tables, syms, nw, dl, F)
    fids = int(matched[matched >= 0].unique().numel())
    hits = int((matched >= 0).sum())
    pop = int(fb[1].sum())
    n = dict(B=B, MB=MB, L=L, nbytes=int(ln.clamp(0, MB).sum()), P=P, in_vocab=in_vocab, K=K,
             visits=visits, final=final, lanes=K, hits=hits, fids=fids, W=W, kslot=kslot,
             pop=pop)

    def comp_plain():
        parts = [R.compact_fanout_slots_plain(fb[0][lo:lo + 1024], kslot)
                 for lo in range(0, B, 1024)]
        return tuple(torch.cat(p) for p in zip(*parts))

    kinds = {
        "tokenize": dict(
            kernel=lambda: T.tokenize(bm, ln, salt, L),
            plain=lambda: T.tokenize_plain(bm, ln, salt, L), out=tok),
        "vocab_lookup": dict(
            kernel=lambda: T.vocab_lookup(tables, h1, h2, P),
            plain=lambda: T.vocab_lookup_plain(tables, h1, h2, P), out=syms,
            notes=vocab_notes(torch, syms, nw, tables)),
        "nfa_walk": dict(
            kernel=lambda: Mt.batch_match_syms(tables, syms, nw, dl, frontier=F,
                                               max_matches=K, probes=P),
            plain=lambda: Mt.batch_match_syms_plain(tables, syms, nw, dl, frontier=F,
                                                    max_matches=K, probes=P),
            out=nfa_out),
        "fanout_bitmaps": dict(
            kernel=lambda: R.fanout_bitmaps(bits, matched),
            plain=lambda: R.fanout_bitmaps_plain(bits, matched), out=fb),
        "compact_fanout_slots": dict(
            kernel=lambda: R.compact_fanout_slots(fb[0], kslot),
            plain=comp_plain, out=comp,
            notes=dict(lanes_over_8=lanes_over_8(torch, fb[0], kslot))),
    }
    for name, k in kinds.items():
        k.update(serving_work(name, **n))
    inputs = {"batch": B, "max_levels": L, "frontier": F, "max_matches": K, "probes": P,
              "width_words": W, "kslot": kslot, "in_vocab_lanes": in_vocab,
              "nfa_state_visits": visits, "nfa_final_states": final, "distinct_fids": fids,
              "matched_lanes": hits, "fanout_bits": pop}
    return kinds, inputs


def store_policies(torch, bits, matched, kslot) -> dict:
    """`fanout_bitmaps` alone, and followed by the `compact_fanout_slots`
    that reads its bitmaps, under default and streaming stores, in turns
    (default, streaming, streaming, default): the call (`time_ms`) and the
    device time (`queued_ms`), ms, each turn's sample."""
    from emqx_tpu_torch.models import router_model as R

    def alone(s):
        return lambda: R.fanout_bitmaps(bits, matched, streaming=s)

    def pair(s):
        return lambda: R.compact_fanout_slots(alone(s)()[0], kslot)

    out = {}
    for s in (False, True, True, False):
        r = out.setdefault("streaming" if s else "default",
                           {"fanout_ms": [], "fanout_device_ms": [], "with_compact_ms": [],
                            "with_compact_device_ms": []})
        r["fanout_ms"].append(time_ms(alone(s), torch))
        r["fanout_device_ms"].append(queued_ms(torch, alone(s)))
        r["with_compact_ms"].append(time_ms(pair(s), torch))
        r["with_compact_device_ms"].append(queued_ms(torch, pair(s)))
    return out


def plus_path(torch, rng):
    """plus_100k: TpuMatcher and route_step (dense with kslot 0 and 64, and
    CSR) against the trie, churn through the NFA mirror, the five kernels
    against their twins. -> (kernel cases, launches, composite bound)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.ops.matcher import CAUSES, MatcherConfig, TpuMatcher
    from emqx_tpu_torch.ops.segments import DeviceSegmentManager

    t0 = time.perf_counter()
    st = build_plus()
    build_s = time.perf_counter() - t0
    builder, trie, dense, csr = (st[k] for k in ("builder", "trie", "dense", "csr"))
    mc = MatcherConfig(max_bytes=MAX_BYTES, max_levels=MAX_LEVELS)
    cfg = dict(max_levels=mc.max_levels, frontier=mc.frontier, max_matches=mc.max_matches,
               probes=mc.probes)
    metrics = Metrics()
    matcher = TpuMatcher(builder, mc, metrics=metrics)
    bits_sync = DeviceSegmentManager("cuda", name="bitmaps")
    csr_sync = DeviceSegmentManager("cuda", name="csr")
    t0 = time.perf_counter()
    tables = matcher._tables()
    bits = bits_sync.sync(dense)["sub_bitmaps"]
    csr_t = csr_sync.sync(csr)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    phase("tables_plus", filters=st["filters"], distinct=len(builder),
          width_words=dense.width_words, fcap=int(dense.arr.shape[0]),
          build_seconds=build_s, build_stage_seconds=st["seconds"], upload_seconds=upload_s,
          device_bytes={"nfa": sum(mirror_bytes(tables).values()),
                        "dense": bits.numel() * 4,
                        "csr": sum(mirror_bytes(csr_t).values())},
          nfa_lanes={k: int(v.numel()) for k, v in tables.items()}, reduced=[])
    oracle = PlusOracle(st)
    batches = [plus_topics(rng, BATCH) for _ in range(ROUTE_BATCHES)]

    # -- the counters are zeroed here and read after the churn batch
    kernels.reset_launches()
    matched = []
    for topics in batches:
        t0 = time.perf_counter()
        got = matcher.match_batch(topics)
        wall = 1e3 * (time.perf_counter() - t0)
        for t, names in zip(topics, got):
            if sorted(names) != sorted(trie.match(t)):
                raise AssertionError(f"TpuMatcher {t!r}: {names}")
        matched.append({"match_batch_ms": wall, "matches": sum(map(len, got))})
    flagged = {c: metrics.get(f"matcher.fallback.rows.{c}") for c in CAUSES + ("too_long",)}
    phase("matcher_plus", batches=matched, flagged_by_cause=flagged,
          flagged=metrics.get("matcher.fallback.rows"))
    steps = []
    for kslot in (0, 64):
        for topics in batches:
            t0 = time.perf_counter()
            out = plus_step(torch, tables, bits, topics, builder.salt, kslot, cfg)
            wall = 1e3 * (time.perf_counter() - t0)
            steps.append({"table": "dense", "kslot": kslot, "step_ms": wall,
                          **check_plus(out, topics, oracle, kslot)})
    for topics in batches:
        t0 = time.perf_counter()
        out = plus_step(torch, tables, csr_t, topics, builder.salt, KSLOT, cfg)
        wall = 1e3 * (time.perf_counter() - t0)
        steps.append({"table": "csr", "kslot": KSLOT, "step_ms": wall,
                      **check_plus(out, topics, oracle, KSLOT)})
    phase("route_step_plus", steps=steps)

    # -- churn: 1,000 filters removed (every reference) and 1,000 fresh exact
    # filters of existing words added, through the NFA mirror and the
    # dense table's mirror; then a checked batch of their topics
    distinct = list(st["slot_of"])
    pick = rng.choice(len(distinct), PLUS_CHURN, replace=False)
    gone = [builder.filter_name(distinct[k]) for k in pick]
    fresh = []
    while len(fresh) < PLUS_CHURN:
        a, b, c, d = (int(x) for x in rng.integers(0, [30, 50, 60, 7]))
        f = f"org/{a}/dev/{b}/ch/{c}/m/{d}"
        if builder.filter_id(f) is None and f not in fresh:
            fresh.append(f)
    e0 = {"nfa": builder.epoch, "bitmaps": dense.epoch}
    c0 = {"nfa": matcher._sync.counters(), "bitmaps": bits_sync.counters()}
    slot_of = st["slot_of"]
    next_slot = len(distinct)
    for f in gone:
        fid = builder.filter_id(f)
        while builder.filter_id(f) is not None:
            builder.remove(f)
        trie.delete(f)
        dense.remove(fid, slot_of.pop(fid))
    for k, f in enumerate(fresh):
        fid = builder.add(f)
        trie.insert(f)
        slot_of[fid] = next_slot + k
        dense.add(fid, next_slot + k)
    topics = plus_topics(rng, BATCH)
    topics[:PLUS_CHURN // 2] = [g.replace("+", "7") for g in gone[:PLUS_CHURN // 2]]
    topics[PLUS_CHURN // 2:PLUS_CHURN * 3 // 2] = fresh
    sc0 = kernels.LAUNCHES["segment_scatter"]
    t0 = time.perf_counter()
    tables = matcher._tables()
    bits = bits_sync.sync(dense)["sub_bitmaps"]
    torch.cuda.synchronize()
    sync_ms = 1e3 * (time.perf_counter() - t0)
    scatters = kernels.LAUNCHES["segment_scatter"] - sc0
    c1 = {"nfa": matcher._sync.counters(), "bitmaps": bits_sync.counters()}
    moves = {m: {k: c1[m][k] - c0[m][k] for k in c1[m]} for m in c1}
    for m, mv in moves.items():
        epoch_moved = (builder.epoch if m == "nfa" else dense.epoch) != e0[m]
        if mv["full_resyncs"] != int(epoch_moved) or \
                (not epoch_moved and mv["delta_launches"] + mv["array_resyncs"] < 1):
            raise AssertionError(f"plus churn: {m} {mv}, epoch moved {epoch_moved}")
    for mgr, src in ((matcher._sync, builder), (bits_sync, dense)):
        snap = src.device_snapshot()
        for k, host in snap.items():
            if not np.array_equal(mgr._arrays[k].cpu().numpy().view(host.dtype), host):
                raise AssertionError(f"mirror {mgr.name}/{k} differs from the host table")
    got = matcher.match_batch(topics)
    for t, names in zip(topics, got):
        if sorted(names) != sorted(trie.match(t)):
            raise AssertionError(f"TpuMatcher after churn {t!r}: {names}")
    churn_check = check_plus(plus_step(torch, tables, bits, topics, builder.salt, KSLOT, cfg),
                             topics, oracle, KSLOT)
    launches = dict(kernels.LAUNCHES)
    path = ("tokenize", "vocab_lookup", "nfa_walk", "fanout_bitmaps", "compact_fanout_slots",
            "sparse_fanout_slots", "segment_scatter")
    if not all(launches[k] for k in path) or launches["shape_match"]:
        raise AssertionError(f"plus_100k launches {launches}")
    phase("churn_plus", removed=len(gone), added=len(fresh), sync_ms=sync_ms,
          scatter_launches=scatters, moved=moves,
          epoch_moved={"nfa": builder.epoch != e0["nfa"], "bitmaps": dense.epoch != e0["bitmaps"]},
          mirrors_equal=True, matches=sum(map(len, got)), route_step=churn_check,
          launches=launches)

    # per batch: a matcher call, a route_step
    per = {}
    for name, fn in (("match_batch", lambda: matcher.match_batch(batches[0])),
                     ("route_step", lambda: plus_step(torch, tables, bits, batches[0],
                                                      builder.salt, KSLOT, cfg))):
        kernels.reset_launches()
        fn()
        per[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    phase("launches_per_batch_plus", **per)

    # -- the five kernels at plus_100k shapes, against their twins
    kinds, inputs = plus_kinds(torch, tables, bits, batches[0], builder.salt, cfg, KSLOT)
    report = kernel_report(torch, kinds)
    comp = sum(r["bound_ms"] for r in report.values())
    phase("kernel_inputs_plus", **inputs, composite_bound_ms=comp)
    phase("fanout_store_policy_plus",
          **store_policies(torch, bits, kinds["nfa_walk"]["out"][0], KSLOT))

    # -- where one NFA-only batch's time goes
    from emqx_tpu_torch.models.router_model import route_step
    from emqx_tpu_torch.ops.tokenizer import encode_topics

    names = ("encode", "h2d", "kernels", "readback", "route")
    samples = {k: [] for k in names + ("match_batch",)}
    for topics in [plus_topics(rng, BATCH) for _ in range(3)]:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mat, lens, _ = encode_topics(topics, MAX_BYTES)
        t.append(time.perf_counter())
        bm, ln = torch.from_numpy(mat).to(bits.device), torch.from_numpy(lens).to(bits.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = route_step(tables, bits, bm, ln, salt=builder.salt, kslot=KSLOT,
                         device=bits.device, **cfg)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        plus_readback(torch, out)
        t.append(time.perf_counter())
        plus_step(torch, tables, bits, topics, builder.salt, KSLOT, cfg)
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            samples[k].append(1e3 * (b - a))
        t0 = time.perf_counter()
        matcher.match_batch(topics)
        samples["match_batch"].append(1e3 * (time.perf_counter() - t0))
    med = {f"{k}_ms": float(np.median(v)) for k, v in samples.items()}
    med["topics_per_s"] = BATCH / (med["route_ms"] / 1e3)
    phase("route_breakdown_plus", **med, composite_bound_ms=comp)
    del st, builder, trie, dense, csr, matcher, bits_sync, csr_sync, tables, bits, csr_t
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches, comp


# -- background compaction and segment-state snapshots ----------------------------

COMPACT_STORM = 3072  # compact_share: hot pairs before the cycle (past 1,024, under 4,096)
COMPACT_RACE = 384  # compact_share: adds, and removes, journaled while the build runs
# the loop's pause between two batches while a build runs, and every how
# many of them is checked against the oracle: the checks are Python loops
# that hold the GIL the build needs too (a checked batch every 0.5 s
# stretched the 80M-pair build to 219.6 s on the H100 host)
COMPACT_POLL_S = 2.0
COMPACT_CHECK_EVERY = 6
COMPACT_BATCHES = 2  # checked batches after each cycle
BROKER_COMPACT = 2048  # compact_broker: subscribes on fresh filters, and unsubscribes
SEM_COMPACT = (1100, 256)  # compact_semantic: semantic subscribes, then removes
# compact_session: the owner's tombstone_frac; ride A's 20,000 acks leave
# 20,000 tombstones in 2^22 rows (0.0048), and the reference's replay check
# uses 0.0
SESS_COMPACT_FRAC = 0.004
SNAPSHOT_BATCHES = 3  # snapshot_broker: batches through the original and the restored broker
MESH_COMPACT = 1024  # mesh_broker_2x2: subscribes before the cycle
MESH_SESS_ACKS = 4096  # mesh_session_2x2: the wave's rows acked before the session cycle
# phase -> {kernel: launches} of the compaction phases, for the kernels line
COMPACT_LAUNCHES: dict = {}


class UploadLog:
    """While open: the array names every full or array resync of a mirror
    uploads (`convert.upload` as `ops.segments` calls it), apart from the
    compaction thread's uploads (`upload_offer`), which it times: (start,
    end, names, bytes) a call."""

    def __init__(self):
        import threading

        from emqx_tpu_torch.ops import segments as G

        self.G, self.names, self.offers = G, [], []
        self._upload, self._offer = G.upload, G.upload_offer
        self._local = threading.local()

        def upload(arrays, *a, **k):
            if not getattr(self._local, "offer", False):
                self.names.extend(arrays)
            return self._upload(arrays, *a, **k)

        def offer(arrays, *a, **k):
            self._local.offer = True
            t0 = time.perf_counter()
            try:
                return self._offer(arrays, *a, **k)
            finally:
                self._local.offer = False
                self.offers.append((t0, time.perf_counter(), sorted(arrays),
                                    int(sum(np.asarray(v).nbytes for v in arrays.values()))))

        G.upload, G.upload_offer = upload, offer

    def take(self) -> list:
        out, self.names = self.names, []
        return out

    def close(self) -> None:
        self.G.upload, self.G.upload_offer = self._upload, self._offer


def run_compactor(comp, owners, during=None, after_begin=None, poll_s=0.0,
                  max_cycles=4) -> list:
    """Housekeeping ticks of `comp` over `owners` on an asyncio loop, as the
    reference app's housekeeping drives its compactor (emqx_tpu/app.py:
    1224-1260), one cycle at a time until no owner needs compaction.
    `after_begin(key)` runs on the loop once a cycle has captured its table
    (its mutations are journaled), `during(key)` between polls while the
    cycle builds. -> per cycle {"key", "seconds", "build_s", "apply_ms",
    "during": [what `during` returned]}. Raises past `max_cycles` (an
    owner whose cycles do not end its need) and when a cycle aborts."""
    import asyncio

    stats = {}
    saved = []
    for o in owners:
        saved.append((o, o.begin, o.build, o.apply))

        def begin(o=o, f=o.begin):
            stats["key"] = o.key
            return f()

        def build(cap, f=o.build):
            t0 = time.perf_counter()
            out = f(cap)
            stats["build_s"] = time.perf_counter() - t0
            return out

        def apply(built, f=o.apply):
            t0 = time.perf_counter()
            out = f(built)
            stats["apply_ms"] = 1e3 * (time.perf_counter() - t0)
            return out

        o.begin, o.build, o.apply = begin, build, apply

    async def drive():
        cycles = []
        while comp.tick(owners):
            t0 = time.perf_counter()
            await asyncio.sleep(0)  # the cycle's begin runs on the loop
            key = stats.pop("key")
            if after_begin is not None:
                after_begin(key)
            calls = []
            while comp._busy:
                if during is not None:
                    calls.append(during(key))
                await asyncio.sleep(poll_s)
            cycles.append({"key": key, "seconds": time.perf_counter() - t0,
                           "build_s": stats.pop("build_s", None),
                           "apply_ms": stats.pop("apply_ms", None), "during": calls})
            if comp.aborted:
                raise AssertionError(f"compaction cycle {key} aborted ({comp.aborted})")
            if len(cycles) > max_cycles:
                raise AssertionError(f"{len(cycles)} cycles: {[c['key'] for c in cycles]}")
        return cycles

    try:
        return asyncio.run(drive())
    finally:
        for o, b, bu, a in saved:
            o.begin, o.build, o.apply = b, bu, a


def adopting_prepare(torch, router, log) -> dict:
    """The prepare after a cycle, timed: the mirrors' moves, the arrays it
    uploaded (`log`) and its scatter launches, which must be the moved
    delta launches' (SCATTER_LAUNCHES each)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.ops import segments as G

    c0 = mirror_counts(router)
    log.take()
    s0 = kernels.LAUNCHES["segment_scatter"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    c1 = mirror_counts(router)
    moves = {m: {k: c1[m][k] - c0[m][k] for k in c1[m]} for m in c1}
    scatters = kernels.LAUNCHES["segment_scatter"] - s0
    if scatters != G.SCATTER_LAUNCHES * sum(v["delta_launches"] for v in moves.values()):
        raise AssertionError(f"adopting prepare: {scatters} scatter launches, moves {moves}")
    return {"args": args, "prepare_ms": ms, "moves": moves, "uploaded": log.take(),
            "scatter_launches": scatters}


def compact_share(torch, router, index, subtab, oracle, rng) -> dict:
    """`compact_share` at share_10m_csr's full width: COMPACT_STORM pairs
    on the group filter device/9/# land in the CSR hot segment; one
    `SegmentCompactor.tick` starts the CSR owner's cycle, whose build (the
    80M-pair CSR and its registry, rebuilt on the compaction thread) and
    upload (on a side stream) run while the loop journals COMPACT_RACE
    adds and removes and routes checked batches; after the apply and the
    offer the next prepare adopts the uploaded csr_* tensors (a full resync
    with no csr_* upload, one scatter for the journal's suffix). The hot
    segment stays at or under HOT_SERVE_MAX at every prepare, so no
    prepare folds inline (the table's epoch moves once, by the apply).
    Then a batch routed while the same arrays upload again beside it, and
    checked batches against the oracle, with rows past the gather window
    (device/9/# now holds its storm in the packed column)."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.ops import segments as G
    from emqx_tpu_torch.ops.csr_table import CsrTable

    csr = subtab.csr
    router.prepare()
    storm_i, hot0 = 9, csr.hot_fill
    if hot0 + COMPACT_STORM + COMPACT_RACE > CsrTable.HOT_SERVE_MAX:
        raise AssertionError(f"hot {hot0}: the storm would pass HOT_SERVE_MAX")
    fid9 = index.filter_id(f"device/{storm_i}/#")
    storm_topics = [f"device/{storm_i}/mid/{j}/leaf" for j in range(64)]

    def batch():
        topics = topic_batch_share(rng, BATCH)
        topics[: len(storm_topics)] = storm_topics
        return topics

    hot_fills, prep_ms = [], []
    real_args = router._device_args

    def device_args():  # every prepare: the hot fill it sees, its time
        hot_fills.append(csr.hot_fill)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_args()
        torch.cuda.synchronize()
        prep_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    router._device_args = device_args
    log = UploadLog()
    try:
        kernels.reset_launches()
        e0 = subtab.epoch
        for s in range(COMPACT_STORM):
            subtab.add(fid9, 700_000 + s)
        storm = route_share_checked(router, [batch()], oracle)[0]
        if not storm["overflow_rows"]:
            raise AssertionError("the hot storm produced no rows past kslot")
        outside = list(prep_ms)
        owners = router.compaction_owners()
        if [o.key for o in owners if o.needs_compact()] != ["bitmaps"]:
            raise AssertionError(f"owners needing compaction: "
                                 f"{[o.key for o in owners if o.needs_compact()]}")
        # the racing churn: COMPACT_RACE fresh pairs on bench filters, and
        # COMPACT_RACE removes of packed pairs
        ij = rng.integers(0, [SHARE_IDS, SHARE_NUMS], size=(COMPACT_RACE, 2))
        adds = [(index.filter_id(f"device/{i}/+/{j}/#"), 800_000 + k)
                for k, (i, j) in enumerate(ij)]
        removes = []
        n_subs = SHARE_IDS * SHARE_NUMS * SHARE_SPF
        for n in rng.choice(n_subs, size=4 * COMPACT_RACE, replace=False).tolist():
            f, s = n // SHARE_SPF, n % SHARE_SLOTS
            if len(removes) < COMPACT_RACE and csr._reg_get(csr._key(f, s)) is not None:
                removes.append((f, s))
        journal = {}

        def race(key):
            if csr._journal is None:
                raise AssertionError("the CSR cycle's capture did not start a journal")
            for (fa, sa), (fr, sr) in zip(adds, removes):
                subtab.add(fa, sa)
                subtab.remove(fr, sr)
            journal["entries"] = len(csr._journal)

        polls = []

        def serve(key):
            t0 = time.perf_counter()
            topics = batch()
            if len(polls) % COMPACT_CHECK_EVERY == 0:
                rec = route_share_checked(router, [topics], oracle)[0]
                out = {"checked": True, "route_ms": rec["route_ms"],
                       "rows_past_kslot": rec["overflow_rows"]}
            else:
                router.route(topics)
                out = {"checked": False, "route_ms": 1e3 * (time.perf_counter() - t0)}
            polls.append(t0)
            return {"at_s": t0, **out, "prepare_ms": prep_ms[-1], "hot_fill": hot_fills[-1]}

        comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
        cycles = run_compactor(comp, owners, during=serve, after_begin=race,
                               poll_s=COMPACT_POLL_S)
        m = comp.metrics
        if [c["key"] for c in cycles] != ["bitmaps"] or comp.runs != 1 or comp.aborted \
                or journal.get("entries") != 2 * COMPACT_RACE \
                or not any(d["checked"] for d in cycles[0]["during"]):
            raise AssertionError(f"compact_share: cycles {[c['key'] for c in cycles]}, runs "
                                 f"{comp.runs}, aborted {comp.aborted}, journal {journal}")
        during = cycles[0]["during"]
        offered = router._bits_sync._offer[1]
        adopt = adopting_prepare(torch, router, log)
        args, moves = adopt["args"], adopt["moves"]
        uploaded_csr = sorted(k for k in adopt["uploaded"] if k.startswith("csr_"))
        if uploaded_csr or moves["bitmaps"]["full_resyncs"] != 1 \
                or moves["bitmaps"]["delta_launches"] != 1 \
                or args.tables["csr_off"] is not offered["csr_off"] \
                or args.tables["csr_len"] is not offered["csr_len"]:
            raise AssertionError(f"adopting prepare: uploaded {adopt['uploaded']}, moves {moves}")
        if subtab.epoch != e0 + 1 or max(hot_fills) > CsrTable.HOT_SERVE_MAX:
            raise AssertionError(f"an inline fold: epoch {e0} -> {subtab.epoch}, "
                                 f"hot fills up to {max(hot_fills)}")
        mirrors = check_mirrors(torch, router)
        after = route_share_checked(router, [batch() for _ in range(COMPACT_BATCHES)], oracle)
        if not all(r["gather_window_rows"] for r in after):
            raise AssertionError("the packed storm took no rows past the gather window")
        # a serving batch while the same packed arrays upload on another
        # thread's side stream, against the same batch alone
        overlap = upload_overlap(torch, router, {k: getattr(csr, k) for k in
                                                 ("csr_off", "csr_len", "csr_slots")}, batch)
        launches = dict(kernels.LAUNCHES)
    finally:
        router._device_args = real_args
        log.close()
    for k in ("tokenize", "shape_match", "sparse_fanout_slots", "share_pick",
              "occurrence_index", "segment_scatter"):
        if not launches[k]:
            raise AssertionError(f"compact_share: {k} never launched ({launches})")
    COMPACT_LAUNCHES["compact_share"] = launches
    build_window = [(t0, t1) for t0, t1, names, _b in log.offers if "csr_slots" in names]
    out = {
        "storm_pairs": COMPACT_STORM, "hot_fill_before": hot0, "race": COMPACT_RACE,
        "journal_entries": journal["entries"], "storm_batch": storm,
        "build_s": cycles[0]["build_s"], "cycle_s": cycles[0]["seconds"],
        "apply_ms": cycles[0]["apply_ms"],
        "offer_upload": [{"s": t1 - t0, "arrays": names, "bytes": b}
                         for t0, t1, names, b in log.offers],
        "prepare_ms_outside": outside,
        "prepare_ms_during": {"p50": float(np.median([d["prepare_ms"] for d in during])),
                              "max": float(max(d["prepare_ms"] for d in during)),
                              "n": len(during)},
        "route_ms_during": {"p50": float(np.median([d["route_ms"] for d in during])),
                            "max": float(max(d["route_ms"] for d in during)),
                            "checked": sum(d["checked"] for d in during)},
        "batches_during": during, "during_upload": [
            d for d in during if any(a <= d["at_s"] <= b for a, b in build_window)],
        "adopting_prepare_ms": adopt["prepare_ms"], "adopting_moves": moves,
        "adopting_uploads": adopt["uploaded"], "adopting_scatter_launches":
            adopt["scatter_launches"], "hot_fill_at_each_prepare": hot_fills,
        "epoch_moves": subtab.epoch - e0, "runs": comp.runs, "aborted": comp.aborted,
        "merged": m.get("router.compact.merged"), "mirrors_equal": mirrors, "after": after,
        "upload_overlap": overlap, "launches": launches, "card": card_line(), "reduced": [],
    }
    return out


def upload_overlap(torch, router, arrays, batch) -> dict:
    """Batches routed while `arrays` upload on another thread, against the
    same batches alone: the port's `upload_offer` (a side stream, pinned
    staging) and, beside it in turns (offer, pageable, pageable, offer),
    one pageable `.to()` an array on a side stream (the first design,
    whose neighbours waited for it). Host-clock ms of each `route()`, and
    each upload's seconds."""
    import threading

    from emqx_tpu_torch.ops import segments as G

    def pageable():
        side = torch.cuda.Stream(router.device)
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(v).to(router.device) for k, v in arrays.items()}
        side.synchronize()
        return out

    topics = [batch() for _ in range(3)]

    def alone():
        out = []
        for t in topics:
            t0 = time.perf_counter()
            router.route(t)
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    def beside(up):
        box = {}

        def run():
            t0 = time.perf_counter()
            box["t"] = up()
            box["s"] = time.perf_counter() - t0

        th = threading.Thread(target=run, name="segment-compact-probe")
        routes = []
        th.start()
        k = 0
        while th.is_alive():
            t0 = time.perf_counter()
            router.route(topics[k % len(topics)])
            routes.append(1e3 * (time.perf_counter() - t0))
            k += 1
        th.join()
        box.pop("t")
        torch.cuda.empty_cache()
        return {"upload_s": box["s"], "route_ms": routes}

    out = {"bytes": int(sum(a.nbytes for a in arrays.values())), "route_ms_alone": alone()}
    for name, up in (("offer", lambda: G.upload_offer(arrays, router.device)),
                     ("pageable", pageable), ("pageable", pageable),
                     ("offer", lambda: G.upload_offer(arrays, router.device))):
        out.setdefault(name, []).append(beside(up))
    out["route_ms_alone_after"] = alone()
    return out


def compact_bitmaps(torch, router, index, subtab, oracle, batches) -> dict:
    """`compact_bitmaps` on mixed_1m's dense table: one `BitmapGrowthOwner`
    cycle (started by a tick when the 1,000,100 filters already pass 3/4
    of the matrix, else run at once), the grown matrix uploaded on the
    compaction thread and adopted by the next prepare; the grown mirror
    equal to host and the routed batches equal to the oracle through
    `fanout_bitmaps` / `compact_fanout_slots`."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.ops import segments as G

    owner = [o for o in router.compaction_owners() if o.key == "bitmaps"]
    if len(owner) != 1 or type(owner[0]).__name__ != "BitmapGrowthOwner":
        raise AssertionError(f"mixed_1m owners: {owner}")
    owner = owner[0]
    router.prepare()
    need, fcap0, capacity = owner.needs_compact(), subtab._fcap, index.num_filters_capacity
    log = UploadLog()
    kernels.reset_launches()
    try:
        comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
        if need:
            cycles = run_compactor(comp, [owner])
        else:
            t0 = time.perf_counter()
            comp.compact_now(owner)
            cycles = [{"key": owner.key, "seconds": time.perf_counter() - t0}]
        if comp.runs != 1 or comp.aborted:
            raise AssertionError(f"compact_bitmaps: runs {comp.runs}, aborted {comp.aborted}")
        offered = router._bits_sync._offer[1]["sub_bitmaps"]
        adopt = adopting_prepare(torch, router, log)
        if "sub_bitmaps" in adopt["uploaded"] or adopt["moves"]["bitmaps"]["full_resyncs"] != 1 \
                or adopt["args"].tables["sub_bitmaps"] is not offered:
            raise AssertionError(f"adopting prepare: {adopt['uploaded']}, {adopt['moves']}")
        mirrors = check_mirrors(torch, router)
        routed = []
        for topics in batches:
            t0 = time.perf_counter()
            res = router.route(topics)
            routed.append({"route_ms": 1e3 * (time.perf_counter() - t0),
                           **check_batch(res, topics, oracle)})
        launches = dict(kernels.LAUNCHES)
    finally:
        log.close()
    if not launches["fanout_bitmaps"] or not launches["compact_fanout_slots"]:
        raise AssertionError(f"compact_bitmaps: launches {launches}")
    COMPACT_LAUNCHES["compact_bitmaps"] = launches
    return {"needed": need, "filter_capacity": capacity, "fcap_before": fcap0,
            "fcap_after": subtab._fcap, "cycles": cycles, "runs": comp.runs,
            "aborted": comp.aborted, "offer_upload": [{"s": t1 - t0, "arrays": n, "bytes": b}
                                                     for t0, t1, n, b in log.offers],
            "adopting_prepare_ms": adopt["prepare_ms"], "adopting_moves": adopt["moves"],
            "adopting_uploads": adopt["uploaded"], "mirrors_equal": mirrors, "routed": routed,
            "launches": launches, "card": card_line()}


def compact_broker(torch, broker, rec, rng) -> dict:
    """`compact_broker` on broker_1m through `Broker.subscribe` /
    `unsubscribe`: BROKER_COMPACT subscribes on fresh filters of the
    table's shape (hot shape entries and hot CSR pairs) and BROKER_COMPACT
    plain unsubscribes (tombstones); a checked `publish_batch` before; the
    shape and CSR owners of `compaction_owners()` ticked to completion,
    a checked batch published while each builds; a checked batch after
    the adopting prepare; mirrors equal to host."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.ops import segments as G

    dev = broker._device_router()
    subtab, shapes = broker.subtab, broker.router.index.shapes
    opts = SubOpts()
    ids = rng.integers(0, BROKER_IDS, BROKER_COMPACT).tolist()
    t0 = time.perf_counter()
    for k, i in enumerate(ids):
        sid = f"k{k}"
        broker.subscribe(sid, sid, f"device/{i}/+/{3000 + k}/#", opts, rec.sink(sid))
    gone = []
    for k in rng.choice(BROKER_IDS * BROKER_NUMS, size=2 * BROKER_COMPACT,
                        replace=False).tolist():
        i, j = divmod(k, BROKER_NUMS)
        if len(gone) < BROKER_COMPACT and broker.unsubscribe(f"c{i}_{j}", f"device/{i}/+/{j}/#"):
            gone.append((i, j))
    churn_s = time.perf_counter() - t0
    if len(gone) != BROKER_COMPACT:
        raise AssertionError(f"{len(gone)} unsubscribes of {BROKER_COMPACT}")
    timer = BrokerTimer(torch, broker)
    log = UploadLog()
    kernels.reset_launches()
    launches = collections.Counter()
    tag = [40]

    def publish():
        tag[0] += 1
        b = broker_publish(torch, broker, rec, timer, topic_batch_1m(rng, BATCH), tag[0])
        launches.update(b["launches"])
        got = {sid for _m, sid in rec.log}
        if got & {f"c{i}_{j}" for i, j in gone}:
            raise AssertionError("an unsubscribed client still received")
        return {k: b[k] for k in ("deliveries", "publish_batch_ms", "prepare_ms", "route_ms")}

    try:
        before = publish()
        state0 = {"shapes": {"hot_live": shapes.hot_live, "tombstones": shapes.packed_tombstones},
                  "csr": {"hot_fill": subtab.csr.hot_fill,
                          "tombstones": subtab.csr.packed_tombs + subtab.csr.hot_tombs}}
        owners = [o for o in dev.compaction_owners() if o.key in ("shapes", "bitmaps")]
        needs = {o.key: o.needs_compact() for o in owners}
        comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
        c_start = mirror_counts(dev)
        log.take()
        # a batch published while the second cycle builds adopts the
        # first cycle's offer: the moves and uploads count from here
        cycles = run_compactor(comp, owners, during=lambda key: publish(),
                               poll_s=COMPACT_POLL_S)
        started = sorted(c["key"] for c in cycles)
        want = sorted(k for k, v in needs.items() if v)
        for o in owners:  # an owner the tick left alone runs its one cycle now
            if o.key not in started:
                t0 = time.perf_counter()
                if not comp.compact_now(o):
                    raise AssertionError(f"compact_broker: the {o.key} cycle aborted")
                cycles.append({"key": o.key, "seconds": time.perf_counter() - t0,
                               "compact_now": True})
        if comp.runs != 2 or comp.aborted or started != want:
            raise AssertionError(f"compact_broker: runs {comp.runs}, aborted {comp.aborted}, "
                                 f"started {started}, needing {want}")
        uploaded = log.take()
        adopt = adopting_prepare(torch, dev, log)
        uploaded += adopt["uploaded"]
        c_end = mirror_counts(dev)
        moves = {m: {k: c_end[m][k] - c_start[m][k] for k in c_end[m]} for m in c_end}
        if any(k == "shape_tab" or k.startswith("csr_") for k in uploaded) \
                or moves["shapes"]["full_resyncs"] != 1 or moves["bitmaps"]["full_resyncs"] != 1:
            raise AssertionError(f"compact_broker: uploaded {uploaded}, moves {moves}")
        mirrors = check_mirrors(torch, dev)
        after = [publish() for _ in range(COMPACT_BATCHES)]
    finally:
        timer.remove(broker)
        log.close()
    COMPACT_LAUNCHES["compact_broker"] = dict(launches)
    return {"subscribed": BROKER_COMPACT, "unsubscribed": len(gone), "churn_s": churn_s,
            "state_before": state0, "needed": needs, "before": before,
            "cycles": [{k: v for k, v in c.items()} for c in cycles], "runs": comp.runs,
            "aborted": comp.aborted, "merged": comp.metrics.get("router.compact.merged"),
            "offer_upload": [{"s": t1 - t0, "arrays": n, "bytes": b}
                             for t0, t1, n, b in log.offers],
            "adopting_prepare_ms": adopt["prepare_ms"], "adopting_moves": adopt["moves"],
            "moves_from_the_first_cycle": moves, "uploads_from_the_first_cycle": uploaded,
            "mirrors_equal": mirrors, "after": after, "launches": dict(launches),
            "card": card_line()}


def compact_semantic(torch, broker, rec, rng, fired) -> dict:
    """`compact_semantic` on broker_1m's semantic plane: SEM_COMPACT[0]
    semantic subscribes (semantic_256k's generator) and SEM_COMPACT[1]
    removes of earlier ones, then one `SemanticSegmentOwner` cycle (f32)
    on the compaction thread; the next prepare adopts the packed arrays,
    the semantic mirror equals host, and a `publish_batch` with embeddings
    and rule payloads passes `sem_broker_publish`'s checks (its semantic
    half against the twin outside tau)."""
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.ops import segments as G

    sem, dev = broker.semantic, broker._device_router()
    table = sem.table
    n_add, n_rm = SEM_COMPACT
    filters, vecs, ths = sem_broker_filters(rng, n_add)
    e0, opts = table.epoch, SubOpts()
    t0 = time.perf_counter()
    for i, f in enumerate(filters):
        sid = f"e{SEM_BROKER_N + i}"
        broker.subscribe(sid, sid, f, opts, rec.sink(sid), embedding=vecs[i],
                         sem_threshold=float(ths[i]))
    efilt = {sid: f for f, subs in broker._subs.items() for sid in subs
             if sid.startswith("e") and int(sid[1:]) < SEM_BROKER_N}
    for sid in sorted(efilt)[:: max(1, len(efilt) // n_rm)][:n_rm]:
        if not broker.unsubscribe(sid, efilt[sid]):
            raise AssertionError(f"unsubscribe {sid} refused")
    churn_s = time.perf_counter() - t0
    folds = table.epoch - e0
    owner = [o for o in dev.compaction_owners() if o.key == "semantic"][0]
    state0 = {"hot_fill": table.hot_fill, "tombstones": table.packed_tombs + table.hot_tombs,
              "live": table.live, "needs_compact": owner.needs_compact(),
              "inline_folds": folds}
    log = UploadLog()
    try:
        comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
        if state0["needs_compact"]:
            cycles = run_compactor(comp, [owner])
        else:
            t0 = time.perf_counter()
            comp.compact_now(owner)
            cycles = [{"key": owner.key, "seconds": time.perf_counter() - t0}]
        if comp.runs != 1 or comp.aborted:
            raise AssertionError(f"compact_semantic: runs {comp.runs}, aborted {comp.aborted}")
        adopt = adopting_prepare(torch, dev, log)
        packed = ("sem_vec", "sem_fid", "sem_slot", "sem_thresh")
        if any(k in packed for k in adopt["uploaded"]) \
                or adopt["moves"]["semantic"]["full_resyncs"] != 1:
            raise AssertionError(f"adopting prepare: {adopt['uploaded']}, {adopt['moves']}")
        mirror = check_sem_mirror(torch, adopt["args"], table)
    finally:
        log.close()
    traffic = [sem_broker_traffic(rng, BATCH)]
    sync, launches = sem_broker_publish(torch, broker, rec, traffic, fired,
                                        name="compact_semantic_publish")
    COMPACT_LAUNCHES["compact_semantic"] = dict(launches)
    return {"subscribed": n_add, "removed": n_rm, "churn_s": churn_s, "state_before": state0,
            "cycles": cycles, "runs": comp.runs, "aborted": comp.aborted,
            "merged": comp.metrics.get("router.compact.merged"),
            "offer_upload": [{"s": t1 - t0, "arrays": n, "bytes": b}
                             for t0, t1, n, b in log.offers],
            "adopting_prepare_ms": adopt["prepare_ms"], "adopting_moves": adopt["moves"],
            "adopting_uploads": adopt["uploaded"], "mirror_bytes_equal": mirror,
            "status": sem.status(), "launches": dict(launches), "card": card_line()}


def compact_session(torch, store, router, args, rng) -> dict:
    """`compact_session` on session_1m's store: with ride A's acks in the
    table as tombstones, the due (slot, pid) pairs are predicted from the
    host lanes; one `SessionSegmentOwner` cycle (tombstone_frac
    SESS_COMPACT_FRAC) rebuilds the 2^22-row table on the compaction
    thread and uploads it; the next rider's sync adopts it (no lane
    uploaded), its sweep lists exactly the predicted pairs' first
    SESS_SWEEP rows of the rebuilt table with the predicted count, and
    the mirror equals host."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.ops import segments as G

    table = store.table
    now, retry = store.now_ds(), store.retry_ds
    due = table.due_rows(now, retry)
    predicted = set(zip(table.sess_slot[due].tolist(), table.sess_pid[due].tolist()))
    owner = store.compaction_owner(tombstone_frac=SESS_COMPACT_FRAC)
    state0 = {"rows": table._cap, "live": table.live, "tombstones": table.tombstones,
              "tombstone_share": table.tombstones / table._cap,
              "needs_compact": owner.needs_compact(), "due": len(due)}
    if not state0["needs_compact"]:
        raise AssertionError(f"compact_session: the acks left {table.tombstones} tombstones")
    log = UploadLog()
    kernels.reset_launches()
    try:
        comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
        cycles = run_compactor(comp, [owner])
        if comp.runs != 1 or comp.aborted or store.table.tombstones:
            raise AssertionError(f"compact_session: runs {comp.runs}, aborted {comp.aborted}")
        c0 = store.manager.counters()
        log.take()
        store.request_sweep()
        ride = session_ride(torch, store, router, args, topic_batch_1m(rng, SESS_BATCH))
        c1 = store.manager.counters()
        uploaded = log.take()
    finally:
        log.close()
    moves = {k: c1[k] - c0[k] for k in c1}
    rows = ride["due"][ride["due"] >= 0]
    got = set(zip(store.table.sess_slot[rows].tolist(), store.table.sess_pid[rows].tolist()))
    if uploaded or moves["full_resyncs"] != 1 or ride["due_count"] != len(predicted) \
            or not got <= predicted or len(rows) != min(SESS_SWEEP, len(predicted)):
        raise AssertionError(f"compact_session: uploads {uploaded}, moves {moves}, due "
                             f"{ride['due_count']} against {len(predicted)}")
    launches = dict(kernels.LAUNCHES)
    COMPACT_LAUNCHES["compact_session"] = launches
    return {**state0, "tombstone_frac": SESS_COMPACT_FRAC, "cycles": cycles,
            "runs": comp.runs, "aborted": comp.aborted,
            "merged": comp.metrics.get("router.compact.merged"),
            "offer_upload": [{"s": t1 - t0, "arrays": n, "bytes": b}
                             for t0, t1, n, b in log.offers],
            "rows_after": store.table._cap, "adopting_moves": moves, "adopting_uploads": uploaded,
            "ride": {"due_count": ride["due_count"], "listed": int(len(rows)),
                     "ms": ride["ms"]},
            "mirror": check_session_mirror(torch, store), "launches": launches,
            "card": card_line()}


def broker_table_bytes(b, st) -> dict:
    """Every host array a broker's (and its session store's) mirrors
    upload, as bytes: what a restore must reproduce byte for byte."""
    out = {}
    for name, src in (("shapes", b.router.index.shapes), ("nfa", b.router.index.nfa),
                      ("subtab", b.subtab), ("groups", b.grouptab), ("sessions", st.table)):
        for k, v in src.device_snapshot().items():
            out[f"{name}.{k}"] = np.ascontiguousarray(v).tobytes()
    return out


def snapshot_broker(torch, broker, rec, rng, sess_capture):
    """`snapshot_broker`: broker_1m's tables and session_1m's store (its
    capture installed into a `SessionStore` attached to the broker)
    through the port's `DurableState(FileKv(data_dir), segments=
    SegmentStateSnapshot(...))`: the capture and install callables are the
    reference app's closures (emqx_tpu/app.py:660-700: router, subscriber
    table, group table, the store's capture; the install drops the device
    router). `flush` writes the data dir, a `.snapshot-*` directory beside
    the script, which the app phases then boot from (`app_path`; the
    caller removes it); `restore` installs it into a broker shell (a
    shallow copy of the broker: its registry, the session layer the app
    restores, is shared). The restored tables are byte-identical, the
    shell's first prepare is one full upload a mirror and the store's
    first sync one full upload, and the same batches from the same
    round-robin bases deliver what the original broker delivered (digests
    equal). -> (the phase's fields, the data dir, the tables' bytes)."""
    import copy
    import os
    import tempfile

    from emqx_tpu_torch.broker.persistent_session import DurableState
    from emqx_tpu_torch.broker.session_store import SessionStore
    from emqx_tpu_torch.ops import segments as G
    from emqx_tpu_torch.storage.kv import FileKv

    mono = [0.0]
    clock = lambda: mono[0]  # noqa: E731 — the frozen store clock
    store = SessionStore(capacity=64, sweep_slots=SESS_SWEEP, retry_interval=SESS_RETRY,
                         clock=clock, device="cuda")
    store.install(sess_capture)
    store.manager.sync(store.table)
    broker.session_store = store
    shell = copy.copy(broker)
    shell.session_store = SessionStore(capacity=64, sweep_slots=SESS_SWEEP,
                                       retry_interval=SESS_RETRY, clock=clock, device="cuda")
    shell._device = None

    def capture():
        return {"router": broker.router, "subtab": broker.subtab,
                "grouptab": broker.grouptab,
                "session_store": broker.session_store.capture()}

    def install(state):
        shell.router = state["router"]
        shell.subtab = state["subtab"]
        shell.grouptab = state["grouptab"]
        shell.session_store.install(state["session_store"])
        shell._device = None  # rebuilt on the next batch

    rr0 = ingest_rr_state(broker)
    want_tables = broker_table_bytes(broker, store)
    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = tempfile.mkdtemp(dir=here, prefix=".snapshot-")
    path = os.path.join(data_dir, "segments.pkl")
    gc.disable()  # the restore allocates millions of objects
    try:
        t0 = time.perf_counter()
        DurableState(FileKv(data_dir), segments=G.SegmentStateSnapshot(
            path, capture=capture)).flush()
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = DurableState(FileKv(data_dir), segments=G.SegmentStateSnapshot(
            path, capture=dict, install=install)).restore()
        load_s = time.perf_counter() - t0
    finally:
        # out of the collector's reach for the batches below: a full
        # collection over both brokers' objects took 9.7 s of the
        # first batch on the H100 host
        gc.freeze()
        gc.enable()
    if shell.router is broker.router or shell.router._matcher is not None:
        raise AssertionError("the shell did not take the restored router")
    if broker_table_bytes(shell, shell.session_store) != want_tables:
        raise AssertionError("a restored table differs from the saved one")
    sems = {"semantic_match": 2, "rule_masks": 1} if len(broker.semantic.table) else {}
    batches = [topic_batch_1m(rng, BATCH) for _ in range(SNAPSHOT_BATCHES)]
    launches = collections.Counter()
    runs = {}
    for name, b in (("original", broker), ("restored", shell)):
        ingest_rr_restore(b, rr0)
        timer = BrokerTimer(torch, b)
        try:
            dev = b._device_router()
            first = None
            if name == "restored":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dev.prepare()
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                st = dev.segment_status()
                if any(c["delta_launches"] or c["array_resyncs"] or c["full_resyncs"] != 1
                       for m, c in st.items() if m != "nfa"):
                    raise AssertionError(f"the restored broker's first prepare: {st}")
            digests, pubs = [], []
            for k, topics in enumerate(batches):
                got = []
                pubs.append(broker_publish(torch, b, rec, timer, topics, 60 + k, got_out=got,
                                           want_extra=sems))
                launches.update(pubs[-1]["launches"])
                digests.append(delivery_digest(got))
        finally:
            timer.remove(b)
        runs[name] = {"digests": digests, "first_prepare_s": first,
                      "publish_batch_ms": [p["publish_batch_ms"] for p in pubs],
                      "deliveries": [p["deliveries"] for p in pubs]}
    if runs["restored"]["digests"] != runs["original"]["digests"]:
        raise AssertionError("the restored broker delivered differently")
    c0 = shell.session_store.manager.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shell.session_store.manager.sync(shell.session_store.table)
    torch.cuda.synchronize()
    sess_sync_s = time.perf_counter() - t0
    c1 = shell.session_store.manager.counters()
    if c1["full_resyncs"] - c0["full_resyncs"] != 1:
        raise AssertionError(f"the restored store's first sync: {c0} -> {c1}")
    mirror = check_session_mirror(torch, shell.session_store)
    launches = dict(launches)
    COMPACT_LAUNCHES["snapshot_broker"] = launches
    broker.session_store = None
    shell._device = shell.session_store = None
    gc.unfreeze()
    fields = {"save_s": save_s, "file_bytes": size, "load_s": load_s,
              "data_dir_files": sorted(os.listdir(data_dir)), "restored": restored,
              "tables_equal": len(want_tables),
              "sessions": len(store._slots), "session_first_sync_s": sess_sync_s,
              "session_mirror": mirror, **{
                  f"{k}_{n}": v for n, r in runs.items() for k, v in r.items()},
              "launches": launches, "card": card_line()}
    return fields, data_dir, want_tables


# -- the app: BrokerApp over TCP on broker_1m's restored tables -----------------

APP_PLAIN = 48  # subscribers a plain group: restored device/{i}/+/{j}/# (QoS 1),
APP_HOT = 48  # restored device/{i}/# for 50 <= i < 98 (QoS 0), and
APP_NEW = 96  # new device/{i}/# for i >= 100 (QoS 1): 192 plain subscribers
APP_SHARE = 16  # members of $share/g/device/+/share/#
APP_SHARE_FILTER = "device/+/share/#"
APP_SHARE_TOPICS = 4096  # of the publishes, device/{i}/share/{k}
APP_RESIDUAL = 16  # subscribers on residual-shape filters (the NFA lane)
APP_RETAINED = 16  # subscribers to ret/{s}/# over the retained store
APP_RETAINED_N = 4096  # retained messages ret/{k % 16}/dev/{k}, stored first
APP_PUBLISHERS = 64
APP_PUBLISHES = 65536  # half QoS 0, half QoS 1
# a round of publishes, acked before the next: the config's
# ingest_max_batch, APP_ROUND / APP_PUBLISHERS = 64 from each publisher in
# one socket write, below a channel's PUB_PIPELINE_MAX (100), so a round
# can fill a batch without any channel stalling its reads
APP_ROUND = 4096
APP_DEVICE_SHARE = 0.9  # the least share of a phase's rounds' rows in device batches
APP_TARGETED = 8  # publishes aimed at each new, plain and residual filter
APP_PERSISTENT = 32  # of the plain QoS 1 subscribers: clean_start false, an expiry
APP_BURST = 8192  # app_restart's publishes
APP_WAIT_S = 120.0  # the longest wait for every expected delivery
APP_PIPE_LIMIT = 1 << 28  # one command or answer line to the client process
APP_REDUCED = [
    "the 304 MQTT clients share one process and event loop, on the app's host",
    "the durability flush interval is 3,600 s: with segment_snapshot on, "
    "every flush re-pickles the whole 1M-filter table on the event loop "
    "(the reference's behaviour), so only the stop's final flush writes"]
# the kernels the app's path runs (the bring-up table's "yes" rows)
APP_KERNELS = ("tokenize", "shape_match", "vocab_lookup", "nfa_walk", "segment_scatter",
               "sparse_fanout_slots", "share_pick", "occurrence_index", "row_lengths",
               "narrow_i16", "session_sweep")
APP_STORM_SERIES = ("retained.storm.fused", "retained.storm.flushed",
                    "retained.storm.deferred", "retained.storm.fallback",
                    "retained.storm.filters")
# every section the port's app refuses, switched off
APP_OFF = {
    "dashboard": {"enable": False},
    "observe": {"sys_mon_enable": False, "os_mon_enable": False, "vm_mon_enable": False,
                "slow_subs": {"enable": False}, "tpu_fallback_alarm_enable": False,
                "retrace_alarm_enable": False, "trace_spans_enable": False,
                "event_message": {k: False for k in (
                    "client_connected", "client_disconnected", "session_subscribed",
                    "session_unsubscribed", "message_delivered", "message_acked",
                    "message_dropped")}},
    "slo": {"alarm_enable": False},
}


def app_config(data_dir) -> dict:
    """The app phases' config: one TCP listener on 127.0.0.1:0, the refused
    sections off, durability with the segment snapshot in `data_dir`, the
    router at its defaults but for broker_1m's byte and level budgets
    (which its restored router carries), the device session store, the
    retained storms riding batches (`feed_broker`'s 30 s window, so only a
    publish batch answers the storm: a background compaction holding the
    GIL can starve the loop past a short window; the device index from
    4,096 stored topics), degrade and slo at their defaults."""
    return {**APP_OFF,
            "listeners": [{"bind": "127.0.0.1", "port": 0}],
            "durability": {"enable": True, "data_dir": data_dir, "segment_snapshot": True,
                           "flush_interval": 3600.0},
            "router": {"max_bytes": MAX_BYTES, "max_levels": MAX_LEVELS},
            "session": {"device_store": True},
            "retainer": {"storm_ride": True, "storm_window_us": int(FEED_WINDOW_S * 1e6),
                         "device_threshold": APP_RETAINED_N}}


def app_client_class():
    """The port's MQTT client, recording every PUBLISH it receives as
    (topic, payload, qos, retain); while `cork` is a list, the packets it
    sends collect there, and `uncork` writes them to the socket at once."""
    from emqx_tpu_torch.mqtt import packet as pkt
    from emqx_tpu_torch.mqtt.client import Client
    from emqx_tpu_torch.mqtt.frame import serialize

    class AppClient(Client):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.got = []
            self.cork = None

        def _send(self, p):
            if self.cork is None:
                super()._send(p)
            else:
                self.cork.append(serialize(p, self.version))

        def uncork(self):
            buf, self.cork = self.cork, None
            self._writer.write(b"".join(buf))

        def _handle(self, p):
            if p.type == pkt.PUBLISH:
                self.got.append((p.topic, bytes(p.payload), p.qos, p.retain))
            super()._handle(p)
            while not self.messages.empty():  # `got` keeps them
                self.messages.get_nowait()

    return AppClient


def app_clients_main() -> int:
    """`python3 chip_smoke.py --app-clients`: the app phases' MQTT clients
    in a process of their own, so the app's event loop serves the broker
    alone. One JSON command a line on stdin, one JSON answer a line on
    stdout (`AppClientProc` sends them): `connect`, `subscribe`, `publish`
    (in rounds: every publisher writes its next `each` publishes in one
    socket write, and every one of them is acked or written before the
    next round; QoS 1 PUBACK latencies timed), `wait` (for a count of deliveries), `collect` (every
    client's deliveries, pickled to a path), `close`, `exit`."""
    import asyncio
    import pickle

    from emqx_tpu_torch.mqtt import packet as pkt

    Client = app_client_class()
    clients = {}

    async def publish(cmd):
        lat, acks = [], []

        async def one(pub, t, pl, q, retain):
            t1 = time.perf_counter()
            ack = await pub.publish(t, pl.encode("latin-1"), qos=q, retain=retain,
                                    timeout=cmd["timeout"])
            if q:
                lat.append(time.perf_counter() - t1)
                acks.append(ack.reason_code)

        each, sends = cmd["each"], cmd["sends"]
        rounds = max(-(-len(items) // each) for items in sends.values())
        t0 = time.perf_counter()
        for r in range(rounds):
            tasks = []
            for cid, items in sends.items():
                clients[cid].cork = []
                tasks += [asyncio.ensure_future(one(clients[cid], *it))
                          for it in items[r * each:(r + 1) * each]]
            # each publish serializes into its publisher's cork before it
            # waits for its ack; then every publisher writes its burst
            for _ in range(100):
                await asyncio.sleep(0)
                if sum(len(clients[cid].cork) for cid in sends) >= len(tasks):
                    break
            for cid in sends:
                clients[cid].uncork()
            await asyncio.gather(*tasks)
        return {"s": time.perf_counter() - t0, "lat": lat, "acks": acks, "rounds": rounds}

    async def op(cmd):
        name = cmd["op"]
        if name == "connect":
            async def one(cid, version, clean_start, props):
                c = Client(client_id=cid, version=version, clean_start=clean_start,
                           properties=props)
                await c.connect("127.0.0.1", cmd["port"], timeout=30)
                clients[cid] = c
                return cid, c.connack.session_present

            t0 = time.perf_counter()
            present = dict(await asyncio.gather(*(one(*c) for c in cmd["clients"])))
            return {"s": time.perf_counter() - t0, "present": present}
        if name == "subscribe":
            rcs = {}
            for cid, filters in cmd["subs"]:
                sa = await clients[cid].subscribe(
                    [(f, pkt.SubOpts(qos=q)) for f, q in filters], timeout=30)
                rcs[cid] = sa.reason_codes
            return {"rcs": rcs}
        if name == "publish":
            return await publish(cmd)
        if name == "wait":
            t0 = time.perf_counter()
            count = lambda: sum(len(c.got) for c in clients.values())  # noqa: E731
            while count() < cmd["n"] and time.perf_counter() - t0 < cmd["timeout"]:
                await asyncio.sleep(0.02)
            s = time.perf_counter() - t0
            await asyncio.sleep(0.5)  # nothing more may arrive
            return {"s": s, "got": count()}
        if name == "collect":
            with open(cmd["path"], "wb") as f:
                pickle.dump({cid: c.got for cid, c in clients.items()}, f)
            return {}
        if name == "close":
            for cid in cmd["abrupt"]:  # no DISCONNECT: the session detaches
                clients[cid]._writer.close()
            for cid, c in clients.items():
                if cid not in cmd["abrupt"]:
                    await c.disconnect()
            return {}
        if name == "exit":
            return {}
        raise ValueError(f"unknown op {name!r}")

    async def run():
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader(limit=APP_PIPE_LIMIT)
        await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
        while True:
            line = await reader.readline()
            if not line:
                return
            cmd = json.loads(line)
            try:
                out = {"ok": True, **await op(cmd)}
            except Exception as e:  # noqa: BLE001 - answered, the parent raises it
                out = {"ok": False, "error": repr(e)}
            print(json.dumps(out), flush=True)
            if cmd["op"] == "exit":
                return

    asyncio.run(run())
    return 0


class AppClientProc:
    """The parent's end of `app_clients_main`: started before the app it
    connects to (its torch import overlaps the app's boot), driven one
    command at a time from the app's event loop, and killed if it is
    still running at `stop`."""

    async def start(self):
        import asyncio
        import os

        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, os.path.abspath(__file__), "--app-clients",
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, limit=APP_PIPE_LIMIT)
        return self

    async def __call__(self, op: str, **kw) -> dict:
        import asyncio

        self.proc.stdin.write((json.dumps({"op": op, **kw}) + "\n").encode())
        await self.proc.stdin.drain()
        line = await asyncio.wait_for(self.proc.stdout.readline(), 2 * APP_WAIT_S)
        if not line:
            raise AssertionError(f"app clients: the process ended at {op!r}")
        out = json.loads(line)
        if not out.pop("ok"):
            raise AssertionError(f"app clients: {op}: {out['error']}")
        return out

    async def stop(self) -> None:
        import asyncio

        if self.proc.returncode is None:
            try:
                await self("exit")
                await asyncio.wait_for(self.proc.wait(), 30)
            except Exception:  # noqa: BLE001 - then it is killed
                self.proc.kill()
                await self.proc.wait()


class AppBatches:
    """Wraps the app broker's `adispatch_begin`: each batch's size, the
    (topic, payload) of each message a CPU batch (below `min_tpu_batch`)
    took, and at each batch (so after every earlier one) no degraded
    batch and no injected fault."""

    def __init__(self, app):
        self.app = app
        self.sizes = []
        self.cpu_rows = set()
        self.first_t = None
        broker = app.broker
        self._orig = broker.adispatch_begin

        def begin(msgs):
            self.check()
            if self.first_t is None:
                self.first_t = time.perf_counter()
            self.sizes.append(len(msgs))
            if len(msgs) < broker.router.min_tpu_batch:
                self.cpu_rows.update((m.topic, bytes(m.payload)) for m in msgs)
            return self._orig(msgs)

        broker.adispatch_begin = begin

    def check(self) -> None:
        m = self.app.broker.metrics
        bad = {k: m.get(k) for k in ("degrade.fallback.batches", "faults.injected",
                                     "messages.routed.device_fallback") if m.get(k)}
        if bad:
            raise AssertionError(f"app: a batch left the device path: {bad}")

    def device_rows(self) -> int:
        floor = self.app.broker.router.min_tpu_batch
        return sum(n for n in self.sizes if n >= floor)

    def device_share(self, first: int) -> float:
        """The share of the rows of the batches from the `first`-th on that
        went through the device route."""
        floor = self.app.broker.router.min_tpu_batch
        s = self.sizes[first:]
        return sum(n for n in s if n >= floor) / max(1, sum(s))

    def summary(self) -> dict:
        self.check()
        s = np.asarray(self.sizes or [0])
        floor = self.app.broker.router.min_tpu_batch
        return {"batches": len(self.sizes), "rows": int(s.sum()),
                "device_batches": int((s >= floor).sum()),
                "cpu_batches": int(((s > 0) & (s < floor)).sum()),
                "rows_p50": float(np.percentile(s, 50)), "rows_max": int(s.max())}


def app_state(app, batches) -> dict:
    """What a stalled app phase shows: its batches and the series of the
    ingest, the SLO ladder, the breaker, the storm feed and the store."""
    m = app.broker.metrics
    ing = app.broker.ingest
    names = ("ingest.shed", "slo.shed", "messages.routed.device", "messages.dispatch_error",
             "degrade.fallback.batches", "faults.injected", "session.sweep.device",
             "session.sweep.host", "session.redeliveries", *APP_STORM_SERIES)
    return {"batches": len(batches.sizes), "last_sizes": batches.sizes[-8:],
            "rung": app.slo.rung if app.slo is not None else None,
            "pending": None if ing is None else len(ing._pending),
            **{k: m.get(k) for k in names}}


def app_stages(m) -> dict:
    """The broker's stage histograms over a phase: how many and how many
    seconds in all (table syncs on the loop thread, host fan-out, the
    batches' wait in the ingest queue, settles, the device's idle gaps)."""
    out = {}
    for name in ("profile.stage.prepare.seconds", "profile.stage.host_dispatch.seconds",
                 "profile.stage.queue_wait.seconds", "ingest.settle.seconds",
                 "ingest.device.idle.seconds"):
        h = m.histogram(name)
        if h is not None:
            snap = h.snapshot()
            out[name] = {"count": snap["count"], "sum_s": snap["sum"]}
    return out


def app_oracle(subs, sent):
    """{client: sorted [(topic, payload, qos)]}: what each subscriber must
    receive. `subs`: client -> [(filter, granted qos)]; `sent`: [(topic,
    payload, qos)]. One delivery a matching subscription; each topic is
    matched once against a trie of the clients' filters."""
    from emqx_tpu_torch.broker.trie import TopicTrie

    trie, owners = TopicTrie(), collections.defaultdict(list)
    for cid, filters in subs.items():
        for f, sq in filters:
            trie.insert(f)
            owners[f].append((cid, sq))
    out = {cid: [] for cid in subs}
    for t, pl, q in sent:
        for f in trie.match(t):
            for cid, sq in owners[f]:
                out[cid].append((t, pl, min(q, sq)))
    return {cid: sorted(v) for cid, v in out.items()}


def app_slot_prediction(broker, subs, sent):
    """The deliveries the device fan-out makes to the clients of `subs`
    ({client: [(filter, qos)]}) from the broker's tables, on the host: for
    each topic one of their filters matches (the fan-out's filter re-check
    drops every other), the topic's matched filters (the CPU trie), the
    union of their subscriber-table rows, and each slot's subscriber in
    the broker's registry, if it is one of these clients and its filter
    matches the topic. -> {client: sorted [(topic, payload, qos)]}."""
    from emqx_tpu_torch.broker.trie import TopicTrie
    from emqx_tpu_torch.ops import topics as T

    mine = TopicTrie()
    for filters in subs.values():
        for f, _q in filters:
            mine.insert(f)
    r, sub = broker.router, broker.subtab
    reg = broker._slot_subs
    out = {c: [] for c in subs}
    for t, pl, q in sent:
        if not mine.match(t):
            continue
        slots = set()
        for name in r.match(t):
            fid = r.filter_id(name)
            if fid is None:
                continue
            if sub.sparse:
                slots.update(sub.csr.slots_of(fid).tolist())
            elif fid < sub.arr.shape[0]:
                row = np.ascontiguousarray(sub.arr[fid])
                slots.update(np.nonzero(np.unpackbits(row.view(np.uint8),
                                                      bitorder="little"))[0].tolist())
        for s in slots:
            x = reg[s] if 0 <= s < len(reg) else None
            if x is not None and x.client_id in out and T.match(t, x.filter):
                out[x.client_id].append((t, pl, min(q, x.opts.qos)))
    return {c: sorted(v) for c, v in out.items()}


def residual_filters(index, n_residual):
    """Filters of distinct shapes under res/: enough to fill the shape
    table's free shapes, then `n_residual` past it, which the index sends
    to the residual NFA. -> (fillers, residuals), each with one topic that
    matches it."""
    from emqx_tpu_torch.ops.shape_index import MAX_SHAPES, ShapeIndex

    live = set(index.shapes._shape_ids)
    free = MAX_SHAPES - len(live)
    out = []
    for plen in range(2, MAX_LEVELS):
        for has_hash in (False, True):
            if plen + has_hash > MAX_LEVELS:
                continue
            for mask in range(1 << (plen - 1)):
                words = ["res"] + [f"w{k}" if mask >> (k - 1) & 1 else "+"
                                   for k in range(1, plen)]
                f = "/".join(words + (["#"] if has_hash else []))
                if ShapeIndex.parse_shape(f)[:3] in live:
                    continue
                topic = "/".join(["res"] + [f"w{k}" if w != "+" else "x"
                                            for k, w in enumerate(words[1:], 1)]
                                 + (["y"] if has_hash else []))
                out.append((f, topic))
                if len(out) == free + n_residual:
                    return out[:free], out[free:]
    raise AssertionError("not enough distinct res/ shapes")


def app_path(torch, data_dir, want_tables, rng) -> dict:
    """The app phases: the port's `BrokerApp` boots from the data dir
    `snapshot_broker` wrote (broker_1m's tables and session_1m's store),
    serves 304 MQTT clients over loopback TCP, stops with its final flush,
    boots again from the same dir for the persistent sessions, and
    `python -m emqx_tpu_torch` serves one round trip in a subprocess.
    -> each kernel's launches while the first app served its clients."""
    import asyncio

    return asyncio.run(app_phases(torch, data_dir, want_tables, rng))


async def app_boot(torch, cfg):
    """Build and start a BrokerApp from `cfg`, each restore and the warmup
    timed (the app freezes the heap after its restore). -> (app, timings)."""
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.config.schema import load_config
    from emqx_tpu_torch.models.router_model import DeviceRouter

    app = BrokerApp(load_config(cfg))
    spans = {}

    def timed(obj, attr, name, sync=False):
        fn = getattr(obj, attr)

        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                spans.setdefault(name, time.perf_counter() - t0)

        setattr(obj, attr, wrapper)
        return lambda: setattr(obj, attr, fn)

    subscribes = [0]
    real_sub = Broker.subscribe

    def counting(self, *a, **kw):
        subscribes[0] += 1
        return real_sub(self, *a, **kw)

    undo = [timed(app.session_persistence, "restore", "session_restore_s"),
            timed(app.durable_state, "restore", "durable_restore_s")]
    prep, route = DeviceRouter.prepare, DeviceRouter.route_prepared
    uploads = {}

    def first_prepare(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = prep(self)
        torch.cuda.synchronize()
        if "first_prepare_s" not in spans:
            spans["first_prepare_s"] = time.perf_counter() - t0
            uploads.update(mirror_counts(self))
            uploads["bytes"] = sum(mirror_bytes(args.tables).values()) + sum(
                mirror_bytes(args.group_tables or {}).values())
        return args

    def first_route(self, *a, **kw):
        t0 = time.perf_counter()
        out = route(self, *a, **kw)
        torch.cuda.synchronize()
        spans.setdefault("warmup_route_s", time.perf_counter() - t0)
        return out

    Broker.subscribe, DeviceRouter.prepare, DeviceRouter.route_prepared = (
        counting, first_prepare, first_route)
    t0 = time.perf_counter()
    try:
        await app.start()
    finally:
        spans["start_s"] = time.perf_counter() - t0
        Broker.subscribe, DeviceRouter.prepare, DeviceRouter.route_prepared = (
            real_sub, prep, route)
        for u in undo:
            u()
    spans["subscribes_replayed"] = subscribes[0]
    spans["first_upload"] = uploads
    return app, spans


async def app_phases(torch, data_dir, want_tables, rng) -> dict:
    """`app_boot`, `app_clients`, `app_restart` and `app_main` (see
    `app_path`), the clients in a process of their own (`AppClientProc`),
    a fresh one for the restart."""
    import asyncio
    import os
    import pickle

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.mqtt import packet as pkt
    from emqx_tpu_torch.ops import topics as T

    cfg = app_config(data_dir)
    v5, v4 = pkt.MQTT_V5, pkt.MQTT_V4
    expiry = {"Session-Expiry-Interval": 3600}
    clients = await AppClientProc().start()  # imports while the app boots
    main = None
    try:
        # -- app_boot -------------------------------------------------------------
        app, boot = await app_boot(torch, cfg)
        tables = broker_table_bytes(app.broker, app.session_store)
        if tables != want_tables:
            bad = sorted(k for k in want_tables if tables.get(k) != want_tables[k])
            raise AssertionError(f"app_boot: restored tables differ from broker_1m's: {bad}")
        n_filters = len(app.broker.router)
        if boot["subscribes_replayed"] or n_filters < BROKER_IDS * BROKER_NUMS:
            raise AssertionError(f"app_boot: {boot['subscribes_replayed']} subscribes replayed, "
                                 f"{n_filters} filters restored")
        port = next(iter(app.listeners.list().values())).port
        phase("app_boot", filters=n_filters, sessions=len(app.session_store._slots),
              tables_equal=len(want_tables), port=port, **boot,
              sub_table="csr" if app.broker.subtab.sparse else "dense",
              config={k: cfg[k] for k in ("router", "session", "retainer", "durability")},
              reduced=APP_REDUCED, card=card_line())

        # -- app_clients ----------------------------------------------------------
        kernels.reset_launches()
        m = app.broker.metrics
        batches = AppBatches(app)
        plain = []
        for k in range(APP_PLAIN):
            plain.append((f"ap{k}", f"device/{k}/+/{(7 * k) % BROKER_NUMS}/#", 1))
        for k in range(APP_HOT):
            plain.append((f"ah{k}", f"device/{50 + k}/#", 0))
        for k in range(APP_NEW):
            plain.append((f"an{k}", f"device/{BROKER_HOT + k}/#", 1))
        persistent = [cid for cid, _f, _q in plain[:APP_PERSISTENT]]
        subs = {cid: [(f, q)] for cid, f, q in plain}  # client id -> [(filter, granted qos)]
        conns = [[cid, v5 if k % 2 == 0 else v4, cid not in persistent,
                  expiry if cid in persistent and k % 2 == 0 else None]
                 for k, (cid, _f, _q) in enumerate(plain)]
        for pre, n in (("as", APP_SHARE), ("ar", APP_RESIDUAL), ("at", APP_RETAINED),
                       ("pub", APP_PUBLISHERS)):
            conns += [[f"{pre}{k}", v5 if k % 2 == 0 else v4, True, None] for k in range(n)]
        r = await clients("connect", port=port, clients=conns)
        connect_s = r["s"]
        await clients("subscribe", subs=[[f"as{k}", [[f"$share/g/{APP_SHARE_FILTER}", 0]]]
                                         for k in range(APP_SHARE)])
        r = await clients("subscribe", subs=[[cid, [[f, q]]] for cid, f, q in plain])
        bad = {cid: rc for cid, rc in r["rcs"].items() if rc != [subs[cid][0][1]]}
        if bad:
            raise AssertionError(f"app_clients: SUBACKs {bad}")
        fillers, residuals = residual_filters(app.broker.router.index, APP_RESIDUAL)
        for k, (f, _t) in enumerate(residuals):
            subs[f"ar{k}"] = [(f, 0)] + [(g, 0) for g, _t in fillers[k::APP_RESIDUAL]]
        await clients("subscribe", subs=[[f"ar{k}", subs[f"ar{k}"]] for k in range(APP_RESIDUAL)])
        residual_count = app.broker.router.index.residual_count
        if residual_count < APP_RESIDUAL:
            raise AssertionError(f"app_clients: {residual_count} residual filters")
        # the traffic: broker_1m topics, a few aimed at every new, plain and
        # residual filter, and the $share group's own subtree
        aimed = []
        for k in range(APP_NEW):
            aimed += [f"device/{BROKER_HOT + k}/mid/{j}/leaf" for j in range(APP_TARGETED)]
        for k in range(APP_PLAIN):
            aimed += [f"device/{k}/mid/{(7 * k) % BROKER_NUMS}/leaf"] * APP_TARGETED
        for _f, t in fillers + residuals:
            aimed += [t] * APP_TARGETED
        aimed += [f"device/{i}/share/{k}"
                  for k, i in enumerate(zipf_ids(rng, APP_SHARE_TOPICS, BROKER_IDS))]
        topics = topic_batch_1m(rng, APP_PUBLISHES - len(aimed)) + aimed
        topics = [topics[i] for i in rng.permutation(len(topics))]
        # each publisher alternates QoS 0 and 1
        sent = [(t, b"%d" % k, (k // APP_PUBLISHERS) % 2) for k, t in enumerate(topics)]
        want = app_oracle(subs, sent)
        # the host model of the fan-out that predicts app_restart's deliveries,
        # held to the oracle here, where the registry took its slots afresh
        psubs = {c: subs[c] for c in persistent}
        t0 = time.perf_counter()
        model = app_slot_prediction(app.broker, psubs, sent)
        model_s = time.perf_counter() - t0
        if any(model[c] != want[c] for c in persistent):
            raise AssertionError("app_clients: the slot model disagrees with the oracle")
        rets = {f"at{k}": sorted((f"ret/{k}/dev/{j}", b"r%d" % j, 1)
                                 for j in range(k, APP_RETAINED_N, APP_RETAINED))
                for k in range(APP_RETAINED)}
        share_want = sorted((t, pl) for t, pl, _q in sent if T.match(t, APP_SHARE_FILTER))
        n_want = sum(map(len, want.values())) + sum(map(len, rets.values())) + len(share_want)

        def sends(items, publishers):
            return {f"pub{p}": [[t, pl.decode("latin-1"), q, retain]
                                for t, pl, q, retain in items[p::publishers]]
                    for p in range(publishers)}

        async def publish(what, items, publishers, each):
            try:
                return await clients("publish", sends=sends(items, publishers), each=each,
                                     timeout=APP_WAIT_S)
            except AssertionError as e:
                raise AssertionError(f"{what}: {e}: {app_state(app, batches)}") from e

        # the retained store, then its wildcard subscribers: their replays wait
        # in the storm feed for the publishers' first device batch
        r = await publish("app_clients", [(f"ret/{k % APP_RETAINED}/dev/{k}", b"r%d" % k, 1, True)
                                          for k in range(APP_RETAINED_N)], 1, 100)
        retained_publish_s = r["s"]
        if len(app.retainer) != APP_RETAINED_N or not app.retainer._device_ready():
            raise AssertionError(f"app_clients: {len(app.retainer)} retained, device index "
                                 f"ready {app.retainer._device_ready()}")
        await clients("subscribe", subs=[[f"at{k}", [[f"ret/{k}/#", 1]]]
                                         for k in range(APP_RETAINED)])
        first = len(batches.sizes)
        r = await publish("app_clients", [(t, pl, q, False) for t, pl, q in sent],
                          APP_PUBLISHERS, APP_ROUND // APP_PUBLISHERS)
        acked_s, lat, acks = r["s"], r["lat"], r["acks"]
        w = await clients("wait", n=n_want, timeout=APP_WAIT_S)
        delivered_s = acked_s + w["s"]
        app_launches = dict(kernels.LAUNCHES)
        path = os.path.join(data_dir, "clients.pkl")
        await clients("collect", path=path)
        with open(path, "rb") as f:
            recs = pickle.load(f)
        got = {cid: sorted((t, pl, q) for t, pl, q, _r in recs[cid]) for cid in want}
        bad = {cid: (len(got[cid]), len(w)) for cid, w in want.items() if got[cid] != w}
        if bad:
            raise AssertionError(f"app_clients: deliveries differ from the oracle "
                                 f"(got, want): {dict(list(bad.items())[:8])}, {len(bad)} clients")
        for cid, w in rets.items():
            g = recs[cid]
            if sorted((t, pl, q) for t, pl, q, _r in g) != w or not all(r for *_x, r in g):
                raise AssertionError(f"app_clients: {cid} retained replay {len(g)} of {len(w)}")
        share_got = sorted((t, pl) for k in range(APP_SHARE) for t, pl, _q, _r in recs[f"as{k}"])
        if share_got != share_want:
            raise AssertionError(f"app_clients: $share deliveries {len(share_got)} of "
                                 f"{len(share_want)}, each once to one member")
        if len(acks) != APP_PUBLISHES // 2 or set(acks) - {0, 0x10}:
            raise AssertionError(f"app_clients: {len(acks)} PUBACKs, codes {set(acks)}")
        summary = batches.summary()
        routed = m.get("messages.routed.device")
        if routed != batches.device_rows():
            raise AssertionError(f"app_clients: messages.routed.device {routed} against "
                                 f"{batches.device_rows()} rows in device batches")
        share = batches.device_share(first)
        if share < APP_DEVICE_SHARE:
            raise AssertionError(f"app_clients: {share:.3f} of the rounds' rows in device "
                                 f"batches: {summary}")
        storms = m.get("retained.storm.fused")
        idle = [k for k in APP_KERNELS if not app_launches.get(k)]
        if idle or not storms:
            raise AssertionError(f"app_clients: kernels that never launched {idle}, storms "
                                 f"{ {k: m.get(k) for k in APP_STORM_SERIES} }")
        phase("app_clients", connections=len(conns), connect_s=connect_s,
              subscribers=len(subs) + APP_SHARE + APP_RETAINED, publishers=APP_PUBLISHERS,
              publishes=APP_PUBLISHES, residual_filters=residual_count, model_s=model_s,
              retained=APP_RETAINED_N, retained_publish_s=retained_publish_s,
              deliveries=n_want, acked_s=acked_s, delivered_s=delivered_s,
              messages_per_s=APP_PUBLISHES / acked_s, deliveries_per_s=n_want / delivered_s,
              puback_p50_ms=1e3 * float(np.percentile(lat, 50)),
              puback_p99_ms=1e3 * float(np.percentile(lat, 99)),
              rounds=r["rounds"], device_share=share,
              storms={k: m.get(k) for k in APP_STORM_SERIES},
              session_sweeps=m.get("session.sweep.device"), stages=app_stages(m), **summary,
              routed_device=routed, app_launches=app_launches, card=card_line())

        # -- app_restart ----------------------------------------------------------
        for _ in range(200):  # the persistent sessions' windows drain
            if not any(len(s.inflight) for s in (ch.session for ch in map(
                    app.cm.get_channel, persistent) if ch is not None) if s is not None):
                break
            await asyncio.sleep(0.05)
        # the persistent clients drop their sockets (their sessions detach),
        # the others disconnect; the second process imports during the stop
        await clients("close", abrupt=persistent)
        await clients.stop()
        clients = await AppClientProc().start()
        for _ in range(200):  # the dropped sockets' sessions detach
            if len(app.cm._detached) >= len(persistent):
                break
            await asyncio.sleep(0.05)
        main = app_main_start(data_dir)
        t0 = time.perf_counter()
        await app.stop()
        stop_s = time.perf_counter() - t0
        kv_files = sorted(f for f in os.listdir(data_dir) if not f.startswith("clients"))
        del app, batches
        torch.cuda.empty_cache()
        t_boot = time.perf_counter()
        app2, boot2 = await app_boot(torch, cfg)
        if boot2["subscribes_replayed"] > sum(len(v) for v in psubs.values()):
            raise AssertionError(
                f"app_restart: {boot2['subscribes_replayed']} subscribes replayed")
        if sorted(app2.cm._detached) != sorted(persistent):
            raise AssertionError(f"app_restart: detached {len(app2.cm._detached)}")
        port2 = next(iter(app2.listeners.list().values())).port
        batches2 = AppBatches(app2)
        conns = [[cid, v5 if k % 2 == 0 else v4, False, expiry if k % 2 == 0 else None]
                 for k, cid in enumerate(persistent)]
        conns += [[f"pub{k}", v4, True, None] for k in range(APP_PUBLISHERS)]
        r = await clients("connect", port=port2, clients=conns)
        lost = [cid for cid in persistent if not r["present"][cid]]
        if lost:
            raise AssertionError(f"app_restart: {lost} resumed no session")
        aimed = [f"device/{k}/mid/{(7 * k) % BROKER_NUMS}/leaf"
                 for k in range(APP_PERSISTENT) for _ in range(APP_TARGETED)]
        topics = topic_batch_1m(rng, APP_BURST - len(aimed)) + aimed
        topics = [topics[i] for i in rng.permutation(len(topics))]
        sent2 = [(t, b"b%d" % k, (k // APP_PUBLISHERS) % 2) for k, t in enumerate(topics)]
        oracle = app_oracle(psubs, sent2)
        r = await clients("publish", sends=sends([(t, pl, q, False) for t, pl, q in sent2],
                                                 APP_PUBLISHERS),
                          each=APP_ROUND // APP_PUBLISHERS, timeout=APP_WAIT_S)
        lat = r["lat"]
        share2 = batches2.device_share(0)
        if share2 < APP_DEVICE_SHARE:
            raise AssertionError(f"app_restart: {share2:.3f} of the rows in device batches: "
                                 f"{batches2.summary()}")
        # a device batch delivers as the slot model says; a batch below
        # min_tpu_batch takes the CPU path, which delivers by filter (the
        # oracle), and every publish has settled once it is acked
        on_cpu = [x for x in sent2 if (x[0], x[1]) in batches2.cpu_rows]
        model = app_slot_prediction(
            app2.broker, psubs, [x for x in sent2 if (x[0], x[1]) not in batches2.cpu_rows])
        by_filter = app_oracle(psubs, on_cpu)
        predicted = {c: sorted(model[c] + by_filter[c]) for c in persistent}
        n_pred = sum(map(len, predicted.values()))
        await clients("wait", n=n_pred, timeout=APP_WAIT_S)
        path = os.path.join(data_dir, "clients2.pkl")
        await clients("collect", path=path)
        with open(path, "rb") as f:
            recs = pickle.load(f)
        got2 = {cid: sorted((t, pl, q) for t, pl, q, _r in recs[cid]) for cid in persistent}
        if got2 != predicted:
            bad = {c: (len(got2[c]), len(predicted[c]), len(oracle[c]),
                       sorted(set(got2[c]) ^ set(predicted[c]))[:4])
                   for c in persistent if got2[c] != predicted[c]}
            raise AssertionError(f"app_restart: deliveries differ from the slot prediction "
                                 f"(got, predicted, oracle, a sample of the difference): "
                                 f"{bad}")
        # the restore's device path checked on most of the sessions' deliveries
        dev_share2 = sum(len(model[c]) for c in persistent) / max(1, n_pred)
        if dev_share2 < APP_DEVICE_SHARE:
            raise AssertionError(f"app_restart: {dev_share2:.3f} of the persistent sessions' "
                                 f"deliveries from device batches")
        summary2 = batches2.summary()
        routed2 = app2.broker.metrics.get("messages.routed.device")
        if routed2 != batches2.device_rows():
            raise AssertionError(f"app_restart: messages.routed.device {routed2} against "
                                 f"{batches2.device_rows()}")
        await clients("close", abrupt=[])
        # the second app's final flush leaves the 1M-table pickle out: the
        # first stop measured it, and the dir is removed after the phases
        app2.durable_state.segments = None
        await app2.stop()
        phase("app_restart", persistent=len(persistent), stop_flush_s=stop_s,
              data_dir_files=kv_files, restore=boot2,
              first_batch_s=batches2.first_t - t_boot if batches2.first_t else None,
              publishes=APP_BURST, device_share=share2, cpu_rows=len(on_cpu),
              oracle_deliveries=sum(map(len, oracle.values())),
              predicted_deliveries=n_pred, device_delivery_share=dev_share2,
              clients_as_oracle=sum(predicted[c] == oracle[c] for c in persistent),
              puback_p50_ms=1e3 * float(np.percentile(lat, 50)),
              puback_p99_ms=1e3 * float(np.percentile(lat, 99)), **summary2,
              card=card_line())
        del app2
        phase("app_main", **await app_main_check(*main))
        return app_launches
    finally:
        await clients.stop()
        if main is not None and main[0].poll() is None:
            main[0].kill()
            main[0].wait()


def app_main_start(data_dir):
    """`app_main`'s subprocess, `python -m emqx_tpu_torch -c small.json
    --no-dashboard` (one TCP listener on port 0, `min_tpu_batch` 1: the
    device route), started while the first app's final flush runs so that
    its torch import overlaps it. -> (the process, its start time)."""
    import os

    path = os.path.join(data_dir, "small.json")
    with open(path, "w") as f:
        json.dump({**APP_OFF, "dashboard": {"enable": True},
                   "listeners": [{"bind": "127.0.0.1", "port": 0}],
                   "router": {"min_tpu_batch": 1}}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch", "-c", path, "--no-dashboard"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, t0


async def app_main_check(proc, t0) -> dict:
    """`app_main`: the subprocess's listener line, one QoS 1 round trip,
    SIGTERM, exit 0; the process is killed if it is still running."""
    import asyncio
    import re
    import signal

    from emqx_tpu_torch.mqtt.client import Client

    loop = asyncio.get_running_loop()
    try:
        line = await loop.run_in_executor(None, proc.stdout.readline)
        ready_s = time.perf_counter() - t0
        found = re.fullmatch(r"emqx_tpu_torch listener tcp:default on 127\.0\.0\.1:(\d+)\n",
                             line)
        if not found:
            proc.kill()
            raise AssertionError(f"app_main: {line!r} {proc.stderr.read()[-2000:]}")
        port = int(found.group(1))
        sub, pub = Client("main-sub"), Client("main-pub")
        await sub.connect("127.0.0.1", port, timeout=30)
        await sub.subscribe("main/t", qos=1)
        await pub.connect("127.0.0.1", port, timeout=30)
        t1 = time.perf_counter()
        ack = await pub.publish("main/t", b"hi", qos=1, timeout=30)
        msg = await sub.recv(30)
        rt = time.perf_counter() - t1
        await sub.disconnect()
        await pub.disconnect()
        if ack.reason_code or (msg.topic, msg.payload, msg.qos) != ("main/t", b"hi", 1):
            raise AssertionError(f"app_main: {ack} {msg}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = await loop.run_in_executor(None, lambda: proc.wait(timeout=30))
        exit_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"app_main: exit {rc}: {proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"listener_line_s": ready_s, "round_trip_ms": 1e3 * rt, "sigterm_exit_s": exit_s,
            "exit_code": rc, "card": card_line()}


def mesh_compact_broker(torch, mesh, broker, rec, dev, batches, rr0, got_sync) -> dict:
    """The mesh broker's compaction (in `mesh_broker_2x2`): MESH_COMPACT
    subscribes on fresh filters no batch hits, then one shape and one CSR
    cycle with `compact_now` on every rank at the same batch boundary (the
    ranks hold the same host tables and compact their own copies; each
    rank's CSR build uploads its own 'tp' shard); the next prepare adopts
    them, every rank's mirror equals its block, and the same batches from
    the same bases deliver what they delivered before the cycle."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.mqtt.packet import SubOpts
    from emqx_tpu_torch.ops import segments as G

    opts = SubOpts()
    t0 = time.perf_counter()
    for k in range(MESH_COMPACT):
        sid = f"m{k}"
        broker.subscribe(sid, sid, f"device/{k % BROKER_IDS}/+/{2000 + k}/#", opts,
                         rec.sink(sid))
    storm_s = time.perf_counter() - t0
    owners = [o for o in dev.compaction_owners() if o.key in ("shapes", "bitmaps")]
    comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
    log = UploadLog()
    cycles = {}
    try:
        for o in owners:
            need = o.needs_compact()
            t0 = time.perf_counter()
            if not comp.compact_now(o):
                raise AssertionError(f"mesh compaction: the {o.key} cycle aborted")
            cycles[o.key] = {"needed": need, "seconds": time.perf_counter() - t0}
        if comp.metrics.get("mesh.shard.compact.runs") != 2:
            raise AssertionError("mesh compaction: the owners carry no mesh placement")
        adopt = adopting_prepare(torch, dev, log)
        if any(k == "shape_tab" or k.startswith("csr_") for k in adopt["uploaded"]) \
                or adopt["moves"]["shapes"]["full_resyncs"] != 1 \
                or adopt["moves"]["bitmaps"]["full_resyncs"] != 1:
            raise AssertionError(f"mesh adopting prepare: {adopt['uploaded']}, {adopt['moves']}")
        mirrors = mesh_mirrors(torch, [(dev._shape_sync, broker.router.index.shapes),
                                       (dev._bits_sync, broker.subtab)])
    finally:
        log.close()
    ingest_rr_restore(broker, rr0)
    timer = BrokerTimer(torch, broker)
    launches = collections.Counter()
    digests = []
    try:
        for b, topics in enumerate(batches):
            got = []
            pub = broker_publish(torch, broker, rec, timer, topics, b, got_out=got)
            launches.update(pub["launches"])
            digests.append(delivery_digest(got))
    finally:
        timer.remove(broker)
    if digests != [delivery_digest(g) for g in got_sync]:
        raise AssertionError(f"mesh compaction: digests {digests} after the cycle")
    return {"storm": MESH_COMPACT, "storm_s": storm_s, "cycles": cycles, "runs": comp.runs,
            "aborted": comp.aborted, "merged": comp.metrics.get("router.compact.merged"),
            "offer_upload": [{"s": t1 - t0, "arrays": n, "bytes": b}
                             for t0, t1, n, b in log.offers],
            "adopting_prepare_ms": adopt["prepare_ms"], "adopting_moves": adopt["moves"],
            "adopting_uploads": adopt["uploaded"], "mirrors": mirrors, "digests": digests,
            "launches": dict(launches)}


# -- the mesh paths (port of emqx_tpu/parallel/mesh.py) ---------------------------

MESH_WORLD = 4  # a 2 x 2 ('dp', 'tp') mesh
MESH_TP = 2
MESH_TIMEOUT = {"share": 480, "1m": 420, "nccl1": 150, "plus": 300,  # s, each launch
                "broker": 420}
MESH_DEADLINE = 900  # the whole mesh process


def mesh_reduced(backend: str, n_gpu: int) -> list:
    if backend == "nccl":
        return []
    return [f"{MESH_WORLD} gloo ranks share cuda:0 ({n_gpu} visible GPU): the "
            "collectives are staged through the host, so the mesh paths measure the "
            "sharded kernels, the layout, the collectives' semantics and the assembly, "
            "not NVLink"]


def mesh_route(router, topics, oracle, kslot, strategy=None, client_hashes=None) -> dict:
    """One routed batch on every rank; the lead rank (the one holding an
    oracle) checks every recipient set and, with groups, every pick against
    `pick_oracle` over the WHOLE batch in flat order (the dp ranks' offsets);
    every rank then advances the round-robin bases as the broker does."""
    t0 = time.perf_counter()
    res = router.route(topics, client_hashes=client_hashes)
    wall = time.perf_counter() - t0
    out = {"route_ms": 1e3 * wall, "readback_bytes": res.readback_bytes}
    if oracle is not None:
        out.update(check_batch(res, topics, oracle, kslot=kslot))
        if strategy is not None:
            want = pick_oracle(router.grouptab, res.matched, strategy, client_hashes)
            for got, w, what in zip(res.picks, want, ("pick_gid", "pick_idx")):
                if got.shape != w.shape or not np.array_equal(got, w):
                    bad = np.argwhere(got != w)[:3].tolist()
                    raise AssertionError(f"mesh {strategy}: {what} differs at {bad}")
            out["picks"] = int((res.picks[0] >= 0).sum())
    if strategy == "round_robin":
        advance_rr(router.grouptab, res.picks)
    return out, res


def per_batch(coll: dict, n: int) -> dict:
    return {b: {op: c / n for op, c in ops.items()} for b, ops in coll.items()}


class CollectiveClock:
    """Times every `Mesh` collective (each ending in a synchronize, so the
    waits for the other ranks are in it) while installed."""

    def __init__(self, torch):
        from emqx_tpu_torch.parallel import mesh as M

        self.M, self.torch, self.ms = M, torch, 0.0
        self.real = (M.Mesh.all_reduce, M.Mesh.all_gather)

    def wrap(self, f):
        def run(mesh, *a, **k):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            r = f(mesh, *a, **k)
            self.torch.cuda.synchronize()
            self.ms += 1e3 * (time.perf_counter() - t)
            return r
        return run

    def __enter__(self):
        self.M.Mesh.all_reduce, self.M.Mesh.all_gather = (self.wrap(f) for f in self.real)
        return self

    def __exit__(self, *exc):
        self.M.Mesh.all_reduce, self.M.Mesh.all_gather = self.real


def mesh_barrier(torch, mesh) -> None:
    """Every rank waits here (the lead rank times kernels meanwhile)."""
    mesh.all_reduce(torch.zeros(1, device=mesh.device), ("dp", "tp"), "barrier")


def mesh_mirrors(torch, pairs) -> dict:
    """Each mirror of this rank against this rank's slice of its host table,
    bit for bit; -> {mirror: its counters}. Raises on a difference."""
    from emqx_tpu_torch.convert import _as_device_type

    out = {}
    for mgr, src in pairs:
        snap = src.device_snapshot()
        if set(mgr._arrays) != set(snap):
            raise AssertionError(f"{mgr.name}: arrays {sorted(mgr._arrays)} != {sorted(snap)}")
        for k, t in mgr._arrays.items():
            want = _as_device_type(np.ascontiguousarray(mgr.placement.place(k, snap[k])), k)
            got = t.contiguous()
            got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
            got = got.cpu().numpy()
            if got.shape != want.shape or got.tobytes() != want.tobytes():
                raise AssertionError(f"mirror {mgr.name}/{k} differs from its host slice")
        out[mgr.name] = mgr.counters()
    return out


def mesh_local_inputs(torch, mesh, router, topics):
    """This rank's rows of a batch as `_route_mesh` prepares them."""
    from emqx_tpu_torch.ops.tokenizer import encode_topics
    from emqx_tpu_torch.parallel import mesh as M

    per, lo = M.batch_rows(mesh, len(topics))
    mat, lens, too_long = encode_topics(topics[lo:lo + per], MAX_BYTES)
    bm, ln = (torch.from_numpy(x).to(mesh.device) for x in router._mesh_pad(mat, lens, per))
    return per, lo, bm, ln, too_long


def mesh_tables(args):
    from emqx_tpu_torch.ops.csr_table import CSR_KEYS

    sub = {k: v for k, v in args.tables.items() if k in CSR_KEYS} or args.tables["sub_bitmaps"]
    shape = {k: v for k, v in args.tables.items() if k not in CSR_KEYS and k != "sub_bitmaps"}
    return shape, sub


def mesh_step(torch, mesh, router, args, topics):
    """The sharded step alone on this rank's rows (no assembly)."""
    from emqx_tpu_torch.parallel import mesh as M

    per, lo, bm, ln, _tl = mesh_local_inputs(torch, mesh, router, topics)
    pick = (None,) * 4
    if args.group_tables is not None:
        pick = (args.group_tables, *(
            torch.from_numpy(router._mesh_pad_rows(v, lo, per).view(np.int32)).to(mesh.device)
            for v in router._pick_inputs(topics, None)))
    shape, sub = mesh_tables(args)
    cfg = router.config
    return M.dist_shape_route_step(
        mesh, shape, args.nfa_tables, sub, bm, ln, *pick, m_active=args.m_active,
        salt=args.salt, max_levels=cfg.max_levels, frontier=cfg.frontier,
        max_matches=cfg.max_matches, probes=cfg.probes,
        share_strategy=router.share_strategy, kslot=args.kslot)


def mesh_stats(torch, mesh, router, args, topics, res, windows: int) -> dict:
    """The step's stats (reduced over the mesh) against the single-device
    step's formulas on the assembled rows: routed and matches from mcount;
    fanout_bits, the OR's set bits on a dense table or the CSR gather's
    live candidates (both the row's slot_count when no row passed a
    shard's gather window)."""
    out = mesh_step(torch, mesh, router, args, topics)
    got = {k: int(v) for k, v in out["stats"].items()}
    want = {"routed": int((res.mcount > 0).sum()), "matches": int(res.mcount.sum())}
    if not windows:
        want["fanout_bits"] = int(res.slot_count.astype(np.int64).sum())
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"mesh stats {got} != {want}")
    return got


def mesh_breakdown(torch, mesh, router, batches) -> dict:
    """Where one sharded batch's time goes on this rank, medians over the
    batches (host clock, each stage ending in a synchronize): encoding this
    rank's rows, their host->device copy, the step to completion (kernels
    and the step's collectives; the collectives' own time beside it), the
    assembly (the packed all-gather, the one device->host copy and the host
    decode), then a whole route() of the same batch. Every rank runs it."""
    from emqx_tpu_torch.ops.tokenizer import encode_topics
    from emqx_tpu_torch.parallel import mesh as M

    args = router.prepare()
    names = ("encode", "h2d", "step", "assembly", "route")
    samples = {k: [] for k in names + ("step_collectives", "assembly_collectives")}
    shape, sub = mesh_tables(args)
    cfg = router.config
    for topics in batches:
        per, lo = M.batch_rows(mesh, len(topics))
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mat, lens, too_long = encode_topics(topics[lo:lo + per], MAX_BYTES)
        pick_np = router._pick_inputs(topics, None) if args.group_tables is not None else None
        t.append(time.perf_counter())
        bm, ln = (torch.from_numpy(x).to(mesh.device) for x in router._mesh_pad(mat, lens, per))
        pick = (None,) * 4
        if pick_np is not None:
            pick = (args.group_tables, *(torch.from_numpy(
                router._mesh_pad_rows(v, lo, per).view(np.int32)).to(mesh.device)
                for v in pick_np))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with CollectiveClock(torch) as clock:
            out = M.dist_shape_route_step(
                mesh, shape, args.nfa_tables, sub, bm, ln, *pick, m_active=args.m_active,
                salt=args.salt, max_levels=cfg.max_levels, frontier=cfg.frontier,
                max_matches=cfg.max_matches, probes=cfg.probes,
                share_strategy=router.share_strategy, kslot=args.kslot)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            step_coll = clock.ms
            tl = np.zeros(per, bool)
            tl[:len(too_long)] = too_long
            out["flags"] = out["flags"] | torch.from_numpy(tl).to(mesh.device)
            router._readback_mesh(out, len(topics), per, args.kslot)
            t.append(time.perf_counter())
            asm_coll = clock.ms - step_coll
        router.route(topics)
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            samples[k].append(1e3 * (b - a))
        samples["step_collectives"].append(step_coll)
        samples["assembly_collectives"].append(asm_coll)
    med = {f"{k}_ms": float(np.median(v)) for k, v in samples.items()}
    med["topics_per_s"] = len(batches[0]) / (med["route_ms"] / 1e3)
    return med


def mesh_share_kinds(torch, mesh, router, args, topics):
    """The mesh's own kernels at share_10m_csr shapes, on the lead rank's
    rows (no collective): occurrence_index with its totals (the per-group
    counts the round-robin branch all-gathers over 'dp') over the raw
    group lanes, and the round-robin share_pick with rank offsets (the
    counts of a lower dp rank taken as this rank's own, dp rank 1), whose
    call must make 5 launches: the raw lanes, the occurrence call's 3 and
    the picks, no histogram launch of its own."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models import router_model as R

    per, lo, bm, ln, _tl = mesh_local_inputs(torch, mesh, router, topics)
    shape, sub = mesh_tables(args)
    out = R.shape_route_step({**shape, **sub}, bm, ln, m_active=args.m_active,
                             salt=args.salt, max_levels=MAX_LEVELS, kslot=args.kslot,
                             device=mesh.device)
    matched = out["matched"]
    gt = args.group_tables
    gcap = gt["group_len"].shape[0]
    gpf = gt["filter_groups"].shape[1]
    lanes = R._group_lanes(gt, matched)[0].contiguous()
    flat = lanes.reshape(-1)
    n = lanes.numel()
    live = int((lanes >= 0).sum())
    occ_tot = R.occurrence_index(flat, gcap=gcap, totals=True)
    all_c = torch.stack([occ_tot[1], occ_tot[1]])
    B, K = matched.shape
    zeros = torch.zeros(B, dtype=torch.int32, device=mesh.device)
    pick = lambda f: f(gt, matched, zeros, zeros, zeros, strategy=1,  # noqa: E731
                       dp_gather=lambda _c: all_c, dp_rank=1)
    kernels.reset_launches()
    pick(R.share_pick)
    torch.cuda.synchronize()
    per_call = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if per_call != {"share_pick": 2, "occurrence_index": 3}:
        raise AssertionError(f"a mesh round-robin share_pick call launched {per_call}")
    fids_live = int((matched >= 0).sum())
    kinds = {
        "occurrence_index/mesh_totals": dict(
            name="occurrence_index",
            kernel=lambda: R.occurrence_index(flat, gcap=gcap, totals=True),
            plain=lambda: (R.occurrence_index_plain(flat), R.group_counts_plain(lanes, gcap)),
            out=occ_tot,
            # a gid in and a rank out per lane, each group's total out once
            bytes=8 * n + 4 * gcap,
            ops=4 * n,  # a range check, a count, a prefix and an add per lane
        ),
        # the same call without the totals, for what they cost in one run
        "occurrence_index/mesh_ranks_only": dict(
            name="occurrence_index",
            kernel=lambda: R.occurrence_index(flat, gcap=gcap),
            plain=lambda: R.occurrence_index_plain(flat),
            out=occ_tot[0],
            bytes=8 * n,
            ops=4 * n,
        ),
        "share_pick/mesh": dict(
            name="share_pick",
            per_call={"share_pick_kernel": 2},
            kernel=lambda: pick(R.share_pick),
            plain=lambda: pick(R.share_pick_plain),
            out=pick(R.share_pick),
            # as share_pick/round_robin, plus the lower rank's count of
            # each live lane's group
            bytes=4 * B * K + 12 * B + 4 * gpf * fids_live + 16 * live + 8 * n,
            ops=12 * n + live,
        ),
    }
    return kinds, {"rows": B, "group_lanes": n, "live_group_lanes": live, "gcap": gcap,
                   "round_robin_launches_per_call": per_call}


def mesh_composite_bound(torch, mesh, router, args, topics, names, extra=0.0) -> float:
    """The sharded step's bound on this rank for one batch: the sum of its
    kernels' bounds at this rank's shapes (its rows, its shard), as row 7's
    composite bound sums its kernels'."""
    from emqx_tpu_torch.parallel import mesh as M

    per, lo = M.batch_rows(mesh, len(topics))
    rows = topics[lo:lo + per]
    kinds = (share_kinds(torch, router, args, rows) if args.group_tables is not None
             else serving_kinds(torch, args, rows))[0]
    return extra + sum(bound(kinds[k]["bytes"], kinds[k]["ops"])[0] for k in names)


def rank_mesh_share(mesh, st) -> dict:
    """mesh_share_2x2 on one rank: share_10m_csr over the 2 x 2 mesh, the
    CSR table in two slot-owner shards over 'tp', B = 8192 over 'dp'."""
    import torch

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import STRATEGY_IDS, MeshServingRouter
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.parallel import mesh as M

    lead = mesh.rank == 0
    index, subtab, grouptab = st["index"], st["subtab"], st["grouptab"]
    rng = np.random.default_rng(SEED + 40)  # the same draws on every rank
    router = MeshServingRouter(index, subtab,
                               MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES),
                               grouptab=grouptab, mesh=mesh)
    t0 = time.perf_counter()
    args = router.prepare()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if subtab.shards != mesh.tp or args.kslot != KSLOT or args.tables["csr_slots"].shape[0] != 1:
        raise AssertionError(f"shards {subtab.shards}, kslot {args.kslot}")
    dev_bytes = {**mirror_bytes(args.tables), **mirror_bytes(args.group_tables)}
    oracle = MeshOracle(index, subtab) if lead else None
    batches = [topic_batch_share(rng, BATCH) for _ in range(ROUTE_BATCHES)]
    batches[0][: len(EDGE_TOPICS_SHARE)] = EDGE_TOPICS_SHARE

    # the main path: counters zeroed here, read after the churn
    kernels.reset_launches()
    M.reset_collectives()
    routed, results = [], []
    for topics in batches:
        rec, res = mesh_route(router, topics, oracle, args.kslot, "round_robin")
        routed.append(rec)
        results.append(res)
    coll_rr = per_batch(M.COLLECTIVES, len(batches))
    router.share_strategy = STRATEGY_IDS["hash_clientid"]
    client_hashes = rng.integers(0, 1 << 32, BATCH, dtype=np.uint64).astype(np.uint32)
    rec, _res = mesh_route(router, batches[0], oracle, args.kslot, "hash_clientid",
                           client_hashes)
    routed.append(rec)
    router.share_strategy = STRATEGY_IDS["round_robin"]
    windows = routed[-2].get("gather_window_rows", 0) if lead else 0
    windows = int(mesh.all_reduce(torch.tensor([windows], device=mesh.device),
                                  ("dp", "tp"), "check")[0])
    stats = mesh_stats(torch, mesh, router, router.prepare(), batches[-1], results[-1], windows)
    if lead:
        phase("mesh_route_share", batches=routed, stats=stats,
              collectives_per_batch=coll_rr, upload_seconds=upload_s, device_bytes=dev_bytes)

    # churn: each wave's writes belong to one tp shard; they must reach that
    # shard's ranks as one scatter and nothing else, and every mirror must
    # equal its host slice after it
    def fid_of(i, j=None):
        return index.filter_id(f"device/{i}/#" if j is None else f"device/{i}/+/{j}/#")

    tp_rank = mesh.axis_index("tp")
    churn = {}

    def wave(what, mutate, topics_extra, owner):
        router.prepare()  # the last batch's round-robin bases
        c0 = router.segment_status()
        mutate()
        t0 = time.perf_counter()
        router.prepare()
        torch.cuda.synchronize()
        sync_ms = 1e3 * (time.perf_counter() - t0)
        c1 = router.segment_status()
        moved_ = {m: {k: c1[m][k] - c0[m][k] for k in c1[m]} for m in c1}
        mine = tp_rank == owner
        want = {"full_resyncs": 0, "delta_launches": int(mine), "array_resyncs": 0,
                "delta_skipped": int(not mine)}
        if moved_["bitmaps"] != want:
            raise AssertionError(f"{what}: bitmaps mirror moved {moved_['bitmaps']}, want {want}")
        mirrors = mesh_mirrors(torch, [(router._shape_sync, index.shapes),
                                       (router._bits_sync, subtab),
                                       (router._group_sync, grouptab)])
        topics = topic_batch_share(rng, BATCH)
        topics[: len(topics_extra)] = topics_extra
        rec, _res = mesh_route(router, topics, oracle, args.kslot, "round_robin")
        return {"prepare_ms": sync_ms, "moved": moved_, "mirrors": mirrors, "routed": rec,
                "hot_fill": subtab.csr.hot_fill, "packed_tombstones": subtab.csr.packed_tombs}

    hot_i = 7
    # 100 even slots on a group filter (its rows pass kslot on shard 0) and
    # 120 even slots on bench filters: every write is shard 0's
    hot_adds = [(fid_of(hot_i), 500_000 + 2 * s) for s in range(100)]
    ij = rng.integers(0, [50, SHARE_NUMS], size=(120, 2))
    hot_adds += [(fid_of(int(i), int(j)), 2 * int(s)) for (i, j), s in
                 zip(ij, rng.integers(0, SHARE_SLOTS // 2, 120))]
    row_topics = [f"device/{hot_i}/mid/{j}/leaf" for j in range(64)]
    row_topics += [f"device/{i}/mid/{j}/leaf" for i, j in ij]
    churn["subscribe"] = wave("subscribe wave", lambda: [subtab.add(f, s) for f, s in hot_adds],
                              row_topics, owner=0)
    # 1,000 packed subscriptions with odd slots (subscription n has slot n
    # mod 2^20): every write is shard 1's
    n_subs = SHARE_IDS * SHARE_NUMS * SHARE_SPF
    gone = 2 * rng.choice(n_subs // 2, size=1000, replace=False) + 1
    gone_pairs = [(int(n // SHARE_SPF), int(n % SHARE_SLOTS)) for n in gone]
    gone_topics = []
    for f, _s in gone_pairs[:300]:
        i, _plus, j = index.filter_name(f).split("/")[1:4]
        gone_topics.append(f"device/{i}/mid/{j}/leaf")
    churn["unsubscribe"] = wave("unsubscribe wave",
                                lambda: [subtab.remove(f, s) for f, s in gone_pairs],
                                gone_topics, owner=1)
    launches = dict(kernels.LAUNCHES)
    coll = {k: dict(v) for k, v in M.COLLECTIVES.items()}
    path = ("tokenize", "shape_match", "sparse_fanout_slots", "share_pick",
            "occurrence_index")
    # a round-robin step makes 2 share_pick and 3 occurrence_index launches
    # (its group counts are the occurrence call's totals, with no launch of
    # their own), the one hash_clientid batch 1 share_pick launch
    rr_steps, occ_rest = divmod(launches["occurrence_index"], 3)
    if not all(launches[k] for k in path) or launches["fanout_bitmaps"] \
            or launches["compact_fanout_slots"] or occ_rest \
            or launches["share_pick"] != 2 * rr_steps + 1:
        raise AssertionError(f"rank {mesh.rank}: mesh_share_2x2 launches {launches}")
    if lead:
        phase("mesh_churn_share", **{k: {kk: vv for kk, vv in v.items() if kk != "mirrors"}
                                     for k, v in churn.items()})

    # the mesh kernels at this path's shapes, timed on the lead rank alone
    report = kinds_info = comp = None
    if lead:
        args = router.prepare()
        kinds, kinds_info = mesh_share_kinds(torch, mesh, router, args, batches[0])
        report = kernel_report(torch, kinds)
        # the occurrence call's totals: 4 gcap bytes more than its
        # single-device case
        tot_bound = bound(4 * kinds_info["gcap"], 0)[0]
        comp = mesh_composite_bound(
            torch, mesh, router, args, batches[0],
            ("tokenize", "shape_match", "sparse_fanout_slots", "occurrence_index",
             "share_pick/round_robin"), tot_bound)
        phase("kernel_inputs_mesh_share", **kinds_info)
    mesh_barrier(torch, mesh)
    brk = mesh_breakdown(torch, mesh, router,
                         [topic_batch_share(rng, BATCH) for _ in range(3)])
    if lead:
        phase("mesh_route_breakdown_share", **brk, composite_bound_ms=comp)
    return {"rank": mesh.rank, "launches": launches, "collectives": coll,
            "collectives_per_batch": coll_rr, "mirrors": {k: v["mirrors"] for k, v in
                                                          churn.items()},
            "moved": {k: v["moved"]["bitmaps"] for k, v in churn.items()},
            "report": report, "breakdown": brk, "device_bytes": dev_bytes}


def mesh_twin(torch, mesh, router, args, topics) -> dict:
    """The raw outputs of this rank's sharded step against the per-shard
    twin composition: the same step on CPU copies of this rank's tables,
    so every kernel runs as its plain twin and the collectives run on the
    CPU tensors (gloo carries both). Every output must be equal."""
    import copy

    from emqx_tpu_torch.models.router_model import Prepared

    got = mesh_step(torch, mesh, router, args, topics)
    cpu = lambda d: None if d is None else {k: v.cpu() for k, v in d.items()}  # noqa: E731
    cmesh = copy.copy(mesh)
    cmesh.device = torch.device("cpu")
    cargs = Prepared(cpu(args.tables), cpu(args.nfa_tables), args.salt, args.m_active,
                     args.kslot, cpu(args.group_tables))

    class Host:  # the router's host side, on the CPU
        config, share_strategy = router.config, router.share_strategy
        _mesh_pad, _mesh_pad_rows = router._mesh_pad, router._mesh_pad_rows
        _pick_inputs = router._pick_inputs

    want = mesh_step(torch, cmesh, Host, cargs, topics)
    keys = ("matched", "mcount", "flags", "bitmaps", "slots", "slot_count", "overflow")
    for k in keys:
        a, b = got.get(k), want.get(k)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            raise AssertionError(f"rank {mesh.rank}: {k} differs from the twin composition")
    if {k: int(v) for k, v in got["stats"].items()} != \
            {k: int(v) for k, v in want["stats"].items()}:
        raise AssertionError(f"rank {mesh.rank}: stats differ from the twin composition")
    return {"rows": int(got["matched"].shape[0]), "compared": list(keys) + ["stats"]}


def mesh_sem_check(torch, mesh, srouter, sargs, res, topics, q, msgs, filt, oracle,
                   path) -> dict:
    """One routed batch with embeddings and rules on the semantic mesh. On
    every rank: this rank's block (its dp rows x its tp shard's segment of
    kslot + topk slots) against the twin run on its shard's entries and
    unioned into its shard's topic slots, as `_sem_rules_local` does; a
    row that differs must hold the kernel's own winners and pass the f64
    band check on this shard; the qualifying counts, summed over 'tp',
    must equal the assembled sem_count (the single-device count). On the
    lead rank: the topic recipients (every shard's topic segment) against
    the host oracle, the rule masks against the twin and the numpy masks.
    Called just after the route: the launch counts are added to `path`
    first (`take_launches`), and the check's own launches dropped."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import RouteResult
    from emqx_tpu_torch.ops import semantic_table as ST
    from emqx_tpu_torch.parallel import mesh as M
    from emqx_tpu_torch.rules import compile as RC

    take_launches(path)
    per, lo = M.batch_rows(mesh, len(topics))
    tp = mesh.axis_index("tp")
    kslot, topk = sargs.kslot, sargs.sem_topk
    seg = kslot + topk
    if res.slots.shape != (len(topics), seg * mesh.tp):
        raise AssertionError(f"semantic mesh slots {res.slots.shape}")
    block = np.ascontiguousarray(res.slots[lo:lo + per, tp * seg:(tp + 1) * seg])
    topic = np.ascontiguousarray(block[:, :kslot])
    dev = mesh.device
    qd = torch.from_numpy(np.ascontiguousarray(q[lo:lo + per])).to(dev)
    md = torch.from_numpy(np.ascontiguousarray(res.matched[lo:lo + per])).to(dev)
    ws, wc, census = sem_twin(torch, sargs.sem_tables, qd, md, topk)
    want = ST.union_semantic_slots_plain(torch.from_numpy(topic), ws.cpu()).numpy()
    diff = np.nonzero((block != want).any(axis=1))[0]
    if len(diff):
        sel = torch.from_numpy(diff).to(dev)
        ks, kc = ST.semantic_match_step(sargs.sem_tables, qd[sel].contiguous(),
                                        md[sel].contiguous(), topk)
        kernels.reset_launches()
        u = ST.union_semantic_slots_plain(torch.from_numpy(topic[diff]), ks.cpu()).numpy()
        if not np.array_equal(u, block[diff]):
            raise AssertionError("semantic mesh rows differ from the kernel's own winners")
        full_ks = np.full((per, topk), -1, np.int32)
        full_kc = np.zeros(per, np.int32)
        full_ks[diff], full_kc[diff] = ks.cpu().numpy(), kc.cpu().numpy()
        SemHost(srouter.semtab, shard=tp).check(
            q[lo:lo + per], res.matched[lo:lo + per], diff,
            [(full_ks, full_kc), (ws.cpu().numpy(), wc.cpu().numpy())], topk)
    counts = mesh.all_reduce(wc.to(torch.int32).contiguous(), "tp", "check").cpu().numpy()
    off = np.nonzero(counts != res.sem_count[lo:lo + per])[0]
    if len(off):
        SemHost(srouter.semtab, shard=tp).check(
            q[lo:lo + per], res.matched[lo:lo + per], off, [(ws.cpu().numpy(), wc.cpu().numpy())],
            topk)
    out = {"rows_differing_from_twin": int(len(diff)), "count_rows_off": int(len(off)),
           "band": census}
    if oracle is not None:
        topic_all = np.concatenate([res.slots[:, t * seg:t * seg + kslot]
                                    for t in range(mesh.tp)], axis=1)
        out.update(check_batch(RouteResult(**{**res._asdict(), "slots": topic_all}),
                               topics, oracle, kslot=kslot))
        progs, feats, valid = filt.progs, *filt.features(msgs)
        plain = RC.eval_rule_masks_plain(progs, torch.from_numpy(feats),
                                         torch.from_numpy(valid)).numpy()
        if not (np.array_equal(res.rule_masks, plain)
                and np.array_equal(plain, filt.host_masks(msgs))):
            raise AssertionError("mesh rule masks differ from the twin or the host masks")
        out["semantic_recipients"] = int(sum((res.slots[:, t * seg + kslot:(t + 1) * seg] >= 0)
                                             .sum() for t in range(mesh.tp)))
        out["sem_count_mean"] = float(res.sem_count.mean())
    return out


def mesh_compact_kind(torch, mesh, router, args, topics):
    """compact_fanout_slots with a lane base at mixed_1m's mesh shapes
    (this rank's rows, its 4 of 8 lane words, at the base tp rank 1
    writes), against the twin."""
    from emqx_tpu_torch.models import router_model as R

    per, lo, bm, ln, _tl = mesh_local_inputs(torch, mesh, router, topics)
    shape, sub = mesh_tables(args)
    out = R.shape_route_step({**shape, "sub_bitmaps": sub}, bm, ln, m_active=args.m_active,
                             salt=args.salt, max_levels=MAX_LEVELS, device=mesh.device)
    bits = out["bitmaps"]
    B, W = bits.shape
    base = W * 32  # the lane base of tp rank 1, on this rank's bits
    kslot = args.kslot
    return {"compact_fanout_slots/mesh": dict(
        name="compact_fanout_slots",
        kernel=lambda: R.compact_fanout_slots_shard(bits, kslot, base),
        plain=lambda: R.compact_fanout_slots_shard_plain(bits, kslot, base),
        out=R.compact_fanout_slots_shard(bits, kslot, base),
        notes=dict(lanes_over_8=lanes_over_8(torch, bits, kslot)),
        bytes=4 * B * W + 4 * B * kslot + 8 * B,  # words in; slots and the pair out
        ops=B * W * 32,
    )}, {"rows": B, "words": W, "lane_base": base, "kslot": kslot}


def mesh_stage_bounds(torch, mesh, sargs, filt, msgs, job, m_active, kslot) -> dict:
    """On this rank, the bounds a batch of the semantic and the fused mesh
    steps adds to the dense step's kernels: the semantic stage over its
    'tp' shard's live entries for its 'dp' rows (`sem_kernel_report`'s
    count, f32) with the rule masks (`rule_kind`'s), and the storm's
    kernels on its 'dp' block of every chunk (`retained_kinds`'s:
    row_lengths, tokenize, shape_match, narrow_i16)."""
    from emqx_tpu_torch.models import retained_index as RI
    from emqx_tpu_torch.parallel import mesh as M

    per, _lo = M.batch_rows(mesh, BATCH)
    st_ = sargs.sem_tables
    e_live = int((st_["sem_slot"] >= 0).sum()) + int((st_["sem_hot_slot"] >= 0).sum())
    D, topk = st_["sem_vec"].shape[2], sargs.sem_topk
    sem = bound(4 * per * D + 4 * e_live * D + 12 * e_live + 4 * per * m_active
                + 4 * per * kslot + 4 * per * (kslot + topk) + 4 * per,
                2 * per * e_live * D)[0]
    F = filt.features(msgs)[0].shape[1]
    n_ops = sum(len(p) for p in filt.progs)
    rules = bound(5 * per * F + len(filt.progs) * per, per * n_ops * 4)[0]
    kw = job.kwargs
    storm = 0.0
    for chunk in job.chunks:
        N, MB = chunk.shape
        ln = RI.row_lengths(chunk)
        kinds = match_kinds(torch, job.shape_tables, kw["m_active"], chunk, ln, kw["salt"],
                            kw["max_levels"])[0]
        n = N * kw["m_active"]
        storm += (bound(N * MB + 4 * N, N * MB)[0] + bound(6 * n, n)[0]
                  + sum(bound(kinds[k]["bytes"], kinds[k]["ops"])[0]
                        for k in ("tokenize", "shape_match")))
    return {"semantic_entries": e_live, "semantic_ms": sem, "rule_masks_ms": rules,
            "storm_chunks": len(job.chunks), "storm_rows_per_chunk": int(job.chunks[0].shape[0]),
            "storm_ms": storm}


def rank_mesh_1m(mesh, st) -> dict:
    """mesh_1m_2x2 on one rank: mixed_1m dense (256 slots, 4 of the 8 lane
    words a tp rank), the retained_5m storm fused into one batch (chunk
    rows over 'dp'), semantic_256k f32 (2^17 entries a tp rank) with the
    rule set, and churn; raw outputs against the per-shard twins."""
    import torch

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import MeshServingRouter
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.parallel import mesh as M
    from emqx_tpu_torch.rules import compile as RC
    from emqx_tpu_torch.rules import sql as RS

    lead = mesh.rank == 0
    index, subtab, ridx, sem, cents = (st[k] for k in ("index", "subtab", "ridx", "sem",
                                                       "cents"))
    cfg = MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES)
    rng = np.random.default_rng(SEED + 50)
    router = MeshServingRouter(index, subtab, cfg, mesh=mesh)
    args = router.prepare()
    if args.kslot != KSLOT or args.tables["sub_bitmaps"].shape[1] != subtab.width_words // mesh.tp:
        raise AssertionError(f"kslot {args.kslot}, lanes {tuple(args.tables['sub_bitmaps'].shape)}")
    oracle = Oracle(index, subtab) if lead else None
    batches = []
    for _ in range(ROUTE_BATCHES):
        topics = topic_batch_1m(rng, BATCH)
        topics[: len(EDGE_TOPICS)] = EDGE_TOPICS
        batches.append(topics)
    out = {"rank": mesh.rank}

    kernels.reset_launches()
    path = {}  # the launches, added up around the semantic checks
    M.reset_collectives()
    routed = [mesh_route(router, t, oracle, args.kslot)[0] for t in batches]
    out["collectives_per_batch"] = per_batch(M.COLLECTIVES, len(batches))
    twin = mesh_twin(torch, mesh, router, args, batches[0]) if mesh.backend == "gloo" else None
    if lead:
        phase("mesh_route_1m", batches=routed, twin=twin,
              collectives_per_batch=out["collectives_per_batch"],
              device_bytes=mirror_bytes(args.tables))

    # the retained_5m store and its 8,192-filter storm fused into one batch
    t0 = time.perf_counter()
    ridx.place(mesh)
    storm = [f"site/+/dev/{d}/ch/#" for d in range(RET_STORM)]
    job = ridx.prepare_storm(storm)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    topics = topic_batch_1m(rng, BATCH)
    M.reset_collectives()
    t0 = time.perf_counter()
    fused = router.route_prepared(router.prepare(), topics, retained=job)
    fused_ms = 1e3 * (time.perf_counter() - t0)
    fused_coll = {k: dict(v) for k, v in M.COLLECTIVES.items()}
    plain = router.route(topics)
    for k in ("matched", "mcount", "flags", "slots", "slot_count", "overflow"):
        if not np.array_equal(getattr(fused, k), getattr(plain, k)):
            raise AssertionError(f"fused mesh route half: {k} differs from the unfused route")
    alone = ridx.match_many(storm)
    pairs = 0
    if lead:
        if not storms_equal(fused.retained, alone):
            raise AssertionError("the fused mesh storm differs from match_many's")
        for d, f in enumerate(storm):
            if not np.array_equal(fused.retained[f], np.arange(d, RET_N, RET_DEVIDS)):
                raise AssertionError(f"{f}: mesh storm rows differ from the oracle's")
        pairs = sum(len(v) for v in fused.retained.values())
        phase("mesh_fused_retained", chunks=len(job.chunks), chunk_rows_per_rank=int(
            job.chunks[0].shape[0]), chunk_bytes_per_rank=sum(
                c.numel() * c.element_size() for c in job.chunks), pairs=pairs, prepare_seconds=prep_s,
            fused_ms=fused_ms, readback_bytes=fused.readback_bytes, collectives=fused_coll,
            chunk_mirror=ridx._seg.counters())

    # semantic_256k (f32, slot-owner shards over 'tp') with the rule set
    filt = rule_filter(RULES_SQL, RS, RC)
    srouter = MeshServingRouter(index, subtab, cfg, semtab=sem, mesh=mesh)
    t0 = time.perf_counter()
    sargs = srouter.prepare()
    torch.cuda.synchronize()
    sem_upload_s = time.perf_counter() - t0
    if sargs.sem_tables["sem_vec"].shape[0] != 1 or sem.shards != mesh.tp:
        raise AssertionError("the semantic mirror is not this rank's shard")
    M.reset_collectives()
    semantic = []
    for _ in range(SEM_ROUTE_BATCHES):
        topics, q, msgs = sem_batch(rng, cents, BATCH, edge=True)
        t0 = time.perf_counter()
        res = srouter.route(topics, embeds=q, rules=(filt.progs, *filt.features(msgs)))
        wall = 1e3 * (time.perf_counter() - t0)
        semantic.append({"route_ms": wall, **mesh_sem_check(
            torch, mesh, srouter, sargs, res, topics, q, msgs, filt, oracle, path)})
    out["sem_collectives"] = {k: dict(v) for k, v in M.COLLECTIVES.items()}
    if lead:
        phase("mesh_route_semantic", batches=semantic, upload_seconds=sem_upload_s,
              sem_bytes=mirror_bytes(sargs.sem_tables), collectives=out["sem_collectives"])

    # churn: 100 subscribers on device/7/# (its rows pass kslot on tp shard
    # 0: the dense rows come back through the second gather), then their
    # removal; semantic churn step A; mirrors against host slices after each
    mirrors = {}
    fid = index.add("device/7/#")
    churn_slots = [s for s in range(100) if s not in slot_set(subtab.arr[fid])]
    churn_topics = topic_batch_1m(rng, BATCH)
    churn_topics[:64] = [f"device/7/mid/{j}/leaf" for j in range(64)]
    for s in churn_slots:
        subtab.add(fid, s)
    rec_sub, _ = mesh_route(router, churn_topics, oracle, args.kslot)
    mirrors["subscribe"] = mesh_mirrors(torch, [(router._shape_sync, index.shapes),
                                                (router._bits_sync, subtab)])
    if lead and not rec_sub["overflow_rows"]:
        raise AssertionError("mesh churn produced no overflow rows")
    for s in churn_slots:
        subtab.remove(fid, s)
    index.remove("device/7/#")
    rec_unsub, _ = mesh_route(router, churn_topics, oracle, args.kslot)
    mirrors["unsubscribe"] = mesh_mirrors(torch, [(router._shape_sync, index.shapes),
                                                  (router._bits_sync, subtab)])
    c0 = srouter.segment_status()["semantic"]
    sem_churn(rng, sem, cents, index, SEM_CHURN[0], 50, SEM_CHURN[0], 1 << 20)
    t0 = time.perf_counter()
    srouter.prepare()
    torch.cuda.synchronize()
    sem_sync_ms = 1e3 * (time.perf_counter() - t0)
    c1 = srouter.segment_status()["semantic"]
    mirrors["semantic"] = mesh_mirrors(torch, [(srouter._sem_sync, sem)])
    sem_moved = {k: c1[k] - c0[k] for k in c1}
    topics, q, msgs = sem_batch(rng, cents, BATCH)
    res = srouter.route(topics, embeds=q, rules=(filt.progs, *filt.features(msgs)))
    sem_after = mesh_sem_check(torch, mesh, srouter, srouter.prepare(), res, topics, q, msgs,
                               filt, oracle, path)
    out["launches"] = take_launches(path)
    path = ("tokenize", "shape_match", "fanout_bitmaps", "compact_fanout_slots",
            "row_lengths", "narrow_i16", "semantic_match", "rule_masks", "segment_scatter")
    if not all(out["launches"][k] for k in path) or out["launches"]["sparse_fanout_slots"]:
        raise AssertionError(f"rank {mesh.rank}: mesh_1m_2x2 launches {out['launches']}")
    out["mirrors"], out["sem_moved"] = mirrors, sem_moved
    if lead:
        phase("mesh_churn_1m", subscribe=rec_sub, unsubscribe=rec_unsub,
              semantic={"mirror_moved": sem_moved, "sync_ms": sem_sync_ms,
                        "route": sem_after})

    # compact_fanout_slots with its lane base, timed on the lead rank alone
    out["report"] = comp = None
    if lead:
        args = router.prepare()
        kinds, info = mesh_compact_kind(torch, mesh, router, args, batches[0])
        out["report"] = kernel_report(torch, kinds)
        comp = mesh_composite_bound(torch, mesh, router, args, batches[0],
                                    ("tokenize", "shape_match", "fanout_bitmaps",
                                     "compact_fanout_slots"))
        phase("kernel_inputs_mesh_1m", **info)
        # rows 15c and 15d of PERF.md: the dense step's bound plus the stages
        extra = mesh_stage_bounds(torch, mesh, srouter.prepare(), filt, msgs, job,
                                  args.m_active, args.kslot)
        phase("composite_bounds_mesh_1m", dist_shape_step_ms=comp,
              sem_dist_shape_step_ms=comp + extra["semantic_ms"] + extra["rule_masks_ms"],
              dist_fused_step_ms=comp + extra["storm_ms"], **extra)
    mesh_barrier(torch, mesh)
    out["breakdown"] = mesh_breakdown(torch, mesh, router,
                                      [topic_batch_1m(rng, BATCH) for _ in range(3)])
    if lead:
        phase("mesh_route_breakdown_1m", **out["breakdown"], composite_bound_ms=comp)
    return out


def rank_mesh_nccl1(mesh, st) -> dict:
    """mesh_1m_nccl1: a world of one NCCL rank; its MeshServingRouter must
    equal DeviceRouter.route on the same batches, bit for bit."""
    import torch

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import DeviceRouter, MeshServingRouter
    from emqx_tpu_torch.ops.matcher import MatcherConfig
    from emqx_tpu_torch.parallel import mesh as M

    index, subtab = st["index"], st["subtab"]
    cfg = MatcherConfig(max_levels=MAX_LEVELS, max_bytes=MAX_BYTES)
    router = MeshServingRouter(index, subtab, cfg, mesh=mesh)
    single = DeviceRouter(index, subtab, cfg, device=mesh.device)
    rng = np.random.default_rng(SEED + 60)
    batches = [topic_batch_1m(rng, BATCH) for _ in range(ROUTE_BATCHES)]
    batches[0][: len(EDGE_TOPICS)] = EDGE_TOPICS
    fid = index.add("device/7/#")
    churn_topics = topic_batch_1m(rng, BATCH)
    churn_topics[:64] = [f"device/7/mid/{j}/leaf" for j in range(64)]

    def compare(topics):
        a, b = router.route(topics), single.route(topics)
        for k in ("matched", "mcount", "flags", "bitmaps", "slots", "slot_count", "overflow"):
            x, y = getattr(a, k), getattr(b, k)
            if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
                raise AssertionError(f"nccl1: {k} differs from DeviceRouter.route")
        if a.dense_index != b.dense_index or any(
                not np.array_equal(a.dense_rows[j], b.dense_rows[j])
                for j in range(len(a.dense_index or ()))):
            raise AssertionError("nccl1: dense rows differ from DeviceRouter.route")
        return int(a.overflow.sum())

    kernels.reset_launches()
    M.reset_collectives()
    ovf = [compare(t) for t in batches]
    coll = per_batch(M.COLLECTIVES, len(batches))
    churn_slots = [s for s in range(100) if s not in slot_set(subtab.arr[fid])]
    for s in churn_slots:
        subtab.add(fid, s)
    ovf.append(compare(churn_topics))
    launches = dict(kernels.LAUNCHES)
    if not ovf[-1] or not all(launches[k] for k in ("tokenize", "shape_match", "fanout_bitmaps",
                                                       "compact_fanout_slots")):
        raise AssertionError(f"nccl1: overflow {ovf}, launches {launches}")
    brk = mesh_breakdown(torch, mesh, router, [topic_batch_1m(rng, BATCH) for _ in range(3)])
    phase("mesh_1m_nccl1", backend=mesh.backend, world=mesh.world, batches=len(ovf),
          overflow_rows=ovf, collectives_per_batch=coll, launches=launches,
          breakdown=brk, equal_to_device_router=True)
    return {"launches": launches, "collectives_per_batch": coll, "breakdown": brk}


def mesh_plus_breakdown(torch, mesh, tables, sub, batches, salt, cfg) -> dict:
    """Where one NFA-only mesh batch's time goes on this rank, medians over
    the batches (host clock, each stage ending in a synchronize): encoding
    this rank's rows, their host->device copy, `dist_route_step` to
    completion (its all-reduces' own time beside it), the one copy of the
    rank's blocks back, and the four together."""
    from emqx_tpu_torch.ops.tokenizer import encode_topics
    from emqx_tpu_torch.parallel import mesh as M

    names = ("encode", "h2d", "step", "readback")
    samples = {k: [] for k in names + ("collectives", "route")}
    for topics in batches:
        per, lo = M.batch_rows(mesh, len(topics))
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mat, lens, _ = encode_topics(topics[lo:lo + per], MAX_BYTES)
        t.append(time.perf_counter())
        bm, ln = torch.from_numpy(mat).to(mesh.device), torch.from_numpy(lens).to(mesh.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with CollectiveClock(torch) as clock:
            out = M.dist_route_step(mesh, tables, sub, bm, ln, salt=salt, **cfg)
            torch.cuda.synchronize()
        t.append(time.perf_counter())
        plus_readback(torch, out)
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            samples[k].append(1e3 * (b - a))
        samples["collectives"].append(clock.ms)
        samples["route"].append(1e3 * (t[-1] - t[0]))
    med = {f"{k}_ms": float(np.median(v)) for k, v in samples.items()}
    med["topics_per_s"] = len(batches[0]) / (med["route_ms"] / 1e3)
    return med


def rank_mesh_plus(mesh, st) -> dict:
    """mesh_plus_2x2 on one rank: the NFA-only step (`dist_route_step`) on
    plus_100k's dense table, 2,048 of its 4,096 lane words a tp rank, B =
    8192 over 'dp': this rank's blocks of matched / mcount / flags /
    bitmaps against the host oracle's slice, the reduced stats against the
    single-device `route_step`'s (lead rank), two all-reduces a batch."""
    import torch

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.models.router_model import route_step
    from emqx_tpu_torch.ops.segments import DeviceSegmentManager
    from emqx_tpu_torch.ops.tokenizer import encode_topics
    from emqx_tpu_torch.parallel import mesh as M

    lead = mesh.rank == 0
    builder, dense = st["builder"], st["dense"]
    oracle = PlusOracle(st)
    cfg = dict(max_levels=MAX_LEVELS, frontier=32, max_matches=64, probes=8)
    nfa = DeviceSegmentManager(mesh.device, name="nfa", placement=M.table_placement(mesh))
    lanes = DeviceSegmentManager(mesh.device, name="bitmaps",
                                 placement=M.bitmap_placement(mesh))
    t0 = time.perf_counter()
    tables = nfa.sync(builder)
    sub = lanes.sync(dense)["sub_bitmaps"]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    w_l = dense.width_words // mesh.tp
    tpi = mesh.axis_index("tp")
    if tuple(sub.shape) != (dense.arr.shape[0], w_l):
        raise AssertionError(f"lane block {tuple(sub.shape)}")
    rng = np.random.default_rng(SEED + 70)
    batches = [plus_topics(rng, BATCH) for _ in range(ROUTE_BATCHES)]
    want = []
    if lead:  # the single-device step on the whole table, for the stats:
        # run before the launch window, so the counts are the mesh step's own
        full = DeviceSegmentManager(mesh.device, name="full").sync(dense)["sub_bitmaps"]
        for topics in batches:
            mat, lens, _ = encode_topics(topics, MAX_BYTES)
            one = route_step(tables, full, torch.from_numpy(mat).to(mesh.device),
                             torch.from_numpy(lens).to(mesh.device), salt=builder.salt,
                             device=mesh.device, **cfg)
            want.append({k: int(v) for k, v in one["stats"].items()})
        del full, one
        torch.cuda.empty_cache()
    out = {"rank": mesh.rank, "stats": []}
    kernels.reset_launches()
    M.reset_collectives()
    checked = []
    for i, topics in enumerate(batches):
        mat, lens, _ = encode_topics(topics, MAX_BYTES)
        bm, ln = M.place_batch(mesh, mat, lens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = M.dist_route_step(mesh, tables, sub, bm, ln, salt=builder.salt, **cfg)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        host = plus_readback(torch, step)
        per, lo = M.batch_rows(mesh, len(topics))
        rec = check_plus({k: host[k] for k in ("matched", "mcount", "flags", "bitmaps")},
                         topics[lo:lo + per], oracle, 0,
                         lanes=slice(tpi * w_l, (tpi + 1) * w_l))
        out["stats"].append(host["stats"])
        if lead and host["stats"] != want[i]:
            raise AssertionError(f"mesh stats {host['stats']} != single device {want[i]}")
        checked.append({"step_ms": step_ms, "block_rows": per,
                        "block_bytes": int(host["bitmaps"].nbytes), **rec})
    out["launches"] = dict(kernels.LAUNCHES)
    out["collectives_per_batch"] = per_batch(M.COLLECTIVES, len(batches))
    if out["collectives_per_batch"] != {"dist_step": {"all_reduce": 2.0, "all_gather": 0.0}}:
        raise AssertionError(f"dist_step collectives {out['collectives_per_batch']}")
    want_l = {"tokenize": 3, "vocab_lookup": 3, "nfa_walk": 3, "fanout_bitmaps": 3,
              "compact_fanout_slots": 0, "shape_match": 0}
    if any(out["launches"][k] != v for k, v in want_l.items()):
        raise AssertionError(f"rank {mesh.rank}: mesh_plus launches {out['launches']}")
    out["mirrors"] = {"upload": {"nfa": nfa.counters(), "bitmaps": lanes.counters()}}
    if lead:
        phase("mesh_route_plus", batches=checked, upload_seconds=upload_s,
              lane_words_per_rank=w_l, collectives=dict(M.COLLECTIVES),
              collectives_per_batch=out["collectives_per_batch"],
              device_bytes={"nfa": sum(mirror_bytes(tables).values()),
                            "lanes": sub.numel() * 4})
        per, lo = M.batch_rows(mesh, BATCH)
        kinds, _ = plus_kinds(torch, tables, sub, batches[0][lo:lo + per], builder.salt, cfg,
                              KSLOT)
        out["bound_ms"] = sum(bound(kinds[k]["bytes"], kinds[k]["ops"])[0] for k in (
            "tokenize", "vocab_lookup", "nfa_walk", "fanout_bitmaps"))
    mesh_barrier(torch, mesh)
    out["breakdown"] = mesh_plus_breakdown(torch, mesh, tables, sub,
                                           [plus_topics(rng, BATCH) for _ in range(3)],
                                           builder.salt, cfg)
    if lead:
        phase("mesh_route_breakdown_plus", **out["breakdown"], composite_bound_ms=out["bound_ms"])
    return out


# -- the mesh broker: broker_1m's broker and session_1m's store on 2 x 2 ---------

MESH_SESS_WAVE = 16384  # mesh_session_2x2: rows moved to the rel phase in one wave


def mesh_broker_tables() -> tuple:
    """broker_1m's broker (`broker_build`: 1,000,100 plain subscriptions, 100
    round-robin groups of 16, the CSR flip, the empty semantic plane and
    the device-attached rule engine) and session_1m's store (1,000,000 QoS1
    sessions bulk-loaded into 2^22 rows, as `session_path` loads them; its
    host lanes only, `device="cpu"`, never synced), built in the mesh
    process before any rank exists. -> (the ranks' state, its record)."""
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.broker.session_store import SessionStore
    from emqx_tpu_torch.ops.csr_table import CSR_KEYS
    from emqx_tpu_torch.ops.nfa import _next_pow2

    t0 = time.perf_counter()
    broker, rec, secs = broker_build()
    t1 = time.perf_counter()
    n = SESS_N
    store = SessionStore(capacity=_next_pow2(2 * n), sweep_slots=SESS_SWEEP,
                         retry_interval=SESS_RETRY, clock=lambda: 0.0, device="cpu")
    pids = (np.arange(n) % 65535) + 1
    rows = store.bulk_load([f"c{i}" for i in range(n)],
                           [Message(topic="dev/offline", payload=b"m", qos=1)] * n, pids=pids)
    if int((rows < 0).sum()):
        raise AssertionError("mesh session load lost rows")
    t2 = time.perf_counter()
    subtab, index = broker.subtab, broker.router.index
    n_subs = BROKER_IDS * BROKER_NUMS + BROKER_HOT + BROKER_GROUPS * BROKER_MEMBERS
    if not subtab.sparse or broker.subscription_count() != n_subs:
        raise AssertionError(f"mesh broker: sparse {subtab.sparse}, "
                             f"{broker.subscription_count()} subscriptions")
    csr = subtab.device_snapshot()
    shapes = sum(a.nbytes for a in index.shapes.device_snapshot().values())
    nfa = sum(a.nbytes for a in index.nfa.device_snapshot().values()) \
        if index.residual_count else 0
    groups = sum(a.nbytes for a in broker.grouptab.device_snapshot().values())
    lanes = sum(a.nbytes for a in store.table.device_snapshot().values())
    record = {
        "subscriptions": broker.subscription_count(), "filters": len(broker.router),
        "groups": len(broker.grouptab), "flips": subtab.flips,
        "residual_count": index.residual_count, "sessions": n,
        "session_rows": store.table._cap,
        "build_seconds": {"broker": t1 - t0, "broker_stages": secs, "sessions": t2 - t1},
        # what a rank's mirrors will hold: the match and group tables whole,
        # a half of the CSR arrays ('tp') and of the session lanes ('dp')
        "rank_mirror_bytes": {"shapes": shapes, "nfa": nfa, "groups": groups,
                              "csr_half": sum(csr[k].nbytes for k in CSR_KEYS) // MESH_TP,
                              "session_lanes_half": lanes // (MESH_WORLD // MESH_TP)},
    }
    state = {"broker": broker, "rec": rec, "session_state": store.capture(),
             "session_pids": pids}
    return state, record


def peak_rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def mesh_broker_messages(batches) -> list:
    """broker_publish's messages: payload the index, publisher pub{batch}."""
    from emqx_tpu_torch.broker.message import Message

    return [[Message(topic=t, payload=b"%d" % k, from_client=f"pub{b}")
             for k, t in enumerate(topics)] for b, topics in enumerate(batches)]


def depth2_members(broker, got_sync) -> list:
    """The deliveries `adispatch_begin` makes at depth 2, predicted from the
    synchronous path's: batch N + 1 is prepared before batch N's
    round-robin bases are written back (`pinned_schedule`), so from the
    second batch on each group's picks start as many members earlier as
    that group delivered in the batch before; plain deliveries are the
    same."""
    members = {}
    out = [got_sync[0]]
    for b in range(1, len(got_sync)):
        prev = collections.Counter(s.split("_")[0] for sids in got_sync[b - 1] for s in sids
                                   if s.startswith("g"))
        rows = []
        for sids in got_sync[b]:
            row = []
            for sid in sids:
                if sid.startswith("g"):
                    g = sid.split("_")[0]
                    if g not in members:
                        grp = broker.shared.group(f"device/{g[1:]}/#", "ingest")
                        members[g] = list(grp.members)
                    ms = members[g]
                    sid = ms[(ms.index(sid) - prev[g]) % len(ms)]
                row.append(sid)
            rows.append(row)
        out.append(rows)
    return out


def mesh_broker_ingest(torch, broker, rec, batches, rr0, got_sync) -> dict:
    """mesh_ingest_broker_2x2: the same batches through `adispatch_begin` at
    depth 1 and 2 (at most that many `PendingDispatch` outstanding, each
    settled in launch order), from the bases the synchronous pass started
    at. Depth 1 must deliver the synchronous path's digests; depth 2 those
    of `depth2_members`."""
    import asyncio

    from emqx_tpu_torch import kernels

    want = {1: [delivery_digest(g) for g in got_sync],
            2: [delivery_digest(g) for g in depth2_members(broker, got_sync)]}
    out = {}
    for depth in (1, 2):
        ingest_rr_restore(broker, rr0)
        msgs = mesh_broker_messages(batches)
        where = {id(m): (b, k) for b, ms in enumerate(msgs) for k, m in enumerate(ms)}
        settle = []
        rec.log.clear()

        async def drive():
            pend = collections.deque()
            for ms in msgs:
                if len(pend) == depth:
                    pd, t0 = pend.popleft()
                    await pd.complete()
                    settle.append(1e3 * (time.perf_counter() - t0))
                pend.append((broker.adispatch_begin(ms), time.perf_counter()))
            while pend:
                pd, t0 = pend.popleft()
                await pd.complete()
                settle.append(1e3 * (time.perf_counter() - t0))

        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyncio.run(drive())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        got = [[[] for _ in ms] for ms in msgs]
        for m, sid in rec.log:
            b, k = where[id(m)]
            got[b][k].append(sid)
        digests = [delivery_digest(g) for g in got]
        if digests != want[depth]:
            raise AssertionError(f"mesh ingest depth {depth}: digests {digests} != {want[depth]}")
        n = sum(len(ms) for ms in msgs)
        out[str(depth)] = {"messages": n, "deliveries": len(rec.log), "wall_s": wall,
                           "messages_per_s": n / wall,
                           "settle_p50_ms": float(np.percentile(settle, 50)),
                           "settle_p99_ms": float(np.percentile(settle, 99)),
                           "launches": launches, "digests": digests}
    rec.log.clear()
    return out


def mesh_session(torch, mesh, st) -> dict:
    """mesh_session_2x2 on one rank: a `SessionStore(mesh=...)` installs the
    loaded 1,000,000 sessions (its mirror this rank's 'dp' block); its first
    full sync is timed; a wave of MESH_SESS_WAVE rows moved to the rel
    phase (3 lane writes each) goes up as one delta, every write this rank
    owns and no other; then `tick(fused_path=False)` with the clock past the
    retry interval redelivers the wave's rows (their sessions bound to a
    sink) through the host sweep, and the touches go up as one more delta.
    The mirror is held against this rank's block after each sync."""
    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.broker.session_store import SessionStore

    mono = [0.0]
    metrics = Counters()
    store = SessionStore(capacity=64, sweep_slots=SESS_SWEEP, retry_interval=SESS_RETRY,
                         metrics=metrics, clock=lambda: mono[0], mesh=mesh)
    if store.install(st["session_state"]) != SESS_N:
        raise AssertionError("mesh session install restored fewer sessions")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = store.manager.sync(store.table)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    rank_bytes = sum(mirror_bytes(arrays).values())
    mirrors = {"full": mesh_mirrors(torch, [(store.manager, store.table)])}
    slots = np.linspace(0, SESS_N - 1, MESH_SESS_WAVE).astype(np.int64)
    pids = st["session_pids"][slots]
    for slot, pid in zip(slots.tolist(), pids.tolist()):
        store.inflight_phase(slot, pid, "pubrel")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.manager.sync(store.table)
    torch.cuda.synchronize()
    wave_ms = 1e3 * (time.perf_counter() - t0)
    wave_scatters = kernels.LAUNCHES["segment_scatter"]
    mirrors["wave"] = mesh_mirrors(torch, [(store.manager, store.table)])
    sink = FloodSink()
    for slot in slots.tolist():
        store.bind(slot, sink.resend)
    mono[0] += 60.0
    kernels.reset_launches()
    t0 = time.perf_counter()
    store.tick(fused_path=False)
    store.manager.sync(store.table)  # the sweep's touches
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0)
    tick_scatters = kernels.LAUNCHES["segment_scatter"]
    mirrors["tick"] = mesh_mirrors(torch, [(store.manager, store.table)])
    if sorted(sink.pids) != sorted(pids.tolist()) or metrics.get("session.sweep.host") != 1:
        raise AssertionError(f"mesh tick redelivered {len(sink.pids)} of {MESH_SESS_WAVE}")
    compact = mesh_session_compact(torch, store, slots, pids)
    mirrors["session_compact"] = compact.pop("mirrors")
    return {"first_full_sync_s": full_s, "rank_mirror_bytes": rank_bytes, "compact": compact,
            "local_rows": int(arrays["sess_slot"].shape[0]), "table_rows": store.table._cap,
            "wave_rows": MESH_SESS_WAVE, "wave_sync_ms": wave_ms,
            "wave_scatter_launches": wave_scatters, "tick_ms": tick_ms,
            "tick_scatter_launches": tick_scatters, "redeliveries": len(sink.pids),
            "mirrors": mirrors, "manager": store.manager.counters()}


def mesh_session_compact(torch, store, slots, pids) -> dict:
    """mesh_session_2x2's compaction: the first MESH_SESS_ACKS rows of the
    wave acked (tombstones, one delta), then one `SessionSegmentOwner`
    cycle (tombstone_frac 0, as the reference's replay check) on every
    rank with the store's 'dp' placement: its build uploads this rank's
    block, the next sync adopts it (no lane uploaded), and the mirror
    equals this rank's block of the rebuilt host lanes."""
    from emqx_tpu_torch.broker.metrics import Metrics
    from emqx_tpu_torch.ops import segments as G

    for slot, pid in zip(slots[:MESH_SESS_ACKS].tolist(), pids[:MESH_SESS_ACKS].tolist()):
        store.inflight_delete(slot, pid)
    store.manager.sync(store.table)
    owner = store.compaction_owner(tombstone_frac=0.0)
    tombs = store.table.tombstones
    comp = G.SegmentCompactor(metrics=Metrics(), interval_s=0.0)
    log = UploadLog()
    try:
        t0 = time.perf_counter()
        if not owner.needs_compact() or not comp.compact_now(owner):
            raise AssertionError(f"mesh session cycle: {tombs} tombstones, aborted")
        cycle_s = time.perf_counter() - t0
        c0 = store.manager.counters()
        log.take()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.manager.sync(store.table)
        torch.cuda.synchronize()
        adopt_ms = 1e3 * (time.perf_counter() - t0)
        c1 = store.manager.counters()
        uploaded = log.take()
    finally:
        log.close()
    moves = {k: c1[k] - c0[k] for k in c1}
    if uploaded or moves["full_resyncs"] != 1 or store.table.tombstones \
            or comp.metrics.get("mesh.shard.compact.runs") != 1:
        raise AssertionError(f"mesh session cycle: uploads {uploaded}, moves {moves}")
    return {"acked": MESH_SESS_ACKS, "tombstones": tombs, "cycle_s": cycle_s,
            "offer_upload": [{"s": t1 - t0, "arrays": n, "bytes": b}
                             for t0, t1, n, b in log.offers],
            "adopting_sync_ms": adopt_ms, "adopting_moves": moves,
            "merged": comp.metrics.get("router.compact.merged"),
            "mirrors": mesh_mirrors(torch, [(store.manager, store.table)])}


def rank_mesh_broker(mesh, st) -> dict:
    """mesh_broker_2x2, mesh_ingest_broker_2x2 and mesh_session_2x2 on one
    rank. The broker was built in the mesh process (`mesh_broker_tables`);
    here it takes the mesh (`Broker.mesh`, `Router.mesh`), its first
    prepare reshards the CSR table over 'tp', and it publishes the batches
    broker_1m's fresh broker publishes (the first ROUTE_BATCHES draws of
    `default_rng(SEED)`), every one checked as `broker_publish` checks it
    (plain recipients, each group's pick against `pick_oracle`, the
    launches); every rank's fan-out delivers the whole batch, so every
    rank's digests must equal the single-device broker's."""
    import torch

    from emqx_tpu_torch import kernels
    from emqx_tpu_torch.ops.csr_table import CSR_KEYS
    from emqx_tpu_torch.parallel import mesh as M

    lead = mesh.rank == 0
    broker, rec = st["broker"], st["rec"]
    broker.mesh = mesh
    broker.router.mesh = mesh
    dev = broker._device_router()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = dev.prepare()
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    if type(dev).__name__ != "MeshServingRouter" or broker.subtab.shards != mesh.tp:
        raise AssertionError(f"mesh broker: {type(dev).__name__}, shards {broker.subtab.shards}")
    dev_bytes = {"shapes": sum(mirror_bytes({k: v for k, v in args.tables.items()
                                             if k not in CSR_KEYS}).values()),
                 "csr": sum(mirror_bytes({k: args.tables[k] for k in CSR_KEYS}).values()),
                 "groups": sum(mirror_bytes(args.group_tables).values())}
    if lead:
        phase("mesh_broker_prepare", first_prepare_seconds=prep_s, shards=broker.subtab.shards,
              kslot=args.kslot, kg=args.kg, rank_device_bytes=dev_bytes,
              shard_status=dev.shard_status(), peak_rss_mb=peak_rss_mb())
    rng = np.random.default_rng(SEED)  # broker_path's first draws
    batches = [topic_batch_1m(rng, BATCH) for _ in range(ROUTE_BATCHES)]
    rr0 = ingest_rr_state(broker)
    timer = BrokerTimer(torch, broker)
    launches = collections.Counter()
    published, digests, got_sync = [], [], []
    # the main path: counters zeroed per batch by broker_publish, summed here
    for b, topics in enumerate(batches):
        got = []
        M.reset_collectives()
        with CollectiveClock(torch) as clock:
            pub = broker_publish(torch, broker, rec, timer, topics, b, got_out=got)
        launches.update(pub["launches"])
        coll = {k: dict(v) for k, v in M.COLLECTIVES.items()}
        digests.append(delivery_digest(got))
        got_sync.append(got)
        published.append({**pub, "messages_per_s": len(topics) / (pub["publish_batch_ms"] / 1e3),
                          "deliveries_per_s": pub["deliveries"] / (pub["publish_batch_ms"] / 1e3),
                          "collectives": coll, "collectives_ms": clock.ms,
                          "peak_rss_mb": peak_rss_mb(), "digest": digests[-1]})
    if lead:
        phase("mesh_broker_2x2", backend=mesh.backend, world=mesh.world, batches=published)
    timer.remove(broker)
    ingest = mesh_broker_ingest(torch, broker, rec, batches, rr0, got_sync)
    for run in ingest.values():
        launches.update(run["launches"])
    if lead:
        phase("mesh_ingest_broker_2x2", depths=ingest, peak_rss_mb=peak_rss_mb())
    cmp_ = mesh_compact_broker(torch, mesh, broker, rec, dev, batches, rr0, got_sync)
    if lead:
        phase("mesh_compact_broker_2x2", **{k: v for k, v in cmp_.items() if k != "mirrors"},
              card=card_line(), peak_rss_mb=peak_rss_mb())
    sess = mesh_session(torch, mesh, st)
    launches["segment_scatter"] += sess["wave_scatter_launches"] + sess["tick_scatter_launches"]
    if lead:
        phase("mesh_session_2x2", **{k: v for k, v in sess.items() if k != "mirrors"},
              peak_rss_mb=peak_rss_mb())
    return {"rank": mesh.rank, "launches": dict(launches), "digests": digests,
            "ingest_digests": {d: r["digests"] for d, r in ingest.items()},
            "compact_digests": cmp_["digests"], "compact_launches": cmp_["launches"],
            "redeliveries": sess["redeliveries"], "peak_rss_mb": peak_rss_mb(),
            "collectives_per_batch": published[-1]["collectives"],
            "mirrors": {"publish": dev.segment_status(), "compact": cmp_["mirrors"],
                        **sess["mirrors"]},
            "ingest": {d: {k: v for k, v in r.items() if k != "digests"}
                       for d, r in ingest.items()},
            "session": {k: v for k, v in sess.items() if k != "mirrors"}}


def mesh_check_ranks(name: str, ranks: list) -> None:
    """Every rank took the same mirror decisions (a delta is a launch or a
    skip); the per-rank summary line."""
    def decision(c):
        return c["full_resyncs"], c["array_resyncs"], c["delta_launches"] + c["delta_skipped"]

    for r in ranks[1:]:
        for step, mirrors in r["mirrors"].items():
            for m, c in mirrors.items():
                if decision(ranks[0]["mirrors"][step][m]) != decision(c):
                    raise AssertionError(f"{name}/{step}/{m}: rank {r['rank']} decided {c}")
    phase(f"{name}_ranks", ranks=[{k: r.get(k) for k in ("rank", "launches", "collectives",
                                                          "collectives_per_batch", "mirrors",
                                                          "moved", "sem_moved")}
                                   for r in ranks])


def mesh_main(backend: str, n_gpu: int, wait: bool = False) -> int:
    """The mesh paths, in a process that never touches CUDA itself: it
    builds every path's host tables first (with `wait`, while the calling
    process runs the earlier paths, then it waits for a line on its
    standard input; at end of input it exits without running), then
    `parallel.launch` forks the ranks, which share the tables
    copy-on-write. Prints the mesh kernels' entries as one `mesh_report`
    line for the calling process."""
    from emqx_tpu_torch.models.retained_index import DeviceRetainedIndex
    from emqx_tpu_torch.parallel import launch

    reduced = mesh_reduced(backend, n_gpu)
    out = {"backend": backend, "reduced": reduced}
    t0 = time.perf_counter()
    index, subtab, grouptab, secs = build_share(shards=MESH_TP)
    phase("tables_mesh_share", filters=len(index), subscriptions=subtab.live,
          shards=subtab.shards, groups=len(grouptab), build_seconds=time.perf_counter() - t0,
          build_stage_seconds=secs, backend=backend, ranks=MESH_WORLD, tp=MESH_TP,
          reduced=reduced)
    t0 = time.perf_counter()
    index1, subtab1 = build_mixed_1m()
    t1 = time.perf_counter()
    ridx = DeviceRetainedIndex(max_bytes=RET_MAX_BYTES, max_levels=MAX_LEVELS, device="cpu")
    if ridx.bulk_add(retained_topics(range(RET_N))) != RET_N:
        raise AssertionError("bulk_add refused topics")
    t2 = time.perf_counter()
    cents = sem_centroids()
    sem, sem_stages = build_semantic(np.random.default_rng(SEED + 8), index1, "float32", cents,
                                     shards=MESH_TP)
    t3 = time.perf_counter()
    phase("tables_mesh_1m", filters=len(index1), subscriptions=subtab1.live,
          width_words=subtab1.width_words, retained_topics=len(ridx), chunks=len(ridx._host_b),
          semantic_entries=len(sem), semantic_shards=sem.shards,
          semantic_shard_entries=[int((sem.sem_slot[t] >= 0).sum()) for t in range(sem.shards)],
          semantic_shard_capacity=sem._pcap,
          build_seconds={"mixed_1m": t1 - t0, "retained_5m": t2 - t1,
                         "semantic_256k": t3 - t2, "semantic_stages": sem_stages},
          backend=backend, ranks=MESH_WORLD, tp=MESH_TP, reduced=reduced)
    t0 = time.perf_counter()
    plus = build_plus()
    phase("tables_mesh_plus", filters=plus["filters"], distinct=len(plus["builder"]),
          width_words=plus["dense"].width_words, lane_words_per_rank=plus["dense"].width_words
          // MESH_TP, build_seconds=time.perf_counter() - t0,
          build_stage_seconds=plus["seconds"], backend=backend, ranks=MESH_WORLD, tp=MESH_TP,
          reduced=reduced)
    t0 = time.perf_counter()
    broker_state, broker_tables = mesh_broker_tables()
    built_at = time.time()
    phase("tables_mesh_broker", **broker_tables, seconds=time.perf_counter() - t0,
          built_at=built_at, backend=backend, ranks=MESH_WORLD, tp=MESH_TP, reduced=[])
    # the ranks share this heap copy-on-write: out of the collector's reach,
    # a rank's collections never walk (and so never copy) its pages
    phase("mesh_heap", **frozen_heap())
    if wait:
        line = sys.stdin.readline()
        if not line:
            return 3  # the calling process ended before it asked for the paths
        asked = float(line.split()[1])
        # the main process waits for this build when it ends after the ask
        phase("mesh_build_overlap", built_at=built_at, asked_at=asked,
              ahead_s=asked - built_at, waited_s=max(0.0, built_at - asked))
    t_all = time.perf_counter()

    # 1. mesh_share_2x2
    t0 = time.perf_counter()
    ranks = launch.run(rank_mesh_share, MESH_WORLD, backend=backend, tp=MESH_TP,
                       timeout=MESH_TIMEOUT["share"],
                       state={"index": index, "subtab": subtab, "grouptab": grouptab})
    mesh_check_ranks("mesh_share_2x2", ranks)
    out["share"] = {"report": ranks[0]["report"], "launches": ranks[0]["launches"],
                    "seconds": time.perf_counter() - t0}
    phase("mesh_share_seconds", seconds=time.perf_counter() - t0)
    del index, subtab, grouptab, ranks
    # the CSR table and its op-log hooks form a cycle, out of reach while
    # frozen: free it, then freeze what is left for the next forks
    gc.unfreeze()
    gc.collect()
    gc.freeze()

    # 2. mesh_1m_2x2 and 3. mesh_1m_nccl1
    t0 = time.perf_counter()
    ranks = launch.run(rank_mesh_1m, MESH_WORLD, backend=backend, tp=MESH_TP,
                       timeout=MESH_TIMEOUT["1m"],
                       state={"index": index1, "subtab": subtab1, "ridx": ridx, "sem": sem,
                              "cents": cents})
    mesh_check_ranks("mesh_1m_2x2", ranks)
    out["1m"] = {"report": ranks[0]["report"], "launches": ranks[0]["launches"],
                 "seconds": time.perf_counter() - t0}
    phase("mesh_1m_seconds", seconds=time.perf_counter() - t0)
    del ranks
    t0 = time.perf_counter()
    nccl1 = launch.run(rank_mesh_nccl1, 1, backend="nccl", tp=1,
                       timeout=MESH_TIMEOUT["nccl1"], state={"index": index1, "subtab": subtab1})
    out["nccl1"] = {"launches": nccl1[0]["launches"], "seconds": time.perf_counter() - t0}

    # 4. mesh_plus_2x2: the NFA-only step over the mesh
    t0 = time.perf_counter()
    ranks = launch.run(rank_mesh_plus, MESH_WORLD, backend=backend, tp=MESH_TP,
                       timeout=MESH_TIMEOUT["plus"], state=plus)
    mesh_check_ranks("mesh_plus_2x2", ranks)
    if any(r["stats"] != ranks[0]["stats"] for r in ranks):
        raise AssertionError("mesh_plus_2x2: the ranks' reduced stats differ")
    out["plus"] = {"launches": ranks[0]["launches"], "bound_ms": ranks[0]["bound_ms"],
                   "collectives_per_batch": ranks[0]["collectives_per_batch"],
                   "breakdown": ranks[0]["breakdown"], "seconds": time.perf_counter() - t0}
    phase("mesh_plus_seconds", seconds=time.perf_counter() - t0)
    del plus, ranks
    gc.collect()

    # 5. mesh_broker_2x2, mesh_ingest_broker_2x2, mesh_session_2x2
    t0 = time.perf_counter()
    ranks = launch.run(rank_mesh_broker, MESH_WORLD, backend=backend, tp=MESH_TP,
                       timeout=MESH_TIMEOUT["broker"], state=broker_state)
    mesh_check_ranks("mesh_broker_2x2", ranks)
    for r in ranks[1:]:
        for key in ("digests", "ingest_digests", "redeliveries", "compact_digests"):
            if r[key] != ranks[0][key]:
                raise AssertionError(f"mesh_broker_2x2: rank {r['rank']}'s {key} differ")
    out["broker"] = {"digests": [r["digests"] for r in ranks], "launches": ranks[0]["launches"],
                     "compact_digests": [r["compact_digests"] for r in ranks],
                     "compact_launches": ranks[0]["compact_launches"],
                     "peak_rss_mb": [r["peak_rss_mb"] for r in ranks],
                     "seconds": time.perf_counter() - t0}
    phase("mesh_broker_seconds", seconds=time.perf_counter() - t0,
          peak_rss_mb=out["broker"]["peak_rss_mb"])
    phase("mesh_seconds", seconds=time.perf_counter() - t_all)
    print(json.dumps({"mesh_report": out}), flush=True)
    return 0


def mesh_start(torch):
    """Start the mesh paths' process (`python3 chip_smoke.py --mesh BACKEND
    GPUS`: a process that has used CUDA cannot fork ranks that use it). It
    builds its host tables while this process runs the earlier paths, then
    waits for `mesh_ask`. 4 ranks on NCCL with four GPUs or more, else
    4 gloo ranks sharing cuda:0. -> (process, backend)."""
    import os

    n_gpu = torch.cuda.device_count()
    backend = "nccl" if n_gpu >= MESH_WORLD else "gloo"
    # a session of its own: killing it (`mesh_kill`) takes its ranks too
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh", backend,
                             str(n_gpu)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, bufsize=1, start_new_session=True)
    return proc


def mesh_kill(proc) -> None:
    """Kill the mesh process and every rank it forked, if any is left."""
    import os
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def mesh_ask(torch, proc) -> dict:
    """Phases 34-37, first half: let the mesh process run its paths now,
    its lines collected by a reader thread (so a full pipe never stalls
    it) while this process goes on with host-only work (broker_1m's
    subscribe loop: the card is the mesh ranks' meanwhile). -> the handle
    `mesh_join` takes."""
    import threading

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    watchdog = threading.Timer(MESH_DEADLINE, mesh_kill, (proc,))
    watchdog.start()
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    reader = threading.Thread(target=read, name="mesh-lines")
    proc.stdin.write(f"go {time.time()}\n")  # the time of the ask, for the overlap
    proc.stdin.close()
    reader.start()
    return {"proc": proc, "watchdog": watchdog, "reader": reader, "lines": lines,
            "asked": time.perf_counter()}


def mesh_join(asked) -> dict:
    """Second half: wait for the mesh process, relay its lines, -> the
    `mesh_report` it printed. Raises when it fails or outlives
    MESH_DEADLINE (then it is killed with its ranks)."""
    proc = asked["proc"]
    try:
        asked["reader"].join()
        rc = proc.wait()
    finally:
        asked["watchdog"].cancel()
        mesh_kill(proc)
    report = None
    for line in asked["lines"]:
        if line.startswith('{"mesh_report"'):
            report = json.loads(line)["mesh_report"]
            continue
        print(line, end="", flush=True)
    if rc != 0 or report is None:
        raise AssertionError(f"the mesh paths failed (exit code {rc})")
    report["joined_after_s"] = time.perf_counter() - asked["asked"]
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from emqx_tpu_torch.kernels import build

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load()
    mesh_proc = mesh_start(torch)  # builds the mesh paths' tables meanwhile
    try:
        return run_paths(torch, build, card, t0, mesh_proc)
    finally:
        mesh_kill(mesh_proc)


def run_paths(torch, build, card, t0, mesh_proc) -> int:
    phase("toolchain", card=card, python=sys.version.split()[0],
          torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version(),
          build_seconds=time.perf_counter() - t0)

    phase("launch_path", **launch_path_costs(torch))
    rng = np.random.default_rng(SEED)
    report_1m = mixed_1m_path(torch, rng)
    phase("kernels_1m", kernels=list(report_1m.values()))
    torch.cuda.empty_cache()
    report, launches = mixed_10m_path(torch, rng)
    for name in report:
        report[name]["launches"] = launches[name]
    gc.collect()
    torch.cuda.empty_cache()
    share_report, share_launches = share_path(torch, rng)
    for case in share_report.values():
        case["launches"] = share_launches[case["name"]]
    # row 7, the serving composite: per batch, the sum of its kernels' bounds
    phase("composite_bounds", mixed_10m_ms=sum(
        report[k]["bound_ms"] for k in ("tokenize", "shape_match", "vocab_lookup",
                                        "nfa_walk", "fanout_bitmaps", "compact_fanout_slots")),
          share_10m_csr_ms=sum(share_report[k]["bound_ms"] for k in (
              "tokenize", "shape_match", "sparse_fanout_slots", "occurrence_index",
              "share_pick/round_robin")))
    # the kernels line: the mixed_10m path's seven, and this path's three
    # (share_pick as the path runs it, round_robin)
    for k in ("sparse_fanout_slots", "share_pick/round_robin", "occurrence_index"):
        report[share_report[k]["name"]] = share_report[k]
    del share_report
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ret_report, ret_launches, router_1m, ret_index = retained_path(torch, rng)
    phase("retained_seconds", seconds=time.perf_counter() - t0)
    # and the retained path's two; tokenize and shape_match gain their storm
    # cases (their launches: one a chunk of every storm, and the fused
    # calls' route half), shape_match also the wide storm's
    for k in ("row_lengths", "narrow_i16"):
        report[k] = {**ret_report[k], "launches": ret_launches[k]}
    report["tokenize"]["retained"] = {**ret_report["tokenize/chunk"],
                                      "launches": ret_launches["tokenize"]}
    report["shape_match"]["retained"] = {**ret_report["shape_match/chunk"],
                                         "launches": ret_launches["shape_match"]}
    # the wide storm's chunk: the path's count only (both storms' chunks
    # and the fused route halves), not this case's own launches
    report["shape_match"]["retained_wide"] = {**ret_report["shape_match/wide_chunk"],
                                              "path_launches": ret_launches["shape_match"]}
    phase("launches_retained", **ret_launches)
    del ret_report
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sess_report, sess_launches, sess_capture = session_path(torch, rng, router_1m)
    phase("session_seconds", seconds=time.perf_counter() - t0)
    # and the session path's one
    report["session_sweep"] = {**sess_report["session_sweep"],
                               "launches": sess_launches["session_sweep"]}
    del sess_report
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sem_report, sem_launches = semantic_path(torch, rng, router_1m)
    phase("semantic_seconds", seconds=time.perf_counter() - t0)
    # and the semantic path's two (semantic_match with its f32 table), and
    # the scatter's float lanes beside its int32 case
    for k in ("semantic_match", "rule_masks"):
        report[k] = {**sem_report[k], "launches": sem_launches[k]}
    report["segment_scatter"]["lanes"] = sem_report["segment_scatter_lanes"]
    del sem_report, router_1m
    gc.collect()
    torch.cuda.empty_cache()
    # the broker's publish path and the NFA-only step: their kernels' cases
    # at these paths' shapes join the entries
    t0 = time.perf_counter()
    # the mesh paths run while broker_1m's subscribe loop (host work only)
    # builds its broker
    broker_report, broker_launches, broker_digests, mesh, storm_launches, app_launches = \
        broker_path(torch, np.random.default_rng(SEED), sess_capture, mesh_proc, ret_index)
    del sess_capture, ret_index
    phase("broker_seconds", seconds=time.perf_counter() - t0)
    for case in broker_report.values():
        report[case["name"]]["broker_1m"] = {**case, "launches": broker_launches[case["name"]]}
    # the broker's semantic phases launch the semantic path's two kernels
    for k in ("semantic_match", "rule_masks"):
        report[k]["broker_1m_launches"] = broker_launches[k]
    # and the batches that carried a retained storm (feed_broker,
    # retainer_broker) launched the storm's four
    for k in ("row_lengths", "narrow_i16", "tokenize", "shape_match"):
        report[k]["broker_1m_storm_launches"] = storm_launches[k]
    # and the app's clients' batches (app_clients) every kernel they launched
    for case in report.values():
        case["app_launches"] = app_launches.get(case["name"], 0)
    t0 = time.perf_counter()
    plus_report, plus_launches, plus_bound = plus_path(torch, np.random.default_rng(SEED + 70))
    phase("plus_seconds", seconds=time.perf_counter() - t0)
    for name, case in plus_report.items():
        report[name]["plus_100k"] = {**case, "launches": plus_launches[name]}
    del broker_report, plus_report
    gc.collect()
    torch.cuda.empty_cache()
    # the mesh paths: occurrence_index (with its totals, the round-robin
    # branch's group counts), compact_fanout_slots and share_pick gain their
    # mesh cases (totals, lane base, rank offsets)
    phase("mesh_paths_seconds", seconds=mesh["joined_after_s"], backend=mesh["backend"],
          reduced=mesh["reduced"], beside="broker_1m's subscribe loop")
    share_mesh, launches_share = mesh["share"]["report"], mesh["share"]["launches"]
    report["occurrence_index"]["mesh"] = {**share_mesh["occurrence_index/mesh_totals"],
                                          "launches": launches_share["occurrence_index"]}
    report["share_pick"]["mesh"] = {**share_mesh["share_pick/mesh"],
                                    "launches": launches_share["share_pick"]}
    report["compact_fanout_slots"]["mesh"] = {
        **mesh["1m"]["report"]["compact_fanout_slots/mesh"],
        "launches": mesh["1m"]["launches"]["compact_fanout_slots"]}
    # the mesh broker: every rank delivered broker_1m's batches as the
    # single-device broker did, and its launches join the entries
    mb = mesh["broker"]
    if any(d != broker_digests for d in mb["digests"]):
        raise AssertionError(f"mesh_broker_2x2: digests {mb['digests']} against broker_1m's "
                             f"{broker_digests}")
    phase("mesh_broker_digests", ranks=len(mb["digests"]), batches=len(broker_digests),
          equal_to_broker_1m=True)
    for name, n in mb["launches"].items():
        if n:
            report[name]["mesh_broker_launches"] = n
    # ... and after its shape and CSR cycle on every rank
    if any(d != broker_digests for d in mb["compact_digests"]):
        raise AssertionError(f"mesh_compact_broker_2x2: digests {mb['compact_digests']} "
                             f"against broker_1m's {broker_digests}")
    phase("mesh_compact_broker_digests", ranks=len(mb["compact_digests"]),
          batches=len(broker_digests), equal_to_broker_1m=True)
    # the compaction and snapshot phases' launches, each kernel's by phase
    COMPACT_LAUNCHES["mesh_compact_broker_2x2"] = mb["compact_launches"]
    for case in report.values():
        case["compact_launches"] = {ph: n[case["name"]] for ph, n in COMPACT_LAUNCHES.items()
                                    if n.get(case["name"])}
    # the two composites this slice ports: route_step's bound per batch (the
    # sum of its kernels' bounds) beside dist_step's on a rank
    phase("composite_bounds_nfa", route_step_ms=plus_bound,
          dist_step_rank_ms=mesh["plus"]["bound_ms"],
          dist_step_collectives_per_batch=mesh["plus"]["collectives_per_batch"])
    print(card, flush=True)
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--app-clients"]:  # the app phases' clients (AppClientProc)
        sys.exit(app_clients_main())
    if sys.argv[1:2] == ["--mesh"]:  # the mesh paths' own process (mesh_start)
        # with --now it runs at once (the mesh paths alone, e.g. on a
        # four-GPU host: `--mesh nccl 4 --now`)
        sys.exit(mesh_main(sys.argv[2], int(sys.argv[3]), wait="--now" not in sys.argv))
    sys.exit(main())
