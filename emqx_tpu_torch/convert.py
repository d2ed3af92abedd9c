"""Host tables -> the port's device tensors.

`upload` is the port's counterpart of "weights carried across": it takes
any snapshot dict the host builders hand out — `ShapeIndex`,
`NfaBuilder`, `SubscriberTable` (dense ``sub_bitmaps`` or the five
``[S, F]`` / ``[S, P]`` / ``[S, H]`` CSR arrays) or `GroupTable`
`.device_snapshot()`, of either package, which agree byte for byte, and
`DeviceRetainedIndex`'s uint8 topic chunks, `SemanticTable`'s f32 lanes
and, in its quantized mode, bf16 vectors — and uploads each array, of
any shape, as the tensor the kernels read. uint32 arrays are
reinterpreted bit for bit as int32 (the kernels read them back as
uint32_t); int32, uint8 and float32 arrays keep their type; a `BF16`
array (numpy has no bfloat16: its elements are the uint16 bits, under a
dtype of their own) becomes a torch.bfloat16 tensor of the same bits; no
value is converted. Every full resync of `ops.segments.DeviceSegmentManager` goes
through it;
`tables_to_device` gathers the shape tables and the subscriber bitmaps
into the one dict `models.router_model.shape_route_step` reads.

On a ('dp', 'tp') mesh (`parallel.mesh`) every rank holds the same host
tables and uploads only its own part of each array: `upload(...,
placement=)` with a `Replicated` placement (match tables, storm filter
tables, group tables) or a `Block` one (dense bitmap lanes over 'tp' on
axis 1, CSR and semantic slot-owner shards over 'tp' on axis 0, retained
chunk rows over 'dp' on axis 0), the counterparts of the JAX placements
(emqx_tpu/parallel/mesh.py:795-857). A placement also maps an op-log
write's global flat index to this rank's local one (`local_writes`), so a
mirror replays only the writes it owns.

`session_state_from_reference` carries a reference session store's capture
across: the port's store installs it and redelivers what the reference's
would.
`segment_state_from_reference` carries a reference segment-state
snapshot across (the reference app's `segments.pkl`: its router,
subscriber table, group table and session store capture): a restricted
unpickler maps each reference class onto the port's copy, refuses every
other class, and hands the session capture to
`session_state_from_reference`.
`semantic_state_from_reference` does the same for a reference
`SemanticRouting`: its live entries, slot registry and default threshold
become a port `SemanticRouting` whose table is the packed layout the
reference's own fold builds. Rules carry across as their SQL strings: the
port's `RuleEngine.create_rule` takes the reference rule's id and SQL.
`retained_messages_from_reference` carries a reference retainer's messages
into port `Message`s for `Retainer.load`. A reference `DegradeController.
snapshot()` needs no conversion: the port's `restore` takes it as it is.

`resolve_device` is the one place an entry point turns its `device`
argument into a torch device: CUDA unless the caller asks for the CPU, and
an error — never a quiet move to the CPU — when CUDA is asked for and
absent.
"""

from __future__ import annotations

import io
import pickle
from typing import Dict, List

import numpy as np
import torch

from emqx_tpu_torch.ops.shape_index import SHAPE_TABLE_KEYS

# bfloat16 on the host: the uint16 bits, under a dtype no other table uses
BF16 = np.dtype([("bf16", np.uint16)])


def bf16_bits(x) -> np.ndarray:
    """float32 values -> their bfloat16 bits (uint16), rounded to nearest
    even, NaN as the quiet NaN of its sign: the bits
    ``x.astype(ml_dtypes.bfloat16)`` gives, and ``astype(bfloat16)`` in
    JAX."""
    x = np.ascontiguousarray(x, np.float32)
    b = x.view(np.uint32)
    r = ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1)))
         >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        r[nan] = ((b[nan] >> np.uint32(16)) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return r


def to_bf16(x) -> np.ndarray:
    """float32 values -> a `BF16` host array (see `bf16_bits`)."""
    return bf16_bits(x).view(BF16)


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch twins of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _as_device_type(arr: np.ndarray, name: str) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return arr.view(np.int32)
    if arr.dtype == BF16:
        return arr.view(np.int16)
    if arr.dtype not in (np.int32, np.uint8, np.float32):
        raise TypeError(
            f"{name}: expected int32 or uint32 (or uint8 bytes, float32 or BF16), got {arr.dtype}"
        )
    return arr


def _to_device(arr: np.ndarray, name: str, device, chunk_bytes: int = 0) -> torch.Tensor:
    """One host array -> a fresh tensor on `device` (always a copy: the
    host builders mutate their arrays in place). With `chunk_bytes`, a
    card copy is staged through two pinned buffers of that size: a piece
    is copied into one while the other's asynchronous copy runs on the
    current stream, which is waited for at the end."""
    src = torch.from_numpy(_as_device_type(arr, name))
    if chunk_bytes and device.type == "cuda" and src.nbytes > chunk_bytes:
        t = torch.empty(src.shape, dtype=src.dtype, device=device)
        step = max(1, chunk_bytes // src.element_size())
        flat_s, flat_d = src.view(-1), t.view(-1)
        stream = torch.cuda.current_stream(device)
        bufs = [torch.empty(step, dtype=src.dtype, pin_memory=True) for _ in range(2)]
        done = [None, None]
        for i, a in enumerate(range(0, flat_s.numel(), step)):
            n, b = min(step, flat_s.numel() - a), i % 2
            if done[b] is not None:
                done[b].synchronize()  # the copy that read this buffer is over
            bufs[b][:n].copy_(flat_s[a:a + n])
            flat_d[a:a + n].copy_(bufs[b][:n], non_blocking=True)
            done[b] = torch.cuda.Event()
            done[b].record(stream)
        stream.synchronize()
    else:
        t = src.to(device, copy=True)
    return t.view(torch.bfloat16) if np.asarray(arr).dtype == BF16 else t


class Replicated:
    """Every rank holds the whole array (JAX's ``P()``). Called as
    ``placement(name, array)`` (a numpy array or a tensor) it returns this
    rank's tensor on `device`, as the JAX placements return a placed
    array."""

    def __init__(self, device=None):
        self.device = device

    def __call__(self, name: str, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return self.place(name, arr).contiguous().to(resolve_device(self.device))
        return upload({name: arr}, self.device or "cuda", self)[name]

    def place(self, name: str, arr):
        """`arr` (numpy or tensor) -> this rank's part of it, a view."""
        return arr

    def local_writes(self, name: str, shape, idx: np.ndarray):
        """Global flat indices of `name` (an array of `shape`) -> (mask of
        the writes this rank owns, their local flat indices)."""
        return np.ones(len(idx), bool), idx


class Block(Replicated):
    """Axis `axis` cut into `parts` equal blocks; this rank holds block
    `index` (JAX's ``P(None, "tp")`` for axis 1, ``P("tp")`` /
    ``P("dp", None)`` for axis 0). Raises when the axis does not divide."""

    def __init__(self, axis: int, parts: int, index: int, device=None):
        if parts < 1 or not 0 <= index < parts:
            raise ValueError(f"block {index} of {parts}")
        super().__init__(device)
        self.axis, self.parts, self.index = axis, parts, index

    def _block(self, name: str, shape) -> int:
        if len(shape) <= self.axis or shape[self.axis] % self.parts:
            raise ValueError(
                f"{name}: axis {self.axis} of shape {tuple(shape)} does not "
                f"split into {self.parts} equal blocks"
            )
        return shape[self.axis] // self.parts

    def place(self, name: str, arr):
        blk = self._block(name, tuple(arr.shape))
        sl = [slice(None)] * arr.ndim
        sl[self.axis] = slice(self.index * blk, (self.index + 1) * blk)
        return arr[tuple(sl)]

    def local_writes(self, name: str, shape, idx: np.ndarray):
        blk = self._block(name, shape)
        inner = int(np.prod(shape[self.axis + 1:], dtype=np.int64))
        n_ax = shape[self.axis]
        idx = np.asarray(idx, np.int64)
        outer, rest = np.divmod(idx, n_ax * inner)
        a, r = np.divmod(rest, inner)
        lo = self.index * blk
        mask = (a >= lo) & (a < lo + blk)
        local = (outer * blk + (a - lo)) * inner + r
        return mask, local[mask]


def upload(snapshot: Dict[str, np.ndarray], device="cuda",
           placement=None, chunk_bytes: int = 0) -> Dict[str, torch.Tensor]:
    """{name: host array} -> {name: fresh tensor on `device`} of the same
    bits: int32 for the int32 and uint32 arrays, uint8 for byte arrays,
    float32 for float32 lanes, bfloat16 for `BF16` arrays. With a
    `placement` each tensor holds this rank's part of its array (`Block`),
    or all of it (`Replicated`, the default). `chunk_bytes` > 0: copies to
    a card are staged through pinned buffers of that size (a background
    upload's copies are then asynchronous DMA, not pageable copies that
    other threads' copies queue behind)."""
    dev = resolve_device(device)
    place = placement.place if placement is not None else (lambda _k, v: v)
    return {k: _to_device(place(k, v), k, dev, chunk_bytes) for k, v in snapshot.items()}


def tables_to_device(
    shape_snapshot: Dict[str, np.ndarray],
    sub_bitmaps: np.ndarray,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """-> {shape_tab, shape_hot, shape_tomb, shape_mask, shape_len,
    shape_flags, sub_bitmaps} int32 tensors on `device`.

    shape_snapshot: `ShapeIndex.device_snapshot()`; sub_bitmaps: uint32
    [Fcap, W] from `SubscriberTable.pack(index.num_filters_capacity)`."""
    if sub_bitmaps.ndim != 2:
        raise ValueError(f"sub_bitmaps: expected [Fcap, W], got {sub_bitmaps.shape}")
    snap = {k: shape_snapshot[k] for k in SHAPE_TABLE_KEYS}
    snap["sub_bitmaps"] = sub_bitmaps
    return upload(snap, device)


# the lanes of a session table, row lanes then the per-slot lane
SESSION_LANES = ("sess_slot", "sess_pid", "sess_state", "sess_ts", "sess_mid",
                 "slot_expiry")
# the fields of a message record (`broker.message.Message`)
MESSAGE_FIELDS = ("topic", "payload", "qos", "retain", "dup", "from_client",
                  "from_username", "mid", "headers", "properties", "timestamp")


def session_state_from_reference(state: Dict) -> Dict:
    """A reference `SessionStore.capture()` (emqx_tpu/broker/
    session_store.py:563) -> the port's capture, for the port's
    `SessionStore.install`: the session store's state carried across.

    The table is read by attribute (its lanes as numpy arrays, counts,
    epoch, version, op-log) into a port `SessionTable` holding copies of
    identical lanes; each slab message is read by field into a port
    `Message` (one per distinct object: a message the slab holds many
    times stays one object), None kept; the registry lists and dicts are
    copied. Nothing is shared with `state`, which may be installed too.
    Duck-typed: nothing of the reference package is imported."""
    from emqx_tpu_torch.broker.message import Message
    from emqx_tpu_torch.ops.session_table import SessionTable

    src = state["table"]
    table = SessionTable.__new__(SessionTable)
    for name in SESSION_LANES:
        lane = np.asarray(getattr(src, name))
        if lane.dtype != np.int32:
            raise TypeError(f"{name}: expected int32, got {lane.dtype}")
        setattr(table, name, lane.copy())
    for name in ("_cap", "_scap", "live", "tombstones", "epoch", "version",
                 "OPLOG_MAX", "_structure_gen"):
        setattr(table, name, int(getattr(src, name)))
    if getattr(src, "_journal", None) is not None:
        raise ValueError("the captured table is mid-compaction")
    table._journal = None
    table.oplog = [tuple(e) for e in src.oplog]
    memo: Dict[int, object] = {}

    def port_msg(m):
        if m is None:
            return None
        got = memo.get(id(m))
        if got is None:
            got = memo[id(m)] = Message(**{
                f: (dict(getattr(m, f)) if f in ("headers", "properties")
                    else getattr(m, f)) for f in MESSAGE_FIELDS})
        return got

    return {
        "table": table,
        "slab": [port_msg(m) for m in state["slab"]],
        "free_mids": list(state["free_mids"]),
        "slots": dict(state["slots"]),
        "slot_cid": list(state["slot_cid"]),
        "free_slots": list(state["free_slots"]),
        "t0_age_ds": int(state.get("t0_age_ds", 0)),
    }


def retained_messages_from_reference(msgs) -> List:
    """A reference `Retainer.all_messages()` (emqx_tpu/broker/retainer.py
    :236) -> port `Message`s, for the port's `Retainer.load`: the retained
    store carried across. Each message is read by field (headers and
    properties copied); nothing of the reference package is imported."""
    from emqx_tpu_torch.broker.message import Message

    return [Message(**{f: (dict(getattr(m, f)) if f in ("headers", "properties")
                           else getattr(m, f)) for f in MESSAGE_FIELDS})
            for m in msgs]


def semantic_state_from_reference(entries, by_slot: Dict, default_threshold: float, *,
                                  dim: int, topk: int, dtype: str = "float32"):
    """A reference `SemanticRouting`'s state (emqx_tpu/broker/semantic.py:76)
    -> a port `SemanticRouting` (broker/semantic.py) routing as it does.

    Plain values only, nothing of the reference package imported:
    `entries`, each live entry's (slot, vector, threshold, fid), as the
    reference table's `_live_tuples()` lists them (vectors unit f32 [dim],
    thresholds the table's f32 values); `by_slot`, its
    ``{slot: (sid, scope filter or None, threshold)}`` registry;
    `default_threshold`; `dim`, `topk` and `dtype` (the table's vector
    type, "float32" or "bfloat16") as the reference routing was made. The
    entries are installed as one packed build of
    exactly these vectors (no renormalisation, so no bit moves), the layout
    the reference table's own fold (`_rebuild`) makes of the same entries:
    the port table's `device_snapshot()` is byte-identical to the folded
    reference table's, and one epoch bump makes the next `prepare()` a
    full upload."""
    from emqx_tpu_torch.broker.semantic import SemanticRouting

    routing = SemanticRouting(dim=dim, topk=topk, threshold=default_threshold, dtype=dtype)
    ent = []
    for slot, vec, th, fid in entries:
        v = np.array(vec, np.float32)
        if v.shape != (dim,):
            raise ValueError(f"slot {slot}: vector of shape {v.shape}, want ({dim},)")
        ent.append((int(slot), v, float(np.float32(th)),
                    -1 if fid is None or fid < 0 else int(fid)))
    if len({e[0] for e in ent}) != len(ent):
        raise ValueError("two entries bind one slot")
    table = routing.table
    table._install(table._build(ent, table.shards, table.dim))
    table._bump()
    routing._by_slot = {int(s): (str(sid), scope, float(th))
                        for s, (sid, scope, th) in by_slot.items()}
    return routing


# reference class -> the port's copy of it, for `segment_state_from_reference`
_REFERENCE_CLASSES = {
    ("emqx_tpu.broker.router", "Router"): ("emqx_tpu_torch.broker.router", "Router"),
    ("emqx_tpu.broker.trie", "TopicTrie"): ("emqx_tpu_torch.broker.trie", "TopicTrie"),
    ("emqx_tpu.broker.trie", "_Node"): ("emqx_tpu_torch.broker.trie", "_Node"),
    ("emqx_tpu.ops.route_index", "RouteIndex"): ("emqx_tpu_torch.ops.route_index", "RouteIndex"),
    ("emqx_tpu.ops.shape_index", "ShapeIndex"): ("emqx_tpu_torch.ops.shape_index", "ShapeIndex"),
    ("emqx_tpu.ops.nfa", "NfaBuilder"): ("emqx_tpu_torch.ops.nfa", "NfaBuilder"),
    ("emqx_tpu.ops.matcher", "MatcherConfig"): ("emqx_tpu_torch.ops.matcher", "MatcherConfig"),
    ("emqx_tpu.ops.csr_table", "CsrTable"): ("emqx_tpu_torch.ops.csr_table", "CsrTable"),
    ("emqx_tpu.models.router_model", "SubscriberTable"):
        ("emqx_tpu_torch.models.router_model", "SubscriberTable"),
    ("emqx_tpu.models.router_model", "GroupTable"):
        ("emqx_tpu_torch.models.router_model", "GroupTable"),
    ("emqx_tpu.ops.session_table", "SessionTable"):
        ("emqx_tpu_torch.ops.session_table", "SessionTable"),
}
# what numpy pickles its arrays, scalars and dtypes through
_NUMPY_GLOBALS = {
    (mod, name)
    for core in ("numpy.core", "numpy._core")
    for mod, name in ((f"{core}.multiarray", "_reconstruct"), (f"{core}.multiarray", "scalar"),
                      (f"{core}.numeric", "_frombuffer"))
} | {("numpy", "ndarray"), ("numpy", "dtype")}
_MESSAGE_CLASSES = {("emqx_tpu.broker.message", "Message"),
                    ("emqx_tpu.broker.message", "SlabMessage")}


class _ReferenceMessage:
    """A reference message's pickled fields, read by attribute
    (`session_state_from_reference` turns it into a port `Message`). A
    slab message pickles its owned topic and payload as ``_topic`` and
    ``_payload``."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __getattr__(self, name):
        if name in ("topic", "payload"):
            return self.__dict__[f"_{name}"]
        raise AttributeError(name)


def _bound_method(obj, name: str):
    """``getattr`` as a pickled bound method uses it (a `CsrTable`'s
    op-log callbacks are its `SubscriberTable`'s methods), allowed only
    for a method of a mapped class."""
    mapped = {v for v in _REFERENCE_CLASSES.values()}
    cls = type(obj)
    if (cls.__module__, cls.__qualname__) not in mapped or name.startswith("__") \
            or not callable(getattr(cls, name, None)):
        raise pickle.UnpicklingError(f"refused getattr({cls.__qualname__}, {name!r})")
    return getattr(obj, name)


class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        import importlib

        if (module, name) in _REFERENCE_CLASSES:
            mod, cls = _REFERENCE_CLASSES[(module, name)]
            return getattr(importlib.import_module(mod), cls)
        if (module, name) in _MESSAGE_CLASSES:
            return _ReferenceMessage
        if (module, name) in _NUMPY_GLOBALS:
            return getattr(importlib.import_module(module), name)
        if (module, name) == ("builtins", "getattr"):
            return _bound_method
        raise pickle.UnpicklingError(f"refused class {module}.{name}")


def segment_state_from_reference(state, device="cuda") -> Dict:
    """A reference segment-state snapshot (what the reference app's
    `_cap_segments` captures, emqx_tpu/app.py:660-681) -> the port's, for
    an install into a port broker.

    `state`: the snapshot file's path, its bytes, or the captured dict
    itself (its objects are pickled here as the reference pickles them).
    A restricted unpickler maps the reference's `Router`, `TopicTrie`,
    `RouteIndex`, `ShapeIndex`, `NfaBuilder`, `MatcherConfig`,
    `SubscriberTable`, `CsrTable`, `GroupTable` and `SessionTable` onto the
    port's copies (whose host arrays and registries are the reference's,
    bit for bit), reads messages as plain records, and refuses any other
    class. The router's matcher and mesh come back None (as the reference
    pickles them) and its `device` is `device`; a ``session_store`` capture
    goes through `session_state_from_reference`. Nothing of the reference
    package is imported."""
    import dataclasses

    from emqx_tpu_torch.ops.matcher import MatcherConfig

    if isinstance(state, dict):
        data = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    elif isinstance(state, (bytes, bytearray, memoryview)):
        data = bytes(state)
    else:
        with open(state, "rb") as f:
            data = f.read()
    got = _ReferenceUnpickler(io.BytesIO(data)).load()
    if not isinstance(got, dict):
        raise TypeError(f"a segment snapshot is a dict, got {type(got).__name__}")
    out = dict(got)
    router = out.get("router")
    if router is not None:
        router._matcher = None
        router.mesh = None
        router.device = device
        cfg = router._matcher_config
        router._matcher_config = MatcherConfig(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(MatcherConfig)})
    if out.get("session_store") is not None:
        out["session_store"] = session_state_from_reference(out["session_store"])
    return out
