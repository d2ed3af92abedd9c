"""Device index for retained-message replay storms: the port's copy of
`emqx_tpu/models/retained_index.py` (BASELINE config 5, a wildcard
SUBSCRIBE storm against millions of retained messages).

The routing kernels pointed the other way: the stored retained TOPICS are
the batch, and the storm's FILTERS become a one-shot shape index (plus a
residual NFA when they span more than `MAX_SHAPES` shapes). One storm
launch per chunk of `CHUNK` stored topics answers "which retained topics
match which filter" as a sparse [CHUNK, lanes] match matrix:

  row_lengths  ->  tokenize  ->  shape_match  [->  vocab_lookup -> nfa_walk]
  [->  narrow_i16, when every filter id fits in int16]

`row_lengths` and `narrow_i16` are this module's kernels
(`kernels/csrc/retained.cu`); the others are the serving step's
(`models.router_model.shape_route_step`, match-only). Each has its plain
PyTorch twin beside its wrapper; a wrapper runs the twin only for CPU
tensors.

Host state stays numpy, bit for bit the JAX index's: the chunks
(`_host_b`, uint8 [CHUNK, bucket]), the row registry and the op-log.
The chunks reach the device through one `ops.segments.DeviceSegmentManager`
(name "retained"): a row edit is a byte scatter, a fresh chunk re-uploads
alone, and only a change of the bucket width pays a full upload. A storm's
filter tables are uploaded per storm and never mirrored.

`CHUNK` is read at call time, as a module global, in the JAX module too.

On a ('dp', 'tp') mesh (`mesh=`, or `place(mesh)` for an index whose host
state was built before the ranks existed) the chunk mirror holds this
rank's 'dp' block of every chunk's rows (`parallel.mesh
.retained_placement`) and a storm's filter tables are replicated: each
rank matches its block, and `match` / `match_many` gather the blocks over
'dp'; a `MeshServingRouter` fuses them into its batch's one gather.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.convert import resolve_device, upload
from emqx_tpu_torch.kernels import build
from emqx_tpu_torch.models.router_model import shape_route_step
from emqx_tpu_torch.ops import topics as T
from emqx_tpu_torch.ops.matcher import batch_match_syms_plain
from emqx_tpu_torch.ops.nfa import _next_pow2
from emqx_tpu_torch.ops.route_index import RouteIndex
from emqx_tpu_torch.ops.segments import RESYNC, DeviceSegmentManager
from emqx_tpu_torch.ops.shape_index import shape_match_plain
from emqx_tpu_torch.ops.tokenizer import encode_topics, tokenize_plain, vocab_lookup_plain

# Topics per storm launch (JAX sizes it for its per-launch dispatch cost);
# the port keeps it so both packages cut a store into the same chunks.
CHUNK = 1 << 20

# the residual lane's knobs in a storm launch: the JAX step passes none and
# takes `shape_route_step_impl`'s defaults
STORM_FRONTIER = 32
STORM_MAX_MATCHES = 64
STORM_PROBES = 8


# -- kernel 11a: row lengths -------------------------------------------------


def row_lengths_plain(bytes_mat):
    """Plain PyTorch twin of the `row_lengths` kernel (any device)."""
    return (bytes_mat != 0).sum(dim=1, dtype=torch.int32)


def row_lengths(bytes_mat):
    """Topic chunk uint8 [N, MB] -> int32 [N]: the count of nonzero bytes
    of each row, which is a retained topic's length (topics hold no NUL;
    padding and removed rows count 0). Kernel `row_lengths`; replaces
    `jnp.sum((bm != 0).astype(jnp.int32), axis=1)`
    (emqx_tpu/models/retained_index.py:69, router_model.py:653)."""
    kernels.check_tensor(bytes_mat, "bytes_mat", torch.uint8, 2)
    if not kernels.on_cuda(bytes_mat):
        return row_lengths_plain(bytes_mat)
    N, MB = bytes_mat.shape
    out = torch.empty(N, dtype=torch.int32, device=bytes_mat.device)
    kernels.launch("row_lengths", "emqx_row_lengths", bytes_mat.device,
                   bytes_mat.data_ptr(), out.data_ptr(), N, MB)
    return out


# -- kernel 11b: narrowing ---------------------------------------------------


def narrow_i16_plain(matched):
    """Plain PyTorch twin of the `narrow_i16` kernel (any device)."""
    return matched.to(torch.int16)


def narrow_i16(matched):
    """Match matrix int32 [N, lanes] -> int16 [N, lanes], each value's low
    16 bits (exact while every fid < 2^15 - 1, which the caller checks).
    Kernel `narrow_i16`; replaces `m.astype(jnp.int16)`
    (emqx_tpu/models/retained_index.py:82, router_model.py:666)."""
    kernels.check_tensor(matched, "matched", torch.int32, 2)
    if not kernels.on_cuda(matched):
        return narrow_i16_plain(matched)
    out = torch.empty_like(matched, dtype=torch.int16)  # contiguous, as matched is
    kernels.launch("narrow_i16", "emqx_narrow_i16", matched.device,
                   matched.data_ptr(), out.data_ptr(), matched.numel())
    return out


# -- one storm launch --------------------------------------------------------


def retained_step(shape_tables, nfa_tables, bytes_mat, *, m_active: int,
                  with_nfa: bool, salt: int, max_levels: int, narrow: bool):
    """One chunk of stored topics against a storm's filter tables ->
    matched [N, m_active (+ STORM_MAX_MATCHES)] fids, -1 holes; int16 when
    ``narrow``, else int32. The counterpart of `_retained_step`
    (emqx_tpu/models/retained_index.py:55): lengths derive on the device,
    the serving step runs match-only."""
    out = shape_route_step(
        shape_tables, bytes_mat, row_lengths(bytes_mat), m_active=m_active,
        salt=salt, nfa_tables=nfa_tables, with_nfa=with_nfa,
        max_levels=max_levels, frontier=STORM_FRONTIER,
        max_matches=STORM_MAX_MATCHES, probes=STORM_PROBES,
        device=bytes_mat.device,
    )
    m = out["matched"]
    return narrow_i16(m) if narrow else m


def retained_step_plain(shape_tables, nfa_tables, bytes_mat, *, m_active: int,
                        with_nfa: bool, salt: int, max_levels: int, narrow: bool):
    """`retained_step` through every kernel's plain twin (any device): the
    whole launch's reference on the card."""
    h1, h2, nw, dl = tokenize_plain(bytes_mat, row_lengths_plain(bytes_mat),
                                    salt, max_levels)
    m = shape_match_plain(shape_tables, m_active, h1, h2, nw, dl)
    if with_nfa:
        syms = vocab_lookup_plain(nfa_tables, h1, h2, STORM_PROBES)
        m2 = batch_match_syms_plain(
            nfa_tables, syms, nw, dl, frontier=STORM_FRONTIER,
            max_matches=STORM_MAX_MATCHES, probes=STORM_PROBES,
        )[0]
        m = torch.cat([m, m2], dim=1)
    return narrow_i16_plain(m) if narrow else m


class StormJob(NamedTuple):
    """A prepared replay storm, ready to ride a routed batch
    (`DeviceRouter.route_prepared(..., retained=job)`) or to run alone.

    Built on the thread that mutates the index (`prepare_storm`); the
    tensors are one generation of the chunk mirrors, which a later sync
    never writes. `decode` turns the per-chunk match matrices (numpy) into
    {filter: row-index array}."""

    index: "DeviceRetainedIndex"
    filters: List[str]
    fids: Dict[int, str]
    shape_tables: Dict[str, torch.Tensor]
    nfa_tables: Optional[Dict[str, torch.Tensor]]
    kwargs: Dict
    chunks: List[torch.Tensor]  # device chunk mirrors, uint8 [CHUNK, bucket]
    nrows: int  # live-row high-water at prepare time
    # the index's count of reused rows at prepare time (-1: unknown); while
    # it stands, every row that holds a topic holds the one it held here
    reused: int = -1

    def decode(self, matched_list) -> Dict[str, np.ndarray]:
        return self.index._decode_storm(
            self.fids, self.filters, matched_list, self.nrows
        )


class DeviceRetainedIndex:
    """The retained topics of one node, on the device, for replay storms.
    The counterpart of `DeviceRetainedIndex`
    (emqx_tpu/models/retained_index.py:110), with its mesh placement
    (`:117-156`)."""

    # retained churn is row-granular (up to `bucket` logged bytes per
    # insert or delete), so the op-log cap sits higher than the index
    # sources'
    OPLOG_MAX = 1 << 18

    def __init__(self, max_bytes: int = 64, max_levels: int = 8, mesh=None,
                 device=None):
        """`mesh`: a `parallel.mesh.Mesh` rank: the chunk mirror uploads
        this rank's 'dp' row block and storms run on the mesh's device.
        Without a mesh, `device` defaults to CUDA. On a card the kernel
        library is built and loaded here, as `Broker._device_router` does,
        so a build failure raises from the constructor and never from a
        storm whose caller would answer it from a CPU walk."""
        self.max_bytes = max_bytes  # hard cap (device-budget gate)
        self.max_levels = max_levels
        # storage width: a pow2 bucket grown to the longest stored topic
        self.bucket = min(16, max_bytes)
        self._rows: Dict[str, int] = {}  # topic -> global row
        self._by_row: List[Optional[str]] = []
        self._free: List[int] = []
        self._tombstones = 0  # live rows removed
        self._reused = 0  # freed rows a new topic took (StormJob.reused)
        self._host_b: List[np.ndarray] = []  # mirrored-array
        self.epoch = 0
        self.oplog: list = []
        self.version = 0
        self.mesh = None
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
            self.place(mesh)
        else:
            self.device = resolve_device("cuda" if device is None else device)
            self._seg = DeviceSegmentManager(self.device, name="retained")
        if self.device.type == "cuda":
            build.load()

    def place(self, mesh) -> None:
        """Serve from rank `mesh` of a ('dp', 'tp') mesh: a fresh chunk
        mirror holding this rank's 'dp' row block (its first sync is a full
        upload). For host state built before the ranks existed (a launcher
        builds the store once and forks), as JAX's constructor takes
        `mesh=`."""
        from emqx_tpu_torch.parallel.mesh import retained_placement

        self.mesh = mesh
        self.device = mesh.device
        self._seg = DeviceSegmentManager(self.device, name="retained",
                                         placement=retained_placement(mesh))

    # -- delta protocol -----------------------------------------------------
    def device_snapshot(self) -> Dict[str, np.ndarray]:
        return {f"chunk_{c}": b for c, b in enumerate(self._host_b)}

    def _bump_epoch(self) -> None:
        self.epoch += 1
        self.oplog.clear()
        self.version += 1

    def _log_resync(self, name: str) -> None:
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        self.oplog.append((RESYNC, name, 0))

    def _log_row(self, c: int, i: int) -> None:
        """Op-log one row's bytes (after the write): the scatter replays the
        whole `bucket`-wide row, trailing zeros included, so the length the
        device derives stays exact."""
        self.version += 1
        if len(self.oplog) >= self.OPLOG_MAX:
            self._bump_epoch()
            return
        row = self._host_b[c][i]
        base = i * self.bucket
        name = f"chunk_{c}"
        for b in range(self.bucket):
            self.oplog.append((name, base + b, int(row[b])))

    def _grow_bucket(self, need: int) -> None:
        nb = min(max(self.bucket, _next_pow2(need)), self.max_bytes)
        if nb == self.bucket:
            return
        for c in range(len(self._host_b)):
            new = np.zeros((CHUNK, nb), np.uint8)
            new[:, : self.bucket] = self._host_b[c]
            self._host_b[c] = new
        self.bucket = nb
        self._bump_epoch()  # every chunk changed geometry: full upload

    def __len__(self) -> int:
        return len(self._rows)

    # -- mutation ----------------------------------------------------------
    def add(self, topic: str) -> bool:
        """False when the topic does not fit the device budget (too long or
        too deep): the caller's CPU path stays authoritative for it."""
        if topic in self._rows:
            return True
        enc = topic.encode()
        if len(enc) > self.max_bytes or len(T.words(topic)) > self.max_levels:
            return False
        if len(enc) > self.bucket:
            self._grow_bucket(len(enc))
        if self._free:
            row = self._free.pop()
            self._by_row[row] = topic
            self._tombstones -= 1
            self._reused += 1
        else:
            row = len(self._by_row)
            self._by_row.append(topic)
            if row >= len(self._host_b) * CHUNK:
                self._host_b.append(np.zeros((CHUNK, self.bucket), np.uint8))
                # a fresh chunk re-uploads alone
                self._log_resync(f"chunk_{len(self._host_b) - 1}")
        self._rows[topic] = row
        c, i = divmod(row, CHUNK)
        self._host_b[c][i, : len(enc)] = np.frombuffer(enc, np.uint8)
        self._host_b[c][i, len(enc):] = 0
        self._log_row(c, i)
        return True

    def bulk_add(self, topics: List[str]) -> int:
        """Vectorised initial load; returns the count added. Topics must fit
        the device budget (raises otherwise, as `add` refuses them)."""
        fresh = [t for t in topics if t not in self._rows]
        longest = 0
        for t in fresh:
            if len(T.words(t)) > self.max_levels:
                raise ValueError(f"bulk_add: topic too deep: {t!r}")
            longest = max(longest, len(t.encode()))
        if longest > self.bucket:
            self._grow_bucket(longest)
        pos = 0
        while pos < len(fresh):
            # fill the tail of the current chunk
            row0 = len(self._by_row)
            c, i0 = divmod(row0, CHUNK)
            if c >= len(self._host_b):
                self._host_b.append(np.zeros((CHUNK, self.bucket), np.uint8))
            take = min(CHUNK - i0, len(fresh) - pos)
            batch = fresh[pos : pos + take]
            mat, _lens, too_long = encode_topics(batch, self.bucket)
            if too_long.any():
                raise ValueError("bulk_add: topic exceeds max_bytes")
            self._host_b[c][i0 : i0 + take] = mat
            # a slab write re-uploads the touched chunk instead of logging
            # CHUNK x bucket byte writes
            self._log_resync(f"chunk_{c}")
            for k, t in enumerate(batch):
                self._rows[t] = row0 + k
            self._by_row.extend(batch)
            pos += take
        return len(fresh)

    def remove(self, topic: str) -> None:
        row = self._rows.pop(topic, None)
        if row is None:
            return
        self._by_row[row] = None
        self._free.append(row)
        self._tombstones += 1
        c, i = divmod(row, CHUNK)
        self._host_b[c][i, :] = 0  # its length derives as 0
        self._log_row(c, i)

    # -- query ------------------------------------------------------------
    def _build_tables(self, filters: List[str], floor: int = 0):
        """-> (idx, fid -> filter, shape tables, nfa tables or None, launch
        kwargs) for a storm's filter set, uploaded once and never
        mirrored."""
        idx = RouteIndex()
        fids: Dict[int, str] = {}
        for f in filters:
            if len(T.words(f)) > self.max_levels:
                raise ValueError(f"filter too deep for device budget: {f}")
            fids[idx.add(f)] = f
        shape_tables = upload(idx.shapes.device_snapshot(), self.device)
        with_nfa = idx.residual_count > 0
        nfa_tables = upload(idx.nfa.device_snapshot(), self.device) if with_nfa else None
        kwargs = dict(
            m_active=idx.shapes.m_active(floor=floor) if floor else idx.shapes.m_active(),
            with_nfa=with_nfa,
            salt=idx.salt,
            max_levels=self.max_levels,
            narrow=idx.num_filters_capacity < (1 << 15) - 1,
        )
        return idx, fids, shape_tables, nfa_tables, kwargs

    def _ensure_chunks(self) -> List[torch.Tensor]:
        """Sync the chunk mirrors through the segment manager -> the device
        chunks in order. A sync that races a mutation is used for this
        storm (decode re-checks rows against live state) and never cached
        as clean (the manager's version guard)."""
        segs = self._seg.sync(self)
        return [segs[f"chunk_{c}"] for c in range(len(self._host_b))]

    def _launch_all(self, shape_tables, nfa_tables, kwargs,
                    chunks=None) -> List[torch.Tensor]:
        """One storm launch per chunk (`chunks`, else the chunks synced
        now), all before any readback; on a mesh, this rank's row blocks,
        gathered over 'dp' into whole chunks."""
        if chunks is None:
            chunks = self._ensure_chunks()
        outs = [retained_step(shape_tables, nfa_tables, d, **kwargs) for d in chunks]
        if self.mesh is None:
            return outs
        return [self.mesh.all_gather(m, "dp", "retained").reshape(-1, m.shape[1])
                for m in outs]

    def prepare_storm(self, filters: List[str]) -> Optional[StormJob]:
        """Build one storm's filter tables and sync the chunks, so that the
        storm can ride the next routed batch
        (`DeviceRouter.route_prepared(..., retained=job)`).

        None when the index is empty or a filter exceeds the device budget
        (the caller falls back to its CPU walk). Must run on the thread that
        mutates the index, as `DeviceRouter.prepare` must."""
        if any(len(T.words(f)) > self.max_levels for f in filters):
            return None
        return self.storm_job(filters)

    def storm_job(self, filters: List[str]) -> Optional[StormJob]:
        """The storm's filter tables built and uploaded and the chunks
        synced, for `run_storm` or a routed batch; None for an empty index
        (nothing can match), a raise for a filter past `max_levels`. Must
        run on the thread that mutates the index."""
        if not self._host_b:
            return None
        _idx, fids, shape_tables, nfa_tables, kwargs = self._build_tables(
            filters, floor=1
        )
        return StormJob(
            index=self,
            filters=list(filters),
            fids=fids,
            shape_tables=shape_tables,
            nfa_tables=nfa_tables,
            kwargs=kwargs,
            chunks=self._ensure_chunks(),
            nrows=len(self._by_row),
            reused=self._reused,
        )

    def run_storm(self, job: StormJob) -> Dict[str, np.ndarray]:
        """One prepared storm run alone: one launch train per chunk, every
        chunk launched before the one readback (on a mesh, this rank's row
        blocks gathered over 'dp'), then the host decode -> {filter:
        row-index array}. Syncs nothing, so it may run on a pool thread
        while the loop thread mutates the index (`broker.retained_feed`'s
        standalone flush): the job holds its own generation of the chunk
        mirrors. Its decode reads one copy of the index's freed rows (see
        `_decode_storm`), so a row may have changed topic between the sync
        and the answer: the caller turns rows into topics on the loop
        thread and, once `changed_since(job)`, checks each against its
        filter."""
        outs = self._launch_all(job.shape_tables, job.nfa_tables, job.kwargs,
                                job.chunks)
        matched_list = [m.cpu().numpy() for m in outs]
        del outs
        return job.decode(matched_list)

    def launch_stream(self):
        """The CUDA stream this thread launches on (None on the CPU): a
        pool thread that runs `run_storm` for the loop runs on it
        (`router_model.on_stream`), after the loop's chunk sync."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def match(self, filter_: str) -> Optional[List[str]]:
        """Retained topics matching `filter_`, or None when the filter
        itself exceeds the device budget (the caller falls back to its CPU
        walk: JAX's contract with the CPU retainer, not a device
        fallback)."""
        if len(T.words(filter_)) > self.max_levels:
            return None
        _idx, _fids, shape_tables, nfa_tables, kwargs = self._build_tables(
            [filter_]
        )
        outs = self._launch_all(shape_tables, nfa_tables, kwargs)
        nrows = len(self._by_row)
        out: List[str] = []
        for c, matched in enumerate(outs):
            hit_rows = np.nonzero((matched.cpu().numpy() >= 0).any(axis=1))[0]
            base = c * CHUNK
            for i in hit_rows:
                row = base + int(i)
                # padding rows (length 0) can match plen-0 filters like '#'
                t = self._by_row[row] if row < nrows else None
                # host verification: a false candidate costs a check
                if t is not None and T.match(t, filter_):
                    out.append(t)
        return out

    def warm(self, filters: List[str]) -> None:
        """Sync the chunks and run the storm's launches without reading
        anything back (there is no compile to warm: the kernels build at
        first use)."""
        _idx, _f, shape_tables, nfa_tables, kwargs = self._build_tables(
            filters, floor=1
        )
        self._launch_all(shape_tables, nfa_tables, kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def match_many(self, filters: List[str]) -> Dict[str, np.ndarray]:
        """Answer a replay STORM: many wildcard subscribes in one pass.

        Every filter enters ONE shape table; each chunk launch matches every
        stored topic against every filter (one lane per shape: within a
        shape at most one filter matches a topic). Returns {filter: global
        row-index array}; `topic_at` gives the topics. Hits are
        spot-checked on the host (sampled), as in the JAX index."""
        job = self.storm_job(filters)
        if job is None:  # empty index: nothing can match
            return {f: np.empty(0, np.int64) for f in filters}
        # every chunk launched before any readback
        out = self.run_storm(job)
        # sampled verification: one hit row of each filter
        rng = np.random.default_rng(0)
        for f, sel in out.items():
            if len(sel):
                t = self._by_row[int(rng.choice(sel))]
                assert t is None or T.match(t, f), (t, f)
        return out

    def _decode_storm(self, fids, filters: List[str], matched_list,
                      nrows: int) -> Dict[str, np.ndarray]:
        """Host decode: per-chunk match matrices (numpy) -> {filter:
        row-index array}, dropping padding rows (at or past `nrows`) and
        the rows freed by the time of the decode, as JAX's decode does.
        Device-free, so a fused batch's readback can run it wherever it
        landed. Off the loop thread it reads one copy of the freed-row list
        (taken at once under the GIL), and a row that a new topic took
        since the storm's sync is kept: the feed re-checks every topic
        against its filter on the loop thread (`RetainedStormFeed.
        _topics`)."""
        lanes = int(matched_list[0].shape[1])
        flat = np.concatenate([np.asarray(m).ravel() for m in matched_list])
        # flat index = row_g * lanes + lane; hit rows grouped by fid with
        # one stable argsort
        nhits = int(np.count_nonzero(flat >= 0))
        if nhits == flat.size and lanes == 1 and nrows == flat.size:
            # dense storm (every stored row matched)
            hits = rows_g = np.arange(flat.size, dtype=np.int64)
        else:
            hits = np.nonzero(flat >= 0)[0]
            rows_g = hits if lanes == 1 else hits // lanes
            oob = rows_g >= nrows  # padding rows can match plen-0 filters
            if oob.any():
                keep = ~oob
                hits, rows_g = hits[keep], rows_g[keep]
        dead = np.asarray(list(self._free), dtype=np.int64)
        dead = dead[dead < nrows]  # on the fused path the store may have grown
        if len(dead):
            # removed rows can still match plen-0 filters like '#' through
            # their zero length
            live = np.ones(nrows, dtype=bool)
            live[dead] = False
            keep = live[rows_g]
            hits, rows_g = hits[keep], rows_g[keep]
        hit_fids = flat[hits]
        order = np.argsort(hit_fids, kind="stable")
        rows_g = rows_g[order]
        hit_fids = hit_fids[order]
        bounds = np.nonzero(np.diff(hit_fids))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(hit_fids)]])
        out: Dict[str, np.ndarray] = {f: np.empty(0, np.int64) for f in filters}
        for s, e in zip(starts, ends):
            if e <= s:
                continue
            f = fids.get(int(hit_fids[s]))
            if f is None:
                continue
            out[f] = rows_g[s:e]
        return out

    def changed_since(self, job: StormJob) -> bool:
        """Did a freed row take a new topic since `job`'s sync? Until one
        does, each of the job's rows that still holds a topic holds the
        topic it was matched as."""
        return job.reused != self._reused

    def topic_at(self, row: int) -> Optional[str]:
        return self._by_row[row] if 0 <= row < len(self._by_row) else None
