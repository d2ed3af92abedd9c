"""The ('dp', 'tp') mesh on torch.distributed, its placements and its
sharded serving steps: the port's counterpart of `emqx_tpu/parallel/mesh.py`.

JAX runs one program over a `jax.sharding.Mesh` through `shard_map`; the
port runs one process per shard (SPMD ranks, the counterpart of JAX's
multi-controller mode): every rank holds the same host tables, uploads its
own part of each (the placements), runs the single-device kernels on its
shard, and meets the others only in collectives:

- rank r sits at ``(dp, tp) = divmod(r, tp)``, as ``np.array(devices)
  .reshape(dp, tp)`` places JAX's devices (`make_mesh`, `:78`);
- axis ``dp`` splits the topic batch (and retained chunk rows); axis
  ``tp`` splits the subscriber table: dense bitmap lanes, or the CSR and
  semantic tables' slot-owner shards;
- the collectives are `Mesh.all_reduce` (SUM) and `Mesh.all_gather` (the
  list form), the counterparts of `psum` and `all_gather` inside
  `shard_map`; `axis_index` is a plain integer.

`COLLECTIVES` counts them per builder and per op, the counterpart of the
contracts' ``collectives=`` pins (`:177`, `:269`, `:434`, `:613`, `:626`).
The mesh's own arithmetic runs in hand-written kernels
(`models/router_model.py`): the lane-based compaction, the per-group
counts and the rank-offset round-robin picks.

The backend is the caller's: ``"nccl"`` needs one GPU a rank and refuses a
mesh with more ranks than GPUs; ``"gloo"`` runs any number of ranks on the
CPU or on CUDA tensors (staged through the host by gloo itself). Nothing
here picks or switches a backend. `parallel.launch` starts the ranks.

`dist_route_step` is the NFA-only step over the mesh (the `dist_step`
contract, `:171-261`).
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from emqx_tpu_torch.convert import Block, Replicated, resolve_device

BACKENDS = ("nccl", "gloo")
AXES = ("dp", "tp")  # both axes at once: the world group

# builder -> {"all_reduce": n, "all_gather": n}; `Mesh` adds one per call
COLLECTIVES: Dict[str, Dict[str, int]] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(builder: str, op: str) -> None:
    COLLECTIVES.setdefault(builder, {"all_reduce": 0, "all_gather": 0})[op] += 1


def factor(n: int, tp: Optional[int] = None):
    """n ranks -> (dp, tp); tp defaults to 2 when n is even and > 1, else 1
    (`make_mesh`, emqx_tpu/parallel/mesh.py:78)."""
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n < 1 or tp < 1 or n % tp:
        raise ValueError(f"{n} ranks do not factor into dp x tp with tp = {tp}")
    return n // tp, tp


def rank_device(backend: str, rank: int, world: int, device=None) -> torch.device:
    """The device rank `rank` of `world` serves from; raises on a backend
    the device cannot carry. NCCL: CUDA only, one GPU a rank (``cuda:rank``),
    so a mesh with more ranks than visible GPUs raises. gloo: the CPU when
    asked for, else CUDA, ranks spread round robin over the visible GPUs
    (all on ``cuda:0`` with one)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    want = torch.device(device) if device is not None else torch.device("cuda")
    if backend == "nccl":
        if want.type != "cuda":
            raise ValueError(f"backend 'nccl' carries CUDA tensors only, not {want}")
        resolve_device("cuda")
        n_gpu = torch.cuda.device_count()
        if world > n_gpu:
            raise ValueError(
                f"backend 'nccl' needs one GPU a rank: {world} ranks, {n_gpu} "
                "visible GPUs (ask for backend='gloo' to share a GPU)"
            )
        if want.index is not None and want.index != rank:
            raise ValueError(f"backend 'nccl': rank {rank} serves cuda:{rank}, not {want}")
        return torch.device("cuda", rank)
    if want.type == "cpu":
        return resolve_device("cpu")
    dev = resolve_device(want)
    if want.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class Mesh:
    """One rank's view of the ('dp', 'tp') mesh: its coordinates, its
    device and the process groups of its two axes (and of the world)."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 backend: str, groups: Dict):
        self.dp, self.tp = dp, tp
        self.rank = rank
        self.world = dp * tp
        self.device = device
        self.backend = backend
        self._groups = groups  # axis -> ProcessGroup (None: the world)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def axis_index(self, name: str) -> int:
        if name == "dp":
            return self.rank // self.tp
        if name == "tp":
            return self.rank % self.tp
        raise ValueError(f"axis {name!r}: 'dp' or 'tp'")

    def size(self, axis) -> int:
        return self.world if axis == AXES else self.shape[axis]

    def all_reduce(self, t: torch.Tensor, axis, builder: str) -> torch.Tensor:
        """SUM `t` in place over `axis` ("dp", "tp" or ("dp", "tp")) -> t."""
        if not t.is_contiguous():
            raise ValueError("all_reduce: the tensor must be contiguous")
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._groups[axis])
        _count(builder, "all_reduce")
        return t

    def all_gather(self, t: torch.Tensor, axis, builder: str) -> torch.Tensor:
        """`t` of every rank along `axis`, in axis order -> [n, *t.shape].
        A type gloo does not carry (int16, bool) travels as its bytes."""
        t = t.contiguous()
        raw = t.view(torch.uint8) if t.dtype in (torch.int16, torch.bool) else t
        outs = [torch.empty_like(raw) for _ in range(self.size(axis))]
        dist.all_gather(outs, raw, group=self._groups[axis])
        _count(builder, "all_gather")
        return torch.stack(outs).view(t.dtype)


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None, *,
              device=None) -> Mesh:
    """Factor the initialised process group's ranks into a ('dp', 'tp')
    mesh (`make_mesh`, emqx_tpu/parallel/mesh.py:78): the mesh spans the
    whole group, every rank calls this in the same order, and rank r sits
    at divmod(r, tp). `device` as `rank_device` takes it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (see init_mesh)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: {n} != {world}")
    dp, tp = factor(n, tp)
    backend = dist.get_backend()
    dev = rank_device(backend, rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups = {AXES: None}
    # every rank creates every group, in one order
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)]) if world > 1 else None
        if rank % tp == t:
            groups["dp"] = g
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)]) if world > 1 else None
        if rank // tp == d:
            groups["tp"] = g
    return Mesh(dp, tp, rank, dev, backend, groups)


def init_mesh(rank: int, world: int, *, backend: str, store_path: str,
              tp: Optional[int] = None, device=None,
              timeout_s: float = 300.0) -> Mesh:
    """Join a process group of `world` ranks through a `FileStore` at
    `store_path` (one fresh file per launch: parallel test runs never
    share a port), then `make_mesh`. The backend and device are checked
    before anything is joined."""
    rank_device(backend, rank, world, device)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(world, tp, device=device)


# -- placements: (name, array) -> this rank's tensor --------------------------


def table_placement(mesh: Mesh) -> Replicated:
    """Match tables (shape index, NFA, groups, storm filters): replicated."""
    return Replicated(mesh.device)


def bitmap_placement(mesh: Mesh) -> Block:
    """Dense subscriber bitmaps [Fcap, W]: lanes (axis 1) over 'tp'."""
    return Block(1, mesh.tp, mesh.axis_index("tp"), mesh.device)


def csr_placement(mesh: Mesh) -> Block:
    """CSR subscriber arrays [S, ...]: the slot-owner axis over 'tp' (the
    table holds S = tp shards, subscription -> shard slot % S). Slot ids
    are global, so shard rows need no rebase."""
    return Block(0, mesh.tp, mesh.axis_index("tp"), mesh.device)


def semantic_placement(mesh: Mesh) -> Block:
    """Semantic arrays [S, ...]: the slot-owner axis over 'tp' (the CSR
    regime: per-shard winners are global slot ids)."""
    return Block(0, mesh.tp, mesh.axis_index("tp"), mesh.device)


def retained_placement(mesh: Mesh) -> Block:
    """Retained topic chunks [CHUNK, bucket]: rows over 'dp' (CHUNK is a
    power of two, so any power-of-two dp divides it)."""
    return Block(0, mesh.dp, mesh.axis_index("dp"), mesh.device)


def session_placement(mesh: Mesh) -> Block:
    """Session table lanes (ops/session_table.py, 1-D row and slot lanes):
    blocks over 'dp' (`session_placement`, emqx_tpu/parallel/mesh.py:840;
    power-of-two capacities, so any power-of-two dp divides them). Each
    'dp' rank's mirror holds its share of the rows; a delta scatter lands
    as this rank's writes only."""
    return Block(0, mesh.dp, mesh.axis_index("dp"), mesh.device)


def batch_rows(mesh: Mesh, n: int):
    """A batch of n rows padded to a multiple of dp (`_mesh_pad`,
    emqx_tpu/models/router_model.py:2456) -> (rows a rank, this rank's
    first row)."""
    per = max(1, -(-n // mesh.dp))
    return per, mesh.axis_index("dp") * per


def place_batch(mesh: Mesh, bytes_mat, lengths):
    """A whole topic batch (numpy) -> this rank's 'dp' rows on its device,
    the batch padded with empty rows to a multiple of dp."""
    per, lo = batch_rows(mesh, len(lengths))
    bm = np.zeros((per, bytes_mat.shape[1]), np.uint8)
    ln = np.zeros(per, np.int32)
    part = slice(lo, min(lo + per, len(lengths)))
    n = max(0, part.stop - part.start)
    bm[:n] = bytes_mat[part]
    ln[:n] = lengths[part]
    return (torch.from_numpy(bm).to(mesh.device),
            torch.from_numpy(ln).to(mesh.device))


# -- the sharded serving step --------------------------------------------------


def _reduce_stats(mesh: Mesh, builder: str, out: Dict) -> Dict:
    """routed/matches are tp replicas: reduce over 'dp' only; fanout_bits
    is partial per subscriber shard: reduce over both axes
    (emqx_tpu/parallel/mesh.py:156)."""
    st = out["stats"]
    rm = torch.stack([st["routed"], st["matches"]]).to(torch.int64)
    mesh.all_reduce(rm, "dp", builder)
    fb = st["fanout_bits"].to(torch.int64).reshape(1)
    mesh.all_reduce(fb, AXES, builder)
    out["stats"] = {"routed": rm[0], "matches": rm[1], "fanout_bits": fb[0]}
    return out


def _sem_rules_local(mesh: Mesh, builder: str, out: Dict, sem_tables, q_vecs,
                     rule_feats, rule_valid, sem_topk: int, rule_progs) -> None:
    """The semantic union and the rule masks on one shard
    (emqx_tpu/parallel/mesh.py:131): this 'tp' shard's entries answer its
    'dp' rows, their winners (global slot ids) union into the shard's own
    slot rows before the 'tp' concat, and the qualifying counts sum over
    'tp'. On a mesh a row's semantic recipients are therefore the union of
    each shard's top-k, not the global top-k, exactly as in JAX."""
    from emqx_tpu_torch.ops.semantic_table import SEM_KEYS, semantic_route_stage
    from emqx_tpu_torch.rules.compile import eval_rule_masks

    dev = mesh.device
    if sem_tables is not None:
        if "slots" not in out:
            raise ValueError("semantic routing requires the compact fan-out "
                             "stage (kslot > 0 and a subscriber table)")
        q = torch.as_tensor(q_vecs, dtype=torch.float32, device=dev).contiguous()
        out["slots"], count = semantic_route_stage(
            {k: sem_tables[k] for k in SEM_KEYS}, q, out["matched"], sem_topk,
            out["slots"])
        out["sem_count"] = mesh.all_reduce(count.contiguous(), "tp", builder)
    if rule_progs:
        out["rule_masks"] = eval_rule_masks(
            rule_progs,
            torch.as_tensor(rule_feats, dtype=torch.float32, device=dev).contiguous(),
            torch.as_tensor(rule_valid, dtype=torch.bool, device=dev).contiguous(),
        )


def _local_step(mesh: Mesh, builder: str, shape_tables, nfa_tables, sub_bitmaps,
                bytes_mat, lengths, group_tables, client_hash, topic_hash, rand,
                sem_tables, q_vecs, rule_feats, rule_valid, *, m_active, salt,
                max_levels, frontier, max_matches, probes, share_strategy,
                kslot, kg, sem_topk, rule_progs) -> Dict:
    from emqx_tpu_torch.models.router_model import (
        compact_fanout_slots_shard,
        shape_route_step,
    )

    sparse = isinstance(sub_bitmaps, dict)
    tables = dict(shape_tables)
    if sparse:
        tables.update(sub_bitmaps)
    else:
        tables["sub_bitmaps"] = sub_bitmaps
    with_groups = group_tables is not None
    out = shape_route_step(
        tables, bytes_mat, lengths, m_active=m_active, salt=salt,
        nfa_tables=nfa_tables, with_nfa=nfa_tables is not None,
        group_tables=group_tables, client_hash=client_hash,
        topic_hash=topic_hash, rand=rand, with_groups=with_groups,
        share_strategy=share_strategy, max_levels=max_levels,
        frontier=frontier, max_matches=max_matches, probes=probes,
        kslot=kslot if sparse else 0, kg=kg,
        dp_gather=(lambda c: mesh.all_gather(c, "dp", builder)) if with_groups else None,
        dp_rank=mesh.axis_index("dp"), device=mesh.device,
    )
    if kslot:
        if sparse:
            # the CSR gather already wrote global slot ids; sum the
            # per-shard counts and overflows over 'tp'
            pair = torch.stack([out["slot_count"], out["overflow"].to(torch.int32)])
        else:
            w_local = out["bitmaps"].shape[1]
            out["slots"], pair = compact_fanout_slots_shard(
                out["bitmaps"], kslot, mesh.axis_index("tp") * w_local * 32)
        mesh.all_reduce(pair, "tp", builder)
        # a row overflows when ANY shard's local fan-out passed kslot
        out["slot_count"], out["overflow"] = pair[0], pair[1] > 0
    _sem_rules_local(mesh, builder, out, sem_tables, q_vecs, rule_feats,
                     rule_valid, sem_topk, rule_progs)
    return _reduce_stats(mesh, builder, out)


def dist_route_step(mesh: Mesh, tables: Dict, sub_bitmaps, bytes_mat, lengths, *,
                    salt: int, max_levels: int = 16, frontier: int = 32,
                    max_matches: int = 64, probes: int = 8) -> Dict:
    """One rank's share of the NFA-only route step over the mesh
    (`dist_route_step`, emqx_tpu/parallel/mesh.py:219, built at
    `:171-216` as the `dist_step` contract).

    Layout, as JAX's shard_map specs place it: `tables`, the NFA tables,
    replicated (`table_placement`); `sub_bitmaps` this rank's dense lane
    slice [Fcap, W / tp] (`bitmap_placement`); bytes_mat / lengths this
    rank's 'dp' rows (`place_batch`). Each rank runs `route_step` with no
    compaction (JAX's `_dist_step_fn` passes no kslot) and returns its
    blocks of JAX's outputs (`_out_specs()`, `:107`): matched / mcount /
    flags for its 'dp' rows (tp replicas), bitmaps [B / dp, W / tp] for
    its ('dp', 'tp') block, and the stats reduced by `_reduce_stats`:
    two all-reduces a batch under the builder name ``dist_step`` (routed
    and matches over 'dp', fanout_bits over the mesh)."""
    from emqx_tpu_torch.models.router_model import route_step

    out = route_step(tables, sub_bitmaps, bytes_mat, lengths, salt=salt,
                     max_levels=max_levels, frontier=frontier,
                     max_matches=max_matches, probes=probes, device=mesh.device)
    return _reduce_stats(mesh, "dist_step", out)


def step_builder(sub_bitmaps, sem_tables, fused: bool = False) -> str:
    """The JAX contract name of the program a call corresponds to."""
    if fused:
        return "dist_fused_step"
    if isinstance(sub_bitmaps, dict):
        return "sparse_dist_shape_step"
    return "sem_dist_shape_step" if sem_tables is not None else "dist_shape_step"


def dist_shape_route_step(
    mesh: Mesh, shape_tables: Dict, nfa_tables: Optional[Dict], sub_bitmaps,
    bytes_mat, lengths, group_tables: Optional[Dict] = None, client_hash=None,
    topic_hash=None, rand=None, sem_tables: Optional[Dict] = None, q_vecs=None,
    rule_feats=None, rule_valid=None, *, m_active: int, salt: int,
    max_levels: int = 16, frontier: int = 32, max_matches: int = 64,
    probes: int = 8, share_strategy: int = 0, kslot: int = 0, kg: int = 0,
    sem_topk: int = 0, rule_progs: tuple = (),
) -> Dict:
    """One rank's share of the distributed serving step
    (emqx_tpu/parallel/mesh.py:717, built at `:279-423`).

    Every table argument is this rank's placed tensors: shape, NFA and
    group tables replicated; `sub_bitmaps` the dense lane slice [Fcap,
    W / tp] or the CSR arrays' 'tp' shard (a dict of `CSR_KEYS`);
    `sem_tables` the semantic table's 'tp' shard; the batch inputs and the
    per-row pick inputs, query vectors and rule features this rank's 'dp'
    rows (`place_batch`). Returns this rank's block of JAX's global
    outputs (`_out_specs`, `:107-128`): matched / mcount / flags / picks /
    sem_count / rule masks for its 'dp' rows (tp replicas); with
    ``kslot > 0`` its slot segment [B / dp, kslot (+ topk)] of global slot
    ids, and slot_count / overflow reduced over 'tp'; stats reduced over
    the mesh (`_reduce_stats`). `MeshServingRouter` assembles the global
    result from every rank's block."""
    builder = step_builder(sub_bitmaps, sem_tables)
    return _local_step(
        mesh, builder, shape_tables, nfa_tables, sub_bitmaps, bytes_mat,
        lengths, group_tables, client_hash, topic_hash, rand, sem_tables,
        q_vecs, rule_feats, rule_valid, m_active=m_active, salt=salt,
        max_levels=max_levels, frontier=frontier, max_matches=max_matches,
        probes=probes, share_strategy=share_strategy, kslot=kslot, kg=kg,
        sem_topk=sem_topk, rule_progs=rule_progs)


def dist_fused_route_step(
    mesh: Mesh, shape_tables: Dict, nfa_tables: Optional[Dict], sub_bitmaps,
    bytes_mat, lengths, ret_shape_tables: Dict, ret_nfa_tables: Optional[Dict],
    ret_bytes, group_tables: Optional[Dict] = None, client_hash=None,
    topic_hash=None, rand=None, sem_tables: Optional[Dict] = None, q_vecs=None,
    rule_feats=None, rule_valid=None, *, m_active: int, salt: int,
    ret_m_active: int, ret_with_nfa: bool, ret_salt: int, ret_max_levels: int,
    ret_narrow: bool, max_levels: int = 16, frontier: int = 32,
    max_matches: int = 64, probes: int = 8, share_strategy: int = 0,
    kslot: int = 0, kg: int = 0, sem_topk: int = 0, rule_progs: tuple = (),
) -> Dict:
    """`dist_shape_route_step` plus a retained storm's chunk in the same
    call (emqx_tpu/parallel/mesh.py:636, built at `:443-598`): the storm's
    filter tables replicated, `ret_bytes` this rank's 'dp' block of the
    chunk's rows; ``out["retained"]`` is its block of the match matrix
    (int16 when ``ret_narrow``). The retained half needs no collective."""
    from emqx_tpu_torch.models.retained_index import retained_step

    out = _local_step(
        mesh, step_builder(sub_bitmaps, sem_tables, fused=True), shape_tables,
        nfa_tables, sub_bitmaps, bytes_mat, lengths, group_tables, client_hash,
        topic_hash, rand, sem_tables, q_vecs, rule_feats, rule_valid,
        m_active=m_active, salt=salt, max_levels=max_levels, frontier=frontier,
        max_matches=max_matches, probes=probes, share_strategy=share_strategy,
        kslot=kslot, kg=kg, sem_topk=sem_topk, rule_progs=rule_progs)
    out["retained"] = retained_step(
        ret_shape_tables, ret_nfa_tables, ret_bytes, m_active=ret_m_active,
        with_nfa=ret_with_nfa, salt=ret_salt, max_levels=ret_max_levels,
        narrow=ret_narrow)
    return out
