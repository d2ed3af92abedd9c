"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every source under `csrc/` is compiled by its own `nvcc` process, all
started together, into an object file for `sm_90a`; one more `nvcc` links
them into a shared library with a plain C interface, loaded with `ctypes`.
No source includes PyTorch's headers: the wrappers hand over
`tensor.data_ptr()` and the current stream as integers, which keeps a
cold build to seconds instead of the minutes a `torch/extension.h`
translation unit costs.

The library lands in `kernels/_build/` (ignored by git), named by a hash
of the sources and flags, so a second process in the same checkout reuses
it and a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "--ptxas-options=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_longlong
_Q = ctypes.c_ulonglong

# C launcher -> argument types; every launcher returns the cudaError_t
# read right after its launch
_SIGNATURES = {
    # bytes, lengths, h1, h2, nwords, is_dollar, B, MB, L, seed1, seed2, stream
    "emqx_tokenize": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _P),
    # h1, h2, nwords, dollar, mask, len, flags, tab, tcap, hot, hcap, tomb,
    # out, B, L, M, probes, stream
    "emqx_shape_match": (
        _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _P,
    ),
    # sub_bitmaps, fcap, matched, out, popcount, B, K, W, streaming, stream
    "emqx_fanout_bitmaps": (_P, _L, _P, _P, _P, _I, _I, _I, _I, _P),
    # bitmaps, slots, count, overflow, pair, B, W, kslot, lane_base, stream
    "emqx_compact_fanout_slots": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # h1, h2, vocab_h1, vocab_h2, vocab_sym, V, sym, n, probes, stream
    "emqx_vocab_lookup": (_P, _P, _P, _P, _P, _L, _P, _L, _I, _P),
    # syms, nwords, dollar, plus_child, hash_filter, term_filter, edge_node,
    # edge_sym, edge_child, E, matched, mcount, flags, B, L, F, K, probes,
    # stream
    "emqx_nfa_walk": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    # buf (A pointers, widths, offsets; indices; value bits), A, n, hash
    # table, cap, stream
    "emqx_scatter_claim": (_P, _I, _L, _P, _L, _P),
    "emqx_scatter_store": (_P, _I, _L, _P, _L, _P),
    # csr_off, csr_len, F, csr_slots, P, hot_fid, hot_slot, H, matched,
    # slots, count, overflow, live, B, K, kslot, kg, stream
    "emqx_sparse_fanout_slots": (
        _P, _P, _L, _P, _L, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
    # filter_groups, Fcap, GPF, group_len, group_rr, group_sticky, Gcap,
    # matched, occ, client_hash, topic_hash, rand, pick_gid, pick_idx, B,
    # K, strategy, phase, all_counts, dp_rank, stream
    "emqx_share_pick": (
        _P, _L, _I, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _P, _I, _P,
    ),
    # gids, n, gcap, sub-tiles a tile, counts, counts' words, occ, stream
    "emqx_occ_count": (_P, _L, _L, _I, _P, _L, _P, _P),
    # n, gcap, sub-tiles a tile, counts, counts' words, totals (or null),
    # stream
    "emqx_occ_scan": (_L, _L, _I, _P, _L, _P, _P),
    # gids, n, gcap, sub-tiles a tile, counts, counts' words, occ, stream
    "emqx_occ_add": (_P, _L, _L, _I, _P, _L, _P, _P),
    # bytes, out, N, MB, stream
    "emqx_row_lengths": (_P, _P, _L, _I, _P),
    # in, out, n, stream
    "emqx_narrow_i16": (_P, _P, _L, _P),
    # slot, state, ts, cap, expiry, scap, now, retry, scratch, base, epoch,
    # due, expired, counts, sweep_k, stream
    "emqx_session_sweep": (
        _P, _P, _P, _L, _P, _L, _I, _I, _P, _Q, _Q, _P, _P, _P, _I, _P,
    ),
    # q, q_bf16 scratch, vec_p, P, vec_h, H, bf16, fid_p, slot_p, th_p,
    # fid_h, slot_h, th_h, matched, B, K, D, topk, S, tiles_per_split,
    # cand_s, cand_i, part, stream
    "emqx_semantic_scores": (
        _P, _P, _P, _L, _P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _I, _L, _P, _P, _P, _P,
    ),
    # cand_s, cand_i, part, S, slot_p, P, slot_h, topic slots, kslot, B,
    # topk, out, count, stream
    "emqx_semantic_merge": (_P, _P, _P, _I, _P, _L, _P, _P, _I, _I, _I, _P, _P, _P),
    # slots, kslot, sem_slots, topk, B, out, stream
    "emqx_semantic_union": (_P, _I, _P, _I, _I, _P, _P),
    # words (codes, offsets, rule order, literals), code words, R, words,
    # depth, feats, valid, B, F, out, stream
    "emqx_rule_masks": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P),
}


class KernelBuildError(RuntimeError):
    """The kernel library could not be built or loaded (no nvcc, a compile
    or link error, a library that will not load). A fault of the
    checkout, not of the device: the broker's degrade ladder, which
    serves a batch from the CPU when a launch or a sync raises, re-raises
    this one instead."""


_lib = None  # the loaded library (the port's one extension handle)
_load_lock = threading.Lock()  # one build and load when threads race to it


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise with the first failure's output."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT))
        for cmd in cmds
    ]
    logs = []
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out.decode(errors="replace"))
        if proc.returncode != 0 and failed is None:
            failed = (cmd, logs[-1])
    if failed is not None:
        raise KernelBuildError(
            f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}"
        )
    return logs


def _build(target: Path) -> None:
    nvcc = nvcc_path()
    work = BUILD_DIR / f"work-{target.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / (src.stem + ".o") for src in _sources()]
    logs = _run_all(
        [
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            for src, obj in zip(_sources(), objs)
        ]
    )
    tmp = work / target.name
    logs += _run_all(
        [[nvcc, NVCC_FLAGS[0], "-shared", "-Xcompiler", "-fPIC", *map(str, objs),
          "-o", str(tmp)]]
    )
    (BUILD_DIR / (target.stem + ".log")).write_text("".join(logs))
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)


def library_path() -> Path:
    """-> the built library's path, building it first if this checkout's
    sources have none yet. Runs `nvcc` only and makes no CUDA call, so a
    process that forks workers (`parallel.launch`) builds once, before the
    fork, and every worker only loads."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libemqx_kernels-{_tag()}.so"
    if not target.exists():
        _build(target)
    return target


def load():
    """-> the ctypes library with every launcher bound (built if needed)."""
    if _lib is not None:
        return _lib
    with _load_lock:
        return _lib if _lib is not None else _load()


def _load():  # holds-lock: _load_lock
    global _lib
    path = library_path()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.emqx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.emqx_cuda_error_string.restype = ctypes.c_char_p
    lib.emqx_sweep_blocks.argtypes = [_L, _L]
    lib.emqx_sweep_blocks.restype = _L
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return load().emqx_cuda_error_string(code).decode()
