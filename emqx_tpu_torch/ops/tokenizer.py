"""Topic tokenization: the port's copy of `emqx_tpu/ops/tokenizer.py`.

Host half (numpy, bit for bit as in the JAX package): `encode_topics` packs
a batch of topics into a zero-padded uint8 matrix, and `tokenize_host_np`
hashes a bulk load of filters.

Device half: `tokenize` splits every row into its level words and hashes
each word into the pair (h1, h2) that `nfa.word_hash_pair` defines. On a
CUDA tensor it launches the hand-written kernel `kernels/csrc/tokenize.cu`;
on a CPU tensor it runs `tokenize_plain`, the straightforward PyTorch
version of the same function. The JAX package computes the word hashes
from prefix sums with inverse powers (a TPU has no cheap per-byte
recurrence); both versions here use the equal per-word Horner form of
`nfa._poly_raw` instead. `vocab_lookup` turns the word-hash pairs into the
residual NFA's symbol ids (kernel `kernels/csrc/vocab_lookup.cu`, twin
`vocab_lookup_plain`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np

import torch

from emqx_tpu_torch import kernels
from emqx_tpu_torch.ops.nfa import P1, P2, VOCAB_H_MUL, VOCAB_H_SHIFT, _SALT1, _SALT2
from emqx_tpu_torch.ops.u32 import M32, mix32, mul32, to_i32, u32

SLASH = np.uint8(ord("/"))
DOLLAR = np.uint8(ord("$"))


def _inv_mod_2_32(p: int) -> int:
    """Modular inverse of odd p mod 2^32 via Newton iteration."""
    x = p  # 3-bit correct
    for _ in range(5):
        x = (x * (2 - p * x)) & 0xFFFFFFFF
    assert (x * p) & 0xFFFFFFFF == 1
    return x


@lru_cache(maxsize=8)
def _pow_tables(max_bytes: int) -> Tuple[np.ndarray, ...]:
    """P^i and P^-i tables, i in [0, max_bytes], for both primes."""
    out = []
    for P in (int(P1), int(P2)):
        inv = _inv_mod_2_32(P)
        pw = np.empty(max_bytes + 1, dtype=np.uint32)
        ipw = np.empty(max_bytes + 1, dtype=np.uint32)
        a = b = 1
        for i in range(max_bytes + 1):
            pw[i] = a
            ipw[i] = b
            a = (a * P) & 0xFFFFFFFF
            b = (b * inv) & 0xFFFFFFFF
        out += [pw, ipw]
    return tuple(out)


class TopicRef(NamedTuple):
    """A topic's bytes IN PLACE inside a shared read slab (the fabric
    frame body): `buf` is the flat uint8 view of the whole slab, the
    topic is buf[off:off+ln]. `encode_topics` gathers every ref sharing
    a slab into the topic matrix with ONE vectorized pass — the
    zero-copy seam between transport/fabric.py and the device tokenizer
    (no str decode, no per-row copy)."""

    buf: np.ndarray
    off: int
    ln: int

    def tobytes(self) -> bytes:
        return self.buf[self.off : self.off + self.ln].tobytes()

    def __str__(self) -> str:
        return self.tobytes().decode("utf-8", "surrogatepass")


def _fill_from_slab(mat, lens, too_long, buf, rows, offs, lns, max_bytes):
    """One gather fills every row backed by the same slab buffer."""
    rows = np.asarray(rows, np.int64)
    offs = np.asarray(offs, np.int64)
    lns = np.asarray(lns, np.int64)
    if buf.size == 0:
        return  # degenerate slab: rows keep their zero fill
    tl = lns > max_bytes
    eff = np.minimum(lns, max_bytes)
    cols = np.arange(max_bytes, dtype=np.int64)
    idx = offs[:, None] + cols[None, :]
    valid = cols[None, :] < eff[:, None]
    np.clip(idx, 0, max(buf.size - 1, 0), out=idx)
    mat[rows] = buf[idx] * valid
    lens[rows] = eff
    too_long[rows] = tl


def encode_topics(
    topics: List[bytes | str], max_bytes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack topics into a zero-padded uint8 matrix.

    -> (bytes_mat uint8 [B, max_bytes], lengths int32 [B], too_long bool [B]).
    Too-long topics are truncated and flagged (host falls back to the CPU
    trie for those rows; cf. 64KB cap at emqx_topic.erl ?MAX_TOPIC_LEN).

    `TopicRef` entries (zero-copy ingest: topic bytes still sitting in a
    fabric read slab) are grouped per backing buffer and gathered into
    the matrix with one vectorized indexed read per slab — the common
    serving batch (one PUBB frame) fills in a single pass.
    """
    B = len(topics)
    mat = np.zeros((B, max_bytes), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    too_long = np.zeros(B, dtype=bool)
    slabs: dict = {}
    for i, t in enumerate(topics):
        if isinstance(t, TopicRef):
            g = slabs.get(id(t.buf))
            if g is None:
                g = slabs[id(t.buf)] = (t.buf, [], [], [])
            g[1].append(i)
            g[2].append(t.off)
            g[3].append(t.ln)
            continue
        b = t.encode("utf-8", "surrogatepass") if isinstance(t, str) else t
        n = len(b)
        if n > max_bytes:
            too_long[i] = True
            n = max_bytes
        mat[i, :n] = np.frombuffer(b[:n], dtype=np.uint8)
        lens[i] = n
    for buf, rows, offs, lns in slabs.values():
        _fill_from_slab(mat, lens, too_long, buf, rows, offs, lns,
                        max_bytes)
    return mat, lens, too_long


def _seeds(salt: int) -> Tuple[int, int]:
    """Per-salt xor seeds of the two word hashes (`nfa.word_hash_pair`)."""
    return (
        (int(salt) * int(_SALT1) + 1) & M32,
        (int(salt) * int(_SALT2) + 7) & M32,
    )


def tokenize_plain(bytes_mat, lengths, salt: int, max_levels: int):
    """Plain PyTorch twin of the `tokenize` kernel (same outputs, any device).

    A per-word Horner walk over the columns: column j extends the hash of
    the word it belongs to (its index is the count of separators before
    it); words at or past `max_levels` accumulate in a discard column.
    """
    B, MB = bytes_mat.shape
    L = max_levels
    dev = bytes_mat.device
    c = bytes_mat.to(torch.int64)
    n = lengths.to(torch.int64).clamp(0, MB)
    cols = torch.arange(MB, device=dev)
    inb = cols[None, :] < n[:, None]
    issep = inb & (c == ord("/"))
    ischar = inb & ~issep
    sep = issep.to(torch.int64)
    word = (torch.cumsum(sep, dim=1) - sep).clamp(max=L)  # L = discard
    acc1 = torch.ones((B, L + 1), dtype=torch.int64, device=dev)
    acc2 = torch.ones((B, L + 1), dtype=torch.int64, device=dev)
    for j in range(MB):
        wj = word[:, j : j + 1]
        keep = ischar[:, j : j + 1]
        cj = c[:, j : j + 1]
        for acc, P in ((acc1, int(P1)), (acc2, int(P2))):
            cur = acc.gather(1, wj)
            nxt = (mul32(cur, P) + cj) & M32
            acc.scatter_(1, wj, torch.where(keep, nxt, cur))
    nwords = sep.sum(dim=1) + 1
    seed1, seed2 = _seeds(salt)
    valid = torch.arange(L, device=dev)[None, :] < nwords.clamp(max=L)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    h1 = torch.where(valid, mix32(acc1[:, :L] ^ seed1), zero)
    h2 = torch.where(valid, mix32(acc2[:, :L] ^ seed2), zero)
    is_dollar = (lengths > 0) & (bytes_mat[:, 0] == ord("$"))
    return to_i32(h1), to_i32(h2), nwords.to(torch.int32), is_dollar


def tokenize(bytes_mat, lengths, salt: int, max_levels: int):
    """Topic bytes -> per-level word-hash pairs (kernel 1).

    bytes_mat uint8 [B, MB], lengths int32 [B] (<= MB, as `encode_topics`
    makes them) -> (h1 [B, L] int32 holding uint32 bits, h2 likewise,
    nwords int32 [B], is_dollar bool [B]). Rows deeper than `max_levels`
    report their true nwords; hashes at or past nwords are 0. The
    counterpart of `tokenize_device` (emqx_tpu/ops/tokenizer.py:147).
    """
    kernels.check_tensor(bytes_mat, "bytes_mat", torch.uint8, 2)
    kernels.check_tensor(lengths, "lengths", torch.int32, 1)
    B, MB = bytes_mat.shape
    if lengths.shape[0] != B:
        raise ValueError(f"lengths: expected [{B}], got {tuple(lengths.shape)}")
    if max_levels < 1:
        raise ValueError(f"max_levels must be >= 1, got {max_levels}")
    if not kernels.on_cuda(bytes_mat, lengths):
        return tokenize_plain(bytes_mat, lengths, salt, max_levels)
    L = max_levels
    dev = bytes_mat.device
    h1 = torch.empty((B, L), dtype=torch.int32, device=dev)
    h2 = torch.empty((B, L), dtype=torch.int32, device=dev)
    nwords = torch.empty(B, dtype=torch.int32, device=dev)
    is_dollar = torch.empty(B, dtype=torch.bool, device=dev)
    seed1, seed2 = _seeds(salt)
    kernels.launch(
        "tokenize",
        "emqx_tokenize",
        dev,
        bytes_mat.data_ptr(),
        lengths.data_ptr(),
        h1.data_ptr(),
        h2.data_ptr(),
        nwords.data_ptr(),
        is_dollar.data_ptr(),
        B,
        MB,
        L,
        seed1,
        seed2,
    )
    return h1, h2, nwords, is_dollar


def vocab_lookup_plain(tables, h1, h2, probes: int):
    """Plain PyTorch twin of the `vocab_lookup` kernel (any device): the
    probe loop of `vocab_lookup_device` (emqx_tpu/ops/tokenizer.py:294),
    first live hit wins (tombstones, vocab_sym -3, never hit)."""
    V = tables["vocab_sym"].shape[0]
    a1, a2 = u32(h1), u32(h2)
    h = mul32(a1, VOCAB_H_MUL)
    h = h ^ (h >> VOCAB_H_SHIFT)
    th1, th2 = u32(tables["vocab_h1"]), u32(tables["vocab_h2"])
    tsym = tables["vocab_sym"]
    sym = torch.full(h1.shape, -1, dtype=torch.int32, device=h1.device)
    found = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    for p in range(probes):
        idx = (h + p) & (V - 1)
        hit = (th1[idx] == a1) & (th2[idx] == a2) & (tsym[idx] >= 0) & ~found
        sym = torch.where(hit, tsym[idx], sym)
        found |= hit
    return sym


def vocab_lookup(tables, h1, h2, probes: int):
    """Word-hash pairs -> residual-NFA symbol ids (kernel `vocab_lookup`).

    tables: the NFA device dict (`vocab_h1`, `vocab_h2` int32 [V] holding
    uint32 bits, `vocab_sym` int32 [V], V a power of two); h1, h2 int32
    [B, L] from `tokenize` -> sym int32 [B, L] (-1 = out of vocabulary).
    Every lane is looked up, those past a row's depth included, as in the
    counterpart `vocab_lookup_device` (emqx_tpu/ops/tokenizer.py:294).
    On CUDA a lane reads each probe's three words together and stops at
    its first hit or at its first never-written slot (vocab_sym -1), which
    equals the twin on every table an `NfaBuilder` makes: none holds a
    live word behind a -1 within its probe window
    (`kernels/csrc/vocab_lookup.cu`).
    """
    for k in ("vocab_h1", "vocab_h2", "vocab_sym"):
        kernels.check_tensor(tables[k], k, torch.int32, 1)
    kernels.check_tensor(h1, "h1", torch.int32, 2)
    kernels.check_tensor(h2, "h2", torch.int32, 2)
    V = tables["vocab_sym"].shape[0]
    if V < 1 or V & (V - 1):
        raise ValueError(f"vocab_sym: length must be a power of two, got {V}")
    if tables["vocab_h1"].shape[0] != V or tables["vocab_h2"].shape[0] != V:
        raise ValueError("vocab_h1, vocab_h2 and vocab_sym disagree in length")
    if h2.shape != h1.shape:
        raise ValueError("h1 and h2 disagree in shape")
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    args = [tables["vocab_h1"], tables["vocab_h2"], tables["vocab_sym"], h1, h2]
    if not kernels.on_cuda(*args):
        return vocab_lookup_plain(tables, h1, h2, probes)
    sym = torch.empty(h1.shape, dtype=torch.int32, device=h1.device)
    kernels.launch(
        "vocab_lookup",
        "emqx_vocab_lookup",
        h1.device,
        h1.data_ptr(),
        h2.data_ptr(),
        tables["vocab_h1"].data_ptr(),
        tables["vocab_h2"].data_ptr(),
        tables["vocab_sym"].data_ptr(),
        V,
        sym.data_ptr(),
        h1.numel(),
        probes,
    )
    return sym


def tokenize_host_np(bytes_mat, lengths, salt: int, max_levels: int):
    """Numpy mirror of `tokenize`, bit-for-bit.

    The vectorized host half of bulk subscription loads: computing a
    million filters' word hashes one Python call at a time
    (nfa.word_hash_pair) is the cold-start bottleneck; this produces the
    same (h1, h2, nwords, is_dollar) — plus the word extents the shape
    compiler needs — with a handful of numpy passes.

    Returns (h1, h2, nwords, is_dollar, wstart, wlen); all uint32/int32
    arrays shaped like the device variant's.
    """
    B, MB = bytes_mat.shape
    L = max_levels
    pw1, ipw1, pw2, ipw2 = _pow_tables(MB)
    cols = np.arange(MB, dtype=np.int32)
    inb = cols[None, :] < lengths[:, None]
    c = bytes_mat.astype(np.uint32)
    issep = inb & (bytes_mat == SLASH)
    ischar = inb & ~issep
    segex = np.cumsum(issep, axis=1, dtype=np.int32) - issep.astype(np.int32)
    rows = np.arange(B, dtype=np.int32)[:, None]

    with np.errstate(over="ignore"):
        u1 = np.where(ischar, c * ipw1[cols][None, :], np.uint32(0))
        u2 = np.where(ischar, c * ipw2[cols][None, :], np.uint32(0))
        U1 = np.cumsum(u1, axis=1, dtype=np.uint32)
        U2 = np.cumsum(u2, axis=1, dtype=np.uint32)

        # slot L is the discard bucket (device uses scatter mode="drop");
        # separators past L words clip into it
        sep_slot = np.minimum(np.where(issep, segex, L), L)
        sepcol = np.full((B, L + 1), -1, dtype=np.int32)
        sepcol[rows, sep_slot] = np.broadcast_to(cols[None, :], (B, MB))
        sepcol = sepcol[:, :L]
        k = np.arange(L, dtype=np.int32)[None, :]
        nsep = np.sum(issep, axis=1).astype(np.int32)
        nwords = nsep + 1
        has_sep = sepcol >= 0
        wend = np.where(has_sep, sepcol - 1, lengths[:, None] - 1)
        prev_sep = np.concatenate(
            [np.full((B, 1), -1, dtype=np.int32), sepcol[:, : L - 1]], axis=1
        )
        wstart = prev_sep + 1
        wlen = wend - wstart + 1

        def word_hash(U, pw, salt_mul, salt_add):
            e = np.clip(wend, 0, MB - 1)
            s0 = np.clip(wstart - 1, 0, MB - 1)
            Ue = np.take_along_axis(U, e, axis=1)
            Us = np.where(
                wstart > 0,
                np.take_along_axis(U, s0, axis=1),
                np.uint32(0),
            )
            raw = (Ue - Us) * pw[e] + pw[np.clip(wlen, 0, MB)]
            seed = np.uint32(
                (int(salt) * int(salt_mul) + salt_add) & 0xFFFFFFFF
            )
            x = raw ^ seed
            x ^= x >> np.uint32(16)
            x = x * np.uint32(0x7FEB352D)
            x ^= x >> np.uint32(15)
            x = x * np.uint32(0x846CA68B)
            x ^= x >> np.uint32(16)
            return x

        h1 = word_hash(U1, pw1, int(_SALT1), 1)
        h2 = word_hash(U2, pw2, int(_SALT2), 7)
    valid_word = k < np.minimum(nwords, L)[:, None]
    h1 = np.where(valid_word, h1, np.uint32(0))
    h2 = np.where(valid_word, h2, np.uint32(0))
    is_dollar = (lengths > 0) & (bytes_mat[:, 0] == DOLLAR)
    return h1, h2, nwords, is_dollar, wstart, wlen
