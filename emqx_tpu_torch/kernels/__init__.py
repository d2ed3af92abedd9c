"""Hand-written CUDA kernels of the port, their launch counters, and the
checks every wrapper shares.

Each kernel lives beside its plain PyTorch twin in the module of its JAX
counterpart (`ops/tokenizer.py`, `ops/shape_index.py`, `ops/matcher.py`,
`ops/segments.py`, `ops/csr_table.py`, `ops/session_table.py`,
`ops/semantic_table.py`, `rules/compile.py`, `models/router_model.py`,
`models/retained_index.py`; the mesh's lane-based compaction and
rank-offset picks sit beside their single-device forms in
`models/router_model.py`). A
wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel (built at first use by `build.load`) and raises on any failure
— there is no fallback from one to the other.

`LAUNCHES` counts kernel launches per wrapper: `launch` adds one right
after each CUDA kernel launched, and nowhere else, so a run can show that
its path went through the kernels. A wrapper call may launch several
(`share_pick` under round_robin two, `occurrence_index` three,
`semantic_match` two: the scores and the merge,
`segment_scatter` two: the claim and the store). The pipelined publish
path launches from the event loop's thread and from the dispatch pool's
workers at once, so each count is taken under a lock and stays exact.
"""

from __future__ import annotations

import threading

import torch

from emqx_tpu_torch.kernels import build

LAUNCHES = {
    "tokenize": 0,
    "shape_match": 0,
    "fanout_bitmaps": 0,
    "compact_fanout_slots": 0,
    "vocab_lookup": 0,
    "nfa_walk": 0,
    "segment_scatter": 0,
    "sparse_fanout_slots": 0,
    "share_pick": 0,
    "occurrence_index": 0,
    "row_lengths": 0,
    "narrow_i16": 0,
    "session_sweep": 0,
    "semantic_match": 0,
    "rule_masks": 0,
}
_count_lock = threading.Lock()  # guards LAUNCHES across launching threads


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check_tensor(t, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` with `ndim` dims."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU; raises on a mix or on any other device."""
    first = tensors[0]
    if len(tensors) > 1:
        dev = first.device
        for t in tensors[1:]:
            if t.device != dev:
                devs = sorted({str(t.device) for t in tensors})
                raise ValueError(f"tensors on several devices: {devs}")
    if first.is_cuda:
        return True
    if first.is_cpu:
        return False
    raise ValueError(f"unsupported device {first.device}")


_launchers: dict = {}  # C launcher name -> its bound ctypes function
_raw_stream = None  # the current stream's handle by device index, bound at first use


def launcher(c_launcher: str):
    """-> the C launcher `c_launcher` of the kernel library, with its
    argument types bound (`build._SIGNATURES`); the library is built and
    loaded at the first call, and each launcher resolved once."""
    fn = _launchers.get(c_launcher)
    if fn is None:
        fn = _launchers[c_launcher] = getattr(build.load(), c_launcher)
    return fn


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current stream of CUDA `device`, from
    `torch._C._cuda_getCurrentRawStream` (bound at the first call), which
    builds no `torch.cuda.Stream` object."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = torch._C._cuda_getCurrentRawStream
    index = device.index
    return _raw_stream(torch.cuda.current_device() if index is None else index)


def launch(name: str, c_launcher: str, device: torch.device, *args) -> None:
    """Call one C launcher of the kernel library on the current stream of
    `device` and count its one kernel launch under `name`.

    The launcher returns the `cudaGetLastError()` code read right after
    its launch; anything but 0 raises, with the CUDA runtime's message.
    It runs on the stream of `stream_handle(device)`."""
    fn = _launchers.get(c_launcher) or launcher(c_launcher)
    rc = fn(*args, stream_handle(device))
    if rc:
        raise RuntimeError(
            f"{name}: CUDA launch failed ({rc}: {build.error_string(rc)})"
        )
    with _count_lock:
        LAUNCHES[name] += 1
