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

`resolve_device` is the one place an entry point turns its `device`
argument into a torch device: CUDA unless the caller asks for the CPU, and
an error — never a quiet move to the CPU — when CUDA is asked for and
absent.
"""

from __future__ import annotations

from typing import Dict

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


def _to_device(arr: np.ndarray, name: str, device) -> torch.Tensor:
    """One host array -> a fresh tensor on `device` (always a copy: the
    host builders mutate their arrays in place)."""
    t = torch.from_numpy(_as_device_type(arr, name)).to(device, copy=True)
    return t.view(torch.bfloat16) if np.asarray(arr).dtype == BF16 else t


def upload(snapshot: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """{name: host array} -> {name: fresh tensor on `device`} of the same
    shapes and bits: int32 for the int32 and uint32 arrays, uint8 for byte
    arrays, float32 for float32 lanes, bfloat16 for `BF16` arrays."""
    dev = resolve_device(device)
    return {k: _to_device(v, k, dev) for k, v in snapshot.items()}


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
