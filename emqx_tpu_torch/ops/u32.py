"""mod-2^32 arithmetic for the plain PyTorch twins of the kernels.

PyTorch on the CPU implements neither `>>` nor `%` nor `cumsum` for
uint32, and int32 `>>` is arithmetic, so the twins carry every 32-bit
hash in an int64 lane holding a value in [0, 2^32). Products are split
so that no intermediate leaves int64's range.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any integer tensor) -> int64 lanes in [0, 2^32)."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2^32) -> the same bits as an int32 tensor."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def mul32(x: torch.Tensor, m) -> torch.Tensor:
    """(x * m) mod 2^32 for x, m in [0, 2^32) (m an int or a tensor)."""
    lo = x * (m & 0xFFFF)
    hi = (x * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3-style finalizer of `nfa._mix32`, elementwise."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)
