"""The plaintext answers of the benchmark's plans, in plain
PyTorch, and the bit layout of a row of a frame.

A row of a frame holds its columns' bits in declaration order, each column
least significant bit first; an UINT8 column has 8 bits, a BIT column 1.
"""

from __future__ import annotations

import torch


def to_bits(values: torch.Tensor, width: int) -> torch.Tensor:
    """[...] integers -> [..., width] bits, least significant first."""
    shifts = torch.arange(width, device=values.device)
    return (values[..., None] >> shifts) & 1


def row_bits(columns: list[torch.Tensor], widths: list[int]) -> torch.Tensor:
    """Columns of R values each -> [R, sum(widths)] bits."""
    return torch.cat([to_bits(c, w) for c, w in zip(columns, widths)],
                     dim=-1)


def parity(x: torch.Tensor) -> torch.Tensor:
    return to_bits(x, 8).sum(-1) & 1


def xor_parity(a: torch.Tensor, b: torch.Tensor) -> dict[str, torch.Tensor]:
    """The map stage of the batch plan: x = a XOR b, odd = parity(x)."""
    x = a ^ b
    return {"x": x, "odd": parity(x)}


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """The bitwise XOR of all values (the reduce stage of the batch plan)."""
    bits = to_bits(x, 8).sum(0) & 1
    return (bits << torch.arange(8, device=x.device)).sum()


def add8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 8-bit ripple adder's sum: (a + b) mod 256."""
    return (a + b) & 0xFF
