"""Gadget decompositions, batched, closed-form (carry-free), on the int32
carrier — the port of ``herdsman_tpu.ops.decomp``."""

from __future__ import annotations

import torch

from herdsman_tpu_torch.ops.u32 import srl, u32_const


def _round_top(x: torch.Tensor, W: int) -> torch.Tensor:
    """Round the u32 pattern to its top W bits: [...] -> [...] in [0, 2^W)."""
    if W >= 32:
        return x
    return srl(x + (1 << (32 - W - 1)), 32 - W)


def signed_decompose(x: torch.Tensor, bg_bits: int,
                     levels: int) -> torch.Tensor:
    """Balanced signed digits: [...] -> [..., levels] int32 in [-Bg/2, Bg/2).

    Level 0 is most significant (scale q/Bg).  Round to the top W bits, add
    the balanced offset, read digits, subtract Bg/2.
    """
    W = bg_bits * levels
    half = 1 << (bg_bits - 1)
    offset = sum(half << (bg_bits * i) for i in range(levels))
    w = _round_top(x, W) + u32_const(offset)
    digits = [srl(w, bg_bits * (levels - 1 - j)) & ((1 << bg_bits) - 1)
              for j in range(levels)]
    return torch.stack(digits, dim=-1) - half


def unsigned_decompose(x: torch.Tensor, base_bits: int,
                       levels: int) -> torch.Tensor:
    """Unsigned digits with rounding: [...] -> [..., levels] int32 in [0, base)."""
    v = _round_top(x, base_bits * levels)
    digits = [srl(v, base_bits * (levels - 1 - j)) & ((1 << base_bits) - 1)
              for j in range(levels)]
    return torch.stack(digits, dim=-1)
