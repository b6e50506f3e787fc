"""Negacyclic polynomial primitives over Z_{2^32}[X]/(X^N+1), batched, exact.

The negacyclic product (u * p) is a Toeplitz matrix product:
    (u * p)[c] = sum_r u[r] * T(p)[r, c],   T(p)[r, c] = ext(p)[(c - r) mod 2N]
with ext(p) = concat(p, -p).  Tensors are the int32 carrier of ``ops.u32``;
the int8-limb products split operands into balanced signed base-256 limbs
whose products accumulate exactly in int32.
"""

from __future__ import annotations

import torch

from herdsman_tpu_torch.ops.u32 import srl, u32_const

I32 = torch.int32
I8 = torch.int8


def negacyclic_extend(p: torch.Tensor) -> torch.Tensor:
    """ext(p) = concat(p, -p) along the last axis: [..., N] -> [..., 2N]."""
    return torch.cat([p, -p], dim=-1)


def to_i8_limbs(x: torch.Tensor) -> torch.Tensor:
    """Balanced signed base-256 limbs of u32: [...] -> [..., 4] int8.

    x == sum_j limbs[..., j] * 256^j  (mod 2^32), limbs in [-128, 127].
    """
    u = x + u32_const(0x80808080)
    limbs = torch.stack([srl(u, 8 * j) & 0xFF for j in range(4)], dim=-1)
    return (limbs - 128).to(I8)


def from_i32_limb_partials(partials: torch.Tensor) -> torch.Tensor:
    """Combine limb partial sums: [..., 4] int32 -> [...] u32 carrier."""
    p = partials.to(I32)
    return p[..., 0] + (p[..., 1] << 8) + (p[..., 2] << 16) + (p[..., 3] << 24)


def negacyclic_shift(p: torch.Tensor, s: int) -> torch.Tensor:
    """X^s * p for a static s in [0, 2N): [..., N] -> [..., N]."""
    N = p.shape[-1]
    s %= 2 * N
    neg = s >= N
    s %= N
    out = torch.cat([-p[..., N - s:], p[..., :N - s]], dim=-1) if s else p
    return -out if neg else out


def _toeplitz_indices(N: int, device: torch.device) -> torch.Tensor:
    """idx[r, c] = (c - r) mod 2N, used to gather T(p) from ext(p)."""
    r = torch.arange(N, device=device)[:, None]
    c = torch.arange(N, device=device)[None, :]
    return (c - r) % (2 * N)


def negacyclic_monomial_mul(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X^r * p with a per-batch exponent r in [0, 2N): p [..., N], r [...].

    One gather from ext(p): coefficient c of X^r p is ext(p)[(c - r) mod 2N].
    """
    N = p.shape[-1]
    r = torch.as_tensor(r, device=p.device).to(torch.int64)
    shape = torch.broadcast_shapes(p.shape[:-1], r.shape)
    ext = negacyclic_extend(p.expand(shape + (N,)))
    idx = (torch.arange(N, device=p.device) - r[..., None]) % (2 * N)
    return torch.gather(ext, -1, idx.expand(shape + (N,)))


def negacyclic_toeplitz(p: torch.Tensor) -> torch.Tensor:
    """T(p): [..., N] -> [..., N, N] with (u*p) == u @ T(p). Gather-based."""
    N = p.shape[-1]
    return negacyclic_extend(p)[..., _toeplitz_indices(N, p.device)]


def negacyclic_polymul(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product via gather-Toeplitz: elementwise products
    and a wrapping int32 sum (CUDA has no integer matmul)."""
    T = negacyclic_toeplitz(p)
    return (u[..., :, None] * T).sum(dim=-2, dtype=I32)
