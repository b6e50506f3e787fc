"""Exact 32-bit modular arithmetic on torch tensors: the port of
``herdsman_tpu.ops.modmath``. Primitives:

- mulhi32: high word of a u32 x u32 product (16-bit limb split).
- barrett_u32: x mod p for x < 2^32 (p < 2^31).
- Montgomery multiplication (R = 2^32): mont_mul(a, b) = a*b*R^-1 mod p for
  odd p < 2^31. Storing one operand pre-scaled by R (twiddles, NTT-domain
  key polynomials) makes mont_mul(data, w_mont) return the PLAIN product.

Residues travel in the port's u32 carrier (``ops/u32.py``: int32 holding
the bits). The functions compute in int64, where every intermediate is
exact (the bounds are stated beside each), and return the JAX functions'
bits: ``mulhi32``, ``barrett_u32``, ``modadd`` and ``modsub`` on every u32
input, the Montgomery functions for a, b < p. The ``_``-prefixed versions
take and return int64 values and serve the NTT, which keeps its
intermediates in int64.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF


def _u(x: torch.Tensor) -> torch.Tensor:
    """The u32 value of an int32 carrier (or of int64 u32 values), int64."""
    return x.to(I64) & M32


def _carrier(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 carrier (the cast wraps)."""
    return x.to(I32)


def _mulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """floor(a*b / 2^32) for int64 a, b in [0, 2^32): a split into 16-bit
    limbs, so that no product passes 2^48."""
    a0, a1 = a & 0xFFFF, a >> 16
    return (a1 * b + ((a0 * b) >> 16)) >> 16


def _mullo_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a u32 constant c: c
    split into 16-bit limbs, each product below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mulhi32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the 64-bit product of two u32 carriers (exact)."""
    return _carrier(_mulhi(_u(a), _u(b)))


def _barrett(x: torch.Tensor, p: int, mu: int) -> torch.Tensor:
    """x mod p for int64 x in [0, 2^32), p < 2^31, mu = floor(2^32 / p) <
    2^31 (p > 2), so x * mu < 2^63. q = floor(x*mu / 2^32) underestimates
    floor(x/p) by at most 2."""
    q = (x * mu) >> 32
    r = x - q * p
    r = torch.where(r >= 2 * p, r - 2 * p, r)
    return torch.where(r >= p, r - p, r)


def barrett_u32(x: torch.Tensor, p: int, mu: int) -> torch.Tensor:
    """x mod p for a u32 carrier x, p < 2^31, mu = floor(2^32 / p)."""
    return _carrier(_barrett(_u(x), p, mu))


@dataclasses.dataclass(frozen=True)
class MontgomeryCtx:
    """Per-prime constants for R = 2^32 Montgomery arithmetic."""

    p: int
    p_inv_neg: int   # -p^-1 mod 2^32
    r_mod_p: int     # 2^32 mod p
    r2_mod_p: int    # 2^64 mod p  (to_mont factor)
    mu: int          # floor(2^32 / p)  (Barrett companion)

    @staticmethod
    def make(p: int) -> "MontgomeryCtx":
        assert p % 2 == 1 and 2 < p < (1 << 31)
        p_inv = pow(p, -1, 1 << 32)
        return MontgomeryCtx(
            p=p,
            p_inv_neg=((1 << 32) - p_inv) % (1 << 32),
            r_mod_p=(1 << 32) % p,
            r2_mod_p=(1 << 64) % p,
            mu=(1 << 32) // p,
        )


def _mont_mul(a: torch.Tensor, b, ctx: MontgomeryCtx) -> torch.Tensor:
    """a * b * 2^-32 mod p (REDC) for int64 a, b in [0, p): a*b < 2^62,
    m*p < 2^63; (lo + (m*p) mod 2^32) is 0 or 2^32, a carry iff lo != 0."""
    t = a * b
    lo = t & M32
    m = _mullo_const(lo, ctx.p_inv_neg)
    u = (t >> 32) + ((m * ctx.p) >> 32) + (lo != 0).to(I64)
    return torch.where(u >= ctx.p, u - ctx.p, u)


def mont_mul(a: torch.Tensor, b, ctx: MontgomeryCtx) -> torch.Tensor:
    """a * b * 2^-32 mod p (REDC), exact for u32 carriers a, b < p (b may
    be a Python int)."""
    b = _u(b) if isinstance(b, torch.Tensor) else b
    return _carrier(_mont_mul(_u(a), b, ctx))


def to_mont(x: torch.Tensor, ctx: MontgomeryCtx) -> torch.Tensor:
    return mont_mul(x, ctx.r2_mod_p, ctx)


def from_mont(x: torch.Tensor, ctx: MontgomeryCtx) -> torch.Tensor:
    return mont_mul(x, 1, ctx)


def modmul_by_mont(x_plain: torch.Tensor, w_mont: torch.Tensor,
                   ctx: MontgomeryCtx) -> torch.Tensor:
    """(x * w) mod p with w stored in Montgomery form: one REDC."""
    return mont_mul(x_plain, w_mont, ctx)


def _modsub(a: torch.Tensor, b, p: int) -> torch.Tensor:
    """a - b mod p for int64 a, b in [0, p)."""
    d = a - b
    return torch.where(d < 0, d + p, d)


def modadd(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a + b, less p where the u32 sum (wrapping) is at least p."""
    s = (_u(a) + _u(b)) & M32
    return _carrier(torch.where(s >= p, s - p, s))


def modsub(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a - b in u32 (wrapping), plus p where that is at least p (u32 wrap
    detection, as the JAX function does)."""
    d = (_u(a) - _u(b)) & M32
    return _carrier(torch.where(d >= p, (d + p) & M32, d))
