"""RNS/CRT multi-limb polynomial arithmetic (BASELINE config 3): the port
of ``herdsman_tpu.ops.rns``.

A polynomial over Z_Q with Q = p_0 * p_1 * ... * p_{L-1} is held as its
residues [L, ..., N] (int32 carriers, limb-major) on the context's device.
Limb operations are independent; the products run the four-step NTT of
``ops/ntt`` limb by limb.

Includes an RLWE key switch in the CRT-gadget style of RNS-BFV/CKKS:
    a = sum_j d_j * Qhat_j (mod Q),   Qhat_j = Q/p_j,
    d_j = [a * Qhat_j^-1]_{p_j}  (centered),
so the gadget digits are limb-LOCAL (no positional reconstruction), and the
key-switching key encrypts s2 * Qhat_j.

The residue conversions and the big-int product run on the host (exact
Python ints), as copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from herdsman_tpu_torch.ops import modmath as mm
from herdsman_tpu_torch.ops import ntt as nttm
from herdsman_tpu_torch.ops.u32 import (from_numpy_u32, on_device,
                                        resolve_device)


@dataclasses.dataclass(frozen=True)
class RNSContext:
    N: int
    primes: tuple[int, ...]
    device: torch.device
    plans: tuple[nttm.NTTPlan, ...] = dataclasses.field(repr=False)

    @property
    def L(self) -> int:
        return len(self.primes)

    @property
    def Q(self) -> int:
        q = 1
        for p in self.primes:
            q *= p
        return q


def make_rns(N: int, n_primes: int = 3,
             device: str | torch.device = "cuda") -> RNSContext:
    """The context of ``n_primes`` NTT primes at degree ``N``, its tables on
    ``device`` (the card by default; without one this raises)."""
    dev = resolve_device(device)
    primes = nttm.ntt_primes_for(N, n_primes)
    plans = tuple(nttm.make_plan(p, N, dev) for p in primes)
    return RNSContext(N=N, primes=primes, device=dev, plans=plans)


# ---------------------------------------------------------------------------
# residue conversion (host, exact big-int)
# ---------------------------------------------------------------------------

def to_rns(ctx: RNSContext, coeffs: Sequence[int] | np.ndarray) -> np.ndarray:
    """Python-int/object coefficients mod Q -> residues [L, ...] uint32."""
    arr = np.asarray(coeffs, dtype=object) % ctx.Q
    out = np.empty((ctx.L,) + arr.shape, dtype=np.uint32)
    for j, p in enumerate(ctx.primes):
        out[j] = (arr % p).astype(np.uint32)
    return out


def from_rns(ctx: RNSContext, residues: np.ndarray) -> np.ndarray:
    """Residues [L, ...] -> object-int array of values in [0, Q) (CRT)."""
    Q = ctx.Q
    acc = np.zeros(residues.shape[1:], dtype=object)
    for j, p in enumerate(ctx.primes):
        Qj = Q // p
        inv = pow(Qj % p, -1, p)
        acc = (acc + residues[j].astype(object) * inv % p * Qj) % Q
    return acc


def centered(ctx: RNSContext, values: np.ndarray) -> np.ndarray:
    Q = ctx.Q
    return np.where(values > Q // 2, values - Q, values)


def host_negacyclic_polymul(ctx: RNSContext, a, b) -> np.ndarray:
    """Exact big-int negacyclic product mod Q (test oracle)."""
    full = np.convolve(np.asarray(a, dtype=object),
                       np.asarray(b, dtype=object))
    out = full[: ctx.N].copy()
    out[: ctx.N - 1] -= full[ctx.N:]
    return out % ctx.Q


# ---------------------------------------------------------------------------
# device limb ops (residues [L, ..., N])
# ---------------------------------------------------------------------------

def _on(ctx: RNSContext, x) -> torch.Tensor:
    return on_device(x, ctx.device)


def _per_limb(ctx: RNSContext, fn) -> torch.Tensor:
    return torch.stack([fn(j) for j in range(ctx.L)], dim=0)


def add(ctx: RNSContext, a, b) -> torch.Tensor:
    a, b = _on(ctx, a), _on(ctx, b)
    return _per_limb(ctx, lambda j: mm.modadd(a[j], b[j], ctx.primes[j]))


def sub(ctx: RNSContext, a, b) -> torch.Tensor:
    a, b = _on(ctx, a), _on(ctx, b)
    return _per_limb(ctx, lambda j: mm.modsub(a[j], b[j], ctx.primes[j]))


def neg(ctx: RNSContext, a) -> torch.Tensor:
    a = _on(ctx, a)
    return _per_limb(
        ctx, lambda j: mm.modsub(torch.zeros_like(a[j]), a[j], ctx.primes[j]))


def ntt_fwd(ctx: RNSContext, a) -> torch.Tensor:
    a = _on(ctx, a)
    return _per_limb(ctx, lambda j: nttm.ntt_fwd(ctx.plans[j], a[j]))


def ntt_inv(ctx: RNSContext, a) -> torch.Tensor:
    a = _on(ctx, a)
    return _per_limb(ctx, lambda j: nttm.ntt_inv(ctx.plans[j], a[j]))


def spec_mul(ctx: RNSContext, a_spec, b_spec) -> torch.Tensor:
    a_spec, b_spec = _on(ctx, a_spec), _on(ctx, b_spec)
    return _per_limb(
        ctx, lambda j: nttm.pointwise_mul(ctx.plans[j], a_spec[j], b_spec[j]))


def spec_mul_mont(ctx: RNSContext, a_spec, b_mont_spec) -> torch.Tensor:
    """Pointwise with the second operand pre-scaled to Montgomery form."""
    a_spec, b_mont_spec = _on(ctx, a_spec), _on(ctx, b_mont_spec)
    return _per_limb(
        ctx, lambda j: mm.mont_mul(a_spec[j], b_mont_spec[j],
                                   ctx.plans[j].ctx))


def to_mont(ctx: RNSContext, a) -> torch.Tensor:
    a = _on(ctx, a)
    return _per_limb(ctx, lambda j: mm.to_mont(a[j], ctx.plans[j].ctx))


def polymul(ctx: RNSContext, a, b) -> torch.Tensor:
    """Negacyclic product mod Q: residues [L, ..., N] x same -> same (the
    leading dimensions broadcast)."""
    return ntt_inv(ctx, spec_mul(ctx, ntt_fwd(ctx, a), ntt_fwd(ctx, b)))


# ---------------------------------------------------------------------------
# RLWE key switch with the CRT gadget
# ---------------------------------------------------------------------------

# the key's error deviation, the JAX package's, so that one seed draws the
# same key
KEY_ERR_STD = 3.2


@dataclasses.dataclass
class RnsKeySwitchKey:
    """ksk_a/ksk_b: [L_digit, L_limb, N] int32 NTT-domain spectra in
    MONTGOMERY form, on the context's device; row j encrypts s2 * Qhat_j
    under s1:
        beta_j = alpha_j * s1 + e_j + Qhat_j * s2  (mod Q).
    """

    ctx: RNSContext
    ksk_a: torch.Tensor
    ksk_b: torch.Tensor


def device_keyswitch_key(ctx: RNSContext, ksk_a: np.ndarray,
                         ksk_b: np.ndarray) -> RnsKeySwitchKey:
    """Carry a host key-switching key (the JAX package's ``ksk_a`` and
    ``ksk_b``, uint32 [L, L, N]) to the context's device."""
    want = (ctx.L, ctx.L, ctx.N)
    for name, k in (("ksk_a", ksk_a), ("ksk_b", ksk_b)):
        if tuple(np.shape(k)) != want:
            raise ValueError(f"{name} shape {np.shape(k)} != {want}")
    return RnsKeySwitchKey(ctx, from_numpy_u32(ksk_a, ctx.device),
                           from_numpy_u32(ksk_b, ctx.device))


def keyswitch_keygen(
    ctx: RNSContext,
    s1: np.ndarray,   # [N] small (binary) destination key
    s2: np.ndarray,   # [N] small source key
    rng: np.random.Generator,
) -> RnsKeySwitchKey:
    """The JAX package's ``keyswitch_keygen`` with the same draws in the
    same order, so that one seed gives the same key; alpha_j * s1 mod Q is
    ``polymul`` on the device (one call for every j) instead of a big-int
    product, and the spectra are the device's ``ntt_fwd``."""
    Q = ctx.Q
    a_all, extra = [], []
    for p in ctx.primes:
        Qhat = Q // p
        # independent uniform residues per limb == uniform mod Q (CRT)
        a_all.append(np.stack(
            [rng.integers(0, pi, ctx.N).astype(np.uint32)
             for pi in ctx.primes], axis=0))
        e = np.rint(rng.normal(0, KEY_ERR_STD, ctx.N)).astype(int)
        extra.append(to_rns(ctx, np.asarray(e, dtype=object)
                            + Qhat * np.asarray(s2, dtype=object)))
    # [L_limb, L_digit, N]: row j of every limb
    a_res = from_numpy_u32(np.stack(a_all, axis=1), ctx.device)
    s1_res = from_numpy_u32(to_rns(ctx, s1)[:, None], ctx.device)
    b_res = add(ctx, polymul(ctx, a_res, s1_res),
                np.ascontiguousarray(np.stack(extra, axis=1)))
    ksk_a = to_mont(ctx, ntt_fwd(ctx, a_res)).transpose(0, 1).contiguous()
    ksk_b = to_mont(ctx, ntt_fwd(ctx, b_res)).transpose(0, 1).contiguous()
    return RnsKeySwitchKey(ctx, ksk_a, ksk_b)


def gadget_digits(ctx: RNSContext, a) -> torch.Tensor:
    """CRT gadget digits of a [L, ..., N]: returns [L_digit, L_limb, ..., N]
    where digit j is d_j = centered([a_j * Qhat_j^-1]_{p_j}) re-reduced mod
    every limb. Limb-local except the broadcast."""
    a = _on(ctx, a)
    Q = ctx.Q
    out = []
    for j, p in enumerate(ctx.primes):
        inv = pow((Q // p) % p, -1, p)
        ctxj = ctx.plans[j].ctx
        # (a_j * inv) mod p via Montgomery with the constant pre-scaled by R
        inv_mont = (inv * ctxj.r_mod_p) % p
        dj = mm.mont_mul(a[j], inv_mont, ctxj)
        half = p // 2
        limbs = []
        for i, pi in enumerate(ctx.primes):
            if i == j:
                limbs.append(dj)
                continue
            ctxi = ctx.plans[i].ctx
            pos = mm.barrett_u32(dj, pi, ctxi.mu)
            neg_ = mm.modsub(pos, torch.full_like(pos, p % pi), pi)
            limbs.append(torch.where(dj > half, neg_, pos))
        out.append(torch.stack(limbs, dim=0))
    return torch.stack(out, dim=0)  # [L_digit, L_limb, ..., N]


def key_switch(ctx: RNSContext, ksk: RnsKeySwitchKey, ct) -> torch.Tensor:
    """Switch RLWE ct [2, L, N] (a, b), or a batch [2, L, B, N], from key
    s2 to key s1 (the key broadcasts over B).

    out = ( -sum_j d_j (x) alpha_j,  b - sum_j d_j (x) beta_j ):
    phase' = b' - a'*s1 = b - sum_j d_j (e_j + Qhat_j s2)
           = phase(ct) - sum_j d_j e_j.
    """
    ct = _on(ctx, ct)
    if ksk.ksk_a.device != ctx.device:
        raise ValueError(f"the key is on {ksk.ksk_a.device}, not on "
                         f"{ctx.device}")
    a, b = ct[0], ct[1]
    digits = gadget_digits(ctx, a)  # [L_digit, L, (B,) N]
    acc_a = None
    acc_b = None
    for j in range(ctx.L):
        d_spec = ntt_fwd(ctx, digits[j])
        pa = spec_mul_mont(ctx, d_spec, ksk.ksk_a[j])
        pb = spec_mul_mont(ctx, d_spec, ksk.ksk_b[j])
        acc_a = pa if acc_a is None else add(ctx, acc_a, pa)
        acc_b = pb if acc_b is None else add(ctx, acc_b, pb)
    sum_a = ntt_inv(ctx, acc_a)
    sum_b = ntt_inv(ctx, acc_b)
    return torch.stack([neg(ctx, sum_a), sub(ctx, b, sum_b)], dim=0)
