"""Negacyclic NTT over NTT-friendly primes, four-step, its DFT steps int8
products: the port of ``herdsman_tpu.ops.ntt``.

This is the BASELINE config-3 path (RNS/CRT multi-limb polynomial
arithmetic, N up to 4096): polynomial products over prime moduli p < 2^23
with p = 1 (mod 2N), computed as

    pre-twist by psi^i  ->  four-step cyclic NTT  ->  pointwise  ->
    inverse NTT  ->  post-twist by psi^-i / N

The two DFT steps of the four-step NTT are modular matmuls: operands are
decomposed into 3 balanced signed int8 digits (exact for values < 2^23),
multiplied in ONE ``torch._int_mm`` a step accumulating in int32 (x's three
digit planes stacked along the rows, W's along the columns), and the
shift-class partial sums are recombined mod p with Barrett Horner steps.
Pointwise products use Montgomery REDC with the constant operand (twiddles,
NTT-domain keys) stored in Montgomery form (``ops/modmath``).

Residues travel in the port's u32 carrier (int32 holding values < p); the
elementwise passes compute in int64. The spectrum is stored as [k1, k2]
row-major (k = k2*N1 + k1), as in the JAX package, so that spectra and
key-switching keys are interchangeable with its own.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from herdsman_tpu_torch.core import numtheory as nt
from herdsman_tpu_torch.ops import modmath as mm
from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul
from herdsman_tpu_torch.ops.u32 import on_device, resolve_device, to_numpy_u32

I8 = torch.int8
I32 = torch.int32
I64 = torch.int64


def split_n(N: int) -> tuple[int, int]:
    """(N1, N2) of the four-step NTT: N1 = 2^floor(log2(N) / 2)."""
    n1 = 1 << (int(np.log2(N)) // 2)
    return n1, N // n1


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _operand(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    """The DFT matrix [K, L] (residues <= numtheory.MAX_DIGIT3, where the
    3 balanced digits are exact) as the product's B operand: [K8, C8] int8,
    column j*L + l the digit j of column l (``_digits3``), K and the
    columns zero-padded to multiples of 8 (``torch._int_mm`` on the card
    wants both), stored K-major (it reads a K-major B about 5x faster)."""
    assert (mat <= nt.MAX_DIGIT3).all()
    K, L = mat.shape
    dig = _digits3(torch.from_numpy(mat.astype(np.int32)))  # [3, K, L]
    w = torch.zeros(_round8(K), _round8(3 * L), dtype=I8)
    w[:K, :3 * L] = dig.permute(1, 0, 2).reshape(K, 3 * L)
    return w.to(device).t().contiguous().t()


@dataclasses.dataclass(frozen=True)
class NTTPlan:
    """Per-prime tables for the negacyclic four-step NTT, on ``device``.
    ``plan_tables`` returns them in the JAX package's layouts."""

    p: int
    N: int
    N1: int
    N2: int
    device: torch.device
    ctx: mm.MontgomeryCtx = dataclasses.field(repr=False)
    psi_mont: torch.Tensor = dataclasses.field(repr=False)
    # [N] i32: psi^i in Montgomery form (pre-twist)
    psi_inv_mont: torch.Tensor = dataclasses.field(repr=False)
    # [N] i32: psi^-i / N in Montgomery form
    w1_dig: torch.Tensor = dataclasses.field(repr=False)
    # [K8(N1), C8(3*N1)] i8: digits of w1^(n1*k1), as ``_operand`` lays them
    w1i_dig: torch.Tensor = dataclasses.field(repr=False)   # inverse
    tw_mont: torch.Tensor = dataclasses.field(repr=False)
    # [N1, N2] i32: omega^(k1*n2) in Montgomery form
    twi_mont: torch.Tensor = dataclasses.field(repr=False)  # inverse
    w2_dig: torch.Tensor = dataclasses.field(repr=False)
    # [K8(N2), C8(3*N2)] i8: digits of w2^(n2*k2)
    w2i_dig: torch.Tensor = dataclasses.field(repr=False)   # inverse


def ntt_primes_for(N: int, count: int) -> tuple[int, ...]:
    """NTT primes compatible with the 3-digit int8 product path."""
    return nt.ntt_primes(2 * N, count, cap=nt.MAX_DIGIT3)


def make_plan(p: int, N: int, device: str | torch.device = "cuda") -> NTTPlan:
    """The tables of prime ``p`` at degree ``N`` on ``device``, cached per
    (p, N, device); the default device is the card, and without one this
    raises."""
    return _make_plan(p, N, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _make_plan(p: int, N: int, device: torch.device) -> NTTPlan:
    assert (p - 1) % (2 * N) == 0 and p <= nt.MAX_DIGIT3
    ctx = mm.MontgomeryCtx.make(p)
    psi = nt.root_of_unity(p, 2 * N)
    omega = psi * psi % p
    N1, N2 = split_n(N)
    w1 = pow(omega, N2, p)
    w2 = pow(omega, N1, p)
    n_inv = pow(N, -1, p)
    psi_inv = pow(psi, -1, p)
    R = (1 << 32) % p

    def mont(x: np.ndarray) -> torch.Tensor:
        m = (x.astype(np.uint64) * R % p).astype(np.int32)
        return torch.from_numpy(m).to(device)

    i1 = np.arange(N1)
    i2 = np.arange(N2)
    w1_mat = np.array([[pow(w1, int(a * b), p) for b in i1] for a in i1],
                      dtype=np.uint32)
    w1i_mat = np.array(
        [[pow(w1, int(-a * b) % (p - 1), p) for b in i1] for a in i1],
        dtype=np.uint32)
    w2_mat = np.array([[pow(w2, int(a * b), p) for b in i2] for a in i2],
                      dtype=np.uint32)
    w2i_mat = np.array(
        [[pow(w2, int(-a * b) % (p - 1), p) for b in i2] for a in i2],
        dtype=np.uint32)
    tw = np.array([[pow(omega, int(k1 * n2), p) for n2 in i2] for k1 in i1],
                  dtype=np.uint32)
    twi = np.array(
        [[pow(omega, int(-k1 * n2) % (p - 1), p) for n2 in i2] for k1 in i1],
        dtype=np.uint32)

    psi_pows = nt.powers_mod(psi, N, p).astype(np.uint32)
    psi_inv_pows = (
        nt.powers_mod(psi_inv, N, p).astype(np.uint64) * n_inv % p
    ).astype(np.uint32)

    return NTTPlan(
        p=p, N=N, N1=N1, N2=N2, device=device, ctx=ctx,
        psi_mont=mont(psi_pows),
        psi_inv_mont=mont(psi_inv_pows),
        w1_dig=_operand(w1_mat, device),
        w1i_dig=_operand(w1i_mat, device),
        tw_mont=mont(tw),
        twi_mont=mont(twi),
        w2_dig=_operand(w2_mat, device),
        w2i_dig=_operand(w2i_mat, device),
    )


def plan_tables(plan: NTTPlan) -> dict[str, np.ndarray]:
    """The plan's eight tables on the host in the JAX ``NTTPlan``'s
    layouts: the Montgomery tables uint32, the digit tables int8 [K, L,
    3]."""
    out = {}
    for name, K in (("w1_dig", plan.N1), ("w1i_dig", plan.N1),
                    ("w2_dig", plan.N2), ("w2i_dig", plan.N2)):
        w = getattr(plan, name).cpu().numpy()[:K, :3 * K]
        out[name] = np.ascontiguousarray(w.reshape(K, 3, K).transpose(0, 2, 1))
    for name in ("psi_mont", "psi_inv_mont", "tw_mont", "twi_mont"):
        out[name] = to_numpy_u32(getattr(plan, name))
    return out


def _digits3(x: torch.Tensor) -> torch.Tensor:
    """Balanced signed digits of residues x [R, K] (< 2^23): [3, R, K] i8,
    digit plane i the bits 8i..8i+7 of x + 0x808080, less 128."""
    u = x.to(I32) + 0x808080
    return torch.stack([((u >> (8 * i)) & 0xFF) - 128 for i in range(3)]
                       ).to(I8)


def _mod_matmul_digits(x: torch.Tensor, w: torch.Tensor, L: int, p: int,
                       mu: int) -> torch.Tensor:
    """(x @ W) mod p with x [..., M, K] residues (< p < 2^23) and W [K, L]
    given as the plan's operand of its digits (``_operand``): int64 [...,
    M, L]. One int8 product of x's digit planes stacked along the rows [3R,
    K8] by W's stacked along the columns [K8, C8]: block (i, j) of the
    [3R, 3L] result is the digit-pair product x_i @ W_j. Every entry is at
    most K * 128 * 128 = K * 2^14 in magnitude and a shift class sums up to
    3 of them, K * 2^14 * 3 < 2^31 for K < 43690 (K is N1 or N2, 64 at N =
    4096), so the int32 accumulation neither wraps nor saturates (on the
    card ``torch._int_mm`` saturates). The classes s = i + j are
    recombined mod p by Barrett Horner steps from the top class down."""
    *lead, M, K = x.shape
    rows = x.reshape(-1, K)
    R = rows.shape[0]
    d = _digits3(rows)
    if w.shape[0] != K:  # K < 8: zero digits against zero rows of W
        d = torch.nn.functional.pad(d, (0, w.shape[0] - K))
    prod = int8_matmul(d.reshape(3 * R, w.shape[0]), w)
    prod = prod[:, :3 * L].reshape(3, R, 3, L)
    classes = [prod[0, :, 0],
               prod[0, :, 1] + prod[1, :, 0],
               prod[0, :, 2] + prod[1, :, 1] + prod[2, :, 0],
               prod[1, :, 2] + prod[2, :, 1],
               prod[2, :, 2]]
    # make non-negative: |class| <= K * 128 * 128 * 3 = off < 2^30
    off = K * 128 * 128 * 3
    assert off < (1 << 30)
    # Horner in int64: r < p < 2^23 so r * 256 < 2^31, and c < 2^31, so
    # (r << 8) + c < 2^32 may pass int32's range (the JAX package carries
    # it as u32)
    r = None
    off_total = 0
    for s in range(4, -1, -1):
        c = classes[s].to(I64) + off
        off_total = off_total * 256 + off
        r = mm._barrett(c if r is None else (r << 8) + c, p, mu)
    # subtract the accumulated offset (a constant mod p)
    return mm._modsub(r, off_total % p, p).reshape(*lead, M, L)


def ntt_fwd(plan: NTTPlan, x) -> torch.Tensor:
    """Negacyclic forward NTT: [..., N] residues (< p) -> [..., N] spectrum,
    int32 carriers."""
    x = on_device(x, plan.device)
    p, mu, ctx = plan.p, plan.ctx.mu, plan.ctx
    xt = mm._mont_mul(x.to(I64), plan.psi_mont.to(I64), ctx)   # pre-twist
    m = xt.reshape(*x.shape[:-1], plan.N1, plan.N2)
    # DFT over n1: y[k1, n2] = sum_n1 m[n1, n2] w1^(n1 k1)
    y = _mod_matmul_digits(m.transpose(-1, -2), plan.w1_dig, plan.N1, p, mu)
    y = y.transpose(-1, -2)  # [..., N1(k1), N2(n2)]
    z = mm._mont_mul(y, plan.tw_mont.to(I64), ctx)              # twiddle
    out = _mod_matmul_digits(z, plan.w2_dig, plan.N2, p, mu)
    return out.reshape(*x.shape[:-1], plan.N).to(I32)


def ntt_inv(plan: NTTPlan, spec) -> torch.Tensor:
    """Inverse of ``ntt_fwd``: [..., N] spectrum -> [..., N] residues."""
    spec = on_device(spec, plan.device)
    p, mu, ctx = plan.p, plan.ctx.mu, plan.ctx
    s = spec.reshape(*spec.shape[:-1], plan.N1, plan.N2)
    z = _mod_matmul_digits(s, plan.w2i_dig, plan.N2, p, mu)     # undo k2 DFT
    y = mm._mont_mul(z, plan.twi_mont.to(I64), ctx)             # undo twiddle
    m = _mod_matmul_digits(y.transpose(-1, -2), plan.w1i_dig, plan.N1, p, mu)
    xt = m.transpose(-1, -2).reshape(*spec.shape[:-1], plan.N)
    return mm._mont_mul(xt, plan.psi_inv_mont.to(I64), ctx).to(I32)  # /N


def pointwise_mul(plan: NTTPlan, a_spec, b_spec) -> torch.Tensor:
    """Pointwise product of two spectra (both plain-domain): 2 REDCs."""
    a_spec, b_spec = (on_device(x, plan.device) for x in (a_spec, b_spec))
    b_mont = mm._mont_mul(b_spec.to(I64), plan.ctx.r2_mod_p, plan.ctx)
    return mm._mont_mul(a_spec.to(I64), b_mont, plan.ctx).to(I32)


def negacyclic_polymul_ntt(plan: NTTPlan, a, b) -> torch.Tensor:
    """Exact negacyclic product mod p via NTT: [..., N] each, values < p."""
    return ntt_inv(plan, pointwise_mul(plan, ntt_fwd(plan, a),
                                       ntt_fwd(plan, b)))
