"""Exact-integer NumPy reference of TFHE gate bootstrapping, for the port.

The port's own copy of the part of ``herdsman_tpu.core.reference`` that gate
bootstrapping needs: keys, encryption, decryption and the scalar bootstrap.
It is the client side of the port (keys and ciphertexts are made and read on
the host) and the yardstick that ``chip_smoke.py`` spot-checks the card
against.  Every function is integer arithmetic mod 2^32 on ``np.uint32``, so
agreement is array equality.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from herdsman_tpu_torch.core.params import TFHEParams

U32 = np.uint32
I64 = np.int64

BOOL_MU = U32(1 << 29)                     # q/8
NEG_BOOL_MU = U32((1 << 32) - (1 << 29))  # -q/8 mod 2^32


# ---------------------------------------------------------------------------
# Polynomial arithmetic over R_q = Z_{2^32}[X] / (X^N + 1)
# ---------------------------------------------------------------------------

def negacyclic_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Negacyclic product of two degree-<N polynomials, coefficients mod 2^32.

    16-bit operand splitting and int64 convolutions: the a1*b1 term is a
    multiple of 2^32, and every other partial sum fits int64 exactly.
    Leading batch dims broadcast.
    """
    a = np.asarray(a, dtype=U32)
    b = np.asarray(b, dtype=U32)
    N = a.shape[-1]
    assert b.shape[-1] == N
    out_shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (N,)
    a = np.broadcast_to(a, out_shape).reshape(-1, N)
    b = np.broadcast_to(b, out_shape).reshape(-1, N)
    a0 = (a & U32(0xFFFF)).astype(I64)
    a1 = (a >> U32(16)).astype(I64)
    b0 = (b & U32(0xFFFF)).astype(I64)
    b1 = (b >> U32(16)).astype(I64)
    res = np.empty_like(a)
    for row in range(a.shape[0]):
        lo = np.convolve(a0[row], b0[row])
        mid = np.convolve(a0[row], b1[row]) + np.convolve(a1[row], b0[row])
        full = (lo + (mid << 16)) & 0xFFFFFFFF
        c = full[:N].copy()
        c[: N - 1] -= full[N:]  # X^N = -1
        res[row] = (c & 0xFFFFFFFF).astype(U32)
    return res.reshape(out_shape)


def negacyclic_monomial_mul(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """X^r * p in R_q, r in [0, 2N). Batched: p [..., N], r [...] (broadcast)."""
    p = np.asarray(p, dtype=U32)
    r = np.asarray(r)
    N = p.shape[-1]
    out_shape = np.broadcast_shapes(p.shape[:-1], r.shape) + (N,)
    p = np.broadcast_to(p, out_shape).reshape(-1, N)
    r = np.broadcast_to(r, out_shape[:-1]).reshape(-1)
    res = np.empty_like(p)
    for row in range(p.shape[0]):
        rr = int(r[row]) % (2 * N)
        s = rr % N
        rolled = np.roll(p[row], s)
        if s:
            rolled[:s] = U32(0) - rolled[:s]  # wrapped coeffs pick up X^N = -1
        if rr >= N:
            rolled = U32(0) - rolled
        res[row] = rolled
    return res.reshape(out_shape)


# ---------------------------------------------------------------------------
# Gadget decomposition
# ---------------------------------------------------------------------------

def signed_decompose(x: np.ndarray, bg_bits: int, levels: int) -> np.ndarray:
    """Balanced signed base-2^bg_bits digits: [...] u32 -> [..., levels] int32.

    Level 0 is the most significant (scale q / Bg); digits lie in
    [-Bg/2, Bg/2).  Closed form: round to the top W = bg_bits*levels bits,
    add the balanced offset, read unsigned digits, subtract Bg/2.
    """
    x = np.asarray(x, dtype=U32)
    W = bg_bits * levels
    Bg = 1 << bg_bits
    half = Bg >> 1
    v = (x + U32(1 << (32 - W - 1))) >> U32(32 - W) if W < 32 else x
    offset = sum(half << (bg_bits * i) for i in range(levels))
    w = v + U32(offset & 0xFFFFFFFF)
    shifts = np.array([bg_bits * (levels - 1 - j) for j in range(levels)],
                      dtype=U32)
    digits = (w[..., None] >> shifts) & U32(Bg - 1)
    return digits.astype(np.int32) - np.int32(half)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClientKey:
    params: TFHEParams
    lwe_key: np.ndarray    # [n] uint32 in {0,1}
    glwe_key: np.ndarray   # [k, N] uint32 in {0,1}

    @property
    def extracted_key(self) -> np.ndarray:
        """The kN-dim LWE key implied by sample extraction (coeff order)."""
        return self.glwe_key.reshape(-1)


@dataclasses.dataclass
class ServerKey:
    params: TFHEParams
    bsk: np.ndarray        # [n, (k+1)*l, k+1, N] uint32 — GGSW(s_lwe[i])
    ksk: np.ndarray        # [kN, ks_levels, n+1] uint32


def _gaussian_u32(rng: np.random.Generator, std: float, shape) -> np.ndarray:
    """Centered rounded-Gaussian noise as uint32 (two's complement wrap)."""
    e = np.rint(rng.normal(0.0, std, size=shape)).astype(I64)
    return (e & 0xFFFFFFFF).astype(U32)


def keygen(params: TFHEParams,
           rng: np.random.Generator) -> tuple[ClientKey, ServerKey]:
    p = params
    lwe_key = rng.integers(0, 2, size=p.n, dtype=np.uint32)
    glwe_key = rng.integers(0, 2, size=(p.k, p.N), dtype=np.uint32)
    ck = ClientKey(p, lwe_key, glwe_key)

    bsk = np.empty((p.n, (p.k + 1) * p.levels, p.k + 1, p.N), dtype=U32)
    for i in range(p.n):
        bsk[i] = ggsw_encrypt(ck, int(lwe_key[i]), rng)

    s_ext = ck.extracted_key.astype(I64)
    ksk = np.empty((p.kN, p.ks_levels, p.n + 1), dtype=U32)
    for t in range(p.ks_levels):
        scale = I64(1) << I64(32 - p.ks_base_bits * (t + 1))
        msgs = ((s_ext * scale) & 0xFFFFFFFF).astype(U32)
        ksk[:, t, :] = lwe_encrypt_raw(ck, msgs, rng)
    return ck, ServerKey(p, bsk, ksk)


# ---------------------------------------------------------------------------
# LWE
# ---------------------------------------------------------------------------

def lwe_encrypt_raw(ck: ClientKey, mu: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """Encrypt torus values mu [...] -> ct [..., n+1] under the n-LWE key."""
    p = ck.params
    mu = np.asarray(mu, dtype=U32)
    a = rng.integers(0, 1 << 32, size=mu.shape + (p.n,),
                     dtype=np.uint64).astype(U32)
    e = _gaussian_u32(rng, p.lwe_std, mu.shape)
    b = (a * ck.lwe_key).sum(axis=-1, dtype=U32) + mu + e
    return np.concatenate([a, b[..., None]], axis=-1)


def encrypt_bool(ck: ClientKey, bits: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    mu = np.where(np.asarray(bits), BOOL_MU, NEG_BOOL_MU).astype(U32)
    return lwe_encrypt_raw(ck, mu, rng)


def lwe_phase(key: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """b - <a, s> mod 2^32 for ct [..., dim+1] under binary key [dim]."""
    return ct[..., -1] - (ct[..., :-1] * key).sum(axis=-1, dtype=U32)


def lwe_decrypt_bool(ck: ClientKey, ct: np.ndarray) -> np.ndarray:
    """Decode the boolean +-q/8 encoding: True iff phase in (0, q/2)."""
    return lwe_phase(ck.lwe_key, ct).astype(np.int32) > 0


# ---------------------------------------------------------------------------
# GLWE / GGSW
# ---------------------------------------------------------------------------

def glwe_encrypt(ck: ClientKey, msg_poly: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """GLWE ct [k+1, N] of message polynomial [N] (already torus-scaled)."""
    p = ck.params
    a = rng.integers(0, 1 << 32, size=(p.k, p.N), dtype=np.uint64).astype(U32)
    e = _gaussian_u32(rng, p.glwe_std, (p.N,))
    b = np.asarray(msg_poly, dtype=U32) + e
    for j in range(p.k):
        b = b + negacyclic_polymul(a[j], ck.glwe_key[j])
    return np.concatenate([a, b[None, :]], axis=0)


def ggsw_encrypt(ck: ClientKey, m: int, rng: np.random.Generator) -> np.ndarray:
    """GGSW ct [(k+1)*l, k+1, N] of small integer m (a key bit).

    Row (j, lev) encrypts -s_j * m * q/Bg^(lev+1) for j < k and
    m * q/Bg^(lev+1) as a constant for j = k; rows j-major, level MSB-first.
    """
    p = ck.params
    rows = []
    for j in range(p.k + 1):
        for lev in range(p.levels):
            scale = I64(1) << I64(32 - p.bg_bits * (lev + 1))
            factor = (I64(m) * scale) & 0xFFFFFFFF
            msg = np.zeros(p.N, dtype=U32)
            if j < p.k:
                msg = (((I64(0) - I64(factor)) * ck.glwe_key[j].astype(I64))
                       & 0xFFFFFFFF).astype(U32)
            else:
                msg[0] = U32(factor)
            rows.append(glwe_encrypt(ck, msg, rng))
    return np.stack(rows, axis=0)


def external_product(params: TFHEParams, ggsw: np.ndarray,
                     glwe: np.ndarray) -> np.ndarray:
    """GGSW (x) GLWE -> GLWE, exact integer ops."""
    p = params
    digits = signed_decompose(glwe, p.bg_bits, p.levels)  # [k+1, N, l]
    digits = np.moveaxis(digits, -1, 1).reshape((p.k + 1) * p.levels, p.N)
    digits_u = digits.astype(U32)
    out = np.zeros((p.k + 1, p.N), dtype=U32)
    for row in range((p.k + 1) * p.levels):
        for col in range(p.k + 1):
            out[col] += negacyclic_polymul(digits_u[row], ggsw[row, col])
    return out


# ---------------------------------------------------------------------------
# Bootstrapping
# ---------------------------------------------------------------------------

def mod_switch_2N(params: TFHEParams, ct: np.ndarray) -> np.ndarray:
    """Round LWE coefficients from q = 2^32 to 2N (int64 in [0, 2N))."""
    shift = 32 - (params.log2_2N + 1)  # one extra bit for rounding
    r = (ct >> U32(shift)).astype(I64)
    return (r + 1) >> 1 & I64(params.two_N - 1)


def make_test_poly(params: TFHEParams, mu: int = int(BOOL_MU)) -> np.ndarray:
    """Constant test polynomial: all coefficients mu -> sign bootstrap."""
    return np.full(params.N, U32(mu), dtype=U32)


def blind_rotate(sk: ServerKey, ct: np.ndarray,
                 test_poly: np.ndarray) -> np.ndarray:
    """GINX blind rotation of one LWE [n+1] -> GLWE acc [k+1, N]:
    acc = (0, X^{-b~} v), then acc += BSK_i (x) (X^{a~_i} acc - acc)."""
    p = sk.params
    tilde = mod_switch_2N(p, ct)
    a_t, b_t = tilde[:-1], int(tilde[-1])
    acc = np.zeros((p.k + 1, p.N), dtype=U32)
    acc[p.k] = negacyclic_monomial_mul(test_poly, (2 * p.N - b_t) % (2 * p.N))
    for i in range(p.n):
        rot = negacyclic_monomial_mul(acc, int(a_t[i]))
        acc = acc + external_product(p, sk.bsk[i], rot - acc)
    return acc


def sample_extract(params: TFHEParams, glwe: np.ndarray,
                   offset: int = 0) -> np.ndarray:
    """Extract coeff `offset` as an LWE ct of dimension kN (+ body): [kN+1]."""
    p = params
    a_out = np.empty(p.kN, dtype=U32)
    idx = (offset - np.arange(p.N)) % p.N
    neg = np.arange(p.N) > offset
    for j in range(p.k):
        coeffs = glwe[j][idx]
        a_out[j * p.N:(j + 1) * p.N] = np.where(neg, U32(0) - coeffs, coeffs)
    return np.concatenate([a_out, np.array([glwe[p.k, offset]], dtype=U32)])


def key_switch(sk: ServerKey, ct: np.ndarray) -> np.ndarray:
    """Switch an extracted [kN+1] LWE down to the n-LWE key: [n+1], with
    balanced signed digits of the key-switching gadget."""
    p = sk.params
    digits = signed_decompose(ct[:-1], p.ks_base_bits, p.ks_levels)  # [kN, t]
    out = np.zeros(p.n + 1, dtype=U32)
    out[p.n] = ct[-1]
    contrib = (digits.astype(U32)[..., None] * sk.ksk).sum(axis=(0, 1),
                                                          dtype=U32)
    return out - contrib


def bootstrap_bool(sk: ServerKey, ct: np.ndarray) -> np.ndarray:
    """Full sign bootstrap back to the n-LWE key: [n+1] -> [n+1]."""
    acc = blind_rotate(sk, ct, make_test_poly(sk.params))
    return key_switch(sk, sample_extract(sk.params, acc))
