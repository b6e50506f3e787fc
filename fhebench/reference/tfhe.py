"""Plain TFHE over the torus Z_{2^32} in PyTorch: keys, encryption, phases
and decoding, made from a seed on any device.

This is the benchmark's own yardstick.  It imports nothing of the program:
it follows the conventions of the TFHE scheme (CGGI) as a parameter set
states them, with q = 2^32:

- an LWE ciphertext is [..., n+1], mask first, body b = <a, s> + mu + e;
- a GLWE ciphertext is [..., k+1, N] over Z_q[X]/(X^N + 1), mask polys
  first, body b = sum_j a_j * s_j + e + mu;
- a GGSW ciphertext of a bit m is [(k+1)*l, k+1, N]; row (j, i), j-major
  and level i most significant first, is a GLWE encryption of
  -s_j * m * q/Bg^(i+1) for j < k and of m * q/Bg^(i+1) for j = k;
- the key-switching key holds, for every coefficient i of the extracted
  key s_ext (the GLWE key's coefficients in order) and every level t, an
  LWE encryption under the n-dim key of s_ext[i] * q/base^(t+1);
- secret keys are uniform binary.

Every torus value is an int64 tensor holding a number in [0, 2^32).  The
products of a torus value with a binary key are float64 matrix products:
every partial sum is an integer below 2^32 * 2048 < 2^53, so the products
are exact whatever order the device sums in.
"""

from __future__ import annotations

import dataclasses

import torch

Q_BITS = 32
MASK = (1 << Q_BITS) - 1
I64 = torch.int64
F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class Params:
    """A TFHE parameter set as a configuration file states it."""

    n: int
    N: int
    k: int
    bg_bits: int
    levels: int
    ks_base_bits: int
    ks_levels: int
    lwe_std: float
    glwe_std: float

    @classmethod
    def of(cls, numbers: dict) -> "Params":
        return cls(**{f.name: numbers[f.name]
                      for f in dataclasses.fields(cls)})

    @property
    def rows(self) -> int:
        """GGSW rows, (k+1)*l."""
        return (self.k + 1) * self.levels


@dataclasses.dataclass
class Keys:
    """The secret keys and the evaluation keys of one client."""

    params: Params
    lwe_key: torch.Tensor    # [n] in {0, 1}
    glwe_key: torch.Tensor   # [k, N] in {0, 1}
    bsk: torch.Tensor        # [n, (k+1)*l, k+1, N] torus
    ksk: torch.Tensor        # [k*N, ks_levels, n+1] torus


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of ``seed``: the
    same seed and stream give the same numbers."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return gen


def uniform(shape, gen: torch.Generator) -> torch.Tensor:
    """Uniform torus values."""
    return torch.randint(0, 1 << Q_BITS, tuple(shape), generator=gen,
                         device=gen.device, dtype=I64)


def bits(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 2, tuple(shape), generator=gen,
                         device=gen.device, dtype=I64)


def gaussian(std: float, shape, gen: torch.Generator) -> torch.Tensor:
    """Rounded centred Gaussian noise, as a torus value."""
    e = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=F64) * std
    return torch.round(e).to(I64) & MASK


def dot_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod q of torus rows a [..., m] with a binary key s [m]."""
    return (a.to(F64) @ s.to(F64)).to(I64) & MASK


def negacyclic_matrix(s: torch.Tensor) -> torch.Tensor:
    """M [N, N] with (a * s)_i = sum_j a_j M[j, i] in Z[X]/(X^N + 1)."""
    N = s.shape[-1]
    i = torch.arange(N, device=s.device)
    diff = i[None, :] - i[:, None]                 # i - j
    sign = torch.where(diff >= 0, 1.0, -1.0).to(F64)
    return s.to(F64)[diff % N] * sign


def poly_dot_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """sum_j a_j * s_j mod q of mask polys a [..., k, N] with a binary GLWE
    key s [k, N]."""
    acc = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=F64,
                      device=a.device)
    for j in range(s.shape[0]):
        acc += a[..., j, :].to(F64) @ negacyclic_matrix(s[j])
    return acc.to(I64) & MASK


def keygen(p: Params, seed: int, device) -> Keys:
    """Secret and evaluation keys from ``seed``, on ``device``."""
    gen = generator(seed, 1, device)
    lwe_key = bits((p.n,), gen)
    glwe_key = bits((p.k, p.N), gen)
    R = p.rows
    a = uniform((p.n, R, p.k, p.N), gen)
    body = (poly_dot_binary(a, glwe_key)
            + gaussian(p.glwe_std, (p.n, R, p.N), gen))
    # row (j, i): message -s_j * m * q/Bg^(i+1) (j < k), m * q/Bg^(i+1)
    # at coefficient 0 (j = k)
    scale = torch.tensor([1 << (Q_BITS - p.bg_bits * (i + 1))
                          for i in range(p.levels)], dtype=I64,
                         device=device)
    factor = lwe_key[:, None] * scale[None, :]                 # [n, l]
    msg = torch.zeros((p.n, p.k + 1, p.levels, p.N), dtype=I64,
                      device=device)
    msg[:, :p.k] = -factor[:, None, :, None] * glwe_key[None, :, None, :]
    msg[:, p.k, :, 0] = factor
    body = (body + msg.reshape(p.n, R, p.N)) & MASK
    bsk = torch.cat([a, body[:, :, None, :]], dim=2)

    s_ext = glwe_key.reshape(-1)
    ks_scale = torch.tensor([1 << (Q_BITS - p.ks_base_bits * (t + 1))
                             for t in range(p.ks_levels)], dtype=I64,
                            device=device)
    ksk = encrypt(lwe_key, s_ext[:, None] * ks_scale[None, :], p.lwe_std,
                  gen)
    return Keys(p, lwe_key, glwe_key, bsk, ksk)


def encrypt(lwe_key: torch.Tensor, mu: torch.Tensor, std: float,
            gen: torch.Generator) -> torch.Tensor:
    """LWE encryptions [..., n+1] of the torus values ``mu`` [...]."""
    a = uniform(mu.shape + lwe_key.shape, gen)
    b = (dot_binary(a, lwe_key) + (mu & MASK)
         + gaussian(std, mu.shape, gen)) & MASK
    return torch.cat([a, b[..., None]], dim=-1)


def phase(lwe_key: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """b - <a, s> mod q of LWE ciphertexts [..., n+1] (torus values)."""
    n = lwe_key.shape[0]
    if ct.shape[-1] != n + 1:
        raise ValueError(f"ciphertexts of width {ct.shape[-1]}, the key "
                         f"takes {n + 1}")
    return (ct[..., n] - dot_binary(ct[..., :n], lwe_key)) & MASK


def centred(x: torch.Tensor) -> torch.Tensor:
    """Torus values as integers in [-q/2, q/2)."""
    x = x & MASK
    return torch.where(x >= 1 << (Q_BITS - 1), x - (1 << Q_BITS), x)


# ---------------------------------------------------------------------------
# Message encodings
# ---------------------------------------------------------------------------

BOOL_MU = 1 << (Q_BITS - 3)   # q/8


def encode_bool(b: torch.Tensor) -> torch.Tensor:
    """True -> q/8, False -> -q/8."""
    return torch.where(b.bool(), BOOL_MU, (1 << Q_BITS) - BOOL_MU).to(I64)


def judge_bool(ph: torch.Tensor, want: torch.Tensor
               ) -> tuple[int, float]:
    """(wrong bits, largest phase error) of phases ``ph`` against the
    bits ``want``; the error is a share of q/8, the distance from a bit's
    value to the nearest value of the other bit: 1 or more decrypts
    wrong."""
    got = (ph > 0) & (ph < 1 << (Q_BITS - 1))
    err = centred(ph - encode_bool(want)).abs()
    wrong = int((got != want.bool()).sum())
    return wrong, (float(err.max()) / BOOL_MU if err.numel() else 0.0)
