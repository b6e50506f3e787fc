"""TFHE parameter sets — the port's own copy of ``herdsman_tpu.core.params``,
set for set and field for field (a test holds the two equal).

The scheme is TFHE/CGGI gate bootstrapping over the discretized torus
Z_q with q = 2^32 (TFHE-rs-style power-of-two modulus): all torus arithmetic
is exact uint32/int32 wraparound, so no modular reduction appears anywhere on
the hot path, and negacyclic polynomial products can run as int8-limb
products with int32 accumulation.

Conventions
-----------
- Torus elements are uint32; value x represents x / 2^32 in [0, 1).
- LWE ciphertext: array [..., n+1], mask first, body last
  (b = <a, s> + m + e mod 2^32).
- GLWE ciphertext: array [..., k+1, N] over R = Z_q[X]/(X^N + 1),
  mask polys first, body poly last.
- GGSW ciphertext: array [..., (k+1)*l, k+1, N]; row (j, i) encrypts
  -s_j * m * q/Bg^(i+1) for j < k and m * q/Bg^(i+1) for j = k,
  rows ordered j-major, level i MSB-first.
- Secret keys are uniform binary.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TFHEParams:
    """One TFHE gate-bootstrapping parameter set (q = 2^32 fixed)."""

    name: str

    # LWE (the small, gate-level ciphertexts)
    n: int                  # LWE dimension
    lwe_std: float          # absolute noise std-dev (torus units of 2^32)

    # GLWE (the bootstrapping accumulator ring)
    N: int                  # polynomial degree, power of two
    k: int                  # GLWE dimension
    glwe_std: float         # absolute noise std-dev

    # Bootstrapping-key gadget decomposition (signed, balanced digits)
    bg_bits: int            # log2(Bg)
    levels: int             # decomposition levels l

    # Key-switching-key decomposition (unsigned digits)
    ks_base_bits: int       # log2(base)
    ks_levels: int

    # Documented security estimate for the set (informational)
    security_bits: int = 0

    # Measured restriction: the set's noise budget supports only single-bit
    # (bool gate) payloads — the PBS integer layers (shortint/radix slot
    # encodings) decrypt wrong at these params and refuse them (e.g.
    # STD128_SHORTINT_FAST: 1.9 sigma to the half-slot boundary)
    bool_only: bool = False

    @property
    def q_bits(self) -> int:
        return 32

    @property
    def Bg(self) -> int:
        return 1 << self.bg_bits

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_base_bits

    @property
    def kN(self) -> int:
        """Dimension of the LWE ciphertext extracted from a GLWE sample."""
        return self.k * self.N

    @property
    def two_N(self) -> int:
        return 2 * self.N

    @property
    def log2_2N(self) -> int:
        return int(math.log2(2 * self.N))

    def __post_init__(self) -> None:
        assert self.N & (self.N - 1) == 0, "N must be a power of two"
        assert self.bg_bits * self.levels <= 32
        assert self.ks_base_bits * self.ks_levels <= 32
        assert self.Bg <= 256, "signed digits must fit int8 products"
        assert self.ks_base <= 256, "KS digits must fit int8 products"


# Tiny, insecure, math-identical set for fast unit tests. The decomposition /
# rotation / extraction logic has zero parameter-dependent branches, so
# bit-exactness at TOY scale implies it at production scale.
TOY = TFHEParams(
    name="toy",
    n=16,
    lwe_std=0.5,            # essentially noiseless: exactness tests
    N=64,
    k=1,
    glwe_std=0.5,
    bg_bits=6,
    levels=3,
    ks_base_bits=4,
    ks_levels=3,
    security_bits=0,
)

# Small set with real (but reduced) noise, N = 256, fast under pytest on CPU.
TEST_SMALL = TFHEParams(
    name="test_small",
    n=128,
    lwe_std=2.0,
    N=256,
    k=1,
    glwe_std=2.0,
    bg_bits=7,
    levels=3,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=0,
)

# PBS/shortint/radix test set: like TEST_SMALL but with n = 64 so the
# mod-switch rounding noise (sigma ~ sqrt(n/12) rotation indices) leaves a
# ~5-sigma margin inside a 16-index slot of the 4-bit (msg 2 + carry 2)
# working space — TEST_SMALL's n = 128 leaves only ~3.5 sigma, enough for
# rare single-slot misses across the thousands of PBS a radix test runs.
TEST_PBS = TFHEParams(
    name="test_pbs",
    n=64,
    lwe_std=2.0,
    N=256,
    k=1,
    glwe_std=2.0,
    bg_bits=7,
    levels=3,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=0,
)

# Production set, 128-bit-class security (CGGI gate bootstrapping).
# Magnitudes track the classic TFHE boolean parameterizations at q = 2^32:
#   - LWE n = 768, sigma/q = 2^-18  (absolute sigma = 2^14)
#   - GLWE N = 1024, k = 1, sigma/q = 2^-25 (absolute sigma = 128)
#   - PBS decomposition Bg = 2^7, l = 3 (21 bits)
#   - KS  decomposition base = 2^3, l = 5 (15 bits)
# Predicted bootstrap output noise std ~ 2^-8.7 * q against a decision margin
# of q/16 (~26 sigma).
STD128 = TFHEParams(
    name="std128",
    n=768,
    lwe_std=float(2 ** 14),
    N=1024,
    k=1,
    glwe_std=128.0,
    bg_bits=7,
    levels=3,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=128,
)

# Throughput-oriented variant: 2 decomposition levels at Bg = 2^8 (16 bits)
# instead of 3 x 7 (21 bits). The coarser gadget raises the decomposition
# noise term to roughly the same magnitude as the key-noise term
# (predicted output std ~2^-7.8 q against the q/16 margin, ~16 sigma; XOR's
# doubled noise still ~13 sigma) while cutting the external-product MACs and
# bootstrapping-key bytes by a third (R = (k+1)*l : 6 -> 4).
STD128_FAST = TFHEParams(
    name="std128_fast",
    n=768,
    lwe_std=float(2 ** 14),
    N=1024,
    k=1,
    glwe_std=128.0,
    bg_bits=8,
    levels=2,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=128,
)

# Shortint-oriented production set: N = 2048 with a much smaller GLWE noise
# (kN = 2048 at q = 2^32 is far above 128-bit even at sigma = 4) drops the
# bootstrap output noise to ~2^-11.5 q, giving ~45-sigma margins at the
# q/64 slot width of a (msg=2, carry=2) shortint working space.
# KS gadget: base 2^2 x 12 levels — the KS gadget noise (kN*l*(B^2/12)*
# lwe_std^2) dominated the PBS output sigma at the original base 2^3 x 5
# (~8.9e-4 q of the measured 9.2e-4); the finer gadget cuts it ~2.6x so
# the PACKED bivariate inputs of the radix layer (x*4 + y: noise scaled
# 4x, plus the 1.95e-3 q mod-switch floor) clear ~6.4 sigma instead of
# ~4.
STD128_SHORTINT = TFHEParams(
    name="std128_shortint",
    n=768,
    lwe_std=float(2 ** 14),
    N=2048,
    k=1,
    glwe_std=4.0,
    bg_bits=7,
    levels=3,
    ks_base_bits=2,
    ks_levels=12,
    security_bits=128,
)

# Throughput variant of the shortint set: Bg = 2^8, l = 2 (like STD128_FAST)
# at N = 2048 — cuts external-product MACs and the key (R = 6 -> 4) by a
# third.
#
# BOOL-GATE TIER ONLY: the 2+2-bit shortint stack decrypts wrong at these
# params (slot-phase std 8.27e-3 q = 1.9 sigma to the half-slot boundary;
# the l=2 decomposition noise at this glwe_std swamps the packed-bivariate
# budget).
STD128_SHORTINT_FAST = TFHEParams(
    name="std128_shortint_fast",
    n=768,
    lwe_std=float(2 ** 14),
    N=2048,
    k=1,
    glwe_std=4.0,
    bg_bits=8,
    levels=2,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=128,
    bool_only=True,  # measured: shortint margins fail (1.9 sigma, r4)
)

# The parameter set of record.  Same lattice dimension kN = 1024 (so the same
# 128-bit GLWE security and the same extracted-LWE/key-switch shapes as
# STD128/STD128_FAST) re-shaped as k = 2, N = 512.  External-product MACs
# scale as (k+1)^2/k^2 * l * (kN)^2: k=2 needs (3/2)^2/(2/1)^2 = 0.5625x
# the MACs of k=1 at equal l at fixed security.  Measured decision margin
# (decrypting bootstrap outputs): 15.9 sigma, better than STD128_FAST's 13.9
# (the (k+1)*N-proportional BSK noise term shrinks more than the mod-switch
# term grows from the halved 2N = 1024 rotation window).
STD128_K2 = TFHEParams(
    name="std128_k2",
    n=768,
    lwe_std=float(2 ** 14),
    N=512,
    k=2,
    glwe_std=128.0,
    bg_bits=8,
    levels=2,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=128,
)

# One step further along the same curve: k = 4, N = 256 (kN = 1024 still).
# MACs scale by (5/4)^2/(3/2)^2 = 0.694x vs K2 (2.56x fewer than k=1).
# The 2N = 512 rotation
# window costs another mod-switch bit; margin measured empirically before
# any promotion (K2's measured 15.9 sigma suggests ~8-11 here).
STD128_K4 = TFHEParams(
    name="std128_k4",
    n=768,
    lwe_std=float(2 ** 14),
    N=256,
    k=4,
    glwe_std=128.0,
    bg_bits=8,
    levels=2,
    ks_base_bits=3,
    ks_levels=5,
    security_bits=128,
)

# Byte-aligned l=3 shortint set (bg=2^8, levels=3, W=24): the SAME R=6
# external-product MAC count as STD128_SHORTINT's l=3 x bg=2^7 gadget, but
# with byte-aligned digits.  Closed-form margins: packed-bivariate 5.32
# sigma vs 5.42 for STD128_SHORTINT — bg 2^7->2^8 raises the per-level
# digit variance ~4x, but W growing 21->24 bits shrinks the ignored-tail
# term.
STD128_SHORTINT_B8 = dataclasses.replace(
    STD128_SHORTINT, name="std128_shortint_b8", bg_bits=8, levels=3)

# l=4 byte-aligned variant of the shortint set (bg=2^8, W=32 — an EXACT
# decomposition, zero gadget noise, margins strictly above l=3's; 4/3 more
# external-product MACs than l=3).
STD128_SHORTINT_L4 = dataclasses.replace(
    STD128_SHORTINT, name="std128_shortint_l4", bg_bits=8, levels=4)

PARAM_SETS = {
    p.name: p
    for p in (TOY, TEST_SMALL, TEST_PBS, STD128, STD128_FAST,
              STD128_SHORTINT, STD128_SHORTINT_FAST, STD128_SHORTINT_B8,
              STD128_SHORTINT_L4, STD128_K2, STD128_K4)
}
