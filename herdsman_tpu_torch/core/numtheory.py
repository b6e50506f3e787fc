"""Host-side number theory for the NTT/RNS path: NTT-friendly primes,
primitive roots, twiddle tables (exact Python ints; device tables as u32).

The port's own copy of ``herdsman_tpu.core.numtheory`` (NumPy only);
``tests/test_torch_hygiene.py`` holds it equal to the original."""

from __future__ import annotations

import functools

import numpy as np


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


# Largest value exactly representable by 3 balanced signed 8-bit digits
# (range [-0x808080, 0x7F7F7F + ... ] => max 2^24 - 0x808080 - 1)
MAX_DIGIT3 = (1 << 24) - 0x808080 - 1  # 8 355 711


@functools.lru_cache(maxsize=None)
def ntt_primes(two_n: int, count: int, bits: int = 24,
               cap: int | None = None) -> tuple[int, ...]:
    """`count` primes p <= cap (default 2^bits - 1) with p ≡ 1 (mod two_n),
    largest first."""
    cap = cap if cap is not None else (1 << bits) - 1
    out = []
    k = cap // two_n
    while k > 0 and len(out) < count:
        p = k * two_n + 1
        if p <= cap and is_prime(p):
            out.append(p)
        k -= 1
    if len(out) < count:
        raise ValueError(f"not enough NTT primes <= {cap} for 2N={two_n}")
    return tuple(out)


def primitive_root(p: int) -> int:
    """Smallest primitive root mod prime p."""
    factors = []
    phi = p - 1
    m = phi
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
    raise ValueError("no primitive root")


def root_of_unity(p: int, order: int) -> int:
    """An element of exact multiplicative order `order` mod p."""
    assert (p - 1) % order == 0
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) != 1
    return w


def powers_mod(base: int, count: int, p: int) -> np.ndarray:
    """[base^0, ..., base^(count-1)] mod p as uint32."""
    out = np.empty(count, dtype=np.uint64)
    acc = 1
    for i in range(count):
        out[i] = acc
        acc = acc * base % p
    return out.astype(np.uint32)
