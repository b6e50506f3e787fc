"""Programmable bootstrapping (functional/LUT bootstrap) — the port of
``herdsman_tpu.ops.pbs``.

Beyond boolean gates: a bootstrap whose test polynomial encodes an arbitrary
look-up table evaluates f(m) for a small integer message m while refreshing
noise — the building block of shortint-style arithmetic (tfhe-rs shortint,
OpenFHE EvalFunc).

Encoding: messages m in [0, 2^msg_bits) with one padding bit, i.e.
Delta = q / 2^(msg_bits+1); the padding bit keeps the phase in the positive
half-torus so the negacyclic constraint (v(X + N) = -v(X)) never bites.
The LUT output uses the same encoding, so PBS outputs compose.

The pipeline runs eagerly (the JAX package's ``unroll`` form): one blind
rotation, then k sample extracts, then one key switch over their
concatenation.  The engine defaults to ``mega12``, the integer tier's
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops.server_key import DeviceServerKey
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, resolve_device, to_device


def _centered(v: np.ndarray, half: int) -> np.ndarray:
    """v rotated by X^{-half}: coefficients wrapping past index 0 negate
    (X^N = -1)."""
    if not half:
        return v
    return np.concatenate([v[half:], np.uint32(0) - v[:half]])


def lut_test_poly(params: TFHEParams, table, msg_bits: int,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Test polynomial [N] (int32 carrier) for f given as ``table`` (length
    2^msg_bits ints, values in [0, 2^msg_bits)).

    Phase m*Delta mod-switches to m * 2N / 2^(msg_bits+1); coefficient
    windows of v must hold f(m)*Delta over the window centered on each m
    (half-window shifted so rounding noise lands inside the right segment).
    """
    p = params
    space = 1 << (msg_bits + 1)  # incl. padding bit
    if len(table) != 1 << msg_bits:
        raise ValueError(f"table has {len(table)} entries, not "
                         f"{1 << msg_bits}")
    delta = (1 << 32) // space
    window = 2 * p.N // space     # coefficients per message segment
    if window < 1:
        raise ValueError("message space too large for N")
    v = np.zeros(p.N, dtype=np.uint32)
    # indices >= N fold negacyclically; with a padding bit the phase never
    # reaches them, so they stay 0
    for m in range(1 << msg_bits):
        val = np.uint32(((int(table[m]) % space) * delta) & 0xFFFFFFFF)
        v[m * window:min((m + 1) * window, p.N)] = val
    return from_numpy_u32(_centered(v, window // 2), device)


def encode(params: TFHEParams, m, msg_bits: int) -> np.ndarray:
    delta = (1 << 32) // (1 << (msg_bits + 1))
    return (np.asarray(m, dtype=np.uint64) * delta & 0xFFFFFFFF).astype(
        np.uint32)


def decode(params: TFHEParams, phase: np.ndarray, msg_bits: int) -> np.ndarray:
    space = 1 << (msg_bits + 1)
    delta = (1 << 32) // space
    return ((phase.astype(np.uint64) + delta // 2) // delta % space).astype(
        np.int64) % (1 << msg_bits)


def rotate_extract_switch(dsk: DeviceServerKey, ct: torch.Tensor,
                          tv: torch.Tensor, engine: str,
                          k: int) -> torch.Tensor:
    """k interleaved LUTs from one rotation: rotate, extract coefficients
    0..k-1, one key switch over the k extracts: [B, n+1] -> [k*B, n+1]."""
    acc = bs.blind_rotate_batch(dsk, ct, tv, engine=engine,
                                coarse_bits=k.bit_length() - 1)
    raws = [bs.sample_extract_batch(dsk.params, acc, offset=j)
            for j in range(k)]
    return bs.key_switch_batch(dsk, torch.cat(raws))


def pbs_batch(dsk: DeviceServerKey, ct, table, msg_bits: int,
              engine: str = "mega12",
              device: str | torch.device = "cuda") -> torch.Tensor:
    """Apply f (the LUT) under encryption with noise refresh:
    [B, n+1] -> [B, n+1], messages in [0, 2^msg_bits).  ``ct`` is a numpy
    uint32 array or an int32 carrier tensor; it is moved to ``device``,
    which must be the key's."""
    dev = dsk.check_device(resolve_device(device))
    tv = lut_test_poly(dsk.params, table, msg_bits, device=dev)
    return rotate_extract_switch(dsk, to_device(ct, dev), tv, engine, 1)


# ---------------------------------------------------------------------------
# Many-LUT PBS (PBSmanyLUT, Chillotti-Ligier-Orfila-Tap class): k LUTs from
# ONE blind rotation. The modulus switch rounds to multiples of k (rotation
# lands on every k-th coefficient), the test polynomial interleaves the k
# functions at fine indices k*u + j, and coefficient j is sample-extracted
# per LUT. Cost: one rotation + k cheap extract/key-switch passes instead of
# k full rotations; the price is a k-times-coarser rounding window.
# ---------------------------------------------------------------------------

def many_lut_capacity(params: TFHEParams, msg_bits: int,
                      min_window: int = 32) -> int:
    """Largest power-of-two LUT count whose per-message fine-index window
    stays >= min_window (the mod-switch noise safety criterion; 32 fine
    indices leaves ~5 sigma at n=768)."""
    space = 1 << (msg_bits + 1)
    k = 1
    while 2 * params.N // (space * 2 * k) >= min_window:
        k *= 2
    return k


def lut_test_poly_many(params: TFHEParams, tables, msg_bits: int,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """Interleaved test polynomial: fine coefficient k*u + j holds
    f_j(message of coarse index u). The k=1 case reduces to
    lut_test_poly."""
    p = params
    k = len(tables)
    if k & (k - 1):
        raise ValueError("LUT count must be a power of two")
    space = 1 << (msg_bits + 1)
    window_c = (2 * p.N // k) // space  # coarse indices per message
    if window_c < 1:
        raise ValueError("message space too large for N/k")
    delta = (1 << 32) // space
    v = np.zeros(p.N, dtype=np.uint32)
    for m in range(1 << msg_bits):
        vals = [np.uint32((int(t[m]) % space * delta) & 0xFFFFFFFF)
                for t in tables]
        for uu in range(window_c):
            base = k * (m * window_c + uu)
            for j in range(k):
                if base + j < p.N:
                    v[base + j] = vals[j]
    return from_numpy_u32(_centered(v, k * window_c // 2), device)


def pbs_many_batch(dsk: DeviceServerKey, ct, tables, msg_bits: int,
                   engine: str = "mega12",
                   device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """Evaluate k LUTs over the SAME ciphertext batch with one blind
    rotation: [B, n+1] -> k x [B, n+1]. The k key switches run as one
    batched int8 product."""
    k = len(tables)
    if k == 1:
        return [pbs_batch(dsk, ct, tables[0], msg_bits, engine=engine,
                          device=device)]
    if k & (k - 1):
        raise ValueError("LUT count must be a power of two")
    dev = dsk.check_device(resolve_device(device))
    tv = lut_test_poly_many(dsk.params, tables, msg_bits, device=dev)
    ct = to_device(ct, dev)
    return list(rotate_extract_switch(dsk, ct, tv, engine, k).chunk(k))
