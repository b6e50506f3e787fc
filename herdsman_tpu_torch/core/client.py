"""Client-side table encryption/decryption — the port's copy of
``herdsman_tpu.core.client`` (the `herd` client-library analog, SURVEY.md
§2.5): row tables, seeded row tables (one u32 body per bit on the wire) and
the coordinator's GLWE-packed downloads.

A table is a sequence of rows; each row one Python int per column. Encrypted
layout matches the compiler: [rows, total_bits, n+1] uint32, column bits
concatenated in declaration order, LSB-first.
"""

from __future__ import annotations

import secrets
import struct
from typing import Sequence

import numpy as np

from herdsman_tpu_torch.circuit.model import ColumnMeta
from herdsman_tpu_torch.core import reference as ref


def _row_bits(columns: Sequence[ColumnMeta],
              rows: Sequence[Sequence[int]]) -> np.ndarray:
    """A cleartext table as its bits: [rows, total_bits] bool, column bits
    concatenated in declaration order, LSB-first."""
    total_bits = sum(c.dtype.bit_width for c in columns)
    bits = np.zeros((len(rows), total_bits), dtype=bool)
    for r, row in enumerate(rows):
        assert len(row) == len(columns), "row arity mismatch"
        off = 0
        for val, col in zip(row, columns):
            w = col.dtype.bit_width
            for i in range(w):
                bits[r, off + i] = (int(val) >> i) & 1
            off += w
    return bits


def encrypt_rows(
    ck: ref.ClientKey,
    columns: Sequence[ColumnMeta],
    rows: Sequence[Sequence[int]],
    rng: np.random.Generator,
) -> np.ndarray:
    """Encrypt a cleartext table: -> [rows, total_bits, n+1] uint32."""
    return ref.encrypt_bool(ck, _row_bits(columns, rows), rng)


def encrypt_rows_seeded(
    ck: ref.ClientKey,
    columns: Sequence[ColumnMeta],
    rows: Sequence[Sequence[int]],
    rng: np.random.Generator,
    seed: int | None = None,
) -> tuple[np.ndarray, int]:
    """Seeded table encryption: -> (bodies [rows, total_bits] uint32, seed).

    Upload the bodies through ``begin_data_frame_upload(...,
    seeded_seed=seed)``: the wire carries one u32 per bit instead of n+1
    (~770x less at n = 768), and the coordinator expands the rows at
    ingest.

    SECURITY: the seed determines the Philox-derived LWE masks. Reusing a
    seed under the same client key reuses masks, so ct1 - ct2 leaks
    plaintext relations directly. Leave ``seed=None`` (the default) to
    draw a fresh CSPRNG seed per call; a seed passed in MUST be unique per
    (key, upload stream)."""
    if seed is None:
        seed = secrets.randbits(64)
    bits = _row_bits(columns, rows)
    bodies = ref.encrypt_bool_seeded(ck, bits.reshape(-1), seed, rng)
    return bodies.reshape(bits.shape), seed


def decrypt_rows_packed(
    ck: ref.ClientKey,
    columns: Sequence[ColumnMeta],
    partitions: Sequence[bytes],
) -> list[dict[str, int]]:
    """Decrypt the partitions of a GLWE-packed download (the coordinator's
    ``download_data_frame_packed`` stream: [u32 n_cts][u32 n_groups], then
    n_groups GLWEs of (k+1)*N u32 each)."""
    p = ck.params
    total_bits = sum(c.dtype.bit_width for c in columns)
    bits_flat: list[np.ndarray] = []
    for blob in partitions:
        n_cts, n_groups = struct.unpack_from("<II", blob, 0)
        off = 8
        got = 0
        for _ in range(n_groups):
            g = np.frombuffer(blob, dtype=np.uint32, count=(p.k + 1) * p.N,
                              offset=off).reshape(p.k + 1, p.N)
            take = min(p.N, n_cts - got)
            bits_flat.append(ref.unpack_bools(ck, g, take))
            got += take
            off += (p.k + 1) * p.N * 4
        assert got == n_cts, "packed stream truncated"
    bits = (np.concatenate(bits_flat) if bits_flat
            else np.zeros(0, dtype=bool)).reshape(-1, total_bits)
    return _bits_to_rows(columns, bits)


def decrypt_rows(
    ck: ref.ClientKey,
    columns: Sequence[ColumnMeta],
    cts: np.ndarray,
) -> list[dict[str, int]]:
    """Decrypt [rows, total_bits, n+1] -> one {column: int} dict per row."""
    return _bits_to_rows(columns, ref.lwe_decrypt_bool(ck, np.asarray(cts)))


def _bits_to_rows(columns: Sequence[ColumnMeta],
                  bits: np.ndarray) -> list[dict[str, int]]:
    """[rows, total_bits] bool -> one {column: int} dict per row."""
    out = []
    for r in range(bits.shape[0]):
        row = {}
        off = 0
        for col in columns:
            w = col.dtype.bit_width
            val = 0
            for i in range(w):
                val |= int(bits[r, off + i]) << i
            if col.dtype.signed and bits[r, off + w - 1]:
                val -= 1 << w
            row[col.name] = val
            off += w
        out.append(row)
    return out
