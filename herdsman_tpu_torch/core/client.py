"""Client-side table encryption/decryption — the port's copy of
``encrypt_rows`` and ``decrypt_rows`` of ``herdsman_tpu.core.client`` (the
`herd` client-library analog, SURVEY.md §2.5).  The seeded and packed
variants are not ported yet (ROADMAP queue 1, items 14 and 9).

A table is a sequence of rows; each row one Python int per column. Encrypted
layout matches the compiler: [rows, total_bits, n+1] uint32, column bits
concatenated in declaration order, LSB-first.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from herdsman_tpu_torch.circuit.model import ColumnMeta
from herdsman_tpu_torch.core import reference as ref


def encrypt_rows(
    ck: ref.ClientKey,
    columns: Sequence[ColumnMeta],
    rows: Sequence[Sequence[int]],
    rng: np.random.Generator,
) -> np.ndarray:
    """Encrypt a cleartext table: -> [rows, total_bits, n+1] uint32."""
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
    return ref.encrypt_bool(ck, bits, rng)


def decrypt_rows(
    ck: ref.ClientKey,
    columns: Sequence[ColumnMeta],
    cts: np.ndarray,
) -> list[dict[str, int]]:
    """Decrypt [rows, total_bits, n+1] -> one {column: int} dict per row."""
    bits = ref.lwe_decrypt_bool(ck, np.asarray(cts))
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
