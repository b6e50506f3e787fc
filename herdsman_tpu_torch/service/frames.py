"""Ciphertext row (de)serialization between disk frames and device arrays.

A TFHE_BOOL row with `total_bits` column bits is stored as the little-endian
uint32 dump of its [total_bits, n+1] LWE ciphertext block; rows travel inside
the length-prefixed framing of utils.rowcodec (reference wire format,
src/service/storage_service.cpp:19-28)."""

from __future__ import annotations

import numpy as np

from herdsman_tpu_torch.core.params import TFHEParams


def row_to_bytes(row: np.ndarray) -> bytes:
    """[total_bits, n+1] uint32 -> bytes."""
    return np.ascontiguousarray(row, dtype="<u4").tobytes()


def bytes_to_row(data: bytes, total_bits: int, params: TFHEParams) -> np.ndarray:
    width = params.n + 1
    expect = total_bits * width * 4
    if len(data) != expect:
        raise ValueError(
            f"row payload is {len(data)} bytes, expected {expect} "
            f"({total_bits} bits x {width} x u32)"
        )
    return np.frombuffer(data, dtype="<u4").reshape(total_bits, width).copy()


def rows_to_payloads(rows: np.ndarray) -> list[bytes]:
    """[R, total_bits, n+1] -> list of row payloads."""
    return [row_to_bytes(rows[i]) for i in range(rows.shape[0])]


def payloads_to_rows(payloads: list[bytes], total_bits: int,
                     params: TFHEParams) -> np.ndarray:
    if not payloads:
        return np.zeros((0, total_bits, params.n + 1), dtype=np.uint32)
    return np.stack(
        [bytes_to_row(p, total_bits, params) for p in payloads], axis=0
    )
