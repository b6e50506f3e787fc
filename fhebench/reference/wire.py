"""The wire form of a frame's rows: what a client uploads and downloads.

Written from the format, not taken from the program:

- a frame travels as rows, each a u32 little-endian byte count followed by
  that many bytes of payload (the upstream's length-prefixed rows,
  herdsman ``src/service/storage_service.cpp:19-28``);
- a TFHE_BOOL row's payload is the little-endian u32 dump of its
  ciphertexts [bits, n+1]: one LWE ciphertext a bit, mask first and body
  last, the bits in the columns' declaration order and each column least
  significant bit first (``plans.row_bits``).
"""

from __future__ import annotations

import numpy as np
import torch

U32 = np.dtype("<u4")


def frame(cts: torch.Tensor) -> bytes:
    """Rows of ciphertexts [R, bits, n+1] (torus values) -> framed rows."""
    rows = np.ascontiguousarray(cts.cpu().numpy().astype(U32))
    payload = rows.reshape(rows.shape[0], -1).view(np.uint8)
    size = np.full((rows.shape[0], 1), payload.shape[1], U32)
    return np.concatenate([size.view(np.uint8), payload], axis=1).tobytes()


def parse(data: bytes, bits: int, n: int) -> torch.Tensor:
    """Framed rows of ``bits`` ciphertexts of width n+1 -> [R, bits, n+1]
    torus values (int64).  A row of another size, or a frame that ends
    inside a row, raises."""
    width = 4 * bits * (n + 1)
    if len(data) % (4 + width):
        raise ValueError(f"a frame of {len(data)} bytes is no whole number "
                         f"of {4 + width}-byte rows")
    raw = np.frombuffer(data, np.uint8).reshape(-1, 4 + width)
    sizes = raw[:, :4].copy().view(U32)[:, 0]
    if (sizes != width).any():
        raise ValueError(f"row sizes {sorted(set(sizes.tolist()))}, "
                         f"expected {width}")
    rows = raw[:, 4:].copy().view(U32).reshape(-1, bits, n + 1)
    return torch.from_numpy(rows.astype(np.int64))
