"""Length-prefixed row codec + partition splitter (the data-loader hot path).

Wire/disk format, parity with the reference (reference
src/service/storage_service.cpp:19-28): each row is [u32 LE size][payload];
the stored row INCLUDES the 4-byte header ("size += sizeof(size)").

The port's copy of ``herdsman_tpu.utils.rowcodec`` with its pure-Python
splitter only: the JAX package's native splitter (``native/rowcodec.cpp``,
loaded with ctypes) is not ported yet.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Callable, Protocol


class _UploadStateLike(Protocol):
    current_partition: int
    rows_stored_in_partition: int


_U32 = struct.Struct("<I")


def parse_rows(data: bytes) -> list[bytes]:
    """Parse framed rows -> list of payloads (headers stripped)."""
    rows = []
    off = 0
    n = len(data)
    while off < n:
        if off + 4 > n:
            raise ValueError("truncated row header")
        (size,) = _U32.unpack_from(data, off)
        if off + 4 + size > n:
            raise ValueError("truncated row payload")
        rows.append(data[off + 4 : off + 4 + size])
        off += 4 + size
    return rows


def frame_rows(payloads: list[bytes]) -> bytes:
    """Frame payloads with u32 size headers."""
    out = bytearray()
    for p in payloads:
        out += _U32.pack(len(p))
        out += p
    return bytes(out)


def split_rows(
    data: bytes,
    frame_dir: pathlib.Path,
    state: _UploadStateLike,
    max_rows: Callable[[int], int],
    partitions: int,
) -> int:
    """Append framed rows to partition files, rolling to the next partition
    when full (reference src/service/storage_service.cpp:119-150). Returns
    the number of rows consumed."""
    rows_read = 0
    off = 0
    n = len(data)
    while off < n:
        if state.current_partition >= partitions:
            raise ValueError("upload overrun: all partitions full")
        part_path = frame_dir / str(state.current_partition)
        cap = max_rows(state.current_partition)
        with open(part_path, "ab") as f:
            while off < n:
                if off + 4 > n:
                    raise ValueError("truncated row header")
                (size,) = _U32.unpack_from(data, off)
                end = off + 4 + size
                if end > n:
                    raise ValueError("truncated row payload")
                f.write(data[off:end])  # stored row includes the header
                off = end
                rows_read += 1
                state.rows_stored_in_partition += 1
                if state.rows_stored_in_partition == cap:
                    state.current_partition += 1
                    state.rows_stored_in_partition = 0
                    break
    return rows_read
