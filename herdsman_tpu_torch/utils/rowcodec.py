"""Length-prefixed row codec + partition splitter (the data-loader hot path).

Wire/disk format, parity with the reference (reference
src/service/storage_service.cpp:19-28): each row is [u32 LE size][payload];
the stored row INCLUDES the 4-byte header ("size += sizeof(size)").

The port's copy of ``herdsman_tpu.utils.rowcodec``.  ``split_rows`` is the
native splitter ``csrc/rowcodec.cpp``, which ``ops/kernels/_build.py``
compiles with the host compiler at first use and which is loaded with
ctypes, on every device; there is no fallback: a failed build or load
raises.  ``split_rows_plain`` is the same splitter in Python, kept for the
tests to hold the native one to, message for message.  Unlike the JAX
package's native path, a failing chunk raises what the Python splitter
raises (a truncated header or payload, an overrun, the ``OSError`` of a
partition file) and leaves the same files and the same upload state:
the rows appended before the failure stay counted.  ``parse_rows`` and
``frame_rows`` are Python, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import struct
from typing import Callable, Protocol

from herdsman_tpu_torch.ops.kernels import _build


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


# hm_split_rows's failures (csrc/rowcodec.cpp)
_TRUNCATED_HEADER, _OVERRUN, _IO_ERROR, _TRUNCATED_PAYLOAD = -1, -2, -3, -4
_MESSAGES = {_TRUNCATED_HEADER: "truncated row header",
             _TRUNCATED_PAYLOAD: "truncated row payload",
             _OVERRUN: "upload overrun: all partitions full"}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/rowcodec.cpp`` with its C signature declared."""
    lib = _build.load("rowcodec")
    lib.hm_split_rows.restype = ctypes.c_int64
    lib.hm_split_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,   # data
        ctypes.c_char_p,                     # frame dir
        ctypes.POINTER(ctypes.c_int64),      # state (2 x i64 in/out)
        ctypes.POINTER(ctypes.c_int64),      # max_rows per partition
        ctypes.c_int64,                      # partitions
        ctypes.POINTER(ctypes.c_int),        # errno of a failed open/write
    ]
    return lib


def split_rows(
    data: bytes,
    frame_dir: pathlib.Path,
    state: _UploadStateLike,
    max_rows: Callable[[int], int],
    partitions: int,
) -> int:
    """Append framed rows to partition files, rolling to the next partition
    when full (reference src/service/storage_service.cpp:119-150), in the
    native splitter. Returns the number of rows consumed; on a failure,
    raises what ``split_rows_plain`` raises, after updating ``state`` to
    the rows appended."""
    caps = (ctypes.c_int64 * partitions)(
        *[max_rows(i) for i in range(partitions)])
    st = (ctypes.c_int64 * 2)(state.current_partition,
                              state.rows_stored_in_partition)
    err = ctypes.c_int(0)
    rows_read = _lib().hm_split_rows(
        bytes(data), len(data), os.fsencode(frame_dir), st, caps,
        partitions, ctypes.byref(err))
    state.current_partition = int(st[0])
    state.rows_stored_in_partition = int(st[1])
    if rows_read == _IO_ERROR:
        raise OSError(err.value, os.strerror(err.value),
                      str(pathlib.Path(frame_dir) / str(st[0])))
    if rows_read < 0:
        raise ValueError(_MESSAGES[rows_read])
    return int(rows_read)


def split_rows_plain(
    data: bytes,
    frame_dir: pathlib.Path,
    state: _UploadStateLike,
    max_rows: Callable[[int], int],
    partitions: int,
) -> int:
    """``split_rows`` in Python (the JAX package's Python branch), the
    native splitter's plain version for the tests."""
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
