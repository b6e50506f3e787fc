"""The port's native row splitter (``csrc/rowcodec.cpp`` through
``herdsman_tpu_torch.utils.rowcodec.split_rows``) against the JAX package's
``split_rows`` and the port's plain version ``split_rows_plain``.

Seeded uploads: rows of 0 to 300 bytes, cut into chunks at random row
boundaries (so chunks end mid-partition and span partition boundaries),
partition capacities by the storage service's rule (rows // parts, plus one
for the first rows % parts partitions).  On chunks that succeed the
partition files, the rows each chunk consumed and the upload state equal
the JAX package's splitter's byte for byte, run as it runs (its native
library where it was built, else its Python branch) and with its Python
branch forced; on every chunk, failing ones included (a truncated header, a
truncated payload, an overrun, a missing frame directory), they equal the
plain version's, and so does what is raised.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from herdsman_tpu.utils import rowcodec as jax_rowcodec
from herdsman_tpu_torch.utils import rowcodec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the port's other CPU test files pin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class State:
    current_partition: int = 0
    rows_stored_in_partition: int = 0


def capacities(rows: int, partitions: int):
    """The storage service's partition sizes
    (``service/storage.append_to_data_frame``)."""
    chunk, rem = divmod(rows, partitions)
    return lambda i: chunk + (1 if i < rem else 0)


def upload(seed: int):
    """(chunks, rows, partitions, payloads) of a seeded upload."""
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(1, 120))
    partitions = int(rng.integers(1, 6))
    payloads = [rng.integers(0, 256, int(rng.integers(0, 301)),
                             dtype=np.uint8).tobytes() for _ in range(rows)]
    cuts = sorted(set(rng.integers(1, rows, int(rng.integers(0, 12)))
                      .tolist())) if rows > 1 else []
    bounds = [0, *cuts, rows]
    chunks = [rowcodec.frame_rows(payloads[a:b])
              for a, b in zip(bounds, bounds[1:])]
    return chunks, rows, partitions, payloads


def run(split, chunks, frame_dir: pathlib.Path, max_rows, partitions):
    """Each chunk's outcome (rows consumed, or the exception's type, errno
    and message), the upload state after it, and the partition files."""
    state = State()
    outcomes = []
    for chunk in chunks:
        try:
            got = split(chunk, frame_dir, state, max_rows, partitions)
        except OSError as e:
            got = (type(e), e.errno, e.strerror,
                   str(pathlib.Path(e.filename).relative_to(frame_dir.parent)))
        except ValueError as e:
            got = (ValueError, str(e))
        outcomes.append((got, dataclasses.astuple(state)))
    files = ({p.name: p.read_bytes() for p in frame_dir.iterdir()}
             if frame_dir.exists() else None)
    return outcomes, files


def both(tmp_path, split_a, split_b, chunks, max_rows, partitions,
         make_dirs=True):
    out = []
    for name, split in (("a", split_a), ("b", split_b)):
        frame_dir = tmp_path / name / "frame"
        if make_dirs:
            frame_dir.mkdir(parents=True)
        else:
            frame_dir.parent.mkdir()
        out.append(run(split, chunks, frame_dir, max_rows, partitions))
    return out


@pytest.fixture(params=["as_it_runs", "python_branch"])
def jax_split(request, monkeypatch):
    """The JAX package's ``split_rows``, as it runs here or with its Python
    branch forced (no native library)."""
    if request.param == "python_branch":
        monkeypatch.setattr(jax_rowcodec, "_native", None)
        monkeypatch.setattr(jax_rowcodec, "_native_checked", True)
    return jax_rowcodec.split_rows


@pytest.mark.parametrize("seed", range(12))
def test_native_splitter_equals_jax_and_plain(tmp_path, jax_split, seed):
    chunks, rows, partitions, _ = upload(seed)
    max_rows = capacities(rows, partitions)
    native, jax = both(tmp_path, rowcodec.split_rows, jax_split, chunks,
                       max_rows, partitions)
    assert native == jax
    outcomes, files = native
    assert sum(got for got, _ in outcomes) == rows
    assert outcomes[-1][1] == (min(rows, partitions), 0)
    assert b"".join(files[str(i)] for i in range(len(files))) == \
        b"".join(chunks)
    native2, plain = both(tmp_path / "again", rowcodec.split_rows,
                          rowcodec.split_rows_plain, chunks, max_rows,
                          partitions)
    assert native2 == plain == native


# bytes that end a chunk in the middle of a row
FAULTS = {"truncated_header": (b"\x05\x00", "truncated row header"),
          "truncated_payload": (b"\x09\x00\x00\x00abc",
                                "truncated row payload")}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_truncated_chunk_equals_plain(tmp_path, fault, seed):
    """A chunk that breaks off after a seeded number of rows raises the
    plain version's message and leaves its files and upload state: the rows
    before the fault stay appended and counted, and the chunks after it go
    on (and overrun at the end) as the plain version's do."""
    _, rows, partitions, payloads = upload(100 + seed)
    tail, message = FAULTS[fault]
    r = int(np.random.default_rng(seed).integers(0, rows))
    chunks = [rowcodec.frame_rows(payloads[:r]) + tail,
              rowcodec.frame_rows(payloads[r:]),
              rowcodec.frame_rows([b"after"])]
    native, plain = both(tmp_path, rowcodec.split_rows,
                         rowcodec.split_rows_plain, chunks,
                         capacities(rows, partitions), partitions)
    assert native == plain
    outcomes, files = native
    assert [got for got, _ in outcomes] == [
        (ValueError, message), rows - r,
        (ValueError, "upload overrun: all partitions full")]
    assert b"".join(files[str(i)] for i in range(len(files))) == \
        rowcodec.frame_rows(payloads)


@pytest.mark.parametrize("seed", range(4))
def test_overrun_equals_plain(tmp_path, seed):
    """Rows past the last partition's capacity: the plain version's
    message, files and state, on the chunk that crosses the end and on a
    later one."""
    chunks, rows, partitions, _ = upload(200 + seed)
    chunks = [*chunks, rowcodec.frame_rows([b"x", b"yz"]),
              rowcodec.frame_rows([b""])]
    native, plain = both(tmp_path, rowcodec.split_rows,
                         rowcodec.split_rows_plain, chunks,
                         capacities(rows, partitions), partitions)
    assert native == plain
    outcomes, _ = native
    assert outcomes[-2:] == [
        ((ValueError, "upload overrun: all partitions full"),
         (min(rows, partitions), 0))] * 2


def test_truncated_first_row_of_a_partition(tmp_path):
    """A chunk that fills partition 0 exactly and then breaks off: both
    splitters roll to partition 1, create its file empty and count no row
    in it."""
    chunks = [rowcodec.frame_rows([b"a", b"bc"]) + b"\x01"]
    native, plain = both(tmp_path, rowcodec.split_rows,
                         rowcodec.split_rows_plain, chunks, lambda i: 2, 2)
    assert native == plain
    outcomes, files = native
    assert outcomes == [((ValueError, "truncated row header"), (1, 0))]
    assert files == {"0": rowcodec.frame_rows([b"a", b"bc"]), "1": b""}


def test_missing_frame_dir_raises_the_plain_oserror(tmp_path):
    chunks = [rowcodec.frame_rows([b"row"])]
    native, plain = both(tmp_path, rowcodec.split_rows,
                         rowcodec.split_rows_plain, chunks, lambda i: 1, 1,
                         make_dirs=False)
    assert native == plain
    (got, state), = native[0]
    assert got[0] is FileNotFoundError and got[3] == "frame/0"
    assert state == (0, 0) and native[1] is None


def test_empty_chunk_touches_nothing(tmp_path):
    native, plain = both(tmp_path, rowcodec.split_rows,
                         rowcodec.split_rows_plain, [b""], lambda i: 1, 1)
    assert native == plain == ([(0, (0, 0))], {})


def test_split_rows_has_no_fallback(monkeypatch, tmp_path):
    """A failed build or load raises; the plain version never stands in."""
    def broken(name):
        raise RuntimeError(f"build failed for {name}")

    rowcodec._lib.cache_clear()
    monkeypatch.setattr(rowcodec._build, "load", broken)
    try:
        with pytest.raises(RuntimeError, match="build failed for rowcodec"):
            rowcodec.split_rows(rowcodec.frame_rows([b"x"]), tmp_path,
                                State(), lambda i: 1, 1)
        assert not list(tmp_path.iterdir())
    finally:
        monkeypatch.undo()
        rowcodec._lib.cache_clear()
