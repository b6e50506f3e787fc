"""StorageService — encrypted data-frame store (the port's copy of
``herdsman_tpu.service.storage``), parity with the reference (reference
include/service/storage_service.hpp, src/service/storage_service.cpp):

- disk layout  storage_dir/<session_uuid>/<frame_uuid>/<partition_index>
  (reference :229-251);
- rows are length-prefixed: [u32 size][payload], the stored row includes the
  header (reference :19-28);
- partition sizes: rows//parts with the first rows%parts partitions getting
  +1 row (reference :121-147, re-derived in get_partition_size :321-332);
- streamed append splits rows across partition files in order;
- catalog entries carry {uuid, name, schema_type, columns, row_count,
  partitions, uploaded, busy}.

The row splitter is the pure-Python one of ``utils.rowcodec`` (the JAX
package's native C++ splitter is not ported yet).

Deviation (deliberate fix): the reference sets `busy` at job schedule and
never clears it (SURVEY.md §2.1); here unlock_data_frame exists and the
ExecutionService calls it on job completion.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
import uuid as uuid_mod
from typing import Optional, Sequence

from herdsman_tpu_torch.circuit.model import ColumnMeta, SchemaType
from herdsman_tpu_torch.service.errors import (
    ObjectNotFoundException,
    ResourceLockedException,
)
from herdsman_tpu_torch.utils import rowcodec


@dataclasses.dataclass
class DataFrameEntry:
    uuid: str
    name: str
    schema_type: SchemaType
    columns: tuple[ColumnMeta, ...]
    row_count: int
    partitions: int
    uploaded: bool = False
    busy: int = 0  # refcount (reference uses a never-cleared bool)
    # GLWE-domain storage: partitions hold packed GLWE blobs ((k+1)*N u32
    # each, up to N LWE bits packed per blob) instead of per-row LWE
    # payloads; unpacked on load via ops.pack.unpack_lwes_batch
    glwe_packed: bool = False


@dataclasses.dataclass
class _UploadState:
    current_partition: int = 0
    rows_stored_in_partition: int = 0
    rows_total: int = 0


class StorageService:
    """The catalog is persisted to <storage_dir>/catalog.json and rehydrated
    on startup, so frames survive a coordinator restart (the reference keeps
    its catalog multimaps purely in-memory and loses them, SURVEY.md §5
    checkpoint/resume: "jobs and catalogs do not [survive]")."""

    def __init__(self, storage_dir: str | pathlib.Path,
                 catalog_backend: str = "json"):
        assert catalog_backend in ("json", "sqlite"), catalog_backend
        self._dir = pathlib.Path(storage_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._frames: dict[str, list[DataFrameEntry]] = {}
        self._uploads: dict[str, _UploadState] = {}
        self._backend = catalog_backend
        self._db = None
        if catalog_backend == "sqlite":
            self._open_db()
        self._load_catalog()

    # ---- durability ----

    @property
    def _catalog_path(self) -> pathlib.Path:
        return self._dir / "catalog.json"

    @property
    def _db_path(self) -> pathlib.Path:
        return self._dir / "catalog.db"

    def _open_db(self) -> None:
        """WAL-mode SQLite catalog: crash-safe, transactional saves for a
        SINGLE coordinator process.  (Saves rewrite the table from this
        process's in-memory snapshot, so two coordinators sharing a
        storage dir would still lose each other's updates — same
        single-owner model as the reference's in-memory catalog.)  The
        reference finds SQLite3 but never uses it (reference
        CMakeLists.txt:76,215 — a planned-but-unbuilt persistence
        layer); this implements it."""
        import sqlite3

        self._db = sqlite3.connect(str(self._db_path),
                                   check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS frames ("
            " session TEXT NOT NULL, uuid TEXT NOT NULL,"
            " name TEXT NOT NULL, schema_type INTEGER NOT NULL,"
            " columns TEXT NOT NULL, row_count INTEGER NOT NULL,"
            " partitions INTEGER NOT NULL, uploaded INTEGER NOT NULL,"
            " glwe_packed INTEGER NOT NULL, ord_idx INTEGER NOT NULL,"
            " PRIMARY KEY (session, uuid))")
        self._db.commit()

    def _entry_dict(self, e: DataFrameEntry) -> dict:
        return {
            "uuid": e.uuid,
            "name": e.name,
            "schema_type": int(e.schema_type),
            "columns": [
                {"name": c.name, "dtype": int(c.dtype)} for c in e.columns
            ],
            "row_count": e.row_count,
            "partitions": e.partitions,
            "uploaded": e.uploaded,
            "glwe_packed": e.glwe_packed,
        }

    @staticmethod
    def _entry_from_dict(e: dict) -> DataFrameEntry:
        from herdsman_tpu_torch.circuit.model import DataType

        return DataFrameEntry(
            uuid=e["uuid"],
            name=e["name"],
            schema_type=SchemaType(e["schema_type"]),
            columns=tuple(
                ColumnMeta(c["name"], DataType(c["dtype"]))
                for c in e["columns"]
            ),
            row_count=e["row_count"],
            partitions=e["partitions"],
            uploaded=e["uploaded"],
            glwe_packed=e.get("glwe_packed", False),
        )

    def _save_catalog(self) -> None:
        import json

        if self._backend == "sqlite":
            with self._db:  # one transaction: readers never see half-state
                self._db.execute("DELETE FROM frames")
                self._db.executemany(
                    "INSERT INTO frames VALUES (?,?,?,?,?,?,?,?,?,?)",
                    [
                        (session, e.uuid, e.name, int(e.schema_type),
                         json.dumps([{"name": c.name, "dtype": int(c.dtype)}
                                     for c in e.columns]),
                         e.row_count, e.partitions, int(e.uploaded),
                         int(e.glwe_packed), i)
                        for session, entries in self._frames.items()
                        for i, e in enumerate(entries)
                    ],
                )
            return
        data = {
            session: [self._entry_dict(e) for e in entries]
            for session, entries in self._frames.items()
        }
        tmp = self._catalog_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data))
        tmp.replace(self._catalog_path)

    def _load_catalog(self) -> None:
        import json

        if self._backend == "sqlite":
            rows = self._db.execute(
                "SELECT session, uuid, name, schema_type, columns,"
                " row_count, partitions, uploaded, glwe_packed"
                " FROM frames ORDER BY session, ord_idx").fetchall()
            if not rows and self._catalog_path.exists():
                # one-shot migration from the json sidecar
                data = json.loads(self._catalog_path.read_text())
                for session, entries in data.items():
                    self._frames[session] = [
                        self._entry_from_dict(e) for e in entries
                    ]
                self._save_catalog()
                return
            for (session, uuid, name, schema_type, columns, row_count,
                 partitions, uploaded, glwe_packed) in rows:
                self._frames.setdefault(session, []).append(
                    self._entry_from_dict({
                        "uuid": uuid, "name": name,
                        "schema_type": schema_type,
                        "columns": json.loads(columns),
                        "row_count": row_count, "partitions": partitions,
                        "uploaded": bool(uploaded),
                        "glwe_packed": bool(glwe_packed),
                    }))
            return
        if not self._catalog_path.exists():
            return
        data = json.loads(self._catalog_path.read_text())
        for session, entries in data.items():
            self._frames[session] = [
                self._entry_from_dict(e) for e in entries
            ]

    # ---- helpers ----

    def _find(self, session_uuid: str, frame_uuid: str) -> DataFrameEntry:
        for e in self._frames.get(session_uuid, []):
            if e.uuid == frame_uuid:
                return e
        raise ObjectNotFoundException(f"no data frame {frame_uuid}")

    def frame_dir(self, session_uuid: str, frame_uuid: str) -> pathlib.Path:
        return self._dir / session_uuid / frame_uuid

    def partition_path(self, session_uuid: str, frame_uuid: str,
                       partition: int) -> pathlib.Path:
        return self.frame_dir(session_uuid, frame_uuid) / str(partition)

    # ---- catalog ----

    def create_data_frame(
        self,
        session_uuid: str,
        name: str,
        schema_type: SchemaType,
        columns: Sequence[ColumnMeta],
        row_count: int,
        partitions: int,
    ) -> str:
        if not (0 < partitions <= row_count):
            # reference validation src/controller/storage_controller.cpp:66-73
            raise ValueError(
                f"partitions must be in (0, row_count]; got {partitions} "
                f"for {row_count} rows"
            )
        with self._lock:
            frame_uuid = str(uuid_mod.uuid4())
            entry = DataFrameEntry(
                frame_uuid, name, schema_type, tuple(columns), row_count,
                partitions,
            )
            self._frames.setdefault(session_uuid, []).append(entry)
            self.frame_dir(session_uuid, frame_uuid).mkdir(
                parents=True, exist_ok=True
            )
            self._uploads[frame_uuid] = _UploadState()
            self._save_catalog()
            return frame_uuid

    def data_frame_exists(self, session_uuid: str, frame_uuid: str) -> bool:
        with self._lock:
            try:
                self._find(session_uuid, frame_uuid)
                return True
            except ObjectNotFoundException:
                return False

    def get_data_frame(self, session_uuid: str,
                       frame_uuid: str) -> DataFrameEntry:
        with self._lock:
            return dataclasses.replace(self._find(session_uuid, frame_uuid))

    def list_session_data_frames(
        self, session_uuid: str, schema_type: Optional[SchemaType] = None
    ) -> list[DataFrameEntry]:
        with self._lock:
            out = [
                dataclasses.replace(e)
                for e in self._frames.get(session_uuid, [])
            ]
        if schema_type is not None:
            out = [e for e in out if e.schema_type == schema_type]
        return out

    # ---- partition math (reference formula) ----

    def get_partition_size(self, session_uuid: str, frame_uuid: str,
                           partition: int) -> int:
        e = self.get_data_frame(session_uuid, frame_uuid)
        chunk = e.row_count // e.partitions
        rem = e.row_count % e.partitions
        return chunk + (1 if partition < rem else 0)

    def get_partition_count(self, session_uuid: str, frame_uuid: str) -> int:
        return self.get_data_frame(session_uuid, frame_uuid).partitions

    # ---- streamed upload ----

    def append_to_data_frame(self, session_uuid: str, frame_uuid: str,
                             data: bytes) -> int:
        """Append a chunk of length-prefixed rows, splitting across partition
        files (reference src/service/storage_service.cpp:100-150). Returns
        rows read. Raises ValueError on overrun or a truncated row."""
        with self._lock:
            entry = self._find(session_uuid, frame_uuid)
            state = self._uploads.get(frame_uuid)
            if state is None:
                state = self._uploads[frame_uuid] = _UploadState()
            chunk = entry.row_count // entry.partitions
            rem = entry.row_count % entry.partitions

            def max_rows(partition: int) -> int:
                return chunk + (1 if partition < rem else 0)

            frame_dir = self.frame_dir(session_uuid, frame_uuid)
            rows_read = rowcodec.split_rows(
                data,
                frame_dir,
                state,
                max_rows,
                entry.partitions,
            )
            state.rows_total += rows_read
            if state.rows_total > entry.row_count:
                raise ValueError(
                    f"upload overrun: {state.rows_total} > {entry.row_count}"
                )
            return rows_read

    def set_glwe_packed(self, session_uuid: str, frame_uuid: str) -> None:
        """Mark a frame's partitions as GLWE-packed (written out-of-band
        by the runner; bypasses streamed-upload row accounting)."""
        with self._lock:
            entry = self._find(session_uuid, frame_uuid)
            entry.glwe_packed = True
            entry.uploaded = True
            self._uploads.pop(frame_uuid, None)
            self._save_catalog()

    def mark_data_frame_as_uploaded(self, session_uuid: str,
                                    frame_uuid: str) -> None:
        with self._lock:
            entry = self._find(session_uuid, frame_uuid)
            state = self._uploads.get(frame_uuid)
            if state is not None and state.rows_total != entry.row_count:
                raise ValueError(
                    f"short upload: {state.rows_total} of {entry.row_count} "
                    "rows"
                )
            entry.uploaded = True
            self._uploads.pop(frame_uuid, None)
            self._save_catalog()

    def finalize_external_frame(self, session_uuid: str,
                                frame_uuid: str) -> None:
        """Mark a frame whose partitions were written OUT-OF-BAND (by
        offload workers sharing the filesystem, the reference's worker ⇄
        storage data plane, lambda_http_worker_group.cpp:69-74) as
        uploaded, bypassing the streamed-upload row accounting."""
        with self._lock:
            entry = self._find(session_uuid, frame_uuid)
            entry.uploaded = True
            self._uploads.pop(frame_uuid, None)
            self._save_catalog()

    # ---- partition IO ----

    def read_partition_rows(self, session_uuid: str, frame_uuid: str,
                            partition: int) -> list[bytes]:
        path = self.partition_path(session_uuid, frame_uuid, partition)
        if not path.exists():
            raise ObjectNotFoundException(f"no partition {partition}")
        return rowcodec.parse_rows(path.read_bytes())

    def write_partition_rows(self, session_uuid: str, frame_uuid: str,
                             partition: int, rows: list[bytes]) -> None:
        """Server-side partition materialization (intermediate frames are
        created by the coordinator itself, reference
        src/service/execution_service.cpp:524-549)."""
        path = self.partition_path(session_uuid, frame_uuid, partition)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(rowcodec.frame_rows(rows))
        with self._lock:
            state = self._uploads.get(frame_uuid)
            if state is not None:
                state.rows_total += len(rows)

    # ---- locking / removal ----

    def lock_data_frame(self, session_uuid: str, frame_uuid: str) -> None:
        with self._lock:
            self._find(session_uuid, frame_uuid).busy += 1

    def unlock_data_frame(self, session_uuid: str, frame_uuid: str) -> None:
        with self._lock:
            e = self._find(session_uuid, frame_uuid)
            if e.busy > 0:
                e.busy -= 1

    def remove_data_frame(self, session_uuid: str, frame_uuid: str) -> None:
        import shutil

        with self._lock:
            entry = self._find(session_uuid, frame_uuid)
            if entry.busy > 0:
                # reference refuses busy frames
                # (src/controller/storage_controller.cpp:190-199)
                raise ResourceLockedException(
                    f"data frame {frame_uuid} is busy"
                )
            # NOTE the reference deletes the whole SESSION directory here
            # (src/service/storage_service.cpp:296-305 removes chunks_path =
            # storage_dir/<session>), destroying sibling frames — an evident
            # bug we do not replicate: only the frame directory is removed.
            shutil.rmtree(self.frame_dir(session_uuid, frame_uuid),
                          ignore_errors=True)
            self._frames[session_uuid].remove(entry)
            self._uploads.pop(frame_uuid, None)
            self._save_catalog()
