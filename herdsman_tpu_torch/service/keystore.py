"""KeyService — per-session evaluation-key store, parity with the reference
(reference include/service/key_service.hpp:13-41, src/service/key_service.cpp):
keys stored on disk at key_dir/<session_uuid>/<schema_type_int>.key; in-memory
catalog with a refcount lock — remove refuses while locked.

Deviation (deliberate fix): the reference never calls unlock_key, leaking
locks forever (SURVEY.md §2.1); here the ExecutionService unlocks on job
completion/failure.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading

from herdsman_tpu_torch.circuit.model import SchemaType
from herdsman_tpu_torch.service.errors import (
    ObjectAlreadyExistsException,
    ObjectNotFoundException,
    ResourceLockedException,
)


@dataclasses.dataclass
class KeyEntry:
    schema_type: SchemaType
    path: pathlib.Path
    locks: int = 0


class KeyService:
    def __init__(self, key_dir: str | pathlib.Path):
        self._dir = pathlib.Path(key_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._keys: dict[str, dict[SchemaType, KeyEntry]] = {}
        # rehydrate from disk: the layout key_dir/<session>/<int>.key is
        # self-describing, so keys survive a coordinator restart (the
        # reference loses its in-memory catalog, SURVEY.md §5)
        for session_dir in self._dir.iterdir():
            if not session_dir.is_dir():
                continue
            for key_file in session_dir.glob("*.key"):
                try:
                    schema = SchemaType(int(key_file.stem))
                except ValueError:
                    continue
                self._keys.setdefault(session_dir.name, {})[schema] = (
                    KeyEntry(schema, key_file)
                )

    def _entry(self, session_uuid: str, schema_type: SchemaType) -> KeyEntry:
        try:
            return self._keys[session_uuid][schema_type]
        except KeyError:
            raise ObjectNotFoundException(
                f"no key {schema_type} in session {session_uuid}"
            ) from None

    def add_key(self, session_uuid: str, schema_type: SchemaType,
                key_data: bytes) -> None:
        with self._lock:
            session_keys = self._keys.setdefault(session_uuid, {})
            if schema_type in session_keys:
                raise ObjectAlreadyExistsException(
                    f"key {schema_type} already uploaded"
                )
            d = self._dir / session_uuid
            d.mkdir(parents=True, exist_ok=True)
            path = d / f"{int(schema_type)}.key"
            path.write_bytes(key_data)
            session_keys[schema_type] = KeyEntry(schema_type, path)

    def read_key(self, session_uuid: str, schema_type: SchemaType) -> bytes:
        with self._lock:
            return self._entry(session_uuid, schema_type).path.read_bytes()

    def key_exists(self, session_uuid: str, schema_type: SchemaType) -> bool:
        with self._lock:
            return schema_type in self._keys.get(session_uuid, {})

    def list_keys(self, session_uuid: str) -> list[SchemaType]:
        with self._lock:
            return list(self._keys.get(session_uuid, {}).keys())

    def remove_key(self, session_uuid: str, schema_type: SchemaType) -> None:
        with self._lock:
            entry = self._entry(session_uuid, schema_type)
            if entry.locks > 0:
                raise ResourceLockedException(
                    f"key {schema_type} is locked by {entry.locks} job(s)"
                )
            entry.path.unlink(missing_ok=True)
            del self._keys[session_uuid][schema_type]

    def lock_key(self, session_uuid: str, schema_type: SchemaType) -> None:
        with self._lock:
            self._entry(session_uuid, schema_type).locks += 1

    def unlock_key(self, session_uuid: str, schema_type: SchemaType) -> None:
        with self._lock:
            entry = self._entry(session_uuid, schema_type)
            if entry.locks > 0:
                entry.locks -= 1
