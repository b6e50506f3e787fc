"""SessionService — session registry, parity with the reference
(reference include/service/session_service.hpp:11-32,
src/service/session_service.cpp): multimap user_id -> {uuid, name}; create is
name-unique per user; destroy by uuid; list per user.

Beyond the reference (which keeps sessions purely in-memory and loses them
on restart): when constructed with a `persist_path`, the registry is
journaled to a JSON sidecar (atomic tmp+replace, same scheme as the storage
catalog) and rehydrated on startup, so sessions survive a coordinator
restart together with their on-disk keys and frames."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
import uuid as uuid_mod

from herdsman_tpu_torch.service.errors import (
    ObjectAlreadyExistsException,
    ObjectNotFoundException,
)


@dataclasses.dataclass(frozen=True)
class Session:
    uuid: str
    name: str


class SessionService:
    def __init__(self, persist_path: str | pathlib.Path | None = None) -> None:
        self._lock = threading.RLock()
        self._sessions: dict[int, list[Session]] = {}
        self._persist_path = (
            pathlib.Path(persist_path) if persist_path is not None else None
        )
        self._load()

    # ---- persistence ----

    def _load(self) -> None:
        if self._persist_path is None or not self._persist_path.exists():
            return
        data = json.loads(self._persist_path.read_text())
        for user_id, sessions in data.items():
            self._sessions[int(user_id)] = [
                Session(s["uuid"], s["name"]) for s in sessions
            ]

    def _save(self) -> None:
        if self._persist_path is None:
            return
        data = {
            str(uid): [{"uuid": s.uuid, "name": s.name} for s in sessions]
            for uid, sessions in self._sessions.items()
            if sessions
        }
        self._persist_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._persist_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data))
        tmp.replace(self._persist_path)

    # ---- registry (reference surface) ----

    def create_session(self, user_id: int, name: str) -> Session:
        with self._lock:
            for s in self._sessions.get(user_id, []):
                if s.name == name:
                    raise ObjectAlreadyExistsException(
                        f"session {name!r} already exists"
                    )
            session = Session(str(uuid_mod.uuid4()), name)
            self._sessions.setdefault(user_id, []).append(session)
            self._save()
            return session

    def destroy_session_by_uuid(self, user_id: int, session_uuid: str) -> None:
        with self._lock:
            sessions = self._sessions.get(user_id, [])
            for i, s in enumerate(sessions):
                if s.uuid == session_uuid:
                    del sessions[i]
                    self._save()
                    return
            raise ObjectNotFoundException(f"no session {session_uuid}")

    def destroy_session_by_name(self, user_id: int, name: str) -> None:
        with self._lock:
            sessions = self._sessions.get(user_id, [])
            for i, s in enumerate(sessions):
                if s.name == name:
                    del sessions[i]
                    self._save()
                    return
            raise ObjectNotFoundException(f"no session {name!r}")

    def session_exists_by_uuid(self, user_id: int, session_uuid: str) -> bool:
        with self._lock:
            return any(
                s.uuid == session_uuid
                for s in self._sessions.get(user_id, [])
            )

    def list_sessions(self, user_id: int) -> list[Session]:
        with self._lock:
            return list(self._sessions.get(user_id, []))
