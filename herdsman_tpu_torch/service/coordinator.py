"""Coordinator — the control-plane facade, the port of
``herdsman_tpu.service.coordinator`` on the port's device path.

Exposes the client-facing API of the reference's Auth, Session, Storage and
Execution services (SURVEY.md §2.4) as direct method calls.  Every method
that the reference guards with the token plugin takes a `token` argument
validated the same way (bypass list = authorize_connection, reference
src/main.cpp:34).  Jobs run on the server key's device through the port's
``StorageJobRunner`` → ``PlanCompiler`` → ``compile_circuit`` → the
blind-rotation engine.

What the JAX coordinator does beyond that is not ported yet, and raises
``NotImplementedError`` naming the ROADMAP item that ports it, rather than
quietly doing less: offload worker groups (``workers.grpc`` /
``workers.lambda``), a mesh of more than one device, the GLWE frame options
(``glwe_frames``, ``glwe_outputs``, ``glwe_inputs``) and
``download_data_frame_packed``, ``logging.profile_dir``, seeded uploads and
compressed server keys.
"""

from __future__ import annotations

import io
import logging
import pathlib
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from herdsman_tpu_torch.circuit.model import ColumnMeta, MappingError, SchemaType
from herdsman_tpu_torch.circuit.plan import ExecutionPlan
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.core.reference import ServerKey
from herdsman_tpu_torch.ops.server_key import (
    device_server_key,
    fit_engine,
    layouts_for_engine,
)
from herdsman_tpu_torch.ops.u32 import resolve_device
from herdsman_tpu_torch.service.auth import AuthService, AuthToken
from herdsman_tpu_torch.service.config import Config, port_engine
from herdsman_tpu_torch.service.errors import ObjectNotFoundException
from herdsman_tpu_torch.service.execution import ExecutionService, JobDescriptor
from herdsman_tpu_torch.service.keystore import KeyService
from herdsman_tpu_torch.service.runner import StorageJobRunner
from herdsman_tpu_torch.service.session import SessionService
from herdsman_tpu_torch.service.storage import DataFrameEntry, StorageService

log = logging.getLogger("herdsman")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to herdsman_tpu_torch yet ({item}); the JAX "
        f"package's herdsman_tpu.service.coordinator serves it")


def serialize_server_key(sk: ServerKey) -> bytes:
    """The JAX package's wire format of a full server key."""
    buf = io.BytesIO()
    np.savez_compressed(buf, bsk=sk.bsk, ksk=sk.ksk,
                        params=np.array([sk.params.name], dtype=object))
    return buf.getvalue()


def deserialize_server_key(data: bytes) -> ServerKey:
    z = np.load(io.BytesIO(data), allow_pickle=True)
    if "seed" in z.files:
        raise _unported("a compressed (seeded) server key",
                        "ROADMAP queue 1, item 14")
    return ServerKey(PARAM_SETS[str(z["params"][0])], z["bsk"], z["ksk"])


class Coordinator:
    def __init__(self, config: Config, engine: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        """``engine`` overrides the config's (a JAX package name such as
        ``pallas_fused``, or the port's own, e.g. ``bt_fused``).  With no
        ``workers.mesh`` section the engine is ``bt``: the JAX coordinator
        takes ``conv_i8`` there, an XLA engine with no kernel to port.
        ``device`` is resolved here, on the constructing thread (CUDA is
        initialised here, not on an executor thread), and raises without a
        card unless it is ``"cpu"``."""
        self._check_config(config)
        self.config = config
        level = getattr(logging, config.logging.level.upper(), logging.INFO)
        logging.basicConfig(level=level)
        self.device = resolve_device(device)
        self.auth = AuthService(config.security.secret_key,
                                config.security.token_lifetime)
        storage_dir = pathlib.Path(config.server.storage_directory)
        self.sessions = SessionService(persist_path=storage_dir
                                       / "sessions.json")
        self.keys = KeyService(config.server.key_directory)
        self.storage = StorageService(
            config.server.storage_directory,
            catalog_backend=config.server.catalog_backend)
        mw = config.mesh_workers
        self.execution = ExecutionService(
            self.keys, self.storage,
            journal_path=str(storage_dir / "jobs.jsonl"),
            concurrent_workers=mw.concurrent_jobs if mw else 1,
        )
        self._engine = port_engine(engine or (mw.engine if mw else "bt"))
        # session -> (resolved engine name, DeviceServerKey)
        self._session_dsk: dict[str, tuple[str, object]] = {}
        # session -> StorageJobRunner: reused ACROSS jobs so the
        # PlanCompiler's planned circuits survive job boundaries
        self._session_runner: dict[str, StorageJobRunner] = {}
        self.execution.set_runner(self._run_job)

    @staticmethod
    def _check_config(config: Config) -> None:
        """Refuse what the port cannot serve yet, before anything starts."""
        if config.grpc_workers is not None:
            raise _unported("workers.grpc (offload to a gRPC worker fleet)",
                            "ROADMAP queue 1, item 15")
        if config.lambda_workers is not None:
            raise _unported("workers.lambda (elastic CPU offload)",
                            "ROADMAP queue 1, item 15")
        mw = config.mesh_workers
        if mw is not None:
            if mw.batch_axis * mw.limb_axis > 1:
                raise _unported("a workers.mesh of more than one device",
                                "ROADMAP queue 1, item 12")
            for flag in ("glwe_frames", "glwe_outputs", "glwe_inputs"):
                if getattr(mw, flag):
                    raise _unported(f"workers.mesh.{flag} (GLWE-packed "
                                    "frames)", "ROADMAP queue 1, item 9")
        if config.logging.profile_dir:
            raise _unported("logging.profile_dir (per-job traces)",
                            "ROADMAP queue 1, item 17")

    # ---- auth (reference src/controller/auth_controller.cpp) ----

    def authorize_connection(self, authentication_token: str) -> str:
        return self.auth.authenticate(authentication_token)

    def _validate(self, token: str) -> AuthToken:
        return self.auth.validate_token(token)

    # ---- sessions (reference src/controller/session_controller.cpp) ----

    def create_session(self, token: str, name: str):
        user = self._validate(token)
        return self.sessions.create_session(user.user_id, name)

    def destroy_session(self, token: str, session_uuid: str) -> None:
        user = self._validate(token)
        self.sessions.destroy_session_by_uuid(user.user_id, session_uuid)

    def list_sessions(self, token: str):
        user = self._validate(token)
        return self.sessions.list_sessions(user.user_id)

    def _check_session(self, token: str, session_uuid: str) -> AuthToken:
        user = self._validate(token)
        if not self.sessions.session_exists_by_uuid(user.user_id, session_uuid):
            raise ObjectNotFoundException(f"no session {session_uuid}")
        return user

    # ---- keys (client-streamed in the reference,
    #            src/controller/session_controller.cpp:120-207) ----

    def add_key(self, token: str, session_uuid: str, schema_type: SchemaType,
                size: int, chunks: Iterable[bytes]) -> None:
        self._check_session(token, session_uuid)
        buf = bytearray()
        for chunk in chunks:
            buf.extend(chunk)
            if len(buf) > size:
                raise ValueError(
                    f"key upload overrun: {len(buf)} > declared {size}"
                )
        if len(buf) != size:
            raise ValueError(f"short key upload: {len(buf)} of {size} bytes")
        if schema_type == SchemaType.TFHE_BOOL and "seed" in np.load(
                io.BytesIO(bytes(buf)), allow_pickle=True).files:
            raise _unported("a compressed (seeded) server key",
                            "ROADMAP queue 1, item 14")
        self.keys.add_key(session_uuid, schema_type, bytes(buf))
        self._session_dsk.pop(session_uuid, None)
        self._session_runner.pop(session_uuid, None)

    def remove_key(self, token: str, session_uuid: str,
                   schema_type: SchemaType) -> None:
        self._check_session(token, session_uuid)
        self.keys.remove_key(session_uuid, schema_type)
        self._session_dsk.pop(session_uuid, None)
        self._session_runner.pop(session_uuid, None)

    def list_keys(self, token: str, session_uuid: str) -> list[SchemaType]:
        self._check_session(token, session_uuid)
        return self.keys.list_keys(session_uuid)

    # ---- data frames (reference src/controller/storage_controller.cpp) ----

    def begin_data_frame_upload(
        self, token: str, session_uuid: str, name: str,
        schema_type: SchemaType, columns: Sequence[ColumnMeta],
        row_count: int, partitions: int,
        seeded_seed: Optional[int] = None,
    ) -> DataFrameEntry:
        """First message of the bidi stream: validates and replies with the
        new frame's metadata (reference :55-113)."""
        self._check_session(token, session_uuid)
        if seeded_seed is not None:
            raise _unported("a seeded (compressed) upload",
                            "ROADMAP queue 1, item 14")
        if not self.keys.key_exists(session_uuid, schema_type):
            raise ObjectNotFoundException(
                f"upload the {schema_type.name} key before frames "
                "(reference storage_controller.cpp:90-98)"
            )
        frame_uuid = self.storage.create_data_frame(
            session_uuid, name, schema_type, columns, row_count, partitions
        )
        return self.storage.get_data_frame(session_uuid, frame_uuid)

    def append_data_frame(self, token: str, session_uuid: str,
                          frame_uuid: str, data: bytes) -> int:
        self._check_session(token, session_uuid)
        try:
            return self.storage.append_to_data_frame(
                session_uuid, frame_uuid, data
            )
        except ValueError:
            # over/under-run aborts delete the frame (reference :128-150)
            self.storage.remove_data_frame(session_uuid, frame_uuid)
            raise

    def finish_data_frame_upload(self, token: str, session_uuid: str,
                                 frame_uuid: str) -> None:
        self._check_session(token, session_uuid)
        try:
            self.storage.mark_data_frame_as_uploaded(session_uuid, frame_uuid)
        except ValueError:
            self.storage.remove_data_frame(session_uuid, frame_uuid)
            raise

    def abandon_data_frame_upload(self, token: str, session_uuid: str,
                                  frame_uuid: str) -> None:
        """Clean up an upload whose stream terminated without finishing
        (client disconnect / abort): delete the never-finalized frame — the
        reference deletes frames on aborted streams too
        (storage_controller.cpp:128-150)."""
        self._check_session(token, session_uuid)
        try:
            entry = self.storage.get_data_frame(session_uuid, frame_uuid)
        except ObjectNotFoundException:
            return
        if not entry.uploaded:
            self.storage.remove_data_frame(session_uuid, frame_uuid)

    def list_data_frames(
        self, token: str, session_uuid: str,
        schema_type: Optional[SchemaType] = None,
    ) -> list[DataFrameEntry]:
        self._check_session(token, session_uuid)
        return self.storage.list_session_data_frames(session_uuid, schema_type)

    def remove_data_frame(self, token: str, session_uuid: str,
                          frame_uuid: str) -> None:
        self._check_session(token, session_uuid)
        self.storage.remove_data_frame(session_uuid, frame_uuid)

    def download_data_frame(self, token: str, session_uuid: str,
                            frame_uuid: str) -> Iterable[bytes]:
        """Stream partition contents (implemented; the reference returns
        UNIMPLEMENTED, src/controller/storage_controller.cpp:264-273)."""
        self._check_session(token, session_uuid)
        entry = self.storage.get_data_frame(session_uuid, frame_uuid)
        if entry.glwe_packed:
            raise MappingError(
                f"frame {frame_uuid} is stored in the GLWE-packed domain, "
                "which the port does not read yet (ROADMAP queue 1, item 9)")
        for part in range(entry.partitions):
            path = self.storage.partition_path(session_uuid, frame_uuid, part)
            yield path.read_bytes() if path.exists() else b""

    def download_data_frame_packed(self, token: str, session_uuid: str,
                                   frame_uuid: str) -> Iterable[bytes]:
        raise _unported("download_data_frame_packed",
                        "ROADMAP queue 1, item 9")

    # ---- execution (reference src/controller/execution_controller.cpp) ----

    def _device_key(self, session_uuid: str):
        """(engine, dsk) for the session — the engine is resolved PER
        SESSION (fit_engine depends on the session key's params), so one
        session's memory-driven fallback never downgrades another."""
        if session_uuid not in self._session_dsk:
            data = self.keys.read_key(session_uuid, SchemaType.TFHE_BOOL)
            sk = deserialize_server_key(data)
            engine = fit_engine(self._engine, sk.params)
            if engine != self._engine:
                log.warning("engine %s key layout won't fit the card at %s; "
                            "session %s uses %s", self._engine,
                            sk.params.name, session_uuid, engine)
            self._session_dsk[session_uuid] = (engine, device_server_key(
                sk, layouts=layouts_for_engine(engine), device=self.device))
        return self._session_dsk[session_uuid]

    def _run_job(self, job: JobDescriptor):
        cached = self._session_runner.get(job.session_uuid)
        if cached is not None:
            return cached(job)
        engine, dsk = self._device_key(job.session_uuid)
        runner = StorageJobRunner(self.storage, dsk, engine=engine)
        # concurrent executor slots may race here; last writer wins and the
        # loser's runner is still correct (same dsk and engine)
        self._session_runner[job.session_uuid] = runner
        return runner(job)

    def schedule_job(self, token: str, session_uuid: str,
                     plan: ExecutionPlan | str,
                     concurrency_limit: int = 1) -> JobDescriptor:
        self._check_session(token, session_uuid)
        if isinstance(plan, str):
            plan = ExecutionPlan.from_json(plan)  # raises MappingError
        if not isinstance(plan, ExecutionPlan):
            raise MappingError("not an execution plan")
        return self.execution.schedule_job(session_uuid, plan,
                                           concurrency_limit)

    def get_job_state(self, token: str, session_uuid: str, job_uuid: str):
        self._check_session(token, session_uuid)
        return self.execution.get_job_state(session_uuid, job_uuid)

    def list_jobs(self, token: str, session_uuid: str):
        self._check_session(token, session_uuid)
        return self.execution.list_jobs(session_uuid)

    def describe_job(self, token: str, session_uuid: str, job_uuid: str):
        self._check_session(token, session_uuid)
        return self.execution.describe_job(session_uuid, job_uuid)

    def wait_for_job(self, token: str, session_uuid: str, job_uuid: str,
                     timeout: float = 300.0):
        self._check_session(token, session_uuid)
        return self.execution.wait_for_job(session_uuid, job_uuid, timeout)

    def shutdown(self) -> None:
        self.execution.shutdown()
