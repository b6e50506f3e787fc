"""Coordinator — the control-plane facade, the port of
``herdsman_tpu.service.coordinator`` on the port's device path.

Exposes the client-facing API of the reference's Auth, Session, Storage and
Execution services (SURVEY.md §2.4) as direct method calls.  Every method
that the reference guards with the token plugin takes a `token` argument
validated the same way (bypass list = authorize_connection, reference
src/main.cpp:34).  Jobs run on the server key's device through the port's
``StorageJobRunner`` → ``PlanCompiler`` → ``compile_circuit`` → the
blind-rotation engine.

Beyond the reference, as the JAX coordinator: compressed (seeded) server
keys and seeded row uploads, expanded at ingest; GLWE-packed frames
(``workers.mesh.glwe_inputs``, ``glwe_frames``, ``glwe_outputs``) and
``download_data_frame_packed``, packed on the card with the session's
``TFHE_PACKING`` key.

What the JAX coordinator does beyond that is not ported yet, and raises
``NotImplementedError`` naming the ROADMAP item that ports it, rather than
quietly doing less: offload worker groups (``workers.grpc`` /
``workers.lambda``), a mesh of more than one device and
``logging.profile_dir``.
"""

from __future__ import annotations

import io
import logging
import pathlib
import struct
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from herdsman_tpu_torch.circuit.model import ColumnMeta, MappingError, SchemaType
from herdsman_tpu_torch.circuit.plan import ExecutionPlan
from herdsman_tpu_torch.compiler.stages import partition_sizes
from herdsman_tpu_torch.core import PARAM_SETS, noise
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.core.reference import ServerKey
from herdsman_tpu_torch.ops import pack
from herdsman_tpu_torch.ops.server_key import (
    device_server_key,
    fit_engine,
    layouts_for_engine,
)
from herdsman_tpu_torch.ops.u32 import (
    from_numpy_u32,
    resolve_device,
    to_numpy_u32,
)
from herdsman_tpu_torch.service.auth import AuthService, AuthToken
from herdsman_tpu_torch.service.config import Config, port_engine
from herdsman_tpu_torch.service.errors import ObjectNotFoundException
from herdsman_tpu_torch.service.execution import ExecutionService, JobDescriptor
from herdsman_tpu_torch.service.keystore import KeyService
from herdsman_tpu_torch.service.runner import (
    StorageJobRunner,
    pack_frame_partitions_inplace,
)
from herdsman_tpu_torch.service.session import SessionService
from herdsman_tpu_torch.service.storage import DataFrameEntry, StorageService
from herdsman_tpu_torch.utils import rowcodec

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


def serialize_server_key_compressed(csk: ref.CompressedServerKey) -> bytes:
    """The JAX package's wire format of a seeded server key: (k+1)x less
    BSK and (n+1)x less KSK upload than the full key."""
    buf = io.BytesIO()
    np.savez_compressed(
        buf, seed=np.array([csk.seed], dtype=np.uint64),
        bsk_bodies=csk.bsk_bodies, ksk_bodies=csk.ksk_bodies,
        params=np.array([csk.params.name], dtype=object))
    return buf.getvalue()


def deserialize_server_key(data: bytes) -> ServerKey:
    """A full or a compressed server key; a compressed one is expanded
    here, at ingest (``core.reference.expand_server_key``)."""
    z = np.load(io.BytesIO(data), allow_pickle=True)
    params = PARAM_SETS[str(z["params"][0])]
    if "seed" in z.files:
        return ref.expand_server_key(ref.CompressedServerKey(
            params, int(z["seed"][0]), z["bsk_bodies"], z["ksk_bodies"]))
    return ServerKey(params, z["bsk"], z["ksk"])


def serialize_packing_key(pk: ref.PackingKey) -> bytes:
    """Wire and disk form of the LWE -> GLWE packing keyswitch key
    (uploaded under SchemaType.TFHE_PACKING), the JAX package's."""
    buf = io.BytesIO()
    np.savez_compressed(buf, pksk=pk.pksk,
                        params=np.array([pk.params.name], dtype=object))
    return buf.getvalue()


def deserialize_packing_key(data: bytes) -> ref.PackingKey:
    z = np.load(io.BytesIO(data), allow_pickle=True)
    return ref.PackingKey(PARAM_SETS[str(z["params"][0])], z["pksk"])


def key_params_from_bytes(data: bytes):
    """Parameter set of a serialized key, without loading its arrays (npz
    members decompress lazily on access)."""
    z = np.load(io.BytesIO(data), allow_pickle=True)
    return PARAM_SETS[str(z["params"][0])]


class Coordinator:
    def __init__(self, config: Config, engine: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        """``engine`` overrides the config's (a JAX package name such as
        ``pallas_fused``, or the port's own, e.g. ``bt_fused``).  With no
        ``workers.mesh`` section the engine is ``bt``, where the JAX
        coordinator takes ``conv_i8``: the port serves ``conv_i8`` where a
        caller or a config names it, with outputs equal to every other
        engine's, but its products are plain int8 matrix products, about
        6x slower on the card than ``mega13`` (``PERF.md``).
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
        # session -> (packing key in the conv_i8 layout on the device,
        # params): packed ingest and packed downloads
        self._session_pkc: dict[str, tuple[torch.Tensor, object]] = {}
        # in-flight seeded uploads: frame_uuid -> expansion state (seed,
        # params, bits per row, position in the mask stream, partial row)
        self._seeded_uploads: dict[str, dict] = {}
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
        self.keys.add_key(session_uuid, schema_type, bytes(buf))
        self._forget_keys(session_uuid)

    def remove_key(self, token: str, session_uuid: str,
                   schema_type: SchemaType) -> None:
        self._check_session(token, session_uuid)
        self.keys.remove_key(session_uuid, schema_type)
        self._forget_keys(session_uuid)

    def _forget_keys(self, session_uuid: str) -> None:
        """Drop what was built from the session's keys."""
        self._session_dsk.pop(session_uuid, None)
        self._session_runner.pop(session_uuid, None)
        self._session_pkc.pop(session_uuid, None)

    def _packing_key(self, session_uuid: str) -> tuple[torch.Tensor, object]:
        """(the session's TFHE_PACKING key in the conv_i8 layout on the
        device, its params); raises ObjectNotFoundException without one."""
        if session_uuid not in self._session_pkc:
            pk = deserialize_packing_key(self.keys.read_key(
                session_uuid, SchemaType.TFHE_PACKING))
            self._session_pkc[session_uuid] = (
                pack.packing_key_conv(pk, device=self.device), pk.params)
        return self._session_pkc[session_uuid]

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
        new frame's metadata (reference :55-113).

        ``seeded_seed`` selects the compressed upload (beyond the
        reference): row payloads carry only the LWE bodies (one u32 per
        bit) and the coordinator re-derives the masks from the seed at
        ingest, storing the standard expanded layout, so the partitions and
        the job path are untouched."""
        self._check_session(token, session_uuid)
        if not self.keys.key_exists(session_uuid, schema_type):
            raise ObjectNotFoundException(
                f"upload the {schema_type.name} key before frames "
                "(reference storage_controller.cpp:90-98)"
            )
        frame_uuid = self.storage.create_data_frame(
            session_uuid, name, schema_type, columns, row_count, partitions
        )
        if seeded_seed is not None:
            params = key_params_from_bytes(
                self.keys.read_key(session_uuid, schema_type))
            self._seeded_uploads[frame_uuid] = {
                "seed": int(seeded_seed),
                "params": params,
                "row_bits": sum(c.dtype.bit_width for c in columns),
                "cts_done": 0,
                "buf": b"",
            }
        return self.storage.get_data_frame(session_uuid, frame_uuid)

    def _expand_seeded_chunk(self, frame_uuid: str, data: bytes) -> bytes:
        """Expand a chunk of seeded rows ([u32 size][bodies]) into the
        standard full-ciphertext framing; partial rows wait for the next
        chunk (clients may split anywhere, reference
        storage_service.cpp:119-150)."""
        st = self._seeded_uploads[frame_uuid]
        buf = st["buf"] + data
        p = st["params"]
        row_bodies: list[np.ndarray] = []
        off = 0
        row_bytes = st["row_bits"] * 4
        while off + 4 <= len(buf):
            (size,) = struct.unpack_from("<I", buf, off)
            if size != row_bytes:
                raise ValueError(
                    f"seeded row payload must be {row_bytes} bytes "
                    f"(one u32 body per bit), got {size}")
            if off + 4 + size > len(buf):
                break
            row_bodies.append(np.frombuffer(
                buf, dtype=np.uint32, count=st["row_bits"], offset=off + 4))
            off += 4 + size
        st["buf"] = buf[off:]
        if not row_bodies:
            return b""
        # one mask-stream expansion for all complete rows of the chunk
        cts = ref.expand_seeded(p, st["seed"], np.concatenate(row_bodies),
                                offset=st["cts_done"])
        st["cts_done"] += cts.shape[0]
        cts = cts.reshape(len(row_bodies), st["row_bits"] * (p.n + 1))
        return rowcodec.frame_rows([row.tobytes() for row in cts])

    def append_data_frame(self, token: str, session_uuid: str,
                          frame_uuid: str, data: bytes) -> int:
        self._check_session(token, session_uuid)
        try:
            if frame_uuid in self._seeded_uploads:
                data = self._expand_seeded_chunk(frame_uuid, data)
                if not data:
                    return 0
            return self.storage.append_to_data_frame(
                session_uuid, frame_uuid, data
            )
        except ValueError:
            # over/under-run aborts delete the frame (reference :128-150)
            self._seeded_uploads.pop(frame_uuid, None)
            self.storage.remove_data_frame(session_uuid, frame_uuid)
            raise

    def finish_data_frame_upload(self, token: str, session_uuid: str,
                                 frame_uuid: str) -> None:
        """Close the upload; with ``workers.mesh.glwe_inputs``, pack the
        frame (``_pack_input_frame``)."""
        self._check_session(token, session_uuid)
        try:
            st = self._seeded_uploads.pop(frame_uuid, None)
            if st is not None and st["buf"]:
                raise ValueError(
                    f"seeded upload ended mid-row ({len(st['buf'])} "
                    "trailing bytes)")
            self.storage.mark_data_frame_as_uploaded(session_uuid, frame_uuid)
        except ValueError:
            self.storage.remove_data_frame(session_uuid, frame_uuid)
            raise
        mw = self.config.mesh_workers
        if mw is not None and mw.glwe_inputs:
            self._pack_input_frame(session_uuid, frame_uuid)

    def _pack_input_frame(self, session_uuid: str, frame_uuid: str) -> None:
        """glwe_inputs: re-encode the freshly uploaded row frame as packed
        GLWEs on the card (192x smaller at STD128_K2; the job runner
        expands it on load).  Two cases leave the frame in the row format,
        as in the JAX package: the session has no TFHE_PACKING key, or the
        set's closed-form frame margin is below 8 sigma at a set with
        security_bits > 0.  Any other failure (device, packing, storage)
        raises to the caller, and the frame stays in the row format
        (``pack_frame_partitions_inplace`` is all or nothing).  The JAX
        coordinator swallows every such exception
        (``herdsman_tpu/service/coordinator.py:352-355``); the port does
        not hide a failing device."""
        try:
            pkc, params = self._packing_key(session_uuid)
        except ObjectNotFoundException:
            log.warning("glwe_inputs: session %s has no TFHE_PACKING key at "
                        "ingest; frame %s stays in row format",
                        session_uuid, frame_uuid)
            return
        margin = noise.glwe_frame_margin_sigma(params)
        if margin < 8.0 and params.security_bits > 0:
            log.warning("glwe_inputs: frame margin %.1f sigma at %s below "
                        "the 8-sigma bar; frame %s stays in row format",
                        margin, params.name, frame_uuid)
            return
        pack_frame_partitions_inplace(self.storage, session_uuid, frame_uuid,
                                      pkc, params)

    def abandon_data_frame_upload(self, token: str, session_uuid: str,
                                  frame_uuid: str) -> None:
        """Clean up an upload whose stream terminated without finishing
        (client disconnect / abort): drop any seeded-expansion state and
        delete the never-finalized frame — the reference deletes frames on
        aborted streams too (storage_controller.cpp:128-150)."""
        self._check_session(token, session_uuid)
        self._seeded_uploads.pop(frame_uuid, None)
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
        self._seeded_uploads.pop(frame_uuid, None)  # drop in-flight state
        self.storage.remove_data_frame(session_uuid, frame_uuid)

    def download_data_frame(self, token: str, session_uuid: str,
                            frame_uuid: str) -> Iterable[bytes]:
        """Stream partition contents (implemented; the reference returns
        UNIMPLEMENTED, src/controller/storage_controller.cpp:264-273)."""
        self._check_session(token, session_uuid)
        entry = self.storage.get_data_frame(session_uuid, frame_uuid)
        if entry.glwe_packed:
            raise MappingError(
                f"frame {frame_uuid} is stored in the GLWE-packed domain "
                "(glwe_frames); download it with download_data_frame_packed "
                "and decrypt with the GLWE secret key")
        for part in range(entry.partitions):
            path = self.storage.partition_path(session_uuid, frame_uuid, part)
            yield path.read_bytes() if path.exists() else b""

    def download_data_frame_packed(self, token: str, session_uuid: str,
                                   frame_uuid: str) -> Iterable[bytes]:
        """Compressed download (beyond the reference): the frame's LWE rows
        packed into GLWE ciphertexts with the session's TFHE_PACKING key (up
        to N per GLWE: (n+1)*N -> (k+1)*N u32, ~192x at STD128_K2), on the
        card.  Each partition streams as [u32 n_cts][u32 n_groups], then
        n_groups * (k+1)*N u32 GLWEs; clients holding the GLWE secret key
        decrypt them directly (``core.client.decrypt_rows_packed``).  A
        frame stored packed streams its GLWEs as they are."""
        self._check_session(token, session_uuid)
        pkc, p = self._packing_key(session_uuid)
        entry = self.storage.get_data_frame(session_uuid, frame_uuid)
        frame_params = key_params_from_bytes(
            self.keys.read_key(session_uuid, entry.schema_type))
        if frame_params.name != p.name:
            raise MappingError(
                f"packing key params ({p.name}) do not match the frame's "
                f"{entry.schema_type.name} key params ({frame_params.name}); "
                "re-upload a TFHE_PACKING key generated for the same "
                "parameter set")
        if entry.glwe_packed:
            total_bits = sum(c.dtype.bit_width for c in entry.columns)
            sizes = partition_sizes(entry.row_count, entry.partitions)
            for part in range(entry.partitions):
                path = self.storage.partition_path(session_uuid, frame_uuid,
                                                   part)
                blobs = rowcodec.parse_rows(
                    path.read_bytes() if path.exists() else b"")
                head = struct.pack("<II", sizes[part] * total_bits,
                                   len(blobs))
                yield head + b"".join(blobs)
            return
        for part in range(entry.partitions):
            path = self.storage.partition_path(session_uuid, frame_uuid,
                                               part)
            data = path.read_bytes() if path.exists() else b""
            cts = [np.frombuffer(pl, dtype=np.uint32).reshape(-1, p.n + 1)
                   for pl in rowcodec.parse_rows(data)]
            flat = (np.concatenate(cts) if cts
                    else np.zeros((0, p.n + 1), dtype=np.uint32))
            groups = to_numpy_u32(pack.pack_lwe_rows(
                p, pkc, from_numpy_u32(flat, self.device)))
            head = struct.pack("<II", flat.shape[0], len(groups))
            yield head + groups.tobytes()

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
        pk = None
        mw = self.config.mesh_workers
        if mw is not None and (mw.glwe_frames or mw.glwe_outputs):
            # GLWE-domain frames need the session's packing key; without
            # one (or with one of other params) frames stay rows
            try:
                pk = deserialize_packing_key(self.keys.read_key(
                    job.session_uuid, SchemaType.TFHE_PACKING))
                if pk.params.name != dsk.params.name:
                    log.warning("glwe_frames: packing key params mismatch "
                                "(%s vs %s); using row frames",
                                pk.params.name, dsk.params.name)
                    pk = None
            except ObjectNotFoundException:
                pk = None
            if pk is not None:
                # no GLWE frames where the closed-form margin for the extra
                # pack and unpack keyswitch noise is below the 8-sigma bar
                margin = noise.glwe_frame_margin_sigma(dsk.params)
                if margin < 8.0 and dsk.params.security_bits > 0:
                    log.warning(
                        "glwe_frames: closed-form gate margin %.1f sigma "
                        "at %s is below the 8-sigma production bar; using "
                        "row frames", margin, dsk.params.name)
                    pk = None
        runner = StorageJobRunner(
            self.storage, dsk, engine=engine, packing_key=pk,
            glwe_frames=bool(mw is not None and mw.glwe_frames),
            glwe_outputs=bool(mw is not None and mw.glwe_outputs))
        # concurrent executor slots may race here; last writer wins and the
        # loser's runner is still correct (same dsk, engine and key)
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
