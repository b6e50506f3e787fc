"""gRPC API server — the reference's RPC layer (L6/L7), the port's copy of
``herdsman_tpu.service.api_server`` in front of the port's ``Coordinator``:
four services (Auth / Session / Storage / Execution) over the
proto/herdsman.proto wire model, with a token interceptor replicating
TokenAuthMetadataProcessor (reference
src/plugins/token_auth_metadata_processor.cpp: every rpc except the
authorize allow-list requires `authorization: Bearer <token>`), and the
reference's 32 MiB message caps (reference src/main.cpp:135-136).

grpc service stubs are hand-registered via generic handlers (no grpc
codegen plugin is needed); streaming shapes mirror the reference: add_key is
client-streaming, add_data_frame is bidi, download_data_frame and
download_data_frame_packed are server-streaming.  The wire is the JAX
package's: a client of either package talks to a server of either.

The coordinator's jobs run on the card.  Handlers run on the server's
thread pool and call the coordinator from there (a packed download packs on
the card from that thread); jobs run on the coordinator's executor thread.

Run: python -m herdsman_tpu_torch.service.api_server CONFIG.yaml
        [--device cuda]
(``load_config`` needs PyYAML; build ``Config`` in code and call
``build_server`` where it is missing.)
"""

from __future__ import annotations

import argparse
import logging
import threading
import time
from concurrent import futures

import grpc
import torch

from herdsman_tpu_torch.circuit.model import MappingError, SchemaType
from herdsman_tpu_torch.service import mappers
from herdsman_tpu_torch.service._proto import CHANNEL_OPTIONS
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb
from herdsman_tpu_torch.service.coordinator import Coordinator
from herdsman_tpu_torch.service.errors import (
    InvalidTokenException,
    ObjectAlreadyExistsException,
    ObjectNotFoundException,
    ResourceLockedException,
)

log = logging.getLogger("herdsman.grpc")

SERVER_THREADS = 8

# reference src/main.cpp:34 — only authorize_connection bypasses auth
AUTH_BYPASS = ("/herdsman.Auth/authorize_connection",)


def _abort(context, exc):
    if isinstance(exc, InvalidTokenException):
        context.abort(grpc.StatusCode.UNAUTHENTICATED, str(exc))
    elif isinstance(exc, ObjectNotFoundException):
        context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
    elif isinstance(exc, ObjectAlreadyExistsException):
        context.abort(grpc.StatusCode.ALREADY_EXISTS, str(exc))
    elif isinstance(exc, ResourceLockedException):
        context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(exc))
    elif isinstance(exc, (MappingError, ValueError)):
        context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
    else:
        log.exception("internal error")
        context.abort(grpc.StatusCode.INTERNAL, str(exc))


def _token(context) -> str:
    for key, value in context.invocation_metadata():
        if key == "authorization" and value.startswith("Bearer "):
            return value[len("Bearer "):]
    raise InvalidTokenException("missing bearer token")


class _Pin:
    """Connection-identity pin: user id + live-RPC refcount + idle clock."""

    __slots__ = ("user_id", "inflight", "idle_since")

    def __init__(self, user_id: int):
        self.user_id = user_id
        self.inflight = 0
        self.idle_since = 0.0  # monotonic ts when inflight last hit 0


class _Guard:
    """Wraps handlers: extract + validate token, pin the connection's
    identity, translate exceptions to status codes."""

    # idle pins older than this may be reclaimed; also guards against
    # ip:port reuse after the TCP connection closed (context.peer() is
    # unique only among LIVE connections)
    PIN_IDLE_TTL_S = 900.0

    def __init__(self, coord: Coordinator):
        self.coord = coord
        # Per-connection identity pinning (reference
        # token_auth_metadata_processor.cpp:65-74: once a connection has
        # authenticated as a user, a token for a DIFFERENT user on the
        # same connection is rejected).  Keyed by context.peer().  gRPC
        # Python exposes no connection-close hook, so pin lifetime is
        # approximated: each pin refcounts its in-flight RPCs
        # (context.add_callback fires at rpc termination); eviction under
        # pressure only ever reclaims pins with ZERO in-flight RPCs,
        # oldest-idle first — a connection actively issuing RPCs can never
        # lose its pin — and idle pins expire after PIN_IDLE_TTL_S so a
        # reused ip:port cannot inherit (or be rejected by) a dead
        # connection's identity.
        self._pins: dict[str, _Pin] = {}
        self._pin_lock = threading.Lock()
        self._max_pins = 4096

    def _release_pin(self, peer: str) -> None:
        with self._pin_lock:
            pin = self._pins.get(peer)
            if pin is not None:
                pin.inflight -= 1
                if pin.inflight <= 0:
                    pin.inflight = 0
                    pin.idle_since = time.monotonic()

    def _reclaim_locked(self, now: float) -> None:
        """Drop TTL-expired idle pins; under pressure also evict the
        oldest idle pin.  Pins with in-flight RPCs are never touched."""
        expired = [p for p, pin in self._pins.items()
                   if pin.inflight == 0
                   and now - pin.idle_since > self.PIN_IDLE_TTL_S]
        for p in expired:
            del self._pins[p]
        if len(self._pins) >= self._max_pins:
            idle = [(pin.idle_since, p) for p, pin in self._pins.items()
                    if pin.inflight == 0]
            if idle:
                del self._pins[min(idle)[1]]
            # else: every pin has live RPCs — grow past the soft cap
            # rather than void the one-user-per-connection guarantee

    def token(self, context) -> str:
        """Bearer extraction + validation + connection pinning; raises
        InvalidTokenException (-> UNAUTHENTICATED) on any failure."""
        raw = _token(context)
        user = self.coord.auth.validate_token(raw)
        peer = context.peer()
        now = time.monotonic()
        with self._pin_lock:
            pin = self._pins.get(peer)
            if pin is not None and pin.inflight == 0 \
                    and now - pin.idle_since > self.PIN_IDLE_TTL_S:
                del self._pins[peer]
                pin = None
            if pin is None:
                if len(self._pins) >= self._max_pins:
                    self._reclaim_locked(now)
                pin = self._pins[peer] = _Pin(user.user_id)
            elif pin.user_id != user.user_id:
                raise InvalidTokenException(
                    "connection already authenticated as a different user")
            pin.inflight += 1
        # add_callback returns False (and never fires) if the RPC already
        # terminated — release immediately then, or the pin's inflight
        # count leaks and it becomes exempt from TTL expiry forever.
        if not context.add_callback(lambda: self._release_pin(peer)):
            self._release_pin(peer)
        return raw

    def unary(self, fn):
        def handler(request, context):
            try:
                return fn(self.token(context), request, context)
            except Exception as e:  # noqa: BLE001 — rpc boundary
                _abort(context, e)
        return handler

    def unary_noauth(self, fn):
        def handler(request, context):
            try:
                return fn(request, context)
            except Exception as e:  # noqa: BLE001
                _abort(context, e)
        return handler


def _job_state(job) -> "pb.JobState":
    msg = pb.JobState(
        uuid=job.job_uuid,
        status=int(job.status),
        tasks_executed=job.tasks_executed,
        bootstraps_executed=job.bootstraps_executed,
        output_frames=list(job.output_frames.values()),
    )
    if job.message:
        msg.message = job.message
    return msg


def _frame_meta(entry) -> "pb.DataFrameMetadata":
    return pb.DataFrameMetadata(
        uuid=entry.uuid,
        name=entry.name,
        schema_type=int(entry.schema_type),
        columns=mappers.columns_to_proto(entry.columns),
        rows_count=entry.row_count,
        partitions=entry.partitions,
    )


def build_server(coord: Coordinator, address: str = "127.0.0.1:0",
                 ) -> tuple[grpc.Server, int]:
    """Returns (server, bound_port). Caller starts/stops the server.

    TLS: when config.security.ssl is set, the port is bound with
    grpc.ssl_server_credentials (the reference's SslServerCredentials path,
    src/main.cpp:39-57); otherwise insecure (the LOCAL_TCP analog)."""
    guard = _Guard(coord)

    # ---- Auth ----
    def authorize(request, context):
        return pb.ConnectionToken(
            token=coord.authorize_connection(request.authentication_token)
        )

    auth_handlers = {
        "authorize_connection": grpc.unary_unary_rpc_method_handler(
            guard.unary_noauth(authorize),
            request_deserializer=pb.AuthenticationToken.FromString,
            response_serializer=pb.ConnectionToken.SerializeToString,
        ),
    }

    # ---- Session ----
    def create_session(token, request, context):
        s = coord.create_session(token, request.name)
        return pb.SessionInfo(uuid=s.uuid, name=s.name)

    def destroy_session(token, request, context):
        coord.destroy_session(token, request.uuid)
        return pb.Empty()

    def list_sessions(token, request, context):
        return pb.SessionInfoList(sessions=[
            pb.SessionInfo(uuid=s.uuid, name=s.name)
            for s in coord.list_sessions(token)
        ])

    def add_key(request_iterator, context):
        try:
            token = guard.token(context)
            first = next(request_iterator)
            if first.WhichOneof("part") != "options":
                raise MappingError("first add_key message must be options")
            opt = first.options
            chunks = (
                m.data for m in request_iterator
                if m.WhichOneof("part") == "data"
            )
            coord.add_key(token, opt.session_uuid, SchemaType(opt.type),
                          opt.size, chunks)
            return pb.Empty()
        except Exception as e:  # noqa: BLE001
            _abort(context, e)

    def remove_key(token, request, context):
        coord.remove_key(token, request.session_uuid,
                         SchemaType(request.type))
        return pb.Empty()

    def list_keys(token, request, context):
        return pb.SessionKeyList(type=[
            int(t) for t in coord.list_keys(token, request.session_uuid)
        ])

    session_handlers = {
        "create_session": grpc.unary_unary_rpc_method_handler(
            guard.unary(create_session),
            request_deserializer=pb.SessionCreateRequest.FromString,
            response_serializer=pb.SessionInfo.SerializeToString,
        ),
        "destroy_session": grpc.unary_unary_rpc_method_handler(
            guard.unary(destroy_session),
            request_deserializer=pb.SessionDestroyRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
        "list_sessions": grpc.unary_unary_rpc_method_handler(
            guard.unary(list_sessions),
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.SessionInfoList.SerializeToString,
        ),
        "add_key": grpc.stream_unary_rpc_method_handler(
            add_key,
            request_deserializer=pb.SessionAddKeyRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
        "remove_key": grpc.unary_unary_rpc_method_handler(
            guard.unary(remove_key),
            request_deserializer=pb.SessionRemoveKeyRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
        "list_keys": grpc.unary_unary_rpc_method_handler(
            guard.unary(list_keys),
            request_deserializer=pb.SessionKeyListRequest.FromString,
            response_serializer=pb.SessionKeyList.SerializeToString,
        ),
    }

    # ---- Storage ----
    def add_data_frame(request_iterator, context):
        """Bidi stream, reference shape (storage_controller.cpp:55-166):
        first message info, server replies metadata, then data chunks."""
        entry = None
        finished = False
        try:
            token = guard.token(context)
            first = next(request_iterator)
            if first.WhichOneof("part") != "info":
                raise MappingError("first message must be info")
            info = first.info
            entry = coord.begin_data_frame_upload(
                token, info.session_uuid, info.name, SchemaType(info.type),
                mappers.columns_to_model(info.columns),
                info.row_count, info.partitions,
                seeded_seed=info.seeded_seed if info.seeded else None,
            )
            yield pb.DataFrameAddResponse(metadata=_frame_meta(entry))
            for m in request_iterator:
                if m.WhichOneof("part") != "data":
                    raise MappingError("expected data chunk")
                coord.append_data_frame(token, info.session_uuid, entry.uuid,
                                        m.data)
            coord.finish_data_frame_upload(token, info.session_uuid,
                                           entry.uuid)
            finished = True
        except Exception as e:  # noqa: BLE001
            _abort(context, e)
        finally:
            # terminated stream (disconnect/abort/error): drop in-flight
            # seeded state + the unfinished frame (reference deletes frames
            # on aborted streams, storage_controller.cpp:128-150)
            if entry is not None and not finished:
                try:
                    coord.abandon_data_frame_upload(
                        token, info.session_uuid, entry.uuid)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    log.exception("abandoning upload %s", entry.uuid)

    def remove_data_frame(token, request, context):
        coord.remove_data_frame(token, request.session_uuid, request.uuid)
        return pb.Empty()

    def list_data_frames(token, request, context):
        schema = (
            SchemaType(request.type) if request.HasField("type") else None
        )
        return pb.DataFrameMetadataList(dataframes=[
            _frame_meta(e)
            for e in coord.list_data_frames(token, request.session_uuid,
                                            schema)
        ])

    def download(stream):
        """A server-streaming handler: one chunk per partition that
        ``stream(token, session_uuid, frame_uuid)`` yields (a coordinator
        download method)."""
        def handler(request, context):
            try:
                token = guard.token(context)
                for part, chunk in enumerate(
                        stream(token, request.session_uuid, request.uuid)):
                    yield pb.DataFrameChunk(data=chunk, partition=part)
            except Exception as e:  # noqa: BLE001
                _abort(context, e)
        return handler

    storage_handlers = {
        "add_data_frame": grpc.stream_stream_rpc_method_handler(
            add_data_frame,
            request_deserializer=pb.DataFrameAddRequest.FromString,
            response_serializer=pb.DataFrameAddResponse.SerializeToString,
        ),
        "remove_data_frame": grpc.unary_unary_rpc_method_handler(
            guard.unary(remove_data_frame),
            request_deserializer=pb.DataFrameRemoveRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
        "list_data_frames": grpc.unary_unary_rpc_method_handler(
            guard.unary(list_data_frames),
            request_deserializer=pb.DataFrameListRequest.FromString,
            response_serializer=pb.DataFrameMetadataList.SerializeToString,
        ),
        "download_data_frame": grpc.unary_stream_rpc_method_handler(
            download(coord.download_data_frame),
            request_deserializer=pb.DataFrameDownloadRequest.FromString,
            response_serializer=pb.DataFrameChunk.SerializeToString,
        ),
        "download_data_frame_packed": grpc.unary_stream_rpc_method_handler(
            download(coord.download_data_frame_packed),
            request_deserializer=pb.DataFrameDownloadRequest.FromString,
            response_serializer=pb.DataFrameChunk.SerializeToString,
        ),
    }

    # ---- Execution ----
    def schedule_job(token, request, context):
        plan = mappers.plan_to_model(request.plan)
        job = coord.schedule_job(token, request.session_uuid, plan,
                                 request.concurrency_limit or 1)
        return pb.JobDescription(
            uuid=job.job_uuid,
            plan=request.plan,
            estimated_complexity=job.estimated_complexity,
        )

    def get_job_state(token, request, context):
        return _job_state(
            coord.get_job_state(token, request.session_uuid, request.uuid)
        )

    def list_jobs(token, request, context):
        return pb.JobStateList(states=[
            _job_state(j) for j in coord.list_jobs(token, request.session_uuid)
        ])

    def describe_job(token, request, context):
        job = coord.describe_job(token, request.session_uuid, request.uuid)
        return pb.JobDescription(
            uuid=job.job_uuid,
            plan=mappers.plan_to_proto(job.plan),
            estimated_complexity=job.estimated_complexity,
        )

    execution_handlers = {
        "schedule_job": grpc.unary_unary_rpc_method_handler(
            guard.unary(schedule_job),
            request_deserializer=pb.ScheduleJobRequest.FromString,
            response_serializer=pb.JobDescription.SerializeToString,
        ),
        "get_job_state": grpc.unary_unary_rpc_method_handler(
            guard.unary(get_job_state),
            request_deserializer=pb.GetJobStateRequest.FromString,
            response_serializer=pb.JobState.SerializeToString,
        ),
        "list_jobs": grpc.unary_unary_rpc_method_handler(
            guard.unary(list_jobs),
            request_deserializer=pb.ListJobsRequest.FromString,
            response_serializer=pb.JobStateList.SerializeToString,
        ),
        "describe_job": grpc.unary_unary_rpc_method_handler(
            guard.unary(describe_job),
            request_deserializer=pb.DescribeJobRequest.FromString,
            response_serializer=pb.JobDescription.SerializeToString,
        ),
    }

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=SERVER_THREADS),
        options=CHANNEL_OPTIONS,
    )
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("herdsman.Auth", auth_handlers),
        grpc.method_handlers_generic_handler("herdsman.Session",
                                             session_handlers),
        grpc.method_handlers_generic_handler("herdsman.Storage",
                                             storage_handlers),
        grpc.method_handlers_generic_handler("herdsman.Execution",
                                             execution_handlers),
    ))
    ssl = coord.config.security.ssl
    if ssl:
        with open(ssl.key_path, "rb") as f:
            key = f.read()
        with open(ssl.certificate_path, "rb") as f:
            cert = f.read()
        root = None
        if ssl.root_certificates_path:
            with open(ssl.root_certificates_path, "rb") as f:
                root = f.read()
        creds = grpc.ssl_server_credentials(
            [(key, cert)], root_certificates=root,
            require_client_auth=root is not None,
        )
        port = server.add_secure_port(address, creds)
    else:
        port = server.add_insecure_port(address)
    return server, port


def serve(config_path: str = "./herdsman.yaml",
          device: str | torch.device = "cuda") -> None:
    """Blocking server entry point (the main() analog): the coordinator is
    built on ``device``, which raises without a card unless it is
    ``"cpu"``."""
    from herdsman_tpu_torch.service.config import load_config

    cfg = load_config(config_path)
    coord = Coordinator(cfg, device=device)
    server, port = build_server(
        coord, f"{cfg.server.hostname}:{cfg.server.port}"
    )
    server.start()
    log.info("herdsman listening on port %d", port)
    try:
        server.wait_for_termination()
    finally:
        server.stop(None)
        coord.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="./herdsman.yaml")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.config, args.device)


if __name__ == "__main__":
    main()
