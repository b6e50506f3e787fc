"""HerdClient — the Python client library (the `herd` sibling-repo analog,
SURVEY.md §2.5), the port's copy of ``herdsman_tpu.client.herd_client``:
connects to the gRPC coordinator, authorizes, manages sessions/keys/frames,
submits execution plans, polls job state, downloads results. Combine with
core.reference (keygen/encrypt/decrypt), core.client (table codec) and
circuit.builder (circuit DSL) for the full client-side workflow.

It runs on the host and touches no device.  The wire is the JAX package's,
so it talks to a server of either package.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import grpc
import numpy as np

from herdsman_tpu_torch.circuit.model import ColumnMeta, SchemaType
from herdsman_tpu_torch.circuit.plan import ExecutionPlan
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service import mappers
from herdsman_tpu_torch.service._proto import CHANNEL_OPTIONS
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.utils import rowcodec

DEFAULT_CHUNK = 1 << 20


class HerdClient:
    def __init__(self, address: str, root_certificates: bytes | None = None,
                 private_key: bytes | None = None,
                 certificate_chain: bytes | None = None,
                 ssl_target_name_override: str | None = None):
        """``root_certificates`` switches the channel to TLS (the
        reference server's SslServerCredentials path, src/main.cpp:39-57);
        ``private_key``/``certificate_chain`` add mutual TLS when the
        server requires client auth.  ``ssl_target_name_override`` lets
        tests dial 127.0.0.1 with a cert issued to another hostname."""
        options = list(CHANNEL_OPTIONS)
        if root_certificates is not None:
            if ssl_target_name_override:
                options.append(("grpc.ssl_target_name_override",
                                ssl_target_name_override))
            creds = grpc.ssl_channel_credentials(
                root_certificates=root_certificates,
                private_key=private_key,
                certificate_chain=certificate_chain,
            )
            self._channel = grpc.secure_channel(address, creds,
                                                options=options)
        else:
            self._channel = grpc.insecure_channel(address, options=options)
        self._token: Optional[str] = None

    def close(self) -> None:
        self._channel.close()

    # ---- plumbing ----

    def _call(self, service: str, method: str, request, response_cls):
        fn = self._channel.unary_unary(
            f"/herdsman.{service}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=response_cls.FromString,
        )
        return fn(request, metadata=self._meta())

    def _meta(self):
        return (("authorization", f"Bearer {self._token}"),) if self._token \
            else ()

    # ---- auth ----

    def authorize(self, credential: str = "admin==true") -> str:
        resp = self._call(
            "Auth", "authorize_connection",
            pb.AuthenticationToken(authentication_token=credential),
            pb.ConnectionToken,
        )
        self._token = resp.token
        return resp.token

    # ---- sessions ----

    def create_session(self, name: str):
        return self._call("Session", "create_session",
                          pb.SessionCreateRequest(name=name), pb.SessionInfo)

    def destroy_session(self, session_uuid: str) -> None:
        self._call("Session", "destroy_session",
                   pb.SessionDestroyRequest(uuid=session_uuid), pb.Empty)

    def list_sessions(self):
        return list(
            self._call("Session", "list_sessions", pb.Empty(),
                       pb.SessionInfoList).sessions
        )

    # ---- keys ----

    def add_key(self, session_uuid: str, schema_type: SchemaType,
                key_bytes: bytes, chunk_size: int = DEFAULT_CHUNK) -> None:
        def messages():
            yield pb.SessionAddKeyRequest(options=pb.SessionAddKeyOptions(
                type=int(schema_type), session_uuid=session_uuid,
                size=len(key_bytes),
            ))
            for off in range(0, len(key_bytes), chunk_size):
                yield pb.SessionAddKeyRequest(
                    data=key_bytes[off:off + chunk_size]
                )

        fn = self._channel.stream_unary(
            "/herdsman.Session/add_key",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.Empty.FromString,
        )
        fn(messages(), metadata=self._meta())

    def list_keys(self, session_uuid: str) -> list[SchemaType]:
        resp = self._call("Session", "list_keys",
                          pb.SessionKeyListRequest(session_uuid=session_uuid),
                          pb.SessionKeyList)
        return [SchemaType(t) for t in resp.type]

    def remove_key(self, session_uuid: str, schema_type: SchemaType) -> None:
        self._call("Session", "remove_key",
                   pb.SessionRemoveKeyRequest(session_uuid=session_uuid,
                                              type=int(schema_type)),
                   pb.Empty)

    # ---- data frames ----

    def _stream_add_data_frame(self, info, payloads: list, chunk_rows: int):
        """Shared bidi add_data_frame protocol: info, then framed row
        chunks; returns the server's frame metadata."""
        def messages():
            yield pb.DataFrameAddRequest(info=info)
            for off in range(0, len(payloads), chunk_rows):
                yield pb.DataFrameAddRequest(
                    data=rowcodec.frame_rows(payloads[off:off + chunk_rows])
                )

        fn = self._channel.stream_stream(
            "/herdsman.Storage/add_data_frame",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.DataFrameAddResponse.FromString,
        )
        responses = fn(messages(), metadata=self._meta())
        metadata = next(iter(responses)).metadata
        for _ in responses:  # drain
            pass
        return metadata

    def upload_data_frame(
        self,
        session_uuid: str,
        name: str,
        schema_type: SchemaType,
        columns: Sequence[ColumnMeta],
        encrypted_rows: np.ndarray,      # [rows, bits, n+1] uint32
        partitions: int,
        chunk_rows: int = 64,
    ):
        """Streamed upload (bidi, reference shape); returns frame metadata."""
        payloads = frame_codec.rows_to_payloads(np.asarray(encrypted_rows))
        info = pb.DataFrameInfo(
            type=int(schema_type), session_uuid=session_uuid, name=name,
            row_count=len(payloads), partitions=partitions,
            columns=mappers.columns_to_proto(columns),
        )
        return self._stream_add_data_frame(info, payloads, chunk_rows)

    def upload_data_frame_seeded(
        self,
        session_uuid: str,
        name: str,
        schema_type: SchemaType,
        columns: Sequence[ColumnMeta],
        seeded_bodies: np.ndarray,       # [rows, bits] uint32 (bodies only)
        seed: int,
        partitions: int,
        chunk_rows: int = 1024,
    ):
        """Compressed upload (beyond the reference): ships one u32 per bit
        plus the mask seed; the coordinator re-derives the masks and stores
        the standard expanded frame.  ~(n+1)x less upload bandwidth.

        ``seed`` must be the one returned by core.client.encrypt_rows_seeded
        (freshly drawn per call) — never reuse a seed across uploads under
        the same key (mask reuse leaks plaintext relations)."""
        bodies = np.ascontiguousarray(np.asarray(seeded_bodies,
                                                 dtype=np.uint32))
        payloads = [bodies[r].tobytes() for r in range(bodies.shape[0])]
        info = pb.DataFrameInfo(
            type=int(schema_type), session_uuid=session_uuid, name=name,
            row_count=len(payloads), partitions=partitions,
            columns=mappers.columns_to_proto(columns),
            seeded=True, seeded_seed=seed & ((1 << 64) - 1),
        )
        return self._stream_add_data_frame(info, payloads, chunk_rows)

    def list_data_frames(self, session_uuid: str,
                         schema_type: Optional[SchemaType] = None):
        req = pb.DataFrameListRequest(session_uuid=session_uuid)
        if schema_type is not None:
            req.type = int(schema_type)
        return list(
            self._call("Storage", "list_data_frames", req,
                       pb.DataFrameMetadataList).dataframes
        )

    def remove_data_frame(self, session_uuid: str, frame_uuid: str) -> None:
        self._call("Storage", "remove_data_frame",
                   pb.DataFrameRemoveRequest(session_uuid=session_uuid,
                                             uuid=frame_uuid), pb.Empty)

    def _download(self, method: str, session_uuid: str,
                  frame_uuid: str) -> list[bytes]:
        """The chunks (one a partition) of a server-streaming download."""
        fn = self._channel.unary_stream(
            f"/herdsman.Storage/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.DataFrameChunk.FromString,
        )
        return [chunk.data for chunk in fn(
            pb.DataFrameDownloadRequest(session_uuid=session_uuid,
                                        uuid=frame_uuid),
            metadata=self._meta(),
        )]

    def download_data_frame(
        self, session_uuid: str, frame_uuid: str, total_bits: int, params
    ) -> np.ndarray:
        """Download + decode to [rows, total_bits, n+1] uint32."""
        payloads = [pl for part in self._download(
                        "download_data_frame", session_uuid, frame_uuid)
                    for pl in rowcodec.parse_rows(part)]
        return frame_codec.payloads_to_rows(payloads, total_bits, params)

    def download_data_frame_packed(self, session_uuid: str,
                                   frame_uuid: str) -> list[bytes]:
        """Compressed download: GLWE-packed partitions (decrypt with
        core.client.decrypt_rows_packed; needs the GLWE secret key)."""
        return self._download("download_data_frame_packed", session_uuid,
                              frame_uuid)

    # ---- execution ----

    def schedule_job(self, session_uuid: str, plan: ExecutionPlan,
                     concurrency_limit: int = 1):
        return self._call(
            "Execution", "schedule_job",
            pb.ScheduleJobRequest(
                session_uuid=session_uuid,
                plan=mappers.plan_to_proto(plan),
                concurrency_limit=concurrency_limit,
            ),
            pb.JobDescription,
        )

    def get_job_state(self, session_uuid: str, job_uuid: str):
        return self._call("Execution", "get_job_state",
                          pb.GetJobStateRequest(session_uuid=session_uuid,
                                                uuid=job_uuid), pb.JobState)

    def list_jobs(self, session_uuid: str):
        return list(
            self._call("Execution", "list_jobs",
                       pb.ListJobsRequest(session_uuid=session_uuid),
                       pb.JobStateList).states
        )

    def describe_job(self, session_uuid: str, job_uuid: str):
        return self._call("Execution", "describe_job",
                          pb.DescribeJobRequest(session_uuid=session_uuid,
                                                uuid=job_uuid),
                          pb.JobDescription)

    def wait_for_job(self, session_uuid: str, job_uuid: str,
                     timeout: float = 600.0, poll: float = 0.05):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_state(session_uuid, job_uuid)
            if st.status in (int(JobStatus.COMPLETED), int(JobStatus.FAILED)):
                return st
            time.sleep(poll)
        raise TimeoutError(job_uuid)
