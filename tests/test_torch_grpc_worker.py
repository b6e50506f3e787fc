"""The port's static gRPC worker fleet (``service/grpc_worker.py``: the
GrpcWorkerGroup + hived analog, reference
src/execution/worker/grpc/grpc_worker_group.cpp:13-110) and the
coordinator's ``workers.grpc`` branch, on the CPU, as
tests/test_grpc_worker.py holds the JAX package's:

- a map + reduce plan dispatched as proto tasks over
  herdsman.Worker/{map,reduce} to a two-worker fleet on ``device="cpu"``
  sharing the storage namespace: tasks land round-robin on both workers
  (reference :102), and the output and intermediate frames are byte-equal
  to the JAX coordinator's fleet job (its worker on ``conv_i8``) on the
  same key and upload, and decrypt;
- TIME_OUT retry on UNAVAILABLE (reference executor.cpp:136-167), a
  terminal worker ERROR (INTERNAL, :168-178), and a hung worker that
  surfaces as DEADLINE_EXCEEDED -> TIME_OUT.
"""

import functools
import pathlib
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np
import pytest
import torch

from herdsman_tpu.core import reference as jref
from herdsman_tpu.service import coordinator as jcoord
from herdsman_tpu.service.config import Config as JConfig
from herdsman_tpu.service.config import GrpcWorkersConfig as JGrpcConfig
from herdsman_tpu.service.config import SecurityConfig as JSecurityConfig
from herdsman_tpu.service.config import ServerConfig as JServerConfig
from herdsman_tpu.service.grpc_worker import \
    make_worker_server as jmake_worker_server
from herdsman_tpu_torch.circuit import (
    DAG,
    CircuitBuilder,
    ColumnMeta,
    DataType,
    ExecutionPlan,
    InputStage,
    MapperStage,
    OutputStage,
    Policy,
    ReduceStage,
    SchemaType,
)
from herdsman_tpu_torch.compiler.reduce_tree import build_reduce_tree
from herdsman_tpu_torch.compiler.stages import partition_sizes
from herdsman_tpu_torch.core import TOY, client
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb
from herdsman_tpu_torch.service.config import (Config, GrpcWorkersConfig,
                                               SecurityConfig, ServerConfig)
from herdsman_tpu_torch.service.coordinator import Coordinator
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.service.grpc_worker import (GrpcWorkerGroup,
                                                    make_worker_server)
from herdsman_tpu_torch.service.offload import (CryptoKeyPtr, DataFramePtr,
                                                InputDataFramePtr, MapTask,
                                                TaskKey, TaskStatus)
from herdsman_tpu_torch.utils import rowcodec

IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MAP_OUT_COLS = (ColumnMeta("x", DataType.UINT8),)
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4), (128, 1)]
PARTITIONS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def map_circuit():
    cb = CircuitBuilder(IN_COLS)
    cb.output("x", cb.input_column("a") ^ cb.input_column("b"))
    return cb.build()


def reduce_circuit():
    cb = CircuitBuilder(MAP_OUT_COLS + MAP_OUT_COLS)
    cb.output("x", cb.input_column_at(0) ^ cb.input_column_at(1))
    return cb.build()


def plan(frame_uuid, reduce=True):
    """Input -> Mapper (x = a XOR b) [-> Reduce (XOR, PARALLEL_FULL, 2 a
    node)] -> Output, as tests/test_grpc_worker.py builds it."""
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(map_circuit()))]
    if reduce:
        stages.append(g.emplace(ReduceStage(reduce_circuit(),
                                            Policy.PARALLEL_FULL, 2)))
    stages.append(g.emplace(OutputStage("result")))
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


@functools.cache
def inputs():
    """(client key, server key bytes, upload bytes): one keygen and one
    encryption, which every job here uploads as they are."""
    rng = np.random.default_rng(1234)
    ck, sk = jref.keygen(TOY, rng)
    cts = client.encrypt_rows(ck, IN_COLS, TABLE, rng)
    return ck, jcoord.serialize_server_key(sk), rowcodec.frame_rows(
        frame_codec.rows_to_payloads(cts))


def start_fleet(make, tmp, n=2, keys="keys", **kw):
    servers = []
    for _ in range(n):
        srv, port = make(str(tmp / "storage"), str(tmp / keys), port=0, **kw)
        srv.start()
        servers.append((srv, port))
    return servers


def coordinator(tmp, servers, jax=False):
    addresses = [f"127.0.0.1:{p}" for _, p in servers]
    if jax:
        return jcoord.Coordinator(JConfig(
            server=JServerConfig(key_directory=str(tmp / "keys"),
                                 storage_directory=str(tmp / "storage")),
            security=JSecurityConfig(secret_key="test-secret"),
            grpc_workers=JGrpcConfig(addresses)), engine="conv_i8")
    return Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp / "keys"),
                            storage_directory=str(tmp / "storage")),
        security=SecurityConfig(secret_key="test-secret"),
        grpc_workers=GrpcWorkersConfig(addresses)), device="cpu")


def run(coord, rows=len(TABLE), partitions=PARTITIONS, reduce=True):
    """authorize -> session -> key -> rows -> plan -> wait, on either
    package's coordinator; (job, the output and intermediate frames)."""
    _, key_bytes, data = inputs()
    token = coord.authorize_connection("admin==true")
    session = coord.create_session(token, "grpc-fleet").uuid
    coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                  [key_bytes])
    meta = coord.begin_data_frame_upload(token, session, "in",
                                         SchemaType.TFHE_BOOL, IN_COLS, rows,
                                         partitions)
    coord.append_data_frame(token, session, meta.uuid, data)
    coord.finish_data_frame_upload(token, session, meta.uuid)
    job = coord.schedule_job(token, session, plan(meta.uuid, reduce).to_json(),
                             concurrency_limit=4)
    job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
    if job.status != JobStatus.COMPLETED:
        return job, None
    (out,) = job.output_frames.values()
    (mid,) = [f.uuid for f in coord.list_data_frames(token, session)
              if f.name.startswith(f"intermediate-{job.job_uuid}-")]
    return job, {name: list(coord.download_data_frame(token, session, u))
                 for name, u in (("out", out), ("mid", mid))}


def decrypt(parts):
    ck, _, _ = inputs()
    rows = [pl for part in parts for pl in rowcodec.parse_rows(part)]
    cts = frame_codec.payloads_to_rows(rows, 8, TOY)
    return [r["x"] for r in client.decrypt_rows(ck, MAP_OUT_COLS, cts)]


def stop_all(coord, servers):
    coord.shutdown()
    for srv, _ in servers:
        srv.stop(grace=None)


@functools.cache
def jax_fleet_job():
    """(tasks, bootstraps, frames) of the JAX coordinator's fleet job, one
    worker on conv_i8, on the same key and upload."""
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        servers = start_fleet(jmake_worker_server, tmp, n=1,
                              engine="conv_i8")
        coord = coordinator(tmp, servers, jax=True)
        try:
            job, frames = run(coord)
            assert job.status == JobStatus.COMPLETED, job.message
            return job.tasks_executed, job.bootstraps_executed, frames
        finally:
            stop_all(coord, servers)


def test_grpc_fleet_map_reduce_round_robin_equals_jax(tmp_path):
    """Map + reduce over a two-worker fleet: every task lands round-robin
    (reference grpc_worker_group.cpp:102), and the frames are the JAX
    fleet's byte for byte, and decrypt."""
    servers = start_fleet(make_worker_server, tmp_path, device="cpu")
    coord = coordinator(tmp_path, servers)
    try:
        job, frames = run(coord)
        assert job.status == JobStatus.COMPLETED, job.message
        assert job.retries == 0
        assert not coord._session_dsk  # the coordinator built no key
        assert coord._offload_group.concurrent_workers() == 2
    finally:
        stop_all(coord, servers)
    tree = build_reduce_tree(partition_sizes(len(TABLE), PARTITIONS),
                             Policy.PARALLEL_FULL, 2)
    assert job.tasks_executed == PARTITIONS + tree.total_tasks()
    counts = [srv.task_counts["tasks"] for srv, _ in servers]
    assert counts == [-(-job.tasks_executed // 2), job.tasks_executed // 2]
    assert (job.tasks_executed, job.bootstraps_executed, frames) == \
        jax_fleet_job()
    assert decrypt(frames["mid"]) == [a ^ b for a, b in TABLE]
    expect = 0
    for a, b in TABLE:
        expect ^= a ^ b
    assert decrypt(frames["out"]) == [expect]


def test_grpc_fleet_retry_on_unavailable(tmp_path):
    """Two injected UNAVAILABLEs burn two of the task's three attempts; the
    third succeeds (reference executor.cpp:136-167)."""
    servers = start_fleet(make_worker_server, tmp_path, n=1, device="cpu",
                          fail_first=2)
    coord = coordinator(tmp_path, servers)
    try:
        job, frames = run(coord, partitions=1, reduce=False)
        assert job.status == JobStatus.COMPLETED, job.message
        assert job.retries == 0
        assert servers[0][0].task_counts == {"failed": 2, "tasks": 3}
        assert decrypt(frames["out"]) == [a ^ b for a, b in TABLE]
    finally:
        stop_all(coord, servers)


def test_grpc_fleet_worker_error_is_terminal(tmp_path):
    """A worker that RAISES (INTERNAL) fails the job at once, no retry
    stacked on a terminal ERROR (reference executor.cpp:168-178); injected
    by pointing the worker at an empty key directory."""
    servers = start_fleet(make_worker_server, tmp_path, n=1, keys="nokeys",
                          device="cpu")
    coord = coordinator(tmp_path, servers)
    try:
        job, _ = run(coord, partitions=1, reduce=False)
        assert job.status == JobStatus.FAILED
        assert "worker ERROR" in job.message
        assert job.retries == 1  # one job execution, no stacked retries
        assert servers[0][0].task_counts["tasks"] == 1
    finally:
        stop_all(coord, servers)


def test_hung_worker_times_out_as_retryable(monkeypatch):
    """A worker that never answers surfaces as DEADLINE_EXCEEDED ->
    TIME_OUT (retryable) instead of leaking the RPC forever."""
    release = threading.Event()

    def hang(request, context):
        release.wait(10)
        return pb.Empty()

    server = grpc.server(ThreadPoolExecutor(max_workers=1))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("herdsman.Worker", {
            "map": grpc.unary_unary_rpc_method_handler(
                hang, request_deserializer=pb.MapTaskProto.FromString,
                response_serializer=pb.Empty.SerializeToString)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    monkeypatch.setattr(GrpcWorkerGroup, "RPC_TIMEOUT_S", 0.5)
    group = GrpcWorkerGroup([f"127.0.0.1:{port}"])
    try:
        task = MapTask("s", InputDataFramePtr("f", 0, 1), DataFramePtr("o", 0),
                       CryptoKeyPtr(SchemaType.TFHE_BOOL), map_circuit())
        t0 = time.monotonic()
        handle = group.schedule_task(TaskKey("s", "j", 0, 0), task)
        assert handle.wait(5) is TaskStatus.TIME_OUT
        assert time.monotonic() - t0 < 3  # the deadline fired, not the hang
    finally:
        release.set()
        group.shutdown()
        server.stop(grace=None)


def test_grpc_worker_group_needs_an_address():
    with pytest.raises(ValueError, match="at least one address"):
        GrpcWorkerGroup([])
