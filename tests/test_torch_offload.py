"""The port's offload worker group (``service/offload.py``) and worker
(``service/offload_worker.py``) against the JAX package's, on the CPU, as
tests/test_offload.py holds the JAX ones:

- a map + reduce plan dispatched task by task over HTTP to a port worker on
  ``device="cpu"`` under SEQUENCED and PARALLEL_FULL, on the worker's
  ``conv_i8`` and on its default ``bt``: output and intermediate frames
  byte-equal to the JAX coordinator's offload job (its worker on
  ``conv_i8``) on the same key and upload bytes, and decrypted;
- TIME_OUT retry, retry exhaustion failing the job once, completion by the
  output file alone, ``FilesystemWatch`` and the set-once ``TaskHandle``;
- the worker's key cache: a replaced key is rebuilt, a removed one
  dropped, and at most ``MAX_SESSIONS`` kept; its ``GET /counts``;
- ``task_to_wire`` equal to the JAX package's, key for key;
- a compressed server key with a seeded upload, expanded by the worker;
- ``workers.lambda`` beside ``workers.mesh.glwe_inputs``: the frame is
  packed at ingest and the worker cannot read it as rows, so the job fails
  after its retries, in both packages.
"""

import functools
import json
import pathlib
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from herdsman_tpu.circuit import CircuitBuilder as JCircuitBuilder
from herdsman_tpu.circuit import ColumnMeta as JColumnMeta
from herdsman_tpu.circuit import DataType as JDataType
from herdsman_tpu.circuit import SchemaType as JSchemaType
from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.service import coordinator as jcoord
from herdsman_tpu.service import offload as joffload
from herdsman_tpu.service.config import Config as JConfig
from herdsman_tpu.service.config import LambdaWorkersConfig as JLambdaConfig
from herdsman_tpu.service.config import MeshWorkersConfig as JMeshConfig
from herdsman_tpu.service.config import SecurityConfig as JSecurityConfig
from herdsman_tpu.service.config import ServerConfig as JServerConfig
from herdsman_tpu.service.offload_worker import make_server as jmake_server
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
from herdsman_tpu_torch.core import PARAM_SETS, client
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops import kernels
from herdsman_tpu_torch.service import coordinator as tcoord
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service import offload, offload_worker
from herdsman_tpu_torch.service.config import (
    Config,
    LambdaWorkersConfig,
    MeshWorkersConfig,
    SecurityConfig,
    ServerConfig,
)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.service.offload_worker import make_server
from herdsman_tpu_torch.service.storage import StorageService
from herdsman_tpu_torch.utils import rowcodec

IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MAP_OUT_COLS = (ColumnMeta("x", DataType.UINT8),)
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4), (128, 1), (9, 64), (0, 77)]
PARTITIONS = 3
POLICIES = {"SEQUENCED": Policy.SEQUENCED,
            "PARALLEL_FULL": Policy.PARALLEL_FULL}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def map_circuit(builder=CircuitBuilder, cols=IN_COLS):
    cb = builder(cols)
    cb.output("x", cb.input_column("a") ^ cb.input_column("b"))
    return cb.build()


def reduce_circuit(builder=CircuitBuilder, cols=MAP_OUT_COLS):
    cb = builder(cols + cols)
    cb.output("x", cb.input_column_at(0) ^ cb.input_column_at(1))
    return cb.build()


def plan(frame_uuid, policy=None):
    """Input -> Mapper (x = a XOR b) [-> Reduce (XOR, 2 per node)] ->
    Output, as tests/test_offload.py builds it; map-only without
    ``policy``."""
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(map_circuit()))]
    if policy is not None:
        stages.append(g.emplace(ReduceStage(reduce_circuit(), policy,
                                            per_node_count=2)))
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
    upload = rowcodec.frame_rows(frame_codec.rows_to_payloads(cts))
    return ck, jcoord.serialize_server_key(sk), upload


def start_worker(make, tmp, **kw):
    srv = make(str(tmp / "storage"), str(tmp / "keys"), port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def port_coordinator(tmp, port, **cfg):
    return tcoord.Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp / "keys"),
                            storage_directory=str(tmp / "storage")),
        security=SecurityConfig(secret_key="test-secret"),
        lambda_workers=LambdaWorkersConfig(f"127.0.0.1:{port}", 4), **cfg),
        device="cpu")


def jax_coordinator(tmp, port, **cfg):
    return jcoord.Coordinator(JConfig(
        server=JServerConfig(key_directory=str(tmp / "keys"),
                             storage_directory=str(tmp / "storage")),
        security=JSecurityConfig(secret_key="test-secret"),
        lambda_workers=JLambdaConfig(f"127.0.0.1:{port}", 4), **cfg),
        engine="conv_i8")


def upload(coord, key_bytes, data, rows=len(TABLE), partitions=PARTITIONS,
           token=None, session=None, **kw):
    """authorize -> session -> key -> streamed row upload, on either
    package's coordinator (the wire types are the same integers and
    bytes)."""
    if session is None:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "offload").uuid
    coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                  [key_bytes])
    meta = coord.begin_data_frame_upload(
        token, session, "in", SchemaType.TFHE_BOOL, IN_COLS, rows,
        partitions, **kw)
    coord.append_data_frame(token, session, meta.uuid, data)
    coord.finish_data_frame_upload(token, session, meta.uuid)
    return token, session, meta.uuid


def run(coord, token, session, frame, policy=None):
    """Schedule the plan, wait, and download the output frame and the
    map's intermediate frame."""
    job = coord.schedule_job(token, session, plan(frame, policy).to_json(),
                             concurrency_limit=4)
    job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
    if job.status != JobStatus.COMPLETED:
        return job, None
    (out,) = job.output_frames.values()
    (mid,) = [f.uuid for f in coord.list_data_frames(token, session)
              if f.name.startswith(f"intermediate-{job.job_uuid}-")]
    return job, {name: list(coord.download_data_frame(token, session, u))
                 for name, u in (("out", out), ("mid", mid))}


def decrypt(ck, parts):
    rows = [pl for part in parts for pl in rowcodec.parse_rows(part)]
    cts = frame_codec.payloads_to_rows(rows, 8, TOY)
    return [r["x"] for r in client.decrypt_rows(ck, MAP_OUT_COLS, cts)]


@functools.cache
def jax_offload_job(policy_name):
    """(tasks, bootstraps, frames) of the JAX coordinator's offload job,
    its worker on conv_i8, on the same key and upload."""
    _, key_bytes, data = inputs()
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        srv = start_worker(jmake_server, tmp, engine="conv_i8")
        coord = jax_coordinator(tmp, srv.server_address[1])
        try:
            job, frames = run(coord, *upload(coord, key_bytes, data),
                              POLICIES[policy_name])
            assert job.status == JobStatus.COMPLETED, job.message
            return job.tasks_executed, job.bootstraps_executed, frames
        finally:
            coord.shutdown()
            srv.shutdown()


@pytest.mark.parametrize("engine", ["conv_i8", "bt"])
@pytest.mark.parametrize("policy_name", sorted(POLICIES))
def test_offload_map_reduce_equals_jax(tmp_path, policy_name, engine):
    ck, key_bytes, data = inputs()
    kw = {} if engine == "bt" else {"engine": engine}  # bt is the default
    srv = start_worker(make_server, tmp_path, device="cpu", **kw)
    coord = port_coordinator(tmp_path, srv.server_address[1])
    try:
        token, session, frame = upload(coord, key_bytes, data)
        job, frames = run(coord, token, session, frame,
                          POLICIES[policy_name])
        assert job.status == JobStatus.COMPLETED, job.message
        assert job.retries == 0
        assert not coord._session_dsk  # the coordinator built no key
    finally:
        coord.shutdown()
        srv.shutdown()
    tree = build_reduce_tree(partition_sizes(len(TABLE), PARTITIONS),
                             POLICIES[policy_name], 2)
    assert job.tasks_executed == PARTITIONS + tree.total_tasks()
    j_tasks, j_bootstraps, j_frames = jax_offload_job(policy_name)
    assert (job.tasks_executed, job.bootstraps_executed) == (j_tasks,
                                                             j_bootstraps)
    assert frames == j_frames  # byte for byte, every partition
    assert decrypt(ck, frames["mid"]) == [a ^ b for a, b in TABLE]
    expect = 0
    for a, b in TABLE:
        expect ^= a ^ b
    assert decrypt(ck, frames["out"]) == [expect]


def test_offload_retry_on_timeout(tmp_path):
    """Two injected 500s burn two of the task's three attempts; the third
    succeeds (reference executor.cpp:136-167)."""
    ck, key_bytes, data = inputs()
    srv = start_worker(make_server, tmp_path, device="cpu", fail_first=2)
    coord = port_coordinator(tmp_path, srv.server_address[1])
    try:
        job, frames = run(coord, *upload(coord, key_bytes, data,
                                         partitions=1))
        assert job.status == JobStatus.COMPLETED, job.message
        assert job.retries == 0 and job.tasks_executed == 1
        assert decrypt(ck, frames["out"]) == [a ^ b for a, b in TABLE]
    finally:
        coord.shutdown()
        srv.shutdown()


def test_offload_retry_exhaustion_fails_job_terminally(tmp_path):
    """A task that exhausts RETRY_LIMIT fails the JOB once: terminal, no
    job-level retry stacked on top (reference executor.cpp:158-178)."""
    _, key_bytes, data = inputs()
    srv = start_worker(make_server, tmp_path, device="cpu",
                       fail_first=10_000)
    coord = port_coordinator(tmp_path, srv.server_address[1])
    try:
        job, _ = run(coord, *upload(coord, key_bytes, data, partitions=1))
        assert job.status == JobStatus.FAILED
        assert "failed after 3 attempts" in job.message
        assert job.retries == 1  # one job execution, not RETRY_LIMIT re-runs
    finally:
        coord.shutdown()
        srv.shutdown()


def test_offload_file_only_completion(tmp_path):
    """Fire-and-forget workers: the task completes because the expected
    output file exists, though the HTTP channel never says 200 (reference
    lambda_http_worker_group.cpp:244-259)."""
    ck, key_bytes, data = inputs()
    srv = start_worker(make_server, tmp_path, device="cpu", file_only=True)
    coord = port_coordinator(tmp_path, srv.server_address[1])
    try:
        job, frames = run(coord, *upload(coord, key_bytes, data))
        assert job.status == JobStatus.COMPLETED, job.message
        assert decrypt(ck, frames["out"]) == [a ^ b for a, b in TABLE]
    finally:
        coord.shutdown()
        srv.shutdown()


def test_file_watch_completes_a_task_whose_post_hangs(tmp_path):
    """With the POST still open, the output file's appearance alone
    completes the task (the watch's poll, reference :244-259); the late
    500 does not change a completed status."""
    storage = StorageService(str(tmp_path / "storage"))
    release = threading.Event()

    class Hang(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — http.server API
            self.rfile.read(int(self.headers["Content-Length"]))
            out = storage.partition_path("s", "out", 0)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(b"rows")
            release.wait(10)
            self.send_error(500, "late")

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Hang)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    group = offload.OffloadWorkerGroup(f"127.0.0.1:{srv.server_address[1]}",
                                       1, storage, poll_interval=0.02)
    try:
        task = offload.MapTask(
            "s", offload.InputDataFramePtr("in", 0, 1),
            offload.DataFramePtr("out", 0),
            offload.CryptoKeyPtr(SchemaType.TFHE_BOOL), map_circuit())
        handle = group.schedule_task(offload.TaskKey("s", "j", 1, 0), task)
        assert handle.wait(5) is offload.TaskStatus.COMPLETED
        assert not release.is_set()  # the POST has not been answered
    finally:
        release.set()
        group.shutdown()
        srv.shutdown()
    assert handle.status is offload.TaskStatus.COMPLETED


def test_task_handle_is_set_once():
    """The first completion channel wins, and a waiter wakes when a channel
    marks the handle from another thread (reference
    i_worker_group.cpp:4-25)."""
    handle = offload.TaskHandle(offload.TaskKey("s", "j", 1, 0))
    assert handle.wait(0.01) is offload.TaskStatus.PENDING
    timer = threading.Timer(0.05, handle.mark,
                            (offload.TaskStatus.COMPLETED,))
    timer.start()
    assert handle.wait(5) is offload.TaskStatus.COMPLETED
    timer.join()
    handle.mark(offload.TaskStatus.TIME_OUT)
    assert handle.status is offload.TaskStatus.COMPLETED


def test_filesystem_watch(tmp_path):
    """watch_for fires once when the file appears; unwatch cancels
    (reference filesystem_watch.cpp:4-71)."""
    watch = offload.FilesystemWatch(poll_interval=0.05)
    try:
        hits = []
        watch.watch_for(tmp_path / "a.out", lambda: hits.append("a"))
        watch.watch_for(tmp_path / "b.out", lambda: hits.append("b"))
        watch.unwatch(tmp_path / "b.out")
        time.sleep(0.2)
        assert hits == []
        (tmp_path / "a.out").write_bytes(b"x")
        (tmp_path / "b.out").write_bytes(b"x")
        deadline = time.monotonic() + 5
        while not hits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hits == ["a"]  # b was unwatched
        time.sleep(0.2)
        assert hits == ["a"]  # fires once
    finally:
        watch.stop()


def wire(mod, map_c, reduce_c, schema) -> list[dict]:
    """``mod.task_to_wire`` of a map and a reduce task of ``mod``'s model."""
    key = mod.CryptoKeyPtr(schema)
    return [mod.task_to_wire(t) for t in (
        mod.MapTask("s", mod.InputDataFramePtr("in", 2, 3),
                    mod.DataFramePtr("mid", 2), key, map_c),
        mod.ReduceTask("s", (mod.InputDataFramePtr("mid", 0, 3),
                             mod.InputDataFramePtr("hid", 1, 1)),
                       mod.DataFramePtr("out", 0), key, reduce_c))]


def test_task_to_wire_equals_jax():
    """The JSON task bodies of a map and a reduce task are the JAX
    package's, key for key."""
    j_in = (JColumnMeta("a", JDataType.UINT8),
            JColumnMeta("b", JDataType.UINT8))
    j_mid = (JColumnMeta("x", JDataType.UINT8),)
    port_wire = wire(offload, map_circuit(), reduce_circuit(),
                     SchemaType.TFHE_BOOL)
    assert port_wire == wire(joffload, map_circuit(JCircuitBuilder, j_in),
                             reduce_circuit(JCircuitBuilder, j_mid),
                             JSchemaType.TFHE_BOOL)
    assert [w["type"] for w in port_wire] == ["MAP", "REDUCE"]


def test_worker_expands_a_compressed_key_with_seeded_upload(tmp_path):
    """A compressed server key and a seeded upload: the coordinator expands
    the rows at ingest, the worker expands the key as the coordinator
    would, and the map decrypts."""
    p = PARAM_SETS["toy"]
    rng = np.random.default_rng(8)
    ck, csk = ref.keygen_seeded(p, rng, 31)
    bodies, seed = client.encrypt_rows_seeded(ck, IN_COLS, TABLE, rng)
    data = rowcodec.frame_rows([row.tobytes() for row in bodies])
    srv = start_worker(make_server, tmp_path, device="cpu")
    coord = port_coordinator(tmp_path, srv.server_address[1])
    try:
        job, frames = run(coord, *upload(
            coord, tcoord.serialize_server_key_compressed(csk), data,
            seeded_seed=seed))
        assert job.status == JobStatus.COMPLETED, job.message
        assert decrypt(ck, frames["out"]) == [a ^ b for a, b in TABLE]
    finally:
        coord.shutdown()
        srv.shutdown()


def test_worker_follows_a_replaced_key(tmp_path):
    """A session's key removed and uploaded anew: the worker builds the new
    key and its circuits instead of bootstrapping with the old, and the
    second job decrypts under the new client key."""
    ck_a, key_a, data_a = inputs()
    rng = np.random.default_rng(77)
    ck_b, sk_b = ref.keygen(PARAM_SETS["toy"], rng)
    table_b = [(a, 255 - b) for a, b in TABLE]
    data_b = rowcodec.frame_rows(frame_codec.rows_to_payloads(
        client.encrypt_rows(ck_b, IN_COLS, table_b, rng)))
    srv = start_worker(make_server, tmp_path, device="cpu")
    coord = port_coordinator(tmp_path, srv.server_address[1])
    try:
        token, session, frame = upload(coord, key_a, data_a, partitions=1)
        job, frames = run(coord, token, session, frame)
        assert job.status == JobStatus.COMPLETED, job.message
        assert decrypt(ck_a, frames["out"]) == [a ^ b for a, b in TABLE]
        coord.remove_key(token, session, SchemaType.TFHE_BOOL)
        _, _, frame = upload(coord, tcoord.serialize_server_key(sk_b),
                             data_b, partitions=1, token=token,
                             session=session)
        job, frames = run(coord, token, session, frame)
        assert job.status == JobStatus.COMPLETED, job.message
        assert decrypt(ck_b, frames["out"]) == [a ^ b for a, b in table_b]
    finally:
        coord.shutdown()
        srv.shutdown()


def test_worker_key_cache_is_bounded(tmp_path, monkeypatch):
    """The worker keeps at most ``MAX_SESSIONS`` keys, least recently used
    out first, drops a key whose file has gone, and fails a task whose key
    is missing."""
    monkeypatch.setattr(offload_worker, "MAX_SESSIONS", 2)
    _, key_bytes, _ = inputs()
    schema = int(SchemaType.TFHE_BOOL)
    for s in ("s1", "s2", "s3"):
        (tmp_path / "keys" / s).mkdir(parents=True)
        (tmp_path / "keys" / s / f"{schema}.key").write_bytes(key_bytes)
    eng = offload_worker._Engine(str(tmp_path / "storage"),
                                 str(tmp_path / "keys"), "bt",
                                 torch.device("cpu"))
    first = eng._session("s1", schema)
    eng._session("s2", schema)
    assert eng._session("s1", schema) is first  # cached, and now newest
    eng._session("s3", schema)
    assert list(eng._sessions) == [("s1", schema), ("s3", schema)]
    (tmp_path / "keys" / "s3" / f"{schema}.key").unlink()
    assert eng._session("s1", schema) is first
    assert list(eng._sessions) == [("s1", schema)]
    with pytest.raises(FileNotFoundError):
        eng._session("s3", schema)


def test_worker_reports_launch_counts(tmp_path):
    """GET /counts answers every kernel's launches in the worker's process,
    by the names of ``ops.kernels.wrappers``; a task on the CPU runs the
    plain versions and launches nothing."""
    _, key_bytes, data = inputs()
    srv = start_worker(make_server, tmp_path, device="cpu")
    coord = port_coordinator(tmp_path, srv.server_address[1])
    url = f"http://127.0.0.1:{srv.server_address[1]}/counts"
    try:
        job, _ = run(coord, *upload(coord, key_bytes, data, partitions=1))
        assert job.status == JobStatus.COMPLETED, job.message
        with urllib.request.urlopen(url, timeout=10) as r:
            counts = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "x", timeout=10)
    finally:
        coord.shutdown()
        srv.shutdown()
    assert counts == kernels.launch_counts()
    assert set(counts) == set(kernels.wrappers()) and "mega13" in counts
    assert all(isinstance(n, int) for n in counts.values())


def test_lambda_with_glwe_inputs_fails_as_jax(tmp_path):
    """``workers.lambda`` with ``workers.mesh.glwe_inputs``: both packages
    pack the upload at ingest (the session has a packing key), and their
    workers read partitions as rows, so every attempt at the first map
    task fails and the job fails after its retries."""
    ck, key_bytes, data = inputs()
    pk_bytes = jcoord.serialize_packing_key(
        jref.make_packing_key(ck, np.random.default_rng(5)))
    results = {}
    for name, make, coordinator, mesh, kw in (
            ("jax", jmake_server, jax_coordinator,
             JMeshConfig(glwe_inputs=True), {"engine": "conv_i8"}),
            ("port", make_server, port_coordinator,
             MeshWorkersConfig(glwe_inputs=True), {"device": "cpu"})):
        tmp = tmp_path / name
        srv = start_worker(make, tmp, **kw)
        coord = coordinator(tmp, srv.server_address[1], mesh_workers=mesh)
        try:
            token = coord.authorize_connection("admin==true")
            session = coord.create_session(token, "s").uuid
            coord.add_key(token, session, SchemaType.TFHE_PACKING,
                          len(pk_bytes), [pk_bytes])
            token, session, frame = upload(coord, key_bytes, data,
                                           token=token, session=session)
            packed = coord.storage.get_data_frame(session, frame).glwe_packed
            job, _ = run(coord, token, session, frame)
            results[name] = (packed, job.status, job.retries,
                             "failed after 3 attempts" in job.message)
        finally:
            coord.shutdown()
            srv.shutdown()
    assert results["port"] == results["jax"] == (True, JobStatus.FAILED, 1,
                                                 True)
