"""Per-job traces (``logging.profile_dir``, ``utils/tracing.py`` on
``torch.profiler``) on the CPU: a coordinator with a profile directory
writes one parseable trace under ``<profile_dir>/<job_uuid>/`` for a job on
its own runner and for one dispatched to an offload worker, and the job's
frames equal those of an untraced run; ``trace(None)`` and ``trace("")``
do nothing.  The spans such a trace holds: ``test_torch_spans.py``.
"""

import functools
import json
import threading

import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.service import coordinator as jcoord
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
from herdsman_tpu_torch.core import client
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.config import (
    Config,
    LambdaWorkersConfig,
    LoggingConfig,
    SecurityConfig,
    ServerConfig,
)
from herdsman_tpu_torch.service.coordinator import Coordinator
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.service.offload_worker import make_server
from herdsman_tpu_torch.utils import rowcodec, tracing

IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MID_COLS = (ColumnMeta("x", DataType.UINT8),)
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def inputs():
    """(client key, server key bytes, upload bytes)."""
    rng = np.random.default_rng(21)
    ck, sk = jref.keygen(TOY, rng)
    cts = client.encrypt_rows(ck, IN_COLS, TABLE, rng)
    upload = rowcodec.frame_rows(frame_codec.rows_to_payloads(cts))
    return ck, jcoord.serialize_server_key(sk), upload


def plan(frame_uuid):
    """Input -> Mapper (x = a XOR b) -> Reduce (XOR, PARALLEL) -> Output."""
    mb = CircuitBuilder(IN_COLS)
    mb.output("x", mb.input_column("a") ^ mb.input_column("b"))
    rb = CircuitBuilder(MID_COLS + MID_COLS)
    rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(1))
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(mb.build())),
              g.emplace(ReduceStage(rb.build(), Policy.PARALLEL,
                                    per_node_count=2)),
              g.emplace(OutputStage("result"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


def run_job(tmp, offload: bool, profile_dir: str = ""):
    """One job on a CPU coordinator (on its own runner, or dispatched to an
    offload worker on the CPU): (job, its output and intermediate
    frames)."""
    _, key_bytes, data = inputs()
    srv = None
    cfg = {}
    if offload:
        srv = make_server(str(tmp / "storage"), str(tmp / "keys"),
                          device="cpu")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        cfg["lambda_workers"] = LambdaWorkersConfig(
            f"127.0.0.1:{srv.server_address[1]}", 2)
    coord = Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp / "keys"),
                            storage_directory=str(tmp / "storage")),
        security=SecurityConfig(secret_key="test-secret"),
        logging=LoggingConfig(profile_dir=profile_dir), **cfg), device="cpu")
    try:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "s").uuid
        coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                      [key_bytes])
        meta = coord.begin_data_frame_upload(
            token, session, "in", SchemaType.TFHE_BOOL, IN_COLS, len(TABLE),
            2)
        coord.append_data_frame(token, session, meta.uuid, data)
        coord.finish_data_frame_upload(token, session, meta.uuid)
        job = coord.schedule_job(token, session, plan(meta.uuid).to_json())
        job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
        assert job.status == JobStatus.COMPLETED, job.message
        assert job.retries == 0
        (out,) = job.output_frames.values()
        (mid,) = [f.uuid for f in coord.list_data_frames(token, session)
                  if f.name.startswith(f"intermediate-{job.job_uuid}-")]
        frames = {name: list(coord.download_data_frame(token, session, u))
                  for name, u in (("out", out), ("mid", mid))}
        return job, frames
    finally:
        coord.shutdown()
        if srv is not None:
            srv.shutdown()


@pytest.mark.parametrize("offload", [False, True],
                         ids=["own_runner", "offload"])
def test_profile_dir_writes_one_trace_per_job(tmp_path, offload):
    profile_dir = tmp_path / "traces"
    job, frames = run_job(tmp_path / "traced", offload, str(profile_dir))
    _, plain = run_job(tmp_path / "untraced", offload)
    assert frames == plain  # tracing changes no byte of the job's frames
    assert [p.name for p in profile_dir.iterdir()] == [job.job_uuid]
    (trace_file,) = (profile_dir / job.job_uuid).iterdir()
    assert trace_file.name.endswith(".pt.trace.json")
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)  # timed host operators
    ck = inputs()[0]
    rows = frame_codec.payloads_to_rows(
        [pl for part in frames["out"] for pl in rowcodec.parse_rows(part)],
        8, TOY)
    expect = 0
    for a, b in TABLE:
        expect ^= a ^ b
    assert client.decrypt_rows(ck, MID_COLS, rows) == [{"x": expect}]


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_does_nothing(tmp_path, monkeypatch,
                                                log_dir):
    monkeypatch.chdir(tmp_path)
    with tracing.trace(log_dir):  # the default device is not even resolved
        assert not torch.autograd.profiler._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []

