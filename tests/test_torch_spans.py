"""The port's spans and counters (``utils/tracing.py``) on the CPU at TOY.

- A job through a CPU ``Coordinator`` records its queue wait, frame load,
  compile+exec and store, in that order and without overlap, the runner's
  three on its executor thread; the ``job %s phases`` log record carries
  the recorder's numbers.
- The job has one ``bootstrap.rotation`` span per level of its compiled
  circuit, as many as calls to ``blind_rotate_batch``, and a key switch a
  level.
- Two executor slots keep each job's spans under its own uuid.
- Each session's key ingest is one ``coordinator.add_key`` and one
  ``coordinator.device_key`` span.
- The ring and the job accounts are bounded, and what they push out is
  counted in ``tracing.dropped``.
- A device span's CUDA events are placed on the unix clock by ``settle``
  (fake events stand in for the card's).
- ``logging.profile_dir``'s per-job trace holds the spans by name, on
  ``pallas_fused`` also each rotation's ``bootstrap.step_issue``.
- ``utils/tracing.py`` waits for the device nowhere but at the one
  reference event of ``settle``.
"""

import ast
import functools
import json
import logging
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from herdsman_tpu_torch.circuit import (
    DAG,
    CircuitBuilder,
    ColumnMeta,
    DataType,
    ExecutionPlan,
    InputStage,
    MapperStage,
    OutputStage,
    SchemaType,
)
from herdsman_tpu_torch.compiler.lower import levelize
from herdsman_tpu_torch.compiler.optimizer import optimize_circuit
from herdsman_tpu_torch.core import TOY, client
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.config import (
    Config,
    LoggingConfig,
    MeshWorkersConfig,
    SecurityConfig,
    ServerConfig,
)
from herdsman_tpu_torch.service.coordinator import (Coordinator,
                                                    serialize_server_key)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.utils import rowcodec, tracing

COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4)]
RUNNER = ("runner.load", "runner.exec", "runner.store")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors under parallel test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def keys_and_rows():
    """(server key bytes, upload bytes)."""
    rng = np.random.default_rng(27)
    ck, sk = ref.keygen(TOY, rng)
    cts = client.encrypt_rows(ck, COLS, TABLE, rng)
    return (serialize_server_key(sk),
            rowcodec.frame_rows(frame_codec.rows_to_payloads(cts)))


def circuit():
    """s = (a + b) & (a ^ b): a few levels of gates."""
    cb = CircuitBuilder(COLS)
    a, b = cb.input_column("a"), cb.input_column("b")
    cb.output("s", (a + b) & (a ^ b))
    return cb.build()


def coordinator(tmp, slots=1, profile_dir="", engine="pallas_mega13"):
    return Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp / "keys"),
                            storage_directory=str(tmp / "storage")),
        security=SecurityConfig(secret_key="test-secret"),
        logging=LoggingConfig(profile_dir=profile_dir),
        mesh_workers=MeshWorkersConfig(engine=engine,
                                       concurrent_jobs=slots)),
        device="cpu")


def session(coord, token, name="s"):
    """A session with the server key and a frame: (session, plan json)."""
    key_bytes, data = keys_and_rows()
    sess = coord.create_session(token, name).uuid
    coord.add_key(token, sess, SchemaType.TFHE_BOOL, len(key_bytes),
                  [key_bytes])
    meta = coord.begin_data_frame_upload(token, sess, "in",
                                         SchemaType.TFHE_BOOL, COLS,
                                         len(TABLE), 2)
    coord.append_data_frame(token, sess, meta.uuid, data)
    coord.finish_data_frame_upload(token, sess, meta.uuid)
    g = DAG()
    st = [g.emplace(InputStage(meta.uuid)),
          g.emplace(MapperStage(circuit())),
          g.emplace(OutputStage("out"))]
    g.add_edge(st[0], st[1])
    g.add_edge(st[1], st[2])
    return sess, ExecutionPlan(SchemaType.TFHE_BOOL, g).to_json()


def finish(coord, token, sess, job_uuid):
    job = coord.wait_for_job(token, sess, job_uuid, timeout=600)
    assert job.status == JobStatus.COMPLETED, job.message
    return job


class PhaseRecords(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.args = {}

    def emit(self, record):
        if str(record.msg).startswith("job %s phases"):
            self.args[record.args[0]] = record.args[1:]


@pytest.fixture(scope="module")
def one_job(tmp_path_factory):
    """One job on a CPU coordinator: (job, its raw spans, the phase log's
    arguments, calls to blind_rotate_batch, the levels of its compiled
    circuit)."""
    tmp = tmp_path_factory.mktemp("one")
    records = PhaseRecords()
    runner_log = logging.getLogger("herdsman.runner")
    level = runner_log.level
    runner_log.setLevel(logging.DEBUG)
    runner_log.addHandler(records)
    calls = []
    orig = bs.blind_rotate_batch

    def counted(dsk, ct, *a, **kw):
        calls.append(int(ct.shape[0]))
        return orig(dsk, ct, *a, **kw)
    since = time.time()
    coord = coordinator(tmp)
    try:
        bs.blind_rotate_batch = counted
        token = coord.authorize_connection("admin==true")
        sess, plan = session(coord, token)
        job = finish(coord, token, sess,
                     coord.schedule_job(token, sess, plan).job_uuid)
    finally:
        bs.blind_rotate_batch = orig
        coord.shutdown()
        runner_log.removeHandler(records)
        runner_log.setLevel(level)
    levels, _ = levelize(optimize_circuit(circuit()))
    return job, tracing.spans(since), records.args, calls, len(levels)


def test_a_job_has_its_phases_in_order(one_job):
    job, spans, _, _, _ = one_job
    mine = {name: [s for s in spans if s[2] == name and s[4] == job.job_uuid]
            for name in ("execution.queue",) + RUNNER}
    assert all(len(v) == 1 for v in mine.values()), mine
    (q, load, exe, store) = (mine[n][0] for n in mine)
    assert q[0] <= q[1] <= load[0] <= load[1] <= exe[0] <= exe[1] \
        <= store[0] <= store[1]
    # the runner's phases run on the one executor thread
    assert {s[3] for s in (load, exe, store)} == {"herdsman-executor-0"}
    acct = tracing.job(job.job_uuid)
    assert set(acct["phases"]) == {"queue", "load", "exec", "store"}
    assert acct["phases"]["load"] == pytest.approx(load[1] - load[0],
                                                   abs=1e-6)
    # the children of load and store lie inside them
    for parent, kids in ((load, ("runner.load.read", "runner.load.decode",
                                 "runner.load.h2d")),
                         (store, ("runner.store.d2h",
                                  "runner.store.write"))):
        for kid in kids:
            inner = [s for s in spans if s[2] == kid
                     and s[4] == job.job_uuid]
            assert inner and all(parent[0] <= s[0] <= s[1] <= parent[1]
                                 for s in inner), kid


def test_one_rotation_per_level(one_job):
    job, spans, _, calls, levels = one_job
    acct = tracing.job(job.job_uuid)
    assert len(calls) == levels > 1
    assert acct["rotations"] == calls   # the widths, in order
    assert acct["calls"]["bootstrap.rotation"] == levels
    assert acct["calls"]["bootstrap.key_switch"] == levels
    assert acct["calls"]["lower.level"] == levels
    assert acct["counts"]["bootstrap.rotations"] == levels
    assert acct["counts"]["compiler.cache_miss"] == 1
    assert acct["calls"]["compiler.compile"] == 1
    # on a CPU device the device spans are the host spans, so the time
    # between the rotations is what the host did between them
    rot = sorted(s for s in spans if s[2] == "bootstrap.rotation"
                 and s[3] == "cpu")
    assert len(rot) == levels
    assert acct["rotation_ms"] == pytest.approx(
        sum(b - a for a, b, *_ in rot) * 1e3, abs=1e-3)
    assert acct["between_rotations_ms"] == pytest.approx(
        (rot[-1][1] - rot[0][0]) * 1e3 - acct["rotation_ms"], abs=1e-3)
    assert acct["between_rotations_ms"] > 0
    assert acct["key_switch_ms"] > 0


def test_phase_log_carries_the_recorders_numbers(one_job):
    job, _, args, _, _ = one_job
    ph = tracing.job(job.job_uuid)["phases"]
    assert args[job.job_uuid] == (ph["load"], ph["exec"], ph["store"])


def test_key_ingest_is_one_span_of_each_kind_per_session(tmp_path):
    since = time.time()
    coord = coordinator(tmp_path)
    try:
        token = coord.authorize_connection("admin==true")
        sessions = [session(coord, token, f"s{i}") for i in range(2)]
        jobs = []
        for sess, plan in sessions:
            for _ in range(2):   # the second job reuses the device key
                jobs.append(finish(coord, token, sess, coord.schedule_job(
                    token, sess, plan).job_uuid))
    finally:
        coord.shutdown()
    spans = tracing.spans(since)
    for name in ("coordinator.add_key", "coordinator.device_key"):
        assert len([s for s in spans if s[2] == name]) == 2, name
    accts = [tracing.job(j.job_uuid) for j in jobs]
    assert [a["session"] for a in accts] == [s for s, _ in sessions
                                             for _ in range(2)]
    assert all(a["key_ingest_s"] > 0 for a in accts)
    assert accts[0]["key_ingest_s"] == accts[1]["key_ingest_s"]


def test_two_executor_slots_keep_each_jobs_spans(tmp_path):
    coord = coordinator(tmp_path, slots=2)
    try:
        token = coord.authorize_connection("admin==true")
        sessions = [session(coord, token, f"s{i}") for i in range(2)]
        for sess, plan in sessions:   # the device keys, built apart
            finish(coord, token, sess,
                   coord.schedule_job(token, sess, plan).job_uuid)
        since = time.time()
        queued = [(sess, coord.schedule_job(token, sess, plan).job_uuid)
                  for sess, plan in sessions for _ in range(2)]
        uuids = [finish(coord, token, s, u).job_uuid for s, u in queued]
    finally:
        coord.shutdown()
    levels = len(levelize(optimize_circuit(circuit()))[0])
    spans = tracing.spans(since)
    threads = set()
    for u in uuids:
        acct = tracing.job(u)
        assert all(acct["calls"][n] == 1 for n in RUNNER)
        assert len(acct["rotations"]) == levels
        mine = sorted(s for s in spans if s[4] == u and s[2] in RUNNER)
        assert [s[2] for s in mine] == list(RUNNER)
        assert len({s[3] for s in mine}) == 1   # one executor thread
        threads |= {s[3] for s in mine}
        assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    assert threads <= {"herdsman-executor-0", "herdsman-executor-1"}
    # every rotation of the window belongs to one of its jobs
    rot = [s for s in spans if s[2] == "bootstrap.rotation"
           and s[3].startswith("herdsman-executor")]
    assert sorted(s[4] for s in rot) == sorted(u for u in uuids
                                              for _ in range(levels))


def test_ring_and_accounts_are_bounded():
    rec = tracing.Recorder(ring=4, jobs=2)
    for i in range(6):
        with rec.span("s", job=f"j{i // 2}"):
            pass
    assert len(rec.spans()) == 4
    # two spans and one job account pushed out
    assert rec.counters()[tracing.DROPPED] == 3
    assert rec.job("j0") is None
    assert rec.job("j1")["calls"] == {"s": 2}
    rec.count("c", 5, job="j2")
    assert rec.job("j2")["counts"] == {"c": 5}
    assert rec.counters()["c"] == 5


def test_job_scope_and_threads():
    rec = tracing.Recorder()
    with tracing.job_scope("outer"):
        with rec.span("a"):
            pass
        with tracing.job_scope("inner"):
            rec.count("n")
        with rec.span("b", job="other"):
            pass
        span = rec.begin("q", job="crossing")
    t = threading.Thread(target=span.end)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    with rec.span("c"):
        pass
    assert [(s[2], s[4]) for s in rec.spans()] == [
        ("a", "outer"), ("b", "other"), ("q", "crossing"), ("c", None)]
    assert rec.job("inner")["counts"] == {"n": 1}
    assert span.seconds > 0


class FakeEvent:
    """A CUDA event on the host clock: recorded when the host records it,
    complete at once."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def test_settle_places_device_spans_on_the_unix_clock(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: object())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    card = torch.device("cuda", 0)
    rec = tracing.Recorder()
    for B in (8, 4):
        with rec.span("bootstrap.rotation", job="j", device=card, B=B):
            time.sleep(0.002)
        with rec.span("bootstrap.key_switch", job="j", device=card):
            time.sleep(0.001)
    acct = rec.job("j")
    assert acct["rotations"] == [8, 4] and acct["rotation_ms"] == 0.0
    assert len(rec.spans()) == 4   # host spans only, until settled
    rec.settle(card)
    acct = rec.job("j")
    host = [s for s in rec.spans() if s[3] != "cuda:0"]
    dev = [s for s in rec.spans() if s[3] == "cuda:0"]
    assert [s[2] for s in dev] == [s[2] for s in host]
    # the fake events stamp the host clock: the device spans cover the host
    # ones, within the stamps' order
    for h, d in zip(host, dev):
        assert d[0] <= h[0] + 1e-4 and h[1] <= d[1] + 1e-4
        assert d[1] - d[0] == pytest.approx(h[1] - h[0], abs=2e-4)
    rot = [s for s in dev if s[2] == "bootstrap.rotation"]
    assert acct["rotation_ms"] == pytest.approx(
        sum(b - a for a, b, *_ in rot) * 1e3, abs=1e-3)
    assert acct["between_rotations_ms"] == pytest.approx(
        (rot[1][1] - rot[0][0]) * 1e3 - acct["rotation_ms"], abs=1e-3)
    assert acct["key_switch_ms"] >= 2.0
    rec.settle(card)   # nothing left to take
    assert len(rec.spans()) == 8
    # the events, once read, are reused
    with rec.span("bootstrap.rotation", job="j", device=card, B=2):
        pass
    assert len(rec._free[card]) == 3


def profiled_span_names(tmp_path, engine="pallas_mega13"):
    """The names of the complete events in one job's ``profile_dir``
    trace."""
    profile_dir = tmp_path / "traces"
    coord = coordinator(tmp_path, profile_dir=str(profile_dir),
                        engine=engine)
    try:
        token = coord.authorize_connection("admin==true")
        sess, plan = session(coord, token)
        job = finish(coord, token, sess,
                     coord.schedule_job(token, sess, plan).job_uuid)
    finally:
        coord.shutdown()
    (trace_file,) = (profile_dir / job.job_uuid).iterdir()
    return {e.get("name") for e in
            json.loads(trace_file.read_text())["traceEvents"]
            if e.get("ph") == "X"}


def test_profile_dir_trace_holds_the_spans(tmp_path):
    names = profiled_span_names(tmp_path)
    assert {*RUNNER, "runner.load.read", "runner.load.decode",
            "runner.load.h2d", "runner.store.d2h", "runner.store.write",
            "compiler.compile", "lower.level", "bootstrap.rotation",
            "bootstrap.key_switch", "coordinator.device_key"} <= names
    assert tracing.STEP_ISSUE not in names


def test_profile_dir_trace_holds_a_step_engines_issue_span(tmp_path):
    """On ``pallas_fused`` each rotation's step loop is in the trace too,
    beside the rotation."""
    names = profiled_span_names(tmp_path, engine="pallas_fused")
    assert {"bootstrap.rotation", tracing.STEP_ISSUE} <= names


def test_tracing_waits_for_the_device_only_at_the_reference_event():
    """No synchronize, .item(), .cpu(), .tolist() or .numpy() in the
    recorder but the reference event's wait in ``settle``."""
    tree = ast.parse(pathlib.Path(tracing.__file__).read_text())

    def waits(node):
        return [ast.unparse(n.func) for n in ast.walk(node)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("synchronize", "item", "cpu", "tolist",
                                    "numpy")]
    assert waits(tree) == ["ref.synchronize"]
    (settle,) = [fn for fn in ast.walk(tree)
                 if isinstance(fn, ast.FunctionDef) and fn.name == "settle"]
    assert waits(settle) == ["ref.synchronize"]
