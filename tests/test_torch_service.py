"""The port's coordinator job path against the JAX package, on the CPU.

A map -> reduce plan (tests/test_e2e.py's) runs through the JAX
``Coordinator(engine="conv_i8")`` and the port's ``Coordinator(device=
"cpu")`` on engines ``bt`` and ``bt_fused``, on the same key bytes,
uploaded frames and plan JSON: the output and intermediate partitions are
byte-identical and decrypt to the plaintext oracle.  Also here: the other
reduce policies, plan JSON, job listing, catalogued intermediate frames,
upload cleanup, the options the port refuses and the GLWE, seeded and
compressed-key options it serves, config engine names, and the
pure-Python PASETO v2.local against the JAX package's and RFC 8439.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.service import coordinator as jcoord
from herdsman_tpu.service import paseto as jpaseto
from herdsman_tpu.service.auth import AuthService as JAuthService
from herdsman_tpu.service.config import Config as JConfig
from herdsman_tpu.service.config import SecurityConfig as JSecurityConfig
from herdsman_tpu.service.config import ServerConfig as JServerConfig
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
from herdsman_tpu_torch.service import paseto
from herdsman_tpu_torch.service.auth import AuthService
from herdsman_tpu_torch.service.config import (
    Config,
    ConfigError,
    GrpcWorkersConfig,
    LambdaWorkersConfig,
    LoggingConfig,
    MeshWorkersConfig,
    SecurityConfig,
    ServerConfig,
    load_config,
    port_engine,
)
from herdsman_tpu_torch.service.coordinator import Coordinator
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.ops.server_key import device_server_key
from herdsman_tpu_torch.utils import rowcodec

ROOT = pathlib.Path(__file__).resolve().parent.parent
IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MID_COLS = (ColumnMeta("x", DataType.UINT8), ColumnMeta("odd", DataType.BIT))
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4), (128, 1), (9, 9), (0, 77)]
PARTITIONS = 3


def build_plan(frame_uuid: str, policy: Policy) -> ExecutionPlan:
    """Input -> Mapper (x = a XOR b, odd = parity(x)) -> Reduce (bitwise
    XOR, 2 per node) -> Output, as tests/test_e2e.py builds it."""
    mb = CircuitBuilder(IN_COLS)
    x = mb.input_column("a") ^ mb.input_column("b")
    parity = x.bits[0]
    for bit in x.bits[1:]:
        parity = parity ^ bit
    mb.output("x", x)
    mb.output("odd", parity)
    rb = CircuitBuilder(MID_COLS + MID_COLS)
    rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(2))
    rb.output("odd", rb.input_column_at(1).bits[0]
              ^ rb.input_column_at(3).bits[0])
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(mb.build())),
              g.emplace(ReduceStage(rb.build(), policy, per_node_count=2)),
              g.emplace(OutputStage("result"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


def oracle() -> tuple[list[dict], list[dict]]:
    rows = [{"x": a ^ b, "odd": bin(a ^ b).count("1") & 1} for a, b in TABLE]
    out = {"x": 0, "odd": 0}
    for r in rows:
        out = {k: out[k] ^ r[k] for k in out}
    return rows, [out]


@pytest.fixture(scope="module")
def inputs():
    """Keys, the serialized server key and the encrypted upload."""
    rng = np.random.default_rng(99)
    ck, sk = jref.keygen(TOY, rng)
    cts = client.encrypt_rows(ck, IN_COLS, TABLE, rng)
    payloads = frame_codec.rows_to_payloads(cts)
    chunks = [rowcodec.frame_rows(payloads[i:i + 3])
              for i in range(0, len(payloads), 3)]
    return ck, jcoord.serialize_server_key(sk), chunks


def start_session(coord, key_bytes, chunks, name="in", token=None,
                  session=None):
    """authorize -> session -> key in 64 KiB chunks -> streamed row upload;
    works on either package's coordinator (the wire types are the same
    integers and bytes)."""
    if session is None:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "s").uuid
    coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                  [key_bytes[i:i + (1 << 16)]
                   for i in range(0, len(key_bytes), 1 << 16)])
    meta = coord.begin_data_frame_upload(
        token, session, name, SchemaType.TFHE_BOOL, IN_COLS, len(TABLE),
        PARTITIONS)
    for chunk in chunks:
        coord.append_data_frame(token, session, meta.uuid, chunk)
    coord.finish_data_frame_upload(token, session, meta.uuid)
    return token, session, meta.uuid


def run_plan(coord, token, session, frame_uuid, policy, download=True):
    """Schedule the plan as JSON, wait, and download the output and the
    map's intermediate frame."""
    plan = build_plan(frame_uuid, policy).to_json()
    job = coord.schedule_job(token, session, plan)
    job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
    assert job.status == JobStatus.COMPLETED, job.message
    assert job.retries == 0 and job.bootstraps_executed > 0
    if not download:
        return job, None
    (out,) = job.output_frames.values()
    (mid,) = [f.uuid for f in coord.list_data_frames(token, session)
              if f.name.startswith(f"intermediate-{job.job_uuid}-")]
    return job, {name: list(coord.download_data_frame(token, session, u))
                 for name, u in (("out", out), ("mid", mid))}


def decrypt(ck, parts):
    rows = [pl for part in parts for pl in rowcodec.parse_rows(part)]
    cts = frame_codec.payloads_to_rows(rows, 9, TOY)
    return client.decrypt_rows(ck, MID_COLS, cts)


def port_coordinator(tmp_path, engine="bt_fused", **cfg):
    return Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp_path / "keys"),
                            storage_directory=str(tmp_path / "storage")),
        security=SecurityConfig(secret_key="test-secret"), **cfg),
        engine=engine, device="cpu")


@pytest.fixture(scope="module")
def jax_frames(inputs, tmp_path_factory):
    _, key_bytes, chunks = inputs
    d = tmp_path_factory.mktemp("jax")
    coord = jcoord.Coordinator(JConfig(
        server=JServerConfig(key_directory=str(d / "keys"),
                             storage_directory=str(d / "storage")),
        security=JSecurityConfig(secret_key="test-secret")), engine="conv_i8")
    try:
        token, session, frame = start_session(coord, key_bytes, chunks)
        return run_plan(coord, token, session, frame, Policy.PARALLEL)[1]
    finally:
        coord.shutdown()


@pytest.mark.parametrize("engine", ["bt", "bt_fused"])
def test_parallel_plan_equals_jax_coordinator(inputs, jax_frames, tmp_path,
                                              engine):
    ck, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path, engine=engine)
    try:
        token, session, frame = start_session(coord, key_bytes, chunks)
        job, frames = run_plan(coord, token, session, frame, Policy.PARALLEL)
        assert coord._session_dsk[session][0] == engine
    finally:
        coord.shutdown()
    assert frames == jax_frames  # byte for byte, every partition
    rows, out = oracle()
    assert decrypt(ck, frames["mid"]) == rows
    assert decrypt(ck, frames["out"]) == out


@pytest.mark.parametrize("policy", [Policy.SEQUENCED, Policy.PARALLEL_FULL],
                         ids=lambda q: q.name)
def test_other_policies_on_the_port(inputs, tmp_path, policy):
    ck, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path)
    try:
        token, session, frame = start_session(coord, key_bytes, chunks)
        job, frames = run_plan(coord, token, session, frame, policy)
    finally:
        coord.shutdown()
    rows, out = oracle()
    assert decrypt(ck, frames["mid"]) == rows
    assert decrypt(ck, frames["out"]) == out
    assert job.tasks_executed > 0


def test_plan_json_jobs_and_frames(inputs, tmp_path):
    _, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path)
    try:
        token, session, frame = start_session(coord, key_bytes, chunks)
        plan = build_plan(frame, Policy.PARALLEL)
        assert ExecutionPlan.from_json(plan.to_json()).to_json() \
            == plan.to_json()
        job1, _ = run_plan(coord, token, session, frame, Policy.PARALLEL)
        job2, _ = run_plan(coord, token, session, frame, Policy.SEQUENCED)
        listed = {j.job_uuid: j for j in coord.list_jobs(token, session)}
        assert set(listed) == {job1.job_uuid, job2.job_uuid}
        desc = coord.describe_job(token, session, job1.job_uuid)
        assert desc.status == JobStatus.COMPLETED
        assert desc.output_frames == job1.output_frames
        assert desc.estimated_complexity > 0
        frames = coord.list_data_frames(token, session)
        for job in (job1, job2):
            for prefix in ("intermediate", "reduce"):
                (entry,) = [f for f in frames if f.name.startswith(
                    f"{prefix}-{job.job_uuid}-")]
                assert entry.uploaded and entry.row_count >= 1
        assert [f.name for f in frames].count("result") == 2
        # the first job's planned circuits served the second job's map
        runner = coord._session_runner[session]
        assert len(runner._compiler._circuit_cache) == 2
    finally:
        coord.shutdown()


def test_aborted_and_overrun_uploads_leave_no_frame(inputs, tmp_path):
    _, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path)
    try:
        token, session, _ = start_session(coord, key_bytes, chunks)
        meta = coord.begin_data_frame_upload(
            token, session, "abandoned", SchemaType.TFHE_BOOL, IN_COLS,
            len(TABLE), PARTITIONS)
        coord.append_data_frame(token, session, meta.uuid, chunks[0])
        coord.abandon_data_frame_upload(token, session, meta.uuid)
        coord.abandon_data_frame_upload(token, session, meta.uuid)  # again
        meta = coord.begin_data_frame_upload(
            token, session, "overrun", SchemaType.TFHE_BOOL, IN_COLS, 1, 1)
        with pytest.raises(ValueError):
            coord.append_data_frame(token, session, meta.uuid,
                                    b"".join(chunks))
        names = [f.name for f in coord.list_data_frames(token, session)]
        assert names == ["in"]
    finally:
        coord.shutdown()


UNPORTED_CONFIGS = {
    "grpc_workers": {"grpc_workers": GrpcWorkersConfig(["localhost:1"])},
    "lambda_workers": {"lambda_workers": LambdaWorkersConfig("localhost:1")},
    "mesh_batch_axis": {"mesh_workers": MeshWorkersConfig(batch_axis=2)},
    "mesh_limb_axis": {"mesh_workers": MeshWorkersConfig(limb_axis=2)},
    "profile_dir": {"logging": LoggingConfig(profile_dir="traces")},
}


@pytest.mark.parametrize("option", sorted(UNPORTED_CONFIGS))
def test_unported_config_options_raise(tmp_path, option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_coordinator(tmp_path, **UNPORTED_CONFIGS[option])


@pytest.mark.parametrize("flag", ["glwe_frames", "glwe_outputs",
                                  "glwe_inputs"])
def test_glwe_config_options_are_served(inputs, tmp_path, flag):
    """Each GLWE frame option of ``workers.mesh`` is served: with the
    session's packing key, the frames it names are stored packed (inputs
    at ingest, intermediates and outputs by the job; glwe_outputs alone
    packs the output), and they download packed and decrypt."""
    ck, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path, mesh_workers=MeshWorkersConfig(
        engine="pallas_fused", **{flag: True}))
    try:
        assert getattr(coord.config.mesh_workers, flag)
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "s").uuid
        pk = jref.make_packing_key(ck, np.random.default_rng(5))
        blob = jcoord.serialize_packing_key(pk)
        coord.add_key(token, session, SchemaType.TFHE_PACKING, len(blob),
                      [blob])
        token, session, frame = start_session(coord, key_bytes, chunks,
                                              token=token, session=session)
        entry = coord.storage.get_data_frame(session, frame)
        assert entry.glwe_packed == (flag == "glwe_inputs")
        job, _ = run_plan(coord, token, session, frame, Policy.PARALLEL,
                          download=False)
        frames = {f.name.split("-")[0]: f
                  for f in coord.list_data_frames(token, session)}
        assert frames["intermediate"].glwe_packed == (flag == "glwe_frames")
        assert frames["result"].glwe_packed == (flag == "glwe_outputs")
        rows, out = oracle()
        parts = list(coord.download_data_frame_packed(
            token, session, frames["intermediate"].uuid))
        assert client.decrypt_rows_packed(ck, MID_COLS, parts) == rows
        parts = list(coord.download_data_frame_packed(
            token, session, frames["result"].uuid))
        assert client.decrypt_rows_packed(ck, MID_COLS, parts) == out
    finally:
        coord.shutdown()


def test_seeded_compressed_and_packed_calls_are_served(tmp_path):
    """A compressed server key, a seeded upload and a packed download, each
    refused before the port had them, are served: the compressed key is
    expanded at ingest, the seeded rows are stored expanded and decrypt,
    and the frame downloads packed."""
    coord = port_coordinator(tmp_path)
    try:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "s").uuid
        sck, csk = jref.keygen_seeded(TOY, np.random.default_rng(8), 99)
        blob = jcoord.serialize_server_key_compressed(csk)
        coord.add_key(token, session, SchemaType.TFHE_BOOL, len(blob),
                      [blob])
        bodies, seed = client.encrypt_rows_seeded(
            sck, IN_COLS, TABLE, np.random.default_rng(9))
        meta = coord.begin_data_frame_upload(
            token, session, "seeded", SchemaType.TFHE_BOOL, IN_COLS,
            len(TABLE), PARTITIONS, seeded_seed=seed)
        framed = rowcodec.frame_rows([row.tobytes() for row in bodies])
        for i in range(0, len(framed), 37):
            coord.append_data_frame(token, session, meta.uuid,
                                    framed[i:i + 37])
        coord.finish_data_frame_upload(token, session, meta.uuid)
        rows = [{"a": a, "b": b} for a, b in TABLE]
        parts = list(coord.download_data_frame(token, session, meta.uuid))
        cts = frame_codec.payloads_to_rows(
            [pl for part in parts for pl in rowcodec.parse_rows(part)], 16,
            TOY)
        assert client.decrypt_rows(sck, IN_COLS, cts) == rows
        pk = jref.make_packing_key(sck, np.random.default_rng(10))
        blob = jcoord.serialize_packing_key(pk)
        coord.add_key(token, session, SchemaType.TFHE_PACKING, len(blob),
                      [blob])
        parts = list(coord.download_data_frame_packed(token, session,
                                                      meta.uuid))
        assert client.decrypt_rows_packed(sck, IN_COLS, parts) == rows
        _, dsk = coord._device_key(session)  # the expanded key's
        assert torch.equal(dsk.bsk_bt, device_server_key(
            jref.expand_server_key(csk), layouts=("bsk_bt",),
            device="cpu").bsk_bt)
    finally:
        coord.shutdown()


def test_config_maps_byte_aligned_engines():
    """The byte-aligned and j-major kernels of the JAX package map to the
    port's own."""
    assert {e: port_engine(e) for e in
            ("pallas_mega16", "pallas_mega17", "pallas_mega15", "mega17",
             "pallas_mega11", "pallas_mega8", "pallas_mega7", "mega8")} \
        == {"pallas_mega16": "mega16", "pallas_mega17": "mega17",
            "pallas_mega15": "mega15", "mega17": "mega17",
            "pallas_mega11": "mega11", "pallas_mega8": "mega8",
            "pallas_mega7": "mega7", "mega8": "mega8"}


def test_config_engine_names(tmp_path, monkeypatch):
    monkeypatch.delenv("HERDSMAN_ENGINE", raising=False)
    monkeypatch.delenv("WORKER_TYPE", raising=False)
    assert {e: port_engine(e) for e in
            ("pallas_bt", "pallas_fused", "pallas_mega13", "pallas_mega12",
             "bt_fused", "mega12")} \
        == {"pallas_bt": "bt", "pallas_fused": "bt_fused",
            "pallas_mega13": "mega13", "pallas_mega12": "mega12",
            "bt_fused": "bt_fused", "mega12": "mega12"}
    assert port_engine("conv_i8") == "conv_i8"  # the JAX default engine
    with pytest.raises(ConfigError, match="not ported"):
        port_engine("pallas_mega99")
    assert port_engine("gather_u32") == "gather_u32"  # the JAX config's name
    cfg = load_config(str(ROOT / "template.yaml"))  # loads as it is
    assert cfg.mesh_workers.engine == "bt_fused"
    monkeypatch.setenv("HERDSMAN_ENGINE", "conv_i8")
    assert load_config(str(ROOT / "template.yaml")).mesh_workers.engine \
        == "conv_i8"
    monkeypatch.setenv("HERDSMAN_ENGINE", "pallas_mega99")
    with pytest.raises(ConfigError, match="not ported"):
        load_config(str(ROOT / "template.yaml"))
    for name in ("pallas_mega11", "pallas_mega8", "pallas_mega7",
                 "pallas_mega14", "pallas_mega9", "pallas_mega6",
                 "pallas_mega10", "pallas_mega3", "pallas_mega4",
                 "pallas_mega5", "pallas_mega", "pallas_mega2"):
        monkeypatch.setenv("HERDSMAN_ENGINE", name)
        assert load_config(str(ROOT / "template.yaml")).mesh_workers.engine \
            == name.removeprefix("pallas_")
    monkeypatch.setenv("HERDSMAN_ENGINE", "pallas_bt")
    assert load_config(str(ROOT / "template.yaml")).mesh_workers.engine \
        == "bt"
    # a config built in code keeps the JAX name; the coordinator maps it
    coord = port_coordinator(tmp_path, engine=None,
                             mesh_workers=MeshWorkersConfig())
    assert coord._engine == "bt"
    coord.shutdown()
    coord = port_coordinator(tmp_path / "2", engine=None)
    assert coord._engine == "bt"  # no workers.mesh: bt, not conv_i8
    coord.shutdown()


def test_paseto_tokens_equal_jax_package():
    rng = np.random.default_rng(3)
    key = rng.bytes(32)
    for n in (0, 16, 63, 64, 65, 200):
        msg, nonce_key = rng.bytes(n), rng.bytes(24)
        for footer in (b"", b"herdsman"):
            mine = paseto.encrypt(msg, key, footer, nonce_key=nonce_key)
            theirs = jpaseto.encrypt(msg, key, footer, nonce_key=nonce_key)
            assert mine == theirs
            assert paseto.decrypt(theirs, key, footer) == msg
            assert jpaseto.decrypt(mine, key, footer) == msg
    token = paseto.encrypt(b"payload", key, b"herdsman")
    body = token[len(paseto.HEADER):].split(".")[0]
    i = len(body) // 2
    forged = paseto.HEADER + body[:i] + ("A" if body[i] != "A" else "B") \
        + body[i + 1:] + "." + token.split(".")[-1]
    with pytest.raises(paseto.PasetoError):
        paseto.decrypt(forged, key, b"herdsman")
    with pytest.raises(paseto.PasetoError):
        paseto.decrypt(token, rng.bytes(32), b"herdsman")
    with pytest.raises(paseto.PasetoError):
        paseto.decrypt(token, key, b"other")
    # service tokens validate across the two packages
    assert JAuthService("s").validate_token(
        AuthService("s").authenticate("admin==true")).user_id == 0
    assert AuthService("s").validate_token(
        JAuthService("s").authenticate("admin==true")).user_id == 0


def test_poly1305_rfc8439_vector():
    """RFC 8439 §2.5.2."""
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a8"
                        "0103808afb0db2fd4abff6af4149f51b")
    tag = paseto.poly1305(key, b"Cryptographic Forum Research Group")
    assert tag.hex() == "a8061dc1305136c6c22b8baf0c0127a9"


def test_chacha20_poly1305_equals_cryptography():
    """The pure-Python AEAD (RFC 8439 §2.8) against ``cryptography``'s."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 63, 64, 65, 200):
        key, nonce, aad, msg = (rng.bytes(32), rng.bytes(12),
                                rng.bytes(n % 37), rng.bytes(n))
        ct = paseto.chacha20_xor(key, 1, nonce, msg)
        got = ct + paseto._aead_tag(key, nonce, aad, ct)
        assert got == ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
        assert paseto.chacha20_xor(key, 1, nonce, ct) == msg


def test_port_storage_catalog_matches_jax_dataclass():
    """The catalog entry the two packages persist has the same fields."""
    from herdsman_tpu.service.storage import DataFrameEntry as JEntry
    from herdsman_tpu_torch.service.storage import DataFrameEntry
    assert [f.name for f in dataclasses.fields(DataFrameEntry)] \
        == [f.name for f in dataclasses.fields(JEntry)]
