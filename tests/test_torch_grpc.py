"""The port's gRPC surface (``service/api_server.py``, ``client/``) on the CPU,
as tests/test_grpc.py and the server half of tests/test_auth.py hold the
JAX package's:

- the token interceptor, sessions and keys, a full job, an invalid plan,
  an upload overrun, a seeded upload and a packed download, through the
  port's ``HerdClient`` against the port's server on a ``Coordinator(...,
  device="cpu")``;
- connection pinning, a pin surviving eviction pressure, and the client
  over TLS and mutual TLS with ``cryptography`` certificates (CPU only:
  the GPU machines have no ``cryptography``);
- the slice as a whole: the same key, rows and plan through the JAX client
  and server and through the port's give byte-equal output and
  intermediate frames; a JAX ``HerdClient`` completes a job on the port's
  server (the wire is unchanged);
- ``python -m herdsman_tpu_torch.service.api_server CONFIG --device cpu``
  serves a ``HerdClient``.
"""

import datetime
import functools
import os
import pathlib
import re
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest
import torch

from herdsman_tpu import circuit as jcircuit
from herdsman_tpu.client import HerdClient as JHerdClient
from herdsman_tpu.service import coordinator as jcoord
from herdsman_tpu.service.api_server import build_server as jbuild_server
from herdsman_tpu.service.config import Config as JConfig
from herdsman_tpu.service.config import SecurityConfig as JSecurityConfig
from herdsman_tpu.service.config import ServerConfig as JServerConfig
from herdsman_tpu_torch import circuit as tcircuit
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
from herdsman_tpu_torch.client import HerdClient
from herdsman_tpu_torch.core import TOY
from herdsman_tpu_torch.core import client as client_lib
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service import mappers
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb
from herdsman_tpu_torch.service.api_server import _Guard, build_server
from herdsman_tpu_torch.service.config import (Config, SecurityConfig,
                                               ServerConfig, SslConfig)
from herdsman_tpu_torch.service.coordinator import (Coordinator,
                                                    serialize_packing_key,
                                                    serialize_server_key)
from herdsman_tpu_torch.service.errors import InvalidTokenException
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.utils import rowcodec

ROOT = pathlib.Path(__file__).resolve().parent.parent
IN_COLS = (ColumnMeta("a", DataType.UINT8),)
OUT_COLS = (ColumnMeta("r", DataType.UINT8),)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_coordinator(tmp, **security):
    return Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp / "keys"),
                            storage_directory=str(tmp / "st")),
        security=SecurityConfig(secret_key="grpc-secret", **security)),
        device="cpu")


@pytest.fixture(scope="module")
def grpc_stack(tmp_path_factory):
    coord = port_coordinator(tmp_path_factory.mktemp("grpc"))
    server, port = build_server(coord)
    server.start()
    client = HerdClient(f"127.0.0.1:{port}")
    yield coord, client, port
    client.close()
    server.stop(0)
    coord.shutdown()


@pytest.fixture(scope="module")
def authed(grpc_stack):
    _, client, _ = grpc_stack
    client.authorize("admin==true")
    rng = np.random.default_rng(11)
    ck, sk = ref.keygen(TOY, rng)
    session = client.create_session("net")
    client.add_key(session.uuid, SchemaType.TFHE_BOOL,
                   serialize_server_key(sk), chunk_size=1 << 15)
    return client, session, ck, rng


def not_plan(frame_uuid):
    """Input -> Mapper (r = NOT a, bitwise) -> Output."""
    cb = CircuitBuilder(IN_COLS)
    cb.output("r", ~cb.input_column("a"))
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(cb.build())),
              g.emplace(OutputStage("res"))]
    g.add_edge(stages[0], stages[1])
    g.add_edge(stages[1], stages[2])
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


def run_not(client, session, frame_uuid, table, ck):
    job = client.schedule_job(session.uuid, not_plan(frame_uuid))
    st = client.wait_for_job(session.uuid, job.uuid, timeout=120)
    assert st.status == int(JobStatus.COMPLETED), st.message
    assert len(st.output_frames) == 1
    rows = client.download_data_frame(session.uuid, st.output_frames[0], 8,
                                      TOY)
    got = [r["r"] for r in client_lib.decrypt_rows(ck, OUT_COLS, rows)]
    assert got == [(~a) & 0xFF for (a,) in table]
    return job


def test_auth_required(grpc_stack):
    _, client, _ = grpc_stack
    saved = client._token
    client._token = None
    try:
        with pytest.raises(grpc.RpcError) as e:
            client.list_sessions()
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
    finally:
        client._token = saved


def test_bad_credential(grpc_stack):
    _, client, _ = grpc_stack
    with pytest.raises(grpc.RpcError) as e:
        client._call("Auth", "authorize_connection",
                     pb.AuthenticationToken(authentication_token="nope"),
                     pb.ConnectionToken)
    assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED


def test_session_and_keys(authed):
    client, session, _, _ = authed
    assert any(s.uuid == session.uuid for s in client.list_sessions())
    assert client.list_keys(session.uuid) == [SchemaType.TFHE_BOOL]


def test_full_job_over_grpc(authed):
    client, session, ck, rng = authed
    table = [(7,), (200,), (42,), (255,)]
    cts = client_lib.encrypt_rows(ck, IN_COLS, table, rng)
    meta = client.upload_data_frame(
        session.uuid, "tbl", SchemaType.TFHE_BOOL, IN_COLS, cts,
        partitions=2, chunk_rows=2)
    assert meta.rows_count == 4 and meta.partitions == 2
    job = run_not(client, session, meta.uuid, table, ck)
    assert job.estimated_complexity == 0  # NOT gates are linear
    # describe_job round-trips the plan through the port's mappers
    desc = client.describe_job(session.uuid, job.uuid)
    assert desc.plan.SerializeToString(deterministic=True) == \
        mappers.plan_to_proto(not_plan(meta.uuid)).SerializeToString(
            deterministic=True)
    assert [j.uuid for j in client.list_jobs(session.uuid)].count(
        job.uuid) == 1


def test_invalid_plan_rejected(authed):
    client, session, _, _ = authed
    with pytest.raises(grpc.RpcError) as e:
        client._call("Execution", "schedule_job",
                     pb.ScheduleJobRequest(
                         session_uuid=session.uuid,
                         plan=pb.ExecutionPlanProto(schema_type=0)),
                     pb.JobDescription)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_upload_overrun_aborts(authed):
    client, session, ck, rng = authed
    cts = client_lib.encrypt_rows(ck, IN_COLS, [(1,), (2,), (3,)], rng)

    def messages():  # declare 2 rows, send 3
        yield pb.DataFrameAddRequest(info=pb.DataFrameInfo(
            type=0, session_uuid=session.uuid, name="bad", row_count=2,
            partitions=1, columns=mappers.columns_to_proto(IN_COLS)))
        yield pb.DataFrameAddRequest(data=rowcodec.frame_rows(
            frame_codec.rows_to_payloads(np.asarray(cts))))

    fn = client._channel.stream_stream(
        "/herdsman.Storage/add_data_frame",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb.DataFrameAddResponse.FromString)
    with pytest.raises(grpc.RpcError) as e:
        list(fn(messages(), metadata=client._meta()))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    # the aborted frame is gone (reference deletes it on over/under-run)
    assert all(f.name != "bad" for f in client.list_data_frames(session.uuid))


def test_seeded_upload_over_grpc(authed):
    """Compressed upload over the wire: one u32 per bit and a seed; the
    stored frame evaluates as an expanded upload does."""
    client, session, ck, rng = authed
    table = [(7,), (200,), (42,)]
    bodies, seed = client_lib.encrypt_rows_seeded(ck, IN_COLS, table, rng)
    meta = client.upload_data_frame_seeded(
        session.uuid, "tbl-seeded", SchemaType.TFHE_BOOL, IN_COLS, bodies,
        seed, partitions=1, chunk_rows=2)
    assert meta.rows_count == 3
    run_not(client, session, meta.uuid, table, ck)


def test_packed_download_over_grpc(authed):
    client, session, ck, rng = authed
    pk = ref.make_packing_key(ck, rng)
    client.add_key(session.uuid, SchemaType.TFHE_PACKING,
                   serialize_packing_key(pk))
    table = [(9,), (250,)]
    cts = client_lib.encrypt_rows(ck, IN_COLS, table, rng)
    meta = client.upload_data_frame(session.uuid, "tbl-packed",
                                    SchemaType.TFHE_BOOL, IN_COLS, cts,
                                    partitions=1)
    blobs = client.download_data_frame_packed(session.uuid, meta.uuid)
    assert [r["a"] for r in client_lib.decrypt_rows_packed(
        ck, IN_COLS, blobs)] == [9, 250]


# ---- connection pinning and TLS (the server half of test_auth.py) ----


def test_connection_identity_pinning(tmp_path):
    """Same channel, token for a different user -> UNAUTHENTICATED
    (reference token_auth_metadata_processor.cpp:65-74)."""
    coord = port_coordinator(tmp_path)
    server, port = build_server(coord)
    server.start()
    client = HerdClient(f"127.0.0.1:{port}")
    try:
        client.authorize("admin==true")
        client.list_sessions()  # pins user 0 to this connection
        client._token = coord.auth.create_token(user_id=1)  # valid token...
        with pytest.raises(grpc.RpcError) as e:
            client.list_sessions()  # ...but wrong user for this connection
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
        assert "different user" in e.value.details()
    finally:
        client.close()
        server.stop(0)
        coord.shutdown()


class Ctx:
    """The part of a grpc servicer context that ``_Guard.token`` reads."""

    def __init__(self, peer, token, registered=True):
        self._peer, self._token, self._registered = peer, token, registered
        self.callbacks = []

    def peer(self):
        return self._peer

    def invocation_metadata(self):
        return [("authorization", "Bearer " + self._token)]

    def add_callback(self, cb):
        # grpc returns False (and never calls cb) when the rpc already
        # terminated
        if self._registered:
            self.callbacks.append(cb)
        return self._registered


def test_pin_survives_eviction_pressure(tmp_path):
    """A live connection's pin is never evicted under pin-cap pressure;
    an idle one expires after PIN_IDLE_TTL_S; a callback that grpc refused
    to register releases the pin at once."""
    coord = port_coordinator(tmp_path)
    try:
        guard = _Guard(coord)
        guard._max_pins = 8  # small cap so the test is cheap
        tok0 = coord.auth.create_token(user_id=0)
        tok1 = coord.auth.create_token(user_id=1)
        ctx_a = Ctx("ipv4:10.0.0.1:1111", tok0)
        guard.token(ctx_a)  # peer A holds an in-flight rpc
        for i in range(3 * guard._max_pins):  # a crowd churns through
            ctx = Ctx(f"ipv4:10.0.0.2:{2000 + i}", tok0)
            guard.token(ctx)
            for cb in ctx.callbacks:
                cb()
        assert len(guard._pins) <= guard._max_pins
        ctx_a2 = Ctx("ipv4:10.0.0.1:1111", tok1)
        with pytest.raises(InvalidTokenException, match="different user"):
            guard.token(ctx_a2)
        for cb in ctx_a.callbacks:  # A's rpc ends: idle, not expired
            cb()
        with pytest.raises(InvalidTokenException, match="different user"):
            guard.token(ctx_a2)
        pin = guard._pins["ipv4:10.0.0.1:1111"]
        pin.idle_since -= guard.PIN_IDLE_TTL_S + 1
        guard.token(ctx_a2)  # expired: the reused ip:port re-pins fresh
        assert guard._pins["ipv4:10.0.0.1:1111"].user_id == 1
        guard.token(Ctx("ipv4:10.0.0.9:9999", tok0, registered=False))
        assert guard._pins["ipv4:10.0.0.9:9999"].inflight == 0
    finally:
        coord.shutdown()


def _self_signed(hostname: str):
    """(key_pem, cert_pem) via cryptography — test-only CA-less cert."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, hostname)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(hours=1))
        .add_extension(x509.SubjectAlternativeName(
            [x509.DNSName(hostname)]), critical=False)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    return key_pem, cert.public_bytes(serialization.Encoding.PEM)


@pytest.mark.parametrize("mutual", [False, True], ids=["tls", "mutual_tls"])
def test_client_tls_end_to_end(tmp_path, mutual):
    """HerdClient over grpc.ssl_server_credentials (reference
    src/main.cpp:39-57); with a root certificate on the server, only a
    client presenting a certificate it signed gets in."""
    key_pem, cert_pem = _self_signed("herdsman.test")
    (tmp_path / "tls.key").write_bytes(key_pem)
    (tmp_path / "tls.crt").write_bytes(cert_pem)
    client_key, client_cert = _self_signed("client.test")
    (tmp_path / "client-ca.crt").write_bytes(client_cert)
    coord = port_coordinator(tmp_path, ssl=SslConfig(
        certificate_path=str(tmp_path / "tls.crt"),
        key_path=str(tmp_path / "tls.key"),
        root_certificates_path=(str(tmp_path / "client-ca.crt") if mutual
                                else "")))
    server, port = build_server(coord)
    server.start()
    try:
        creds = ({"private_key": client_key, "certificate_chain": client_cert}
                 if mutual else {})
        client = HerdClient(f"127.0.0.1:{port}", root_certificates=cert_pem,
                            ssl_target_name_override="herdsman.test", **creds)
        client.authorize("admin==true")
        s = client.create_session("tls-session")
        assert any(x.name == "tls-session" for x in client.list_sessions())
        client.destroy_session(s.uuid)
        client.close()
        refused = [HerdClient(f"127.0.0.1:{port}")]  # plaintext
        if mutual:  # TLS without a client certificate
            refused.append(HerdClient(
                f"127.0.0.1:{port}", root_certificates=cert_pem,
                ssl_target_name_override="herdsman.test"))
        for bad in refused:
            with pytest.raises(grpc.RpcError):
                bad.authorize("admin==true")
            bad.close()
    finally:
        server.stop(0)
        coord.shutdown()


# ---- the slice as a whole, against the JAX package ----

TABLE = [(3, 5), (200, 100), (255, 255), (17, 4), (128, 1), (9, 64), (0, 77)]
PAIR_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MID_COLS = (ColumnMeta("x", DataType.UINT8), ColumnMeta("odd", DataType.BIT))


def job_plan(pkg, frame_uuid):
    """Input -> Mapper (x = a XOR b, odd = parity(x)) -> Reduce (XOR,
    PARALLEL, 2 a node) -> Output, in package ``pkg``'s circuit model."""
    cols = tuple(pkg.ColumnMeta(c.name, pkg.DataType(c.dtype))
                 for c in PAIR_COLS)
    mid = tuple(pkg.ColumnMeta(c.name, pkg.DataType(c.dtype))
                for c in MID_COLS)
    mb = pkg.CircuitBuilder(cols)
    xv = mb.input_column("a") ^ mb.input_column("b")
    parity = xv.bits[0]
    for bit in xv.bits[1:]:
        parity = parity ^ bit
    mb.output("x", xv)
    mb.output("odd", parity)
    rb = pkg.CircuitBuilder(mid + mid)
    rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(2))
    rb.output("odd", rb.input_column_at(1).bits[0]
              ^ rb.input_column_at(3).bits[0])
    g = pkg.DAG()
    stages = [g.emplace(pkg.InputStage(frame_uuid)),
              g.emplace(pkg.MapperStage(mb.build())),
              g.emplace(pkg.ReduceStage(rb.build(), pkg.Policy.PARALLEL, 2)),
              g.emplace(pkg.OutputStage("result"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return pkg.ExecutionPlan(pkg.SchemaType.TFHE_BOOL, g)


@functools.cache
def inputs():
    """(client key, server key bytes, row ciphertexts), which every job of
    this part uploads as they are."""
    rng = np.random.default_rng(1234)
    ck, sk = ref.keygen(TOY, rng)
    return ck, serialize_server_key(sk), client_lib.encrypt_rows(
        ck, PAIR_COLS, TABLE, rng)


def job_through(client, pkg):
    """Key, rows (3 partitions) and ``job_plan`` through ``client`` (a
    HerdClient of either package); the downloaded output and intermediate
    frames as rows."""
    ck, key_bytes, cts = inputs()
    client.authorize("admin==true")
    session = client.create_session("slice").uuid
    client.add_key(session, pkg.SchemaType.TFHE_BOOL, key_bytes,
                   chunk_size=1 << 16)
    cols = tuple(pkg.ColumnMeta(c.name, pkg.DataType(c.dtype))
                 for c in PAIR_COLS)
    meta = client.upload_data_frame(session, "in", pkg.SchemaType.TFHE_BOOL,
                                    cols, cts, partitions=3, chunk_rows=2)
    job = client.schedule_job(session, job_plan(pkg, meta.uuid))
    st = client.wait_for_job(session, job.uuid, timeout=300)
    assert st.status == int(JobStatus.COMPLETED), st.message
    (mid,) = [f.uuid for f in client.list_data_frames(session)
              if f.name.startswith(f"intermediate-{job.uuid}-")]
    return {name: client.download_data_frame(session, uuid, 9, TOY)
            for name, uuid in (("out", st.output_frames[0]), ("mid", mid))}


def decrypted(frames):
    ck, _, _ = inputs()
    xs = [a ^ b for a, b in TABLE]
    rows = [{"x": x, "odd": bin(x).count("1") & 1} for x in xs]
    out = {"x": 0, "odd": 0}
    for r in rows:
        out = {k: out[k] ^ r[k] for k in out}
    assert client_lib.decrypt_rows(ck, MID_COLS, frames["mid"]) == rows
    assert client_lib.decrypt_rows(ck, MID_COLS, frames["out"]) == [out]


@functools.cache
def jax_frames():
    """The frames of ``job_plan`` through the JAX client and server, its
    coordinator on conv_i8."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        coord = jcoord.Coordinator(JConfig(
            server=JServerConfig(key_directory=d + "/keys",
                                 storage_directory=d + "/st"),
            security=JSecurityConfig(secret_key="grpc-secret")),
            engine="conv_i8")
        server, port = jbuild_server(coord)
        server.start()
        client = JHerdClient(f"127.0.0.1:{port}")
        try:
            return job_through(client, jcircuit)
        finally:
            client.close()
            server.stop(0)
            coord.shutdown()


def test_grpc_job_frames_equal_jax(tmp_path):
    """The same key, rows and plan through the port's client and server
    (bt, the port's default) and through the JAX package's (conv_i8):
    byte-equal output and intermediate frames, which decrypt."""
    coord = port_coordinator(tmp_path)
    server, port = build_server(coord)
    server.start()
    client = HerdClient(f"127.0.0.1:{port}")
    try:
        frames = job_through(client, tcircuit)
    finally:
        client.close()
        server.stop(0)
        coord.shutdown()
    theirs = jax_frames()
    for name in ("out", "mid"):
        assert frame_codec.rows_to_payloads(frames[name]) == \
            frame_codec.rows_to_payloads(theirs[name])
    decrypted(frames)


def test_jax_client_drives_port_server(grpc_stack):
    """The JAX package's HerdClient (its mappers, its proto module) runs a
    whole job on the port's server: the wire is unchanged."""
    _, _, port = grpc_stack
    client = JHerdClient(f"127.0.0.1:{port}")
    try:
        frames = job_through(client, jcircuit)
    finally:
        client.close()
    decrypted(frames)



def test_api_server_cli_serves_herd_client(tmp_path):
    """``python -m herdsman_tpu_torch.service.api_server CONFIG --device
    cpu`` on a YAML config serves a HerdClient."""
    cfg = tmp_path / "herdsman.yaml"
    cfg.write_text(
        "server:\n  hostname: 127.0.0.1\n  port: 0\n"
        f"  key_directory: {tmp_path / 'keys'}\n"
        f"  storage_directory: {tmp_path / 'st'}\n"
        "security:\n  secret_key: cli-secret\n")
    log_path = tmp_path / "server.log"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "herdsman_tpu_torch.service.api_server",
             str(cfg), "--device", "cpu"],
            cwd=tmp_path, env=env, stdout=log_f, stderr=subprocess.STDOUT)
    try:
        t0 = time.monotonic()
        while not (found := re.search(r"herdsman listening on port (\d+)",
                                      log_path.read_text())):
            assert proc.poll() is None and time.monotonic() - t0 < 120, \
                log_path.read_text()
            time.sleep(0.1)
        client = HerdClient(f"127.0.0.1:{found.group(1)}")
        client.authorize("admin==true")
        session = client.create_session("cli")
        _, key_bytes, _ = inputs()
        client.add_key(session.uuid, SchemaType.TFHE_BOOL, key_bytes)
        assert client.list_keys(session.uuid) == [SchemaType.TFHE_BOOL]
        client.close()
    finally:
        proc.terminate()
        proc.wait(30)
