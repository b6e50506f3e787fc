"""The port's seeded keys and uploads against the JAX package's, on the CPU:
``keygen_seeded``, ``expand_server_key``, the raw Philox stream and
``seeded_mask`` at an offset, ``expand_seeded`` and the seeded encryptions,
the compressed-key and packing-key wire bytes both ways, and the
coordinator's ingest of a compressed server key and of a seeded upload
streamed in odd-sized chunks: the stored partitions and a job's output
byte-equal to the JAX coordinator's.
"""

import dataclasses as dc
import functools

import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY
from herdsman_tpu.core import client as jclient
from herdsman_tpu.core import reference as jref
from herdsman_tpu.service import coordinator as jcoord
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
    SchemaType,
)
from herdsman_tpu_torch.core import PARAM_SETS, client
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.service import coordinator as tcoord
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.config import (
    Config,
    SecurityConfig,
    ServerConfig,
)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.utils import rowcodec

TOY_K2 = dc.replace(TOY, name="toy_k2", n=8, k=2)
GEOMETRIES = {"toy": TOY, "toy_k2": TOY_K2}
IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MID_COLS = (ColumnMeta("x", DataType.UINT8), ColumnMeta("odd", DataType.BIT))
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4), (128, 1), (9, 64)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port(p):
    return dc.replace(PARAM_SETS["toy"], **dc.asdict(p))


@functools.cache
def seeded_keys(name, package):
    """keygen_seeded of a geometry by either package, rng 5 and seed 77."""
    p = GEOMETRIES[name]
    if package == "jax":
        return jref.keygen_seeded(p, np.random.default_rng(5), 77)
    return ref.keygen_seeded(port(p), np.random.default_rng(5), 77)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_keygen_seeded_and_expand_equal_jax(name):
    (jck, jcsk), (tck, tcsk) = (seeded_keys(name, "jax"),
                                seeded_keys(name, "port"))
    for field in ("lwe_key", "glwe_key"):
        np.testing.assert_array_equal(getattr(tck, field), getattr(jck, field))
    assert tcsk.seed == jcsk.seed == 77
    np.testing.assert_array_equal(tcsk.bsk_bodies, jcsk.bsk_bodies)
    np.testing.assert_array_equal(tcsk.ksk_bodies, jcsk.ksk_bodies)
    tsk, jsk = ref.expand_server_key(tcsk), jref.expand_server_key(jcsk)
    np.testing.assert_array_equal(tsk.bsk, jsk.bsk)
    np.testing.assert_array_equal(tsk.ksk, jsk.ksk)
    # the expanded key bootstraps: a fresh bit survives a sign bootstrap
    rng = np.random.default_rng(6)
    bits = np.array([True, False])
    ct = ref.encrypt_bool(tck, bits, rng)
    out = np.stack([ref.bootstrap_bool(tsk, c) for c in ct])
    np.testing.assert_array_equal(ref.lwe_decrypt_bool(tck, out), bits)


@pytest.mark.parametrize("offset", [0, 3, 5, 8])
def test_philox_stream_and_seeded_mask_at_offset_equal_jax(offset):
    """The raw Philox words and the masks from row ``offset`` on (an O(1)
    counter advance, 4 words a block, so odd offsets start mid-block),
    equal to the JAX package's and to the stream from row 0."""
    p = port(TOY)
    seed = (1 << 63) + 12345
    np.testing.assert_array_equal(ref._philox_u32(seed, 40, 2 * offset),
                                  jref._philox_u32(seed, 40, 2 * offset))
    whole = ref.seeded_mask(p, seed, 12)
    np.testing.assert_array_equal(whole, jref.seeded_mask(TOY, seed, 12))
    got = ref.seeded_mask(p, seed, 12 - offset, offset)
    np.testing.assert_array_equal(got, jref.seeded_mask(TOY, seed,
                                                        12 - offset, offset))
    np.testing.assert_array_equal(got, whole[offset:])


def test_seeded_encryption_and_expand_equal_jax():
    jck, _ = seeded_keys("toy", "jax")
    tck, _ = seeded_keys("toy", "port")
    bits = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    jb = jref.encrypt_bool_seeded(jck, bits, 9, np.random.default_rng(3), 2)
    tb = ref.encrypt_bool_seeded(tck, bits, 9, np.random.default_rng(3), 2)
    np.testing.assert_array_equal(tb, jb)
    cts = ref.expand_seeded(port(TOY), 9, tb, offset=2)
    np.testing.assert_array_equal(cts, jref.expand_seeded(TOY, 9, jb, 2))
    np.testing.assert_array_equal(ref.lwe_decrypt_bool(tck, cts), bits)
    mu = np.array([5, 1 << 30], np.uint32)
    np.testing.assert_array_equal(
        ref.lwe_encrypt_seeded(tck, mu, 4, np.random.default_rng(1)),
        jref.lwe_encrypt_seeded(jck, mu, 4, np.random.default_rng(1)))


def test_encrypt_rows_seeded_equals_jax():
    jck, _ = seeded_keys("toy", "jax")
    tck, _ = seeded_keys("toy", "port")
    jb, jseed = jclient.encrypt_rows_seeded(jck, IN_COLS, TABLE,
                                            np.random.default_rng(2), seed=8)
    tb, tseed = client.encrypt_rows_seeded(tck, IN_COLS, TABLE,
                                           np.random.default_rng(2), seed=8)
    assert tseed == jseed == 8 and tb.shape == (len(TABLE), 16)
    np.testing.assert_array_equal(tb, jb)
    cts = ref.expand_seeded(port(TOY), 8, tb).reshape(len(TABLE), 16, -1)
    assert client.decrypt_rows(tck, IN_COLS, cts) \
        == [{"a": a, "b": b} for a, b in TABLE]
    seeds = {client.encrypt_rows_seeded(tck, IN_COLS, TABLE[:1],
                                        np.random.default_rng(2))[1]
             for _ in range(4)}
    assert len(seeds) == 4  # a fresh CSPRNG seed per call


def test_wire_bytes_both_ways():
    """Compressed server keys and packing keys written by either package
    load in the other, array-equal; the params read without the arrays."""
    jck, jcsk = seeded_keys("toy", "jax")
    _, tcsk = seeded_keys("toy", "port")
    for blob in (jcoord.serialize_server_key_compressed(jcsk),
                 tcoord.serialize_server_key_compressed(tcsk)):
        for load in (jcoord.deserialize_server_key,
                     tcoord.deserialize_server_key):
            sk = load(blob)
            assert sk.params.name == "toy"
            np.testing.assert_array_equal(
                sk.bsk, jref.expand_server_key(jcsk).bsk)
            np.testing.assert_array_equal(
                sk.ksk, jref.expand_server_key(jcsk).ksk)
        assert tcoord.key_params_from_bytes(blob) == PARAM_SETS["toy"]
    pk = jref.make_packing_key(jck, np.random.default_rng(4))
    tpk = ref.PackingKey(PARAM_SETS["toy"], pk.pksk)
    for blob in (jcoord.serialize_packing_key(pk),
                 tcoord.serialize_packing_key(tpk)):
        for load in (jcoord.deserialize_packing_key,
                     tcoord.deserialize_packing_key):
            got = load(blob)
            assert got.params.name == "toy"
            np.testing.assert_array_equal(got.pksk, pk.pksk)
    full = jref.expand_server_key(jcsk)
    got = tcoord.deserialize_server_key(jcoord.serialize_server_key(full))
    np.testing.assert_array_equal(got.bsk, full.bsk)


# ---- the coordinator's seeded ingest, against the JAX coordinator ----

def map_plan(frame_uuid):
    """Input -> Mapper (x = a XOR b, odd = parity(x)) -> Output."""
    cb = CircuitBuilder(IN_COLS)
    x = cb.input_column("a") ^ cb.input_column("b")
    parity = x.bits[0]
    for bit in x.bits[1:]:
        parity = parity ^ bit
    cb.output("x", x)
    cb.output("odd", parity)
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(cb.build())),
              g.emplace(OutputStage("seeded-result"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


@pytest.fixture(scope="module")
def seeded_wire():
    """The compressed key's bytes, the client key and a seeded upload."""
    ck, csk = seeded_keys("toy", "jax")
    bodies, seed = jclient.encrypt_rows_seeded(
        ck, IN_COLS, TABLE, np.random.default_rng(12), seed=1234567)
    framed = rowcodec.frame_rows([row.tobytes() for row in bodies])
    return ck, jcoord.serialize_server_key_compressed(csk), seed, framed


def seeded_session(coord, wire, cuts):
    """Compressed key in odd-sized chunks, then the seeded upload cut at
    ``cuts`` (mid-header, mid-row), then a map job: the frame's
    partitions, the output's, and the coordinator's session handles."""
    _, key_bytes, seed, framed = wire
    token = coord.authorize_connection("admin==true")
    session = coord.create_session(token, "seeded").uuid
    coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                  [key_bytes[i:i + 1001]
                   for i in range(0, len(key_bytes), 1001)])
    meta = coord.begin_data_frame_upload(
        token, session, "seeded-in", SchemaType.TFHE_BOOL, IN_COLS,
        len(TABLE), 4, seeded_seed=seed)
    assert meta.uuid in coord._seeded_uploads
    for a, b in zip(cuts, cuts[1:]):
        coord.append_data_frame(token, session, meta.uuid, framed[a:b])
    coord.finish_data_frame_upload(token, session, meta.uuid)
    assert meta.uuid not in coord._seeded_uploads
    job = coord.schedule_job(token, session, map_plan(meta.uuid).to_json())
    job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
    assert job.status == JobStatus.COMPLETED and job.retries == 0, job.message
    (out,) = job.output_frames.values()
    return ([list(coord.download_data_frame(token, session, u))
             for u in (meta.uuid, out)], token, session)


def test_seeded_upload_and_compressed_key_equal_jax(seeded_wire, tmp_path):
    ck, _, _, framed = seeded_wire
    cuts = [0, 3, 70, 71, 200, 333, len(framed)]
    results = []
    for d, make in ((tmp_path / "jax", lambda c: jcoord.Coordinator(
            JConfig(server=JServerConfig(key_directory=str(c / "keys"),
                                         storage_directory=str(c / "st")),
                    security=JSecurityConfig(secret_key="seeded")),
            engine="conv_i8")),
                    (tmp_path / "port", lambda c: tcoord.Coordinator(
            Config(server=ServerConfig(key_directory=str(c / "keys"),
                                       storage_directory=str(c / "st")),
                   security=SecurityConfig(secret_key="seeded")),
            engine="conv_i8", device="cpu"))):
        coord = make(d)
        try:
            results.append(seeded_session(coord, seeded_wire, cuts)[0])
        finally:
            coord.shutdown()
    assert results[1] == results[0]  # every partition, byte for byte
    (in_parts, out_parts) = results[1]
    toy = PARAM_SETS["toy"]

    def decrypt(parts, cols):
        return client.decrypt_rows(ck, cols, frame_codec.payloads_to_rows(
            [pl for part in parts for pl in rowcodec.parse_rows(part)],
            sum(c.dtype.bit_width for c in cols), toy))

    assert decrypt(in_parts, IN_COLS) == [{"a": a, "b": b} for a, b in TABLE]
    assert decrypt(out_parts, MID_COLS) == [
        {"x": a ^ b, "odd": bin(a ^ b).count("1") & 1} for a, b in TABLE]


def test_seeded_upload_refusals_and_cleanup(seeded_wire, tmp_path):
    """A seeded upload that ends mid-row is refused and its frame deleted;
    a payload of the wrong size is refused; abandoning or removing a frame
    drops its expansion state."""
    _, key_bytes, seed, framed = seeded_wire
    coord = tcoord.Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp_path / "keys"),
                            storage_directory=str(tmp_path / "st")),
        security=SecurityConfig(secret_key="seeded")), device="cpu")
    try:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "s").uuid
        coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                      [key_bytes])

        def begin(name):
            return coord.begin_data_frame_upload(
                token, session, name, SchemaType.TFHE_BOOL, IN_COLS,
                len(TABLE), 2, seeded_seed=seed).uuid

        frame = begin("short")
        coord.append_data_frame(token, session, frame, framed[:-2])
        with pytest.raises(ValueError, match="mid-row"):
            coord.finish_data_frame_upload(token, session, frame)
        frame = begin("wrong size")
        with pytest.raises(ValueError, match="one u32 body per bit"):
            coord.append_data_frame(token, session, frame,
                                    rowcodec.frame_rows([b"\0" * 12]))
        assert frame not in coord._seeded_uploads
        frame = begin("abandoned")
        coord.append_data_frame(token, session, frame, framed[:50])
        coord.abandon_data_frame_upload(token, session, frame)
        assert frame not in coord._seeded_uploads
        frame = begin("removed")
        coord.remove_data_frame(token, session, frame)
        assert not coord._seeded_uploads
        assert coord.list_data_frames(token, session) == []
    finally:
        coord.shutdown()
