"""The port's GLWE packing (``ops/pack.py``, ``core/noise.py``, the packed
frames of the runner and the coordinator) against the JAX package's, on the
CPU.

- ``packing_key_conv``, ``pack_lwes_batch``, ``extract_all_batch`` and
  ``unpack_lwes_batch`` against ``herdsman_tpu.ops.pack`` and
  ``core.reference.pack_lwes``, array equality;
- every function of ``core/noise.py`` on every parameter set;
- the coordinator's GLWE-packed jobs (``workers.mesh.glwe_frames``,
  ``glwe_outputs``, ``glwe_inputs``) and both branches of
  ``download_data_frame_packed``, run as tests/test_e2e.py runs them
  (:295, :391, :495, :607) on the JAX ``Coordinator(engine="conv_i8")`` and
  on the port's: every partition of every frame and every packed download
  byte-equal, and decrypted against the plaintext;
- packing at ingest is all or nothing: a failure on the second partition
  raises and leaves the frame in the row format.
"""

import dataclasses as dc
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import PARAM_SETS as JAX_SETS
from herdsman_tpu.core import TOY
from herdsman_tpu.core import noise as jnoise
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import pack as jpack
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu.service import coordinator as jcoord
from herdsman_tpu.service.config import Config as JConfig
from herdsman_tpu.service.config import MeshWorkersConfig as JMesh
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
    MappingError,
    OutputStage,
    Policy,
    ReduceStage,
    SchemaType,
)
from herdsman_tpu_torch.core import PARAM_SETS, client, noise
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops import pack
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service import coordinator as tcoord
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.config import (
    Config,
    MeshWorkersConfig,
    SecurityConfig,
    ServerConfig,
)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.utils import rowcodec

TOY_K2 = dc.replace(TOY, name="toy_k2", n=8, k=2)
GEOMETRIES = {"toy": TOY, "toy_k2": TOY_K2}


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
def keys(name):
    """(client key, server key, packing key, JAX pkc, port pkc)."""
    p = GEOMETRIES[name]
    rng = np.random.default_rng(21)
    ck, sk = jref.keygen(p, rng)
    pk = jref.make_packing_key(ck, rng)
    tpk = ref.PackingKey(port(p), pk.pksk)
    return (ck, sk, pk, np.asarray(jpack.packing_key_conv(pk)),
            pack.packing_key_conv(tpk, device="cpu"))


@functools.cache
def groups(name):
    """Three groups of fresh bits, the last ragged (M = 40 of N = 64)."""
    ck = keys(name)[0]
    rng = np.random.default_rng(22)
    bits = rng.integers(0, 2, (3, GEOMETRIES[name].N)).astype(bool)
    return bits, jref.encrypt_bool(ck, bits, rng)


@functools.cache
def jax_packed(name, M):
    p = GEOMETRIES[name]
    pkc = keys(name)[3]
    cts = groups(name)[1][:, :M]
    return np.asarray(jpack.pack_lwes_batch(p, jnp.asarray(pkc),
                                            jnp.asarray(cts)))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_packing_key_conv_equals_jax(name):
    p = GEOMETRIES[name]
    _, _, _, jpkc, tpkc = keys(name)
    assert tuple(tpkc.shape) == (p.n * p.ks_levels, (p.k + 1) * 4,
                                 2 * p.N - 1)
    np.testing.assert_array_equal(tpkc.numpy(), jpkc)


@pytest.mark.parametrize("M", [64, 40])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_pack_lwes_batch_equals_jax_and_reference(name, M):
    p = GEOMETRIES[name]
    ck, _, pk, _, tpkc = keys(name)
    bits, cts = groups(name)
    got = to_numpy_u32(pack.pack_lwes_batch(port(p), tpkc,
                                            from_numpy_u32(cts[:, :M])))
    np.testing.assert_array_equal(got, jax_packed(name, M))
    np.testing.assert_array_equal(got[2], jref.pack_lwes(pk, cts[2, :M]))
    for g in range(3):
        np.testing.assert_array_equal(jref.unpack_bools(ck, got[g], M),
                                      bits[g, :M])


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_pack_lwe_rows_equals_jax_groups(name):
    """A partition of 168 LWEs in one call: two full groups and a tail of
    40, each equal to the JAX package's group."""
    p = GEOMETRIES[name]
    tpkc = keys(name)[4]
    cts = groups(name)[1]
    flat = np.concatenate([cts[0], cts[1], cts[2, :40]])
    got = to_numpy_u32(pack.pack_lwe_rows(port(p), tpkc,
                                          from_numpy_u32(flat)))
    np.testing.assert_array_equal(got[:2], jax_packed(name, 64)[:2])
    np.testing.assert_array_equal(got[2], jax_packed(name, 40)[2])
    assert pack.pack_lwe_rows(port(p), tpkc, from_numpy_u32(
        flat[:0])).shape == (0, p.k + 1, p.N)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_extract_all_and_unpack_equal_jax(name):
    p = GEOMETRIES[name]
    ck, sk = keys(name)[:2]
    glwes = jax_packed(name, 64)
    want = np.asarray(jpack.extract_all_batch(p, jnp.asarray(glwes)))
    got = to_numpy_u32(pack.extract_all_batch(port(p),
                                              from_numpy_u32(glwes)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, 5], jref.sample_extract(
        p, glwes[1], 5))
    jdsk = jsk.device_server_key(sk, layouts=())
    tdsk = tsk.device_server_key(sk, layouts=(), device="cpu")
    want = np.asarray(jpack.unpack_lwes_batch(jdsk, jnp.asarray(glwes), 50))
    got = to_numpy_u32(pack.unpack_lwes_batch(tdsk, from_numpy_u32(glwes),
                                              50))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3 * 50, p.n + 1)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got).reshape(3, 50), groups(name)[0][:, :50])


NOISE_FUNCTIONS = ("mod_switch_sigma", "blind_rotate_var", "key_switch_var",
                   "pbs_out_sigma", "gate_margin_sigma", "packing_ks_var",
                   "glwe_frame_margin_sigma", "shortint_unary_margin_sigma",
                   "packed_bivariate_margin_sigma")


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_noise_equals_jax(name):
    """Every function of core/noise.py, at its defaults and beside them,
    on every parameter set: the same floats."""
    assert sorted(f for f in dir(noise) if not f.startswith("_")
                  and callable(getattr(noise, f)) and f != "TFHEParams") \
        == sorted(NOISE_FUNCTIONS)
    tp, jp = PARAM_SETS[name], JAX_SETS[name]
    for f in NOISE_FUNCTIONS:
        assert getattr(noise, f)(tp) == getattr(jnoise, f)(jp), f
    assert noise.mod_switch_sigma(tp, 1) == jnoise.mod_switch_sigma(jp, 1)
    for args in ((3, 1), (1, 1)):
        assert noise.shortint_unary_margin_sigma(tp, *args) \
            == jnoise.shortint_unary_margin_sigma(jp, *args)
    for args in ((2, 2, 1), (1, 1, 0)):
        assert noise.packed_bivariate_margin_sigma(tp, *args) \
            == jnoise.packed_bivariate_margin_sigma(jp, *args)
    assert noise.Q == jnoise.Q and math.isfinite(
        noise.glwe_frame_margin_sigma(tp))


# ---- the coordinator's packed frames, against the JAX coordinator ----

IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MID_COLS = (ColumnMeta("x", DataType.UINT8), ColumnMeta("odd", DataType.BIT))
Y_COLS = (ColumnMeta("y", DataType.UINT8),)
TABLE = [(9, 12), (255, 1), (0, 0), (77, 170), (5, 250)]
# the flags of each test_e2e.py case: :295 (a row frame downloaded packed),
# :391 (glwe_frames), :495 (and glwe_outputs), :607 (and glwe_inputs)
MODES = {"download": None,
         "frames": dict(glwe_frames=True),
         "outputs": dict(glwe_frames=True, glwe_outputs=True),
         "inputs": dict(glwe_frames=True, glwe_outputs=True,
                        glwe_inputs=True)}


def plan(frame_uuid, reduce, out="result"):
    """Input -> Mapper (x = a XOR b, odd = parity(x)) [-> PARALLEL XOR
    reduce] -> Output."""
    mb = CircuitBuilder(IN_COLS)
    x = mb.input_column("a") ^ mb.input_column("b")
    parity = x.bits[0]
    for bit in x.bits[1:]:
        parity = parity ^ bit
    mb.output("x", x)
    mb.output("odd", parity)
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(mb.build()))]
    if reduce:
        rb = CircuitBuilder(MID_COLS + MID_COLS)
        rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(2))
        rb.output("odd", rb.input_column_at(1).bits[0]
                  ^ rb.input_column_at(3).bits[0])
        stages.append(g.emplace(ReduceStage(rb.build(), Policy.PARALLEL,
                                            per_node_count=2)))
    stages.append(g.emplace(OutputStage(out)))
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


def not_plan(frame_uuid):
    """Input (x, odd) -> Mapper (y = NOT x) -> Output "second"."""
    cb = CircuitBuilder(MID_COLS)
    cb.output("y", ~cb.input_column("x"))
    g = DAG()
    stages = [g.emplace(InputStage(frame_uuid)),
              g.emplace(MapperStage(cb.build())),
              g.emplace(OutputStage("second"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


@pytest.fixture(scope="module")
def wire():
    """Client key, server and packing key bytes, and the row uploads."""
    rng = np.random.default_rng(31)
    ck, sk = jref.keygen(TOY, rng)
    pk = jref.make_packing_key(ck, rng)
    rows0 = jref.encrypt_bool(ck, np.zeros((1, 16), bool), rng)
    rows = client.encrypt_rows(ck, IN_COLS, TABLE, rng)
    return (ck, jcoord.serialize_server_key(sk), tcoord.serialize_packing_key(
        ref.PackingKey(PARAM_SETS["toy"], pk.pksk)), rows0, rows)


def upload(coord, token, session, name, cts, partitions):
    payloads = frame_codec.rows_to_payloads(cts)
    meta = coord.begin_data_frame_upload(
        token, session, name, SchemaType.TFHE_BOOL, IN_COLS, cts.shape[0],
        partitions)
    for i in range(0, len(payloads), 2):
        coord.append_data_frame(token, session, meta.uuid,
                                rowcodec.frame_rows(payloads[i:i + 2]))
    coord.finish_data_frame_upload(token, session, meta.uuid)
    return meta.uuid


def run(coord, token, session, p):
    job = coord.schedule_job(token, session, p.to_json())
    job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
    assert job.status == JobStatus.COMPLETED, job.message
    assert job.retries == 0
    return job


def scenario(coord, mode, wire):
    """Run ``mode``'s case on ``coord`` (either package's): every frame's
    partitions and flag, and every packed download, by job-independent
    names."""
    _, key_bytes, pk_bytes, rows0, rows = wire
    token = coord.authorize_connection("admin==true")
    session = coord.create_session(token, "glwe").uuid
    coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                  [key_bytes[i:i + 4096]
                   for i in range(0, len(key_bytes), 4096)])
    if mode == "inputs":  # no packing key yet: the frame stays rows
        upload(coord, token, session, "pre-key", rows0, 1)
    coord.add_key(token, session, SchemaType.TFHE_PACKING, len(pk_bytes),
                  [pk_bytes])
    frame = upload(coord, token, session, "in", rows, 2)
    job = run(coord, token, session, plan(frame, mode != "download"))
    (out,) = job.output_frames.values()
    frames = {f.name: f for f in coord.list_data_frames(token, session)}
    second_in = (frames["result"].uuid if mode in ("outputs", "inputs")
                 else next(f.uuid for n, f in frames.items()
                           if n.startswith("intermediate-"))
                 if mode == "frames" else None)
    jobs = [job.job_uuid]
    if second_in is not None:
        jobs.append(run(coord, token, session, not_plan(second_in)).job_uuid)
    res = {}
    for f in coord.list_data_frames(token, session):
        name = f.name
        for i, j in enumerate(jobs):
            name = name.replace(j, f"job{i}")
        parts = [coord.storage.partition_path(session, f.uuid, q).read_bytes()
                 for q in range(f.partitions)]
        res[name] = (f.glwe_packed, parts)
        if f.glwe_packed:  # the row download refuses a packed frame
            try:
                list(coord.download_data_frame(token, session, f.uuid))
            except Exception as e:  # noqa: BLE001 — either package's
                res["row download " + name] = type(e).__name__
        if name.startswith(("intermediate-", "reduce-", "result", "second",
                            "pre-key")) and (mode != "download"
                                             or name == "result"):
            res["packed " + name] = list(coord.download_data_frame_packed(
                token, session, f.uuid))
    return res


def jax_coordinator(d, mode):
    cfg = JConfig(server=JServerConfig(key_directory=str(d / "keys"),
                                       storage_directory=str(d / "st")),
                  security=JSecurityConfig(secret_key="glwe"),
                  mesh_workers=(JMesh(engine="conv_i8", **MODES[mode])
                                if MODES[mode] else None))
    return jcoord.Coordinator(cfg, engine="conv_i8")


def port_coordinator(d, mode):
    cfg = Config(server=ServerConfig(key_directory=str(d / "keys"),
                                     storage_directory=str(d / "st")),
                 security=SecurityConfig(secret_key="glwe"),
                 mesh_workers=(MeshWorkersConfig(engine="conv_i8",
                                                 **MODES[mode])
                               if MODES[mode] else None))
    return tcoord.Coordinator(cfg, engine="conv_i8", device="cpu")


def decrypt_rows(ck, parts, cols, params):
    cts = frame_codec.payloads_to_rows(
        [pl for part in parts for pl in rowcodec.parse_rows(part)],
        sum(c.dtype.bit_width for c in cols), params)
    return client.decrypt_rows(ck, cols, cts)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_jobs_equal_jax_coordinator(wire, tmp_path, mode):
    results = []
    for make, d in ((jax_coordinator, tmp_path / "jax"),
                    (port_coordinator, tmp_path / "port")):
        coord = make(d, mode)
        try:
            results.append(scenario(coord, mode, wire))
        finally:
            coord.shutdown()
    want, got = results
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        assert got[name] == want[name], name
    ck = wire[0]
    toy = PARAM_SETS["toy"]
    xs = [a ^ b for a, b in TABLE]
    odd = [bin(x).count("1") & 1 for x in xs]
    mids = [{"x": x, "odd": o} for x, o in zip(xs, odd)]
    folded = {"x": np.bitwise_xor.reduce(xs), "odd": sum(odd) & 1}
    packed = {n: v for n, v in got.items() if n.startswith("packed ")}
    if mode == "download":
        assert not got["result"][0]
        assert decrypt_rows(ck, got["result"][1], MID_COLS, toy) == mids
        assert client.decrypt_rows_packed(ck, MID_COLS,
                                          packed["packed result"]) == mids
        assert sum(map(len, packed["packed result"])) \
            < sum(map(len, got["result"][1]))
        return
    (mid,) = [n for n in got if n.startswith("intermediate-job0-")]
    assert got[mid][0] and got["in"][0] == (mode == "inputs")
    assert client.decrypt_rows_packed(ck, MID_COLS,
                                      packed["packed " + mid]) == mids
    assert client.decrypt_rows_packed(ck, MID_COLS,
                                      packed["packed result"]) == [folded]
    assert got["result"][0] == (mode != "frames")
    second = [{"y": (~r["x"]) & 0xFF}
              for r in ([folded] if mode != "frames" else mids)]
    if got["second"][0]:
        assert client.decrypt_rows_packed(
            ck, Y_COLS, packed["packed second"]) == second
    else:
        assert decrypt_rows(ck, got["second"][1], Y_COLS, toy) == second
    assert all(v == "MappingError" for n, v in got.items()
               if n.startswith("row download "))
    assert "row download " + mid in got
    if mode == "inputs":
        assert not got["pre-key"][0]
        assert client.decrypt_rows_packed(ck, IN_COLS,
                                          packed["packed pre-key"]) \
            == [{"a": 0, "b": 0}]


def test_pack_at_ingest_is_all_or_nothing(wire, tmp_path, monkeypatch):
    """glwe_inputs: packing fails on the second partition.  The finish
    call raises (the port hides no failure, where the JAX coordinator logs
    and goes on), nothing packed is left beside the rows, the frame stays
    in the row format, and its rows download and decrypt; with packing
    working again, the next upload is packed."""
    ck, key_bytes, pk_bytes, _, rows = wire
    coord = port_coordinator(tmp_path, "inputs")
    calls = []
    pack_rows = pack.pack_lwe_rows

    def failing(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("packing failed on partition 1")
        return pack_rows(*args)

    try:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "atomic").uuid
        for schema, blob in ((SchemaType.TFHE_BOOL, key_bytes),
                             (SchemaType.TFHE_PACKING, pk_bytes)):
            coord.add_key(token, session, schema, len(blob), [blob])
        monkeypatch.setattr(pack, "pack_lwe_rows", failing)
        with pytest.raises(RuntimeError, match="partition 1"):
            upload(coord, token, session, "in", rows, 2)
        assert len(calls) == 2
        (entry,) = coord.list_data_frames(token, session)
        assert entry.uploaded and not entry.glwe_packed
        files = sorted(p.name for p in coord.storage.frame_dir(
            session, entry.uuid).iterdir())
        assert files == ["0", "1"]
        parts = list(coord.download_data_frame(token, session, entry.uuid))
        assert decrypt_rows(ck, parts, IN_COLS, PARAM_SETS["toy"]) \
            == [{"a": a, "b": b} for a, b in TABLE]
        monkeypatch.setattr(pack, "pack_lwe_rows", pack_rows)
        frame = upload(coord, token, session, "again", rows, 2)
        assert coord.storage.get_data_frame(session, frame).glwe_packed
        with pytest.raises(MappingError):
            list(coord.download_data_frame(token, session, frame))
    finally:
        coord.shutdown()
