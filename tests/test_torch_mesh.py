"""The port's mesh (``herdsman_tpu_torch.mesh``) on CPU positions against
the JAX package's ``herdsman_tpu.mesh`` on the suite's 8 virtual XLA
devices, array-equal: the (4, 2) ``conv_i8`` bootstrap with its exact limb
sum, the sharded gate step and ``PlanCompiler`` on a mesh (frames
byte-equal).  Also the refusals, the key's placement, ``init_multihost``
and ``make_pod_mesh`` in one process, ``ShortContext(mesh=...)`` against
one device, and a ``Coordinator(device="cpu")`` serving jobs on a
``workers.mesh`` of CPU positions, byte-equal to one device's.

n is cut to 4 steps, where the JAX test takes 16: the sharding is the same
at any n.  Each JAX reference runs once (``functools.cache``), its
``conv_i8`` calls under ``jax.jit`` (one compile, where its eager
``shard_map`` takes 10-15 s).  Batch parallelism on the rotation engines,
the PBS and radix are in ``tests/test_torch_mesh_dp.py``.
"""

import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu import circuit as jcircuit
from herdsman_tpu import mesh as jmesh
from herdsman_tpu.compiler.stages import FrameData as JFrameData
from herdsman_tpu.compiler.stages import PlanCompiler as JPlanCompiler
from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch import circuit as tcircuit
from herdsman_tpu_torch import mesh as tmesh
from herdsman_tpu_torch.circuit import Policy
from herdsman_tpu_torch.compiler.stages import FrameData, PlanCompiler
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service.config import MeshWorkersConfig
from herdsman_tpu_torch.shortint import ShortContext
from test_torch_service import (decrypt, inputs, oracle,  # noqa: F401
                                port_coordinator, run_plan, start_session)

# n cut to 4 steps; N = 256 for the block-Toeplitz engines, which the port
# tiles by 128 columns
TOY4 = dc.replace(TOY, name="toy_mesh_n4", n=4)
TOY4_N256 = dc.replace(TOY, name="toy_mesh_n4_n256", n=4, N=256)
GATES = [lambda x, y: x & y, lambda x, y: x | y,
         lambda x, y: not (x and y), lambda x, y: not (x or y),
         lambda x, y: x ^ y, lambda x, y: not (x ^ y)]


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
def keys(params):
    rng = np.random.default_rng(41)
    ck, sk = jref.keygen(params, rng)
    return ck, sk


@functools.cache
def bool_batch(params, B=8):
    """(bits, ciphertexts) of B fresh booleans."""
    ck, _ = keys(params)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, B).astype(bool)
    return bits, jref.encrypt_bool(ck, bits, rng)


def cpu_mesh(batch, limb=1):
    return tmesh.make_mesh(batch, limb, device="cpu")


@functools.cache
def jax_conv_bootstrap(batch, limb):
    _, sk = keys(TOY4)
    mesh = jmesh.make_mesh(batch=batch, limb=limb)
    dsk = jsk.device_server_key(sk, layouts=("bsk_conv",))
    _, ct = bool_batch(TOY4)
    return np.asarray(jax.jit(lambda d, c: jmesh.bootstrap_bool_sharded(
        d, mesh, c, engine="conv_i8"))(jmesh.shard_server_key(dsk, mesh),
                                       jnp.asarray(ct)))


@pytest.mark.parametrize("engine", ["conv_i8", "gather_u32"])
def test_limb_sharded_bootstrap_equals_jax_mesh(engine):
    """The (4, 2) bootstrap, each line's two limb positions summing their
    partial products, equals the JAX (4, 2) shard_map's and one device's."""
    _, sk = keys(TOY4)
    dsk = tsk.device_server_key(sk, layouts=tsk.layouts_for_engine(engine),
                                device="cpu")
    mesh = cpu_mesh(4, 2)
    bits, ct = bool_batch(TOY4)
    out = tmesh.bootstrap_bool_sharded(tmesh.shard_server_key(dsk, mesh),
                                       mesh, ct, engine=engine)
    np.testing.assert_array_equal(to_numpy_u32(out), jax_conv_bootstrap(4, 2))
    assert torch.equal(out, tbs.bootstrap_bool_batch(dsk, ct, engine=engine,
                                                     device="cpu"))


def test_sharded_gate_step_equals_jax_and_decrypts():
    ck, sk = keys(TOY4)
    rng = np.random.default_rng(3)
    B = 8
    b1, b2 = (rng.integers(0, 2, B).astype(bool) for _ in range(2))
    ids = rng.integers(0, 6, B)
    c1, c2 = (jref.encrypt_bool(ck, b, rng) for b in (b1, b2))
    jm = jmesh.make_mesh(batch=4, limb=2)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_conv",))
    step = jax.jit(lambda d, i, a, b: jmesh.gate_step_sharded(
        d, jm, i, a, b, engine="conv_i8"))
    want = np.asarray(step(jmesh.shard_server_key(jdsk, jm),
                           jnp.asarray(ids, jnp.int32), jnp.asarray(c1),
                           jnp.asarray(c2)))
    dsk = tsk.device_server_key(sk, layouts=("bsk_conv",), device="cpu")
    out = to_numpy_u32(tmesh.gate_step_sharded(dsk, cpu_mesh(4, 2), ids, c1,
                                               c2, engine="conv_i8"))
    np.testing.assert_array_equal(out, want)
    expect = [bool(GATES[g](bool(x), bool(y)))
              for g, x, y in zip(ids, b1, b2)]
    assert jref.lwe_decrypt_bool(ck, out).tolist() == expect


@pytest.mark.parametrize("engine", ["mega13", "bt_fused", "bt"])
def test_limb_axis_refused_on_batch_only_engines(engine):
    _, sk = keys(TOY4_N256)
    dsk = tsk.device_server_key(sk, layouts=tsk.layouts_for_engine(engine),
                                device="cpu")
    _, ct = bool_batch(TOY4_N256)
    with pytest.raises(ValueError, match=f"engine '{engine}' shards over "
                       "batch only"):
        tmesh.bootstrap_bool_sharded(dsk, cpu_mesh(1, 2), ct, engine=engine)
    # a key split over the limb axis is refused by the engine itself too
    line = tmesh.shard_server_key(dsk, cpu_mesh(1, 2)).line(0)
    with pytest.raises(ValueError, match="limb axis"):
        tbs.bootstrap_bool_batch(line, ct, engine=engine, device="cpu")


def test_make_mesh_refuses_absent_cards():
    """On CUDA the mesh takes the visible cards and names both counts when
    they are too few (none here); CPU positions and a repeated device are
    fine."""
    with pytest.raises(ValueError, match="needs 4 devices, 0 are visible"):
        tmesh.make_mesh(2, 2)
    mesh = tmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.axis_names == ("batch", "limb")
    assert mesh.shape == {"batch": 2, "limb": 2} and mesh.size == 4
    assert set(mesh.devices.flat) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="do not split"):  # R = 6 rows
        _, sk = keys(TOY4)
        tmesh.shard_server_key(
            tsk.device_server_key(sk, layouts=("bsk_conv",), device="cpu"),
            cpu_mesh(1, 4))


def test_shard_server_key_layout():
    """Row-split layouts take their share of the GGSW rows as views of the
    key (positions on one device copy nothing), the rest are the key's own
    tensors; a line's own key holds none of the split layouts."""
    _, sk = keys(TOY4)
    dsk = tsk.device_server_key(sk, layouts=("bsk_conv", "bsk_btS"),
                                device="cpu")
    sharded = tmesh.shard_server_key(dsk, cpu_mesh(2, 3))
    for (b, l), key in np.ndenumerate(sharded.keys):
        assert torch.equal(key.bsk_conv, dsk.bsk_conv[:, 2 * l:2 * l + 2])
        assert key.bsk_conv.data_ptr() == dsk.bsk_conv[:, 2 * l].data_ptr()
        assert key.bsk_btS is dsk.bsk_btS
        assert key.ksk_limbs is dsk.ksk_limbs
    line = sharded.line(1)
    assert line.limb_shards == tuple(sharded.keys[1])
    # the line's own key holds none of the split layouts: a reader that
    # skips the shards fails instead of computing a partial product
    assert all(getattr(line, f) is None for f in tsk.ROW_SHARDED)
    assert line.bsk_btS is dsk.bsk_btS
    with pytest.raises(ValueError, match="bsk_conv"):
        tbs._key(line, "bsk_conv", "conv_i8")


def frame_plan(c):
    """A map (NOT) + SEQUENCED XOR-reduce plan over one UINT8 column, built
    from either package's ``circuit`` module."""
    cols = (c.ColumnMeta("a", c.DataType.UINT8),)
    cb = c.CircuitBuilder(cols)
    cb.output("x", ~cb.input_column("a"))
    rb = c.CircuitBuilder((c.ColumnMeta("x", c.DataType.UINT8),) * 2)
    rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(1))
    g = c.DAG()
    stages = [g.emplace(c.InputStage("frame-0")),
              g.emplace(c.MapperStage(cb.build())),
              g.emplace(c.ReduceStage(rb.build(), c.Policy.SEQUENCED)),
              g.emplace(c.OutputStage("out"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return cols, c.ExecutionPlan(c.SchemaType.TFHE_BOOL, g)


@functools.cache
def jax_plan_frames():
    """The JAX package's PlanCompiler on its 8-device batch mesh."""
    _, sk = keys(TOY4)
    bits = plan_rows()[1]
    cols, plan = frame_plan(jcircuit)
    dsk = jsk.device_server_key(sk, layouts=("bsk_conv",))
    out = JPlanCompiler(dsk, engine="conv_i8",
                        mesh=jmesh.make_mesh(batch=8, limb=1)).execute(
        plan, {"frame-0": JFrameData(cols, jnp.asarray(bits), 2)})
    return [np.asarray(f.data) for f in out.outputs.values()]


@functools.cache
def plan_rows():
    ck, _ = keys(TOY4)
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 256, 8)
    bits = np.stack([jref.encrypt_bool(ck, (vals >> t) & 1 == 1, rng)
                     for t in range(8)], axis=1)
    return vals, bits


@pytest.mark.parametrize("shape, engine", [((8, 1), "conv_i8"),
                                           ((3, 2), "conv_i8"),
                                           ((4, 1), "mega13")])
def test_plan_compiler_on_mesh_equals_jax(shape, engine):
    """A map + SEQUENCED reduce plan with its rows split over the batch
    axis (3 does not divide 8 rows, and the fold's tails shrink below it)
    gives the JAX package's 8-device frames byte for byte."""
    ck, sk = keys(TOY4)
    vals, bits = plan_rows()
    cols, plan = frame_plan(tcircuit)
    dsk = tsk.device_server_key(sk, layouts=tsk.layouts_for_engine(engine),
                                device="cpu")
    got = PlanCompiler(dsk, engine=engine, mesh=cpu_mesh(*shape)).execute(
        plan, {"frame-0": FrameData(cols, from_numpy_u32(bits), 2)})
    [out] = [to_numpy_u32(f.data) for f in got.outputs.values()]
    [want] = jax_plan_frames()
    np.testing.assert_array_equal(out, want)
    dec = sum(int(jref.lwe_decrypt_bool(ck, out[:, t])[0]) << t
              for t in range(8))
    expect = 0
    for v in vals:
        expect ^= ~int(v) & 0xFF
    assert dec == expect


def test_init_multihost_noop_single_process(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_multihost() is False
    assert not torch.distributed.is_initialized()


def test_make_pod_mesh_shapes():
    cpu8 = ["cpu"] * 8
    mesh = tmesh.make_pod_mesh(limb=2, devices=cpu8)
    assert mesh.axis_names == ("batch", "limb")
    assert mesh.devices.shape == (4, 2) and mesh.backend is None
    assert (mesh.processes == 0).all()
    assert tmesh.make_pod_mesh(limb=1, devices=cpu8).devices.shape == (8, 1)
    with pytest.raises(ValueError, match="limb=3 would cross"):
        tmesh.make_pod_mesh(limb=3, devices=cpu8)
    with pytest.raises(ValueError, match=r"per process \[0\]"):
        tmesh.make_pod_mesh()  # the visible cards: none here


def test_pod_mesh_runs_sharded_bootstrap():
    """make_pod_mesh's mesh is a drop-in for the sharded bootstrap."""
    _, sk = keys(TOY4)
    dsk = tsk.device_server_key(sk, layouts=("bsk_conv",), device="cpu")
    mesh = tmesh.make_pod_mesh(limb=2, devices=["cpu"] * 8)
    _, ct = bool_batch(TOY4)
    out = tmesh.bootstrap_bool_sharded(dsk, mesh, ct, engine="conv_i8")
    np.testing.assert_array_equal(to_numpy_u32(out), jax_conv_bootstrap(4, 2))


@pytest.fixture(scope="module")
def single_device_frames(inputs, tmp_path_factory):  # noqa: F811
    _, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path_factory.mktemp("one"))
    try:
        token, session, frame = start_session(coord, key_bytes, chunks)
        return run_plan(coord, token, session, frame, Policy.PARALLEL)[1]
    finally:
        coord.shutdown()


@pytest.mark.parametrize("mesh_cfg, engine", [
    ({"batch_axis": 2}, "pallas_bt"), ({"limb_axis": 2}, "conv_i8"),
    ({"batch_axis": 2, "limb_axis": 2}, "gather_u32")],
    ids=["batch2_default_engine", "limb2_conv_i8", "batch2_limb2_gather"])
def test_coordinator_on_mesh_serves_single_device_frames(
        inputs, single_device_frames, tmp_path, mesh_cfg,  # noqa: F811
        engine):
    """A coordinator on a workers.mesh of CPU positions completes the job
    with no retry, its frames byte-equal to one device's."""
    ck, key_bytes, chunks = inputs
    coord = port_coordinator(tmp_path, engine=None,
                             mesh_workers=MeshWorkersConfig(engine=engine,
                                                            **mesh_cfg))
    try:
        assert coord.mesh.shape == {"batch": mesh_cfg.get("batch_axis", 1),
                                    "limb": mesh_cfg.get("limb_axis", 1)}
        token, session, frame = start_session(coord, key_bytes, chunks)
        _, frames = run_plan(coord, token, session, frame, Policy.PARALLEL)
    finally:
        coord.shutdown()
    assert frames == single_device_frames
    rows, out = oracle()
    assert decrypt(ck, frames["mid"]) == rows
    assert decrypt(ck, frames["out"]) == out


@pytest.mark.parametrize("engine", ["pallas_bt", "pallas_mega13"])
def test_coordinator_refuses_limb_axis_on_batch_only_engine(tmp_path,
                                                            engine):
    port = engine.removeprefix("pallas_")
    with pytest.raises(ValueError, match=f"engine '{port}' shards over "
                       "batch only"):
        port_coordinator(tmp_path, engine=None, mesh_workers=(
            MeshWorkersConfig(engine=engine, limb_axis=2)))


def test_shortint_on_mesh_equals_one_device():
    """ShortContext(mesh=...) on the port's default engine (``mega12``): a
    packed product equal to one device's ciphertexts, on a (1, 2) mesh
    (each limb position with the whole key: the PBS splits its batch over
    every position)."""
    one = ShortContext(PARAM_SETS["test_pbs"], seed=3, device="cpu")
    meshed = ShortContext(one.params, keys=(one.ck, one.sk),
                          mesh=cpu_mesh(1, 2), device="cpu")
    outs = []
    for short in (one, meshed):
        short._rng = np.random.default_rng(1)
        a, b = short.encrypt([0, 1, 2, 3]), short.encrypt([3, 2, 1, 0])
        outs.append(a * b)
    x, y = outs
    assert one.rotations == meshed.rotations == 4
    assert one.engine == meshed.engine == "mega12"
    assert torch.equal(x.data, y.data) and y.data.device == meshed.device
    assert meshed.decrypt(y) == [0, 2, 2, 0]
