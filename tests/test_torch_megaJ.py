"""The port's j-major block-Toeplitz rotation engines (``mega11``, ``mega8``,
``mega7``: ``ops/kernels/megaJ.py``, the plain versions of
``csrc/mega12.cu``'s two windows) against the JAX package, on the CPU: the
three key layouts against ``_block_toeplitz_layout_device``, each plain rotation
against the Pallas ``_mega11/8/7_kernel`` in interpret mode and the NumPy
reference, the wrappers' checks, ``gate_batch`` on each engine, a
coordinator job on ``pallas_mega11`` against the same job on
``pallas_fused``, the integer tier on ``mega7`` and ``mega11``, and
``fit_engine``'s routes against the JAX package's at the port's key
budget.  Array equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import PARAM_SETS as JAX_SETS
from herdsman_tpu.core import TEST_PBS, TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import gates as jgates
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch import shortint as tshort
from herdsman_tpu_torch.circuit import (DAG, CircuitBuilder, ColumnMeta,
                                        DataType, ExecutionPlan, InputStage,
                                        MapperStage, OutputStage, Policy,
                                        ReduceStage, SchemaType)
from herdsman_tpu_torch.core import PARAM_SETS, client
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12, megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service import coordinator as tcoord
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.config import (ENGINE_NAMES, Config,
                                               MeshWorkersConfig,
                                               SecurityConfig, ServerConfig)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.utils import rowcodec

# HALF = 2 at N = 256 moves the window and the negated run, at k = 1 and
# k = 2 (tests/test_ops_bitexact.py:388-440); n is cut to 8 steps so that
# interpret-mode rotations stay fast
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
# the serial-schedule kernels; the legacy mega9 (mega8's source, another
# schedule) and mega6 (mega7's kernel and key) are tests/test_torch_legacy.py's
ENGINES = ["mega11", "mega8", "mega7"]
# layout -> the JAX package's _block_toeplitz_layout_device arguments
JAX_LAYOUTS = {"bsk_btj": {"j_major": True},
               "bsk_btj2": {"windowed": True},
               "bsk_btj2j": {"windowed": True, "col_order": "jcq"}}


def port(p) -> TFHEParams:
    """The port's TFHEParams for the JAX package's."""
    return TFHEParams(**dc.asdict(p))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_u32(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@functools.cache
def keys(params):
    """(params, client key, server key, JAX key, port key), the keys in the
    three layouts, the port's also in the K-major ``bsk_btk`` and
    ``bsk_btk2`` that ``mega7`` and ``mega11`` read."""
    ck, sk = jref.keygen(params, np.random.default_rng(17))
    layouts = tuple(JAX_LAYOUTS)
    return (params, ck, sk, jsk.device_server_key(sk, layouts=layouts),
            tsk.device_server_key(sk, layouts=(*layouts, "bsk_btk",
                                               "bsk_btk2"), device="cpu"))


@pytest.fixture(scope="module", params=[MULTITILE, MULTITILE_K2],
                ids=["k1", "k2"])
def geometry(request):
    return keys(request.param)


@pytest.mark.parametrize("layout", list(JAX_LAYOUTS))
def test_layouts_equal_jax(geometry, layout):
    params, _, sk, jdsk, tdsk = geometry
    got = getattr(tdsk, layout)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jdsk,
                                                                  layout)))
    R = (params.k + 1) * params.levels
    ext = jsk._np_ext(sk.bsk.reshape(params.n, R, params.k + 1, params.N))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsk._block_toeplitz_layout_device(params, ext,
                                          **JAX_LAYOUTS[layout])))
    doubled = layout != "bsk_btj"
    assert got.numel() == (2 if doubled else 1) * tsk.bt_key_bytes(
        tdsk.params)


def test_doubled_window_holds_the_negated_blocks(geometry):
    """Group g of the window is diagonal block (HALF-1-g) mod 2*HALF of
    ``bsk_btj``'s, negated past HALF; ``bsk_btj2j`` is ``bsk_btj2`` with its
    columns (c, j, q) reordered to (j, c, q)."""
    params, _, _, _, tdsk = geometry
    kp1, P, HALF = params.k + 1, 128, params.N // 128
    btj = tdsk.bsk_btj.to(torch.int64)
    for g in range(2 * HALF):
        m = (HALF - 1 - g) % (2 * HALF)
        win = tdsk.bsk_btj2[:, g].to(torch.int64)
        if m < HALF:
            assert torch.equal(win, btj[:, m])
        else:  # limbs of -x: the u32 words are negated, not the limbs
            words = (win.reshape(*win.shape[:3], kp1, 4, P)
                     * (256 ** torch.arange(4))[:, None]).sum(-2)
            pos = (btj[:, m - HALF].reshape(*win.shape[:3], kp1, 4, P)
                   * (256 ** torch.arange(4))[:, None]).sum(-2)
            assert torch.equal((words + pos) % (1 << 32),
                               torch.zeros_like(words))
    n, M, R = tdsk.bsk_btj2.shape[:3]
    jcq = tdsk.bsk_btj2.reshape(n, M, R, P, kp1, 4, P).transpose(4, 5)
    assert torch.equal(jcq.reshape(tdsk.bsk_btj2j.shape), tdsk.bsk_btj2j)


@pytest.mark.parametrize("B", [3, 37])
@pytest.mark.parametrize("name", ENGINES)
def test_plain_rotation_equals_jax_pallas(geometry, name, B):
    params, _, sk, jdsk, tdsk = geometry
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + params.k)
    ct = rand_u32(rng, B, params.n + 1)
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine=f"pallas_{name}", unroll=True))
    before = kernel.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine=name))
    assert kernel.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[B - 1], jref.blind_rotate(sk, ct[B - 1],
                                      jref.make_test_poly(params)))


@pytest.mark.parametrize("name", ENGINES)
def test_megaJ_wrapper_checks(geometry, name):
    params, _, _, _, tdsk = geometry
    p = tdsk.params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    key = getattr(tdsk, megaJ.KEY_LAYOUTS[name])
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernel(p, acc, a_t.long(), key)
    with pytest.raises(ValueError):
        kernel(p, acc, a_t[:, :1].contiguous(), key)
    with pytest.raises(ValueError):  # the other window width
        other = tdsk.bsk_btk if megaJ.KERNELS[name] else tdsk.bsk_btk2
        kernel(p, acc, a_t, other)
    with pytest.raises(ValueError):
        kernel(p, acc[:, :, ::2], a_t, key)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(p, acc.transpose(1, 2).contiguous().transpose(1, 2), a_t, key)
    # one ciphertext over a block's shared memory: csrc/mega12.cu's windows
    # keep digits and accumulators in device memory
    megaJ.check_params(dc.replace(p, N=2048, k=4, bg_bits=1, levels=32),
                       name)
    for bad in (dc.replace(p, N=64), dc.replace(p, k=3),
                dc.replace(p, N=4096)):
        with pytest.raises(ValueError):
            megaJ.check_params(bad, name)
    megaJ.check_params(PARAM_SETS["std128_shortint"], name)
    assert tsk.layouts_for_engine(name) == (megaJ.KEY_LAYOUTS[name],)
    assert tbs.ROTATION_ENGINES[name] == (kernel, megaJ.KEY_LAYOUTS[name])


def test_block_layout_limits():
    """No wrapper of the family has a shared-memory block layout left to
    limit it: every one is ``csrc/mega12.cu``'s (digits and accumulators in
    device memory), and takes STD128_SHORTINT and a set whose one
    ciphertext (accumulator and digits, 368,644 bytes) is over a block's
    232,448 bytes of shared memory, as ``mega12`` does, and reads the key
    of its window."""
    si = PARAM_SETS["std128_shortint"]
    big = dc.replace(si, N=2048, k=4, bg_bits=1, levels=32)
    assert (big.k + 1) * big.N * (4 + big.levels) + 4 > 232_448
    for name, doubled in megaJ.KERNELS.items():
        for p in (si, big):
            megaJ.check_params(p, name)
            assert megaJ.key_shape(p, name) == mega12.key_shape(p, doubled)


@pytest.mark.parametrize("name", ENGINES)
def test_gate_batch_equals_jax(name):
    _, ck, _, jdsk, tdsk = keys(MULTITILE_K2)
    rng = np.random.default_rng(36)
    B = 12
    b1, b2 = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(
        bool)
    ids = np.arange(B) % len(tgates.GATE_IDS)
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    want = np.asarray(jgates.gate_batch(
        jdsk, jgates.GateBatch(jnp.asarray(ids, dtype=jnp.int32),
                               jnp.asarray(c1), jnp.asarray(c2)),
        engine=f"pallas_{name}"))
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    before = kernel.launches
    got = to_numpy_u32(tgates.gate_batch(tdsk, tgates.GateBatch(ids, c1, c2),
                                         engine=name, device="cpu"))
    assert kernel.launches == before
    np.testing.assert_array_equal(got, want)
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    names = list(tgates.GATE_IDS)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got),
        [truth[names[g]][i] for i, g in enumerate(ids)])


IN_COLS = (ColumnMeta("a", DataType.UINT8), ColumnMeta("b", DataType.UINT8))
MID_COLS = (ColumnMeta("x", DataType.UINT8), ColumnMeta("odd", DataType.BIT))
TABLE = [(3, 5), (200, 100), (255, 255), (17, 4), (128, 1)]


def job_plan(frame_uuid: str) -> ExecutionPlan:
    """tests/test_e2e.py's plan: Input -> Mapper (x = a XOR b, odd =
    parity(x)) -> Reduce (bitwise XOR, PARALLEL, 2 per node) -> Output."""
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
              g.emplace(ReduceStage(rb.build(), Policy.PARALLEL,
                                    per_node_count=2)),
              g.emplace(OutputStage("result"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


def run_job(tmp_path, engine: str, key_bytes: bytes, upload: bytes):
    """A coordinator configured in code with ``engine``: session, key, row
    upload, the plan as JSON, and the output and intermediate frames."""
    coord = tcoord.Coordinator(Config(
        server=ServerConfig(key_directory=str(tmp_path / "keys"),
                            storage_directory=str(tmp_path / "st")),
        security=SecurityConfig(secret_key="test-secret"),
        mesh_workers=MeshWorkersConfig(engine=engine)), device="cpu")
    try:
        token = coord.authorize_connection("admin==true")
        session = coord.create_session(token, "s").uuid
        coord.add_key(token, session, SchemaType.TFHE_BOOL, len(key_bytes),
                      [key_bytes])
        meta = coord.begin_data_frame_upload(
            token, session, "in", SchemaType.TFHE_BOOL, IN_COLS, len(TABLE),
            2)
        coord.append_data_frame(token, session, meta.uuid, upload)
        coord.finish_data_frame_upload(token, session, meta.uuid)
        job = coord.schedule_job(token, session,
                                 job_plan(meta.uuid).to_json())
        job = coord.wait_for_job(token, session, job.job_uuid, timeout=600)
        assert job.status == JobStatus.COMPLETED, job.message
        assert job.retries == 0 and job.bootstraps_executed > 0
        (out,) = job.output_frames.values()
        (mid,) = [f.uuid for f in coord.list_data_frames(token, session)
                  if f.name.startswith(f"intermediate-{job.job_uuid}-")]
        return coord._session_dsk[session][0], {
            name: list(coord.download_data_frame(token, session, u))
            for name, u in (("out", out), ("mid", mid))}
    finally:
        coord.shutdown()


def test_coordinator_job_on_mega11_equals_fused(tmp_path, monkeypatch):
    """The same job on ``pallas_mega11`` and on ``pallas_fused`` gives
    byte-equal frames at the k = 2 geometry, which decrypt right."""
    params = port(MULTITILE_K2)
    monkeypatch.setitem(tcoord.PARAM_SETS, params.name, params)
    rng = np.random.default_rng(44)
    ck, sk = jref.keygen(MULTITILE_K2, rng)
    cts = client.encrypt_rows(ck, IN_COLS, TABLE, rng)
    upload = rowcodec.frame_rows(frame_codec.rows_to_payloads(cts))
    key_bytes = tcoord.serialize_server_key(sk)
    before = megaJ.mega11_blind_rotate.launches
    used, frames = run_job(tmp_path / "m11", "pallas_mega11", key_bytes,
                           upload)
    assert used == "mega11" and megaJ.mega11_blind_rotate.launches == before
    fused_used, fused = run_job(tmp_path / "fused", "pallas_fused",
                                key_bytes, upload)
    assert fused_used == "bt_fused"
    assert frames == fused  # byte for byte, every partition
    rows = [{"x": a ^ b, "odd": bin(a ^ b).count("1") & 1} for a, b in TABLE]
    out = {"x": 0, "odd": 0}
    for r in rows:
        out = {k: out[k] ^ r[k] for k in out}
    for name, want in (("mid", rows), ("out", [out])):
        payloads = [pl for part in frames[name]
                    for pl in rowcodec.parse_rows(part)]
        got = client.decrypt_rows(
            ck, MID_COLS, frame_codec.payloads_to_rows(payloads, 9, params))
        assert got == want, name


SHORT_A, SHORT_B = [0, 1, 2, 3, 3], [3, 1, 2, 2, 0]


@functools.cache
def short_mul_add(engine: str) -> torch.Tensor:
    """(a*b)+a, reduced, on a ``ShortContext(engine=...)`` at TEST_PBS, from
    one set of keys and one seed; checks the route and the decryption."""
    keys = jref.keygen(TEST_PBS, np.random.default_rng(4321))
    ctx = tshort.ShortContext(port(TEST_PBS), msg_bits=2, carry_bits=2,
                              keys=keys, seed=5, engine=engine, device="cpu")
    assert ctx.engine == engine
    assert getattr(ctx.dsk, tsk.ENGINE_LAYOUTS[engine]) is not None
    a, b = ctx.encrypt(SHORT_A), ctx.encrypt(SHORT_B)
    r = ((a * b) + a).reduce()
    assert ctx.decrypt(r) == [(x * y + x) % 4 for x, y in zip(SHORT_A,
                                                              SHORT_B)]
    return r.data


@pytest.mark.parametrize("name", ["mega7", "mega11"])
def test_shortint_on_megaJ_equals_mega12(name):
    """``ShortContext(engine=...)`` routes to the engine through
    ``fit_engine`` and gives ``mega12``'s ciphertexts (tests/
    test_torch_shortint.py holds ``mega12``'s equal to the JAX package's)."""
    assert torch.equal(short_mul_add(name), short_mul_add("mega12"))


# the documented divergences of the port's fit_engine: pallas_mega13's route
# (the port's mega13 reads the raw key), and sets whose N is below the
# port's 128-column tile, which only mega13 takes
def test_fit_engine_parity_with_jax():
    """For every parameter set and every JAX engine name the port maps, the
    port's route equals the JAX package's at the port's 40 GiB budget."""
    checked = 0
    for name, p in PARAM_SETS.items():
        for jname, engine in ENGINE_NAMES.items():
            if jname == "pallas_mega13" or p.N < 128:
                continue
            want = jsk.fit_engine(jname, JAX_SETS[name],
                                  hbm_budget_bytes=tsk.KEY_BUDGET_BYTES)
            assert tsk.fit_engine(engine, p) == ENGINE_NAMES[want], (name,
                                                                     jname)
            checked += 1
    assert checked == (len(ENGINE_NAMES) - 1) * (len(PARAM_SETS) - 1)


# the JAX package's route of pallas_mega13, set by set, at the port's 40 GiB
# budget and at the JAX package's own 12 GiB default
JAX_MEGA13_ROUTES = {
    "toy": ("pallas_mega11", "pallas_mega11"),
    "test_small": ("pallas_mega11", "pallas_mega11"),
    "test_pbs": ("pallas_mega11", "pallas_mega11"),
    "std128": ("pallas_mega11", "pallas_mega11"),
    "std128_fast": ("pallas_mega13", "pallas_mega13"),
    "std128_shortint": ("pallas_mega11", "pallas_mega12"),
    "std128_shortint_fast": ("pallas_mega13", "pallas_mega16"),
    "std128_shortint_b8": ("pallas_mega11", "pallas_mega12"),
    "std128_shortint_l4": ("pallas_mega11", "pallas_mega12"),
    "std128_k2": ("pallas_mega13", "pallas_mega13"),
    "std128_k4": ("pallas_mega13", "pallas_mega13"),
}


def test_fit_engine_mega13_divergence_set_by_set():
    """The pairs the parity test skips: the port keeps ``mega13`` at every
    named set (its kernel reads the raw key), where the JAX package keeps
    ``pallas_mega13`` (the extended pt-major key) only at the bg = 2^8, l =
    2 sets with N >= 256 and sends the others to ``pallas_mega11`` at 40
    GiB, and at its 12 GiB default also STD128_SHORTINT_FAST (17.25 GiB)
    to ``pallas_mega16``.  The outputs are equal either way."""
    assert set(JAX_MEGA13_ROUTES) == set(PARAM_SETS)
    for name, p in PARAM_SETS.items():
        at40, at12 = JAX_MEGA13_ROUTES[name]
        assert tsk.fit_engine("mega13", p) == "mega13", name
        assert jsk.fit_engine("pallas_mega13", JAX_SETS[name],
                              hbm_budget_bytes=tsk.KEY_BUDGET_BYTES) == at40
        assert jsk.fit_engine("pallas_mega13", JAX_SETS[name]) == at12
        b8l2 = p.bg_bits == 8 and p.levels == 2 and p.N >= 256
        assert (at40 == "pallas_mega13") == b8l2, name


def test_fit_engine_doubled_key_routes():
    """The doubled key's budget: mega11 and mega8 keep their engine while
    it fits, else take mega12's route; mega7 routes like mega12; a
    byte-aligned request at a set it does not serve takes mega11 while the
    doubled key fits, as the JAX package does; N < 128 goes to mega13."""
    k2, shortint = PARAM_SETS["std128_k2"], PARAM_SETS["std128_shortint"]
    doubled = 2 * tsk.bt_key_bytes(k2)
    assert doubled == 768 * 2 * 4 * 6 * 128 * 1536  # 6.75 GiB
    for name in ("mega11", "mega8"):
        assert tsk.fit_engine(name, k2) == name
        assert tsk.fit_engine(name, shortint) == name  # 18 GiB fits 40
        assert tsk.fit_engine(name, k2, budget_bytes=doubled - 1) == "mega12"
        assert tsk.fit_engine(name, k2, budget_bytes=doubled // 2 - 1) \
            == "mega13"
        assert jsk.fit_engine(f"pallas_{name}", JAX_SETS["std128_k2"],
                              hbm_budget_bytes=doubled - 1) == "pallas_mega12"
        assert tsk.fit_engine(name, PARAM_SETS["toy"]) == "mega13"
    assert tsk.fit_engine("mega7", shortint) == "mega7"
    assert tsk.fit_engine("mega7", shortint, budget_bytes=8 << 30) == "mega13"
    # the keys of csrc/mega12.cu's two windows
    assert tsk.layouts_for_engine("mega7") == ("bsk_btk",)
    assert tsk.layouts_for_engine("mega11") == ("bsk_btk2",)
    assert tsk.fit_engine("mega16", shortint) == "mega11"
    assert tsk.fit_engine("mega16", shortint,
                          budget_bytes=10 << 30) == "mega12"
    k3 = dc.replace(TOY, name="toy_k3", n=8, N=256, k=3)
    for name in ENGINES:
        with pytest.raises(ValueError):
            tsk.fit_engine(name, port(k3))
