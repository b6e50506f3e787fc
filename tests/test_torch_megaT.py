"""The port's byte-aligned rotation engines (``mega16``, ``mega17``,
``mega15``: ``ops/kernels/megaT.py``, the plain versions of ``csrc/megaS.cu``'s
byte-aligned entries)
against the JAX package, on the CPU: the compact ``bsk_btTc`` key's expansion
against the JAX package's single-width layouts, each plain rotation against
the Pallas ``_mega16/17/15_kernel`` in interpret mode and the NumPy
reference, the digit packer against the bytes of the Pallas kernels'
``compute_stream``, ``fit_engine``'s routing, and the integer tier and gate
path on these engines against the JAX package's.  Array equality
throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu import shortint as jshort
from herdsman_tpu.core import PARAM_SETS as JAX_SETS
from herdsman_tpu.core import TEST_PBS, TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import gates as jgates
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu.ops.pallas import mega as jmega
from herdsman_tpu_torch import shortint as tshort
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import megaS, megaT
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# kernel -> (its levels, the JAX package's engine and key layout)
ENGINES = {"mega16": (2, "pallas_mega16", "bsk_btTs"),
           "mega17": (3, "pallas_mega17", "bsk_btT3"),
           "mega15": (4, "pallas_mega15", "bsk_btT4")}


def sets(L: int) -> list:
    """The JAX package's B8L2 / B8L3 / B8L4 geometries
    (tests/test_ops_bitexact.py:447-583): n = 8, N = 256 (HALF = 2, the
    wrap split moves) at k = 1 and 2, and N = 512 (HALF = 4)."""
    N3, k3 = (512, 2) if L == 2 else (512, 1)
    return [dc.replace(TOY, name=f"toy_b8l{L}_k1", n=8, N=256, k=1,
                       bg_bits=8, levels=L),
            dc.replace(TOY, name=f"toy_b8l{L}_k2", n=8, N=256, k=2,
                       bg_bits=8, levels=L),
            dc.replace(TOY, name=f"toy_b8l{L}_k{k3}_n{N3}", n=8, N=N3,
                       k=k3, bg_bits=8, levels=L)]


def port(p) -> TFHEParams:
    """The port's TFHEParams for the JAX package's."""
    return TFHEParams(**dc.asdict(p))


ALL_SETS = [(name, p) for name, (L, _, _) in ENGINES.items()
            for p in sets(L)]


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


@pytest.fixture(scope="module")
def keys():
    """(host keys, JAX key, port key) per parameter set, made once."""
    cache = {}

    def get(name, params):
        if params.name not in cache:
            rng = np.random.default_rng(31 + params.levels)
            ck, sk = jref.keygen(params, rng)
            jdsk = jsk.device_server_key(sk, layouts=(ENGINES[name][2],))
            tdsk = tsk.device_server_key(sk, layouts=("bsk_btTc",),
                                         device="cpu")
            cache[params.name] = (ck, sk, jdsk, tdsk)
        return cache[params.name]
    return get


@pytest.mark.parametrize("name,params", ALL_SETS,
                         ids=[p.name for _, p in ALL_SETS])
def test_bsk_btTc_expands_to_jax_layout(keys, name, params):
    _, _, jdsk, tdsk = keys(name, params)
    key = tdsk.bsk_btTc
    assert key.dtype == torch.int8 and key.numel() == megaT.key_bytes(params)
    want = np.asarray(getattr(jdsk, ENGINES[name][2]))
    np.testing.assert_array_equal(megaT.expand_key(tdsk.params, key).numpy(),
                                  want)
    # the padding after L*(N+P-1) bytes is zeros
    assert not key[..., params.levels * (params.N + 127):].any()


@pytest.mark.parametrize("B", [3, 37])
@pytest.mark.parametrize("name,params",
                         [(name, sets(L)[i]) for name, (L, _, _)
                          in ENGINES.items() for i in (0, 1)],
                         ids=[f"{name}-k{k}" for name in ENGINES
                              for k in (1, 2)])
def test_plain_rotation_equals_jax_pallas(keys, name, params, B):
    _, sk, jdsk, tdsk = keys(name, params)
    kernel = getattr(megaT, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + params.k)
    ct = rand_u32(rng, B, params.n + 1)
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine=ENGINES[name][1], unroll=True))
    before = kernel.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine=name))
    assert kernel.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[B - 1], jref.blind_rotate(sk, ct[B - 1],
                                      jref.make_test_poly(params)))


# differences whose rounded value plus the balanced offset carries past bit
# W-1 (top bits at or near 0x7F..), the extremes, and small values
SPECIAL_DIFFS = [0x00000000, 0x00000001, 0x0000007F, 0x00000080, 0x7F7F7F7F,
                 0x7F800000, 0x7FFF8000, 0x7FFFFF80, 0x7FFFFFFF, 0x80000000,
                 0x80808080, 0xFF800000, 0xFFFF8000, 0xFFFFFF80, 0xFFFFFFFF,
                 0x7F7FFF80, 0x7FFF7F80, 0x807F7F80]


@pytest.mark.parametrize("name", list(ENGINES))
def test_pack_stream_equals_jax_compute_stream(name):
    """The JAX kernel's digit stream, read back through a probe key: one
    step at rotation amount 1 turns chosen differences d into the stream,
    and a key row (limb 0, c_out = c_in, q) holding one 1 at stream column
    q + m*P adds byte L*ct*P + m*P + q of the stream to output coefficient
    ct*P + q.  L runs (m = 0..L-1) read every byte."""
    L, engine, _ = ENGINES[name]
    p = dc.replace(TOY, name=f"toy_b8l{L}_probe", n=1, N=256, k=1,
                   bg_bits=8, levels=L)
    P, HALF, kp1, B = 128, p.N // 128, p.k + 1, 3
    rng = np.random.default_rng(L)
    d = rand_u32(rng, B, kp1, p.N)
    d[0, 0, 1:1 + len(SPECIAL_DIFFS)] = SPECIAL_DIFFS
    d[1, 1, -len(SPECIAL_DIFFS):] = SPECIAL_DIFFS
    # X^1 acc - acc = d at every coefficient but 0: acc[y] = acc[y-1] - d[y]
    acc = np.empty_like(d)
    acc[..., 0] = rand_u32(rng, B, kp1)
    for y in range(1, p.N):
        acc[..., y] = acc[..., y - 1] - d[..., y]
    a_t = np.ones((1, B), dtype=np.int32)
    rows = np.arange(P)
    stream = np.empty((B, kp1, L * p.N), dtype=np.int8)
    fn = getattr(jmega, f"{name}_blind_rotate")
    for m in range(L):
        key = np.zeros((1, kp1, 4 * kp1 * P, L * p.N), dtype=np.int8)
        for c in range(kp1):
            key[0, c, c * P + rows, m * P + rows] = 1
        out = np.asarray(fn(p, jnp.asarray(acc), jnp.asarray(a_t),
                            jnp.asarray(key)))
        got = (out - acc).view(np.int32).reshape(B, kp1, HALF, P)
        for ct in range(HALF):
            s0 = L * ct * P + m * P
            stream[..., s0:s0 + P] = got[:, :, ct, :]
    acc_t = from_numpy_u32(acc)
    diff = poly.negacyclic_monomial_mul(acc_t, torch.ones(B, 1,
                                                          dtype=torch.int32))
    np.testing.assert_array_equal(to_numpy_u32(diff - acc_t)[..., 1:],
                                  d[..., 1:])
    packed = megaT.pack_stream(port(p), diff - acc_t)
    np.testing.assert_array_equal(packed.numpy(), stream)


@pytest.mark.parametrize("name", list(ENGINES))
def test_fit_engine_routes_byte_aligned(name):
    """Each engine at its own set, at a foreign set and over budget, beside
    the JAX package's routing at the port's 40 GiB budget: at a foreign set
    both take mega11, whose doubled key fits."""
    L, jengine, _ = ENGINES[name]
    own = {2: "std128_shortint_fast", 3: "std128_shortint_b8",
           4: "std128_shortint_l4"}[L]
    p = PARAM_SETS[own]
    assert tsk.layouts_for_engine(name) == ("bsk_btTc",)
    assert tsk.fit_engine(name, p) == name
    assert jsk.fit_engine(jengine, JAX_SETS[own],
                          hbm_budget_bytes=40 << 30) == jengine
    # 60 to 110 MB: the compact key, against 6.0 to 12.0 GiB expanded
    assert megaT.key_bytes(p) < (1 << 27)
    assert megaT.key_bytes(p) * 64 < jsk_bytes(p, L)
    foreign = "std128_shortint" if L != 3 else "std128_shortint_fast"
    assert tsk.fit_engine(name, PARAM_SETS[foreign]) == "mega11"
    assert jsk.fit_engine(jengine, JAX_SETS[foreign],
                          hbm_budget_bytes=40 << 30) == "pallas_mega11"
    # over budget: mega12's key does not fit either, so mega13 serves
    assert tsk.fit_engine(name, p, budget_bytes=1 << 20) == "mega13"
    k3 = dc.replace(TOY, name="toy_k3", n=8, N=256, k=3, bg_bits=8,
                    levels=L)
    with pytest.raises(ValueError):
        tsk.fit_engine(name, k3)


def jsk_bytes(p, L: int) -> int:
    """Bytes of the JAX package's single-width key at ``p``."""
    return p.n * (p.k + 1) ** 2 * 4 * 128 * L * p.N


def test_fit_engine_keeps_mega13_at_shortint_fast():
    """The documented divergence: the port's mega13 reads the raw key, so
    it stays on mega13 at STD128_SHORTINT_FAST, where the JAX package at
    its default 12 GiB budget moves pallas_mega13 to pallas_mega16 (at 40
    GiB it keeps it: tests/test_torch_megaJ.py)."""
    fast = PARAM_SETS["std128_shortint_fast"]
    assert tsk.fit_engine("mega13", fast) == "mega13"
    assert jsk.fit_engine("pallas_mega13", JAX_SETS["std128_shortint_fast"]) \
        == "pallas_mega16"


@pytest.mark.parametrize("budget_gib", [40, 12, 8, 4])
def test_mega16_routes_at_every_budget(budget_gib):
    """``mega16`` on ``csrc/megaS.cu`` routes as it did on the dp4a
    kernel, whose shared-memory check no named set reached: kept at the
    sets of its gadget (bg = 2^8, levels 2), whose ``bsk_btTc`` fits every
    budget here; elsewhere ``mega11``'s route (``mega13`` at TOY's N <
    128)."""
    budget = budget_gib * (1 << 30)
    own = {"std128_fast", "std128_k2", "std128_k4", "std128_shortint_fast"}
    for pset, p in PARAM_SETS.items():
        got = tsk.fit_engine("mega16", p, budget_bytes=budget)
        if pset in own:
            assert got == "mega16", pset
        else:
            assert got == tsk.fit_engine("mega11", p, budget_bytes=budget)
    assert tsk.layouts_for_engine("mega16") == ("bsk_btTc",)


def test_megaT_wrapper_checks():
    p = sets(3)[0]
    tp = port(p)
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    key = torch.zeros(p.n, p.k + 1, p.k + 1, 4, megaT.row_bytes(tp),
                      dtype=torch.int8)
    with pytest.raises(TypeError):
        megaT.mega17_blind_rotate(tp, acc, a_t.long(), key)
    with pytest.raises(ValueError):
        megaT.mega17_blind_rotate(tp, acc, a_t[:, :1].contiguous(), key)
    with pytest.raises(ValueError):
        megaT.mega17_blind_rotate(tp, acc, a_t, key[..., :-16])
    with pytest.raises(ValueError):
        megaT.mega17_blind_rotate(tp, acc[:, :, ::2], a_t, key)
    with pytest.raises(ValueError):  # the levels of another kernel
        megaT.mega16_blind_rotate(tp, acc, a_t, key)
    for bad in (dc.replace(tp, N=64), dc.replace(tp, k=3),
                dc.replace(tp, bg_bits=7)):
        with pytest.raises(ValueError):
            megaT.check_params(bad, "mega17")
    with pytest.raises(ValueError):
        tsk.stream_key_layout(PARAM_SETS["std128_shortint"],
                              torch.zeros(1, 6, 2, 2048, dtype=torch.int32))
    for name, pset in (("mega16", "std128_shortint_fast"),
                       ("mega17", "std128_shortint_b8"),
                       ("mega15", "std128_shortint_l4")):
        megaT.check_params(PARAM_SETS[pset], name)
        # bsk_btTc's column tile is 128: N from 128 to 2048; k+1 in (2, 3,
        # 5); the kernel's own levels
        p = PARAM_SETS[pset]
        megaT.check_params(dc.replace(p, N=128), name)
        for bad in (dc.replace(p, N=64), dc.replace(p, N=4096),
                    dc.replace(p, k=3),
                    dc.replace(p, levels=p.levels % 3 + 2)):
            with pytest.raises(ValueError):
                megaT.check_params(bad, name)
    # every wrapper runs csrc/megaS.cu through an entry that fixes its
    # gadget; the plain version of the compact-key ones is one function
    for name, L in megaT.KERNELS.items():
        assert megaS.GADGET[name] == (8, L)
        assert megaT.plain(name) is (megaT.blind_rotate_plain_btTe
                                     if name in megaT.EXTENDED
                                     else megaT.blind_rotate_plain_btTc)


@pytest.fixture(scope="module", params=[3, 4], ids=["mega17", "mega15"])
def short_pair(request):
    """(JAX context, port context) on the same keys and seed at a TEST_PBS
    set with the byte-aligned gadget of levels 3 or 4."""
    L = request.param
    name = {3: "mega17", 4: "mega15"}[L]
    p = dc.replace(TEST_PBS, name=f"test_pbs_b8l{L}", bg_bits=8, levels=L)
    keys = jref.keygen(p, np.random.default_rng(4321))
    j = jshort.ShortContext(p, msg_bits=2, carry_bits=2, keys=keys, seed=5,
                            engine=f"pallas_{name}")
    t = tshort.ShortContext(port(p),
                            msg_bits=2, carry_bits=2, keys=keys, seed=5,
                            engine=name, device="cpu")
    return name, j, t


def test_shortint_mul_add_equals_jax(short_pair):
    name, j, t = short_pair
    assert j.engine == f"pallas_{name}" and t.engine == name
    assert t.dsk.bsk_btTc is not None and t.dsk.bsk_btjj is None
    av, bv = [0, 1, 2, 3, 3, 1], [3, 1, 2, 2, 0, 3]
    ja, jb = j.encrypt(av), j.encrypt(bv)
    ta, tb = t.encrypt(av), t.encrypt(bv)
    np.testing.assert_array_equal(to_numpy_u32(ta.data), np.asarray(ja.data))
    jr, tr = ((ja * jb) + ja).reduce(), ((ta * tb) + ta).reduce()
    np.testing.assert_array_equal(to_numpy_u32(tr.data), np.asarray(jr.data))
    assert t.rotations == j.rotations
    assert t.decrypt(tr) == [(a * b + a) % 4 for a, b in zip(av, bv)]


def test_gate_batch_on_mega16_equals_jax():
    params = sets(2)[2]  # toy_b8l2_k2_n512, the STD128_K2 tile geometry
    rng = np.random.default_rng(35)
    ck, sk = jref.keygen(params, rng)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_btTs",))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_btTc",), device="cpu")
    B = 12
    b1, b2 = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(
        bool)
    ids = np.arange(B) % len(tgates.GATE_IDS)
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    want = np.asarray(jgates.gate_batch(
        jdsk, jgates.GateBatch(jnp.asarray(ids, dtype=jnp.int32),
                               jnp.asarray(c1), jnp.asarray(c2)),
        engine="pallas_mega16"))
    before = megaT.mega16_blind_rotate.launches
    got = to_numpy_u32(tgates.gate_batch(tdsk, tgates.GateBatch(ids, c1, c2),
                                         engine="mega16", device="cpu"))
    assert megaT.mega16_blind_rotate.launches == before
    np.testing.assert_array_equal(got, want)
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    names = list(tgates.GATE_IDS)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got),
        [truth[names[g]][i] for i, g in enumerate(ids)])
