"""The port's ``mega14`` engine (``ops/kernels/megaT.py``, the plain version
of ``csrc/megaS.cu``'s extended-key instantiation) against the JAX package, on
the CPU: the plain rotation against the Pallas ``_mega14_kernel`` in
interpret mode and the NumPy reference, the extended key ``bsk_btTe``
against the JAX package's pt-major ``bsk_btT2`` windows, ``fit_engine``'s
``mega14`` route against the JAX package's at the port's key budget, the
wrapper's checks, and the eager ``HerdContext`` on ``mega14`` against the
JAX package's.  Array equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu import api as japi
from herdsman_tpu.core import PARAM_SETS as JAX_SETS
from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch import api as tapi
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import megaS, megaT
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# the JAX package's B8L2 sets (tests/test_ops_bitexact.py:447-455: N = 256
# at k = 1 and 2, and STD128_K2's N = 512, k = 2 tile geometry) and
# STD128_K4's k = 4, N = 256 (HALF = 2, PT = 1: the smallest geometry the
# kernel takes)
B8L2_SETS = [
    dc.replace(TOY, name="toy_b8l2_k1", n=8, N=256, k=1, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="toy_b8l2_k2", n=8, N=256, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="toy_b8l2_k2_n512", n=8, N=512, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="toy_b8l2_k4", n=8, N=256, k=4, bg_bits=8,
               levels=2),
]
IDS = [p.name for p in B8L2_SETS]


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
    """(server key, the JAX key with ``bsk_btT2``, the port's with
    ``bsk_btTe``)."""
    _, sk = jref.keygen(params, np.random.default_rng(31))
    return (sk, jsk.device_server_key(sk, layouts=("bsk_btT2",)),
            tsk.device_server_key(sk, layouts=("bsk_btTe",), device="cpu"))


@pytest.mark.parametrize("B", [3, 37])
@pytest.mark.parametrize("params", B8L2_SETS, ids=IDS)
def test_plain_rotation_equals_jax_pallas(params, B):
    sk, jdsk, tdsk = keys(params)
    rng = np.random.default_rng(B + params.k + params.N)
    ct = rand_u32(rng, B, params.n + 1)
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine="pallas_mega14", unroll=True))
    before = megaT.mega14_blind_rotate.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine="mega14"))
    assert megaT.mega14_blind_rotate.launches == before  # no kernel on CPU
    np.testing.assert_array_equal(got, want)
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i], jref.make_test_poly(params)))


@pytest.mark.parametrize("params", B8L2_SETS, ids=IDS)
def test_extended_key_equals_jax_btT2_windows(params):
    """Tile ct's rows of ``bsk_btTe`` (``ext_tile_rows``) are the JAX
    package's ``bsk_btT2`` window at (HALF-1-ct)*(k+1)*4P, its columns (pt,
    c_in, w, b) read as the port's stream byte 2z + b%2 of c_in, z = pt*P +
    w + (b//2)*N/2 (the pair packing of ``mega.py:1049-1052``)."""
    sk, jdsk, tdsk = keys(params)
    p = tdsk.params
    P, kp1, n = megaT.P, p.k + 1, p.n
    HALF, PT = p.N // P, p.N // (2 * P)
    key = tdsk.bsk_btTe
    assert key.dtype == torch.int8
    assert tuple(key.shape) == (n, kp1, kp1, 4, megaT.row_bytes(p, True))
    assert key.numel() == megaT.key_bytes(p, extended=True)
    btT2 = np.asarray(jdsk.bsk_btT2)                   # [n, C4P, KEXT]
    pt, c, w, b = np.ix_(range(PT), range(kp1), range(P), range(4))
    z = pt * P + w + (b // 2) * (p.N // 2)
    for ct in range(HALF):
        o = (HALF - 1 - ct) * kp1 * 4 * P
        want = btT2[:, :, o:o + PT * kp1 * 4 * P].reshape(
            n, 4 * kp1 * P, PT, kp1, P, 4)
        rows = torch.stack([megaT.ext_tile_rows(p, key[i], ct)
                            for i in range(n)]).numpy()
        rows = rows.reshape(n, kp1, 4 * kp1 * P, p.N, 2)
        got = np.moveaxis(np.moveaxis(rows, 2, -1)[:, c, z, b % 2], -1, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"tile {ct}")
    # the extended sequence holds the compact one as its tail
    tc = tsk.stream_key_layout(p, from_numpy_u32(sk.bsk))
    L, U = p.levels, p.N + P - 1
    np.testing.assert_array_equal(
        key[..., L * (p.N - P):L * (p.N - P) + L * U].numpy(),
        tc[..., :L * U].numpy())


def test_fit_engine_mega14_route_equals_jax():
    """``mega14`` stays where the set has the bg = 2^8, l = 2 gadget and N
    >= 256 and its key fits, else takes ``mega16``'s route, as the JAX
    package routes ``pallas_mega14`` (``server_key.py:639-658``), on every
    named set at the port's budget; the extended key is 57-101 MB at the
    sets that keep it."""
    kept = set()
    for name, p in PARAM_SETS.items():
        want = jsk.fit_engine("pallas_mega14", JAX_SETS[name],
                              hbm_budget_bytes=tsk.KEY_BUDGET_BYTES)
        got = tsk.fit_engine("mega14", p)
        if p.N >= 128:  # below, the port's tile sends everything to mega13
            assert got == want.removeprefix("pallas_"), name
        if got == "mega14":
            kept.add(name)
            assert megaT.key_bytes(p, extended=True) < 110 * 10**6
    assert kept == {"std128_fast", "std128_k2", "std128_k4",
                    "std128_shortint_fast"}
    k4 = PARAM_SETS["std128_k4"]
    assert tsk.layouts_for_engine("mega14") == ("bsk_btTe",)
    assert tsk.fit_engine("mega14", k4) == "mega14"
    small = megaT.key_bytes(k4, extended=True) - 1
    assert small >= megaT.key_bytes(k4)  # the compact key still fits
    assert tsk.fit_engine("mega14", k4, budget_bytes=small) == "mega16"
    # N = 128 is below the kernel's N >= 2P: mega16's route, as in JAX
    n128 = dc.replace(k4, name="k4_n128", N=128)
    assert tsk.fit_engine("mega14", n128) == "mega16"
    assert jsk.fit_engine("pallas_mega14", dc.replace(
        JAX_SETS["std128_k4"], name="k4_n128", N=128)) == "pallas_mega16"


def test_mega14_bounds():
    """``utils.bounds``: mega14's work is mega13's at STD128_K2 (30.0018 ms
    at B=2048) and 2.06e13 MACs at STD128_K4 (20.8 ms), both bound by
    operations."""
    from herdsman_tpu_torch.utils import bounds

    (k2,) = [r for r in bounds.table() if "_mega14_kernel" in r[0]]
    (k4,) = [r for r in bounds.further_table() if "_mega14_kernel" in r[0]]
    assert k2[1:] == ("std128_k2", pytest.approx(30.0018, abs=1e-4),
                      "operations")
    assert k4[1:] == ("std128_k4", pytest.approx(20.8346, abs=1e-4),
                      "operations")
    ops, _ = bounds.rotation(PARAM_SETS["std128_k4"], 2048, 0)
    assert ops == 2 * 768 * 2048 * (10 * 256) * (5 * 4 * 256)


def test_mega14_wrapper_checks():
    p = port(B8L2_SETS[0])
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    key = torch.zeros(p.n, p.k + 1, p.k + 1, 4, megaT.row_bytes(p, True),
                      dtype=torch.int8)
    compact = torch.zeros(p.n, p.k + 1, p.k + 1, 4, megaT.row_bytes(p),
                          dtype=torch.int8)
    with pytest.raises(TypeError):
        megaT.mega14_blind_rotate(p, acc, a_t.long(), key)
    with pytest.raises(ValueError):
        megaT.mega14_blind_rotate(p, acc, a_t[:, :1].contiguous(), key)
    with pytest.raises(ValueError, match="bsk_btTe"):  # mega16's key
        megaT.mega14_blind_rotate(p, acc, a_t, compact)
    with pytest.raises(ValueError):  # mega14's key to mega16
        megaT.mega16_blind_rotate(p, acc, a_t, key)
    for bad in (dc.replace(p, N=128), dc.replace(p, k=3),
                dc.replace(p, levels=3), dc.replace(p, N=4096)):
        with pytest.raises(ValueError):
            megaT.check_params(bad, "mega14")
    for name in ("std128_k2", "std128_k4", "std128_fast",
                 "std128_shortint_fast"):
        megaT.check_params(PARAM_SETS[name], "mega14")
    # the extended key is the stream key of megaS.cu with a tile of N: its
    # sequences, 8208 bytes at N = 2048, are megaT's extended rows
    fast = PARAM_SETS["std128_shortint_fast"]
    assert megaS.geometry(fast.N, 2, True).RB == megaT.row_bytes(fast, True)
    assert megaS.key_shape(fast, True) == (768, 2, 2, 4, 8208)
    assert tbs.ROTATION_ENGINES["mega14"] == (megaT.mega14_blind_rotate,
                                              "bsk_btTe")


# STD128_K4's gadget and shape at toy noise and depth
K4_TOY = dc.replace(TOY, name="toy_k4", n=8, N=256, k=4, bg_bits=8, levels=2)


@pytest.fixture(scope="module")
def contexts():
    keys_k4 = jref.keygen(K4_TOY, np.random.default_rng(44))
    j = japi.HerdContext(K4_TOY, engine="conv_i8", keys=keys_k4, seed=6)
    t = tapi.HerdContext(port(K4_TOY), engine="mega14", keys=keys_k4, seed=6,
                         device="cpu")
    return j, t


def test_herd_context_on_mega14_equals_jax(contexts):
    """``HerdContext(..., engine="mega14")`` routes to ``mega14`` through
    ``fit_engine``, builds only ``bsk_btTe``, and its a + b and min at width
    4 equal the JAX context's on ``conv_i8`` with the same keys and seed."""
    j, t = contexts
    assert t.engine == "mega14"
    assert t.dsk.bsk_btTe is not None and t.dsk.bsk is None
    av, bv = [3, 9, 15, 0, 7], [5, 9, 1, 0, 12]
    ja, jb = j.encrypt(av, width=4), j.encrypt(bv, width=4)
    ta, tb = t.encrypt(av, width=4), t.encrypt(bv, width=4)
    np.testing.assert_array_equal(to_numpy_u32(ta.data), np.asarray(ja.data))
    before = megaT.mega14_blind_rotate.launches
    ts, tm = ta + tb, ta.min(tb)
    assert megaT.mega14_blind_rotate.launches == before
    np.testing.assert_array_equal(to_numpy_u32(ts.data),
                                  np.asarray((ja + jb).data))
    np.testing.assert_array_equal(to_numpy_u32(tm.data),
                                  np.asarray(ja.min(jb).data))
    assert t.decrypt(ts) == [(x + y) % 16 for x, y in zip(av, bv)]
    assert t.decrypt(tm) == [min(x, y) for x, y in zip(av, bv)]


def test_herd_context_on_conv_i8_equals_jax(contexts):
    """The port's ``HerdContext`` on ``conv_i8`` at STD128_K4's gadget and
    shape: a + b equal to a JAX context's (``conv_i8``) with the same keys
    and seed."""
    j, t = contexts
    c = tapi.HerdContext(port(K4_TOY), engine="conv_i8", keys=(t.ck, t.sk),
                         seed=6, device="cpu")
    assert c.engine == "conv_i8" and c.dsk.bsk_conv is not None
    jc = japi.HerdContext(K4_TOY, engine="conv_i8", keys=(t.ck, t.sk),
                          seed=6)
    av, bv = [3, 9, 15, 0, 7], [5, 9, 1, 0, 12]
    ja, jb = jc.encrypt(av, width=4), jc.encrypt(bv, width=4)
    ca, cb = c.encrypt(av, width=4), c.encrypt(bv, width=4)
    np.testing.assert_array_equal(to_numpy_u32(ca.data), np.asarray(ja.data))
    cs = ca + cb
    np.testing.assert_array_equal(to_numpy_u32(cs.data),
                                  np.asarray((ja + jb).data))
    assert c.decrypt(cs) == [(x + y) % 16 for x, y in zip(av, bv)]
