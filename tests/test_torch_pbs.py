"""The port's programmable bootstrapping and its rotation engine against the
JAX package, on the CPU: the ``bsk_btjj`` key layout and the ``mega12``
kernel's ``bsk_btk`` (the same bytes in ``wgmma``'s order), the plain
version of the ``mega12`` CUDA kernel (``blind_rotate_plain_btk``) against
the Pallas ``_mega12_kernel`` in interpret mode, the LUT test polynomials,
and ``pbs_batch`` / ``pbs_many_batch`` against the JAX package's.  Array
equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import PARAM_SETS as JAX_SETS
from herdsman_tpu.core import TEST_PBS, TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import pbs as jpbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import pbs as tpbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# HALF = 2 at N = 256 exercises the negated diagonal run and the descending
# digit packing, as tests/test_ops_bitexact.py:388 and :414 do; n is cut to
# 8 steps so that interpret-mode rotations stay fast
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)


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


@pytest.fixture(scope="module", params=[MULTITILE, MULTITILE_K2],
                ids=["k1", "k2"])
def geometry(request):
    params = request.param
    rng = np.random.default_rng(11)
    ck, sk = jref.keygen(params, rng)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_btjj",))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_btjj", "bsk_btk"),
                                 device="cpu")
    return params, rng, sk, jdsk, tdsk


def test_bsk_btjj_equals_jax_layout(geometry):
    params, _, sk, jdsk, tdsk = geometry
    assert tdsk.bsk_btjj.dtype == torch.int8
    np.testing.assert_array_equal(tdsk.bsk_btjj.numpy(),
                                  np.asarray(jdsk.bsk_btjj))
    assert tdsk.bsk_btjj.numel() == tsk.bt_key_bytes(tdsk.params)
    # the same blocks as bsk_bt, steps and rows swapped, columns limb-major
    bt = tsk.device_server_key(sk, layouts=("bsk_bt",), device="cpu").bsk_bt
    n, R, HALF, P, C = bt.shape
    kp1 = params.k + 1
    jcq = bt.reshape(n, R, HALF, P, kp1, 4, P).permute(0, 2, 1, 3, 5, 4, 6)
    assert torch.equal(jcq.reshape(n, HALF, R, P, C), tdsk.bsk_btjj)


def test_bsk_btk_is_bsk_btjj_reordered(geometry):
    """``mega12``'s key holds ``bsk_btjj``'s bytes: tile (i, m, r, c, q
    half) row 64j + q' is column (j, c, q) of block (i, m, r), K bytes in
    16-byte chunks at chunk ch ^ (row % 8) (the 128-byte swizzle)."""
    params, _, _, _, tdsk = geometry
    jj, btk = tdsk.bsk_btjj, tdsk.bsk_btk
    kp1 = params.k + 1
    n, HALF, R, P, C = jj.shape
    assert tuple(btk.shape) == mega12.key_shape(tdsk.params) \
        == (n, HALF, R, kp1, 2, 256, 128)
    assert btk.numel() == jj.numel() == tsk.bt_key_bytes(tdsk.params)
    assert torch.equal(mega12.from_kmajor_order(btk), jj)
    assert torch.equal(mega12.kmajor_order(jj, kp1), btk)
    rows = jj.reshape(n, HALF, R, P, 4, kp1, 2, 64).permute(
        0, 1, 2, 5, 6, 4, 7, 3).reshape(n, HALF, R, kp1, 2, 256, 8, 16)
    v = torch.arange(256) % 8
    ch = torch.arange(8)[None, :] ^ v[:, None]    # stored chunk -> chunk
    assert torch.equal(rows[..., torch.arange(256)[:, None], ch, :]
                       .reshape(btk.shape), btk)


@pytest.mark.parametrize("B", [1, 3])
def test_mega12_plain_equals_jax_pallas(geometry, B):
    params, rng, sk, jdsk, tdsk = geometry
    ct = rand_u32(rng, B, params.n + 1)
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine="pallas_mega12", unroll=True))
    before = mega12.mega12_blind_rotate.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine="mega12"))
    assert mega12.mega12_blind_rotate.launches == before  # no kernel on CPU
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[B - 1], jref.blind_rotate(sk, ct[B - 1],
                                      jref.make_test_poly(params)))


def test_mega12_plain_equals_mega13_with_many_lut_switch(geometry):
    """The coarse (many-LUT) mod switch feeds both rotation engines alike."""
    params, rng, sk, _, tdsk = geometry
    both = tsk.device_server_key(sk, layouts=("bsk_btS", "bsk_btk"),
                                 device="cpu")
    ct = from_numpy_u32(rand_u32(rng, 5, params.n + 1))
    tp = tbs.make_test_poly(both.params)
    outs = [tbs.blind_rotate_batch(both, ct, tp, engine=e, coarse_bits=1)
            for e in ("mega12", "mega13")]
    assert torch.equal(*outs)


def test_mega12_wrapper_checks(geometry):
    params, _, _, _, tdsk = geometry
    p = tdsk.params
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    key = tdsk.bsk_btk
    with pytest.raises(TypeError):
        mega12.mega12_blind_rotate(p, acc, a_t.long(), key)
    with pytest.raises(ValueError):
        mega12.mega12_blind_rotate(p, acc, a_t[:, :1].contiguous(), key)
    with pytest.raises(ValueError):
        mega12.mega12_blind_rotate(p, acc, a_t, key[:, :1])
    with pytest.raises(ValueError):
        mega12.mega12_blind_rotate(p, acc[:, :, ::2], a_t, key)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mega12.mega12_blind_rotate(p, acc, a_t, torch.zeros(
            key.numel() + 1, dtype=torch.int8)[1:].view(key.shape))
    for bad in (dc.replace(p, N=64), dc.replace(p, k=3),
                dc.replace(p, N=4096)):
        with pytest.raises(ValueError):
            mega12.check_params(bad)
    mega12.check_params(PARAM_SETS["std128_shortint"])
    # no shared-memory limit per ciphertext: the accumulators live in
    # device memory
    mega12.check_params(dc.replace(p, N=2048, k=4, bg_bits=1, levels=32))


def test_fit_engine_routes_mega12():
    """The integer tier names mega12 while its 9 GiB key fits the budget,
    else falls back to mega13 where that kernel takes the set."""
    shortint = PARAM_SETS["std128_shortint"]
    assert tsk.layouts_for_engine("mega12") == ("bsk_btk",)
    assert tsk.fit_engine("mega12", shortint) == "mega12"
    assert tsk.bt_key_bytes(shortint) == 768 * 6 * 8 * 128 * 2048  # 9 GiB
    assert tsk.fit_engine("mega12", shortint, budget_bytes=8 << 30) \
        == "mega13"
    assert tsk.fit_engine("mega12", TOY) == "mega13"  # N = 64 < 128
    k3 = dc.replace(TOY, name="toy_k3", n=8, N=256, k=3)
    with pytest.raises(ValueError):
        tsk.fit_engine("mega12", k3)
    # the mega13 routing is unchanged: it stays on mega13 at N = 2048
    assert tsk.fit_engine("mega13", shortint) == "mega13"


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_lut_polys_and_capacity_equal_jax(name):
    tp, jp = PARAM_SETS[name], JAX_SETS[name]
    for msg_bits in (1, 2, 4):
        if 2 * tp.N // (1 << (msg_bits + 1)) < 1:
            continue
        table = [(3 * m + 1) % (1 << msg_bits) for m in range(1 << msg_bits)]
        np.testing.assert_array_equal(
            to_numpy_u32(tpbs.lut_test_poly(tp, table, msg_bits)),
            np.asarray(jpbs.lut_test_poly(jp, table, msg_bits)))
        cap = tpbs.many_lut_capacity(tp, msg_bits)
        assert cap == jpbs.many_lut_capacity(jp, msg_bits)
        for k in (2, 4):
            if (2 * tp.N // k) // (1 << (msg_bits + 1)) < 1:
                continue
            tables = [[(m + j) % (1 << msg_bits) for m in range(1 << msg_bits)]
                      for j in range(k)]
            np.testing.assert_array_equal(
                to_numpy_u32(tpbs.lut_test_poly_many(tp, tables, msg_bits)),
                np.asarray(jpbs.lut_test_poly_many(jp, tables, msg_bits)))
    m = np.arange(16)
    np.testing.assert_array_equal(tpbs.encode(tp, m, 4),
                                  jpbs.encode(jp, m, 4))
    phase = rand_u32(np.random.default_rng(1), 64)
    np.testing.assert_array_equal(tpbs.decode(tp, phase, 4),
                                  jpbs.decode(jp, phase, 4))


@pytest.fixture(scope="module")
def pbs_keys():
    rng = np.random.default_rng(4321)
    ck, sk = jref.keygen(TEST_PBS, rng)
    return (ck, sk, rng, jsk.device_server_key(sk, layouts=("bsk_conv",)),
            tsk.device_server_key(sk, layouts=("bsk_btk",), device="cpu"))


@pytest.mark.parametrize("msg_bits,fn", [(2, lambda m: (m * m) % 4),
                                         (4, lambda m: (7 * m + 3) % 16)])
def test_pbs_batch_equals_jax(pbs_keys, msg_bits, fn):
    ck, sk, rng, jdsk, tdsk = pbs_keys
    table = [fn(m) for m in range(1 << msg_bits)]
    msgs = rng.integers(0, 1 << msg_bits, 9)
    ct = jref.lwe_encrypt_raw(ck, jpbs.encode(TEST_PBS, msgs, msg_bits), rng)
    want = np.asarray(jpbs.pbs_batch(jdsk, jnp.asarray(ct), table, msg_bits))
    got = to_numpy_u32(tpbs.pbs_batch(tdsk, ct, table, msg_bits,
                                      device="cpu"))
    np.testing.assert_array_equal(got, want)
    dec = tpbs.decode(tdsk.params, jref.lwe_phase(ck.lwe_key, got), msg_bits)
    np.testing.assert_array_equal(dec, [table[m] for m in msgs])


def test_pbs_many_batch_equals_jax(pbs_keys):
    """Two LUTs from one rotation at TEST_PBS (the coarse mod switch and the
    offset extracts), equal to the JAX package's and decoding right at the
    2-bit space, where the k = 2 window is still 32 indices wide."""
    ck, sk, rng, jdsk, tdsk = pbs_keys
    sq = [(m * m) % 4 for m in range(4)]
    inc = [(m + 1) % 4 for m in range(4)]
    msgs = rng.integers(0, 4, 7)
    ct = jref.lwe_encrypt_raw(ck, jpbs.encode(TEST_PBS, msgs, 2), rng)
    want = jpbs.pbs_many_batch(jdsk, jnp.asarray(ct), [sq, inc], 2)
    got = tpbs.pbs_many_batch(tdsk, ct, [sq, inc], 2, device="cpu")
    assert len(got) == 2
    for g, w, table in zip(got, want, (sq, inc)):
        np.testing.assert_array_equal(to_numpy_u32(g), np.asarray(w))
        dec = tpbs.decode(tdsk.params,
                          jref.lwe_phase(ck.lwe_key, to_numpy_u32(g)), 2)
        np.testing.assert_array_equal(dec, [table[m] for m in msgs])


def test_many_lut_n1024_equals_jax():
    """The many-LUT case of tests/test_radix.py:225-250 at N = 1024 (the
    4-bit working space, k = 2 LUTs per rotation)."""
    p = dc.replace(TEST_PBS, name="test_pbs_many", N=1024)
    rng = np.random.default_rng(7)
    ck, sk = jref.keygen(p, rng)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_conv",))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_btk",), device="cpu")
    assert tpbs.many_lut_capacity(tdsk.params, 4) == 2
    lo = [t % 4 for t in range(16)]
    hi = [t >> 2 for t in range(16)]
    msgs = rng.integers(0, 16, 4)
    ct = jref.lwe_encrypt_raw(ck, jpbs.encode(p, msgs, 4), rng)
    want = jpbs.pbs_many_batch(jdsk, jnp.asarray(ct), [lo, hi], 4)
    got = tpbs.pbs_many_batch(tdsk, ct, [lo, hi], 4, device="cpu")
    for g, w, table in zip(got, want, (lo, hi)):
        np.testing.assert_array_equal(to_numpy_u32(g), np.asarray(w))
        dec = tpbs.decode(tdsk.params,
                          jref.lwe_phase(ck.lwe_key, to_numpy_u32(g)), 4)
        np.testing.assert_array_equal(dec, [table[m] for m in msgs])
