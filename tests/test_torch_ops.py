"""The port's parameters, reference, u32 carrier, polynomial, decomposition
and bootstrap-stage ops against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages; every
comparison is array equality (integer arithmetic mod 2^32, no tolerance).
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import params as jparams
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import decomp as jdecomp
from herdsman_tpu.ops import poly as jpoly
from herdsman_tpu.ops.server_key import device_server_key as jax_dsk
from herdsman_tpu_torch.core import params as tparams
from herdsman_tpu_torch.core import reference as tref
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import decomp as tdecomp
from herdsman_tpu_torch.ops import poly as tpoly
from herdsman_tpu_torch.ops import u32
from herdsman_tpu_torch.ops.server_key import bt_tile, device_server_key

CPU = "cpu"


def rand_u32(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def t(x):
    """numpy uint32 -> the port's int32 carrier on the CPU."""
    return u32.from_numpy_u32(x)


def n(x):
    """The port's carrier (or a JAX array) -> numpy uint32."""
    if isinstance(x, torch.Tensor):
        return u32.to_numpy_u32(x) if x.dtype == torch.int32 else x.numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def toy():
    """TOY keys from the JAX package's keygen, on both packages' devices."""
    rng = np.random.default_rng(42)
    ck, sk = jref.keygen(jparams.TOY, rng)
    return ck, sk, jax_dsk(sk, layouts=("bsk_ext",)), \
        device_server_key(sk, layouts=("bsk", "bsk_ext", "bsk_btS"),
                          device=CPU)


@pytest.mark.parametrize("name", sorted(jparams.PARAM_SETS))
def test_param_sets_equal_jax(name):
    assert sorted(tparams.PARAM_SETS) == sorted(jparams.PARAM_SETS)
    assert dc.asdict(tparams.PARAM_SETS[name]) == dc.asdict(
        jparams.PARAM_SETS[name])
    for prop in ("Bg", "ks_base", "kN", "two_N", "log2_2N"):
        assert getattr(tparams.PARAM_SETS[name], prop) == getattr(
            jparams.PARAM_SETS[name], prop)


def test_keygen_encrypt_equal_jax():
    """Same seed, same keys and ciphertexts: the port's NumPy reference is a
    copy of the JAX package's, draw for draw."""
    pj, pt = jparams.TOY, tparams.TOY
    ckj, skj = jref.keygen(pj, np.random.default_rng(3))
    ckt, skt = tref.keygen(pt, np.random.default_rng(3))
    for a, b in ((ckj.lwe_key, ckt.lwe_key), (ckj.glwe_key, ckt.glwe_key),
                 (skj.bsk, skt.bsk), (skj.ksk, skt.ksk)):
        np.testing.assert_array_equal(a, b)
    bits = np.array([True, False, True])
    ctj = jref.encrypt_bool(ckj, bits, np.random.default_rng(4))
    ctt = tref.encrypt_bool(ckt, bits, np.random.default_rng(4))
    np.testing.assert_array_equal(ctj, ctt)
    for i in range(3):
        out = tref.bootstrap_bool(skt, ctt[i])
        np.testing.assert_array_equal(out, jref.bootstrap_bool(skj, ctj[i]))
        assert tref.lwe_decrypt_bool(ckt, out) == bits[i]


def test_u32_carrier_roundtrip_and_srl():
    rng = np.random.default_rng(1)
    x = rand_u32(rng, 257)
    np.testing.assert_array_equal(n(t(x)), x)
    for s in (0, 1, 7, 16, 31):
        np.testing.assert_array_equal(n(u32.srl(t(x), s)), x >> np.uint32(s))
    y = rand_u32(rng, 257)
    np.testing.assert_array_equal(n(t(x) + t(y)), x + y)
    np.testing.assert_array_equal(n(t(x) - t(y)), x - y)
    np.testing.assert_array_equal(n(t(x) * t(y)), x * y)


def test_negacyclic_shift_and_monomial_mul():
    rng = np.random.default_rng(7)
    N = 64
    p = rand_u32(rng, 3, N)
    for s in [0, 1, 17, N - 1, N, N + 9, 2 * N - 1]:
        np.testing.assert_array_equal(
            n(tpoly.negacyclic_shift(t(p), s)),
            n(jpoly.negacyclic_shift(jnp.asarray(p), s)), err_msg=f"s={s}")
    q = rand_u32(rng, 16, N)
    r = rng.integers(0, 2 * N, 16)
    np.testing.assert_array_equal(
        n(tpoly.negacyclic_monomial_mul(t(q), torch.as_tensor(r))),
        n(jpoly.negacyclic_monomial_mul(jnp.asarray(q), jnp.asarray(r))))


def test_i8_limbs_and_extend_equal_jax():
    rng = np.random.default_rng(9)
    x = rand_u32(rng, 1000)
    limbs = tpoly.to_i8_limbs(t(x))
    assert limbs.dtype == torch.int8
    np.testing.assert_array_equal(n(limbs), n(jpoly.to_i8_limbs(jnp.asarray(x))))
    np.testing.assert_array_equal(
        n(tpoly.from_i32_limb_partials(limbs.to(torch.int32))), x)
    p = rand_u32(rng, 2, 32)
    np.testing.assert_array_equal(n(tpoly.negacyclic_extend(t(p))),
                                  n(jpoly.negacyclic_extend(jnp.asarray(p))))


def test_toeplitz_polymul_equal_jax():
    rng = np.random.default_rng(11)
    N = 64
    a = rand_u32(rng, 2, N)
    b = rand_u32(rng, 2, N)
    np.testing.assert_array_equal(
        n(tpoly.negacyclic_toeplitz(t(b))),
        n(jpoly.negacyclic_toeplitz(jnp.asarray(b))))
    got = n(tpoly.negacyclic_polymul(t(a), t(b)))
    np.testing.assert_array_equal(
        got, n(jpoly.negacyclic_polymul(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, jref.negacyclic_polymul(a, b))


@pytest.mark.parametrize("bits,levels", [(6, 3), (7, 3), (8, 2), (4, 8),
                                         (8, 4), (3, 5)])
def test_decompose_equal_jax(bits, levels):
    rng = np.random.default_rng(10)
    x = rand_u32(rng, 500)
    np.testing.assert_array_equal(  # digits are signed int32, not u32
        tdecomp.signed_decompose(t(x), bits, levels).numpy(),
        np.asarray(jdecomp.signed_decompose(jnp.asarray(x), bits, levels)))
    np.testing.assert_array_equal(
        tdecomp.unsigned_decompose(t(x), bits, levels).numpy(),
        np.asarray(jdecomp.unsigned_decompose(jnp.asarray(x), bits, levels)))


@pytest.mark.parametrize("coarse_bits", [0, 1, 2])
def test_mod_switch_equal_jax(coarse_bits):
    p = jparams.STD128_K2
    rng = np.random.default_rng(12)
    ct = rand_u32(rng, 5, p.n + 1)
    got = n(tbs.mod_switch_2N(tparams.STD128_K2, t(ct), coarse_bits))
    np.testing.assert_array_equal(
        got, n(jbs.mod_switch_2N(p, jnp.asarray(ct), coarse_bits)))
    if coarse_bits == 0:
        np.testing.assert_array_equal(got, jref.mod_switch_2N(p, ct))


@pytest.mark.parametrize("offset", [0, 1, 7, 32, 63])
def test_sample_extract_equal_jax(offset):
    p = tparams.TOY
    rng = np.random.default_rng(13)
    acc = rand_u32(rng, 3, p.k + 1, p.N)
    got = n(tbs.sample_extract_batch(p, t(acc), offset=offset))
    np.testing.assert_array_equal(got, n(jbs.sample_extract_batch(
        jparams.TOY, jnp.asarray(acc), offset=offset)))
    np.testing.assert_array_equal(got[1],
                                  tref.sample_extract(p, acc[1], offset))


def test_server_key_carried_across(toy):
    _, sk, jdsk, dsk = toy
    p = tparams.TOY
    assert dsk.params == p and dsk.device == torch.device("cpu")
    np.testing.assert_array_equal(n(dsk.bsk), sk.bsk)
    np.testing.assert_array_equal(n(dsk.bsk_ext), n(jdsk.bsk_ext))
    cols = (p.n + 1) * 4
    assert dsk.ksk_limbs.shape == (p.kN * p.ks_levels, -(-cols // 8) * 8)
    np.testing.assert_array_equal(n(dsk.ksk_limbs[:, :cols]),
                                  n(jdsk.ksk_limbs))
    assert not dsk.ksk_limbs[:, cols:].any()
    assert bt_tile(tparams.STD128_K2) == (128, 4)


def test_key_switch_equal_jax(toy):
    _, sk, jdsk, dsk = toy
    rng = np.random.default_rng(14)
    ct = rand_u32(rng, 3, tparams.TOY.kN + 1)
    got = n(tbs.key_switch_batch(dsk, t(ct)))
    np.testing.assert_array_equal(got, n(jbs.key_switch_batch(
        jdsk, jnp.asarray(ct))))
    for i in range(3):
        np.testing.assert_array_equal(got[i], jref.key_switch(sk, ct[i]))


def test_int8_matmul_pads_rows_exactly():
    from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul

    g = torch.Generator().manual_seed(0)
    for M in (1, 5, 17, 40):
        a = torch.randint(-128, 128, (M, 64), dtype=torch.int8, generator=g)
        b = torch.randint(-128, 128, (64, 24), dtype=torch.int8, generator=g)
        got = int8_matmul(a, b)
        assert got.dtype == torch.int32 and got.shape == (M, 24)
        assert torch.equal(got, a.to(torch.int32) @ b.to(torch.int32))
