"""The port's ``conv_i8`` engine against the JAX package's, on the CPU: the
``bsk_conv`` key layout, the engine's product ``_ep_conv_i8`` on random
digits and keys, ``blind_rotate_batch`` against the JAX engine and
``core.reference.blind_rotate``, the int32 wrap of the correlation's sums,
and the gate batch, the many-LUT programmable bootstrap and the routes on
``conv_i8``.  Array equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TEST_PBS, TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import gates as jgates
from herdsman_tpu.ops import pbs as jpbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import pbs as tpbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service.config import port_engine

TOY_K2 = dc.replace(TOY, name="toy_k2", n=8, k=2)
# TEST_PBS's gadget and N at 16 steps: the many-LUT window is 32 wide
PBS16 = dc.replace(TEST_PBS, name="test_pbs_n16", n=16)
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
    """(client key, server key, JAX key, port key) of a geometry."""
    p = GEOMETRIES[name]
    ck, sk = jref.keygen(p, np.random.default_rng(7))
    return (ck, sk, jsk.device_server_key(sk, layouts=("bsk_conv",)),
            tsk.device_server_key(sk, layouts=("bsk_conv",), device="cpu"))


@functools.cache
def jax_rotation(name):
    """The JAX conv_i8 rotation of 12 fresh ciphertexts, and them."""
    ck, _, jdsk, _ = keys(name)
    rng = np.random.default_rng(8)
    ct = jref.encrypt_bool(ck, rng.integers(0, 2, 12).astype(bool), rng)
    acc = jbs.blind_rotate_batch(jdsk, jnp.asarray(ct),
                                 jbs.make_test_poly(GEOMETRIES[name]),
                                 engine="conv_i8")
    return ct, np.asarray(acc)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_bsk_conv_equals_jax_layout(name):
    _, _, jdsk, tdsk = keys(name)
    p = GEOMETRIES[name]
    R = (p.k + 1) * p.levels
    assert tuple(tdsk.bsk_conv.shape) == (p.n, R, (p.k + 1) * 4, 2 * p.N - 1)
    assert tdsk.bsk_conv.dtype == torch.int8
    np.testing.assert_array_equal(tdsk.bsk_conv.numpy(),
                                  np.asarray(jdsk.bsk_conv))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_ep_conv_i8_equals_jax_on_random_inputs(name):
    p = GEOMETRIES[name]
    rng = np.random.default_rng(9)
    R = (p.k + 1) * p.levels
    half = 1 << (p.bg_bits - 1)
    digits = rng.integers(-half, half, (5, R, p.N), dtype=np.int32)
    w = rng.integers(-128, 128, (R, (p.k + 1) * 4, 2 * p.N - 1),
                     dtype=np.int8)
    want = np.asarray(jbs._ep_conv_i8(p, jnp.asarray(digits),
                                      jnp.asarray(w)))
    got = tbs._ep_conv_i8(port(p), torch.from_numpy(digits),
                          torch.from_numpy(w))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_blind_rotate_conv_i8_equals_jax_and_reference(name):
    ck, sk, _, tdsk = keys(name)
    p = GEOMETRIES[name]
    ct, want = jax_rotation(name)
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(port(p)),
        engine="conv_i8"))
    np.testing.assert_array_equal(got, want)
    for i in (0, 11):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i], jref.make_test_poly(p)))


def test_correlation_wraps_int32_as_xla():
    """Saturated digits against a key of -128s at R*N = 131200 rows: the
    sums reach 2^31 and wrap mod 2^32 as XLA's int32 accumulator does.
    The correlation takes them in two products (at most
    ``_CONV_EXACT_ROWS`` rows each, every sum exact) and wraps only in the
    int32 add of the two; the result equals an int64 computation mod 2^32
    and the JAX engine's convolution."""
    R, N, O = 4100, 32, 4
    assert R * N > tbs._CONV_EXACT_ROWS
    assert R * N * 128 * 128 > 1 << 31
    rng = np.random.default_rng(10)
    d = np.full((2, R, N), -128, np.int8)
    d[1] = np.where(rng.random((R, N)) < 0.02, 127, -128)
    w = np.full((R, O, 2 * N - 1), -128, np.int8)
    w[:, 1::2] = np.where(rng.random((R, O // 2, 2 * N - 1)) < 0.02,
                          127, -128)
    got = tbs.conv_i8_correlate(torch.from_numpy(d), torch.from_numpy(w))
    d64, w64 = d.astype(np.int64), w.astype(np.int64)
    want = np.stack([np.einsum("brm,rom->bo", d64,
                               w64[:, :, N - 1 - x:2 * N - 1 - x])
                     for x in range(N)], axis=-1)         # [2, O, N] int64
    assert want.max() >= 1 << 31                          # really wraps
    np.testing.assert_array_equal(
        got.numpy(), (want + (1 << 31)) % (1 << 32) - (1 << 31))
    xla = jax.lax.conv_general_dilated(
        jnp.asarray(d), jnp.asarray(w), window_strides=(1,),
        padding=[(N - 1, N - 1)], dimension_numbers=("NCH", "IOH", "NCH"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_gate_batch_on_conv_i8_equals_jax(name):
    ck, _, jdsk, tdsk = keys(name)
    p = GEOMETRIES[name]
    rng = np.random.default_rng(12)
    ids = np.arange(12) % len(jgates.GATE_COEFFS)
    b1, b2 = (rng.integers(0, 2, 12).astype(bool) for _ in range(2))
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    want = np.asarray(jgates.gate_batch(jdsk, jgates.GateBatch(
        jnp.asarray(ids, jnp.int32), jnp.asarray(c1), jnp.asarray(c2)),
        engine="conv_i8"))
    got = to_numpy_u32(tgates.gate_batch(
        tdsk, tgates.GateBatch(ids, c1, c2), engine="conv_i8", device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (12, p.n + 1)


def test_many_lut_pbs_on_conv_i8_equals_jax():
    """Two LUTs from one rotation (the coarse mod switch) on conv_i8."""
    rng = np.random.default_rng(13)
    ck, sk = jref.keygen(PBS16, rng)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_conv",))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_conv",), device="cpu")
    sq = [(m * m) % 4 for m in range(4)]
    inc = [(m + 1) % 4 for m in range(4)]
    msgs = rng.integers(0, 4, 7)
    ct = jref.lwe_encrypt_raw(ck, jpbs.encode(PBS16, msgs, 2), rng)
    want = jpbs.pbs_many_batch(jdsk, jnp.asarray(ct), [sq, inc], 2,
                               engine="conv_i8")
    got = tpbs.pbs_many_batch(tdsk, ct, [sq, inc], 2, engine="conv_i8",
                              device="cpu")
    for g, w, table in zip(got, want, (sq, inc)):
        np.testing.assert_array_equal(to_numpy_u32(g), np.asarray(w))
        dec = tpbs.decode(tdsk.params,
                          jref.lwe_phase(ck.lwe_key, to_numpy_u32(g)), 2)
        np.testing.assert_array_equal(dec, [table[m] for m in msgs])


def test_conv_i8_routes_and_config_name():
    """``conv_i8`` reads ``bsk_conv`` alone and passes ``fit_engine`` at
    every named set, as the JAX package's does; a config names it as it
    is."""
    assert tsk.layouts_for_engine("conv_i8") == ("bsk_conv",)
    assert tbs.ENGINES["conv_i8"] == (tbs._ep_conv_i8, "bsk_conv")
    for name, p in PARAM_SETS.items():
        assert tsk.fit_engine("conv_i8", p) == "conv_i8"
        assert jsk.fit_engine("conv_i8", jref_params(name)) == "conv_i8"
    assert port_engine("conv_i8") == "conv_i8"
    _, _, _, tdsk = keys("toy")
    assert tdsk.bsk_btS is None and tdsk.bsk is None


def jref_params(name):
    from herdsman_tpu.core import PARAM_SETS as JAX_SETS
    return JAX_SETS[name]
