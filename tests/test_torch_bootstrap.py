"""The port's blind rotation and bootstrap against the JAX package, on the
CPU: ``blind_rotate_batch(engine="mega13")`` (on a CPU tensor, the plain
PyTorch version of the CUDA kernel ``csrc/megaS.cu``) against JAX
``pallas_mega13`` in interpret mode, and ``gather_u32`` against JAX
``gather_u32``.  Array equality throughout.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops.server_key import device_server_key as jax_dsk
from herdsman_tpu.ops.server_key import layouts_for_engine
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops.kernels import mega13
from herdsman_tpu_torch.ops.server_key import device_server_key
from herdsman_tpu_torch.ops.server_key import layouts_for_engine as layouts_for
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# the B8L2 sets of tests/test_ops_bitexact.py: N = 512, k = 2 is the
# STD128_K2 tile geometry, cut to n = 8 steps
B8L2_SETS = [
    dc.replace(TOY, name="toy_b8l2_k1", n=8, N=256, k=1, bg_bits=8, levels=2),
    dc.replace(TOY, name="toy_b8l2_k2", n=8, N=256, k=2, bg_bits=8, levels=2),
    dc.replace(TOY, name="toy_b8l2_k2_n512", n=8, N=512, k=2, bg_bits=8,
               levels=2),
]


def rand_u32(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _rotate_both(params, B, seed):
    rng = np.random.default_rng(seed)
    _, sk = jref.keygen(params, rng)
    ct = rand_u32(rng, B, params.n + 1)
    jdsk = jax_dsk(sk, layouts=layouts_for_engine("pallas_mega13"))
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine="pallas_mega13", unroll=True))
    dsk = device_server_key(sk, device="cpu")
    before = mega13.mega13_blind_rotate.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        dsk, from_numpy_u32(ct), tbs.make_test_poly(dsk.params)))
    assert mega13.mega13_blind_rotate.launches == before  # no kernel on CPU
    return sk, ct, got, want


@pytest.mark.parametrize("params", B8L2_SETS, ids=[q.name for q in B8L2_SETS])
def test_mega13_equals_jax_pallas_mega13(params):
    sk, ct, got, want = _rotate_both(params, 3, 31)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[0], jref.blind_rotate(sk, ct[0], jref.make_test_poly(params)))


def test_mega13_equals_jax_pallas_mega13_b256():
    """B = 256: the JAX kernel's two 128-lane chunks, the port's 32 blocks."""
    sk, ct, got, want = _rotate_both(B8L2_SETS[0], 256, 33)
    np.testing.assert_array_equal(got, want)
    for i in (0, 37, 255):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i],
                                      jref.make_test_poly(B8L2_SETS[0])))


def test_mega13_wrapper_checks_arguments():
    params = B8L2_SETS[0]
    dsk = device_server_key(jref.keygen(params, np.random.default_rng(1))[1],
                            device="cpu")
    p = dsk.params
    acc0 = torch.zeros(4, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        mega13.mega13_blind_rotate(p, acc0.to(torch.int64), a_t, dsk.bsk)
    with pytest.raises(ValueError):
        mega13.mega13_blind_rotate(p, acc0, a_t[:, :3], dsk.bsk)
    with pytest.raises(ValueError):
        mega13.mega13_blind_rotate(p, acc0, a_t.T.contiguous().T, dsk.bsk)
    with pytest.raises(ValueError):
        mega13.check_params(dc.replace(p, N=4096))


@pytest.mark.parametrize("engine", ["mega13", "gather_u32"])
def test_bootstrap_bool_equals_jax(engine):
    rng = np.random.default_rng(42)
    ck, sk = jref.keygen(TOY, rng)
    bits = np.array([True, False, False, True])
    ct = jref.encrypt_bool(ck, bits, rng)
    want = np.asarray(jbs.bootstrap_bool_batch(
        jax_dsk(sk, layouts=("bsk_ext",)), jnp.asarray(ct),
        engine="gather_u32"))
    dsk = device_server_key(sk, layouts=layouts_for(engine),
                            device="cpu")
    got = to_numpy_u32(tbs.bootstrap_bool_batch(dsk, ct, engine=engine,
                                                device="cpu"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jref.lwe_decrypt_bool(ck, got), bits)
    np.testing.assert_array_equal(got[1], jref.bootstrap_bool(sk, ct[1]))


def test_bootstrap_raw_and_k2_full_bootstrap_decrypt():
    """The K2-geometry set end to end through the stages one by one."""
    params = B8L2_SETS[2]
    rng = np.random.default_rng(34)
    ck, sk = jref.keygen(params, rng)
    dsk = device_server_key(sk, device="cpu")
    bits = np.array([True, False, True, True])
    ct = jref.encrypt_bool(ck, bits, rng)
    raw = tbs.bootstrap_raw_batch(dsk, from_numpy_u32(ct),
                                  tbs.make_test_poly(dsk.params))
    got = to_numpy_u32(tbs.key_switch_batch(dsk, raw))
    for i in range(len(bits)):
        np.testing.assert_array_equal(got[i], jref.bootstrap_bool(sk, ct[i]))
    np.testing.assert_array_equal(jref.lwe_decrypt_bool(ck, got), bits)
