"""The port's ``mega`` and ``mega2`` engines (``ops/kernels/megaJ.py``:
``csrc/mega12.cu``'s single window on ``bsk_btk``), which replace the JAX
package's legacy Pallas kernels on the R-major ``bsk_bt``, on the CPU:

- each plain rotation against ``legacy.py::_mega_kernel`` and
  ``_mega2_kernel`` in interpret mode (run as the JAX package's own tests
  run them, once per kernel and set) and against the NumPy reference;
- the key maps: ``bsk_btj`` is ``bsk_bt`` with its two block axes swapped,
  and ``mega12.kmajor_from_bt`` of ``bsk_bt`` is the engines' ``bsk_btk``;
- the wrappers' checks and the gate path on both engines.

Array equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12, megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service.config import port_engine

# HALF = 2 at N = 256 moves the negated run, at k = 1 and k = 2; n is cut
# to 8 steps so that interpret-mode rotations stay fast
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
SETS = {"k1": MULTITILE, "k2": MULTITILE_K2}
NAMES = ["mega", "mega2"]
B = 37


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
    """(client key, server key, JAX key in ``bsk_bt``, port key in
    ``bsk_bt``, ``bsk_btj``, the engines' ``bsk_btk`` and the ``mega13``
    layout)."""
    ck, sk = jref.keygen(params, np.random.default_rng(31))
    return (ck, sk, jsk.device_server_key(sk, layouts=("bsk_bt",)),
            tsk.device_server_key(sk, layouts=("bsk_btS", "bsk_bt",
                                               "bsk_btj", "bsk_btk"),
                                  device="cpu"))


@functools.cache
def ciphertexts(params):
    return rand_u32(np.random.default_rng(params.k + 43), B, params.n + 1)


@functools.cache
def jax_rotation(name, set_id):
    """The JAX package's ``pallas_<name>`` rotation of ``ciphertexts``, in
    interpret mode: computed once per kernel and set."""
    params = SETS[set_id]
    return np.asarray(jbs.blind_rotate_batch(
        keys(params)[2], jnp.asarray(ciphertexts(params)),
        jbs.make_test_poly(params), engine=f"pallas_{name}", unroll=True))


@functools.cache
def port_rotation(name, set_id):
    params = SETS[set_id]
    tdsk = keys(params)[3]
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    before = kernel.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ciphertexts(params)),
        tbs.make_test_poly(tdsk.params), engine=name))
    assert kernel.launches == before  # no kernel on the CPU
    return got


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_rotation_equals_jax_legacy_pallas(set_id, name):
    np.testing.assert_array_equal(port_rotation(name, set_id),
                                  jax_rotation(name, set_id))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_rotation_equals_reference_and_mega13(set_id, name):
    params = SETS[set_id]
    sk, tdsk = keys(params)[1], keys(params)[3]
    ct = ciphertexts(params)
    got = port_rotation(name, set_id)
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i], jref.make_test_poly(params)))
    np.testing.assert_array_equal(got, to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine="mega13")))


@pytest.mark.parametrize("set_id", list(SETS))
def test_btj_is_bt_with_block_axes_swapped(set_id):
    """``block_toeplitz_layout`` builds ``bsk_btj`` and ``bsk_bt`` from one
    gather and limb order: the j-major key is the R-major one transposed,
    the port's ``bsk_bt`` is the JAX package's, and ``bsk_bt`` re-laid by
    ``kmajor_from_bt`` is the ``bsk_btk`` that ``mega`` reads."""
    params = SETS[set_id]
    _, _, jdsk, tdsk = keys(params)
    assert torch.equal(tdsk.bsk_btj, tdsk.bsk_bt.transpose(1, 2))
    np.testing.assert_array_equal(tdsk.bsk_bt.numpy(), np.asarray(jdsk.bsk_bt))
    assert torch.equal(mega12.kmajor_from_bt(tdsk.bsk_bt, params.k + 1),
                       tdsk.bsk_btk)
    assert tuple(tdsk.bsk_btk.shape) == megaJ.key_shape(params, "mega")


# --- the wrappers, the gate path and the engine names ----------------------

@pytest.mark.parametrize("name", NAMES)
def test_megaR_wrapper_checks(name):
    """Each wrapper's argument checks; both (``csrc/mega12.cu``) read
    ``bsk_btk``, refuse the JAX package's ``bsk_bt`` and run
    ``mega12.blind_rotate_plain_btk`` on the CPU."""
    _, _, _, tdsk = keys(MULTITILE_K2)
    p = tdsk.params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    key = getattr(tdsk, megaJ.KEY_LAYOUTS[name])
    with pytest.raises(TypeError):
        kernel(p, acc, a_t.long(), key)
    with pytest.raises(TypeError):
        kernel(p, acc, a_t, key.to(torch.int32))
    with pytest.raises(ValueError):
        kernel(p, acc, a_t[:, :1].contiguous(), key)
    with pytest.raises(ValueError):  # the JAX package's key for them
        kernel(p, acc, a_t, tdsk.bsk_bt)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(p, acc, a_t, key.transpose(-1, -2).contiguous().transpose(
            -1, -2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel(p, acc.to("meta"), a_t.to("meta"), key.to("meta"))
    for bad in (dc.replace(p, N=64), dc.replace(p, k=3),
                dc.replace(p, N=4096)):
        with pytest.raises(ValueError):
            megaJ.check_params(bad, name)
    for pset in ("std128_k2", "std128", "std128_fast", "std128_shortint",
                 "std128_k4", "std128_shortint_l4"):
        megaJ.check_params(PARAM_SETS[pset], name)
    assert tsk.layouts_for_engine(name) == ("bsk_btk",)
    assert tbs.ROTATION_ENGINES[name] == (kernel, "bsk_btk")
    assert megaJ.plain(name) is mega12.blind_rotate_plain_btk
    assert not megaJ.KERNELS[name]  # the single window
    assert port_engine(f"pallas_{name}") == name


@pytest.mark.parametrize("name", NAMES)
def test_gate_batch_on_mega_engines(name):
    """``gate_batch`` on each engine decrypts to the truth table and equals
    ``bt_fused``'s and ``mega13``'s outputs on the same key."""
    ck, _, _, tdsk = keys(MULTITILE_K2)
    rng = np.random.default_rng(47)
    n_gates = 12
    b1, b2 = (rng.integers(0, 2, n_gates).astype(bool) for _ in range(2))
    ids = np.arange(n_gates) % len(tgates.GATE_IDS)
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    batch = tgates.GateBatch(ids, c1, c2)
    got = to_numpy_u32(tgates.gate_batch(tdsk, batch, engine=name,
                                         device="cpu"))
    for other in ("bt_fused", "mega13"):
        np.testing.assert_array_equal(got, to_numpy_u32(tgates.gate_batch(
            tdsk, batch, engine=other, device="cpu")))
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    names = list(tgates.GATE_IDS)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got),
        [truth[names[g]][i] for i, g in enumerate(ids)])
