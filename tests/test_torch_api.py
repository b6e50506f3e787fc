"""The port's eager ``HerdContext`` / ``EncUint`` / ``EncBit`` against the
JAX package's, on the CPU at TOY: the same keys and seed give the same
ciphertexts, and add, lt, min, mul (and the bit ops and mux under them) are
array-equal to the JAX package's and decrypt right.  The JAX context pads
its gate batches to a power of two and the port's does not; each gate's
output is the same either way.
"""

import numpy as np
import pytest
import torch

from herdsman_tpu import api as japi
from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu_torch import api as tapi
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops.u32 import to_numpy_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(42)
    keys = jref.keygen(TOY, rng)
    j = japi.HerdContext(TOY, engine="conv_i8", keys=keys, seed=3)
    t = tapi.HerdContext(PARAM_SETS["toy"], keys=keys, seed=3, device="cpu")
    return j, t


def same(jx, tx):
    np.testing.assert_array_equal(to_numpy_u32(tx.data), np.asarray(jx.data))


def test_context_routes_mega13(pair):
    _, t = pair
    assert t.engine == "mega13" and t.dsk.bsk_btS is not None


def test_add_equals_jax(pair):
    j, t = pair
    av, bv = [3, 200, 255, 0], [5, 100, 1, 0]
    ja, jb = j.encrypt(av, width=8), j.encrypt(bv, width=8)
    ta, tb = t.encrypt(av, width=8), t.encrypt(bv, width=8)
    same(ja, ta)
    js, ts = ja + jb, ta + tb
    same(js, ts)
    assert t.decrypt(ts) == [(x + y) % 256 for x, y in zip(av, bv)]


def test_lt_and_min_equal_jax(pair):
    j, t = pair
    av, bv = [3, 200, 17], [5, 100, 17]
    ja, jb = j.encrypt(av, width=8), j.encrypt(bv, width=8)
    ta, tb = t.encrypt(av, width=8), t.encrypt(bv, width=8)
    jl, tl = ja.lt(jb), ta.lt(tb)
    same(jl, tl)
    assert t.decrypt(tl) == [x < y for x, y in zip(av, bv)]
    jm, tm = ja.min(jb), ta.min(tb)
    same(jm, tm)
    assert t.decrypt(tm) == [min(x, y) for x, y in zip(av, bv)]


def test_mul_and_bits_equal_jax(pair):
    j, t = pair
    av, bv = [3, 7, 15], [5, 3, 15]
    ja, jb = j.encrypt(av, width=4), j.encrypt(bv, width=4)
    ta, tb = t.encrypt(av, width=4), t.encrypt(bv, width=4)
    jp, tp = ja * jb, ta * tb
    same(jp, tp)
    assert t.decrypt(tp) == [(x * y) % 16 for x, y in zip(av, bv)]
    same(ja ^ jb, ta ^ tb)
    same(~ja, ~ta)
    jx, tx = j.encrypt_bits([True, False, True]), t.encrypt_bits(
        [True, False, True])
    same(jx, tx)
    same(jx.mux(ja, jb), tx.mux(ta, tb))
    assert t.decrypt(tx.mux(ta, tb)) == [3, 3, 15]
    assert t.decrypt(tx & tx) == [True, False, True]
