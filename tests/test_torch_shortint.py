"""The port's ``ShortContext`` / ``EncShort`` against the JAX package's, on
the CPU at TEST_PBS: the same keys and seed give the same ciphertexts, every
operation's output is array-equal to the JAX package's (the JAX package on
its default ``conv_i8`` engine, the port on ``mega12``'s plain version, and
on ``conv_i8``), and decrypts right.
"""

import numpy as np
import pytest
import torch

from herdsman_tpu import shortint as jshort
from herdsman_tpu.core import TEST_PBS
from herdsman_tpu.core import reference as jref
from herdsman_tpu_torch import shortint as tshort
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.mesh import make_mesh
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
    """(JAX context, port context) on the same keys and seed."""
    rng = np.random.default_rng(4321)
    keys = jref.keygen(TEST_PBS, rng)
    j = jshort.ShortContext(TEST_PBS, msg_bits=2, carry_bits=2, keys=keys,
                            seed=5)
    t = tshort.ShortContext(PARAM_SETS["test_pbs"], msg_bits=2, carry_bits=2,
                            keys=keys, seed=5, device="cpu")
    return j, t


def same(jx, tx):
    """The two EncShorts hold equal ciphertexts and bookkeeping."""
    np.testing.assert_array_equal(to_numpy_u32(tx.data), np.asarray(jx.data))
    assert (tx.max_val, tx.noise_level) == (jx.max_val, jx.noise_level)


def test_context_routes_mega12_and_encrypts_like_jax(pair):
    j, t = pair
    assert t.engine == "mega12" and t.dsk.bsk_btk is not None
    assert t.dsk.device.type == "cpu"
    assert (t.many_lut, t.max_noise) == (j.many_lut, j.max_noise)
    vals = [0, 1, 2, 3, 7]
    same(j.encrypt(vals), t.encrypt(vals))
    same(j.trivial(2, batch=3), t.trivial(2, batch=3))
    assert t.decrypt(t.trivial([1, 3])) == [1, 3]


def test_add_chain_equals_jax(pair):
    j, t = pair
    av, bv = [1, 2, 3, 0], [3, 3, 2, 1]
    ja, jb = j.encrypt(av), j.encrypt(bv)
    ta, tb = t.encrypt(av), t.encrypt(bv)
    same(ja + jb, ta + tb)
    jt, tt = ja, ta
    for _ in range(5):  # crosses the carry space and reduces
        jt, tt = jt + jb, tt + tb
        same(jt, tt)
    assert t.decrypt(tt) == [(x + 5 * y) % 4 for x, y in zip(av, bv)]
    assert t.decrypt(tt) == j.decrypt(jt)


def test_scalar_mul_and_apply_lut_equal_jax(pair):
    j, t = pair
    av = [0, 1, 2, 3]
    ja, ta = j.encrypt(av), t.encrypt(av)
    same(ja.scalar_mul(3), ta.scalar_mul(3))
    same(ja.scalar_mul(0), ta.scalar_mul(0))
    assert t.decrypt(ta.scalar_mul(3)) == [(3 * x) % 4 for x in av]
    jsq, tsq = ja.apply_lut(lambda v: v * v), ta.apply_lut(lambda v: v * v)
    same(jsq, tsq)
    assert t.decrypt(tsq) == [(x * x) % 4 for x in av]


def test_mul_and_mixed_expression_equal_jax(pair):
    j, t = pair
    av, bv = [0, 1, 2, 3, 3], [3, 3, 3, 3, 2]
    ja, jb = j.encrypt(av), j.encrypt(bv)
    ta, tb = t.encrypt(av), t.encrypt(bv)
    j0, t0 = j.rotations, t.rotations
    same(ja * jb, ta * tb)
    assert t.rotations - t0 == 5  # one packed bivariate PBS
    jr = (ja * jb) + ja.scalar_mul(2)
    tr = (ta * tb) + ta.scalar_mul(2)
    same(jr, tr)
    assert t.rotations - t0 == j.rotations - j0
    assert t.decrypt(tr) == [(x * y + 2 * x) % 4 for x, y in zip(av, bv)]


def test_bool_only_and_mesh_refused(pair):
    with pytest.raises(ValueError, match="bool-gate-only"):
        tshort.ShortContext(PARAM_SETS["std128_shortint_fast"], device="cpu")
    _, t = pair
    # a mesh is accepted: the context places its key on it once
    mesh = make_mesh(2, device="cpu")
    short = tshort.ShortContext(t.params, keys=(t.ck, t.sk), dsk=t.dsk,
                                mesh=mesh, device="cpu")
    assert short.mesh is mesh and short._mesh_key.source is t.dsk
    with pytest.raises(ValueError):  # a key on another device
        tshort.ShortContext(t.params, keys=(t.ck, t.sk), dsk=t.dsk,
                            device="meta")


def test_context_on_conv_i8_equals_jax(pair):
    """``ShortContext(engine="conv_i8")`` keeps the engine, builds only
    ``bsk_conv``, and its add chain (through the carry-reducing PBS) and
    packed product equal a fresh JAX context's on the same keys and
    seed."""
    _, t = pair
    keys = (t.ck, t.sk)
    j = jshort.ShortContext(TEST_PBS, msg_bits=2, carry_bits=2, keys=keys,
                            seed=6)
    c = tshort.ShortContext(PARAM_SETS["test_pbs"], msg_bits=2, carry_bits=2,
                            engine="conv_i8", keys=keys, seed=6, device="cpu")
    assert c.engine == "conv_i8" and c.dsk.bsk_conv is not None
    av, bv = [1, 2, 3], [3, 3, 2]
    ja, jb = j.encrypt(av), j.encrypt(bv)
    ca, cb = c.encrypt(av), c.encrypt(bv)
    same(ja, ca)
    jt, ct = ja + jb + jb + jb + jb, ca + cb + cb + cb + cb
    same(jt, ct)
    same(ja * jb, ca * cb)
    assert c.decrypt(ct) == [(x + 4 * y) % 4 for x, y in zip(av, bv)]
    assert c.decrypt(ca * cb) == [(x * y) % 4 for x, y in zip(av, bv)]
