"""The port's ``RadixContext`` / ``EncRadix`` against the JAX package's, on
the CPU at TEST_PBS (3 blocks of 2 message bits: 6-bit integers; 2 blocks
for division and encrypted-amount shifts): every block of every result is
array-equal to the JAX package's on the same keys and seed, with the same
max_val and noise bookkeeping, and decrypts right.
"""

import numpy as np
import pytest
import torch

from herdsman_tpu import radix as jradix
from herdsman_tpu import shortint as jshort
from herdsman_tpu.core import TEST_PBS
from herdsman_tpu.core import reference as jref
from herdsman_tpu_torch import radix as tradix
from herdsman_tpu_torch import shortint as tshort
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops.u32 import to_numpy_u32

MOD = 64


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
    """(JAX, port) 3-block radix contexts on the same keys and seed."""
    rng = np.random.default_rng(4321)
    keys = jref.keygen(TEST_PBS, rng)
    j = jshort.ShortContext(TEST_PBS, msg_bits=2, carry_bits=2, keys=keys,
                            seed=9)
    t = tshort.ShortContext(PARAM_SETS["test_pbs"], msg_bits=2, carry_bits=2,
                            keys=keys, seed=9, device="cpu")
    return jradix.RadixContext(j, n_blocks=3), tradix.RadixContext(t, 3)


def same(jx, tx):
    """Equal blocks (ciphertexts, max_val, noise level) or equal flags."""
    jb = jx.blocks if hasattr(jx, "blocks") else [jx]
    tb = tx.blocks if hasattr(tx, "blocks") else [tx]
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(to_numpy_u32(b.data), np.asarray(a.data))
        assert (b.max_val, b.noise_level) == (a.max_val, a.noise_level)


def encrypt(pair, a_v, b_v, n_blocks=None):
    out = []
    for ctx in pair:
        if n_blocks is not None:
            ctx = type(ctx)(ctx.short, n_blocks=n_blocks)
        out.append((ctx, ctx.encrypt(a_v), ctx.encrypt(b_v)))
    return out


def test_mul_equals_jax(pair):
    a_v, b_v = [7, 9, 63, 0], [9, 7, 63, 5]
    (jc, ja, jb), (tc, ta, tb) = encrypt(pair, a_v, b_v)
    same(ja, ta)
    jp, tp = ja * jb, ta * tb
    same(jp, tp)
    assert tc.decrypt(tp) == [(x * y) % MOD for x, y in zip(a_v, b_v)]


def test_add_chain_and_sub_equal_jax(pair):
    a_v, b_v = [13, 37, 63, 0], [21, 45, 63, 1]
    (jc, ja, jb), (tc, ta, tb) = encrypt(pair, a_v, b_v)
    jt, tt = ja, ta
    for _ in range(6):  # forces propagation mid-chain
        jt, tt = jt + jb, tt + tb
        same(jt, tt)
    assert tc.decrypt(tt) == [(x + 6 * y) % MOD for x, y in zip(a_v, b_v)]
    jd, td = ja - jb, ta - tb
    same(jd, td)
    assert tc.decrypt(td) == [(x - y) % MOD for x, y in zip(a_v, b_v)]
    same(ja.scalar_add(7), ta.scalar_add(7))
    same(~ja, ~ta)


def test_lt_eq_equal_jax(pair):
    a_v, b_v = [5, 20, 20, 63], [9, 20, 3, 0]
    (jc, ja, jb), (tc, ta, tb) = encrypt(pair, a_v, b_v)
    jl, tl = ja.lt(jb), ta.lt(tb)
    same(jl, tl)
    assert tc.decrypt_flag(tl) == [x < y for x, y in zip(a_v, b_v)]
    je, te = ja.eq(jb), ta.eq(tb)
    same(je, te)
    assert tc.decrypt_flag(te) == [x == y for x, y in zip(a_v, b_v)]
    jm, tm = ja.min(jb), ta.min(tb)
    same(jm, tm)
    assert tc.decrypt(tm) == [min(x, y) for x, y in zip(a_v, b_v)]


def test_divmod_equals_jax(pair):
    """Bit-serial restoring division at 4 bits (2 blocks), with the
    division-by-zero convention (q = 2^W - 1, r = dividend)."""
    a_v, b_v = [13, 15, 7, 9], [3, 4, 9, 0]
    (jc, ja, jb), (tc, ta, tb) = encrypt(pair, a_v, b_v, n_blocks=2)
    (jq, jr), (tq, tr) = ja.divmod(jb), ta.divmod(tb)
    same(jq, tq)
    same(jr, tr)
    assert tc.decrypt(tq) == [4, 3, 0, 15]
    assert tc.decrypt(tr) == [1, 3, 7, 9]


def test_shift_by_encrypted_amount_equals_jax(pair):
    """Barrel shifter over W = 4, amounts 0..3 in one batch."""
    a_v, k_v = [0b1011] * 4, [0, 1, 2, 3]
    (jc, ja, jk), (tc, ta, tk) = encrypt(pair, a_v, k_v, n_blocks=2)
    js, ts = ja.shift_left(jk), ta.shift_left(tk)
    same(js, ts)
    assert tc.decrypt(ts) == [(x << s) % 16 for x, s in zip(a_v, k_v)]
    jr, tr = ja.rotate_right(jk), ta.rotate_right(tk)
    same(jr, tr)
    assert tc.decrypt(tr) == [((x >> s) | (x << (4 - s))) % 16 if s else x
                              for x, s in zip(a_v, k_v)]


def test_bits_sum_and_trivial_equal_jax(pair):
    jc, tc = pair
    vals = [0b101101, 0, 63]
    ja, ta = jc.encrypt(vals), tc.encrypt(vals)
    jbits, tbits = ja.bits(), ta.bits()
    for a, b in zip(jbits, tbits):
        same(a, b)
    same(jc._from_bits(jbits), tc._from_bits(tbits))
    same(jc.trivial(5, batch=3), tc.trivial(5, batch=3))
    js = jc.sum([ja, ja, jc.trivial(9, batch=3)])
    ts = tc.sum([ta, ta, tc.trivial(9, batch=3)])
    same(js, ts)
    assert tc.decrypt(ts) == [(2 * v + 9) % MOD for v in vals]
    with pytest.raises(ValueError):
        tc.sum([])
