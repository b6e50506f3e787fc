"""The port's RNS/CRT limb arithmetic and CRT-gadget key switch
(``ops/rns``) against the JAX package's, on the CPU at N = 64 with 3
primes, on the same numpy inputs from a seed. Tolerance 0 everywhere: every
output is an exact residue."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.ops import rns as jrns
from herdsman_tpu_torch.ops import ntt as nttm
from herdsman_tpu_torch.ops import rns
from herdsman_tpu_torch.ops.u32 import to_numpy_u32

N = 64
B = 3
LIMB_OPS = ("add", "sub", "neg", "ntt_fwd", "ntt_inv", "spec_mul",
            "spec_mul_mont", "to_mont", "polymul", "gadget_digits")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def n(x):
    return to_numpy_u32(x)


@functools.cache
def jax_ctx():
    return jrns.make_rns(N, 3)


@functools.cache
def ctx():
    return rns.make_rns(N, 3, device="cpu")


def residues(rng, *shape):
    return np.stack([rng.integers(0, p, shape + (N,)).astype(np.uint32)
                     for p in jax_ctx().primes], axis=0)


@functools.cache
def jax_limb_ops():
    """Operands [L, B, N] and every limb op's JAX output on them."""
    jc = jax_ctx()
    rng = np.random.default_rng(10)
    a, b = residues(rng, B), residues(rng, B)
    x, y = jnp.asarray(a), jnp.asarray(b)
    outs = {
        "add": jrns.add(jc, x, y), "sub": jrns.sub(jc, x, y),
        "neg": jrns.neg(jc, x), "ntt_fwd": jrns.ntt_fwd(jc, x),
        "ntt_inv": jrns.ntt_inv(jc, x), "spec_mul": jrns.spec_mul(jc, x, y),
        "spec_mul_mont": jrns.spec_mul_mont(jc, x, y),
        "to_mont": jrns.to_mont(jc, x), "polymul": jrns.polymul(jc, x, y),
        "gadget_digits": jrns.gadget_digits(jc, x),
    }
    return a, b, {k: np.asarray(v) for k, v in outs.items()}


def test_make_rns_equals_jax():
    c, jc = ctx(), jax_ctx()
    assert (c.N, c.primes, c.L, c.Q) == (jc.N, jc.primes, jc.L, jc.Q)
    assert c.device == torch.device("cpu")
    for pl, jpl in zip(c.plans, jc.plans):
        for name, got in nttm.plan_tables(pl).items():
            np.testing.assert_array_equal(got, np.asarray(getattr(jpl, name)),
                                          err_msg=name)


def test_residue_conversions_equal_jax():
    c, jc = ctx(), jax_ctx()
    rng = np.random.default_rng(5)
    vals = np.array([int(x) for x in rng.integers(0, 1 << 62, N)]
                    + [-1, -c.Q, c.Q, c.Q // 2, c.Q // 2 + 1], dtype=object)
    res = rns.to_rns(c, vals)
    np.testing.assert_array_equal(res, jrns.to_rns(jc, vals))
    back = rns.from_rns(c, res)
    assert (back == jrns.from_rns(jc, res)).all()
    assert (back == vals % c.Q).all()
    assert (rns.centered(c, back) == jrns.centered(jc, back)).all()
    a, b = vals[:N], vals[::-1][:N]
    assert (rns.host_negacyclic_polymul(c, a, b)
            == jrns.host_negacyclic_polymul(jc, a, b)).all()


@pytest.mark.parametrize("op", LIMB_OPS)
def test_limb_ops_equal_jax(op):
    """Each limb op on residues [L, B, N] (``gadget_digits``: [L_digit,
    L_limb, B, N]) and, for ``polymul`` and ``gadget_digits``, on [L, N]."""
    a, b, want = jax_limb_ops()
    fn = getattr(rns, op)
    args = (a,) if op in ("neg", "ntt_fwd", "ntt_inv", "to_mont",
                          "gadget_digits") else (a, b)
    got = fn(ctx(), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), want[op])
    if op in ("polymul", "gadget_digits"):
        np.testing.assert_array_equal(
            n(fn(ctx(), *(x[:, 1].copy() for x in args))), want[op][..., 1, :])


def test_polymul_matches_bigint():
    c = ctx()
    rng = np.random.default_rng(4)
    a = np.array([[int(x) for x in rng.integers(0, 1 << 62, N)]
                  for _ in range(2)], dtype=object) % c.Q
    b = np.array([[int(x) for x in rng.integers(0, 1 << 62, N)]
                  for _ in range(2)], dtype=object) % c.Q
    got = rns.from_rns(c, n(rns.polymul(c, rns.to_rns(c, a),
                                        rns.to_rns(c, b))))
    for r in range(2):
        assert (got[r] == rns.host_negacyclic_polymul(c, a[r], b[r])).all()


@functools.cache
def jax_keys():
    """(s1, s2, the JAX key) of one seed, and the ciphertexts [2, L, B, N]
    under s2 of 8-bit messages in the top bits, as tests/test_ntt.py:100-137
    makes one."""
    jc = jax_ctx()
    rng = np.random.default_rng(6)
    s1 = rng.integers(0, 2, N)
    s2 = rng.integers(0, 2, N)
    ksk = jrns.keyswitch_keygen(jc, s1, s2, np.random.default_rng(7))
    msg = rng.integers(0, 256, (B, N))
    delta = jc.Q // 256
    a_res = residues(rng, B)
    a_int = jrns.from_rns(jc, a_res)
    e = np.rint(rng.normal(0, 3.2, (B, N))).astype(int)
    b_int = np.stack([
        (jrns.host_negacyclic_polymul(jc, a_int[r], s2)
         + np.asarray(msg[r], dtype=object) * delta
         + np.asarray(e[r], dtype=object)) % jc.Q for r in range(B)])
    ct = np.stack([a_res, jrns.to_rns(jc, b_int)], axis=0)
    switched = np.asarray(jrns.key_switch(jc, ksk, jnp.asarray(ct)))
    single = np.asarray(jrns.key_switch(jc, ksk, jnp.asarray(ct[:, :, 0])))
    return s1, s2, ksk, msg, ct, switched, single


def test_keyswitch_keygen_equals_jax():
    """One seed, the same draws in the same order: the same key."""
    s1, s2, jk, *_ = jax_keys()
    ksk = rns.keyswitch_keygen(ctx(), s1, s2, np.random.default_rng(7))
    assert ksk.ksk_a.device == torch.device("cpu")
    np.testing.assert_array_equal(n(ksk.ksk_a), jk.ksk_a)
    np.testing.assert_array_equal(n(ksk.ksk_b), jk.ksk_b)


def decode_and_noise(c, out, s1, msg):
    """Messages right and the noise below delta/16 (tests/test_ntt.py)."""
    delta = c.Q // 256
    a2, b2 = rns.from_rns(c, out[0]), rns.from_rns(c, out[1])
    phase = (b2 - rns.host_negacyclic_polymul(c, a2, s1)) % c.Q
    got = np.array([int((int(v) + delta // 2) // delta) % 256 for v in phase])
    np.testing.assert_array_equal(got, msg)
    err = np.array([min(int(v) % delta, delta - int(v) % delta)
                    for v in phase], dtype=float)
    assert err.max() < delta / 16


@pytest.mark.parametrize("batched", [False, True], ids=["2xLxN", "2xLxBxN"])
def test_key_switch_equals_jax(batched):
    """``key_switch`` on one ciphertext [2, L, N] and a batch [2, L, B, N]
    (the key broadcast over B), on the port's own key of the JAX seed."""
    s1, s2, _, msg, ct, switched, single = jax_keys()
    c = ctx()
    ksk = rns.keyswitch_keygen(c, s1, s2, np.random.default_rng(7))
    x, want = (ct, switched) if batched else (ct[:, :, 0].copy(), single)
    out = n(rns.key_switch(c, ksk, x))
    np.testing.assert_array_equal(out, want)
    for r in range(B if batched else 1):
        decode_and_noise(c, out[:, :, r] if batched else out, s1, msg[r])


def test_device_keyswitch_key_carries_the_jax_key():
    s1, _, jk, msg, ct, switched, single = jax_keys()
    c = ctx()
    ksk = rns.device_keyswitch_key(c, jk.ksk_a, jk.ksk_b)
    assert ksk.ksk_a.dtype == torch.int32 and ksk.ksk_a.device == c.device
    np.testing.assert_array_equal(n(ksk.ksk_a), jk.ksk_a)
    np.testing.assert_array_equal(n(rns.key_switch(c, ksk, ct)), switched)
    np.testing.assert_array_equal(n(rns.key_switch(c, ksk, ct[:, :, 0])),
                                  single)
    with pytest.raises(ValueError, match="shape"):
        rns.device_keyswitch_key(c, jk.ksk_a[:2], jk.ksk_b)


def test_operands_on_another_device_raise():
    c = ctx()
    x = torch.zeros(3, N, dtype=torch.int32, device="meta")
    for fn in (rns.ntt_fwd, rns.neg, rns.to_mont):
        with pytest.raises(ValueError, match="not on cpu"):
            fn(c, x)
    with pytest.raises(ValueError, match="not on cpu"):
        rns.polymul(c, x, x)
