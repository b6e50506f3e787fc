"""The port's modular arithmetic and four-step NTT (``ops/modmath``,
``ops/ntt``) against the JAX package's, on the CPU, on the same numpy
inputs from a seed. Tolerance 0 everywhere: every output is an exact
residue (or u32 word)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.ops import modmath as jmm
from herdsman_tpu.ops import ntt as jntt
from herdsman_tpu_torch.ops import modmath as mm
from herdsman_tpu_torch.ops import ntt as nttm
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

CPU = torch.device("cpu")
PRIMES = (8355329, 12289, 3, (1 << 31) - 1)
EDGES = np.array([0, 1, 2, 0xFFFF, 0x10000, (1 << 31) - 1, 1 << 31,
                  (1 << 32) - 2, (1 << 32) - 1], dtype=np.uint32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return from_numpy_u32(a)


def n(x):
    return to_numpy_u32(x)


def rand_u32(seed, size):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([x, EDGES])


def host_negacyclic_mod(a, b, p):
    full = np.convolve(a.astype(object), b.astype(object))
    N = len(a)
    out = full[:N].copy()
    out[: N - 1] -= full[N:]
    return np.array([int(v) % p for v in out], dtype=np.uint32)


# ---------------------------------------------------------------------------
# modmath over the ranges of tests/test_ntt.py
# ---------------------------------------------------------------------------

def test_mulhi32_equals_jax():
    a, b = rand_u32(0, 2000), rand_u32(1, 2000)[::-1].copy()
    got = n(mm.mulhi32(t(a), t(b)))
    np.testing.assert_array_equal(
        got, np.asarray(jmm.mulhi32(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, ((a.astype(object) * b.astype(object)) >> 32).astype(np.uint32))


@pytest.mark.parametrize("p", PRIMES)
def test_barrett_equals_jax(p):
    mu = (1 << 32) // p
    x = rand_u32(2, 1000)
    got = n(mm.barrett_u32(t(x), p, mu))
    np.testing.assert_array_equal(
        got, np.asarray(jmm.barrett_u32(jnp.asarray(x), p, mu)))
    np.testing.assert_array_equal(got, (x.astype(np.uint64) % p)
                                  .astype(np.uint32))


@pytest.mark.parametrize("p", PRIMES)
def test_modadd_modsub_equal_jax_on_every_u32(p):
    a, b = rand_u32(3, 1000), rand_u32(4, 1000)
    for fn, jfn in ((mm.modadd, jmm.modadd), (mm.modsub, jmm.modsub)):
        np.testing.assert_array_equal(
            n(fn(t(a), t(b), p)),
            np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), p)))


@pytest.mark.parametrize("p", [8355329, 12289, (1 << 31) - 1, 3])
def test_montgomery_equals_jax(p):
    rng = np.random.default_rng(5)
    ctx, jctx = mm.MontgomeryCtx.make(p), jmm.MontgomeryCtx.make(p)
    assert ctx.__dict__ == jctx.__dict__
    edges = np.array([0, 1, p - 1], dtype=np.uint32)
    a = np.concatenate([rng.integers(0, p, 1000).astype(np.uint32), edges])
    b = np.concatenate([rng.integers(0, p, 1000).astype(np.uint32),
                        edges[::-1]])
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    prod = n(mm.mont_mul(t(a), t(b), ctx))
    np.testing.assert_array_equal(prod, np.asarray(jmm.mont_mul(ja, jb, jctx)))
    np.testing.assert_array_equal(
        n(mm.modmul_by_mont(t(a), t(b), ctx)),
        np.asarray(jmm.modmul_by_mont(ja, jb, jctx)))
    am = mm.to_mont(t(a), ctx)
    np.testing.assert_array_equal(n(am), np.asarray(jmm.to_mont(ja, jctx)))
    np.testing.assert_array_equal(n(mm.from_mont(am, ctx)), a)
    np.testing.assert_array_equal(
        n(mm.from_mont(t(b), ctx)), np.asarray(jmm.from_mont(jb, jctx)))
    # one operand in Montgomery form: the plain product
    np.testing.assert_array_equal(
        n(mm.mont_mul(am, t(b), ctx)),
        (a.astype(object) * b.astype(object) % p).astype(np.uint32))


# ---------------------------------------------------------------------------
# the NTT plan and transforms
# ---------------------------------------------------------------------------

@functools.cache
def jax_plan(N):
    return jntt.make_plan(jntt.ntt_primes_for(N, 1)[0], N)


def plan(N):
    return nttm.make_plan(nttm.ntt_primes_for(N, 1)[0], N, device="cpu")


@pytest.mark.parametrize("N", [16, 64, 128, 256, 4096])
def test_ntt_primes_for_equal_jax(N):
    assert nttm.ntt_primes_for(N, 3) == jntt.ntt_primes_for(N, 3)


@pytest.mark.parametrize("N", [16, 64, 128, 256])
def test_plan_tables_equal_jax(N):
    """All eight tables, in the JAX layouts; N = 128 is non-square (N1 = 8,
    N2 = 16) and N = 16 pads K (4) and the columns (12) to 8 and 16."""
    pl, jpl = plan(N), jax_plan(N)
    assert (pl.p, pl.N, pl.N1, pl.N2) == (jpl.p, jpl.N, jpl.N1, jpl.N2)
    assert pl.ctx.__dict__ == jpl.ctx.__dict__
    tables = nttm.plan_tables(pl)
    assert sorted(tables) == sorted(
        ["psi_mont", "psi_inv_mont", "w1_dig", "w1i_dig", "tw_mont",
         "twi_mont", "w2_dig", "w2i_dig"])
    for name, got in tables.items():
        want = np.asarray(getattr(jpl, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the product operands: multiples of 8, zero-padded, K-major
    for name, K in (("w1_dig", pl.N1), ("w2_dig", pl.N2)):
        w = getattr(pl, name)
        assert w.shape == (-(-K // 8) * 8, -(-3 * K // 8) * 8), name
        assert w.stride() == (1, w.shape[0]), name
        assert not w[K:].any() and not w[:, 3 * K:].any(), name


def test_make_plan_is_cached_per_device():
    p = nttm.ntt_primes_for(64, 1)[0]
    assert nttm.make_plan(p, 64, "cpu") is nttm.make_plan(p, 64, CPU)


@functools.cache
def jax_transforms(N):
    """The JAX transforms of a batch [3, 4, N] (row by row, so that the
    rows of a smaller shape's outputs are these rows)."""
    pl = jax_plan(N)
    rng = np.random.default_rng(N)
    a = rng.integers(0, pl.p, (3, 4, N)).astype(np.uint32)
    b = rng.integers(0, pl.p, (3, 4, N)).astype(np.uint32)
    # in one jit: integer ops give the outputs of op-by-op dispatch, in
    # one compile (about half the time here)
    outs = jax.jit(lambda x, y: {
        "fwd": jntt.ntt_fwd(pl, x), "inv": jntt.ntt_inv(pl, y),
        "pointwise": jntt.pointwise_mul(pl, x, y),
        "polymul": jntt.negacyclic_polymul_ntt(pl, x, y),
    })(jnp.asarray(a), jnp.asarray(b))
    return a, b, {k: np.asarray(v) for k, v in outs.items()}


@pytest.mark.parametrize("shape", [(2,), (3, 4)], ids=["2xN", "3x4xN"])
@pytest.mark.parametrize("N", [16, 32, 128, 256])
def test_ntt_equals_jax(N, shape):
    """``ntt_fwd``, ``ntt_inv``, ``pointwise_mul`` and
    ``negacyclic_polymul_ntt`` at square (16, 256) and non-square (32, 128)
    N, on [2, N] and a batch [3, 4, N] (N = 64 in tests/test_torch_rns.py,
    limb by limb)."""
    pl = plan(N)
    a, b, want = jax_transforms(N)
    rows = (0, slice(0, 2)) if shape == (2,) else (slice(None),)
    a, b = a[rows].copy(), b[rows].copy()
    want = {k: v[rows] for k, v in want.items()}
    spec = nttm.ntt_fwd(pl, a)
    assert spec.dtype == torch.int32 and spec.shape == a.shape
    np.testing.assert_array_equal(n(spec), want["fwd"])
    np.testing.assert_array_equal(n(nttm.ntt_inv(pl, b)), want["inv"])
    np.testing.assert_array_equal(n(nttm.ntt_inv(pl, spec)), a)
    np.testing.assert_array_equal(n(nttm.pointwise_mul(pl, a, b)),
                                  want["pointwise"])
    prod = n(nttm.negacyclic_polymul_ntt(pl, t(a), t(b)))
    np.testing.assert_array_equal(prod, want["polymul"])
    a2, b2 = a.reshape(-1, N), b.reshape(-1, N)
    for r in range(2):
        np.testing.assert_array_equal(prod.reshape(-1, N)[r],
                                      host_negacyclic_mod(a2[r], b2[r], pl.p))


@pytest.mark.parametrize("N", [16, 128])
def test_mod_matmul_digits_is_exact(N):
    """The DFT step's product and Horner recombine equal x @ W mod p in
    exact integers, at x = p - 1 and x = 0 everywhere and at random x (N =
    16 pads K from 4 to 8). The transforms above hold it to the JAX
    package."""
    pl = plan(N)
    rng = np.random.default_rng(9)
    xs = np.stack([np.full((5, pl.N1), pl.p - 1), np.zeros((5, pl.N1)),
                   rng.integers(0, pl.p, (5, pl.N1))]).astype(np.uint32)
    got = nttm._mod_matmul_digits(t(xs), pl.w1_dig, pl.N1, pl.p, pl.ctx.mu)
    assert got.dtype == torch.int64 and got.shape == xs.shape
    w1 = pow(nttm.nt.root_of_unity(pl.p, 2 * N) ** 2 % pl.p, pl.N2, pl.p)
    w = np.array([[pow(w1, a * b, pl.p) for b in range(pl.N1)]
                  for a in range(pl.N1)], dtype=object)
    np.testing.assert_array_equal(
        got.numpy(), (xs.astype(object) @ w % pl.p).astype(np.int64))


def test_operands_on_another_device_raise():
    pl = plan(16)
    x = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not on cpu"):
        nttm.ntt_fwd(pl, x)
    with pytest.raises(TypeError, match="int32"):
        nttm.ntt_fwd(pl, torch.zeros(16, dtype=torch.int64))
