"""The port's coefficient-sharded NTT (``herdsman_tpu_torch.mesh.
ntt_sharded``, an all-to-all stage exchange over 4 CPU limb positions)
against the JAX package's ``herdsman_tpu.mesh.ntt_sharded`` on 4 of the
suite's virtual XLA devices and against the port's own ``ops.ntt``:
forward, inverse and the negacyclic product, array-equal.  The JAX
functions run under ``jax.jit`` (one compile each, about 1 s, where the
eager ``shard_map`` takes 40 s and more).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from herdsman_tpu.mesh import ntt_sharded as jns
from herdsman_tpu.ops import ntt as jntt
from herdsman_tpu_torch.mesh import make_mesh
from herdsman_tpu_torch.mesh import ntt_sharded as tns
from herdsman_tpu_torch.ops import ntt as tntt
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def jax_mesh4():
    return JMesh(np.array(jax.devices()[:4]).reshape(1, 4),
                 axis_names=("batch", "limb"))


def residues(p, N, seed, rows=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p, (rows, N)).astype(np.uint32)


@functools.cache
def jax_transforms(N):
    """(x, the JAX package's sharded spectrum, its inverse of it)."""
    p = jntt.ntt_primes_for(N, 1)[0]
    plan = jntt.make_plan(p, N)
    x = residues(p, N, 0)
    fwd = jax.jit(functools.partial(jns.ntt_fwd_sharded, plan, jax_mesh4()))
    inv = jax.jit(functools.partial(jns.ntt_inv_sharded, plan, jax_mesh4()))
    spec = np.asarray(fwd(jnp.asarray(x)))
    return p, x, spec, np.asarray(inv(jnp.asarray(spec)))


@pytest.mark.parametrize("N", [256, 1024])
def test_sharded_ntt_equals_jax_and_single_device(N):
    p, x, jspec, jback = jax_transforms(N)
    plan = tntt.make_plan(p, N, device="cpu")
    mesh = make_mesh(1, 4, device="cpu")
    spec = tns.ntt_fwd_sharded(plan, mesh, x)
    np.testing.assert_array_equal(to_numpy_u32(spec), jspec)
    assert torch.equal(spec, tntt.ntt_fwd(plan, x))
    back = tns.ntt_inv_sharded(plan, mesh, spec)
    np.testing.assert_array_equal(to_numpy_u32(back), jback)
    np.testing.assert_array_equal(to_numpy_u32(back), x)


def test_sharded_polymul_equals_jax():
    N = 256
    p = jntt.ntt_primes_for(N, 1)[0]
    jplan = jntt.make_plan(p, N)
    a, b = residues(p, N, 1, rows=2), residues(p, N, 2, rows=2)
    want = np.asarray(jax.jit(functools.partial(
        jns.polymul_sharded, jplan, jax_mesh4()))(jnp.asarray(a),
                                                    jnp.asarray(b)))
    plan = tntt.make_plan(p, N, device="cpu")
    got = tns.polymul_sharded(plan, make_mesh(1, 4, device="cpu"),
                              from_numpy_u32(a), from_numpy_u32(b))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    assert torch.equal(got, tntt.negacyclic_polymul_ntt(plan, a, b))


@pytest.mark.parametrize("limb", [2, 8])
def test_sharded_ntt_any_split_and_a_repeated_device(limb):
    """Limb axes of 2 and 8 positions on one device (at 8 each position
    holds 4 rows, then 4 columns, of the [32, 32] matrix) give
    ``ops.ntt``'s bits, and so do a batch axis beside them and the same
    split along a batch axis."""
    N = 1024
    p = tntt.ntt_primes_for(N, 1)[0]
    plan = tntt.make_plan(p, N, device="cpu")
    x = from_numpy_u32(residues(p, N, 4, rows=2))
    mesh = make_mesh(2, limb, device="cpu")
    spec = tns.ntt_fwd_sharded(plan, mesh, x)
    assert torch.equal(spec, tntt.ntt_fwd(plan, x))
    assert torch.equal(tns.ntt_inv_sharded(plan, mesh, spec), x)
    # the same split along a batch axis
    assert torch.equal(tns.ntt_fwd_sharded(plan, make_mesh(limb, 1,
                                                         device="cpu"),
                                           x, axis="batch"), spec)


def test_sharded_ntt_refuses_an_uneven_split():
    N = 256   # [16, 16] does not split over 3
    p = tntt.ntt_primes_for(N, 1)[0]
    plan = tntt.make_plan(p, N, device="cpu")
    with pytest.raises(ValueError, match="does not split over 3"):
        tns.ntt_fwd_sharded(plan, make_mesh(1, 3, device="cpu"),
                            residues(p, N, 0))
