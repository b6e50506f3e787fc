"""Batch parallelism of the port's mesh on CPU positions against the JAX
package's on the suite's 8 virtual XLA devices, array-equal: the rotation
and step engines ``bt_fused``, ``mega11``, ``mega12``, ``mega13`` and
``mega16`` run whole on each batch position (the JAX package's
``pallas_*`` engines in interpret mode in its ``shard_map``), the PBS and
many-LUT PBS over every position of a mesh, and a radix multiply through
``ShortContext(mesh=...)``.  n is cut to 4 steps for the rotation engines,
where the JAX test takes 8 or 16.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu import mesh as jmesh
from herdsman_tpu.core import TEST_PBS, TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import pbs as jpbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu.radix import RadixContext as JRadixContext
from herdsman_tpu.shortint import ShortContext as JShortContext
from herdsman_tpu_torch import mesh as tmesh
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.u32 import to_numpy_u32
from herdsman_tpu_torch.radix import RadixContext
from herdsman_tpu_torch.shortint import ShortContext

# N = 256 for the block-Toeplitz engines, which the port tiles by 128
# columns
TOY4_N256 = dc.replace(TOY, name="toy_mesh_n4_n256", n=4, N=256)
TOY4_B8L2 = dc.replace(TOY, name="toy_mesh_b8l2", n=4, N=256, k=2,
                       bg_bits=8, levels=2)
TEST_PBS_1024 = dc.replace(TEST_PBS, name="test_pbs_many_mesh", N=1024)
# the JAX engine -> the port's
PORT_ENGINE = {"pallas_fused": "bt_fused", "pallas_mega11": "mega11",
               "pallas_mega12": "mega12", "pallas_mega13": "mega13",
               "pallas_mega16": "mega16"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def keys(params, seed=41):
    return jref.keygen(params, np.random.default_rng(seed))


def cpu_mesh(batch, limb=1):
    return tmesh.make_mesh(batch, limb, device="cpu")


@pytest.mark.parametrize("jengine, params", [
    ("pallas_fused", TOY4_N256), ("pallas_mega11", TOY4_N256),
    ("pallas_mega12", TOY4_N256), ("pallas_mega13", TOY4_B8L2),
    ("pallas_mega16", TOY4_B8L2)])
def test_dp_engine_equals_jax_mesh(jengine, params):
    """Rotation and step engines run whole on each of 8 batch positions,
    equal to the JAX package's 8-device DP shard_map on the same engine."""
    ck, sk = keys(params)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 8).astype(bool)
    ct = jref.encrypt_bool(ck, bits, rng)
    jm = jmesh.make_mesh(batch=8, limb=1)
    jdsk = jsk.device_server_key(sk, layouts=jsk.layouts_for_engine(jengine))
    want = np.asarray(jmesh.bootstrap_bool_sharded(
        jmesh.shard_server_key(jdsk, jm), jm, jnp.asarray(ct),
        engine=jengine, unroll=True))
    engine = PORT_ENGINE[jengine]
    dsk = tsk.device_server_key(sk, layouts=tsk.layouts_for_engine(engine),
                                device="cpu")
    out = tmesh.bootstrap_bool_sharded(dsk, cpu_mesh(8), ct, engine=engine)
    np.testing.assert_array_equal(to_numpy_u32(out), want)
    assert (jref.lwe_decrypt_bool(ck, want) == bits).all()




@pytest.mark.parametrize("params, tables, shape", [
    (TEST_PBS, ([(3 * m + 1) % 16 for m in range(16)],), (4, 2)),
    (TEST_PBS_1024, ([(m * m) % 16 for m in range(16)],
                     [(m + 7) % 16 for m in range(16)]), (1, 2))],
    ids=["one_lut", "many_lut"])
def test_sharded_pbs_equals_jax_mesh(params, tables, shape):
    """The PBS over every position of a mesh (5 ciphertexts over 8
    positions, 6 over 2 limb positions; padded and cut back), on the port's
    ``conv_i8``,
    equals the JAX package's 8-device sharded PBS LUT for LUT."""
    ck, sk = keys(params)
    rng = np.random.default_rng(9)
    msgs = rng.integers(0, 4, 4 + len(tables))
    ct = jref.lwe_encrypt_raw(ck, jpbs.encode(params, msgs, 4), rng)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_conv",))
    jm = jmesh.make_mesh(batch=8, limb=1)
    want = jmesh.pbs_many_batch_sharded(jdsk, jm, jnp.asarray(ct),
                                        list(tables), 4, engine="conv_i8")
    dsk = tsk.device_server_key(sk, layouts=("bsk_conv",), device="cpu")
    got = tmesh.pbs_many_batch_sharded(dsk, cpu_mesh(*shape), ct,
                                       list(tables), 4, engine="conv_i8")
    assert len(got) == len(tables)
    for g, w, table in zip(got, want, tables):
        np.testing.assert_array_equal(to_numpy_u32(g), np.asarray(w))
        dec = jpbs.decode(params, jref.lwe_phase(ck.lwe_key, np.asarray(w)),
                          4)
        assert dec.tolist() == [table[m] for m in msgs]
    if len(tables) == 1:
        one = tmesh.pbs_batch_sharded(dsk, cpu_mesh(8), ct, tables[0], 4,
                                      engine="conv_i8")
        assert torch.equal(one, got[0])


def test_radix_multiply_on_mesh_equals_jax_mesh():
    """A 3-block radix multiply through ShortContext(mesh=...), the JAX
    package's on its 8 devices and the port's on 8 CPU positions (both on
    ``conv_i8``; ``tests/test_torch_mesh.py`` runs the port's default
    ``mega12`` on a mesh): every block array-equal, and right."""
    ck, sk = keys(TEST_PBS)
    a_vals, b_vals = [13, 42, 7], [11, 3, 29]

    def run(ctx_cls, radix_cls, **kw):
        short = ctx_cls(TEST_PBS, msg_bits=2, carry_bits=2, keys=(ck, sk),
                        **kw)
        short._rng = np.random.default_rng(20240817)
        r = radix_cls(short, n_blocks=3)
        return r, r.encrypt(a_vals) * r.encrypt(b_vals)

    _, want = run(JShortContext, JRadixContext,
                  mesh=jmesh.make_mesh(batch=8, limb=1))
    r, got = run(ShortContext, RadixContext, mesh=cpu_mesh(8),
                 engine="conv_i8", device="cpu")
    assert r.short.mesh is not None and r.short.engine == "conv_i8"
    assert len(got.blocks) == len(want.blocks)
    for g, w in zip(got.blocks, want.blocks):
        np.testing.assert_array_equal(to_numpy_u32(g.data),
                                      np.asarray(w.data))
    assert r.decrypt(got) == [(x * y) % 64 for x, y in zip(a_vals, b_vals)]
