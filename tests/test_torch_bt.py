"""The block-Toeplitz engines of the port against the JAX package, on the
CPU: the ``bsk_bt`` key layout, the plain versions of the two CUDA kernels
(``bt_external_product``, ``rotate_decompose``) against the Pallas kernels
in interpret mode, whole rotations on engines ``bt`` and ``bt_fused``
against JAX ``pallas_bt`` / ``pallas_fused`` and the port's ``mega13``,
and the port's ``fit_engine`` / ``layouts_for_engine``.  Array equality
throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TEST_SMALL, TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu.ops.pallas import blind_rotate as jbr
from herdsman_tpu.ops.pallas import rotate_decompose as jrd
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import bt, rotate_decompose as trd
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# HALF = 2 (TEST_SMALL, k = 1) exercises the negated diagonal run, as
# tests/test_ops_bitexact.py:264 does; k = 2 at N = 256 is the (k+1)-generic
# geometry.  n is cut to 8 steps so that interpret-mode rotations stay fast.
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
GEOMETRIES = [TEST_SMALL, MULTITILE_K2]


def rand_u32(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _keys(params, seed):
    rng = np.random.default_rng(seed)
    ck, sk = jref.keygen(params, rng)
    return rng, sk, tsk.device_server_key(sk, layouts=("bsk_btS", "bsk_bt"),
                                          device="cpu")


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda q: q.name)
def geometry(request):
    rng, sk, dsk = _keys(request.param, 71)
    return request.param, rng, sk, dsk


def test_bsk_bt_equals_jax_block_toeplitz_layout(geometry):
    params, _, sk, dsk = geometry
    R = (params.k + 1) * params.levels
    ext = jsk._np_ext(sk.bsk.reshape(params.n, R, params.k + 1, params.N))
    want = jsk._block_toeplitz_layout(params, ext)
    assert dsk.bsk_bt.dtype == torch.int8
    np.testing.assert_array_equal(dsk.bsk_bt.numpy(), want)
    assert dsk.bsk_bt.numel() == tsk.bt_key_bytes(dsk.params)


@pytest.mark.parametrize("B", [1, 3, 8])
def test_external_product_plain_equals_jax_pallas(geometry, B):
    params, rng, sk, dsk = geometry
    P, HALF = tsk.bt_tile(dsk.params)
    R = (params.k + 1) * params.levels
    half = 1 << (params.bg_bits - 1)
    d8 = rng.integers(-half, half, (R * HALF, B, P)).astype(np.int8)
    glwe = rand_u32(rng, B, params.k + 1, params.N)
    key = dsk.bsk_bt[3]
    for fused in (False, True):
        want = np.asarray(jbr.external_product_bt_pretiled(
            params, jnp.asarray(d8), jnp.asarray(key.numpy()),
            glwe=jnp.asarray(glwe) if fused else None))
        before = bt.external_product_bt.launches
        got = bt.external_product_bt(
            dsk.params, torch.from_numpy(d8), key,
            glwe=from_numpy_u32(glwe) if fused else None)
        assert bt.external_product_bt.launches == before  # no kernel on CPU
        np.testing.assert_array_equal(to_numpy_u32(got), want)
    # and the plain version equals the reference's external product
    digits = jref.signed_decompose(glwe[0], params.bg_bits, params.levels)
    d0 = np.moveaxis(digits, -1, 1).reshape(R * HALF, 1, P).astype(np.int8)
    np.testing.assert_array_equal(
        to_numpy_u32(bt.external_product_bt(dsk.params, torch.from_numpy(d0),
                                            dsk.bsk_bt[0]))[0],
        jref.external_product(params, sk.bsk[0], glwe[0]))


def test_rotate_decompose_plain_equals_jax_pallas(geometry):
    params, rng, _, dsk = geometry
    B = 5
    acc = rand_u32(rng, B, params.k + 1, params.N)
    a_i = rng.integers(0, 2 * params.N, B).astype(np.int32)
    want = np.asarray(jrd.rotate_decompose(params, jnp.asarray(acc),
                                           jnp.asarray(a_i)))
    before = trd.rotate_decompose.launches
    got = trd.rotate_decompose(dsk.params, from_numpy_u32(acc),
                               torch.from_numpy(a_i))
    assert trd.rotate_decompose.launches == before
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("params", [MULTITILE, MULTITILE_K2],
                         ids=["k1", "k2"])
def test_bt_engines_equal_jax_and_mega13(params):
    rng, sk, dsk = _keys(params, 21)
    ct = rand_u32(rng, 3, params.n + 1)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_bt",))
    tp = tbs.make_test_poly(dsk.params)
    mega = to_numpy_u32(tbs.blind_rotate_batch(dsk, from_numpy_u32(ct), tp,
                                               engine="mega13"))
    for engine, jengine in (("bt", "pallas_bt"), ("bt_fused", "pallas_fused")):
        want = np.asarray(jbs.blind_rotate_batch(
            jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
            engine=jengine, unroll=True))
        got = to_numpy_u32(tbs.blind_rotate_batch(
            dsk, from_numpy_u32(ct), tp, engine=engine))
        np.testing.assert_array_equal(got, want, err_msg=engine)
        np.testing.assert_array_equal(got, mega, err_msg=engine)
    np.testing.assert_array_equal(
        mega[1], jref.blind_rotate(sk, ct[1], jref.make_test_poly(params)))


def test_kernel_wrappers_check_arguments(geometry):
    params, _, _, dsk = geometry
    p = dsk.params
    P, HALF = tsk.bt_tile(p)
    R = (p.k + 1) * p.levels
    d8 = torch.zeros(R * HALF, 4, P, dtype=torch.int8)
    key = dsk.bsk_bt[0]
    with pytest.raises(TypeError):
        bt.external_product_bt(p, d8.to(torch.int32), key)
    with pytest.raises(ValueError):
        bt.external_product_bt(p, d8[:, :, :P // 2], key)
    with pytest.raises(ValueError):
        bt.external_product_bt(p, d8, key,
                               glwe=torch.zeros(3, p.k + 1, p.N,
                                                dtype=torch.int32))
    with pytest.raises(ValueError):
        bt.external_product_bt(p, d8.transpose(0, 1).contiguous()
                               .transpose(0, 1), key)
    unaligned = torch.zeros(d8.numel() + 1, dtype=torch.int8)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        bt.external_product_bt(p, unaligned.view(d8.shape), key)
    acc = torch.zeros(4, p.k + 1, p.N, dtype=torch.int32)
    with pytest.raises(ValueError):
        trd.rotate_decompose(p, acc, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        trd.rotate_decompose(p, acc, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        bt.check_params(dc.replace(p, N=4096))


def test_layouts_for_engine_matches_the_engine_registries():
    for table in (tbs.ENGINES, tbs.STEP_ENGINES, tbs.ROTATION_ENGINES):
        for engine, (_, layout) in table.items():
            assert tsk.layouts_for_engine(engine) == (layout,)
    assert tsk.layouts_for_engine("bt") == ("bsk_bt",)
    assert tsk.layouts_for_engine("bt_fused") == ("bsk_bt",)
    assert tsk.layouts_for_engine("mega13") == ("bsk_btS",)
    with pytest.raises(ValueError):
        tsk.layouts_for_engine("pallas_mega12")


def test_fit_engine_card_memory_guard():
    """Mirrors tests/test_e2e.py::test_fit_engine_hbm_guard for the port's
    engines: the block-Toeplitz engines serve a set while their key fits
    the budget, else mega13; mega13 serves what its kernel takes, else
    bt_fused."""
    k2, std = PARAM_SETS["std128_k2"], PARAM_SETS["std128"]
    shortint = PARAM_SETS["std128_shortint"]  # N = 2048
    assert tsk.bt_key_bytes(k2) == 768 * 6 * 4 * 128 * 1536  # 3.375 GiB
    for engine in ("bt", "bt_fused", "mega13", "gather_u32"):
        assert tsk.fit_engine(engine, k2) == engine
        assert tsk.fit_engine(engine, std) == engine
    # a budget below the block-Toeplitz key falls back to mega13
    small = tsk.bt_key_bytes(k2) - 1
    assert tsk.fit_engine("bt", k2, budget_bytes=small) == "mega13"
    assert tsk.fit_engine("bt_fused", k2, budget_bytes=small) == "mega13"
    # mega13's kernel does not take k+1 = 4; the block-Toeplitz engine does
    k3 = dc.replace(TOY, name="toy_k3", n=8, N=256, k=3)
    assert tsk.fit_engine("mega13", k3) == "bt_fused"
    with pytest.raises(ValueError):
        tsk.fit_engine("mega13", k3, budget_bytes=1)
    # the doubled key of mega8 (6.75 GiB) fits, and so does mega2's bsk_btk;
    # a name no engine has raises
    assert tsk.fit_engine("mega8", k2) == "mega8"
    assert tsk.fit_engine("mega2", k2) == "mega2"
    with pytest.raises(ValueError):
        tsk.fit_engine("mega99", k2)
    # N = 2048, l = 3: a 9 GiB key fits the card's budget, not an 8 GiB one
    assert tsk.fit_engine("bt_fused", shortint) == "bt_fused"
    assert tsk.fit_engine("bt_fused", shortint, budget_bytes=8 << 30) \
        == "mega13"


def test_bounds_table_names_every_pallas_kernel():
    """``utils.bounds`` (PERF.md's bound column) holds a row for every
    kernel body of the JAX package, each at its own parameter set, and the
    mega13 row at STD128_K2 is PR 1's 30.0 ms."""
    import pathlib

    from herdsman_tpu_torch.utils import bounds

    pallas = pathlib.Path(jbr.__file__).parent
    for kernel, pset, layout in bounds.TPU_KERNELS:
        site, name = kernel.split()
        path, line = site.split(":")
        src = (pallas / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {name}("), kernel
        assert pset in PARAM_SETS
        assert bounds.key_layout_bytes(PARAM_SETS[pset], layout) > 0
    n_calls = sum(f.read_text().count("pl.pallas_call(")
                  for f in pallas.glob("*.py"))
    rows = bounds.table()
    assert n_calls == 19 and len(rows) == 20
    (mega13,) = [r for r in rows if "_mega13_kernel" in r[0]]
    assert mega13[1:] == ("std128_k2", pytest.approx(30.0018, abs=1e-4),
                          "operations")
    assert all(ms > 0 for _, _, ms, _ in rows)
