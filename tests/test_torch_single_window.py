"""``csrc/mega12.cu``'s single window under the wrappers ``mega5``,
``mega4``, ``mega6``, ``mega3``, ``mega2`` and ``mega``
(``ops/kernels/megaJ.py``), which replace the JAX package's legacy
``_mega5_kernel``, ``_mega4_kernel``, ``_mega6_kernel`` and
``_mega3_kernel`` (on ``bsk_btj``) and ``_mega2_kernel`` and
``_mega_kernel`` (on the R-major ``bsk_bt``) and read ``bsk_btk``, on the
CPU:

- ``mega12.kmajor_from_bt`` and ``kmajor_from_btj`` re-lay a ``bsk_bt``
  or ``bsk_btj`` as ``server_key.block_toeplitz_layout(..., kmajor=True)``
  builds ``bsk_btk``, at k = 1, 2, 4, N = 128, 256, 512 and levels 2, 3,
  and the JAX package's own keys as the port's ``bsk_btk``;
- ``layouts_for_engine`` and ``fit_engine`` for the six names at every
  named set, at 40 and 12 GiB against the JAX package's routes and
  ``mega7``'s, and at 8 and 4 GiB against ``mega7``'s;
- the wrappers' plain versions (``mega12.blind_rotate_plain_btk``) at B =
  1 and 37 against the NumPy ``reference.blind_rotate``, with no launch;
- ``mega4``'s, ``mega6``'s, ``mega3``'s and ``mega``'s plain version on
  the JAX package's ``bsk_btj`` (the first three) and ``bsk_bt``, re-laid,
  against ``legacy.mega4_blind_rotate``, ``mega6_blind_rotate``,
  ``mega3_blind_rotate`` and ``mega_blind_rotate`` in interpret mode on the
  same random accumulators and rotation amounts.

(``tests/test_torch_megaR.py`` and ``tests/test_torch_legacy_j.py`` hold
the gate path on them array-equal to the JAX package's interpret-mode
kernels.)  Array equality throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import PARAM_SETS as JAX_SETS
from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu.ops.pallas import legacy
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12, megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

NAMES = ["mega5", "mega2", "mega4", "mega", "mega6", "mega3"]
GIB = 1 << 30
# HALF = 2 at N = 256 moves the negated run; n cut to 8 steps
SETS = {"k1": dc.replace(TOY, name="toy_multitile", n=8, N=256),
        "k2": dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("N", [128, 256, 512])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("source", ["bsk_bt", "bsk_btj"])
def test_kmajor_from_jax_layout_equals_btk(source, k, N, levels):
    """``bsk_btk`` from ``bsk_bt`` (block axes swapped, columns (c, j, q)
    made (j, c, q), ``kmajor_order``) or from ``bsk_btj`` (the columns
    only) is the ``bsk_btk`` that ``block_toeplitz_layout`` makes from the
    same key."""
    p = dc.replace(PARAM_SETS["toy"], n=2, N=N, k=k, bg_bits=7,
                   levels=levels)
    gen = torch.Generator().manual_seed(N + 10 * k + levels)
    bsk = torch.randint(-2**31, 2**31, (p.n, (k + 1) * levels, k + 1, N),
                        dtype=torch.int32, generator=gen)
    want = tsk.block_toeplitz_layout(p, bsk, kmajor=True)
    assert tuple(want.shape) == mega12.key_shape(p)
    if source == "bsk_bt":
        got = mega12.kmajor_from_bt(tsk.block_toeplitz_layout(p, bsk), k + 1)
    else:
        got = mega12.kmajor_from_btj(
            tsk.block_toeplitz_layout(p, bsk, j_major=True), k + 1)
    assert got.dtype == torch.int8 and torch.equal(got, want)


def test_kmajor_from_refuses_other_shapes():
    p = dc.replace(PARAM_SETS["toy"], n=1, N=256, k=1, bg_bits=7, levels=2)
    bsk = torch.zeros(p.n, 4, 2, p.N, dtype=torch.int32)
    btk = tsk.block_toeplitz_layout(p, bsk, kmajor=True)
    with pytest.raises(ValueError):
        mega12.kmajor_from_btj(btk, 2)
    with pytest.raises(ValueError):  # k+1 = 3 columns of a k+1 = 2 key
        mega12.kmajor_from_bt(tsk.block_toeplitz_layout(p, bsk), 3)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("budget_gib", [40, 12])
@pytest.mark.parametrize("pset", sorted(PARAM_SETS))
def test_single_window_routes(pset, budget_gib, name):
    """Each name reads ``bsk_btk`` and routes as the JAX package routes
    ``pallas_<name>`` (kept at every named set: their key fits either
    budget), as ``mega7`` does; at N < 128 (TOY) the port's 128-column tile
    sends them to ``mega13``."""
    p, budget = PARAM_SETS[pset], budget_gib * GIB
    assert tsk.layouts_for_engine(name) == ("bsk_btk",)
    assert tsk.ENGINE_LAYOUTS[name] == tsk.ENGINE_LAYOUTS["mega7"]
    got = tsk.fit_engine(name, p, budget_bytes=budget)
    assert got == tsk.fit_engine("mega7", p, budget_bytes=budget).replace(
        "mega7", name)
    if p.N < 128:
        assert got == "mega13"
        return
    want = jsk.fit_engine(f"pallas_{name}", JAX_SETS[pset],
                          hbm_budget_bytes=budget)
    assert got == want.removeprefix("pallas_") == name
    assert tsk.bt_key_bytes(p) <= budget


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("budget_gib", [8, 4])
def test_single_window_routes_at_small_budgets(budget_gib, name):
    """Below the named sets' key sizes each name routes as ``mega7`` does,
    set by set (to ``mega13`` where the single-width key does not fit): the
    routes these names had on ``bsk_btj`` and ``bsk_bt``, one size."""
    budget = budget_gib * GIB
    for pset, p in PARAM_SETS.items():
        assert tsk.fit_engine(name, p, budget_bytes=budget) == tsk.fit_engine(
            "mega7", p, budget_bytes=budget).replace("mega7", name), pset


@functools.cache
def keys(set_id):
    """(params, server key, the port's key with ``bsk_btk``, the JAX
    package's key in ``bsk_bt`` and ``bsk_btj``)."""
    params = SETS[set_id]
    _, sk = jref.keygen(params, np.random.default_rng(61))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_btk",), device="cpu")
    jdsk = jsk.device_server_key(sk, layouts=("bsk_bt", "bsk_btj"))
    return params, sk, tdsk, jdsk


@pytest.mark.parametrize("set_id", list(SETS))
def test_kmajor_from_jax_keys_equals_port_key(set_id):
    """The JAX package's ``pallas_mega2`` and ``pallas_mega`` key
    (``bsk_bt``) and ``pallas_mega5``, ``_mega4``, ``_mega6`` and
    ``_mega3`` key (``bsk_btj``), re-laid, are the port's ``bsk_btk``."""
    params, _, tdsk, jdsk = keys(set_id)
    kp1 = params.k + 1
    for got in (mega12.kmajor_from_bt(torch.from_numpy(np.array(
                    jdsk.bsk_bt)), kp1),
                mega12.kmajor_from_btj(torch.from_numpy(np.array(
                    jdsk.bsk_btj)), kp1)):
        assert torch.equal(got, tdsk.bsk_btk)


@functools.cache
def reference(set_id, B):
    """(ciphertexts, their NumPy reference rotations, ``mega7``'s rotation
    of them): computed once per set and width for every name."""
    params, sk, tdsk, _ = keys(set_id)
    rng = np.random.default_rng(B + params.k)
    ct = rng.integers(0, 1 << 32, (B, params.n + 1),
                      dtype=np.uint64).astype(np.uint32)
    test_poly = jref.make_test_poly(params)
    want = np.stack([jref.blind_rotate(sk, ct[i], test_poly)
                     for i in range(B)])
    mega7 = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine="mega7"))
    return ct, want, mega7


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("set_id", list(SETS))
@pytest.mark.parametrize("name", NAMES)
def test_single_window_plain_equals_reference(name, set_id, B):
    """``blind_rotate_batch`` on each engine (its wrapper's plain version on
    CPU tensors, no launch counted) equals the NumPy reference rotation of
    every ciphertext, and ``mega7``'s rotation."""
    tdsk = keys(set_id)[2]
    ct, want, mega7 = reference(set_id, B)
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    before = kernel.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine=name))
    assert kernel.launches == before  # no kernel on the CPU
    assert megaJ.plain(name) is mega12.blind_rotate_plain_btk
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mega7)


# the legacy kernel -> the JAX package's key of it and the re-lay of that
# key into bsk_btk
RELAY = {"mega4": ("bsk_btj", mega12.kmajor_from_btj),
         "mega6": ("bsk_btj", mega12.kmajor_from_btj),
         "mega3": ("bsk_btj", mega12.kmajor_from_btj),
         "mega": ("bsk_bt", mega12.kmajor_from_bt)}


@pytest.mark.parametrize("set_id", list(SETS))
@pytest.mark.parametrize("name", list(RELAY))
def test_plain_on_relaid_key_equals_jax_legacy(name, set_id):
    """``plain(name)`` on the JAX package's own key of ``pallas_<name>``
    re-laid (``kmajor_from_btj(bsk_btj)`` for ``mega4``, ``mega6`` and
    ``mega3``, ``kmajor_from_bt(bsk_bt)`` for ``mega``) equals
    ``legacy.<name>_blind_rotate`` (interpret mode) on the same random
    accumulators and rotation amounts."""
    params, _, _, jdsk = keys(set_id)
    B, kp1 = 5, params.k + 1
    rng = np.random.default_rng(len(name) + params.k)
    acc0 = rng.integers(0, 1 << 32, (B, kp1, params.N),
                        dtype=np.uint64).astype(np.uint32)
    a_t = rng.integers(0, 2 * params.N, (params.n, B)).astype(np.int32)
    layout, relay = RELAY[name]
    jkey = getattr(jdsk, layout)
    key = relay(torch.from_numpy(np.array(jkey)), kp1)
    want = getattr(legacy, f"{name}_blind_rotate")(
        params, jnp.asarray(acc0), jnp.asarray(a_t), jkey)
    got = megaJ.plain(name)(params, from_numpy_u32(acc0),
                            torch.from_numpy(a_t), key)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))
