"""The port's ``mega10`` engine (``ops/kernels/megaJ.py``,
``csrc/mega12.cu``'s doubled window on ``bsk_btk2``) and its ``mega3``,
``mega4`` and ``mega5`` (``csrc/mega12.cu``'s single window on ``bsk_btk``)
against the JAX package's legacy Pallas kernels, on the CPU:

- each plain rotation against ``legacy.py::_mega10_kernel``,
  ``_mega3_kernel``, ``_mega4_kernel`` and ``_mega5_kernel`` in interpret
  mode (run as the JAX package's own tests run them, each once per kernel
  and set) and against the NumPy reference; the plain version of
  ``mega10``, ``mega8`` and ``mega9`` (the doubled window's) also on the
  JAX package's own ``bsk_btj2`` re-laid by ``mega12.kmajor_from_btj``,
  against ``legacy.mega10_blind_rotate``, ``mega.mega8_blind_rotate`` and
  ``legacy.mega9_blind_rotate`` (``tests/test_torch_single_window.py``
  holds ``mega3``'s on the re-laid ``bsk_btj`` against
  ``legacy.mega3_blind_rotate``);
- ``kmajor_from_btj`` of the doubled ``bsk_btj2`` as ``bsk_btk2``;
- the wrappers' checks, the gate path on each engine, and
  ``layouts_for_engine``, ``fit_engine`` and ``port_engine`` against the
  JAX package, set by set, at 40 and 12 GiB.

Array equality throughout: the arithmetic is exact mod 2^32.
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
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu.ops.pallas import legacy, mega
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12, megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service.config import ConfigError, port_engine

# HALF = 2 at N = 256 moves the window and the negated run, at k = 1 and
# k = 2; n is cut to 8 steps so that interpret-mode rotations stay fast
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
SETS = {"k1": MULTITILE, "k2": MULTITILE_K2}
# the legacy kernel -> the kernel whose function and key it shares: mega10
# computes mega8's function, and the port runs it as mega11 runs (the
# doubled window on bsk_btk2); mega3, mega4 and mega5 run as mega7 runs
# (the single window on bsk_btk)
LEGACY = {"mega10": "mega11", "mega3": "mega7", "mega4": "mega7",
          "mega5": "mega7"}
B = 37
GIB = 1 << 30


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
    """(client key, server key, JAX key in ``bsk_btj2`` and ``bsk_btj``,
    port key in those, ``mega7``'s ``bsk_btk`` and ``mega11``'s
    ``bsk_btk2``)."""
    ck, sk = jref.keygen(params, np.random.default_rng(29))
    layouts = ("bsk_btj2", "bsk_btj")
    return (ck, sk, jsk.device_server_key(sk, layouts=layouts),
            tsk.device_server_key(sk, layouts=(*layouts, "bsk_btk",
                                               "bsk_btk2"),
                                  device="cpu"))


@functools.cache
def ciphertexts(params):
    return rand_u32(np.random.default_rng(params.k + 41), B, params.n + 1)


@functools.cache
def jax_rotation(name, set_id):
    """The JAX package's ``pallas_<name>`` rotation of ``ciphertexts``, in
    interpret mode: computed once per kernel and set."""
    params = SETS[set_id]
    jdsk = keys(params)[2]
    return np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ciphertexts(params)), jbs.make_test_poly(params),
        engine=f"pallas_{name}", unroll=True))


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


@pytest.mark.parametrize("name", list(LEGACY))
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_rotation_equals_jax_legacy_pallas(set_id, name):
    np.testing.assert_array_equal(port_rotation(name, set_id),
                                  jax_rotation(name, set_id))


@pytest.mark.parametrize("name", list(LEGACY))
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_rotation_equals_reference(set_id, name):
    params = SETS[set_id]
    sk = keys(params)[1]
    ct = ciphertexts(params)
    got = port_rotation(name, set_id)
    for i in (0, B - 1):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i], jref.make_test_poly(params)))


# the JAX package's wrappers of the doubled window with columns (c, j, q),
# on bsk_btj2
JAX_BTJ2 = {"mega10": legacy.mega10_blind_rotate,
            "mega8": mega.mega8_blind_rotate,
            "mega9": legacy.mega9_blind_rotate}


@pytest.mark.parametrize("name", list(JAX_BTJ2))
@pytest.mark.parametrize("set_id", list(SETS))
def test_plain_on_relaid_btj2_equals_jax(set_id, name):
    """``plain(name)`` on ``kmajor_from_btj(bsk_btj2)`` (the JAX package's
    own doubled key, re-laid) equals the JAX package's ``mega10``,
    ``mega8`` or ``mega9`` rotation (interpret mode) on the same random
    accumulators and rotation amounts, and so does
    ``blind_rotate_plain_btj2`` on ``bsk_btj2`` itself."""
    params = SETS[set_id]
    jkey = keys(params)[2].bsk_btj2
    kp1, n_ct = params.k + 1, 5
    rng = np.random.default_rng(params.k + 17)
    acc0 = rand_u32(rng, n_ct, kp1, params.N)
    a_t = rng.integers(0, 2 * params.N, (params.n, n_ct)).astype(np.int32)
    key = mega12.kmajor_from_btj(torch.from_numpy(np.array(jkey)), kp1)
    want = JAX_BTJ2[name](params, jnp.asarray(acc0), jnp.asarray(a_t), jkey)
    got = megaJ.plain(name)(params, from_numpy_u32(acc0),
                            torch.from_numpy(a_t), key)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))
    direct = megaJ.blind_rotate_plain_btj2(
        params, from_numpy_u32(acc0), torch.from_numpy(a_t),
        torch.from_numpy(np.array(jkey)), jcq=False)
    np.testing.assert_array_equal(to_numpy_u32(direct), np.asarray(want))


# --- the key layout, wrappers, engines and routes --------------------------

@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("k", [1, 2])
def test_kmajor_from_btj2_equals_btk2(k, levels):
    """``mega12.kmajor_from_btj`` re-lays the doubled ``bsk_btj2`` (2*HALF
    groups of blocks, columns (c, j, q)) as the ``bsk_btk2`` that
    ``block_toeplitz_layout(..., windowed=True, kmajor=True)`` makes from
    the same key."""
    p = dc.replace(PARAM_SETS["toy"], n=2, N=256, k=k, bg_bits=7,
                   levels=levels)
    gen = torch.Generator().manual_seed(k + 10 * levels)
    bsk = torch.randint(-2**31, 2**31, (p.n, (k + 1) * levels, k + 1, p.N),
                        dtype=torch.int32, generator=gen)
    want = tsk.block_toeplitz_layout(p, bsk, windowed=True, kmajor=True)
    assert tuple(want.shape) == megaJ.key_shape(p, "mega10")
    got = mega12.kmajor_from_btj(
        tsk.block_toeplitz_layout(p, bsk, windowed=True), k + 1)
    assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_j_wrapper_checks(name):
    _, _, _, tdsk = keys(MULTITILE_K2)
    p = tdsk.params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    key = getattr(tdsk, megaJ.KEY_LAYOUTS[name])
    # another key of the same size: the JAX package's bsk_btj2 for
    # csrc/mega12.cu's doubled window (mega10's key on the TPU) and its
    # bsk_btj for the single window
    other = tdsk.bsk_btj2 if name == "mega10" else tdsk.bsk_btj
    acc = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernel(p, acc, a_t.long(), key)
    with pytest.raises(ValueError):
        kernel(p, acc, a_t[:, :1].contiguous(), key)
    with pytest.raises(ValueError):
        kernel(p, acc, a_t, other)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(p, acc.transpose(1, 2).contiguous().transpose(1, 2), a_t, key)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel(p, acc.to("meta"), a_t.to("meta"), key.to("meta"))
    for bad in (dc.replace(p, N=64), dc.replace(p, k=3)):
        with pytest.raises(ValueError):
            megaJ.check_params(bad, name)
    for pset in ("std128_k2", "std128", "std128_fast", "std128_shortint",
                 "std128_k4"):
        megaJ.check_params(PARAM_SETS[pset], name)
    assert tsk.layouts_for_engine(name) == (megaJ.KEY_LAYOUTS[name],)
    assert tbs.ROTATION_ENGINES[name] == (kernel, megaJ.KEY_LAYOUTS[name])
    # mega3, mega5 and mega4 are csrc/mega12.cu's single window (mega7's
    # instantiation), mega10 its doubled window (mega11's)
    assert megaJ.KERNELS[name] == megaJ.KERNELS[LEGACY[name]]
    assert port_engine(f"pallas_{name}") == name


@pytest.mark.parametrize("name", ["mega4", "mega5", "mega3"])
def test_check_params_names_shared_memory(name):
    """``mega5``, ``mega4`` and ``mega3``, whose wide block, staged key
    buffers and shared-memory ciphertext blocks refused a set whose
    ciphertext fills a block (the first two) or one with wider digits
    (``mega3``), are now ``csrc/mega12.cu``'s single window (digits and
    accumulators in device memory) and behave as ``mega7``: they take both
    sets.  So does ``mega8``, whose block held a ciphertext in shared
    memory and refused the wider one, now ``csrc/mega12.cu``'s doubled
    window."""
    wide = dc.replace(PARAM_SETS["std128_shortint"], name="wide", k=4,
                      bg_bits=2, levels=16)
    wider = dc.replace(wide, bg_bits=1, levels=32)
    assert not megaJ.KERNELS[name]
    for p in (wide, wider):
        megaJ.check_params(p, "mega7")
        megaJ.check_params(p, name)
        megaJ.check_params(p, "mega8")


@pytest.mark.parametrize("name", list(LEGACY))
def test_plain_versions_share_the_serial_function(name):
    """``mega10`` shares ``mega11``'s plain version
    (``blind_rotate_plain_btk2``, the same key); ``mega5`` and ``mega4``
    ``mega7``'s (``mega12.blind_rotate_plain_btk``, the same key), and so
    does ``mega3``: each gives the serial kernel's rotation on the same
    inputs."""
    _, _, _, tdsk = keys(MULTITILE)
    p = tdsk.params
    rng = np.random.default_rng(len(name))
    acc = from_numpy_u32(rand_u32(rng, 5, p.k + 1, p.N))
    a_t = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n, 5)),
                          dtype=torch.int32)
    serial = LEGACY[name]
    want = megaJ.plain(serial)(p, acc, a_t,
                               getattr(tdsk, megaJ.KEY_LAYOUTS[serial]))
    got = megaJ.plain(name)(p, acc, a_t, getattr(tdsk, megaJ.KEY_LAYOUTS[name]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(LEGACY))
def test_gate_batch_equals_serial_engine(name):
    """``gate_batch`` on each engine gives the outputs of the engine whose
    function it shares, which decrypt to the truth table."""
    ck, _, _, tdsk = keys(MULTITILE_K2)
    rng = np.random.default_rng(43)
    n_gates = 12
    b1, b2 = (rng.integers(0, 2, n_gates).astype(bool) for _ in range(2))
    ids = np.arange(n_gates) % len(tgates.GATE_IDS)
    c1, c2 = jref.encrypt_bool(ck, b1, rng), jref.encrypt_bool(ck, b2, rng)
    batch = tgates.GateBatch(ids, c1, c2)
    got = to_numpy_u32(tgates.gate_batch(tdsk, batch, engine=name,
                                         device="cpu"))
    want = to_numpy_u32(tgates.gate_batch(tdsk, batch, engine=LEGACY[name],
                                          device="cpu"))
    np.testing.assert_array_equal(got, want)
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    names = list(tgates.GATE_IDS)
    np.testing.assert_array_equal(
        jref.lwe_decrypt_bool(ck, got),
        [truth[names[g]][i] for i, g in enumerate(ids)])


@pytest.mark.parametrize("budget_gib", [40, 12])
@pytest.mark.parametrize("name", [*LEGACY, "mega", "mega2", "mega8", "mega9"])
def test_routes_equal_jax(name, budget_gib):
    """``fit_engine`` routes each name as the JAX package routes
    ``pallas_<name>`` on every named set at 40 and 12 GiB: ``mega10``
    through the doubled key's check (``server_key.py:694-699``: at 12 GiB
    STD128_SHORTINT's 18 GiB ``bsk_btj2`` goes to ``mega12``), the others
    (``mega`` on ``bsk_bt`` too) kept; ``layouts_for_engine`` is the JAX
    package's but for ``mega3``, ``mega5``, ``mega4``, ``mega2`` and
    ``mega``, which read ``bsk_btk`` (``bsk_btjj`` in ``wgmma``'s order)
    for the JAX package's ``bsk_btj`` and ``bsk_bt``, and ``mega10``,
    ``mega8`` and ``mega9``, which read ``bsk_btk2`` (``bsk_btj2j`` in that
    order) for its ``bsk_btj2``: each pair one size."""
    budget = budget_gib * GIB
    for pset, p in PARAM_SETS.items():
        if p.N < 128:  # below the port's tile: mega13 (documented)
            assert tsk.fit_engine(name, p, budget_bytes=budget) == "mega13"
            continue
        want = jsk.fit_engine(f"pallas_{name}", JAX_SETS[pset],
                              hbm_budget_bytes=budget)
        assert tsk.fit_engine(name, p, budget_bytes=budget) \
            == want.removeprefix("pallas_"), pset
    jax_layouts = jsk.layouts_for_engine(f"pallas_{name}")
    if name in JAX_BTJ2:
        assert jax_layouts == ("bsk_btj2",)
        assert tsk.layouts_for_engine(name) == ("bsk_btk2",)
    elif name in ("mega3", "mega5", "mega4", "mega2", "mega"):
        assert jax_layouts == ("bsk_bt" if name in ("mega2", "mega")
                               else "bsk_btj",)
        assert tsk.layouts_for_engine(name) == ("bsk_btk",)
    else:
        assert tsk.layouts_for_engine(name) == jax_layouts
    assert port_engine(f"pallas_{name}") == name


@pytest.mark.parametrize("budget_gib", [40, 12, 8, 4])
def test_doubled_window_wrappers_route_as_mega11(budget_gib):
    """``mega10``, ``mega8`` and ``mega9`` on ``bsk_btk2`` route as they did
    on ``bsk_btj2``, set by set: as ``mega11`` (their kernel and key now;
    their checks were the doubled key's size and, for ``mega8`` and
    ``mega9``, a shared-memory block no named set overflowed); only the
    layout name changed."""
    budget = budget_gib * GIB
    for pset, p in PARAM_SETS.items():
        want = tsk.fit_engine("mega11", p, budget_bytes=budget)
        for name in JAX_BTJ2:
            assert tsk.fit_engine(name, p, budget_bytes=budget) == \
                want.replace("mega11", name), (pset, name)
    for name in ("mega11", *JAX_BTJ2):
        assert tsk.layouts_for_engine(name) == ("bsk_btk2",)
        assert megaJ.KERNELS[name]
    # fit_engine budgets the doubled key as 2 * bt_key_bytes: bsk_btk2's
    # size, as it was bsk_btj2's
    for p in PARAM_SETS.values():
        if p.N >= megaJ.P:
            assert np.prod(megaJ.key_shape(p, "mega10")) == \
                2 * tsk.bt_key_bytes(p)


def test_port_engine_refuses_mega_and_mega2():
    """Refused until they were ported: a config's ``pallas_mega`` and
    ``pallas_mega2`` now map to the port's engines, and the port's own
    names pass through."""
    for name in ("pallas_mega", "pallas_mega2"):
        assert port_engine(name) == name.removeprefix("pallas_")
        assert port_engine(port_engine(name)) == port_engine(name)
    with pytest.raises(ConfigError, match="not ported"):
        port_engine("pallas_mega99")
