"""The port's ``mega9`` and ``mega6`` engines (``ops/kernels/megaJ.py``:
``csrc/mega12.cu``'s doubled window on ``bsk_btk2`` and its single window
on ``bsk_btk``) against the JAX package's legacy Pallas kernels, on the
CPU: each plain rotation (the one ``mega8`` and ``mega7`` share) against
``legacy.py::_mega9_kernel`` and ``_mega6_kernel`` in interpret mode, run as the JAX package's own tests run them, and the NumPy
reference; the wrappers' checks; the gate path on each engine; and
``fit_engine``'s routes of both names against the JAX package's at the
port's key budget.  Array equality throughout: the arithmetic is exact mod
2^32.
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
from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import gates as tgates
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service.config import port_engine

# HALF = 2 at N = 256 moves the window and the negated run, at k = 1 and
# k = 2; n is cut to 8 steps so that interpret-mode rotations stay fast
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
# the legacy kernel -> the serial kernel whose function it shares
LEGACY = {"mega9": "mega8", "mega6": "mega7"}
# the legacy kernel -> the port key of that serial kernel, which it reads:
# mega8's bsk_btk2 and mega7's bsk_btk (the JAX package's mega8 and mega9
# read bsk_btj2, its mega7 and mega6 bsk_btj, in wgmma's order here)
SERIAL_KEYS = {"mega9": "bsk_btk2", "mega6": "bsk_btk"}


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
    """(client key, server key, JAX key, port key), in ``bsk_btj2`` and
    ``bsk_btj``, the port's also in ``mega7``'s ``bsk_btk`` and ``mega8``'s
    ``bsk_btk2``."""
    ck, sk = jref.keygen(params, np.random.default_rng(23))
    layouts = ("bsk_btj2", "bsk_btj")
    return (ck, sk, jsk.device_server_key(sk, layouts=layouts),
            tsk.device_server_key(sk, layouts=(*layouts, "bsk_btk",
                                               "bsk_btk2"), device="cpu"))


@pytest.mark.parametrize("B", [3, 37])
@pytest.mark.parametrize("name", list(LEGACY))
@pytest.mark.parametrize("params", [MULTITILE, MULTITILE_K2],
                         ids=["k1", "k2"])
def test_plain_rotation_equals_jax_legacy_pallas(params, name, B):
    _, sk, jdsk, tdsk = keys(params)
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    rng = np.random.default_rng(B + params.k + len(name))
    ct = rand_u32(rng, B, params.n + 1)
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine=f"pallas_{name}", unroll=True))
    before = kernel.launches
    got = to_numpy_u32(tbs.blind_rotate_batch(
        tdsk, from_numpy_u32(ct), tbs.make_test_poly(tdsk.params),
        engine=name))
    assert kernel.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[B - 1], jref.blind_rotate(sk, ct[B - 1],
                                      jref.make_test_poly(params)))


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_wrapper_checks(name):
    _, _, _, tdsk = keys(MULTITILE_K2)
    p = tdsk.params
    kernel = getattr(megaJ, f"{name}_blind_rotate")
    key = getattr(tdsk, megaJ.KEY_LAYOUTS[name])
    # another key: the other window width for mega9, the JAX package's
    # bsk_btj (bsk_btk's size) for mega6; both are csrc/mega12.cu's
    other = tdsk.bsk_btj
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
    for bad in (dc.replace(p, N=64), dc.replace(p, k=3)):
        with pytest.raises(ValueError):
            megaJ.check_params(bad, name)
    for pset in ("std128_k2", "std128", "std128_fast", "std128_shortint"):
        megaJ.check_params(PARAM_SETS[pset], name)
    # a set whose one ciphertext fills most of a shared-memory block, which
    # mega9's two-half block refused: csrc/mega12.cu's windows (digits and
    # accumulators in device memory) take it, mega9 and mega6 as mega8 and
    # mega7 do
    wide = dc.replace(PARAM_SETS["std128_shortint"], name="wide", k=4,
                      bg_bits=2, levels=13)
    megaJ.check_params(wide, LEGACY[name])
    megaJ.check_params(wide, name)
    assert megaJ.KERNELS[name] == megaJ.KERNELS[LEGACY[name]]
    assert tsk.layouts_for_engine(name) == (megaJ.KEY_LAYOUTS[name],)
    assert megaJ.KEY_LAYOUTS[name] == SERIAL_KEYS[name]
    assert tbs.ROTATION_ENGINES[name] == (kernel, megaJ.KEY_LAYOUTS[name])
    # the serial kernel's plain version on that key: mega8's
    # (blind_rotate_plain_btk2), and mega7's (mega12.blind_rotate_plain_btk)
    assert megaJ.plain(name) is megaJ.plain(LEGACY[name])
    assert port_engine(f"pallas_{name}") == name


@pytest.mark.parametrize("name", list(LEGACY))
def test_gate_batch_equals_serial_engine(name):
    """``gate_batch`` on each legacy engine gives the serial engine's
    outputs (tests/test_torch_megaJ.py holds those equal to the JAX
    package's), and they decrypt to the truth table."""
    ck, _, _, tdsk = keys(MULTITILE_K2)
    rng = np.random.default_rng(37)
    B = 12
    b1, b2 = (rng.integers(0, 2, B).astype(bool) for _ in range(2))
    ids = np.arange(B) % len(tgates.GATE_IDS)
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


@pytest.mark.parametrize("name", list(LEGACY))
def test_fit_engine_legacy_routes_equal_jax(name):
    """``mega9`` routes as ``mega8`` (the doubled key's check,
    ``server_key.py:694-699``) and ``mega6`` as ``mega7``, as the JAX
    package routes ``pallas_mega9`` and ``pallas_mega6``, on every named
    set at the port's budget and, for the doubled key, at a budget it does
    not fit."""
    for pset, p in PARAM_SETS.items():
        if p.N < 128:  # below the port's tile: mega13 (documented)
            assert tsk.fit_engine(name, p) == "mega13"
            continue
        want = jsk.fit_engine(f"pallas_{name}", JAX_SETS[pset],
                              hbm_budget_bytes=tsk.KEY_BUDGET_BYTES)
        assert tsk.fit_engine(name, p) == want.removeprefix("pallas_"), pset
        assert tsk.fit_engine(name, p) == name
    k2 = PARAM_SETS["std128_k2"]
    doubled = 2 * tsk.bt_key_bytes(k2)
    if name == "mega9":
        assert tsk.fit_engine(name, k2, budget_bytes=doubled - 1) == "mega12"
        assert jsk.fit_engine("pallas_mega9", JAX_SETS["std128_k2"],
                              hbm_budget_bytes=doubled - 1) == "pallas_mega12"
    else:
        assert tsk.fit_engine(name, k2, budget_bytes=doubled - 1) == "mega6"
        assert tsk.fit_engine(name, k2, budget_bytes=doubled // 2 - 1) \
            == "mega13"
