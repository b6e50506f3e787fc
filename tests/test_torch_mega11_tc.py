"""NumPy emulation of ``csrc/mega12.cu``'s doubled window (``mega11`` on
int8 tensor cores) on the CPU, before and beside the card, with
``tests/test_torch_mega12_tc.py``'s emulator: K block e of column tile ct
is (sub = e / R, r = e % R), stored group HALF-1-ct+sub of ``bsk_btk2``
and digit row tile r*HALF + sub of the scratch, one run a tile or split
(no negated run, nothing subtracted), under ``mega12.plan``'s tiles, K
splits and two-block clusters (one with a lone M tile).  The emulated
rotation is held array-equal to ``megaJ.blind_rotate_plain_btk2`` and to
the JAX ``_mega11_kernel`` (Pallas interpret mode) at N = 256 (two column
tiles), k = 1 and 2, levels 2.  Beside it: ``bsk_btk2`` read back by
``from_kmajor_order`` is the JAX package's windowed (j, c, q) layout, and
``mega7`` (``mega12``'s single window on ``bsk_btk``) equals the JAX
``_mega7_kernel`` on its ``bsk_btj``.
"""

import dataclasses as dc
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mega12_tc import (BN, P, RING_BASE, U32, emulate,
                                  k_block, read_operand, sw128_desc)

from herdsman_tpu.core import TOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12, megaJ
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# HALF = 2: the window moves with the column tile; n cut to 8 steps
GEOMETRIES = {"k1": dc.replace(TOY, name="toy_w_k1", n=8, N=256, levels=2),
              "k2": dc.replace(TOY, name="toy_w_k2", n=8, N=256, k=2,
                               levels=2)}
# SM counts that reach each plan at these widths: 132 (the H100: 64-row
# tiles, K split at B <= 64), 8 (128-row tiles, clusters), 2048 (every K
# block split apart)
CASES = [(3, 132), (9, 2048), (129, 8)]


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
def keys(geom: str):
    """(params, port params, JAX key in ``bsk_btj2j`` and ``bsk_btj``, port
    key in ``bsk_btj2j``, ``bsk_btk2`` and ``bsk_btk``)."""
    params = GEOMETRIES[geom]
    _, sk = jref.keygen(params, np.random.default_rng(53))
    jdsk = jsk.device_server_key(sk, layouts=("bsk_btj2j", "bsk_btj"))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_btj2j", "bsk_btk2",
                                              "bsk_btk"), device="cpu")
    return params, tdsk.params, jdsk, tdsk


@functools.cache
def ciphertexts(geom: str, B: int) -> np.ndarray:
    params = GEOMETRIES[geom]
    rng = np.random.default_rng(B + params.k)
    return rng.integers(0, U32, (B, params.n + 1),
                        dtype=np.uint64).astype(np.uint32)


@functools.cache
def jax_rotation(geom: str, B: int, engine: str) -> np.ndarray:
    """The JAX package's rotation of ``ciphertexts(geom, B)`` on ``engine``
    (Pallas interpret mode)."""
    params, _, jdsk, _ = keys(geom)
    return np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ciphertexts(geom, B)), jbs.make_test_poly(params),
        engine=engine, unroll=True))


def rotation_inputs(geom: str, B: int):
    p = keys(geom)[1]
    return tbs.rotation_inputs(p, from_numpy_u32(ciphertexts(geom, B)),
                               tbs.make_test_poly(p))


def test_doubled_k_blocks_walk_one_window():
    """Column tile ct's K blocks visit every (sub, r) once, in stored
    groups HALF-1-ct .. 2*HALF-2-ct (the last group is never read), and
    the plan is ``mega12``'s under either window."""
    for p in GEOMETRIES.values():
        HALF, R = p.N // P, (p.k + 1) * p.levels
        seen_groups = set()
        for ct in range(HALF):
            blocks = [k_block(e, ct, R, HALF, doubled=True)
                      for e in range(R * HALF)]
            assert sorted((sub, r) for _, r, sub in blocks) == [
                (sub, r) for sub in range(HALF) for r in range(R)]
            for m, _, sub in blocks:
                assert m == HALF - 1 - ct + sub
                seen_groups.add(m)
        assert seen_groups == set(range(2 * HALF - 1))
    tp = TFHEParams(**dc.asdict(GEOMETRIES["k2"]))
    assert megaJ.key_shape(tp, "mega11") == mega12.key_shape(tp, True) == (
        8, 4, 6, 3, 2, BN, P)
    assert megaJ.key_shape(tp, "mega7") == mega12.key_shape(tp)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_btk2_reads_back_as_jax_window(geom):
    """``bsk_btk2`` is the JAX package's windowed (j, c, q) key in
    ``wgmma``'s order: ``from_kmajor_order`` gives it back, and one staged
    tile read through the descriptor is row n = 64j + q' of column (j, c,
    64*qhalf + q') of stored group m."""
    params, p, jdsk, tdsk = keys(geom)
    jwin = np.asarray(jdsk.bsk_btj2j)
    np.testing.assert_array_equal(tdsk.bsk_btj2j.numpy(), jwin)
    np.testing.assert_array_equal(
        mega12.from_kmajor_order(tdsk.bsk_btk2).numpy(), jwin)
    assert tdsk.bsk_btk2.numel() == 2 * tsk.bt_key_bytes(p)
    kp1, R = p.k + 1, (p.k + 1) * p.levels
    btk2 = tdsk.bsk_btk2.numpy()
    smem = np.zeros(RING_BASE + BN * P, np.int8)
    for i, m, r, c, qh in ((0, 0, 0, 0, 0), (5, 2, R - 1, kp1 - 1, 1),
                           (p.n - 1, 3, 1, 0, 1)):
        smem[RING_BASE:] = btk2[i, m, r, c, qh].reshape(-1)
        read = np.concatenate([read_operand(smem, sw128_desc(
            RING_BASE + 32 * kk), BN) for kk in range(P // 32)], axis=1)
        j, q = np.arange(BN) // 64, qh * 64 + np.arange(BN) % 64
        np.testing.assert_array_equal(
            read, jwin[i, m, r][:, j * kp1 * P + c * P + q].T)


@pytest.mark.parametrize("B, n_sms", CASES)
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_emulated_doubled_kernel_equals_plain_and_jax(geom, B, n_sms):
    params, p, _, tdsk = keys(geom)
    want = jax_rotation(geom, B, "pallas_mega11")
    acc0, a_t = rotation_inputs(geom, B)
    before = megaJ.mega11_blind_rotate.launches
    plain = megaJ.mega11_blind_rotate(p, acc0, a_t, tdsk.bsk_btk2)
    assert megaJ.mega11_blind_rotate.launches == before  # no kernel here
    np.testing.assert_array_equal(to_numpy_u32(plain), want)
    np.testing.assert_array_equal(to_numpy_u32(megaJ.blind_rotate_plain_btj2(
        p, acc0, a_t, tdsk.bsk_btj2j, jcq=True)), want)
    got = emulate(p, to_numpy_u32(acc0).astype(np.int64), a_t.numpy(),
                  tdsk.bsk_btk2.numpy(), n_sms, doubled=True)
    np.testing.assert_array_equal(
        got, want, err_msg=f"{p.name} B={B} n_sms={n_sms} "
                           f"plan={mega12.plan(p, B, n_sms)}")


def test_emulated_doubled_cluster_with_a_lone_m_tile():
    """Three 128-row M tiles in two-block clusters: the second cluster's
    second block computes on pad rows only and stores nothing."""
    _, p, _, tdsk = keys("k1")
    B = 300
    assert mega12.plan(p, B, 8)[:3] == (128, 1, 2)
    rng = np.random.default_rng(7)
    acc0 = rng.integers(0, U32, (B, p.k + 1, p.N))
    a_t = rng.integers(0, 2 * p.N, (p.n, B))
    want = to_numpy_u32(megaJ.blind_rotate_plain_btk2(
        p, from_numpy_u32(acc0.astype(np.uint32)),
        torch.from_numpy(a_t.astype(np.int32)), tdsk.bsk_btk2))
    np.testing.assert_array_equal(
        emulate(p, acc0, a_t, tdsk.bsk_btk2.numpy(), 8, doubled=True), want)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_mega7_on_btk_equals_jax_mega7(geom):
    """``mega7`` is ``mega12``'s single window on ``bsk_btk``: its rotation
    through the engine table (the plain version, on the CPU), ``mega12``'s
    plain version and the emulated kernel equal the JAX ``_mega7_kernel``
    on ``bsk_btj``."""
    params, p, _, tdsk = keys(geom)
    B = 9
    want = jax_rotation(geom, B, "pallas_mega7")
    acc0, a_t = rotation_inputs(geom, B)
    before = megaJ.mega7_blind_rotate.launches
    got = tbs.blind_rotate_batch(tdsk, from_numpy_u32(ciphertexts(geom, B)),
                                 tbs.make_test_poly(p), engine="mega7")
    assert megaJ.mega7_blind_rotate.launches == before
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(to_numpy_u32(mega12.blind_rotate_plain_btk(
        p, acc0, a_t, tdsk.bsk_btk)), want)
    np.testing.assert_array_equal(
        emulate(p, to_numpy_u32(acc0).astype(np.int64), a_t.numpy(),
                tdsk.bsk_btk.numpy(), 132), want)
