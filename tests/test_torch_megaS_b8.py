"""``mega17``, ``mega15`` and ``mega16`` on ``csrc/megaS.cu`` (``mega13``'s
kernel at the byte-aligned gadget, levels 3, 4 and 2, on ``bsk_btTc``),
emulated in NumPy on the CPU with ``tests/test_torch_megaS.py``'s emulator
and held array-equal to ``megaT.blind_rotate_plain_btTc`` (a ragged batch,
the K-split form and the unsplit one) and to the JAX package's
``_mega17_kernel`` / ``_mega15_kernel`` / ``_mega16_kernel`` (Pallas
interpret mode) at a toy geometry.  Beside it: ``bsk_btTc`` is ``bsk_btS``
byte for byte at these gadgets, so the three kernels read it as ``mega13``
reads ``bsk_btS``, and ``megaS.plan``'s work units and K splits at the N =
2048 sets against a hand count.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch
from test_torch_megaS import emulate, jax_rotation, keys, rotation

from herdsman_tpu_torch.core import PARAM_SETS, TOY
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import megaS, megaT
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the N = 2048 byte-aligned sets' gadgets (levels 3, 4 and 2) at n = 2 and
# N = 128 (one column tile), 256 (two) and 2048 (sixteen)
LAYOUT_CASES = [(name, N) for name in ("std128_shortint_b8",
                                       "std128_shortint_l4",
                                       "std128_shortint_fast")
                for N in (128, 256, 2048)]


@pytest.mark.parametrize("pset,N", LAYOUT_CASES,
                         ids=[f"{s.split('_')[-1]}-{N}"
                              for s, N in LAYOUT_CASES])
def test_btTc_is_btS_at_the_byte_aligned_gadget(pset, N):
    """``stream_key_layout`` builds the same bytes as ``bsk_btTc`` and as
    ``bsk_btS``: L*N is a multiple of 128, so the two row lengths agree and
    ``mega17``, ``mega15`` and ``mega16`` read ``bsk_btTc`` as ``mega13``
    reads ``bsk_btS``."""
    p = dc.replace(PARAM_SETS[pset], n=2, N=N)
    rng = np.random.default_rng(N + p.levels)
    bsk = from_numpy_u32(rng.integers(
        0, 1 << 32, (p.n, (p.k + 1) * p.levels, p.k + 1, N),
        dtype=np.uint64).astype(np.uint32))
    tc = tsk.stream_key_layout(p, bsk)
    s = tsk.stream_key_layout(p, bsk, any_gadget=True)
    assert tuple(tc.shape) == megaS.key_shape(p)
    assert megaT.row_bytes(p) == megaS.geometry(N, p.levels, False).RB
    assert torch.equal(tc, s)


def test_plan_by_hand_at_the_n2048_sets():
    """``megaS.plan``'s work units and K splits on the H100's 132 SMs at
    STD128_SHORTINT_B8 and _L4 (N = 2048, k = 1: 32 q-blocks a polynomial,
    kt = 96 and 128 K blocks an item); the kernels' registries."""
    b8 = PARAM_SETS["std128_shortint_b8"]
    l4 = PARAM_SETS["std128_shortint_l4"]
    # (tiles, qblocks, items, kt, splits, units): 7.76 waves at B = 2048,
    # one wave of 128 items at B = 256, K split in 2 at B = 9
    assert megaS.plan(b8, 2048) == (16, 32, 1024, 96, 1, 1024)
    assert megaS.plan(b8, 256) == (2, 32, 128, 96, 1, 128)
    assert megaS.plan(b8, 9) == (1, 32, 64, 96, 2, 128)
    assert megaS.plan(l4, 2048) == (16, 32, 1024, 128, 1, 1024)
    assert megaS.plan(l4, 256) == (2, 32, 128, 128, 1, 128)
    assert megaS.plan(l4, 9) == (1, 32, 64, 128, 2, 128)
    # a ragged batch: B = 300 is three tiles
    assert megaS.plan(b8, 300).units == 3 * 2 * 32
    for name in ("mega17", "mega15", "mega16"):
        assert not megaS.KERNELS[name]
    for name in ("mega17", "mega15", "mega16", "mega14"):
        assert megaS.GADGET[name] == (8, megaT.KERNELS[name])
    assert megaS.GADGET["mega16"] == (8, 2)


def geometry(L: int, N: int = 256, k: int = 1):
    return dc.replace(TOY, name=f"b8l{L}_k{k}_n{N}", n=2, N=N, k=k,
                      bg_bits=8, levels=L)


def bsk_btTc(p) -> torch.Tensor:
    """The kernels' key at ``p`` from the seeded keys of
    ``test_torch_megaS``."""
    sk, _ = keys(p)
    return tsk.stream_key_layout(p, from_numpy_u32(sk.bsk))


# (levels, N, k, B, SMs): at N = 256 two column tiles (a negated run), at
# N = 128 one tile and k+1 = 3; a ragged tile unsplit (8 SMs: 8 items on 8
# blocks) and split (132 SMs: 12 K splits of one block each), two tiles
# unsplit with the second ragged, one tile in 2 and in 16 splits, and at
# levels 2 a ragged tile in 8 (the last number: the K splits of the plan)
CASES = [(3, 256, 1, 37, 8, 1), (3, 256, 1, 37, 132, 12),
                 (4, 256, 1, 130, 16, 1), (4, 256, 1, 9, 132, 16),
                 (3, 128, 2, 9, 12, 2), (2, 256, 1, 37, 132, 8)]


@pytest.mark.parametrize("L,N,k,B,n_sms,splits", CASES,
                         ids=[f"l{c[0]}-n{c[1]}-k{c[2]}-B{c[3]}-sm{c[4]}"
                              for c in CASES])
def test_emulated_b8_equals_plain(L, N, k, B, n_sms, splits):
    p = geometry(L, N, k)
    assert megaS.plan(p, B, n_sms=n_sms).splits == splits
    key = bsk_btTc(p)
    _, acc0, a_t = rotation(p, B, B + 5 * L)
    plain = to_numpy_u32(megaT.blind_rotate_plain_btTc(p, acc0, a_t, key))
    got = emulate(p, to_numpy_u32(acc0).astype(np.int64), a_t.numpy(),
                  key.numpy(), False, n_sms)
    np.testing.assert_array_equal(got, plain)


ENGINE_AT_LEVELS = {3: "mega17", 4: "mega15", 2: "mega16"}


@pytest.mark.parametrize("L", list(ENGINE_AT_LEVELS),
                         ids=list(ENGINE_AT_LEVELS.values()))
def test_emulated_b8_equals_jax_pallas(L):
    """The emulated kernel at levels 3, 4 and 2 against the JAX package's
    ``pallas_mega17`` / ``pallas_mega15`` / ``pallas_mega16`` rotation of
    the same ciphertexts (interpret mode)."""
    p = geometry(L)
    want, acc0, a_t, _ = jax_rotation(f"pallas_{ENGINE_AT_LEVELS[L]}", p, 3)
    got = emulate(p, to_numpy_u32(acc0).astype(np.int64), a_t.numpy(),
                  bsk_btTc(p).numpy(), False, 132)
    np.testing.assert_array_equal(got, want)
