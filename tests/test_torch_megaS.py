"""NumPy emulation of ``csrc/megaS.cu`` (``mega13`` and ``mega14`` on int8
tensor cores, the key ``wgmma``'s register A operand built from its compact
limb sequences) on the CPU, before and beside the card: phase (a)'s digit
stores into the K-permuted, pre-swizzled scratch [k+1, NBc, B_pad, 128];
phase (b)'s items, their K blocks (the wrapped ones first), the producer's
bulk copies of one digit tile and of the four limbs' 16-byte-aligned key
slices into a stage; each consumer thread's nine aligned words a limb, its
funnel shifts and the A fragments they make, read by ``wgmma`` in the
m64nNk32 register layout beside the digit tile read through the
descriptor's (start, SBO, swizzle) fields; each run started by its first
``wgmma`` (scale-d 0), the negated run's recombined words subtracted from
``out`` before the positive run's are added.  Shared memory and the
accumulators start as garbage, so a byte that no copy wrote shows up in the
result.  The emulated rotation is held array-equal to the plain versions
(``mega13.blind_rotate_plain_btS``, ``megaT.blind_rotate_plain_btTe``),
which are held to the JAX package's ``pallas_mega13`` / ``pallas_mega14``
(Pallas interpret mode) and to its NumPy reference; ``bsk_btS``'s rows are
held to the block-Toeplitz key's blocks at two gadgets.  A model of the
ring's barrier protocol (the producer and the two consumer warpgroups on
each stage's full and empty mbarriers, across work units, K splits and
steps) runs over ``megaS.plan`` at N = 32 to 2048 and widths 1 to 2048,
and a launch's ``bootstrap.megaS_turns`` count is held to it.
"""

import collections
import dataclasses as dc
import functools
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY as JTOY
from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core import PARAM_SETS, TOY
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import _build, mega13, megaS, megaT
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.utils import megaS_ablation, tracing

# the kernel's constants (csrc/megaS.cu)
KB, NT, QI, KSLOT = megaS.KB, megaS.NT, megaS.QI, megaS.KSLOT
D_BYTES = NT * KB
STAGE = D_BYTES + 4 * KSLOT
SMEM_PER_BLOCK = 232448
STAGES = (SMEM_PER_BLOCK - 1024 - 256) // STAGE
RING_BASE = 1024  # the ring's shared address: 1024-aligned, as the kernel's
U32 = 1 << 32

# mega13's geometry classes, n cut to 2 steps: the byte-aligned gadget at
# N = 256 (two column tiles: a negated run) and STD128_K2's N = 512, k = 2
# (four tiles, up to six wrapped K blocks a polynomial); bg = 2^7, l = 3
# (row offsets 3 bytes apart: every word alignment); the exact W = 32
# gadget at N = 128 (one tile); TOY (N = 64: the tile is N, the stream of
# 192 bytes padded to 256); and N = 32, l = 1 (a 32-byte stream in one
# padded block, the second consumer warpgroup idle)
MEGA13_SETS = [
    dc.replace(TOY, name="b8l2_k1_n256", n=2, N=256, k=1, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="b8l2_k2_n512", n=2, N=512, k=2, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="b7l3_k1_n256", n=2, N=256, k=1, bg_bits=7,
               levels=3),
    dc.replace(TOY, name="b8l4_k1_n128", n=2, N=128, k=1, bg_bits=8,
               levels=4),
    dc.replace(TOY, name="toy", n=2),
    dc.replace(TOY, name="b8l1_k1_n32", n=2, N=32, k=1, bg_bits=8,
               levels=1),
]
# mega14's: k = 1 and STD128_K4's k = 4 at N = 256
MEGA14_SETS = [
    dc.replace(TOY, name="b8l2_k1_n256", n=2, N=256, k=1, bg_bits=8,
               levels=2),
    dc.replace(TOY, name="b8l2_k4_n256", n=2, N=256, k=4, bg_bits=8,
               levels=2),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: under parallel test
    workers, torch's thread pool would contend for cores with the others'
    XLA threads and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def swizzle(addr):
    """The 128-byte swizzle on shared addresses: 16-byte chunk bits [4, 7)
    XOR row bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def sw128_desc(addr: int) -> int:
    """``sw128_desc`` of ``csrc/hopper.cuh``: start >> 4, LBO 16 B, SBO
    1024 B, layout 1 (128B swizzle)."""
    return (((addr & 0x3FFFF) >> 4) | ((16 >> 4) << 16)
            | ((1024 >> 4) << 32) | (1 << 62))


def read_operand(smem: np.ndarray, desc: int, rows: int) -> np.ndarray:
    """What ``wgmma`` reads through ``desc``: a K-major [rows, 32] int8
    operand, 8-row groups SBO apart, rows 128 bytes apart, the 128-byte
    swizzle on the address."""
    assert desc >> 62 == 1  # 128B swizzle, K-major
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return smem[swizzle(start + (r // 8) * sbo + (r % 8) * KB + k)]


# a consumer warpgroup's threads: warp [4, 1], lane [1, 32]
WARP = np.arange(4)[:, None]
LANE = np.arange(32)[None, :]
G_, TIG = LANE // 4, LANE % 4


# where register r's byte of lane (g, t) in warp w lands in the [64, 32] A
# operand (wgmma's m64nNk32 8-bit layout): row 16w + g + 8(r % 2), K byte
# 16(r // 2) + 4t + byte, least significant first
_R = np.arange(4)[None, None, :, None]
_BYTE = np.arange(4)[None, None, None, :]
A_ROW = np.broadcast_to(16 * WARP[..., None, None] + G_[..., None, None]
                        + 8 * (_R % 2), (4, 32, 4, 4))
A_COL = np.broadcast_to(16 * (_R // 2) + 4 * TIG[..., None, None] + _BYTE,
                        (4, 32, 4, 4))
assert np.unique(A_ROW * 32 + A_COL).size == 64 * 32  # each element once


def a_tiles(regs: np.ndarray) -> np.ndarray:
    """The int8 A operands [..., 64, 32] that warpgroup registers [..., 4
    warps, 32 lanes, 4] (u32) hold."""
    v = (regs[..., None] >> (8 * np.arange(4))) & 0xFF   # [..., 4, 32, 4, 4]
    A = np.empty(regs.shape[:-3] + (64, 32), np.int64)
    A[..., A_ROW, A_COL] = np.where(v >= 128, v - 256, v)
    return A


def fragment(acc: np.ndarray) -> np.ndarray:
    """The m64n128 s32 accumulator fragment [4 warps, 32 lanes, 64] of a
    tile [64, 128]: d[i] is row 16w + g + 8((i % 4) // 2), column 8(i // 4)
    + 2t + i % 2."""
    i = np.arange(64)[None, None, :]
    row = 16 * WARP[..., None] + G_[..., None] + 8 * ((i % 4) // 2)
    col = 8 * (i // 4) + 2 * TIG[..., None] + i % 2
    return acc[row, col]


def digit_phase(p, out, rot, dig, g):
    """Phase (a) of one step: every stream word of X^rot acc - acc (b < B)
    into the scratch ``dig`` [k+1, NBc, B_pad, 128] (uint8) at its
    K-permuted, swizzled address; each word stored once."""
    B, kp1, N = out.shape
    L, bg = p.levels, p.bg_bits
    W = bg * L
    half, dmask = 1 << (bg - 1), (1 << bg) - 1
    offset = sum(half << (bg * lev) for lev in range(L))
    y = np.arange(N)
    t = (y[None, :] - rot[:, None]) & (2 * N - 1)            # [B, N]
    rv = np.take_along_axis(out, (t & (N - 1))[:, None, :], axis=2)
    rv = np.where((t >= N)[:, None, :], (U32 - rv) % U32, rv)
    diff = (rv - out) % U32
    val = (((diff + (1 << (31 - W))) % U32) >> (32 - W)) if W < 32 else diff
    val = (val + offset) % U32                                 # [B, k+1, N]
    lev = np.arange(L)
    digit = (((val[..., None] >> (bg * (L - 1 - lev))) & dmask) - half) & 0xFF
    # stream byte L*z + lb: the digit of level L-1-lb of coefficient z
    stream = digit[..., ::-1].reshape(B, kp1, L * N // 4, 4)
    w = np.arange(L * N // 4)
    b = np.arange(B)[:, None, None]
    c = np.arange(kp1)[None, :, None]
    flat = dig.reshape(-1)
    base = ((c * g.NBc + (w >> 5)) * dig.shape[2] + b) * KB
    offs = np.vectorize(megaS.permuted_word_offset)(w & 31, b)
    addr = base + offs                                         # [B, k+1, W4]
    assert np.unique(addr).size == addr.size
    for byte in range(4):
        flat[addr + byte] = stream[..., byte]


def item_of(p, g, t, qblocks, extended):
    """(bt, c_out, y0, q_lo, q_hi, rot) of item t (``item_of``)."""
    kp1 = p.k + 1
    bt, r = divmod(t, kp1 * qblocks)
    c_out, qb = divmod(r, qblocks)
    y = qb * QI
    ct = 0 if extended else y // g.P
    y0 = ct * g.P
    q_lo = y - y0
    q_hi = min(q_lo + QI, g.P) - 1
    return bt, c_out, y0, q_lo, q_hi, 0 if extended else p.levels * y0 // KB


def k_block(p, g, rot, e):
    """(c_in, kb, sig) of an item's K block e, the wrapped ones first."""
    nneg = (p.k + 1) * rot
    if e < nneg:
        c_in, sig = divmod(e, rot)
        return c_in, g.NBc - rot + sig, sig
    c_in, kb = divmod(e - nneg, g.NBc - rot)
    return c_in, kb, kb + rot


def emulate(p, acc0, a_t, key, extended, n_sms):
    """The kernel's output (u32 [B, k+1, N]) on a card of ``n_sms`` SMs,
    step by step: phase (a), then every work unit (an item's K split) of
    phase (b), stage by stage as the producer fills and the two consumer
    warpgroups read them; the splits' words add (``red.add``) in any order,
    a lone split's as one read-modify-write."""
    B, kp1, N = acc0.shape
    L = p.levels
    g = megaS.geometry(N, L, extended)
    pl = megaS.plan(p, B, extended, n_sms)
    assert STAGES * STAGE + 1024 + 16 * STAGES <= SMEM_PER_BLOCK
    assert key.shape == megaS.key_shape(p, extended)
    B_pad = pl.tiles * NT
    rng = np.random.default_rng(B + N)
    dig = np.zeros((kp1, g.NBc, B_pad, KB), np.uint8)  # the entry's memset
    assert dig.size == megaS.scratch_bytes(p, B, extended)
    keyb = key.reshape(-1).astype(np.uint8)
    RB = g.RB
    out = acc0.astype(np.int64) % U32
    stores = np.zeros((B, kp1, N), np.int64)
    for i in range(p.n):
        digit_phase(p, out, a_t[i].astype(np.int64), dig, g)
        for t in range(pl.units):
            bt, c_out, y0, q_lo, q_hi, rot = item_of(p, g, t // pl.splits,
                                                     pl.qblocks, extended)
            e0, e1 = megaS.split_range(pl.kt, t % pl.splits, pl.splits)
            assert e1 > e0
            nneg = kp1 * rot
            neg_end = min(nneg, e1)
            o_min, o_max = L * (g.P - 1 - q_hi), L * (g.P - 1 - q_lo)
            smem = rng.integers(0, 256, RING_BASE + STAGES * STAGE).astype(
                np.uint8)                                    # garbage
            acc = rng.integers(-U32, U32, (2, 2, 64, NT))    # garbage
            for e in range(e0, e1):
                c_in, kb, sig = k_block(p, g, rot, e)
                st = RING_BASE + (e % STAGES) * STAGE
                # the producer's bulk copies: the digit tile, the 4 slices
                smem[st:st + D_BYTES] = dig[c_in, sig,
                                            bt * NT:(bt + 1) * NT].reshape(-1)
                start = (o_min + KB * kb) & ~15
                length = ((o_max + KB * kb + KB + 4 + 15) & ~15) - start
                assert length % 16 == 0 and 0 < length <= KSLOT
                assert start + length <= RB
                for j in range(4):
                    seq = ((((i * kp1 + c_in) * kp1 + c_out) * 4 + j) * RB
                           + start)
                    dst = st + D_BYTES + j * KSLOT
                    smem[dst:dst + length] = keyb[seq:seq + length]
                first = e in (e0, nneg)
                for wg in range(2):
                    if q_lo + 32 * wg > q_hi:  # an idle warpgroup
                        continue
                    q = q_lo + 32 * wg + 8 * WARP + G_             # [4, 32]
                    rel = L * (g.P - 1 - q) - o_min + (o_min & 15) + 32 * TIG
                    # the 9 words a limb lie in the copied slice
                    assert (rel >= 0).all() and ((rel & ~3) + 36 <= length).all()
                    # each limb's 9 aligned words (little-endian), then the
                    # funnel shifts: register 2hf + (j % 2) of tile j // 2
                    base = (st + D_BYTES + KSLOT * np.arange(4)[:, None, None]
                            + (rel & ~3))[..., None, None]      # [j, w, l]
                    byts = smem[base + 4 * np.arange(9)[:, None]
                                + np.arange(4)].astype(np.int64)
                    wds = (byts << (8 * np.arange(4))).sum(-1)  # [j,w,l,9]
                    sh = ((rel & 3) * 8)[..., None]
                    pair = (wds[..., 1:] << 32) | wds[..., :-1]
                    frag = (pair >> sh) & (U32 - 1)          # [j, w, l, 8]
                    frag = frag.reshape(2, 2, 4, 32, 4, 2)   # [T, h, w, l, kk, hf]
                    regs = frag.transpose(0, 4, 2, 3, 5, 1).reshape(
                        2, 4, 4, 32, 4)                      # [T, kk, w, l, r]
                    A = a_tiles(regs)                        # [T, kk, 64, 32]
                    Bm = np.stack([read_operand(smem, sw128_desc(st + 32 * kk),
                                                NT) for kk in range(4)])
                    Bm = np.where(Bm >= 128, Bm.astype(np.int64) - 256, Bm)
                    prod = np.einsum("tkmi,kni->tmn", A, Bm)  # [T, 64, 128]
                    acc[wg] = prod if first else acc[wg] + prod
                negated_end = e + 1 == neg_end and neg_end > e0
                positive_end = e + 1 == e1 and e1 > max(e0, nneg)
                runs = ([(-1, neg_end - e0)] * negated_end
                        + [(1, e1 - max(e0, nneg))] * positive_end)
                for sign, run_blocks in runs:
                    for wg in range(2):
                        if q_lo + 32 * wg > q_hi:
                            continue
                        f0 = fragment(acc[wg, 0] % U32)
                        f1 = fragment(acc[wg, 1] % U32)
                        q = q_lo + 32 * wg + 8 * WARP + G_
                        for x in range(32):
                            ix = 4 * (x >> 1) + (x & 1)
                            word = (f0[..., ix] + (f0[..., ix + 2] << 8)
                                    + (f1[..., ix] << 16)
                                    + (f1[..., ix + 2] << 24)) % U32
                            b = bt * NT + 8 * (x >> 1) + 2 * TIG + (x & 1)
                            bb, yy, ww = np.broadcast_arrays(b, y0 + q, word)
                            ok = bb < B
                            idx = (bb[ok], c_out, yy[ok])
                            np.add.at(out, idx, sign * ww[ok])
                            np.add.at(stores, idx, run_blocks)
                            out %= U32
    assert (stores == p.n * pl.kt).all(), \
        "an output word not given each K block once a step"
    return out.astype(np.uint32)


@functools.cache
def keys(p: TFHEParams):
    """(host server key, the port's key with ``bsk_btS``, ``bsk_btTe`` and
    ``bsk_bt`` where the set has them) at ``p``, from a seed."""
    _, sk = jref.keygen(p, np.random.default_rng(p.N + p.levels + p.k))
    layouts = ["bsk_btS"]
    if p.bg_bits == 8 and p.levels == 2 and p.N >= 256:
        layouts.append("bsk_btTe")
    if p.N >= 128:
        layouts.append("bsk_bt")
    return sk, tsk.device_server_key(sk, layouts=tuple(layouts),
                                     device="cpu")


def rotation(p, B, seed):
    """(ct, acc0, a_t) of a random batch of B ciphertexts at ``p``."""
    rng = np.random.default_rng(seed)
    ct = rng.integers(0, U32, (B, p.n + 1), dtype=np.uint64).astype(np.uint32)
    acc0, a_t = tbs.rotation_inputs(p, from_numpy_u32(ct),
                                    tbs.make_test_poly(p))
    return ct, acc0, a_t


def test_geometry_and_plan():
    """``megaS.geometry`` and ``plan`` at the smoke run's sets: the tile,
    the padded stream, the sequence bytes (``bsk_btTc``'s and
    ``bsk_btTe``'s where those exist) and the items a step."""
    k2, k4 = PARAM_SETS["std128_k2"], PARAM_SETS["std128_k4"]
    assert megaS.geometry(512, 2, False) == (128, 8, 1024, 1296)
    assert megaS.geometry(512, 2, False).RB == megaT.row_bytes(k2)
    assert megaS.geometry(256, 2, True).RB == megaT.row_bytes(k4, True)
    assert megaS.geometry(64, 3, False) == (64, 2, 256, 464)
    assert megaS.geometry(32, 1, False) == (32, 1, 128, 176)
    assert megaS.key_shape(k2) == (768, 3, 3, 4, 1296)  # 34.2 MiB
    assert megaS.plan(k2, 2048) == (16, 8, 384, 24, 1, 384)
    assert megaS.plan(k2, 256) == (2, 8, 48, 24, 2, 96)  # K split in 2
    assert megaS.plan(k2, 128).splits == 5
    assert megaS.plan(k4, 2048, True) == (16, 4, 320, 20, 1, 320)
    assert megaS.plan(k4, 256, True).splits == 3
    # each split takes at least one K block, the splits cover K once
    for kt, splits in ((24, 5), (20, 3), (2, 2)):
        ranges = [megaS.split_range(kt, s, splits) for s in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == kt
        assert all(e1 > e0 for e0, e1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert megaS.plan(PARAM_SETS["std128"], 2048).kt == 48
    # the digit words of a block are a permutation of its 32 word slots,
    # each ciphertext row's own
    for b in range(8):
        offs = {megaS.permuted_word_offset(w, b) for w in range(32)}
        assert offs == set(range(0, KB, 4))


# (set, B, SMs): one tile of 128 ciphertexts (B = 9) everywhere on the
# H100's 132 SMs (K split up to 8 ways: a split starts, ends or holds the
# negated run), two (B = 130, the second ragged) where a step has few
# items, on 8 SMs (K not split, one read-modify-write a word)
MEGA13_CASES = [(q, B, 132 if B == 9 else 8) for q in MEGA13_SETS
                for B in (9, 130) if B == 9 or q.N <= 256]


@pytest.mark.parametrize("params,B,n_sms", MEGA13_CASES,
                         ids=[f"{q.name}-{B}-{n}" for q, B, n in MEGA13_CASES])
def test_emulated_mega13_equals_plain(params, B, n_sms):
    p = params
    sk, dsk = keys(p)
    ct, acc0, a_t = rotation(p, B, B + p.N)
    plain = to_numpy_u32(mega13.blind_rotate_plain_btS(p, acc0, a_t,
                                                       dsk.bsk_btS))
    got = emulate(p, to_numpy_u32(acc0).astype(np.int64), a_t.numpy(),
                  dsk.bsk_btS.numpy(), False, n_sms)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        plain[0], jref.blind_rotate(sk, ct[0], jref.make_test_poly(p)))


MEGA14_CASES = [(MEGA14_SETS[0], 9, 132), (MEGA14_SETS[0], 130, 8),
                (MEGA14_SETS[1], 9, 132)]


@pytest.mark.parametrize("params,B,n_sms", MEGA14_CASES,
                         ids=[f"{q.name}-{B}-{n}" for q, B, n in MEGA14_CASES])
def test_emulated_mega14_equals_plain(params, B, n_sms):
    p = params
    sk, dsk = keys(p)
    ct, acc0, a_t = rotation(p, B, B + p.k)
    plain = to_numpy_u32(megaT.blind_rotate_plain_btTe(p, acc0, a_t,
                                                       dsk.bsk_btTe))
    got = emulate(p, to_numpy_u32(acc0).astype(np.int64), a_t.numpy(),
                  dsk.bsk_btTe.numpy(), True, n_sms)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        plain[B - 1], jref.blind_rotate(sk, ct[B - 1],
                                        jref.make_test_poly(p)))


def limb_value(limbs: np.ndarray, axis: int) -> np.ndarray:
    """The u32 that 4 balanced int8 limbs along ``axis`` stand for."""
    limbs = np.moveaxis(limbs.astype(np.int64), axis, -1)
    return sum(limbs[..., j] << (8 * j) for j in range(4)) % U32


@pytest.mark.parametrize("params", [MEGA13_SETS[0], MEGA13_SETS[2]],
                         ids=["b8l2", "b7l3"])
def test_btS_rows_are_block_toeplitz_blocks(params):
    """Row (j, c_out, q) of ``bsk_btS`` (``expand_rows``) at key byte s_rel
    = (L*z + lb - L*ct*P) mod L*N, its 4 limbs read as a u32, is the factor
    of digit z of GGSW row c_in*L + L-1-lb in output coefficient ct*P + q:
    the block-Toeplitz key's stored block (ct - z // P) mod HALF at row z %
    P, column (c_out, j, q), as ``mega12``'s formula applies it (negated
    for z // P > ct), negated where ``megaS.cu`` subtracts the run (z <
    ct*P)."""
    p = params
    _, dsk = keys(p)
    L, N, kp1 = p.levels, p.N, p.k + 1
    P, HALF = 128, N // 128
    LN = L * N
    z = np.arange(N)[:, None]
    lb = np.arange(L)[None, :]
    for i in range(p.n):
        rows = mega13.expand_rows(p, dsk.bsk_btS[i]).numpy()
        rows = limb_value(rows.reshape(LN, kp1, 4, kp1, P), 2)  # [s, c_in, c, q]
        bt = dsk.bsk_bt[i].numpy().reshape(kp1, L, HALF, P, kp1, 4, P)
        bt = limb_value(bt, 5)                      # [c_in, lev, m, p, c, q]
        for ct in range(HALF):
            s_rel = (L * z + lb - L * ct * P) % LN            # [N, L]
            got = rows[s_rel]                           # [N, L, c_in, c, q]
            got = np.where((z < ct * P)[..., None, None, None],
                           (U32 - got) % U32, got)
            want = bt[:, L - 1 - lb, (ct - z // P) % HALF, z % P]
            want = np.where((z // P > ct)[None, ..., None, None],
                            (U32 - want) % U32, want)   # [c_in, N, L, c, q]
            np.testing.assert_array_equal(got, np.moveaxis(want, 0, 2),
                                          err_msg=f"step {i} tile {ct}")


@pytest.mark.parametrize("params", MEGA14_SETS, ids=["k1", "k4"])
def test_btS_with_tile_N_is_bsk_btTe(params):
    """At the byte-aligned gadget the extended key is the stream key with
    a tile of N (``stream_key_layout``), and ``bsk_btS`` at N >= 128 is
    ``bsk_btTc``."""
    p = params
    sk, dsk = keys(p)
    bsk = from_numpy_u32(sk.bsk)
    assert torch.equal(dsk.bsk_btS, tsk.stream_key_layout(p, bsk))
    assert tuple(dsk.bsk_btTe.shape) == megaS.key_shape(p, True)


@functools.cache
def jax_rotation(engine, p, B):
    """The JAX package's rotation of a random batch on ``engine`` (Pallas
    interpret mode), the port's inputs and key for the same batch."""
    jp = dc.replace(JTOY, **{f.name: getattr(p, f.name)
                             for f in dc.fields(p)})
    sk, dsk = keys(p)
    ct, acc0, a_t = rotation(p, B, 3 * B + p.N)
    jdsk = jsk.device_server_key(sk, layouts=jsk.layouts_for_engine(engine))
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(jp), engine=engine,
        unroll=True))
    return want, acc0, a_t, dsk


@pytest.mark.parametrize("params", [MEGA13_SETS[0], MEGA13_SETS[1]],
                         ids=["k1_n256", "k2_n512"])
def test_plain_btS_equals_jax_pallas_mega13(params):
    p = params
    want, acc0, a_t, dsk = jax_rotation("pallas_mega13", p, 3)
    got = to_numpy_u32(mega13.blind_rotate_plain_btS(p, acc0, a_t,
                                                     dsk.bsk_btS))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", MEGA14_SETS, ids=["k1", "k4"])
def test_plain_btTe_equals_jax_pallas_mega14(params):
    p = params
    want, acc0, a_t, dsk = jax_rotation("pallas_mega14", p, 3)
    got = to_numpy_u32(megaT.blind_rotate_plain_btTe(p, acc0, a_t,
                                                     dsk.bsk_btTe))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", MEGA13_SETS[2:],
                         ids=[q.name for q in MEGA13_SETS[2:]])
def test_plain_btS_equals_reference_at_other_gadgets(params):
    """The gadgets the JAX ``pallas_mega13`` does not take (bg = 2^7, the
    exact W = 32 one, TOY's, one level): the plain version against the
    NumPy reference rotation, ciphertext by ciphertext."""
    p = params
    sk, dsk = keys(p)
    ct, acc0, a_t = rotation(p, 4, 7 + p.N)
    got = to_numpy_u32(mega13.blind_rotate_plain_btS(p, acc0, a_t,
                                                     dsk.bsk_btS))
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], jref.blind_rotate(sk, ct[i], jref.make_test_poly(p)))


def test_mega13_wrapper_and_routes():
    """The wrapper's checks, its key layout and the engines' routes."""
    p = MEGA13_SETS[2]
    _, dsk = keys(p)
    acc0 = torch.zeros(2, p.k + 1, p.N, dtype=torch.int32)
    a_t = torch.zeros(p.n, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bsk_btS"):  # mega16's key
        mega13.mega13_blind_rotate(
            p, acc0, a_t, torch.zeros(p.n, p.k + 1, p.k + 1, 4,
                                      megaT.row_bytes(dc.replace(
                                          p, levels=2)), dtype=torch.int8))
    with pytest.raises(TypeError):
        mega13.mega13_blind_rotate(p, acc0, a_t.long(), dsk.bsk_btS)
    for bad in (dc.replace(p, bg_bits=4, levels=5), dc.replace(p, N=16),
                dc.replace(p, N=4096), dc.replace(p, k=3)):
        with pytest.raises(ValueError):
            mega13.check_params(bad)
    for q in PARAM_SETS.values():  # every named set
        mega13.check_params(q)
    assert tsk.layouts_for_engine("mega13") == ("bsk_btS",)
    assert tsk.DEFAULT_LAYOUTS == ("bsk_btS",)
    assert tbs.ROTATION_ENGINES["mega13"] == (mega13.mega13_blind_rotate,
                                              "bsk_btS")
    before = mega13.mega13_blind_rotate.launches
    mega13.mega13_blind_rotate(p, acc0, a_t, dsk.bsk_btS)
    assert mega13.mega13_blind_rotate.launches == before  # no kernel on CPU


# ---- the ring's barrier protocol (csrc/megaS.cu) ----

CONSUMER_WARPS = 4  # warps a consumer warpgroup arrives on empty[s] with


class MBarrier:
    """An mbarrier: a phase completes after ``count`` arrivals; a wait on
    parity P passes once the last phase of parity P has completed (a fresh
    barrier's phase of parity 1 counts as completed)."""

    def __init__(self, count: int):
        self.count, self.pending, self.phases = count, 0, 0

    def arrive(self, n: int) -> None:
        self.pending += n
        assert self.pending <= self.count
        if self.pending == self.count:
            self.pending, self.phases = 0, self.phases + 1

    def passed(self, parity: int) -> bool:
        return self.phases % 2 != parity


def consumer_ops(wg: int, steps: int, units: tuple):
    """Consumer warpgroup ``wg``'s barrier operations, as ``consume`` and
    ``k_step`` run them: per step the digit phase's grid barrier, then per
    K block of each of the block's work units (e0, e1, live) the stage's
    full barrier, its group of wgmma (with products where ``live[wg]``) and
    the stage released by its four warps, then the products' grid barrier
    (none after the last step)."""
    it = 0
    for i in range(steps):
        yield ("block",)
        for e0, e1, live in units:
            for _ in range(e0, e1):
                s = it % STAGES
                yield ("wait", ("full", s), (it // STAGES) & 1)
                yield ("group", wg, live[wg])
                yield ("arrive", ("empty", s), CONSUMER_WARPS)
                it += 1
        if i + 1 < steps:
            yield ("block",)


def producer_ops(steps: int, units: tuple):
    """The producer's: per K block the stage's empty barrier, then its
    copies onto the full one (``produce``)."""
    it = 0
    for i in range(steps):
        yield ("block",)
        for e0, e1, _ in units:
            for _ in range(e0, e1):
                s = it % STAGES
                yield ("wait", ("empty", s), ((it // STAGES) & 1) ^ 1)
                yield ("arrive", ("full", s), 1)
                it += 1
        if i + 1 < steps:
            yield ("block",)


def run_block(units: tuple, steps: int, rng) -> list[list[tuple]]:
    """One block's producer and two consumer warpgroups over ``units``,
    interleaved at random where more than one can go on.  Fails where none
    can go on before all end (a warpgroup would wait forever), or where a
    stage's barrier holds arrivals at a step's end.  Returns each step's
    groups in the order they were issued: (warpgroup, with products)."""
    mbar = {}
    for s in range(STAGES):
        mbar["full", s] = MBarrier(1)
        mbar["empty", s] = MBarrier(2 * CONSUMER_WARPS)
    block = {"arrived": 0, "gen": 0}
    groups: list[list[tuple]] = [[]]

    def end_of_step():
        for key, mb in mbar.items():
            assert mb.pending == 0, f"{key}: arrivals left at a step's end"
        assert mbar["full", 0].phases == mbar["empty", 0].phases

    ops = {"producer": producer_ops(steps, units),
           0: consumer_ops(0, steps, units), 1: consumer_ops(1, steps, units)}
    op = {a: next(g) for a, g in ops.items()}
    parked: dict = {}  # actor -> the block barrier generation it waits on
    while op:
        ready = [a for a, o in op.items()
                 if (block["gen"] > parked[a] if a in parked
                     else o[0] != "wait" or mbar[o[1]].passed(o[2]))]
        assert ready, f"no warpgroup can go on: waiting at {op}"
        a = ready[rng.integers(len(ready))]
        o = op[a]
        if a in parked:
            del parked[a]
        elif o[0] == "block":
            parked[a] = block["gen"]
            block["arrived"] += 1
            if block["arrived"] == 3:
                block["arrived"] = 0
                block["gen"] += 1
                if block["gen"] % 2 == 0:  # the products' barrier
                    end_of_step()
                    groups.append([])
            continue
        elif o[0] == "arrive":
            mbar[o[1]].arrive(o[2])
        elif o[0] == "group":
            groups[-1].append((o[1], o[2]))
        nxt = next(ops[a], None)
        if nxt is None:
            del op[a]
        else:
            op[a] = nxt
    end_of_step()
    return groups


def block_units(p, B: int, extended: bool, n_sms: int = 132) -> dict:
    """Each block's work units (e0, e1, (live0, live1)) in the order it
    walks them, counted by how many blocks walk the same ones."""
    g = megaS.geometry(p.N, p.levels, extended)
    pl = megaS.plan(p, B, extended, n_sms)
    blocks = collections.Counter()
    for b in range(n_sms):
        units = []
        for t in range(b, pl.units, n_sms):
            _, _, _, q_lo, q_hi, _ = item_of(p, g, t // pl.splits,
                                             pl.qblocks, extended)
            e0, e1 = megaS.split_range(pl.kt, t % pl.splits, pl.splits)
            units.append((e0, e1, tuple(q_lo + 32 * wg <= q_hi
                                        for wg in range(2))))
        blocks[tuple(units)] += 1
    return blocks


# (N, levels, extended, k): mega13's N = 32 to 2048 at levels 1-4, mega14's
# extended key at N = 512 to 2048 (levels 2) and STD128_K4's k = 4
RING_GEOMETRIES = ([(N, L, False, 1) for N in (32, 64, 512, 1024, 2048)
                    for L in (1, 2, 3, 4)]
                   + [(N, 2, True, 1) for N in (512, 1024, 2048)]
                   + [(256, 2, True, 4)])
RING_WIDTHS = (1, 9, 128, 256, 300, 1920, 2048)


@pytest.mark.parametrize("N,levels,extended,k", RING_GEOMETRIES,
                         ids=[f"N{N}-l{L}-{'ext' if x else 'S'}-k{k}"
                              for N, L, x, k in RING_GEOMETRIES])
def test_ring_protocol_over_plan(N, levels, extended, k):
    """The producer and the two consumer warpgroups on the ring's full and
    empty barriers over ``megaS.plan`` at every width, split and unsplit:
    every block (blocks that walk the same units once) runs two steps
    without a warpgroup waiting forever and with every stage's barriers
    balanced at each step's end (``run_block``); each warpgroup issues one
    group a K block of its units, with products only where it holds
    coefficients of the item (not the second at N = 32); and the groups with
    products of all blocks over n steps are ``megaS.turns``."""
    p = dc.replace(TOY, name=f"ring_{N}_{levels}", n=2, N=N, k=k,
                   bg_bits=8, levels=levels)
    rng = np.random.default_rng(N * 8 + levels)
    splits = set()
    for B in RING_WIDTHS:
        splits.add(megaS.plan(p, B, extended).splits > 1)
        live = 0
        for units, count in block_units(p, B, extended).items():
            steps = run_block(units, 2, rng)
            assert len(steps) == 2
            for groups in steps:
                for wg in range(2):
                    assert [w for v, w in groups if v == wg] == [
                        lv[wg] for e0, e1, lv in units
                        for _ in range(e0, e1)]
            live += count * sum(w for _, w in steps[0])
        assert p.n * live == megaS.turns(p, B, extended)
    assert True in splits and (N < 512 or False in splits)


def tfhe_lib_params() -> TFHEParams:
    """The benchmark's set, built from the numbers of
    ``fhebench/configs/herd_tfhe_lib.json`` (n = 630, N = 1024, k = 1, bg =
    2^7, 3 levels), which the program holds under no name of its own."""
    path = pathlib.Path(__file__).parents[1] / "fhebench" / "configs" / \
        "herd_tfhe_lib.json"
    return TFHEParams(**json.loads(path.read_text())["params"])


@pytest.mark.parametrize("B", (2048, 1920, 256, 128))
def test_launch_counts_megaS_turns(B, monkeypatch):
    """A launch of ``megaS.cu`` adds its rotation's turns to the job's
    ``bootstrap.megaS_turns``: at the benchmark cells' widths, the groups
    with products that every block's work units take over n steps (the
    model above), ``megaS.turns``.  The kernel's build and launch are
    stubbed: the count is the plan's, whatever the card does."""
    p = tfhe_lib_params()
    monkeypatch.setattr(megaS, "_lib", lambda: None)
    monkeypatch.setattr(megaS, "rotate_with",
                        lambda lib, name, q, acc0, a_t, key: acc0)
    acc0 = torch.zeros(B, p.k + 1, p.N, dtype=torch.int32)
    job = f"megaS-turns-{B}"
    with tracing.job_scope(job):
        megaS.launch("mega13", p, acc0, None, None)
    planned = p.n * sum(
        count * sum((e1 - e0) * sum(live) for e0, e1, live in units)
        for units, count in block_units(p, B, False).items())
    assert tracing.job(job)["counts"] == {tracing.MEGAS_TURNS: planned}
    assert planned == megaS.turns(p, B) > 0


def test_ablation_variants_find_their_text():
    """Each of ``utils/megaS_ablation``'s edits finds its text once in the
    kernel's source, so the ablation builds its variants."""
    text = (_build.SRC_DIR / "megaS.cu").read_text()
    for name, edits in megaS_ablation.VARIANTS.items():
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
