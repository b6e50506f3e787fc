"""NumPy emulation of ``csrc/mega12.cu`` (the whole rotation on int8 tensor
cores) on the CPU, before and beside the card: ``mega12.plan``'s tiles and
K splits, and the blocks' round robin over them; phase (a)'s digit stores
into the pre-swizzled scratch [R*HALF, B_pad, P], pad rows as zeros; phase
(b)'s bulk copies of one digit tile and one ``bsk_btk`` key tile into a
stage (in a two-block cluster, each block's half of the key tile sent to
both), read by ``wgmma`` through the descriptor's (start, LBO, SBO,
swizzle) fields; each run started by its first ``wgmma`` (scale-d 0), the
negated run's recombined words subtracted in the epilogue from the m64n256
accumulator fragment, and the ``red.add`` sum of the splits.  The emulated
rotation is held array-equal to ``blind_rotate_plain_btjj`` on the JAX
package's ``bsk_btjj`` and to the JAX ``_mega12_kernel`` (Pallas interpret
mode) at N = 256 (two column tiles: a negated run), k = 1 and 2, ragged
batches.  Shared memory, the digit scratch and the accumulators start as
garbage, so a byte that no copy or store wrote shows up in the result.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import reference as jref
from herdsman_tpu.ops import bootstrap as jbs
from herdsman_tpu.ops import server_key as jsk
from herdsman_tpu_torch.core import PARAM_SETS, TOY
from herdsman_tpu_torch.ops import bootstrap as tbs
from herdsman_tpu_torch.ops import server_key as tsk
from herdsman_tpu_torch.ops.kernels import mega12
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# the kernel's constants (csrc/mega12.cu)
P = mega12.P
BN = mega12.BN
SMEM_PER_BLOCK = 232448
H100_SMS = 132
RING_BASE = 1024  # the ring's shared address: 1024-aligned, as the kernel's

# the geometries of tests/test_torch_pbs.py: HALF = 2, n cut to 8 steps
MULTITILE = dc.replace(TOY, name="toy_multitile", n=8, N=256)
MULTITILE_K2 = dc.replace(TOY, name="toy_k2", n=8, N=256, k=2)
BATCHES = [1, 3, 9, 65, 129]
# SM counts that reach each plan: 132 (the H100: 64-row tiles, K split at
# B <= 64), 8 (128-row tiles) and 2048 (every K block split apart)
N_SMS = [H100_SMS, 8, 2048]
U32 = 1 << 32


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
    return smem[..., swizzle(start + (r // 8) * sbo + (r % 8) * P + k)]


def fragment(acc: np.ndarray) -> np.ndarray:
    """The m64n256 s32 accumulator fragment: [..., warp, lane, 128] of
    warpgroup tiles [..., 64, 256]."""
    w = np.arange(4)[:, None, None]
    lane = np.arange(32)[None, :, None]
    i = np.arange(128)[None, None, :]
    row = 16 * w + lane // 4 + 8 * ((i % 4) // 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return acc[..., row, col]


def words(acc: np.ndarray) -> np.ndarray:
    """The epilogue's 32 words a thread: sum_j acc[32j + x] << 8j mod 2^32,
    [..., warp, lane, 32] of accumulator tiles [..., 64, 256]."""
    fr = fragment(acc % U32)
    return sum(fr[..., 32 * j:32 * j + 32] << (8 * j)
               for j in range(4)) % U32


def k_block(e, ct, R, HALF, doubled=False):
    """(m, r, sub) of K block e of column tile ct: the negated run first, or
    on the doubled window one run, stored group HALF-1-ct+sub."""
    if doubled:
        return HALF - 1 - ct + e // R, e % R, e // R
    nneg = (HALF - 1 - ct) * R
    if e < nneg:
        m = ct + 1 + e // R
        return m, e % R, HALF + ct - m
    return (e - nneg) // R, (e - nneg) % R, ct - (e - nneg) // R


def digit_phase(p, out, rot, dig, B_pad):
    """Phase (a) of one step: every (b, c, coefficient) digit byte of X^rot
    acc - acc into the flat scratch ``dig`` at its pre-swizzled address, the
    pad rows b >= B as zeros; each byte stored once."""
    B, kp1, N = out.shape
    HALF, L, bg = N // P, p.levels, p.bg_bits
    W = bg * L
    half, dmask = 1 << (bg - 1), (1 << bg) - 1
    offset = sum(half << (bg * lev) for lev in range(L))
    y = np.arange(N)
    t = (y[None, :] - rot[:, None]) & (2 * N - 1)            # [B, N]
    rv = np.take_along_axis(out, (t & (N - 1))[:, None, :], axis=2)
    rv = np.where((t >= N)[:, None, :], (U32 - rv) % U32, rv)
    diff = (rv - out) % U32
    if W < 32:
        val = ((diff + (1 << (31 - W))) % U32) >> (32 - W)
    else:
        val = diff
    val = (val + offset) % U32                                 # [B, k+1, N]
    b = np.arange(B_pad)[:, None, None, None]
    c = np.arange(kp1)[None, :, None, None]
    lev = np.arange(L)[None, None, :, None]
    yy = y[None, None, None, :]
    digit = np.zeros((B_pad, kp1, L, N), np.int64)
    digit[:B] = ((val[:, :, None, :] >> (bg * (L - 1 - lev))) & dmask) - half
    sub, x = yy // P, yy % P
    rt = (c * L + lev) * HALF + sub
    pos = (((x >> 4) ^ (b & 7)) << 4) | (x & 15)
    addr = (rt * B_pad + b) * P + pos
    addr, digit = np.broadcast_arrays(addr, digit)
    assert np.unique(addr).size == addr.size == dig.size, \
        "the digit stores do not cover the scratch once each"
    dig[addr.ravel()] = digit.ravel().astype(np.int8)


def emulate(p, acc0, a_t, btk, n_sms, doubled=False):
    """The kernel's output (u32 [B, k+1, N]) on a card of ``n_sms`` SMs,
    step by step: phase (a), then each work tile of phase (b), the M tiles
    of one (column unit, split) side by side; the single window on
    ``bsk_btk`` or, with ``doubled``, the doubled one on ``bsk_btk2``."""
    B, kp1, N = acc0.shape
    HALF, R = N // P, kp1 * p.levels
    groups = 2 * HALF if doubled else HALF
    KB = R * HALF
    pl = mega12.plan(p, B, n_sms)
    nwg = pl.bm // 64
    a_bytes = pl.bm * P
    stage_bytes = a_bytes + BN * P
    stages = (SMEM_PER_BLOCK - 2048) // stage_bytes
    assert stages * stage_bytes + 1024 + 16 * stages <= SMEM_PER_BLOCK
    cl = pl.cluster
    mts = -(-B // (pl.bm * cl)) * cl  # M tiles of whole clusters
    B_pad = mts * pl.bm
    # within the wrapper's scratch
    assert R * HALF * B_pad * P <= mega12.scratch_bytes(p, B)
    assert pl.tiles == mts // cl * pl.units * pl.splits
    # the round robin: cluster tile t to cluster t % clusters (one block per
    # SM), each tile once; the walk is M-tile-major
    clusters = n_sms // cl
    owned = sorted(t for blk in range(clusters)
                   for t in range(blk, pl.tiles, clusters))
    assert owned == list(range(pl.tiles))
    rng = np.random.default_rng(B + n_sms)
    dig = rng.integers(-128, 128, R * HALF * B_pad * P).astype(np.int8)
    key = btk.reshape(-1)
    out = acc0.astype(np.int64)
    stores = np.zeros((B, kp1, N), np.int64)
    warp = np.arange(4)[:, None]
    lane = np.arange(32)[None, :]
    for i in range(p.n):
        digit_phase(p, out, a_t[i].astype(np.int64), dig, B_pad)
        adds = np.zeros((B, kp1, N), np.int64)
        for t0 in range(0, pl.units * pl.splits):
            s_, u = t0 % pl.splits, t0 // pl.splits
            qh, c, ct = u & 1, (u >> 1) % kp1, (u >> 1) // kp1
            e0, e1 = s_ * KB // pl.splits, (s_ + 1) * KB // pl.splits
            nkb = e1 - e0
            assert nkb >= 1
            neg_end = 0 if doubled else min(max((HALF - 1 - ct) * R - e0,
                                                0), nkb)
            smem = np.tile(rng.integers(-128, 128, RING_BASE + stages
                                        * stage_bytes).astype(np.int8),
                           (mts, 1))
            acc = rng.integers(-U32, U32, (mts, nwg, 64, BN))  # garbage
            runw = []
            for lo, hi in ((0, neg_end), (neg_end, nkb)):
                for k in range(lo, hi):
                    m, r, sub = k_block(e0 + k, ct, R, HALF, doubled)
                    st = RING_BASE + (k % stages) * stage_bytes
                    # the two bulk copies: the A tile of every M tile, the
                    # B tile (the same in each)
                    for mt in range(mts):
                        src = ((r * HALF + sub) * B_pad + mt * pl.bm) * P
                        smem[mt, st:st + a_bytes] = dig[src:src + a_bytes]
                    tile = (((i * groups + m) * R + r) * kp1 + c) * 2 + qh
                    share = BN * P // cl  # block `rank`'s copy, to all
                    for rank in range(cl):
                        src = tile * BN * P + rank * share
                        dst = st + a_bytes + rank * share
                        smem[:, dst:dst + share] = key[src:src + share]
                    for kk in range(P // 32):
                        # a k32 product is under 32 * 2^14 in size: exact
                        # in float32 (torch's matmul, one thread)
                        Bt = torch.from_numpy(read_operand(
                            smem[0], sw128_desc(st + a_bytes + 32 * kk), BN)
                            .T.astype(np.float32))
                        for wg in range(nwg):
                            A = torch.from_numpy(read_operand(
                                smem, sw128_desc(st + wg * 64 * P + 32 * kk),
                                64).reshape(-1, 32).astype(np.float32))
                            prod = (A @ Bt).numpy().reshape(
                                mts, 64, BN).astype(np.int64)
                            first = k == lo and kk == 0  # scale-d 0
                            acc[:, wg] = prod if first else acc[:, wg] + prod
                runw.append(words(acc) if hi > lo else 0)
            v = (runw[1] - runw[0]) % U32          # [mts, nwg, 4, 32, 32]
            # epilogue of thread (wg, warp, lane): word x = 4t + 2h + e
            for mt in range(mts):
                for wg in range(nwg):
                    for h in range(2):
                        for t8 in range(8):
                            for e in range(2):
                                x = 4 * t8 + 2 * h + e
                                b = (mt * pl.bm + wg * 64 + warp * 16
                                     + lane // 4 + 8 * h)
                                q = 8 * t8 + 2 * (lane & 3) + e
                                bb, qq = np.broadcast_arrays(b, q)
                                ok = bb < B
                                idx = (bb[ok], c, ct * P + qh * 64 + qq[ok])
                                np.add.at(adds, idx, v[mt, wg][..., x][ok])
                                np.add.at(stores, idx, 1)
        out = (out + adds) % U32  # red.add (splits) or one store: the same
    assert (stores == p.n * pl.splits).all(), \
        "an output word not stored once a split each step"
    return out.astype(np.uint32)


def test_plan_tiles_and_splits():
    """``plan`` at the smoke run's widths on the H100, and its invariants:
    the tiles cover B, every (m, r) block is in one split, split tiles fit
    one wave."""
    si = PARAM_SETS["std128_shortint"]
    Plan = mega12.Plan
    assert mega12.plan(si, 2048, H100_SMS) == Plan(128, 1, 2, 64, 512)
    assert mega12.plan(si, 256, H100_SMS) == Plan(128, 1, 2, 64, 64)
    assert mega12.plan(si, 129, H100_SMS) == Plan(128, 1, 2, 64, 64)
    assert mega12.plan(si, 65, H100_SMS) == Plan(64, 1, 1, 64, 128)
    assert mega12.plan(si, 9, H100_SMS) == Plan(64, 2, 1, 64, 128)
    assert mega12.plan(si, 1, H100_SMS) == Plan(64, 2, 1, 64, 128)
    reached = set()
    for p in (MULTITILE, MULTITILE_K2, si, PARAM_SETS["std128_shortint_l4"],
              PARAM_SETS["std128_k2"], PARAM_SETS["std128"]):
        HALF = p.N // P
        KB = (p.k + 1) * p.levels * HALF
        for B in [*BATCHES, 256, 2048]:
            for n_sms in N_SMS:
                pl = mega12.plan(p, B, n_sms)
                mts = -(-B // pl.bm)
                assert (mts - 1) * pl.bm < B <= mts * pl.bm
                assert pl.units == HALF * (p.k + 1) * 2
                assert 1 <= pl.splits <= KB
                assert pl.cluster == (2 if pl.bm == 128 and mts > 1 else 1)
                assert pl.tiles == -(-mts // pl.cluster) * pl.units \
                    * pl.splits
                if pl.splits > 1:
                    assert pl.tiles <= n_sms
                reached.add((pl.bm, pl.splits > 1, pl.cluster))
    # 128-row tiles are taken only when they nearly fill the card, so never
    # split; clusters pair them
    assert reached == {(64, False, 1), (64, True, 1), (128, False, 1),
                       (128, False, 2)}


@pytest.fixture(scope="module", params=[MULTITILE, MULTITILE_K2],
                ids=["k1", "k2"])
def geometry(request):
    params = request.param
    rng = np.random.default_rng(11)
    ck, sk = jref.keygen(params, rng)
    jdsk = jsk.device_server_key(sk, layouts=("bsk_btjj",))
    tdsk = tsk.device_server_key(sk, layouts=("bsk_btjj", "bsk_btk"),
                                 device="cpu")
    return params, rng, sk, jdsk, tdsk


@pytest.mark.parametrize("B", BATCHES)
def test_emulated_kernel_equals_plain_and_jax(geometry, B):
    params, rng, sk, jdsk, tdsk = geometry
    p = tdsk.params
    ct = rng.integers(0, U32, (B, params.n + 1), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(jbs.blind_rotate_batch(
        jdsk, jnp.asarray(ct), jbs.make_test_poly(params),
        engine="pallas_mega12", unroll=True))
    acc0, a_t = tbs.rotation_inputs(p, from_numpy_u32(ct),
                                    tbs.make_test_poly(p))
    plain = to_numpy_u32(mega12.blind_rotate_plain_btjj(p, acc0, a_t,
                                                        tdsk.bsk_btjj))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(
        to_numpy_u32(mega12.blind_rotate_plain_btk(p, acc0, a_t,
                                                   tdsk.bsk_btk)), want)
    for n_sms in N_SMS:
        got = emulate(p, to_numpy_u32(acc0).astype(np.int64),
                      a_t.numpy(), tdsk.bsk_btk.numpy(), n_sms)
        np.testing.assert_array_equal(
            got, want, err_msg=f"{p.name} B={B} n_sms={n_sms} "
                               f"plan={mega12.plan(p, B, n_sms)}")


def test_emulated_cluster_with_a_lone_m_tile(geometry):
    """Three 128-row M tiles in two-block clusters: the second cluster's
    second block computes on pad rows only and stores nothing."""
    params, rng, _, _, tdsk = geometry
    p = tdsk.params
    B = 300
    assert mega12.plan(p, B, 8)[:3] == (128, 1, 2)
    acc0 = rng.integers(0, U32, (B, p.k + 1, p.N))
    a_t = rng.integers(0, 2 * p.N, (p.n, B))
    want = to_numpy_u32(mega12.blind_rotate_plain_btk(
        p, from_numpy_u32(acc0.astype(np.uint32)),
        torch.from_numpy(a_t.astype(np.int32)), tdsk.bsk_btk))
    np.testing.assert_array_equal(
        emulate(p, acc0, a_t, tdsk.bsk_btk.numpy(), 8), want)


def test_btk_tiles_read_as_btjj_columns(geometry):
    """One staged key tile, read through the descriptor as ``wgmma`` reads
    it, is row n = 64j + q' of the column (j, c, 64*qhalf + q') of
    ``bsk_btjj``'s block (m, r), K bytes in order."""
    params, _, _, _, tdsk = geometry
    p = tdsk.params
    kp1 = p.k + 1
    jj = tdsk.bsk_btjj.numpy()
    btk = tdsk.bsk_btk.numpy()
    smem = np.zeros(RING_BASE + BN * P, np.int8)
    for i, m, r, c, qh in ((0, 0, 0, 0, 0), (3, 1, 2, kp1 - 1, 1),
                           (p.n - 1, 1, kp1 * p.levels - 1, 0, 1)):
        smem[RING_BASE:] = btk[i, m, r, c, qh].reshape(-1)
        read = np.concatenate([read_operand(smem, sw128_desc(
            RING_BASE + 32 * kk), BN) for kk in range(P // 32)], axis=1)
        j, q = np.arange(BN) // 64, qh * 64 + np.arange(BN) % 64
        np.testing.assert_array_equal(
            read, jj[i, m, r][:, j * kp1 * P + c * P + q].T)
