"""NumPy emulation of ``csrc/bt_external_product.cu`` (the int8 tensor-core
external product) on the CPU, before and beside the card: ``bt.plan``'s
tiles and K splits; the producer's 16-byte ``cp.async`` copies of digit
rows and its transposed key words, both at their 128-byte-swizzled K-major
addresses in the stage ring; the consumers' ``wgmma`` operand reads through
the descriptor's (start, LBO, SBO, swizzle) fields; the m64n256 accumulator
fragment and its limb recombine; the negation after each split's negated
blocks and the ``red.add`` sum of the splits.  The emulation is held
array-equal to ``external_product_bt_plain`` and to the JAX package's
``external_product_bt_pretiled`` (Pallas interpret mode), at N = 32, 64 and
512, ragged batches and both ``glwe`` forms.  Shared memory starts as
garbage, so a read of a byte no copy wrote shows up in the result.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herdsman_tpu.core import TOY as JTOY
from herdsman_tpu.ops.pallas import blind_rotate as jbr
from herdsman_tpu_torch.core import PARAM_SETS, TOY
from herdsman_tpu_torch.ops.kernels import bt
from herdsman_tpu_torch.ops.server_key import bt_tile
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# the kernel's constants (csrc/bt_external_product.cu)
KROW = 128
BN = 4 * bt.QB_MAX
SMEM_PER_BLOCK = 232448
H100_SMS = 132
RING_BASE = 1024  # the ring's shared address: 1024-aligned, as the kernel's

# N = 32 and 64 (P = N, one column tile, P/32 k32 steps) and N = 512 at the
# STD128_K2 shape (P = 128, HALF = 4: negated runs, two q blocks)
GEOMETRIES = [dc.replace(TOY, name="toy_n32", N=32), TOY,
              dc.replace(TOY, name="toy_n512_k2", N=512, k=2, bg_bits=8,
                         levels=2)]
BATCHES = [1, 9, 63, 65, 129, 288]
# SM counts that reach each plan: 132 (the H100), 8 (128-row tiles at
# every width), 2048 (K split into every block)
N_SMS = [H100_SMS, 8, 2048]


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
    """``sw128_desc`` of the kernel: start >> 4, LBO 16 B, SBO 1024 B,
    layout 1 (128B swizzle)."""
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
    return smem[..., swizzle(start + (r // 8) * sbo + (r % 8) * KROW + k)]


def k_block(e, ct, R, HALF):
    """(m, r, sub) of K block e of column tile ct, the negated run first."""
    nneg = (HALF - 1 - ct) * R
    if e < nneg:
        m = ct + 1 + e // R
        return m, e % R, HALF + ct - m
    return (e - nneg) // R, (e - nneg) % R, ct - (e - nneg) // R


def produce(smem, stage, p, pl, d8, key, c, Q0, m, r, sub):
    """The producer warpgroup's writes of one stage, in every M tile at once
    (smem [M tiles, bytes]): the A tile (digit rows by cp.async, zero-filled
    past B) and the B tile (transposed key words)."""
    P, HALF = bt_tile(p)
    B = d8.shape[1]
    gx = smem.shape[0]
    a_base = RING_BASE + stage * (pl.bm * KROW + BN * KROW)
    b_base = a_base + pl.bm * KROW
    # digits: item it -> (row, 16-byte chunk), in M tile bx row b0 + row
    chunks = P // 16
    it = np.arange(pl.bm * chunks)
    row, ch = it // chunks, it % chunks
    b = np.arange(gx)[:, None] * pl.bm + row[None, :]     # [gx, items]
    real = b < B
    rows = np.concatenate([d8[r * HALF + sub], np.zeros((1, P), np.int8)])
    src = rows[np.where(real, b, B)].reshape(gx, -1, chunks, 16)[
        :, np.arange(it.size), ch]                         # [gx, items, 16]
    a_addr = (a_base + row * KROW + ((ch ^ (row & 7)) << 4))[:, None] \
        + np.arange(16)
    smem[:, a_addr] = src
    # key: thread pt, pass u: item it = pt + 128u is (q16, p4, j), q16
    # fastest: 16 q of limb j in K rows 4*p4 .. +3
    nq16, np4 = pl.qb // 16, P // 4
    items = nq16 * np4 * 4
    kpass = -(-items // 128)
    assert kpass <= 4  # the kernel's register budget: 4 passes of 4 x uint4
    pt, u = np.meshgrid(np.arange(128), np.arange(kpass), indexing="ij")
    it = pt + 128 * u
    live = it < items
    q16, p4 = pt % nq16, (pt // nq16) % np4    # the same in every pass
    j = it // (nq16 * np4)
    assert (q16 == it % nq16).all() and (p4 == (it // nq16) % np4).all()
    assert np.array_equal(np.sort(it[live]), np.arange(items))
    q16, p4, j = q16[live], p4[live], j[live]
    i4 = np.arange(4)
    col16 = np.arange(16)
    vals = key[r, m][(4 * p4)[:, None, None] + i4[None, :, None],
                     (c * 4 * P + j * P + Q0 + 16 * q16)[:, None, None]
                     + col16[None, None, :]]            # [items, 4, 16]
    # the kernel's store: row n = 64j + 16*q16 + col16, K offset 4*p4, via
    # xo[v] = ((p4 >> 2) ^ v) << 4 for v = n % 8
    xo = ((p4[:, None] >> 2) ^ (col16[None, :] & 7)) << 4
    word = (b_base + (j[:, None] * bt.QB_MAX + 16 * q16[:, None]) * KROW
            + ((p4[:, None] & 3) << 2) + col16[None, :] * KROW + xo)
    b_addr = word[:, :, None] + i4[None, None, :]      # byte i4 = K row i4
    smem[:, b_addr] = vals.transpose(0, 2, 1)
    allw = np.concatenate([a_addr.ravel(), b_addr.ravel()])
    assert np.unique(allw).size == allw.size, "two copies wrote one byte"


def fragment(acc: np.ndarray) -> np.ndarray:
    """The m64n256 s32 accumulator fragment: [..., warp, lane, 128] of
    warpgroup tiles [..., 64, 256]."""
    w = np.arange(4)[:, None, None]
    lane = np.arange(32)[None, :, None]
    i = np.arange(128)[None, None, :]
    row = 16 * w + lane // 4 + 8 * ((i % 4) // 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return acc[..., row, col]


def emulate(p, d8, key, glwes, n_sms):
    """The kernel's outputs (u32), one for each of ``glwes`` (None or u32
    [B, k+1, N]), block by block as ``bt_external_product`` computes them on
    a card of ``n_sms`` SMs; the M tiles of a column tile and split run side
    by side."""
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    kp1 = p.k + 1
    B = d8.shape[1]
    pl = bt.plan(p, B, n_sms)
    nwg = pl.bm // 64
    stage_bytes = pl.bm * KROW + BN * KROW
    stages = (SMEM_PER_BLOCK - 2048) // stage_bytes
    assert stages * stage_bytes + 1024 + 16 * stages <= SMEM_PER_BLOCK
    nq = P // pl.qb
    KB = R * HALF
    split = pl.splits > 1
    outs = []
    for g in glwes:
        out = np.zeros((B, kp1, p.N), np.uint64)
        if split and g is not None:  # the entry point's copy of glwe
            out[:] = g
        outs.append(out)
    stores = np.zeros((B, kp1, p.N), np.int64)
    garbage = np.random.default_rng(5).integers(
        -128, 128, RING_BASE + stages * stage_bytes).astype(np.int8)
    gx, gy, gz = pl.grid
    assert gx * pl.bm >= B > (gx - 1) * pl.bm and gy == HALF * kp1 * nq
    warp = np.arange(4)[:, None]
    lane = np.arange(32)[None, :]
    for by in range(gy):
        qblk, c, ct = by % nq, (by // nq) % kp1, by // (nq * kp1)
        Q0 = qblk * pl.qb
        for bz in range(gz):
            e0, e1 = bz * KB // pl.splits, (bz + 1) * KB // pl.splits
            nkb = e1 - e0
            assert nkb >= 1
            smem = np.tile(garbage, (gx, 1))
            acc = np.zeros((gx, nwg, 64, BN), np.int64)
            nneg = (HALF - 1 - ct) * R
            neg_end = min(nneg, e1) - e0
            for i in range(nkb):
                if i == neg_end:
                    acc = -acc
                s = i % stages
                m, r, sub = k_block(e0 + i, ct, R, HALF)
                produce(smem, s, p, pl, d8, key, c, Q0, m, r, sub)
                a_base = RING_BASE + s * stage_bytes
                b_base = a_base + pl.bm * KROW
                for kk in range(P // 32):
                    # every M tile stages the same key tile over the same
                    # garbage: read tile 0's.  A k32 product is under
                    # 32 * 2^14 in size, exact in float32 (torch's matmul,
                    # on the one thread the fixture sets)
                    Bt = torch.from_numpy(read_operand(
                        smem[0], sw128_desc(b_base + 32 * kk), BN).T
                        .astype(np.float32))
                    for wg in range(nwg):
                        A = torch.from_numpy(read_operand(smem, sw128_desc(
                            a_base + wg * 64 * KROW + 32 * kk), 64)
                            .reshape(-1, 32).astype(np.float32))
                        acc[:, wg] += (A @ Bt).numpy().reshape(
                            gx, 64, BN).astype(np.int64)
            if neg_end >= nkb:
                acc = -acc
            # epilogue of thread (wg, warp, lane): h, t, e
            fr = fragment(acc % (1 << 32))  # [gx, nwg, 4, 32, 128]
            for wg in range(nwg):
                for h in range(2):
                    for t in range(8):
                        for e in range(2):
                            i = 4 * t + 2 * h + e
                            v = sum(fr[:, wg, :, :, 32 * j + i] << (8 * j)
                                    for j in range(4)) % (1 << 32)
                            b = (np.arange(gx)[:, None, None] * pl.bm
                                 + wg * 64 + warp * 16 + lane // 4 + 8 * h)
                            q = 8 * t + 2 * (lane & 3) + e
                            bb, qq = np.broadcast_arrays(b, q)
                            ok = (bb < B) & (qq - e < pl.qb)
                            idx = (bb[ok], c, ct * P + Q0 + qq[ok])
                            vv = v[ok].astype(np.uint64)
                            for g, out in zip(glwes, outs):
                                if split:
                                    np.add.at(out, idx, vv)
                                else:
                                    out[idx] = vv + (0 if g is None
                                                     else g[idx])
                            np.add.at(stores, idx, 1)
    assert (stores == pl.splits).all(), "an output word stored not once a split"
    return [(out % (1 << 32)).astype(np.uint32) for out in outs]


def test_plan_tiles_and_splits():
    """``plan`` at the smoke run's widths on the H100, and its invariants:
    the grid covers B, every (r, m) block is in one split, split grids fit
    one wave."""
    k2, std = PARAM_SETS["std128_k2"], PARAM_SETS["std128"]
    assert bt.plan(k2, 2048, H100_SMS) == bt.Plan(128, 1, 64, (16, 24, 1))
    assert bt.plan(k2, 16384, H100_SMS) == bt.Plan(128, 1, 64, (128, 24, 1))
    assert bt.plan(k2, 288, H100_SMS) == bt.Plan(64, 1, 64, (5, 24, 1))
    assert bt.plan(k2, 9, H100_SMS) == bt.Plan(64, 5, 64, (1, 24, 5))
    assert bt.plan(k2, 1, H100_SMS) == bt.Plan(64, 5, 64, (1, 24, 5))
    assert bt.plan(std, 2048, H100_SMS) == bt.Plan(128, 1, 64, (16, 32, 1))
    assert bt.plan(std, 9, H100_SMS) == bt.Plan(64, 4, 64, (1, 32, 4))
    reached = set()
    for p in [*GEOMETRIES, k2, std]:
        P, HALF = bt_tile(p)
        KB = (p.k + 1) * p.levels * HALF
        for B in [*BATCHES, 2048]:
            for n_sms in N_SMS:
                pl = bt.plan(p, B, n_sms)
                gx, gy, gz = pl.grid
                assert (gx - 1) * pl.bm < B <= gx * pl.bm
                assert gy == HALF * (p.k + 1) * P // pl.qb
                assert 1 <= pl.splits <= KB and gz == pl.splits
                if pl.splits > 1:
                    assert gx * gy * gz <= n_sms
                reached.add((pl.bm, pl.splits > 1))
    # 128-row tiles are taken only when they fill the card, so never split
    assert reached == {(64, False), (64, True), (128, False)}


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda q: q.name)
def geometry(request):
    p = request.param
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    rng = np.random.default_rng(p.N)
    key = rng.integers(-128, 128, (R, HALF, P, (p.k + 1) * 4 * P)
                       ).astype(np.int8)
    return p, key, rng


@pytest.mark.parametrize("B", BATCHES)
def test_emulated_kernel_equals_plain_and_jax(geometry, B):
    p, key, rng = geometry
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    half = 1 << (p.bg_bits - 1)
    d8 = rng.integers(-half, half, (R * HALF, B, P)).astype(np.int8)
    glwe = rng.integers(0, 1 << 32, (B, p.k + 1, p.N),
                        dtype=np.uint64).astype(np.uint32)
    jp = dc.replace(JTOY, name=p.name, N=p.N, k=p.k, bg_bits=p.bg_bits,
                    levels=p.levels)
    wants = []
    for g in (None, glwe):
        plain = to_numpy_u32(bt.external_product_bt_plain(
            p, torch.from_numpy(d8), torch.from_numpy(key),
            glwe=None if g is None else from_numpy_u32(g)))
        want = np.asarray(jbr.external_product_bt_pretiled(
            jp, jnp.asarray(d8), jnp.asarray(key),
            glwe=None if g is None else jnp.asarray(g), bt_chunk=B))
        np.testing.assert_array_equal(plain, want)
        wants.append(want)
    for n_sms in N_SMS:
        for got, want, form in zip(emulate(p, d8, key, (None, glwe), n_sms),
                                   wants, ("unfused", "fused")):
            np.testing.assert_array_equal(
                got, want, err_msg=f"{p.name} B={B} n_sms={n_sms} {form} "
                                   f"plan={bt.plan(p, B, n_sms)}")


def test_wrapper_refuses_an_unaligned_key():
    """The producer stages key rows in 16-byte loads: the wrapper refuses a
    key that does not start on a 16-byte boundary, on either device."""
    p = GEOMETRIES[0]
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    d8 = torch.zeros(R * HALF, 3, P, dtype=torch.int8)
    n = R * HALF * P * (p.k + 1) * 4 * P
    key = torch.zeros(n + 1, dtype=torch.int8)[1:].view(
        R, HALF, P, (p.k + 1) * 4 * P)
    with pytest.raises(ValueError, match="key must be 16-byte aligned"):
        bt.external_product_bt(p, d8, key)
    assert bt.external_product_bt(p, d8, key.clone()).abs().sum() == 0


def test_wrapper_refuses_an_unaligned_glwe():
    """The fused epilogue reads ``glwe`` in 8-byte loads: the wrapper
    refuses a ``glwe`` that starts at an odd 4-byte offset, on either
    device."""
    p = GEOMETRIES[0]
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    d8 = torch.zeros(R * HALF, 3, P, dtype=torch.int8)
    key = torch.zeros(R, HALF, P, (p.k + 1) * 4 * P, dtype=torch.int8)
    n = 3 * (p.k + 1) * p.N
    glwe = torch.arange(n + 1, dtype=torch.int32)[1:].view(3, p.k + 1, p.N)
    with pytest.raises(ValueError, match="glwe must be 8-byte aligned"):
        bt.external_product_bt(p, d8, key, glwe)
    assert torch.equal(bt.external_product_bt(p, d8, key, glwe.clone()), glwe)
