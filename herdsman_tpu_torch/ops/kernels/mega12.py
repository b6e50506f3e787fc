"""Whole-rotation blind-rotation kernel on int8 tensor cores against the
K-major block-Toeplitz key (``csrc/mega12.cu``), and its plain PyTorch
version.

``mega12_blind_rotate`` replaces ``herdsman_tpu/ops/pallas/mega.py::
_mega12_kernel`` (the integer tier's engine, ``pallas_mega12``) and keeps its
wrapper's contract: acc0 [B, k+1, N] and a_t [n, B] in [0, 2N) in, the
accumulator after the n CMux steps out, exact mod 2^32.  The key is
``bsk_btk`` int8 [n, HALF, R, k+1, 2, 256, 128]: the bytes of the JAX
package's limb-major ``bsk_btjj`` [n, HALF, R, P, (k+1)*4*P] in the order
the kernel's ``wgmma`` reads them (``kmajor_order``).  On a CUDA tensor it
launches the hand-written kernel (one launch per rotation, counted in
``mega12_blind_rotate.launches``) or raises; on a CPU tensor it runs
``blind_rotate_plain_btk``.  The source note in ``csrc/mega12.cu`` gives
the kernel's design and bound; ``plan`` mirrors its tiling.  The same
source also serves ``megaJ``'s ``mega7``, ``mega5``, ``mega4``, ``mega6``,
``mega3``, ``mega2`` and ``mega`` wrappers (this kernel on this key) and
its ``mega11`` and ``mega10`` (the doubled window on ``bsk_btk2``), each
through ``launch`` with its own counter.

``check_args``, ``pack_digits``, ``recombine`` and the j-major contraction
``blind_rotate_plain_btjj`` also serve ``megaJ``'s plain versions;
``kmajor_from_bt`` and ``kmajor_from_btj`` re-lay the JAX package's
``bsk_bt`` and ``bsk_btj`` as ``bsk_btk``, and its doubled ``bsk_btj2`` as
``bsk_btk2``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import _build
from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul

I32 = torch.int32
I8 = torch.int8

P = 128      # column tile and K block: the kernel takes N >= 128 only
QH = 64      # q columns of one limb in a kernel tile (a q half)
BN = 4 * QH  # rows of a key tile: (limb j, q')


class Plan(NamedTuple):
    """The kernel's tiling of one step: ``bm`` ciphertexts a tile (64 or
    128), ``splits`` K splits, ``cluster`` blocks a cluster (their M tiles
    side by side, sharing each key tile), ``units`` column units (ct, c, q
    half) and ``tiles`` = cluster M tiles * units * splits, walked
    M-tile-major."""
    bm: int
    splits: int
    cluster: int
    units: int
    tiles: int


def plan(p: TFHEParams, B: int, n_sms: int) -> Plan:
    """``make_plan`` of ``csrc/mega12.cu`` on a card of ``n_sms`` SMs:
    128-row tiles where they fill three quarters of a wave, else 64; then
    K splits over the R*HALF (m, r) blocks while the tiles fit one wave;
    two-block clusters where there are two 128-row M tiles or more."""
    HALF = p.N // P
    units = HALF * (p.k + 1) * 2
    KB = (p.k + 1) * p.levels * HALF
    bm = 128 if 4 * -(-B // 128) * units >= 3 * n_sms else 64
    mts = -(-B // bm)
    splits = max(1, min(KB, n_sms // (mts * units)))
    cluster = 2 if bm == 128 and mts >= 2 else 1
    return Plan(bm, splits, cluster, units,
                -(-mts // cluster) * units * splits)


def check_params(p: TFHEParams, name: str = "mega12") -> None:
    """Raise on a parameter set the kernel does not take: k+1 in (2, 3, 5),
    N a power of two in [128, 2048] and bg_bits <= 8 (int8 digits)."""
    if p.k + 1 not in (2, 3, 5):
        raise ValueError(f"{name} takes k+1 in (2, 3, 5), not {p.k + 1} "
                         f"({p.name})")
    if p.N & (p.N - 1) or not P <= p.N <= 2048:
        raise ValueError(f"{name} takes N a power of two in [{P}, 2048], "
                         f"not {p.N} ({p.name})")
    if p.bg_bits > 8:
        raise ValueError(f"{name} takes bg_bits <= 8, not {p.bg_bits} "
                         f"({p.name})")


def key_shape(p: TFHEParams, doubled: bool = False) -> tuple[int, ...]:
    """Shape of ``bsk_btk`` at ``p``: [n, HALF, R, k+1, 2, 256, 128]; with
    ``doubled``, of ``bsk_btk2``: [n, 2*HALF, R, k+1, 2, 256, 128]."""
    groups = (2 if doubled else 1) * (p.N // P)
    return (p.n, groups, (p.k + 1) * p.levels, p.k + 1, P // QH, BN, P)


def check_args(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
               key: torch.Tensor, layout: str = "bsk_btjj",
               key_shape: tuple[int, ...] | None = None) -> None:
    """Raise unless acc0 [B, k+1, N] and a_t [n, B] are int32, the key
    ``layout`` int8 of ``key_shape`` ([n, HALF, R, P, (k+1)*4*P] by
    default), all contiguous and on acc0's device, and B >= 1."""
    HALF = p.N // P
    R = (p.k + 1) * p.levels
    B = acc0.shape[0] if acc0.dim() == 3 else -1
    shapes = {"acc0": (acc0, I32, (B, p.k + 1, p.N)),
              "a_t": (a_t, I32, (p.n, B)),
              layout: (key, I8, key_shape or (p.n, HALF, R, P,
                                              (p.k + 1) * 4 * P))}
    for what, (t, dtype, shape) in shapes.items():
        if t.dtype != dtype:
            raise TypeError(f"{what} must be {dtype}, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device != acc0.device:
            raise ValueError(f"{what} is on {t.device}, acc0 on {acc0.device}")
    if B < 1:
        raise ValueError("empty batch")


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """Rows of 128 bytes (any leading dimensions, then [rows, 128], rows a
    multiple of 8) with each row n's 16-byte chunk ch moved to chunk ch ^
    (n % 8): the 128-byte swizzle, its own inverse."""
    lead = t.shape[:-2]
    v = torch.arange(8, device=t.device)[:, None]
    chunks = t.reshape(*lead, -1, 8, 8, 16)  # [.., n // 8, n % 8, ch, 16]
    return chunks[..., v, v ^ torch.arange(8, device=t.device), :].reshape(
        t.shape)


def kmajor_order(bsk_btjj: torch.Tensor, kp1: int) -> torch.Tensor:
    """``bsk_btk`` from ``bsk_btjj`` (leading dimensions, then [groups, R,
    P, (k+1)*4*P] with columns (j, c, q)): [..., groups, R, k+1, 2, 256,
    128], key tile (m, r, c, q half) holding at row n = 64j + q' the K bytes
    p of column (j, c, 64*qhalf + q'), each row 128-byte swizzled.  The
    same bytes, in the order the kernel's bulk copies stage them; from the
    doubled ``bsk_btj2j`` (2*HALF groups), ``bsk_btk2``."""
    *lead, HALF, R, _, _ = bsk_btjj.shape
    nl = len(lead)
    t = bsk_btjj.reshape(*lead, HALF, R, P, 4, kp1, P // QH, QH)
    t = t.permute(*range(nl), nl, nl + 1, nl + 4, nl + 5, nl + 3, nl + 6,
                  nl + 2)
    return _swizzle128(t.reshape(*lead, HALF, R, kp1, P // QH, BN, P))


def from_kmajor_order(bsk_btk: torch.Tensor) -> torch.Tensor:
    """``bsk_btjj`` from ``bsk_btk`` (``bsk_btj2j`` from ``bsk_btk2``): the
    inverse of ``kmajor_order``."""
    *lead, HALF, R, kp1, nqh, _, _ = bsk_btk.shape
    nl = len(lead)
    t = _swizzle128(bsk_btk).reshape(*lead, HALF, R, kp1, nqh, 4, QH, P)
    t = t.permute(*range(nl), nl, nl + 1, nl + 6, nl + 4, nl + 2, nl + 3,
                  nl + 5)
    return t.reshape(*lead, HALF, R, P, kp1 * 4 * P)


def _kmajor_steps(key: torch.Tensor, kp1: int, r_major: bool) -> torch.Tensor:
    """``bsk_btk`` from a single-width key with (c, j, q) columns, R-major
    [n, R, HALF, P, (k+1)*4*P] or step-major by stored block [n, HALF, R,
    P, (k+1)*4*P], one step at a time (the working set is one step's)."""
    n, a, b, rows, cols = key.shape
    if rows != P or cols != kp1 * 4 * P:
        raise ValueError(f"a [n, ., ., {P}, {kp1 * 4 * P}] key, not "
                         f"{tuple(key.shape)}")
    HALF, R = (b, a) if r_major else (a, b)
    out = torch.empty((n, HALF, R, kp1, P // QH, BN, P), dtype=I8,
                      device=key.device)
    for i in range(n):
        blocks = key[i].transpose(0, 1) if r_major else key[i]
        jcq = blocks.reshape(HALF, R, P, kp1, 4, P).transpose(3, 4)
        out[i] = kmajor_order(jcq.reshape(HALF, R, P, cols), kp1)
    return out


def kmajor_from_bt(bsk_bt: torch.Tensor, kp1: int) -> torch.Tensor:
    """``bsk_btk`` from the per-step engines' R-major ``bsk_bt`` [n, R,
    HALF, P, (k+1)*4*P] (the JAX package's ``pallas_mega2`` key): per step
    the block axes swapped (``bsk_btj``), the columns (c, j, q) made (j, c,
    q) (``bsk_btjj``), then ``kmajor_order``.  Equal to
    ``server_key.block_toeplitz_layout(..., kmajor=True)``."""
    return _kmajor_steps(bsk_bt, kp1, r_major=True)


def kmajor_from_btj(bsk_btj: torch.Tensor, kp1: int) -> torch.Tensor:
    """``bsk_btk`` from the j-major ``bsk_btj`` [n, HALF, R, P, (k+1)*4*P]
    (the JAX package's ``pallas_mega7``, ``pallas_mega5`` and
    ``pallas_mega4`` key): per step the columns (c, j, q) made (j, c, q),
    then ``kmajor_order``.  The same re-lays the doubled ``bsk_btj2`` [n,
    2*HALF, R, P, (k+1)*4*P] (``pallas_mega8``, ``_mega9`` and
    ``_mega10``'s key) as ``bsk_btk2``: only the blocks' rows and columns
    are checked, and the window's groups are blocks like any other."""
    return _kmajor_steps(bsk_btj, kp1, r_major=False)


def pack_digits(p: TFHEParams, rot_minus_acc: torch.Tensor,
                descending: bool = True) -> torch.Tensor:
    """Balanced digits of X^a acc - acc [B, k+1, N], packed once per step as
    the JAX kernel packs them (``mega.py:696-701``): [B, HALF*R*P] int8,
    column block (HALF-1-sub)*R + r holding coefficients sub*P .. sub*P+P-1
    of GGSW row r = c*levels + level (sub DESCENDING, r minor).  With
    ``descending`` false, block sub*R + r (sub ascending, the doubled-window
    kernels' order, ``mega.py:523-526``)."""
    B = rot_minus_acc.shape[0]
    HALF = p.N // P
    R = (p.k + 1) * p.levels
    digits = signed_decompose(rot_minus_acc, p.bg_bits, p.levels)
    d = digits.permute(0, 1, 3, 2).reshape(B, R, HALF, P).to(I8)
    if descending:
        d = d.flip(2)
    return d.transpose(1, 2).reshape(B, HALF * R * P)


def recombine(total: torch.Tensor, kp1: int, jcq: bool) -> torch.Tensor:
    """One column tile's int32 limb partials [B, (k+1)*4*P], columns (j, c,
    q) with ``jcq`` or (c, j, q) without, to u32 [B, k+1, P]: sum_j
    partial_j << 8j mod 2^32 (``mega.py:528-540`` and ``:150-161``)."""
    B = total.shape[0]
    if jcq:
        limbs = total.reshape(B, 4, kp1, P).permute(0, 2, 3, 1)
    else:
        limbs = total.reshape(B, kp1, 4, P).permute(0, 1, 3, 2)
    return poly.from_i32_limb_partials(limbs)


def _plain_step(p: TFHEParams, acc: torch.Tensor, a_i: torch.Tensor,
                key_i: torch.Tensor) -> torch.Tensor:
    """One CMux step against one step's limb-major j-major key [HALF, R, P,
    (k+1)*4*P]: rotate, decompose and pack the digits; per column tile ct
    the digits' tail against stored blocks 0..ct minus their head against
    the negated blocks ct+1..HALF-1 (``torch._int_mm``); the recombine."""
    B, kp1, N = acc.shape
    HALF = N // P
    R = kp1 * p.levels
    rot = poly.negacyclic_monomial_mul(acc, a_i[:, None])
    D = pack_digits(p, rot - acc)
    key = key_i.reshape(HALF * R * P, kp1 * 4 * P)
    tiles = []
    for ct in range(HALF):
        split = (HALF - 1 - ct) * R * P
        total = int8_matmul(D[:, split:].contiguous(), key[:(ct + 1) * R * P])
        if split:
            total = total - int8_matmul(D[:, :split].contiguous(),
                                        key[(ct + 1) * R * P:])
        tiles.append(recombine(total, kp1, True))  # [B, k+1, P]
    return acc + torch.cat(tiles, dim=-1)


def blind_rotate_plain_btjj(params: TFHEParams, acc0: torch.Tensor,
                            a_t: torch.Tensor,
                            bsk_btjj: torch.Tensor) -> torch.Tensor:
    """The rotation in plain PyTorch, either device, on the JAX package's
    ``bsk_btjj`` key: per step the two-dot contraction of
    ``_ep_column_total_jmajor_packed`` (``ops/pallas/blind_rotate.py:129``)
    and the limb-major recombine (``mega.py:703-715``)."""
    p = params
    check_args(p, acc0, a_t, bsk_btjj)
    acc = acc0
    for i in range(p.n):
        acc = _plain_step(p, acc, a_t[i], bsk_btjj[i])
    return acc


def blind_rotate_plain_btk(params: TFHEParams, acc0: torch.Tensor,
                           a_t: torch.Tensor,
                           bsk_btk: torch.Tensor) -> torch.Tensor:
    """The rotation of ``mega12`` in plain PyTorch, either device, reading
    the same ``bsk_btk``: ``blind_rotate_plain_btjj``'s steps, each on its
    step key taken back to j-major order (``from_kmajor_order``)."""
    p = params
    check_args(p, acc0, a_t, bsk_btk, "bsk_btk", key_shape(p))
    acc = acc0
    for i in range(p.n):
        acc = _plain_step(p, acc, a_t[i], from_kmajor_order(bsk_btk[i]))
    return acc


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/mega12.cu`` with its C signatures declared."""
    lib = _build.load("mega12")
    lib.mega12_blind_rotate.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mega12_blind_rotate.restype = ctypes.c_int
    lib.mega12_plan.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.mega12_plan.restype = ctypes.c_int
    lib.mega12_error_string.argtypes = [ctypes.c_int]
    lib.mega12_error_string.restype = ctypes.c_char_p
    return lib


def kernel_plan(p: TFHEParams, B: int, n_sms: int) -> tuple[int, int, int]:
    """(bm, splits, cluster) that the built kernel's own ``mega12_plan``
    picks (the card tests hold it equal to ``plan``)."""
    bm, splits, cluster = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().mega12_plan(B, p.N, p.k + 1, (p.k + 1) * p.levels, n_sms,
                             ctypes.byref(bm), ctypes.byref(splits),
                             ctypes.byref(cluster))
    if err:
        raise ValueError(f"mega12_plan refused B={B} at {p.name}")
    return bm.value, splits.value, cluster.value


def scratch_bytes(p: TFHEParams, B: int) -> int:
    """Bytes of the kernel's digit scratch for B ciphertexts."""
    return (p.k + 1) * p.levels * p.N * (-(-B // 256) * 256)


def launch(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
           key: torch.Tensor, doubled: bool, counter) -> torch.Tensor:
    """One launch of the kernel's single (``bsk_btk``) or doubled
    (``bsk_btk2``) window on CUDA tensors the caller has checked (the key
    16-byte aligned for the bulk copies), counted in ``counter.launches``:
    the wrapper whose kernel it is."""
    lib = _lib()
    B = acc0.shape[0]
    # the kernel adds into out in place; its digit scratch holds B rounded
    # up to 256 rows (to whole cluster M tiles: 64, 128 or 256 rows), and
    # the barrier word is set to 0 by the entry point
    out = acc0.clone()
    dig = torch.empty(scratch_bytes(p, B), dtype=I8, device=acc0.device)
    bar = torch.empty(1, dtype=I32, device=acc0.device)
    with torch.cuda.device(acc0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mega12_blind_rotate(
            a_t.data_ptr(), key.data_ptr(), out.data_ptr(), dig.data_ptr(),
            bar.data_ptr(), B, p.n, p.N, p.k + 1, p.bg_bits, p.levels,
            int(doubled), stream)
    if err:
        raise RuntimeError(f"{counter.__name__} launch failed: "
                           + lib.mega12_error_string(err).decode())
    counter.launches += 1
    return out


def mega12_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btk: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation: acc0 [B, k+1, N] and a_t [n, B] (int32
    carriers), bsk_btk int8 [n, HALF, R, k+1, 2, 256, 128] -> acc [B, k+1,
    N].  CUDA tensors go through the kernel, CPU tensors through
    ``blind_rotate_plain_btk``."""
    check_params(params)
    check_args(params, acc0, a_t, bsk_btk, "bsk_btk", key_shape(params))
    if bsk_btk.data_ptr() % 16:  # the bulk copies' alignment
        raise ValueError("bsk_btk must be 16-byte aligned")
    if acc0.device.type == "cuda":
        return launch(params, acc0, a_t, bsk_btk, False, mega12_blind_rotate)
    if acc0.device.type == "cpu":
        return blind_rotate_plain_btk(params, acc0, a_t, bsk_btk)
    raise ValueError(f"mega12 runs on cuda or cpu, not {acc0.device}")


mega12_blind_rotate.launches = 0
