"""Whole-rotation blind-rotation kernel against the limb-major block-Toeplitz
key (``csrc/mega12.cu``), and its plain PyTorch version.

``mega12_blind_rotate`` replaces ``herdsman_tpu/ops/pallas/mega.py::
_mega12_kernel`` (the integer tier's engine, ``pallas_mega12``) and keeps its
wrapper's contract: acc0 [B, k+1, N], a_t [n, B] in [0, 2N) and the
``bsk_btjj`` key int8 [n, HALF, R, P, (k+1)*4*P] in, the accumulator after
the n CMux steps out, exact mod 2^32.  On a CUDA tensor it launches the
hand-written kernel (one launch per rotation, counted in
``mega12_blind_rotate.launches``) or raises; on a CPU tensor it runs
``blind_rotate_plain_btjj``.  The source note in ``csrc/mega12.cu`` gives
the kernel's design and bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import _build
from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul

I32 = torch.int32
I8 = torch.int8

P = 128                    # column tile: the kernel takes N >= 128 only
SMEM_LIMIT = 232_448       # bytes of shared memory one H100 block may use


def smem_bytes(p: TFHEParams, G: int) -> int:
    """Shared memory of one block of G ciphertexts: their accumulators
    (u32) and one step's int8 digits, plus the G rotation amounts."""
    R = (p.k + 1) * p.levels
    return G * ((p.k + 1) * p.N * 4 + R * p.N + 4)


def check_params(p: TFHEParams, name: str = "mega12") -> None:
    """Raise on a parameter set the kernel ``name`` (``mega12``, or one of
    ``megaJ.cu``'s, which share its block layout) does not take: k+1 in (2,
    3, 5), N a power of two in [128, 2048], bg_bits <= 8 (int8 digits), and
    one ciphertext's accumulator and digits within a block's shared
    memory."""
    if p.k + 1 not in (2, 3, 5):
        raise ValueError(f"{name} takes k+1 in (2, 3, 5), not {p.k + 1} "
                         f"({p.name})")
    if p.N & (p.N - 1) or not P <= p.N <= 2048:
        raise ValueError(f"{name} takes N a power of two in [{P}, 2048], "
                         f"not {p.N} ({p.name})")
    if p.bg_bits > 8:
        raise ValueError(f"{name} takes bg_bits <= 8, not {p.bg_bits} "
                         f"({p.name})")
    if smem_bytes(p, 1) > SMEM_LIMIT:
        raise ValueError(f"{name} at {p.name} needs {smem_bytes(p, 1)} "
                         f"bytes of shared memory per ciphertext, over "
                         f"{SMEM_LIMIT}")


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


def blind_rotate_plain_btjj(params: TFHEParams, acc0: torch.Tensor,
                            a_t: torch.Tensor, bsk_btjj: torch.Tensor,
                            jcq: bool = True) -> torch.Tensor:
    """The same rotation in plain PyTorch, either device, reading the same
    ``bsk_btjj`` key.  Per step: rotate, decompose and pack the digits
    (``pack_digits``); per column tile ct, the two-dot contraction of
    ``_ep_column_total_jmajor_packed`` (``ops/pallas/blind_rotate.py:129``)
    through ``torch._int_mm``: the digits' tail against stored blocks
    0..ct, minus their head against the negated blocks ct+1..HALF-1; then
    the limb-major recombine (``mega.py:703-715``) into the accumulator.
    With ``jcq`` false the key's columns are (c, j, q): the ``bsk_btj``
    key of ``megaJ.mega7_blind_rotate``."""
    p = params
    check_args(p, acc0, a_t, bsk_btjj)
    B, kp1, N = acc0.shape
    HALF = N // P
    R = kp1 * p.levels
    acc = acc0
    for i in range(p.n):
        rot = poly.negacyclic_monomial_mul(acc, a_t[i][:, None])
        D = pack_digits(p, rot - acc)
        key = bsk_btjj[i].reshape(HALF * R * P, kp1 * 4 * P)
        tiles = []
        for ct in range(HALF):
            split = (HALF - 1 - ct) * R * P
            total = int8_matmul(D[:, split:].contiguous(),
                                key[:(ct + 1) * R * P])
            if split:
                total = total - int8_matmul(D[:, :split].contiguous(),
                                            key[(ct + 1) * R * P:])
            tiles.append(recombine(total, kp1, jcq))  # [B, k+1, P]
        acc = acc + torch.cat(tiles, dim=-1)
    return acc


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/mega12.cu`` with its C signatures declared."""
    lib = _build.load("mega12")
    lib.mega12_blind_rotate.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mega12_blind_rotate.restype = ctypes.c_int
    lib.mega12_ciphertexts_per_block.argtypes = [ctypes.c_int] * 5
    lib.mega12_ciphertexts_per_block.restype = ctypes.c_int
    lib.mega12_error_string.argtypes = [ctypes.c_int]
    lib.mega12_error_string.restype = ctypes.c_char_p
    return lib


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ciphertexts_per_block(p: TFHEParams, B: int,
                          device: torch.device) -> int:
    """The G the kernel picks for a rotation of B ciphertexts at ``p`` on
    the card ``device`` (0 where it takes none)."""
    return _lib().mega12_ciphertexts_per_block(
        B, p.N, p.k + 1, (p.k + 1) * p.levels, _sms(device))


def _launch(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
            key: torch.Tensor) -> torch.Tensor:
    lib = _lib()
    out = torch.empty_like(acc0)
    with torch.cuda.device(acc0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mega12_blind_rotate(
            acc0.data_ptr(), a_t.data_ptr(), key.data_ptr(), out.data_ptr(),
            acc0.shape[0], p.n, p.N, p.k + 1, p.bg_bits, p.levels,
            _sms(acc0.device), stream)
    if err:
        raise RuntimeError("mega12 launch failed: "
                           + lib.mega12_error_string(err).decode())
    mega12_blind_rotate.launches += 1
    return out


def mega12_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btjj: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation: acc0 [B, k+1, N] and a_t [n, B] (int32
    carriers), bsk_btjj int8 [n, HALF, R, P, (k+1)*4*P] -> acc [B, k+1, N].
    CUDA tensors go through the kernel, CPU tensors through
    ``blind_rotate_plain_btjj``."""
    check_params(params)
    check_args(params, acc0, a_t, bsk_btjj)
    if acc0.device.type == "cuda":
        return _launch(params, acc0, a_t, bsk_btjj)
    if acc0.device.type == "cpu":
        return blind_rotate_plain_btjj(params, acc0, a_t, bsk_btjj)
    raise ValueError(f"mega12 runs on cuda or cpu, not {acc0.device}")


mega12_blind_rotate.launches = 0
