"""Whole-rotation blind-rotation kernel (``csrc/mega13.cu``) and its plain
PyTorch version.

``mega13_blind_rotate`` replaces ``herdsman_tpu/ops/pallas/mega.py::
_mega13_kernel`` and keeps its wrapper's signature: acc0 [B, k+1, N], a_t
[n, B] in [0, 2N) and the bootstrapping key in, the accumulator after the n
CMux steps out.  On a CUDA tensor it launches the hand-written kernel (one
launch per rotation, counted in ``mega13_blind_rotate.launches``) or raises;
on a CPU tensor it runs ``blind_rotate_plain``.  The source note in
``csrc/mega13.cu`` gives the kernel's design and bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import _build

I32 = torch.int32
I8 = torch.int8

G = 8                      # ciphertexts per block, as in csrc/mega13.cu
SMEM_LIMIT = 232_448       # bytes of shared memory one H100 block may use


def smem_bytes(p: TFHEParams) -> int:
    """Shared memory of one block: G accumulators, one key row, digits."""
    kp1 = p.k + 1
    return (G * kp1 * p.N + 2 * kp1 * p.N + p.N * G + G) * 4


def check_params(p: TFHEParams) -> None:
    """Raise on a parameter set the kernel does not take."""
    if p.k + 1 not in (2, 3, 5):
        raise ValueError(f"mega13 takes k+1 in (2, 3, 5), not {p.k + 1} "
                         f"({p.name})")
    if p.N & (p.N - 1) or not 32 <= p.N <= 2048:
        raise ValueError(f"mega13 takes N a power of two in [32, 2048], "
                         f"not {p.N} ({p.name})")
    if smem_bytes(p) > SMEM_LIMIT:
        raise ValueError(f"mega13 at {p.name} needs {smem_bytes(p)} bytes "
                         f"of shared memory per block, over {SMEM_LIMIT}")


def _check_args(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
                bsk: torch.Tensor, key_width: int) -> None:
    R = (p.k + 1) * p.levels
    shapes = {"acc0": (acc0, (acc0.shape[0], p.k + 1, p.N)),
              "a_t": (a_t, (p.n, acc0.shape[0])),
              "bsk": (bsk, (p.n, R, p.k + 1, key_width))}
    for name, (t, shape) in shapes.items():
        if t.dtype != I32:
            raise TypeError(f"{name} must be int32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != acc0.device:
            raise ValueError(f"{name} is on {t.device}, acc0 on {acc0.device}")


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, C] -> exact int32 [M, C] via ``torch._int_mm``.

    The CUDA int8 matmul wants more than 16 rows and K, C multiples of 8:
    rows are padded here; K and C are the callers' (key layouts are padded
    when they are built)."""
    M = a.shape[0]
    rows = max(32, -(-M // 8) * 8)
    if rows != M:
        a = torch.nn.functional.pad(a, (0, 0, 0, rows - M))
    return torch._int_mm(a, b)[:M]


def blind_rotate_plain(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor, bsk_ext: torch.Tensor) -> torch.Tensor:
    """The same rotation in plain PyTorch, any gadget, either device.

    Each step is the int8-limb external product: balanced digits
    [B, R*N] times the step key's limb-Toeplitz matrix [R*N, (k+1)*N*4]
    (T[(r, j), (c, m, limb)] = limb(ext[r, c][(m - j) mod 2N])) through
    ``torch._int_mm``, then the limb recombine.  Exact: digits and limbs are
    at most 128 in size, so every int32 partial sum stays below
    R*N*2^14 < 2^31.  bsk_ext [n, R, k+1, 2N]."""
    p = params
    _check_args(p, acc0, a_t, bsk_ext, 2 * p.N)
    B, kp1, N = acc0.shape
    R = kp1 * p.levels
    idx = poly._toeplitz_indices(N, acc0.device)
    acc = acc0
    for i in range(p.n):
        rot = poly.negacyclic_monomial_mul(acc, a_t[i][:, None])
        digits = signed_decompose(rot - acc, p.bg_bits, p.levels)  # [B,k+1,N,l]
        d8 = digits.permute(0, 1, 3, 2).reshape(B, R * N).to(I8)
        limbs = poly.to_i8_limbs(bsk_ext[i][..., idx])  # [R, k+1, N, N, 4]
        M = limbs.permute(0, 2, 1, 3, 4).reshape(R * N, kp1 * N * 4)
        part = int8_matmul(d8, M).reshape(B, kp1, N, 4)
        acc = acc + poly.from_i32_limb_partials(part)
    return acc


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/mega13.cu`` with its C signatures declared."""
    lib = _build.load("mega13")
    lib.mega13_blind_rotate.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.mega13_blind_rotate.restype = ctypes.c_int
    lib.mega13_error_string.argtypes = [ctypes.c_int]
    lib.mega13_error_string.restype = ctypes.c_char_p
    lib.mega13_ciphertexts_per_block.argtypes = []
    lib.mega13_ciphertexts_per_block.restype = ctypes.c_int
    if lib.mega13_ciphertexts_per_block() != G:
        raise RuntimeError("csrc/mega13.cu and mega13.py disagree on G")
    return lib


def _launch(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
            bsk: torch.Tensor) -> torch.Tensor:
    lib = _lib()
    B0 = acc0.shape[0]
    pad = (-B0) % G
    if pad:  # zero lanes rotate to zero and are cut off below
        acc0 = torch.nn.functional.pad(acc0, (0, 0, 0, 0, 0, pad))
        a_t = torch.nn.functional.pad(a_t, (0, pad)).contiguous()
    out = torch.empty_like(acc0)
    with torch.cuda.device(acc0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mega13_blind_rotate(
            acc0.data_ptr(), a_t.data_ptr(), bsk.data_ptr(), out.data_ptr(),
            acc0.shape[0], p.n, p.N, p.k + 1, p.bg_bits, p.levels, stream)
    if err:
        raise RuntimeError("mega13 launch failed: "
                           + lib.mega13_error_string(err).decode())
    mega13_blind_rotate.launches += 1
    return out[:B0]


def mega13_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor, bsk: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation: acc0 [B, k+1, N], a_t [n, B], bsk [n, R, k+1, N]
    (int32 carriers) -> acc [B, k+1, N].  CUDA tensors go through the
    kernel, CPU tensors through ``blind_rotate_plain``."""
    check_params(params)
    _check_args(params, acc0, a_t, bsk, params.N)
    if acc0.device.type == "cuda":
        return _launch(params, acc0, a_t, bsk)
    if acc0.device.type == "cpu":
        return blind_rotate_plain(params, acc0, a_t,
                                  poly.negacyclic_extend(bsk).contiguous())
    raise ValueError(f"mega13 runs on cuda or cpu, not {acc0.device}")


mega13_blind_rotate.launches = 0
