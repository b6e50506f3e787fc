"""Fused rotate + CMux difference + gadget decomposition kernel
(``csrc/rotate_decompose.cu``) and its plain PyTorch version.

``rotate_decompose`` replaces ``herdsman_tpu/ops/pallas/rotate_decompose.py::
_kernel`` and keeps its wrapper's layouts: acc [B, k+1, N] and a_i [B] in
[0, 2N) in, the balanced digits of X^{a_i} acc - acc out as int8
[R*HALF, B, P], row-tile major (the layout ``bt.external_product_bt``
reads).  On a CUDA tensor it launches the hand-written kernel (counted in
``rotate_decompose.launches``) or raises; on a CPU tensor it runs
``rotate_decompose_plain``.  The source note in ``csrc/rotate_decompose.cu``
gives the kernel's design and bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import _build
from herdsman_tpu_torch.ops.server_key import bt_tile

I32 = torch.int32
I8 = torch.int8


def _check_args(p: TFHEParams, acc: torch.Tensor, a_i: torch.Tensor) -> None:
    if p.N & (p.N - 1) or not 32 <= p.N <= 2048:
        raise ValueError(f"rotate_decompose takes N a power of two in "
                         f"[32, 2048], not {p.N} ({p.name})")
    B = acc.shape[0]
    for name, t, shape in (("acc", acc, (B, p.k + 1, p.N)),
                           ("a_i", a_i, (B,))):
        if t.dtype != I32:
            raise TypeError(f"{name} must be int32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != acc.device:
            raise ValueError(f"{name} is on {t.device}, acc on {acc.device}")
    if B < 1:
        raise ValueError("empty batch")


def rotate_decompose_plain(params: TFHEParams, acc: torch.Tensor,
                           a_i: torch.Tensor) -> torch.Tensor:
    """The same digits in plain PyTorch, either device: the port's
    negacyclic monomial product and ``signed_decompose``, reordered to the
    row-tile-major layout."""
    p = params
    _check_args(p, acc, a_i)
    P, HALF = bt_tile(p)
    B = acc.shape[0]
    R = (p.k + 1) * p.levels
    rot = poly.negacyclic_monomial_mul(acc, a_i[:, None])
    digits = signed_decompose(rot - acc, p.bg_bits, p.levels)  # [B,k+1,N,l]
    d8 = digits.permute(0, 1, 3, 2).reshape(B, R * HALF, P).to(I8)
    return d8.transpose(0, 1).contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/rotate_decompose.cu`` with its C signatures."""
    lib = _build.load("rotate_decompose")
    lib.rotate_decompose.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rotate_decompose.restype = ctypes.c_int
    lib.rotate_decompose_error_string.argtypes = [ctypes.c_int]
    lib.rotate_decompose_error_string.restype = ctypes.c_char_p
    return lib


def _launch(p: TFHEParams, acc: torch.Tensor,
            a_i: torch.Tensor) -> torch.Tensor:
    lib = _lib()
    P, HALF = bt_tile(p)
    B = acc.shape[0]
    out = torch.empty((p.k + 1) * p.levels * HALF, B, P, dtype=I8,
                      device=acc.device)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rotate_decompose(
            acc.data_ptr(), a_i.data_ptr(), out.data_ptr(), B, p.N, p.k + 1,
            p.bg_bits, p.levels, stream)
    if err:
        raise RuntimeError("rotate_decompose launch failed: "
                           + lib.rotate_decompose_error_string(err).decode())
    rotate_decompose.launches += 1
    return out


def rotate_decompose(params: TFHEParams, acc: torch.Tensor,
                     a_i: torch.Tensor) -> torch.Tensor:
    """acc int32 [B, k+1, N], a_i int32 [B] in [0, 2N) -> digits int8
    [R*HALF, B, P].  CUDA tensors go through the kernel, CPU tensors
    through ``rotate_decompose_plain``."""
    _check_args(params, acc, a_i)
    if acc.device.type == "cuda":
        return _launch(params, acc, a_i)
    if acc.device.type == "cpu":
        return rotate_decompose_plain(params, acc, a_i)
    raise ValueError(f"rotate_decompose runs on cuda or cpu, not {acc.device}")


rotate_decompose.launches = 0
