"""Block-Toeplitz external-product kernel (``csrc/bt_external_product.cu``)
and its plain PyTorch version.

``external_product_bt`` replaces ``herdsman_tpu/ops/pallas/blind_rotate.py::
_kernel`` / ``_kernel_fused`` and keeps their wrapper's layouts: digits d8
int8 [R*HALF, B, P] (row-tile major), one step's key ``bsk_bt[i]`` int8
[R, HALF, P, (k+1)*4*P], out [B, k+1, N], plus ``glwe`` when given (the
fused CMux accumulate).  On a CUDA tensor it launches the hand-written
kernel (counted in ``external_product_bt.launches``) or raises; on a CPU
tensor it runs ``external_product_bt_plain``.  The source note in
``csrc/bt_external_product.cu`` gives the kernel's design and bound: int8
tensor cores (``wgmma``) on a K-major staged key, with the tile plan and
the K splits of narrow widths that ``plan`` mirrors here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.kernels import _build
from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul
from herdsman_tpu_torch.ops.server_key import bt_tile

I32 = torch.int32
I8 = torch.int8


QB_MAX = 64  # q columns of one limb in a kernel block


class Plan(NamedTuple):
    """The kernel's tiling of one call: ``bm`` ciphertexts a block (64 or
    128), ``splits`` K splits, and the grid (M tiles, column tiles, splits),
    a column tile being (ct, c, q block) of ``qb`` q columns of 4 limbs."""
    bm: int
    splits: int
    qb: int
    grid: tuple[int, int, int]


def plan(p: TFHEParams, B: int, n_sms: int) -> Plan:
    """``make_plan`` of ``csrc/bt_external_product.cu`` on a card of
    ``n_sms`` SMs: 128-row tiles where they alone give every SM a block,
    else 64; then K splits over the R*HALF (r, m) blocks while the blocks
    still fit one wave."""
    P, HALF = bt_tile(p)
    qb = min(P, QB_MAX)
    tiles_n = HALF * (p.k + 1) * (P // qb)
    KB = (p.k + 1) * p.levels * HALF
    bm = 128 if -(-B // 128) * tiles_n >= n_sms else 64
    blocks = -(-B // bm) * tiles_n
    splits = max(1, min(KB, n_sms // blocks))
    return Plan(bm, splits, qb, (-(-B // bm), tiles_n, splits))


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def operations(p: TFHEParams, B: int, device: torch.device) -> int:
    """Device operations one call at width ``B`` issues on ``device``: the
    kernel, and before it the entry point's set of ``out`` (to 0 or to
    ``glwe``) where ``plan`` splits K.  On a CPU tensor the plain version
    stands for the kernel alone."""
    if device.type != "cuda":
        return 1
    return 1 + (plan(p, B, _sms(device)).splits > 1)


def check_params(p: TFHEParams) -> None:
    """Raise on a parameter set the kernel does not take."""
    if p.N & (p.N - 1) or not 32 <= p.N <= 2048:
        raise ValueError(f"bt_external_product takes N a power of two in "
                         f"[32, 2048], not {p.N} ({p.name})")


def _check_args(p: TFHEParams, d8: torch.Tensor, key: torch.Tensor,
                glwe: torch.Tensor | None) -> None:
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    B = d8.shape[1] if d8.dim() == 3 else -1
    shapes = {"d8": (d8, I8, (R * HALF, B, P)),
              "key": (key, I8, (R, HALF, P, (p.k + 1) * 4 * P))}
    if glwe is not None:
        shapes["glwe"] = (glwe, I32, (B, p.k + 1, p.N))
    for name, (t, dtype, shape) in shapes.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != d8.device:
            raise ValueError(f"{name} is on {t.device}, d8 on {d8.device}")
    if B < 1:
        raise ValueError("empty batch")
    # d8 and key are staged in 16-byte loads, glwe read in 8-byte ones
    for name, t, align in (("d8", d8, 16), ("key", key, 16), ("glwe", glwe, 8)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def external_product_bt_plain(params: TFHEParams, d8: torch.Tensor,
                              key: torch.Tensor,
                              glwe: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """The same product in plain PyTorch, either device: for each column
    tile ct, one int8 product over the positive diagonal run minus one over
    the negated run (``_ep_column_total`` of the JAX kernel), all R rows in
    each, through ``torch._int_mm``; then the limb recombine."""
    p = params
    _check_args(p, d8, key, glwe)
    P, HALF = bt_tile(p)
    R = (p.k + 1) * p.levels
    B = d8.shape[1]
    d = d8.reshape(R, HALF, B, P)

    def run(ms: range, subs: list[int]) -> torch.Tensor:
        """[B, C4P] partial of stored blocks ``ms`` against digit tiles
        ``subs``, every GGSW row."""
        dig = torch.cat([d[r, s] for s in subs for r in range(R)], dim=1)
        k = key[:, ms.start:ms.stop].transpose(0, 1).reshape(-1, key.shape[-1])
        return int8_matmul(dig, k)

    tiles = []
    for ct in range(HALF):
        total = run(range(0, ct + 1), [ct - m for m in range(ct + 1)])
        if ct + 1 < HALF:
            total = total - run(range(ct + 1, HALF),
                                [HALF + ct - m for m in range(ct + 1, HALF)])
        limbs = total.reshape(B, p.k + 1, 4, P).transpose(2, 3)
        tiles.append(poly.from_i32_limb_partials(limbs))   # [B, k+1, P]
    out = torch.cat(tiles, dim=-1)
    return out if glwe is None else glwe + out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/bt_external_product.cu`` with its C signatures."""
    lib = _build.load("bt_external_product")
    lib.bt_external_product.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.bt_external_product.restype = ctypes.c_int
    lib.bt_plan.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.bt_plan.restype = ctypes.c_int
    lib.bt_error_string.argtypes = [ctypes.c_int]
    lib.bt_error_string.restype = ctypes.c_char_p
    return lib


def kernel_plan(p: TFHEParams, B: int, n_sms: int) -> tuple[int, int]:
    """(bm, splits) that the built kernel's own ``bt_plan`` picks (the card
    tests hold it equal to ``plan``)."""
    bm, splits = ctypes.c_int(), ctypes.c_int()
    err = _lib().bt_plan(B, p.N, p.k + 1, (p.k + 1) * p.levels, n_sms,
                         ctypes.byref(bm), ctypes.byref(splits))
    if err:
        raise ValueError(f"bt_plan refused B={B} at {p.name}")
    return bm.value, splits.value


def _launch(p: TFHEParams, d8: torch.Tensor, key: torch.Tensor,
            glwe: torch.Tensor | None) -> torch.Tensor:
    lib = _lib()
    B = d8.shape[1]
    # with K splits the entry point first sets out to 0 (or to glwe)
    out = torch.empty(B, p.k + 1, p.N, dtype=I32, device=d8.device)
    with torch.cuda.device(d8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bt_external_product(
            d8.data_ptr(), key.data_ptr(),
            None if glwe is None else glwe.data_ptr(), out.data_ptr(),
            B, p.N, p.k + 1, (p.k + 1) * p.levels, stream)
    if err:
        raise RuntimeError("bt_external_product launch failed: "
                           + lib.bt_error_string(err).decode())
    external_product_bt.launches += 1
    return out


def external_product_bt(params: TFHEParams, d8: torch.Tensor,
                        key: torch.Tensor,
                        glwe: torch.Tensor | None = None) -> torch.Tensor:
    """One step's external product: d8 int8 [R*HALF, B, P], key int8
    [R, HALF, P, (k+1)*4*P] (+ glwe int32 [B, k+1, N]) -> int32 [B, k+1, N].
    CUDA tensors go through the kernel, CPU tensors through
    ``external_product_bt_plain``."""
    check_params(params)
    _check_args(params, d8, key, glwe)
    if d8.device.type == "cuda":
        return _launch(params, d8, key, glwe)
    if d8.device.type == "cpu":
        return external_product_bt_plain(params, d8, key, glwe)
    raise ValueError(f"bt_external_product runs on cuda or cpu, "
                     f"not {d8.device}")


external_product_bt.launches = 0
