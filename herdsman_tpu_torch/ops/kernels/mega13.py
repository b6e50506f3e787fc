"""Whole-rotation blind-rotation kernel on int8 tensor cores against the
compact stream key (``csrc/megaS.cu``), and its plain PyTorch version.

``mega13_blind_rotate`` replaces ``herdsman_tpu/ops/pallas/mega.py::
_mega13_kernel`` (the boolean path's engine) and keeps its wrapper's
signature: acc0 [B, k+1, N], a_t [n, B] in [0, 2N) and the bootstrapping
key in, the accumulator after the n CMux steps out, exact mod 2^32.  The
key is ``bsk_btS`` int8 [n, k+1 (c_in), k+1 (c_out), 4 (limb j), RB]: per
(step, c_in, c_out, j) one L-fold interleaved limb sequence T[L*u + lb] =
limb_j(ext(bsk[i, c_in*L + L-1-lb, c_out])[(P-1-u) mod 2N]) for u < N+P-1,
zeros after, with P = min(128, N) (``server_key.stream_key_layout``; at the
byte-aligned gadget and N >= 128 it is ``bsk_btTc``).  Row (j, c_out, q) of
column tile ct reads it from byte (P-1-q)*L, against the digit stream
rotated by L*ct*P bytes, the wrapped bytes negated (``expand_rows``).

On a CUDA tensor it launches the hand-written kernel (one launch per
rotation, counted in ``mega13_blind_rotate.launches``) or raises; on a CPU
tensor it runs ``blind_rotate_plain_btS``.  Every set the kernel takes (any
gadget with bg_bits <= 8 and levels 1-4, N a power of two in [32, 2048],
k+1 in (2, 3, 5)) goes through the one tensor-core kernel: below N = 128 the
column tile is N itself.  The source note in ``csrc/megaS.cu`` gives the
design and bound.
"""

from __future__ import annotations

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import megaS

I32 = torch.int32
I8 = torch.int8


def check_params(p: TFHEParams) -> None:
    """Raise on a parameter set the kernel does not take: k+1 in (2, 3, 5),
    N a power of two in [32, 2048], bg_bits <= 8 (int8 digits) and levels
    1-4 with bg_bits * levels <= 32."""
    if p.k + 1 not in (2, 3, 5):
        raise ValueError(f"mega13 takes k+1 in (2, 3, 5), not {p.k + 1} "
                         f"({p.name})")
    if p.N & (p.N - 1) or not 32 <= p.N <= 2048:
        raise ValueError(f"mega13 takes N a power of two in [32, 2048], "
                         f"not {p.N} ({p.name})")
    if not (1 <= p.bg_bits <= 8 and 1 <= p.levels <= 4
            and p.bg_bits * p.levels <= 32):
        raise ValueError(f"mega13 takes bg_bits <= 8 and levels 1-4, not "
                         f"{p.bg_bits} and {p.levels} ({p.name})")


def _check_args(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
                key: torch.Tensor) -> None:
    B = acc0.shape[0] if acc0.dim() == 3 else -1
    shapes = {"acc0": (acc0, I32, (B, p.k + 1, p.N)),
              "a_t": (a_t, I32, (p.n, B)),
              "bsk_btS": (key, I8, megaS.key_shape(p))}
    for name, (t, dtype, shape) in shapes.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != acc0.device:
            raise ValueError(f"{name} is on {t.device}, acc0 on {acc0.device}")
    if B < 1:
        raise ValueError("empty batch")


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


def digit_stream(p: TFHEParams, diff: torch.Tensor) -> torch.Tensor:
    """The digit byte stream of diff [B, k+1, N] (int32 carrier): [B, k+1,
    LNp] int8, byte L*z + lb the balanced digit of level L-1-lb (least
    significant first) of coefficient z, zeros from L*N to LNp (the stream
    padded to whole 128-byte K blocks).  At bg = 2^8 these are the bytes of
    ``megaT.pack_stream``."""
    B, kp1, N = diff.shape
    digits = signed_decompose(diff, p.bg_bits, p.levels).flip(-1)
    D = digits.to(I8).reshape(B, kp1, p.levels * N)
    pad = megaS.geometry(N, p.levels, False).LNp - p.levels * N
    return torch.nn.functional.pad(D, (0, pad)) if pad else D


def expand_rows(p: TFHEParams, step_key: torch.Tensor) -> torch.Tensor:
    """The rows of one step of ``bsk_btS`` [k+1, k+1, 4, RB]: [LNp, k+1
    (c_in), (k+1)*4*P (j, c_out, q)], row (j, c_out, q) the run of LNp bytes
    from byte (P-1-q)*L of its limb sequence, K-major."""
    kp1 = step_key.shape[0]
    L = p.levels
    P, _, LNp, _ = megaS.geometry(p.N, L, False)
    runs = step_key[..., :L * (P - 1) + LNp].unfold(-1, LNp, L)  # [.., P, LNp]
    runs = runs.flip(-2)                  # window P-1-q is row q
    # [c_in, c_out, j, q, s] -> [s, c_in, j, c_out, q]
    return runs.permute(4, 0, 2, 1, 3).reshape(LNp, kp1, kp1 * 4 * P)


def blind_rotate_plain_btS(params: TFHEParams, acc0: torch.Tensor,
                           a_t: torch.Tensor,
                           bsk_btS: torch.Tensor) -> torch.Tensor:
    """The rotation of ``mega13`` in plain PyTorch, either device, reading
    the same ``bsk_btS``.  Per step: rotate, the digit stream
    (``digit_stream``), the step key's rows (``expand_rows``); per column
    tile ct of P, the wrap-split two-dot through ``torch._int_mm`` summed
    over c_in (the stream from byte L*ct*P on against the first rows' bytes,
    minus its first L*ct*P bytes against the rest); then the limb-major
    recombine into the accumulator."""
    p = params
    _check_args(p, acc0, a_t, bsk_btS)
    B, kp1, N = acc0.shape
    L = p.levels
    P, _, LNp, _ = megaS.geometry(N, L, False)
    C4P = kp1 * 4 * P
    acc = acc0
    for i in range(p.n):
        rot = poly.negacyclic_monomial_mul(acc, a_t[i][:, None])
        # stream bytes and key rows s-major, c_in minor, so that one
        # product per run sums over c_in
        D = digit_stream(p, rot - acc).transpose(1, 2).contiguous()
        rows = expand_rows(p, bsk_btS[i]).contiguous()   # [LNp, k+1, C4P]
        tiles = []
        for ct in range(N // P):
            cut = L * ct * P
            split = LNp - cut
            total = int8_matmul(D[:, cut:].reshape(B, -1).contiguous(),
                                rows[:split].reshape(-1, C4P))
            if cut:
                total = total - int8_matmul(
                    D[:, :cut].reshape(B, -1).contiguous(),
                    rows[split:].reshape(-1, C4P))
            limbs = total.reshape(B, 4, kp1, P).permute(0, 2, 3, 1)
            tiles.append(poly.from_i32_limb_partials(limbs))  # [B, k+1, P]
        acc = acc + torch.cat(tiles, dim=-1)
    return acc


def mega13_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor, bsk_btS: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation: acc0 [B, k+1, N] and a_t [n, B] (int32
    carriers), bsk_btS int8 [n, k+1, k+1, 4, RB] -> acc [B, k+1, N].  CUDA
    tensors go through the kernel (``csrc/megaS.cu``), CPU tensors through
    ``blind_rotate_plain_btS``."""
    check_params(params)
    _check_args(params, acc0, a_t, bsk_btS)
    if acc0.device.type == "cuda":
        out = megaS.launch("mega13", params, acc0, a_t, bsk_btS)
        mega13_blind_rotate.launches += 1
        return out
    if acc0.device.type == "cpu":
        return blind_rotate_plain_btS(params, acc0, a_t, bsk_btS)
    raise ValueError(f"mega13 runs on cuda or cpu, not {acc0.device}")


mega13_blind_rotate.launches = 0
