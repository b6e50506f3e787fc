"""Whole-rotation blind-rotation kernels of the bitcast-stream class at the
byte-aligned gadget, and their plain PyTorch versions.

The four wrappers serve the byte-aligned gadget bg = 2^8 and keep the
contract of the JAX package's wrappers they replace:

- ``mega16_blind_rotate``: levels 2, ``herdsman_tpu/ops/pallas/mega.py::
  _mega16_kernel`` (STD128_SHORTINT_FAST, the N=2048 bool-gate tier);
- ``mega17_blind_rotate``: levels 3, ``mega.py::_mega17_kernel``
  (STD128_SHORTINT_B8, the integer tier);
- ``mega15_blind_rotate``: levels 4, ``mega.py::_mega15_kernel``
  (STD128_SHORTINT_L4, the exact gadget);
- ``mega14_blind_rotate``: levels 2 against the extended key ``bsk_btTe``,
  ``mega.py::_mega14_kernel`` (STD128_K2, STD128_K4, STD128_FAST and
  STD128_SHORTINT_FAST: N >= 256).

acc0 [B, k+1, N] and a_t [n, B] in [0, 2N) in (int32 carriers), the
accumulator after the n CMux steps out, exact mod 2^32.  Each step packs
the digits of X^a acc - acc into a byte stream (``pack_stream``: byte
L*z + lb of polynomial c is digit lb, least significant first, of
coefficient z) and contracts it, per column tile ct, with the wrap-split
two-dot of ``mega.py:1578-1590``:

    out[ct*P + q] = key[q, :split] . D[L*ct*P:] - key[q, split:] . D[:L*ct*P]

with split = L*(N - ct*P), then recombines the limb rows (j, c_out, q)
limb-major into the accumulator.

The key is the compact step key ``bsk_btTc`` int8 [n, k+1 (c_in), k+1
(c_out), 4 (limb j), row_bytes]: per (step, c_in, c_out, j) one L-fold
interleaved limb sequence T[L*u + lb] = limb_j(ext(bsk[i, c_in*levels +
levels-1-lb, c_out])[(P-1-u) mod 2N]) of length L*(N+P-1), zero-padded.
Row q of the JAX package's single-width key ``[n, k+1, (k+1)*4*P, L*N]``
(``_btT3/_btTs/_btT4_layout_device``) is the slice of T at offset
(P-1-q)*L (``expand_key``), so the compact key holds the same numbers in
(N+P-1)/(P*N) of the bytes: 80 MB instead of 9.0 GiB at
STD128_SHORTINT_B8.

``mega14`` reads the extended key ``bsk_btTe`` int8 [n, k+1, k+1, 4,
row_bytes(p, extended=True)]: per (step, c_in, c_out, j) the limb sequence
Te[L*v + lb] = limb_j(ext(bsk[i, c_in*levels + levels-1-lb, c_out])[(N-1-v)
mod 2N]) of length L*(2N-1), so that output coefficient y reads the whole
stream as one run from offset (N-1-y)*L, the negated wrap already in the
key's values (``ext_tile_rows``): the JAX package's pt-major window
``bsk_btT2`` in 80 MB at STD128_K4 and 101 MB at STD128_SHORTINT_FAST.

On a CUDA tensor each wrapper launches its kernel (one launch per
rotation, counted in its ``launches``) or raises; on a CPU tensor it runs
``blind_rotate_plain_btTc`` (``blind_rotate_plain_btTe`` for ``mega14``).
All four are instantiations of ``csrc/megaS.cu`` (int8 tensor cores, the
key a register operand; ``ops/kernels/megaS.py``), whose source note gives
their design and bound: ``mega16``, ``mega17`` and ``mega15`` read
``bsk_btTc``, which at N >= 128 is ``mega13``'s ``bsk_btS`` byte for byte,
so they run ``mega13``'s kernel through their own C entries; ``mega14``
reads ``bsk_btTe``.
"""

from __future__ import annotations

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.kernels import megaS
from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul
from herdsman_tpu_torch.ops.u32 import srl, u32_const

I32 = torch.int32
I8 = torch.int8

P = 128                    # column tile: the kernels take N >= 128 only

# kernel -> the gadget depth it serves at bg = 2^8
KERNELS = {"mega16": 2, "mega17": 3, "mega15": 4, "mega14": 2}
# the kernels that read the extended key
EXTENDED = ("mega14",)
# kernel -> the key layout it reads
KEY_LAYOUTS = {name: "bsk_btTe" if name in EXTENDED else "bsk_btTc"
               for name in KERNELS}


def row_bytes(p: TFHEParams, extended: bool = False) -> int:
    """Bytes of one limb sequence of ``bsk_btTc`` (L*(N+P-1)) or of
    ``bsk_btTe`` (L*(2N-1)), with one word of slack for the kernel's shifted
    key reads, rounded up to 16."""
    span = 2 * p.N - 1 if extended else p.N + P - 1
    return -(-(p.levels * span + 4) // 16) * 16


def key_bytes(p: TFHEParams, extended: bool = False) -> int:
    """Bytes of the ``bsk_btTc`` (or ``bsk_btTe``) layout at ``p``."""
    return p.n * (p.k + 1) ** 2 * 4 * row_bytes(p, extended)


def check_params(p: TFHEParams, name: str) -> None:
    """Raise on a parameter set kernel ``name`` does not take: its own
    gadget (bg_bits 8, levels KERNELS[name]), k+1 in (2, 3, 5), N a power
    of two in [128, 2048] ([256, 2048] for ``mega14``, the JAX kernel's N
    >= 2P; ``bsk_btTc``'s column tile is 128)."""
    L = KERNELS[name]
    extended = name in EXTENDED
    if p.bg_bits != 8 or p.levels != L:
        raise ValueError(f"{name} takes bg_bits 8 and levels {L}, not "
                         f"{p.bg_bits} and {p.levels} ({p.name})")
    if p.k + 1 not in (2, 3, 5):
        raise ValueError(f"{name} takes k+1 in (2, 3, 5), not {p.k + 1} "
                         f"({p.name})")
    lo = 2 * P if extended else P
    if p.N & (p.N - 1) or not lo <= p.N <= 2048:
        raise ValueError(f"{name} takes N a power of two in [{lo}, 2048], "
                         f"not {p.N} ({p.name})")


def _check_args(p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
                key: torch.Tensor, extended: bool = False) -> None:
    kp1 = p.k + 1
    B = acc0.shape[0] if acc0.dim() == 3 else -1
    layout = "bsk_btTe" if extended else "bsk_btTc"
    shapes = {"acc0": (acc0, I32, (B, kp1, p.N)),
              "a_t": (a_t, I32, (p.n, B)),
              layout: (key, I8, (p.n, kp1, kp1, 4, row_bytes(p, extended)))}
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


def pack_stream(p: TFHEParams, diff: torch.Tensor) -> torch.Tensor:
    """The digit byte stream of diff [B, k+1, N] (int32 carrier) at the
    byte-aligned gadget: [B, k+1, L*N] int8, byte L*z + lb the digit lb
    (least significant first, so level L-1-lb) of coefficient z.  The bytes
    of the JAX kernels' ``compute_stream``: round to the top W = 8L bits,
    add the balanced offset 0x80.. (for W = 32 the exact
    ``diff + 0x80808080``, ``mega.py:1213``), keep the low L bytes of each
    coefficient (the carry past bit W-1 is dropped, ``mega.py:1563-1566``)
    and read each byte b as the digit b - 128."""
    B, kp1, N = diff.shape
    L = p.levels
    W = 8 * L
    offset = u32_const(sum(0x80 << (8 * t) for t in range(L)))
    if W < 32:
        val = srl(diff + (1 << (31 - W)), 32 - W) + offset
    else:
        val = diff + offset
    digits = torch.stack([(srl(val, 8 * lb) & 0xFF) - 128
                          for lb in range(L)], dim=-1)   # [B, k+1, N, L]
    return digits.to(I8).reshape(B, kp1, L * N)


def expand_key(p: TFHEParams, key: torch.Tensor) -> torch.Tensor:
    """The JAX package's single-width key [s, k+1, (k+1)*4*P, L*N] (rows
    (j, c_out, q)) from s steps of ``bsk_btTc`` [s, k+1, k+1, 4, row_bytes]:
    row q is the slice of its limb sequence at offset (P-1-q)*L."""
    s, kp1 = key.shape[:2]
    L, LN = p.levels, p.levels * p.N
    rows = key[..., :L * (p.N + P - 1)].unfold(-1, LN, L)  # [.., P, LN]
    rows = rows.flip(-2)                   # window w starts at (P-1-q)*L
    # [s, c_in, c_out, j, q, LN] -> [s, c_in, j, c_out, q, LN]
    return rows.permute(0, 1, 3, 2, 4, 5).reshape(s, kp1, 4 * kp1 * P, LN)


def blind_rotate_plain_btTc(params: TFHEParams, acc0: torch.Tensor,
                            a_t: torch.Tensor,
                            bsk_btTc: torch.Tensor) -> torch.Tensor:
    """The same rotation in plain PyTorch, either device, at levels 2, 3 or
    4 of the byte-aligned gadget, reading the same ``bsk_btTc`` key.  Per
    step: rotate, pack the digit stream (``pack_stream``), expand the step
    key (``expand_key``); per column tile, the wrap-split two-dot through
    ``torch._int_mm`` summed over c_in; then the limb-major recombine
    (``mega.py:1598-1608``) into the accumulator."""
    p = params
    _check_args(p, acc0, a_t, bsk_btTc)
    B, kp1, N = acc0.shape
    L = p.levels
    C4P = kp1 * 4 * P
    acc = acc0
    for i in range(p.n):
        rot = poly.negacyclic_monomial_mul(acc, a_t[i][:, None])
        # stream bytes and key columns s-major, c_in minor, so that one
        # product per run sums over c_in
        D = pack_stream(p, rot - acc).transpose(1, 2).contiguous()
        keyT = expand_key(p, bsk_btTc[i:i + 1])[0].permute(2, 0, 1)
        keyT = keyT.contiguous()                           # [L*N, k+1, C4P]
        tiles = []
        for ct in range(N // P):
            cut = L * ct * P
            split = L * N - cut
            total = int8_matmul(D[:, cut:].reshape(B, -1).contiguous(),
                                keyT[:split].reshape(-1, C4P))
            if cut:
                total = total - int8_matmul(
                    D[:, :cut].reshape(B, -1).contiguous(),
                    keyT[split:].reshape(-1, C4P))
            limbs = total.reshape(B, 4, kp1, P).permute(0, 2, 3, 1)
            tiles.append(poly.from_i32_limb_partials(limbs))  # [B, k+1, P]
        acc = acc + torch.cat(tiles, dim=-1)
    return acc


def ext_tile_rows(p: TFHEParams, step_key: torch.Tensor,
                  ct: int) -> torch.Tensor:
    """Rows of output column tile ct from one step of ``bsk_btTe`` [k+1,
    k+1, 4, row_bytes]: [k+1 (c_in), (k+1)*4*P (j, c_out, q), L*N], row (j,
    c_out, q) the run of L*N bytes at offset (N-1-ct*P-q)*L of its limb
    sequence, byte L*z + lb the coefficient of stream byte L*z + lb."""
    kp1 = step_key.shape[0]
    L, N = p.levels, p.N
    windows = step_key[..., :L * (2 * N - 1)].unfold(-1, L * N, L)
    rows = windows[..., N - (ct + 1) * P:N - ct * P, :].flip(-2)
    # [c_in, c_out, j, q, LN] -> [c_in, j, c_out, q, LN]
    return rows.permute(0, 2, 1, 3, 4).reshape(kp1, 4 * kp1 * P, L * N)


def blind_rotate_plain_btTe(params: TFHEParams, acc0: torch.Tensor,
                            a_t: torch.Tensor,
                            bsk_btTe: torch.Tensor) -> torch.Tensor:
    """The rotation of ``mega14`` in plain PyTorch, either device, reading
    the same ``bsk_btTe`` key.  Per step: rotate, pack the digit stream
    (``pack_stream``); per column tile one ``torch._int_mm`` of the whole
    stream, summed over c_in, with the tile's rows (``ext_tile_rows``): no
    wrap split; then the limb-major recombine into the accumulator."""
    p = params
    _check_args(p, acc0, a_t, bsk_btTe, extended=True)
    B, kp1, N = acc0.shape
    C4P = kp1 * 4 * P
    acc = acc0
    for i in range(p.n):
        rot = poly.negacyclic_monomial_mul(acc, a_t[i][:, None])
        D = pack_stream(p, rot - acc).transpose(1, 2).reshape(B, -1)
        tiles = []
        for ct in range(N // P):
            rows = ext_tile_rows(p, bsk_btTe[i], ct)   # [c_in, C4P, L*N]
            total = int8_matmul(D.contiguous(),
                                rows.permute(2, 0, 1).reshape(-1, C4P))
            limbs = total.reshape(B, 4, kp1, P).permute(0, 2, 3, 1)
            tiles.append(poly.from_i32_limb_partials(limbs))  # [B, k+1, P]
        acc = acc + torch.cat(tiles, dim=-1)
    return acc


def plain(name: str):
    """The plain version of kernel ``name``: fn(params, acc0, a_t, key)."""
    return (blind_rotate_plain_btTe if name in EXTENDED
            else blind_rotate_plain_btTc)


def _rotate(name: str, wrapper, p: TFHEParams, acc0: torch.Tensor,
            a_t: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    check_params(p, name)
    _check_args(p, acc0, a_t, key, extended=name in EXTENDED)
    if acc0.device.type == "cpu":
        return plain(name)(p, acc0, a_t, key)
    if acc0.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {acc0.device}")
    out = megaS.launch(name, p, acc0, a_t, key)
    wrapper.launches += 1
    return out


def mega16_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btTc: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation at bg = 2^8, levels 2 (adjacent-pair packing):
    acc0 [B, k+1, N] and a_t [n, B] (int32 carriers), bsk_btTc int8 [n,
    k+1, k+1, 4, row_bytes] -> acc [B, k+1, N].  CUDA tensors go through
    ``csrc/megaS.cu`` (``mega13``'s kernel, its own C entry), CPU tensors
    through ``blind_rotate_plain_btTc``."""
    return _rotate("mega16", mega16_blind_rotate, params, acc0, a_t, bsk_btTc)


def mega17_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btTc: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation at bg = 2^8, levels 3 (3-of-4 packing); the
    contract of ``mega16_blind_rotate``, its kernel ``csrc/megaS.cu``
    (``mega13``'s)."""
    return _rotate("mega17", mega17_blind_rotate, params, acc0, a_t, bsk_btTc)


def mega15_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btTc: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation at bg = 2^8, levels 4 (the exact gadget, one
    coefficient per word); the contract of ``mega16_blind_rotate``, its
    kernel ``csrc/megaS.cu`` (``mega13``'s)."""
    return _rotate("mega15", mega15_blind_rotate, params, acc0, a_t, bsk_btTc)


def mega14_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btTe: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation at bg = 2^8, levels 2, against the extended key
    (one run per column tile, no wrap split): acc0 [B, k+1, N] and a_t [n,
    B] (int32 carriers), bsk_btTe int8 [n, k+1, k+1, 4, row_bytes(p,
    extended=True)] -> acc [B, k+1, N].  CUDA tensors go through the kernel
    (``csrc/megaS.cu``), CPU tensors through ``blind_rotate_plain_btTe``."""
    return _rotate("mega14", mega14_blind_rotate, params, acc0, a_t, bsk_btTe)


mega16_blind_rotate.launches = 0
mega17_blind_rotate.launches = 0
mega15_blind_rotate.launches = 0
mega14_blind_rotate.launches = 0
