"""The stream-key rotation kernel on int8 tensor cores (``csrc/megaS.cu``):
its geometry, its work plan and the launch that ``mega13_blind_rotate``
(``ops/kernels/mega13.py``, on ``bsk_btS``), ``mega14_blind_rotate`` (on
``bsk_btTe``) and ``mega17_blind_rotate``, ``mega15_blind_rotate`` and
``mega16_blind_rotate`` (on ``bsk_btTc``, which at N >= 128 is ``bsk_btS``
byte for byte: ``mega13``'s kernel with their own C entries; all four in
``ops/kernels/megaT.py``) share.

Both keys hold, per (step, c_in, c_out, limb j), one L-fold interleaved limb
sequence T[L*u + lb] = limb_j(ext(bsk[i, c_in*L + L-1-lb, c_out])[(P-1-u)
mod 2N]) for u < N+P-1, zeros after: P = min(128, N) for ``mega13``'s
single-width key, P = N for ``mega14``'s extended one.  Output coefficient
ct*P + q reads it from byte (P-1-q)*L on (``geometry`` gives P, the padded
stream's K blocks and the sequence's bytes).  The source note in
``csrc/megaS.cu`` gives the kernel's design and bound; ``plan`` mirrors its
items and K blocks, ``turns`` counts its consumer warpgroups' groups of
``wgmma``, ``permuted_word_offset`` mirrors its digit layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops.kernels import _build
from herdsman_tpu_torch.utils import tracing

KB = 128      # K block: stream bytes a stage, digit row bytes
NT = 128      # ciphertexts of an item (wgmma N)
QI = 64       # output coefficients of an item (32 a consumer warpgroup)
KSLOT = 512   # bytes of one limb's key slice in a stage

# wrapper name -> whether its key is the extended one (P = N)
KERNELS = {"mega13": False, "mega14": True, "mega17": False, "mega15": False,
           "mega16": False}
# wrapper name -> the (bg_bits, levels) its C entry fixes
GADGET = {"mega14": (8, 2), "mega17": (8, 3), "mega15": (8, 4),
          "mega16": (8, 2)}


class Geometry(NamedTuple):
    """``P`` the column tile, ``NBc`` the 128-byte K blocks of one
    polynomial's stream padded to ``LNp`` = NBc*128 bytes, ``RB`` the bytes
    of one limb sequence (16-rounded L*(P-1) + LNp + 4: the last row's run
    and one word of slack for the shifted reads)."""
    P: int
    NBc: int
    LNp: int
    RB: int


def geometry(N: int, levels: int, extended: bool) -> Geometry:
    """``geometry`` of ``csrc/megaS.cu``."""
    P = N if extended else min(KB, N)
    NBc = -(-levels * N // KB)
    return Geometry(P, NBc, NBc * KB,
                    -(-(levels * (P - 1) + NBc * KB + 4) // 16) * 16)


def key_shape(p: TFHEParams, extended: bool = False) -> tuple[int, ...]:
    """[n, k+1 (c_in), k+1 (c_out), 4 (j), RB] of ``bsk_btS`` (``bsk_btTe``
    with ``extended``)."""
    kp1 = p.k + 1
    return (p.n, kp1, kp1, 4, geometry(p.N, p.levels, extended).RB)


H100_SMS = 132


class Plan(NamedTuple):
    """A step's work: ``items`` = ``tiles`` ciphertext tiles of 128 x (k+1)
    output polynomials x ``qblocks`` blocks of 64 coefficients, each over
    ``kt`` = (k+1)*NBc K blocks, cut into ``splits`` K splits: ``units`` =
    items * splits work units, walked by the blocks round robin."""
    tiles: int
    qblocks: int
    items: int
    kt: int
    splits: int
    units: int


def plan(p: TFHEParams, B: int, extended: bool = False,
         n_sms: int = H100_SMS) -> Plan:
    """The kernel's items, K blocks and K splits for a rotation of B
    ciphertexts on a card of ``n_sms`` SMs: K is split while the work units
    fit one wave of one block per SM, at most one K block a split
    (``plan_splits`` of the kernel)."""
    g = geometry(p.N, p.levels, extended)
    tiles = -(-B // NT)
    qblocks = max(1, p.N // QI)
    items = tiles * (p.k + 1) * qblocks
    kt = (p.k + 1) * g.NBc
    splits = max(1, min(kt, n_sms // items))
    return Plan(tiles, qblocks, items, kt, splits, items * splits)


def turns(p: TFHEParams, B: int, extended: bool = False,
          n_sms: int = H100_SMS) -> int:
    """The turns of a rotation of B ciphertexts on the tensor cores, each
    one consumer warpgroup's group of eight ``wgmma`` on one K block: per
    step every work unit's K blocks once for each consumer warpgroup that
    holds coefficients of its item (the second holds none where the column
    tile is 32 coefficients), n steps a rotation."""
    pl = plan(p, B, extended, n_sms)
    live = -(-min(QI, geometry(p.N, p.levels, extended).P) // 32)
    return p.n * pl.items * pl.kt * live


def split_range(kt: int, s: int, splits: int) -> tuple[int, int]:
    """The K blocks [e0, e1) of an item that split s of ``splits`` takes."""
    return s * kt // splits, (s + 1) * kt // splits


def scratch_bytes(p: TFHEParams, B: int, extended: bool = False) -> int:
    """Bytes of the digit scratch [k+1, NBc, B_pad, 128] for B ciphertexts."""
    g = geometry(p.N, p.levels, extended)
    return (p.k + 1) * g.NBc * plan(p, B, extended).tiles * NT * KB


def permuted_word_offset(w: int, b: int) -> int:
    """Byte offset, in ciphertext b's 128-byte digit row of a K block, of
    stream word w (its bytes 4w .. 4w+3): word 8t + 2kk + hf sits at K
    position 32kk + 16hf + 4t (so that lane t of a quad reads 32
    consecutive key bytes a K block), its 16-byte chunk 2kk + hf swizzled
    by b % 8 (``word_offset`` of the kernel)."""
    t, kk, hf = w >> 3, (w >> 1) & 3, w & 1
    return (((2 * kk + hf) ^ (b & 7)) << 4) | (t << 2)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/megaS.cu``) with its C signatures
    declared."""
    for name in KERNELS:
        fn = getattr(lib, f"{name}_blind_rotate")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * (
            4 if name in GADGET else 6) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.megaS_geometry.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.megaS_geometry.restype = ctypes.c_int
    lib.megaS_plan.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.megaS_plan.restype = ctypes.c_int
    lib.megaS_error_string.argtypes = [ctypes.c_int]
    lib.megaS_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``csrc/megaS.cu`` with its C signatures declared."""
    return declare(_build.load("megaS"))


def kernel_geometry(N: int, levels: int, extended: bool) -> Geometry:
    """``geometry`` as the built kernel computes it (the card tests hold it
    equal to the Python one)."""
    P, NBc, RB = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().megaS_geometry(int(extended), N, levels, ctypes.byref(P),
                                ctypes.byref(NBc), ctypes.byref(RB))
    if err:
        raise ValueError(f"megaS_geometry refused N={N}, levels={levels}")
    return Geometry(P.value, NBc.value, NBc.value * KB, RB.value)


def kernel_plan(p: TFHEParams, B: int, name: str,
                n_sms: int = H100_SMS) -> tuple[int, int]:
    """(work units, K splits) of kernel ``name``'s rotation of B
    ciphertexts as the built kernel plans it (the card tests hold it equal
    to ``plan``)."""
    units, splits = ctypes.c_int(), ctypes.c_int()
    err = _lib().megaS_plan(int(KERNELS[name]), B, p.N, p.k + 1, p.levels,
                            n_sms, ctypes.byref(units), ctypes.byref(splits))
    if err:
        raise ValueError(f"megaS_plan refused {name} at {p.name}, B={B}")
    return units.value, splits.value


def rotate_with(lib: ctypes.CDLL, name: str, p: TFHEParams,
                acc0: torch.Tensor, a_t: torch.Tensor,
                key: torch.Tensor) -> torch.Tensor:
    """One launch of kernel ``name`` of ``lib`` (a build of
    ``csrc/megaS.cu``) on CUDA tensors the wrapper has checked: the
    accumulators after the n steps.  Allocates the output, the digit scratch
    and the barrier counter, which the entry point sets up; raises if the
    launch fails."""
    if key.data_ptr() % 16:  # the bulk copies' alignment
        raise ValueError(f"{name}'s key must be 16-byte aligned")
    extended = KERNELS[name]
    B = acc0.shape[0]
    out = torch.empty_like(acc0)
    dig = torch.empty(scratch_bytes(p, B, extended), dtype=torch.int8,
                      device=acc0.device)
    bar = torch.empty(1, dtype=torch.int32, device=acc0.device)
    ptrs = (acc0.data_ptr(), a_t.data_ptr(), key.data_ptr(), out.data_ptr(),
            dig.data_ptr(), bar.data_ptr())
    gadget = () if name in GADGET else (p.bg_bits, p.levels)
    with torch.cuda.device(acc0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_blind_rotate")(
            *ptrs, B, p.n, p.N, p.k + 1, *gadget, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.megaS_error_string(err).decode())
    return out


def launch(name: str, p: TFHEParams, acc0: torch.Tensor, a_t: torch.Tensor,
           key: torch.Tensor) -> torch.Tensor:
    """One launch of kernel ``name`` (``mega13``, ``mega14``, ``mega17``,
    ``mega15`` or ``mega16``) of the built ``csrc/megaS.cu``
    (``rotate_with``), its ``turns`` counted in ``bootstrap.megaS_turns``."""
    out = rotate_with(_lib(), name, p, acc0, a_t, key)
    tracing.count(tracing.MEGAS_TURNS, turns(p, acc0.shape[0], KERNELS[name]))
    return out
