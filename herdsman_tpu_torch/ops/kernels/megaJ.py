"""Whole-rotation blind-rotation kernels of the JAX package's j-major
family and legacy schedules, all against the K-major tensor-core keys of
``csrc/mega12.cu``, and their plain PyTorch versions.

The eleven kernels compute the GINX rotation of ``mega12`` at any gadget
(bg_bits <= 8, any levels) and keep the contract of the JAX package's
wrappers they replace.  Every wrapper is ``csrc/mega12.cu``'s (int8
``wgmma``), each counted apart: seven its single window on ``mega12``'s
key ``bsk_btk``, four (``mega11``, ``mega10``, ``mega8``, ``mega9``) its
doubled window on ``bsk_btk2``:

- ``mega11_blind_rotate``: ``herdsman_tpu/ops/pallas/mega.py::
  _mega11_kernel``, the doubled window: ``csrc/mega12.cu``'s doubled
  instantiation on ``bsk_btk2``, the JAX package's ``bsk_btj2j``
  (limb-major columns (j, c, q)) in ``wgmma``'s byte order
  (``mega12.kmajor_order``);
- ``mega10_blind_rotate``, ``mega8_blind_rotate`` and
  ``mega9_blind_rotate``: ``legacy.py::_mega10_kernel`` (digits built by a
  pass fused across the k+1 polynomials), ``mega.py::_mega8_kernel`` (the
  serial schedule) and ``legacy.py::_mega9_kernel`` (a producer of one
  half's digits beside the contraction of the other's), all on the doubled
  window ``bsk_btj2`` with columns (c, j, q): ``mega11``'s function, so
  ``csrc/mega12.cu``'s doubled instantiation on ``bsk_btk2`` too
  (``mega12.kmajor_from_btj`` re-lays the JAX package's ``bsk_btj2``;
  int8 ``wgmma`` cannot read its column order);
- ``mega7_blind_rotate``: ``mega.py::_mega7_kernel``, the single width:
  ``mega12``'s function, so ``csrc/mega12.cu``'s single instantiation on
  ``bsk_btk`` (the JAX package's ``bsk_btj`` is the same blocks with
  columns (c, j, q), an order int8 ``wgmma`` cannot read);
- ``mega5_blind_rotate``, ``mega4_blind_rotate``, ``mega6_blind_rotate``,
  ``mega3_blind_rotate``, ``mega2_blind_rotate`` and
  ``mega_blind_rotate``: ``herdsman_tpu/ops/pallas/legacy.py::
  _mega5_kernel`` (a wide block on ``bsk_btj``), ``_mega4_kernel`` (each
  step's key block fetched once per group of chunks, ``bsk_btj``),
  ``_mega6_kernel`` (a staggered fetch stream, ``bsk_btj``),
  ``_mega3_kernel`` (all R rows accumulated in the matrix unit,
  ``bsk_btj``), ``_mega2_kernel`` (an inline step on the R-major
  ``bsk_bt``) and ``_mega_kernel`` (row-phased, ``bsk_bt``): ``mega7``'s
  function, so ``csrc/mega12.cu``'s single instantiation on ``bsk_btk``
  too (``mega12.kmajor_from_btj`` and ``kmajor_from_bt`` re-lay the JAX
  package's keys).

acc0 [B, k+1, N] and a_t [n, B] in [0, 2N) in (int32 carriers), the
accumulator after the n CMux steps out, exact mod 2^32.  A doubled key
[n, 2*HALF, R, P, (k+1)*4*P] holds, at group g, diagonal block (HALF-1-g)
mod 2*HALF, the blocks past HALF negated, so column tile ct's whole
contraction is one product of the step's digits (sub ascending, r minor)
with groups [HALF-1-ct, 2*HALF-1-ct) (``mega.py:542-547``).  The
single-width key contracts the negated run apart and subtracts it
(``_ep_column_total_jmajor_packed``), as ``mega12`` does.  The plain
version of the single window's wrappers is
``mega12.blind_rotate_plain_btk``, that of the doubled window's
``blind_rotate_plain_btk2`` (the doubled window's contraction on the key
taken back to j-major order).

On a CUDA tensor each wrapper launches its kernel (one launch per
rotation, counted in its ``launches``) or raises; on a CPU tensor it runs
its plain version (``plain``).  The source note in ``csrc/mega12.cu``
gives the kernel's design and bound.
"""

from __future__ import annotations

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.kernels import mega12
from herdsman_tpu_torch.ops.kernels.mega12 import (P, check_args,
                                                   from_kmajor_order,
                                                   pack_digits, recombine)
from herdsman_tpu_torch.ops.kernels.mega13 import int8_matmul

# kernel -> whether it reads csrc/mega12.cu's doubled window (bsk_btk2) or
# its single one (bsk_btk)
KERNELS = {"mega11": True, "mega8": True, "mega7": False, "mega9": True,
           "mega6": False, "mega10": True, "mega3": False, "mega4": False,
           "mega5": False, "mega": False, "mega2": False}
KEY_LAYOUTS = {name: "bsk_btk2" if doubled else "bsk_btk"
               for name, doubled in KERNELS.items()}


def check_params(p: TFHEParams, name: str) -> None:
    """Raise on a parameter set kernel ``name`` does not take: ``mega12``'s
    geometry, all that ``csrc/mega12.cu``'s windows need (their digits and
    accumulators live in device memory)."""
    mega12.check_params(p, name)


def key_shape(p: TFHEParams, name: str) -> tuple[int, ...]:
    """The shape of kernel ``name``'s key at ``p``: the K-major [n, groups,
    R, k+1, 2, 256, 128] of ``csrc/mega12.cu`` (groups 2*HALF for the
    doubled window, else HALF)."""
    return mega12.key_shape(p, KERNELS[name])


def _check_args(p: TFHEParams, name: str, acc0: torch.Tensor,
                a_t: torch.Tensor, key: torch.Tensor) -> None:
    check_args(p, acc0, a_t, key, KEY_LAYOUTS[name],
               key_shape=key_shape(p, name))


def _window_step(p: TFHEParams, acc: torch.Tensor, a_i: torch.Tensor,
                 window: torch.Tensor, jcq: bool) -> torch.Tensor:
    """One CMux step against one step's doubled window [2*HALF, R, P,
    (k+1)*4*P]: rotate, decompose and pack the digits sub ascending
    (``pack_digits``); per column tile ct one ``torch._int_mm`` of all the
    digits with the groups [HALF-1-ct, 2*HALF-1-ct) (``mega.py:542-547``,
    ``:341-345``); then the recombine of the key's column order ((j, c, q)
    with ``jcq``) into the accumulator."""
    B, kp1, N = acc.shape
    HALF = N // P
    R = kp1 * p.levels
    rot = poly.negacyclic_monomial_mul(acc, a_i[:, None])
    D = pack_digits(p, rot - acc, descending=False)
    window = window.reshape(2 * HALF * R * P, kp1 * 4 * P)
    tiles = []
    for ct in range(HALF):
        o = (HALF - 1 - ct) * R * P
        total = int8_matmul(D, window[o:o + HALF * R * P])
        tiles.append(recombine(total, kp1, jcq))  # [B, k+1, P]
    return acc + torch.cat(tiles, dim=-1)


def blind_rotate_plain_btj2(params: TFHEParams, acc0: torch.Tensor,
                            a_t: torch.Tensor, key: torch.Tensor,
                            jcq: bool) -> torch.Tensor:
    """The doubled window's rotation in plain PyTorch, either device, on
    the JAX package's ``bsk_btj2j`` (``jcq``: the TPU's ``mega11``) or
    ``bsk_btj2`` (its ``mega8``, ``mega9`` and ``mega10``) [n, 2*HALF, R,
    P, (k+1)*4*P]: ``_window_step`` n times."""
    p = params
    check_args(p, acc0, a_t, key, "bsk_btj2j" if jcq else "bsk_btj2",
               key_shape=(p.n, 2 * (p.N // P), (p.k + 1) * p.levels, P,
                          (p.k + 1) * 4 * P))
    acc = acc0
    for i in range(p.n):
        acc = _window_step(p, acc, a_t[i], key[i], jcq)
    return acc


def blind_rotate_plain_btk2(params: TFHEParams, acc0: torch.Tensor,
                            a_t: torch.Tensor,
                            bsk_btk2: torch.Tensor) -> torch.Tensor:
    """The rotation of ``mega11``, ``mega10``, ``mega8`` and ``mega9`` in
    plain PyTorch, either device, reading the same ``bsk_btk2``:
    ``blind_rotate_plain_btj2``'s steps, each on its step key taken back
    to ``bsk_btj2j``'s order (``from_kmajor_order``)."""
    p = params
    _check_args(p, "mega11", acc0, a_t, bsk_btk2)
    acc = acc0
    for i in range(p.n):
        acc = _window_step(p, acc, a_t[i], from_kmajor_order(bsk_btk2[i]),
                           True)
    return acc


def plain(name: str):
    """The plain version of kernel ``name``: fn(params, acc0, a_t, key)
    (the single window's wrappers share ``mega12``'s, the doubled
    window's ``blind_rotate_plain_btk2``)."""
    return (blind_rotate_plain_btk2 if KERNELS[name]
            else mega12.blind_rotate_plain_btk)


def _rotate(name: str, wrapper, p: TFHEParams, acc0: torch.Tensor,
            a_t: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    check_params(p, name)
    _check_args(p, name, acc0, a_t, key)
    if acc0.device.type == "cpu":
        return plain(name)(p, acc0, a_t, key)
    if acc0.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {acc0.device}")
    if key.data_ptr() % 16:  # the bulk copies' alignment
        raise ValueError(f"{name} takes a key on a 16-byte boundary")
    return mega12.launch(p, acc0, a_t, key, KERNELS[name], wrapper)


def mega11_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btk2: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation against the doubled limb-major window: acc0
    [B, k+1, N] and a_t [n, B] (int32 carriers), bsk_btk2 int8 [n, 2*HALF,
    R, k+1, 2, 256, 128] -> acc [B, k+1, N].  CUDA tensors go through
    ``csrc/mega12.cu``'s doubled instantiation, CPU tensors through
    ``blind_rotate_plain_btk2``."""
    return _rotate("mega11", mega11_blind_rotate, params, acc0, a_t,
                   bsk_btk2)


def mega8_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk2: torch.Tensor) -> torch.Tensor:
    """``mega11``'s rotation (the TPU's serial schedule on ``bsk_btj2``)
    against the doubled window ``bsk_btk2`` int8 [n, 2*HALF, R, k+1, 2,
    256, 128]: ``csrc/mega12.cu``'s doubled instantiation, counted here;
    CPU tensors go through ``blind_rotate_plain_btk2``."""
    return _rotate("mega8", mega8_blind_rotate, params, acc0, a_t, bsk_btk2)


def mega7_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk: torch.Tensor) -> torch.Tensor:
    """Whole blind rotation against the single window ``bsk_btk`` int8 [n,
    HALF, R, k+1, 2, 256, 128] (two runs, the negated one subtracted):
    ``csrc/mega12.cu``'s single instantiation, counted here; CPU tensors
    go through ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega7", mega7_blind_rotate, params, acc0, a_t, bsk_btk)


def mega9_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk2: torch.Tensor) -> torch.Tensor:
    """``mega11``'s rotation (the TPU's digit producer beside the
    contraction on ``bsk_btj2``) against the doubled window ``bsk_btk2``
    int8 [n, 2*HALF, R, k+1, 2, 256, 128]: ``csrc/mega12.cu``'s doubled
    instantiation, counted here; CPU tensors go through
    ``blind_rotate_plain_btk2``."""
    return _rotate("mega9", mega9_blind_rotate, params, acc0, a_t, bsk_btk2)


def mega6_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk: torch.Tensor) -> torch.Tensor:
    """``mega7``'s rotation (the TPU's staggered fetch stream on
    ``bsk_btj``) against the single window ``bsk_btk`` int8 [n, HALF, R,
    k+1, 2, 256, 128] (two runs, the negated one subtracted):
    ``csrc/mega12.cu``'s single instantiation, counted here; CPU tensors go
    through ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega6", mega6_blind_rotate, params, acc0, a_t, bsk_btk)


def mega10_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                        a_t: torch.Tensor,
                        bsk_btk2: torch.Tensor) -> torch.Tensor:
    """``mega8``'s rotation (the TPU's poly-fused digit pass on
    ``bsk_btj2``) against the doubled window ``bsk_btk2`` int8 [n, 2*HALF,
    R, k+1, 2, 256, 128]: ``csrc/mega12.cu``'s doubled instantiation,
    counted here; CPU tensors go through ``blind_rotate_plain_btk2``."""
    return _rotate("mega10", mega10_blind_rotate, params, acc0, a_t,
                   bsk_btk2)


def mega3_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk: torch.Tensor) -> torch.Tensor:
    """``mega7``'s rotation (the TPU's R rows accumulated in the matrix unit
    on ``bsk_btj``) against the single window ``bsk_btk`` int8 [n, HALF, R,
    k+1, 2, 256, 128] (two runs, the negated one subtracted):
    ``csrc/mega12.cu``'s single instantiation, counted here; CPU tensors go
    through ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega3", mega3_blind_rotate, params, acc0, a_t, bsk_btk)


def mega4_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk: torch.Tensor) -> torch.Tensor:
    """``mega7``'s rotation (the TPU's grouped chunks on ``bsk_btj``)
    against the single window ``bsk_btk`` int8 [n, HALF, R, k+1, 2, 256,
    128] (two runs, the negated one subtracted): ``csrc/mega12.cu``'s single
    instantiation, counted here; CPU tensors go through
    ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega4", mega4_blind_rotate, params, acc0, a_t, bsk_btk)


def mega5_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk: torch.Tensor) -> torch.Tensor:
    """``mega7``'s rotation (the TPU's wide block on ``bsk_btj``) against
    the single window ``bsk_btk`` int8 [n, HALF, R, k+1, 2, 256, 128] (two
    runs, the negated one subtracted): ``csrc/mega12.cu``'s single
    instantiation, counted here; CPU tensors go through
    ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega5", mega5_blind_rotate, params, acc0, a_t, bsk_btk)


def mega_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                      a_t: torch.Tensor,
                      bsk_btk: torch.Tensor) -> torch.Tensor:
    """``mega7``'s rotation (the TPU's row phases on the R-major
    ``bsk_bt``) against the single window ``bsk_btk`` int8 [n, HALF, R, k+1,
    2, 256, 128] (two runs, the negated one subtracted): ``csrc/mega12.cu``'s
    single instantiation, counted here; CPU tensors go through
    ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega", mega_blind_rotate, params, acc0, a_t, bsk_btk)


def mega2_blind_rotate(params: TFHEParams, acc0: torch.Tensor,
                       a_t: torch.Tensor,
                       bsk_btk: torch.Tensor) -> torch.Tensor:
    """``mega``'s rotation (the TPU's inline step on the R-major
    ``bsk_bt``) against the single window ``bsk_btk`` int8 [n, HALF, R, k+1,
    2, 256, 128] (two runs, the negated one subtracted):
    ``csrc/mega12.cu``'s single instantiation, counted here; CPU tensors go
    through ``mega12.blind_rotate_plain_btk``."""
    return _rotate("mega2", mega2_blind_rotate, params, acc0, a_t, bsk_btk)


mega11_blind_rotate.launches = 0
mega8_blind_rotate.launches = 0
mega7_blind_rotate.launches = 0
mega9_blind_rotate.launches = 0
mega6_blind_rotate.launches = 0
mega10_blind_rotate.launches = 0
mega3_blind_rotate.launches = 0
mega4_blind_rotate.launches = 0
mega5_blind_rotate.launches = 0
mega_blind_rotate.launches = 0
mega2_blind_rotate.launches = 0
