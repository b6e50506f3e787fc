"""Device-resident evaluation key material, in the layouts the port consumes.

The host server key (any object with ``.params``, ``.bsk`` [n, R, k+1, N]
and ``.ksk`` [kN, ks_levels, n+1] as numpy uint32 — the port's
``core.reference.ServerKey`` or the JAX package's) is carried to the device
once, into:

- ``bsk``       int32 [n, R, k+1, N]   the raw bootstrapping key (R =
                                       (k+1)*levels GGSW rows), from which
                                       every other layout is built; kept on
                                       the device only when asked for.
- ``bsk_btS``   int8  [n, k+1, k+1, 4, RB]
                                       the compact stream key of ``mega13``
                                       (``csrc/megaS.cu``), any gadget with
                                       bg_bits <= 8: per (step, c_in, c_out,
                                       limb j) one L-fold interleaved limb
                                       sequence whose run from byte
                                       (P-1-q)*L is row (j, c_out, q) of a
                                       column tile of P = min(128, N)
                                       (``mega13.expand_rows``); RB =
                                       ``megaS.geometry(...).RB``.  At the
                                       byte-aligned gadget and N >= 128 it
                                       is ``bsk_btTc``.  34 MiB at
                                       STD128_K2, so the whole key stays
                                       resident in the H100's 50 MB L2.
- ``bsk_ext``   int32 [n, R, k+1, 2N]  ext(p) = concat(p, -p) of every key
                                       polynomial: the Toeplitz gather table
                                       of the ``gather_u32`` engine.
- ``bsk_bt``    int8  [n, R, HALF, P, (k+1)*4*P]
                                       the block-Toeplitz key of the JAX
                                       package's ``pallas_bt`` engines
                                       (``_block_toeplitz_layout``), read by
                                       ``csrc/bt_external_product.cu`` (the
                                       port's ``mega2`` and ``mega`` read
                                       ``bsk_btk``,
                                       ``mega12.kmajor_from_bt``):
                                       stored diagonal block m at (p, (c, j,
                                       q)) is limb j of ext(bsk[i, r, c])
                                       [(P*m + q - p) mod 2N].  It is
                                       n*R*(k+1)*4*N*P bytes, 3.375 GiB at
                                       STD128_K2, so it is built on the
                                       device in step chunks and only for an
                                       engine that reads it.
- ``bsk_btj``   int8  [n, HALF, R, P, (k+1)*4*P]
                                       the same blocks step-major by stored
                                       diagonal block (``j_major``), columns
                                       (c, j, q): the key of the JAX
                                       package's ``pallas_mega7``
                                       (``_block_toeplitz_layout_device(...,
                                       j_major=True)``) and of its
                                       ``pallas_mega6``, ``_mega5``,
                                       ``_mega4`` and ``_mega3``, held
                                       equal to the JAX package's (the
                                       port's engines of those names read
                                       ``bsk_btk``,
                                       ``mega12.kmajor_from_btj``).  As big
                                       as ``bsk_bt``, built the same way.
- ``bsk_btjj``  int8  [n, HALF, R, P, (k+1)*4*P]
                                       as ``bsk_btj`` with limb-major
                                       columns (j, c, q): the key of the JAX
                                       package's ``pallas_mega12``
                                       (``..., j_major=True,
                                       col_order="jcq"``), read by the plain
                                       j-major contraction and held equal to
                                       ``bsk_btk``.  As big as ``bsk_bt``:
                                       9.0 GiB at STD128_SHORTINT.
- ``bsk_btk``   int8  [n, HALF, R, k+1, 2, 256, 128]
                                       ``bsk_btjj``'s bytes in the order
                                       ``csrc/mega12.cu``'s ``wgmma`` reads
                                       them (``mega12.kmajor_order``): one
                                       32 KB tile per (step, stored block
                                       m, row r, polynomial c, q half), row
                                       64j + q' the 128 K bytes of column
                                       (j, c, q), K-major and 128-byte
                                       swizzled, so one bulk copy stages
                                       it.  The key of the ``mega12``,
                                       ``mega7``, ``mega5``, ``mega4``,
                                       ``mega6``, ``mega3``, ``mega2`` and
                                       ``mega`` engines (one kernel), as
                                       big as ``bsk_btjj``: 3.375 GiB at
                                       STD128_K2, 4.5 GiB at STD128.
- ``bsk_btj2``  int8  [n, 2*HALF, R, P, (k+1)*4*P]
- ``bsk_btj2j`` int8  [n, 2*HALF, R, P, (k+1)*4*P]
                                       the doubled window of the JAX
                                       package's ``pallas_mega8`` and
                                       ``pallas_mega11`` (``...,
                                       windowed=True``, col_order "cjq" and
                                       "jcq"): group g holds diagonal block
                                       (HALF-1-g) mod 2*HALF, the negated
                                       blocks taken from ext(p)[t+N] =
                                       -ext(p)[t], so column tile ct's whole
                                       contraction is groups [HALF-1-ct,
                                       2*HALF-1-ct).  ``bsk_btj2`` is the
                                       key of the JAX package's
                                       ``pallas_mega8``, ``_mega9`` and
                                       ``_mega10``; no port engine reads
                                       it (theirs read ``bsk_btk2``,
                                       ``mega12.kmajor_from_btj``);
                                       ``bsk_btj2j`` by the plain doubled
                                       contraction, held equal to
                                       ``bsk_btk2``.  Twice
                                       ``bsk_bt``: 6.75 GiB at STD128_K2,
                                       18.0 GiB at STD128_SHORTINT.
- ``bsk_btk2``  int8  [n, 2*HALF, R, k+1, 2, 256, 128]
                                       ``bsk_btj2j``'s bytes in ``wgmma``'s
                                       order (``mega12.kmajor_order``, as
                                       ``bsk_btk`` holds ``bsk_btjj``'s):
                                       the key of ``mega11``,
                                       ``mega10``, ``mega8`` and
                                       ``mega9``, ``csrc/mega12.cu``'s
                                       doubled window.  As big as
                                       ``bsk_btj2j``.
- ``bsk_btTc``  int8  [n, k+1, k+1, 4, row_bytes]
                                       the compact step key of the
                                       byte-aligned gadget (bg = 2^8, levels
                                       2, 3 or 4), read by ``mega16``,
                                       ``mega17`` and ``mega15``
                                       (``csrc/megaS.cu``):
                                       per (step, c_in, c_out, limb j) one
                                       L-fold interleaved limb sequence
                                       whose slice at (P-1-q)*L is row (j,
                                       c_out, q) of the JAX package's
                                       single-width ``bsk_btTs`` /
                                       ``bsk_btT3`` / ``bsk_btT4``
                                       (``ops/kernels/megaT.expand_key``).
                                       80 MB at STD128_SHORTINT_B8, where
                                       the expanded key is 9.0 GiB.
- ``bsk_btTe``  int8  [n, k+1, k+1, 4, row_bytes(p, extended=True)]
                                       the extended step key of ``mega14``
                                       (bg = 2^8, levels 2, N >= 256), read
                                       by ``csrc/megaS.cu``: the same limb
                                       sequences over the whole negacyclic
                                       period, L*(2N-1) bytes, so that every
                                       output column reads one unwrapped run
                                       (``ops/kernels/megaT.ext_tile_rows``
                                       is the JAX package's pt-major
                                       ``bsk_btT2`` window).  80 MB at
                                       STD128_K4, 101 MB at
                                       STD128_SHORTINT_FAST, where the JAX
                                       layout takes 17.25 GiB.
- ``bsk_conv``  int8  [n, R, (k+1)*4, 2N-1]
                                       the correlation key of the
                                       ``conv_i8`` engine (the JAX package's
                                       ``bsk_conv``): tap dx of output
                                       channel (c, j) is limb j of
                                       ext(bsk[i, r, c])[(N-1-dx) mod 2N]
                                       (``conv_key_layout``).  56.6 MB at
                                       STD128_K2; the engine expands one
                                       step of it at a time into the
                                       Toeplitz matrix of its product
                                       (``bootstrap.conv_i8_correlate``).
- ``ksk_limbs`` int8  [kN*t, C]        the key-switching key as balanced int8
                                       limbs for one ``torch._int_mm``;
                                       C = (n+1)*4 padded to a multiple of 8,
                                       which the CUDA int8 matmul requires;
                                       stored column-major (K-major), which
                                       ``torch._int_mm`` reads about 5x
                                       faster on the card.

``layouts_for_engine`` names the layout each engine reads, and
``fit_engine`` picks the engine a key fits on the card for (the port of
``herdsman_tpu/ops/server_key.py:594-699``).
"""

from __future__ import annotations

import dataclasses

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.kernels import mega12, mega13, megaJ, megaS, megaT
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, resolve_device

LAYOUTS = ("bsk", "bsk_btS", "bsk_ext", "bsk_bt", "bsk_btj", "bsk_btjj",
           "bsk_btk", "bsk_btj2", "bsk_btj2j", "bsk_btk2",
           "bsk_btTc", "bsk_btTe", "bsk_conv")
DEFAULT_LAYOUTS = ("bsk_btS",)  # the mega13 kernel and its plain version

# the layouts whose axis 1 is the GGSW row axis, split over a mesh's limb
# axis (``mesh.sharding.shard_server_key``); every other one is replicated
ROW_SHARDED = ("bsk_ext", "bsk_conv", "bsk_bt")

# the layout each engine of ops.bootstrap reads
ENGINE_LAYOUTS = {"mega13": "bsk_btS", "mega12": "bsk_btk", "bt": "bsk_bt",
                  "bt_fused": "bsk_bt", "gather_u32": "bsk_ext",
                  "conv_i8": "bsk_conv",
                  **megaT.KEY_LAYOUTS, **megaJ.KEY_LAYOUTS}

# device memory the key layouts of one session may take: half of an H100's
# 80 GB, leaving the rest to ciphertext batches and other sessions
KEY_BUDGET_BYTES = 40 * (1 << 30)

# working set of one chunk of the bsk_bt build
_BT_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class DeviceServerKey:
    params: TFHEParams
    device: torch.device
    ksk_limbs: torch.Tensor             # int8 [kN*ks_levels, ceil8((n+1)*4)]
    bsk: torch.Tensor | None = None     # int32 [n, R, k+1, N]
    bsk_btS: torch.Tensor | None = None  # int8 [n, k+1, k+1, 4, RB]
    bsk_ext: torch.Tensor | None = None  # int32 [n, R, k+1, 2N]
    bsk_bt: torch.Tensor | None = None  # int8 [n, R, HALF, P, (k+1)*4*P]
    bsk_btj: torch.Tensor | None = None  # int8 [n, HALF, R, P, (k+1)*4*P]
    bsk_btjj: torch.Tensor | None = None  # int8 [n, HALF, R, P, (k+1)*4*P]
    bsk_btk: torch.Tensor | None = None  # int8 [n, HALF, R, k+1, 2, 256, 128]
    bsk_btj2: torch.Tensor | None = None  # int8 [n, 2*HALF, R, P, (k+1)*4*P]
    bsk_btj2j: torch.Tensor | None = None  # int8 [n, 2*HALF, R, P, (k+1)*4*P]
    bsk_btk2: torch.Tensor | None = None  # int8 [n, 2*HALF, R, k+1, 2, 256,
    #                                       128]
    bsk_btTc: torch.Tensor | None = None  # int8 [n, k+1, k+1, 4, row_bytes]
    bsk_btTe: torch.Tensor | None = None  # int8 [n, k+1, k+1, 4, row_bytes]
    bsk_conv: torch.Tensor | None = None  # int8 [n, R, (k+1)*4, 2N-1]
    # set on the key of a mesh line whose limb axis splits the GGSW rows
    # (``mesh.sharding``): the keys of the line's positions, each holding
    # its share of the rows of ``ROW_SHARDED`` on its device; a per-step
    # product engine then sums their partial products
    # (``bootstrap.step_rotation``)
    limb_shards: tuple["DeviceServerKey", ...] | None = None

    @property
    def R(self) -> int:
        p = self.params
        return (p.k + 1) * p.levels

    def check_device(self, device: torch.device) -> torch.device:
        """``device`` if the key lives there; raise otherwise."""
        if device != self.device:
            raise ValueError(f"the server key is on {self.device}, "
                             f"not on {device}")
        return device


def bt_tile(params: TFHEParams) -> tuple[int, int]:
    """(P, HALF) of the block-Toeplitz tiling: P = min(128, N), HALF = N/P."""
    P = min(128, params.N)
    return P, params.N // P


def bt_key_bytes(p: TFHEParams) -> int:
    """Bytes of the ``bsk_bt`` layout at ``p`` (and of ``bsk_btj``,
    ``bsk_btjj`` and ``bsk_btk``; the doubled ``bsk_btj2``, ``bsk_btj2j``
    and ``bsk_btk2`` take twice as many)."""
    P, _ = bt_tile(p)
    return p.n * (p.k + 1) * p.levels * (p.k + 1) * 4 * p.N * P


def block_toeplitz_layout(p: TFHEParams, bsk: torch.Tensor,
                          j_major: bool = False, jcq: bool = False,
                          windowed: bool = False,
                          kmajor: bool = False) -> torch.Tensor:
    """``bsk_bt`` int8 [n, R, HALF, P, (k+1)*4*P] from the int32 ``bsk``
    [n, R, k+1, N], on ``bsk``'s device, a chunk of steps at a time: one
    gather of ext(bsk) and one limb split per chunk, so the working set
    stays near 256 MiB whatever the key's size.  Equal to the JAX package's
    ``_block_toeplitz_layout`` (tests/test_torch_bt.py).  Step-major by
    stored group ([n, groups, R, P, (k+1)*4*P]) with ``j_major``, ``jcq``
    or ``windowed``: the JAX ``_block_toeplitz_layout_device(...,
    j_major=True)``; ``jcq`` orders the columns (j, c, q) (``col_order=
    "jcq"``); ``windowed`` stores 2*HALF groups, group g diagonal block
    (HALF-1-g) mod 2*HALF (``windowed=True``); ``kmajor`` stores ``jcq``'s
    blocks as ``mega12``'s K-major swizzled key tiles (``bsk_btk`` [n,
    HALF, R, k+1, 2, 256, 128], ``mega12.kmajor_order``; with ``windowed``
    ``bsk_btk2``, the 2*HALF groups).  Blocks
    HALF..2*HALF-1 are the negated ones: ext(p)[t+N] = -ext(p)[t]
    (tests/test_torch_pbs.py, tests/test_torch_megaJ.py)."""
    n, R, kp1, N = bsk.shape
    P, HALF = bt_tile(p)
    M = 2 * HALF if windowed else HALF
    m = torch.arange(M, device=bsk.device)[:, None, None]
    if windowed:
        m = (HALF - 1 - m) % (2 * HALF)
    row = torch.arange(P, device=bsk.device)[None, :, None]
    q = torch.arange(P, device=bsk.device)[None, None, :]
    idx = (P * m + q - row) % (2 * N)                # [M, P(row), P(q)]
    jcq = jcq or kmajor
    step_major = j_major or jcq or windowed
    shape = (M, R) if step_major else (R, M)
    out = torch.empty(n, *shape, *((kp1, P // mega12.QH, mega12.BN, P)
                                   if kmajor else (P, kp1 * 4 * P)),
                      dtype=torch.int8, device=bsk.device)
    # limbs [c, R, k+1, M, P(row), P(q), 4] -> (R, M, row, c, j, q), or
    # step-major (M, R, row, c, j, q), or limb-major (M, R, row, j, c, q)
    if not step_major:
        order = (0, 1, 3, 4, 2, 6, 5)
    else:
        order = (0, 3, 1, 4, 6, 2, 5) if jcq else (0, 3, 1, 4, 2, 6, 5)
    step = max(1, _BT_CHUNK_BYTES // (R * kp1 * M * P * P * 4 * 8))
    for i0 in range(0, n, step):
        i1 = min(i0 + step, n)
        blocks = poly.negacyclic_extend(bsk[i0:i1])[..., idx]
        limbs = poly.to_i8_limbs(blocks)  # [c, R, k+1, M, P, P, 4]
        chunk = limbs.permute(*order).reshape(i1 - i0, *shape, P,
                                              kp1 * 4 * P)
        if kmajor:
            chunk = mega12.kmajor_order(chunk, kp1)
        out[i0:i1] = chunk
    return out


def stream_key_layout(p: TFHEParams, bsk: torch.Tensor,
                      extended: bool = False,
                      any_gadget: bool = False) -> torch.Tensor:
    """``bsk_btTc`` int8 [n, k+1 (c_in), k+1 (c_out), 4 (j), row_bytes]
    from the int32 ``bsk`` [n, R, k+1, N] at the byte-aligned gadget, on
    ``bsk``'s device, a chunk of steps at a time: T[L*u + lb] =
    limb_j(ext(bsk[i, c_in*levels + levels-1-lb, c_out])[(P-1-u) mod 2N])
    for u < N+P-1 (P = 128), zeros after.  Its expansion equals the JAX
    package's ``_btTs/_btT3/_btT4_layout_device`` (tests/test_torch_megaT.py).
    With ``extended``, ``bsk_btTe``: the same with P = N, Te[L*v + lb] =
    limb_j(ext(...)[(N-1-v) mod 2N]) for v < 2N-1, whose tiles equal the
    JAX package's ``bsk_btT2`` windows (tests/test_torch_mega14.py).  With
    ``any_gadget``, ``bsk_btS``: the same with P = min(128, N) at any gadget
    with bg_bits <= 8 and levels 1-4, RB bytes a sequence
    (``megaS.geometry``), whose rows are the block-Toeplitz key's
    (tests/test_torch_megaS.py)."""
    name = ("bsk_btS" if any_gadget else "bsk_btTe" if extended
            else "bsk_btTc")
    L = p.levels
    if any_gadget:
        mega13.check_params(p)
        P, _, _, RB = megaS.geometry(p.N, L, False)
    else:
        if p.bg_bits != 8 or not 2 <= L <= 4 or p.N % megaT.P:
            raise ValueError(f"{name} needs bg_bits 8, levels 2-4 and N a "
                             f"multiple of {megaT.P}, not {p.bg_bits}, "
                             f"{L} and {p.N} ({p.name})")
        P, RB = (p.N if extended else megaT.P), megaT.row_bytes(p, extended)
    n, R, kp1, N = bsk.shape
    U = N + P - 1
    idx = (P - 1 - torch.arange(U, device=bsk.device)) % (2 * N)
    out = torch.zeros(n, kp1, kp1, 4, RB, dtype=torch.int8, device=bsk.device)
    step = max(1, _BT_CHUNK_BYTES // (R * kp1 * U * 4 * 2))
    for i0 in range(0, n, step):
        i1 = min(i0 + step, n)
        limbs = poly.to_i8_limbs(poly.negacyclic_extend(bsk[i0:i1])[..., idx])
        # [c, R = (c_in, level), c_out, U, j]; byte lb is level L-1-lb
        limbs = limbs.reshape(i1 - i0, kp1, L, kp1, U, 4).flip(2)
        out[i0:i1, ..., :L * U] = limbs.permute(0, 1, 3, 5, 4, 2).reshape(
            i1 - i0, kp1, kp1, 4, U * L)
    return out


def conv_key_layout(rows: torch.Tensor) -> torch.Tensor:
    """The correlation key of ``conv_i8`` from int32 polynomials [..., k+1,
    N]: int8 [..., (k+1)*4, 2N-1], tap dx of channel (c, j) limb j of
    ext(rows[..., c, :])[(N-1-dx) mod 2N] — the JAX package's ``bsk_conv``
    (``server_key.py:134-145``) and ``ops/pack.packing_key_conv``.  Built on
    ``rows``' device, a chunk of the leading axis at a time."""
    *lead, kp1, N = rows.shape
    rows = rows.reshape(-1, kp1, N)
    idx = (N - 1 - torch.arange(2 * N - 1, device=rows.device)) % (2 * N)
    out = torch.empty(rows.shape[0], kp1, 4, 2 * N - 1, dtype=torch.int8,
                      device=rows.device)
    step = max(1, _BT_CHUNK_BYTES // (kp1 * 2 * N * 4 * 8))
    for i0 in range(0, rows.shape[0], step):
        limbs = poly.to_i8_limbs(
            poly.negacyclic_extend(rows[i0:i0 + step])[..., idx])
        out[i0:i0 + step] = limbs.transpose(-1, -2)  # [.., k+1, 4, 2N-1]
    return out.reshape(*lead, kp1 * 4, 2 * N - 1)


def layouts_for_engine(engine: str) -> tuple[str, ...]:
    """Key layout(s) ``device_server_key`` must build for ``engine``."""
    if engine not in ENGINE_LAYOUTS:
        raise ValueError(f"unknown engine {engine!r}; known: "
                         f"{sorted(ENGINE_LAYOUTS)}")
    return (ENGINE_LAYOUTS[engine],)


def fit_engine(engine: str, params: TFHEParams,
               budget_bytes: int = KEY_BUDGET_BYTES) -> str:
    """The engine that serves ``params`` on the card, starting from
    ``engine`` (the port of ``herdsman_tpu/ops/server_key.py:623-699``,
    with the port's budget):

    - ``bt``, ``bt_fused``, and ``mega12`` / ``mega7`` / ``mega6`` /
      ``mega3`` / ``mega4`` / ``mega5`` / ``mega`` / ``mega2``, whose
      kernel must also take the set, while their single-width key
      (``bsk_bt``, ``bsk_btk``: the same size, as is the JAX package's
      ``bsk_btj``) fits ``budget_bytes``; else ``mega13`` (the JAX package
      keeps ``pallas_mega3`` .. ``_6``, ``pallas_mega`` and ``_mega2`` at
      every set; their keys fit the budget at every named set, and the
      port's engines of those names, ``mega12``'s kernel since they read
      ``bsk_btk``, take every named set with N >= 128);
    - ``mega11`` / ``mega10`` / ``mega8`` / ``mega9`` while their doubled
      key (``bsk_btk2``, the size of the JAX package's ``bsk_btj2``)
      fits and their kernel takes the set (the JAX package's doubled-key check,
      ``server_key.py:694-699``); else whatever a ``mega12`` request
      gets;
    - ``mega14`` where the set has bg_bits 8, levels 2 and N >= 256 and its
      extended ``bsk_btTe`` key fits (the JAX package's ``btT_bytes``
      check, ``pallas_mega14`` beside ``pallas_mega13``); else whatever a
      ``mega16`` request gets;
    - ``mega16`` / ``mega17`` / ``mega15`` where the set has their own
      byte-aligned gadget (bg_bits 8 and levels 2 / 3 / 4) and their
      compact ``bsk_btTc`` key fits; else ``mega11`` where its doubled key
      fits and its kernel takes the set; else whatever a ``mega12`` request
      gets;
    - ``mega13`` where its kernel takes the set, else ``bt_fused``;
    - ``gather_u32`` and ``conv_i8`` (PyTorch products, any set) as they
      are, as the JAX package passes ``conv_i8`` through.

    The coordinator and the integer tier build every key through this, so
    none of them can run the card out of memory at key ingest.

    Two routes differ from the JAX package's, with equal outputs:

    - ``mega13`` stays ``mega13`` wherever its kernel takes the set; the
      port's ``mega13`` reads the compact ``bsk_btS`` (51 MiB at
      STD128_SHORTINT_FAST).
      The JAX package's ``pallas_mega13`` reads the extended pt-major key
      and is kept only at the sets with the bg = 2^8, l = 2 gadget and N >=
      256 (STD128_FAST, STD128_K2, STD128_K4, STD128_SHORTINT_FAST) where
      it fits: at the port's 40 GiB budget it sends every other set
      (STD128, STD128_SHORTINT, _B8, _L4, TEST_PBS, TEST_SMALL, TOY) to
      ``pallas_mega11``, and at its own 12 GiB default also
      STD128_SHORTINT_FAST (17.25 GiB) to ``pallas_mega16``
      (tests/test_torch_megaJ.py pins both, set by set).
    - The block-Toeplitz kernels of the port tile N by 128 columns, so at a
      set with N < 128 (TOY) a request for any of them (``mega12``,
      ``mega7``, ``mega8``, ``mega11``, the legacy ``mega3`` .. ``mega10``,
      ``mega`` and ``mega2``), and a byte-aligned one that would fall back
      to them, goes to ``mega13``, where the JAX package (which tiles by
      min(128, N)) keeps the block-Toeplitz engine."""

    def takes(check) -> bool:
        try:
            check(params)
        except ValueError:
            return False
        return True

    bt_fits = bt_key_bytes(params) <= budget_bytes
    route = engine
    if route in megaT.EXTENDED:
        if (takes(lambda p: megaT.check_params(p, route))
                and megaT.key_bytes(params, extended=True) <= budget_bytes):
            return route
        route = "mega16"
    if route in megaT.KERNELS:
        if (takes(lambda p: megaT.check_params(p, route))
                and megaT.key_bytes(params) <= budget_bytes):
            return route
        route = "mega11"
    if route in ("mega11", "mega8", "mega9", "mega10"):
        if (2 * bt_key_bytes(params) <= budget_bytes
                and takes(lambda p: megaJ.check_params(p, route))):
            return route
        route = "mega12"
    if route in ("bt", "bt_fused", "mega12", "mega7", "mega6", "mega3",
                 "mega4", "mega5", "mega", "mega2"):
        if bt_fits and (route in ("bt", "bt_fused")
                        or takes(mega12.check_params if route == "mega12"
                                 else lambda p: megaJ.check_params(p, route))):
            return route
        if takes(mega13.check_params):
            return "mega13"
    elif route == "mega13":
        if takes(mega13.check_params):
            return route
        if bt_fits:
            return "bt_fused"
    elif route in ("gather_u32", "conv_i8"):
        return route
    else:
        layouts_for_engine(route)  # raises for an unknown engine
    raise ValueError(f"no engine of the port serves {params.name} from "
                     f"{engine!r} within {budget_bytes} bytes of key")


def device_server_key(sk, layouts: tuple[str, ...] = DEFAULT_LAYOUTS,
                      device: str | torch.device = "cuda") -> DeviceServerKey:
    """Carry a host server key to ``device`` in the layouts named."""
    dev = resolve_device(device)
    unknown = set(layouts) - set(LAYOUTS)
    if unknown:
        raise ValueError(f"unknown key layouts {sorted(unknown)}; "
                         f"known: {LAYOUTS}")
    # the port's own TFHEParams, whichever package's key this is
    p = TFHEParams(**{f.name: getattr(sk.params, f.name)
                      for f in dataclasses.fields(TFHEParams)})
    R = (p.k + 1) * p.levels
    if tuple(sk.bsk.shape) != (p.n, R, p.k + 1, p.N):
        raise ValueError(f"bsk shape {sk.bsk.shape} != "
                         f"{(p.n, R, p.k + 1, p.N)} for {p.name}")
    if tuple(sk.ksk.shape) != (p.kN, p.ks_levels, p.n + 1):
        raise ValueError(f"ksk shape {sk.ksk.shape} != "
                         f"{(p.kN, p.ks_levels, p.n + 1)} for {p.name}")

    bsk = from_numpy_u32(sk.bsk, dev)
    ksk = from_numpy_u32(sk.ksk, dev)
    cols = (p.n + 1) * 4
    ksk_limbs = poly.to_i8_limbs(ksk).reshape(p.kN * p.ks_levels, cols)
    ksk_limbs = torch.nn.functional.pad(ksk_limbs, (0, (-cols) % 8))
    # stored K-major: torch._int_mm reads a column-major B about 5x faster
    ksk_limbs = ksk_limbs.t().contiguous().t()
    return DeviceServerKey(
        params=p,
        device=dev,
        ksk_limbs=ksk_limbs,
        bsk=bsk if "bsk" in layouts else None,
        bsk_btS=(stream_key_layout(p, bsk, any_gadget=True)
                 if "bsk_btS" in layouts else None),
        bsk_ext=(poly.negacyclic_extend(bsk).contiguous()
                 if "bsk_ext" in layouts else None),
        bsk_bt=(block_toeplitz_layout(p, bsk)
                if "bsk_bt" in layouts else None),
        bsk_btj=(block_toeplitz_layout(p, bsk, j_major=True)
                 if "bsk_btj" in layouts else None),
        bsk_btjj=(block_toeplitz_layout(p, bsk, jcq=True)
                  if "bsk_btjj" in layouts else None),
        bsk_btk=(block_toeplitz_layout(p, bsk, kmajor=True)
                 if "bsk_btk" in layouts else None),
        bsk_btj2=(block_toeplitz_layout(p, bsk, windowed=True)
                  if "bsk_btj2" in layouts else None),
        bsk_btj2j=(block_toeplitz_layout(p, bsk, jcq=True, windowed=True)
                   if "bsk_btj2j" in layouts else None),
        bsk_btk2=(block_toeplitz_layout(p, bsk, windowed=True, kmajor=True)
                  if "bsk_btk2" in layouts else None),
        bsk_btTc=(stream_key_layout(p, bsk)
                  if "bsk_btTc" in layouts else None),
        bsk_btTe=(stream_key_layout(p, bsk, extended=True)
                  if "bsk_btTe" in layouts else None),
        bsk_conv=(conv_key_layout(bsk) if "bsk_conv" in layouts else None),
    )
