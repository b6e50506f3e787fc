"""Batched TFHE gate bootstrapping on torch tensors: blind rotation (GINX /
CMux), sample extraction and key switching, exact mod 2^32 and bit-identical
to ``core.reference`` — the port of ``herdsman_tpu.ops.bootstrap``.

The blind rotation applies, for each of the n bootstrapping-key bits and to
the whole ciphertext batch at once,

    acc <- acc + BSK_i  (x)  (X^{a~_i} * acc - acc)

through one of three kinds of engine:

- ``ROTATION_ENGINES``: one call owns the whole n-step loop.  ``mega13`` (the
  default) is the hand-written CUDA kernel ``csrc/megaS.cu`` (int8 tensor
  cores, the key a register operand built from the compact stream key
  ``bsk_btS``) on a CUDA tensor and its plain PyTorch version on a CPU
  tensor; ``mega12`` (the integer tier's engine, the JAX package's
  ``pallas_mega12``) is ``csrc/mega12.cu`` on int8 tensor cores against
  ``bsk_btk`` (the JAX package's ``bsk_btjj`` in ``wgmma``'s byte order),
  and so are ``mega7``, ``mega5``, ``mega4``, ``mega6``, ``mega3``,
  ``mega2`` and ``mega`` (the same function; the JAX package's
  ``pallas_mega7``, ``pallas_mega5``, ``pallas_mega4``, ``pallas_mega6``
  and ``pallas_mega3`` read the same blocks with other columns,
  ``pallas_mega2`` and ``pallas_mega`` them R-major), and
  ``mega11``, ``mega8`` and the legacy ``mega10`` and ``mega9`` that
  source's doubled window against ``bsk_btk2`` (``bsk_btj2j`` in
  ``wgmma``'s order; the JAX package's ``pallas_mega8``, ``pallas_mega9``
  and ``pallas_mega10`` read the same window with columns (c, j, q),
  ``bsk_btj2``); ``mega16``, ``mega17`` and ``mega15`` (the JAX
  package's engines of the same names, at the byte-aligned gadget bg =
  2^8 with levels 2, 3 and 4) read the compact ``bsk_btTc`` key in
  ``csrc/megaS.cu`` (``mega13``'s kernel, each through its own entry), and
  ``mega14`` (levels 2, N >= 256) is ``csrc/megaS.cu``'s extended
  instantiation against ``bsk_btTe`` (one run per column tile).
- ``STEP_ENGINES``: one call per step, inside a Python loop over i, owns the
  whole CMux step.  ``bt_fused`` (the JAX package's ``pallas_fused``) is
  ``csrc/rotate_decompose.cu`` then ``csrc/bt_external_product.cu`` fused
  with the accumulate, against the ``bsk_bt`` key.
- ``ENGINES``: a per-step external product inside a Python loop over i,
  after a PyTorch rotate and decompose.  ``bt`` (the JAX package's
  ``pallas_bt``) is ``csrc/bt_external_product.cu`` unfused; ``conv_i8``
  (the JAX package's default engine, an XLA int8 convolution there) is the
  same correlation as one int8 product per step against the Toeplitz
  expansion of the compact ``bsk_conv`` key (``conv_i8_correlate``: a
  plain matrix product through ``torch._int_mm``, no hand-written kernel,
  on both devices); ``gather_u32`` is the gather-Toeplitz u32 product of
  the JAX package's engine of the same name (any device, slow; a second
  yardstick).

Every kernel wrapper takes its plain PyTorch version for a CPU tensor and
only then.  The per-step engines launch 2 kernels per step (n = 768 steps
at STD128_K2) from the Python loop and mask ragged batches in the kernels,
so no batch is padded.  A ``STEP_ENGINES`` rotation records its loop as
the host span ``bootstrap.step_issue`` (``B``, ``steps``) and counts the
device operations it issued one at a time (``STEP_LAUNCHES``: kernels,
and the set before a K-split product) in ``bootstrap.step_launches``.

All tensors are the int32 carrier of ``ops.u32``.
"""

from __future__ import annotations

import itertools
from typing import Callable

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import signed_decompose
from herdsman_tpu_torch.ops.kernels import bt, mega12, mega13, megaJ, megaT
from herdsman_tpu_torch.ops.kernels.rotate_decompose import rotate_decompose
from herdsman_tpu_torch.ops.server_key import DeviceServerKey, bt_tile
from herdsman_tpu_torch.ops.u32 import resolve_device, srl, to_device, u32_const
from herdsman_tpu_torch.utils import tracing

I32 = torch.int32
I8 = torch.int8

BOOL_MU = 1 << 29  # q/8


def _ep_gather_u32(p: TFHEParams, digits: torch.Tensor,
                   bsk_ext_i: torch.Tensor) -> torch.Tensor:
    """digits [B, R, N] int32, bsk_ext_i [R, k+1, 2N] -> [B, k+1, N]."""
    T = poly.negacyclic_toeplitz(bsk_ext_i[..., :p.N])  # [R, k+1, N, N]
    prod = digits[:, :, None, :, None] * T[None]        # [B, R, k+1, N, N]
    return prod.sum(dim=(1, 3), dtype=I32)


def _ep_bt(p: TFHEParams, digits: torch.Tensor,
           bsk_bt_i: torch.Tensor) -> torch.Tensor:
    """digits [B, R, N] int32, bsk_bt_i [R, HALF, P, (k+1)*4*P] int8 ->
    [B, k+1, N]: the digits in the kernel's row-tile-major int8 layout,
    then the unfused block-Toeplitz product."""
    P, HALF = bt_tile(p)
    B, R, _ = digits.shape
    d8 = digits.to(I8).reshape(B, R * HALF, P).transpose(0, 1).contiguous()
    return bt.external_product_bt(p, d8, bsk_bt_i)


# bytes of the Toeplitz expansion of the key that conv_i8_correlate builds
# at a time, and the most K rows of one int8 product whose int32 sum cannot
# overflow (|digit * key limb| <= 2^14), so that every partial sum is exact
# and only the int32 adds of the chunks wrap, mod 2^32 as XLA's accumulator
_CONV_CHUNK_BYTES = 1 << 28
_CONV_EXACT_ROWS = ((1 << 31) - 1) // (128 * 128)


def conv_i8_correlate(d8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The JAX package's int8 correlation ``lax.conv_general_dilated(d8, w,
    padding (N-1, N-1), ("NCH", "IOH", "NCH"))`` with int32 output, exact
    mod 2^32: d8 [B, R, N] int8, w [R, O, 2N-1] int8 -> [B, O, N] int32,

        out[b, o, x] = sum_r sum_m d8[b, r, m] * w[r, o, m - x + N - 1].

    One ``mega13.int8_matmul`` of the digits, reversed along m, [B, R*N]
    against the Toeplitz expansion of the key with its taps reversed,
    E[(r, N-1-m), (o, x)] = w[r, o, m + N-1-x] = rev(w)[r, o, (N-1-m) + x]
    [R*N, O*N] (``unfold`` of the reversed taps: runs of N contiguous
    bytes), stored K-major (column-major), which ``torch._int_mm`` reads
    about 5x faster on the card than a row-major one.  The expansion is
    built for a chunk of r at a time and never kept: each chunk stays under
    ``_CONV_CHUNK_BYTES`` and ``_CONV_EXACT_ROWS`` rows, and the chunks are
    summed in int32."""
    B, R, N = d8.shape
    O = w.shape[1]
    rc = max(1, min(_CONV_CHUNK_BYTES // (N * O * N), _CONV_EXACT_ROWS // N))
    out = None
    for r0 in range(0, R, rc):
        r1 = min(r0 + rc, R)
        E = w[r0:r1].flip(-1).unfold(-1, N, 1)       # [r, O, N(m'), N(x)]
        E = E.permute(1, 3, 0, 2).reshape(O * N, (r1 - r0) * N)
        d = d8[:, r0:r1].flip(-1).reshape(B, (r1 - r0) * N)
        part = mega13.int8_matmul(d, E.t())
        out = part if out is None else out + part
    return out.reshape(B, O, N)


def _ep_conv_i8(p: TFHEParams, digits: torch.Tensor,
                bsk_conv_i: torch.Tensor) -> torch.Tensor:
    """digits [B, R, N] int32 (|digit| <= Bg/2 <= 128), bsk_conv_i [R,
    (k+1)*4, 2N-1] int8 -> [B, k+1, N]: the limb partials of the
    correlation, recombined mod 2^32."""
    B = digits.shape[0]
    out = conv_i8_correlate(digits.to(I8), bsk_conv_i)    # [B, (k+1)*4, N]
    return poly.from_i32_limb_partials(
        out.reshape(B, p.k + 1, 4, p.N).permute(0, 1, 3, 2))


def _step_bt_fused(p: TFHEParams, acc: torch.Tensor, a_i: torch.Tensor,
                   bsk_bt_i: torch.Tensor) -> torch.Tensor:
    """Whole CMux step, two kernels: acc + BSK_i (x) (X^{a_i} acc - acc)."""
    d8 = rotate_decompose(p, acc, a_i)
    return bt.external_product_bt(p, d8, bsk_bt_i, glwe=acc)


def _step_bt_fused_launches(p: TFHEParams, B: int,
                            device: torch.device) -> int:
    """Device operations one ``_step_bt_fused`` issues at width B:
    ``rotate_decompose``'s kernel, then ``bt_external_product``'s with the
    set before it where K is split."""
    return 1 + bt.operations(p, B, device)


# engine name -> (fn(params, digits, bsk_i), key layout it reads)
ENGINES: dict[str, tuple[Callable, str]] = {
    "bt": (_ep_bt, "bsk_bt"),
    "conv_i8": (_ep_conv_i8, "bsk_conv"),
    "gather_u32": (_ep_gather_u32, "bsk_ext"),
}

# the per-step product engines whose partial products over a share of the
# key's GGSW rows sum to the step's product (``step_rotation``): a mesh's
# limb axis serves these.  ``bt``'s kernel contracts all R rows of a step
# (``ops/kernels/bt.py``), so it runs on a batch axis only.
LIMB_ENGINES = ("conv_i8", "gather_u32")

# engine name -> (fn(params, acc, a_i, bsk_i), key layout it reads): one
# call runs a whole CMux step
STEP_ENGINES: dict[str, tuple[Callable, str]] = {
    "bt_fused": (_step_bt_fused, "bsk_bt"),
}
# engine name -> fn(params, B, device): the device operations one step of
# a STEP_ENGINES engine issues at width B (``bootstrap.step_launches``)
STEP_LAUNCHES: dict[str, Callable] = {
    "bt_fused": _step_bt_fused_launches,
}

# engine name -> (fn(params, acc0, a_t, bsk), key layout it reads): one call
# runs the whole n-step rotation
ROTATION_ENGINES: dict[str, tuple[Callable, str]] = {
    "mega13": (mega13.mega13_blind_rotate, "bsk_btS"),
    "mega12": (mega12.mega12_blind_rotate, "bsk_btk"),
    "mega16": (megaT.mega16_blind_rotate, "bsk_btTc"),
    "mega17": (megaT.mega17_blind_rotate, "bsk_btTc"),
    "mega15": (megaT.mega15_blind_rotate, "bsk_btTc"),
    "mega14": (megaT.mega14_blind_rotate, "bsk_btTe"),
    "mega11": (megaJ.mega11_blind_rotate, "bsk_btk2"),
    "mega8": (megaJ.mega8_blind_rotate, "bsk_btk2"),
    "mega7": (megaJ.mega7_blind_rotate, "bsk_btk"),
    "mega9": (megaJ.mega9_blind_rotate, "bsk_btk2"),
    "mega6": (megaJ.mega6_blind_rotate, "bsk_btk"),
    "mega10": (megaJ.mega10_blind_rotate, "bsk_btk2"),
    "mega3": (megaJ.mega3_blind_rotate, "bsk_btk"),
    "mega4": (megaJ.mega4_blind_rotate, "bsk_btk"),
    "mega5": (megaJ.mega5_blind_rotate, "bsk_btk"),
    "mega": (megaJ.mega_blind_rotate, "bsk_btk"),
    "mega2": (megaJ.mega2_blind_rotate, "bsk_btk"),
}


def mod_switch_2N(p: TFHEParams, ct: torch.Tensor,
                  coarse_bits: int = 0) -> torch.Tensor:
    """Round LWE coords from q = 2^32 to 2N: [..., n+1] -> int32 in [0, 2N).

    ``coarse_bits`` = log2(k) rounds to multiples of k instead (the
    reduced-precision switch of many-LUT PBS)."""
    shift = 32 - (p.log2_2N + 1) + coarse_bits
    r = srl(ct, shift)
    idx = ((r + 1) >> 1) & ((p.two_N >> coarse_bits) - 1)
    return idx << coarse_bits


def make_test_poly(p: TFHEParams, mu: int = BOOL_MU,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """Constant test polynomial [N]: every coefficient mu (sign bootstrap)."""
    return torch.full((p.N,), u32_const(mu), dtype=I32, device=device)


def rotation_inputs(p: TFHEParams, ct: torch.Tensor, test_poly: torch.Tensor,
                    coarse_bits: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """What a rotation engine is given for ct [B, n+1]: the trivial GLWE
    acc0 = (0, X^{-b~} v) [B, k+1, N] and the switched mask a_t [n, B]."""
    B = ct.shape[0]
    tilde = mod_switch_2N(p, ct, coarse_bits)          # [B, n+1]
    b_t = tilde[:, p.n]
    body = poly.negacyclic_monomial_mul(
        test_poly.expand(B, p.N), (p.two_N - b_t) & (p.two_N - 1))
    acc0 = torch.cat([torch.zeros(B, p.k, p.N, dtype=I32, device=ct.device),
                      body[:, None, :]], dim=1)
    return acc0, tilde[:, :p.n].T.contiguous()


def blind_rotate_batch(dsk: DeviceServerKey, ct: torch.Tensor,
                       test_poly: torch.Tensor, engine: str = "mega13",
                       coarse_bits: int = 0) -> torch.Tensor:
    """GINX blind rotation of a batch: ct [B, n+1] -> acc [B, k+1, N],
    recorded as one ``bootstrap.rotation`` device span."""
    if dsk.limb_shards is not None and engine not in LIMB_ENGINES:
        raise ValueError(f"engine {engine!r} runs the whole key on one "
                         f"device; a key split over a limb axis serves "
                         f"{LIMB_ENGINES}")
    tracing.count("bootstrap.rotations")
    with tracing.span("bootstrap.rotation", device=ct.device,
                      B=ct.shape[0]):
        return _blind_rotate(dsk, ct, test_poly, engine, coarse_bits)


def _blind_rotate(dsk: DeviceServerKey, ct: torch.Tensor,
                  test_poly: torch.Tensor, engine: str,
                  coarse_bits: int) -> torch.Tensor:
    p = dsk.params
    acc0, a_t = rotation_inputs(p, ct, test_poly, coarse_bits)
    if engine in ROTATION_ENGINES:
        rot_fn, layout = ROTATION_ENGINES[engine]
        return rot_fn(p, acc0, a_t, _key(dsk, layout, engine))
    if engine in STEP_ENGINES:
        step_fn, layout = STEP_ENGINES[engine]
        bsk = _key(dsk, layout, engine)
        B = acc0.shape[0]
        acc = acc0
        with tracing.span(tracing.STEP_ISSUE, B=B, steps=p.n):
            for i in range(p.n):
                acc = step_fn(p, acc, a_t[i], bsk[i])
        tracing.count(tracing.STEP_LAUNCHES,
                      p.n * STEP_LAUNCHES[engine](p, B, acc0.device))
        return acc
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    ep, layout = ENGINES[engine]
    return step_rotation(p, ep, acc0, a_t, [
        _key(k, layout, engine) for k in dsk.limb_shards or (dsk,)])


def step_digits(p: TFHEParams, acc: torch.Tensor,
                a_i: torch.Tensor) -> torch.Tensor:
    """The signed digits of X^{a_i} acc - acc: [B, k+1, N] -> [B, R, N],
    row (j, level) of GLWE component j."""
    rot = poly.negacyclic_monomial_mul(acc, a_i[:, None])
    digits = signed_decompose(rot - acc, p.bg_bits, p.levels)
    return digits.permute(0, 1, 3, 2).reshape(acc.shape[0],
                                              (p.k + 1) * p.levels, p.N)


def step_rotation(p: TFHEParams, ep: Callable, acc: torch.Tensor,
                  a_t: torch.Tensor, shards: list[torch.Tensor]
                  ) -> torch.Tensor:
    """The n CMux steps of a per-step product engine ``ep`` of ``ENGINES``
    from acc0 [B, k+1, N] and a_t [n, B]: rotate, subtract and decompose in
    PyTorch, then ``ep``'s external product against step i of the key.

    ``shards`` is the key, ``[bsk]``, or its R GGSW rows split over the limb
    positions of a mesh line: ``shards[j]`` [n, R_j, ...] holds the next R_j
    rows on its position's device.  Every step, each shard gives the partial
    product of its rows of the digits, and the partials are summed exactly
    (int32 adds, which wrap mod 2^32) onto each device of the line.  Each
    distinct device holds its own copy of the accumulator, so positions that
    share a device share one."""
    devices = list(dict.fromkeys(s.device for s in shards))
    accs = [acc.to(d) for d in devices]
    a_ts = [a_t.to(d) for d in devices]
    home = [devices.index(s.device) for s in shards]
    ends = list(itertools.accumulate(s.shape[1] for s in shards))
    rows = [slice(r1 - s.shape[1], r1) for r1, s in zip(ends, shards)]
    for i in range(p.n):
        digits = [step_digits(p, x, a[i]) for x, a in zip(accs, a_ts)]
        parts = [ep(p, digits[h][:, r], s[i])
                 for h, r, s in zip(home, rows, shards)]
        for j, d in enumerate(devices):
            total = parts[0].to(d)
            for q in parts[1:]:
                total = total + q.to(d)
            accs[j] = accs[j] + total
    return accs[devices.index(acc.device)]


def _key(dsk: DeviceServerKey, layout: str, engine: str) -> torch.Tensor:
    key = getattr(dsk, layout)
    if key is None:
        raise ValueError(f"engine {engine!r} reads the {layout!r} key layout, "
                         f"which this DeviceServerKey was built without")
    return key


def sample_extract_batch(p: TFHEParams, acc: torch.Tensor,
                         offset: int = 0) -> torch.Tensor:
    """Extract coeff ``offset``: [B, k+1, N] -> LWE [B, kN+1].

    Coefficient j of a * s is sum_i a[(j - i) mod N] * s[i], with + for
    i <= j and - beyond (X^N = -1)."""
    rolled = torch.roll(acc[:, :p.k, :].flip(-1), offset + 1, dims=-1)
    keep = torch.arange(p.N, device=acc.device) <= offset
    a_out = torch.where(keep, rolled, -rolled).reshape(acc.shape[0], p.kN)
    return torch.cat([a_out, acc[:, p.k, offset:offset + 1]], dim=-1)


def key_switch_batch(dsk: DeviceServerKey, ct: torch.Tensor) -> torch.Tensor:
    """Switch extracted LWEs to the n-key: [B, kN+1] -> [B, n+1].

    One int8 product, balanced signed digits [B, kN*t] times the key's limbs
    [kN*t, (n+1)*4] through ``torch._int_mm`` (exact: kN*t*4*128 < 2^31),
    then the limb recombine; one ``bootstrap.key_switch`` device span."""
    p = dsk.params
    B = ct.shape[0]
    with tracing.span("bootstrap.key_switch", device=ct.device, B=B):
        digits = signed_decompose(ct[:, :p.kN], p.ks_base_bits,
                                  p.ks_levels)
        d8 = digits.reshape(B, p.kN * p.ks_levels).to(I8)
        part = mega13.int8_matmul(d8, dsk.ksk_limbs)[:, :(p.n + 1) * 4]
        contrib = poly.from_i32_limb_partials(part.reshape(B, p.n + 1, 4))
        out = -contrib
        out[:, p.n] += ct[:, p.kN]
    return out


def bootstrap_raw_batch(dsk: DeviceServerKey, ct: torch.Tensor,
                        test_poly: torch.Tensor,
                        engine: str = "mega13") -> torch.Tensor:
    """Blind rotate + extract (no key switch): [B, n+1] -> [B, kN+1]."""
    acc = blind_rotate_batch(dsk, ct, test_poly, engine=engine)
    return sample_extract_batch(dsk.params, acc)


def bootstrap_bool_batch(dsk: DeviceServerKey, ct, engine: str = "mega13",
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """Full sign bootstrap back to the n-LWE key: [B, n+1] -> [B, n+1].

    ``ct`` is a numpy uint32 array or an int32 carrier tensor; it is moved to
    ``device``, which must be the key's."""
    dev = dsk.check_device(resolve_device(device))
    ct = to_device(ct, dev)
    raw = bootstrap_raw_batch(dsk, ct, make_test_poly(dsk.params, device=dev),
                              engine=engine)
    return key_switch_batch(dsk, raw)
