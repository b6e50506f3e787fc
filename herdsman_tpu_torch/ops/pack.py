"""LWE -> GLWE packing keyswitch on torch tensors — the port of
``herdsman_tpu.ops.pack`` (``core.reference.pack_lwes`` in bulk): the (j,
t)-summed negacyclic products are one int8-limb correlation, the bootstrap
engine ``conv_i8``'s with R = n*t rows (``bootstrap.conv_i8_correlate``), so
packed frames and downloads run at the card's rate instead of NumPy loops.

Array-equal to the reference and to the JAX package
(tests/test_torch_pack.py).  The digits are the UNSIGNED key-switch gadget
(values < 2^ks_base_bits), which must fit int8: every named set has
ks_base_bits <= 3.  All tensors are the int32 carrier of ``ops.u32``.
"""

from __future__ import annotations

import torch

from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.core.reference import PackingKey
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops import poly
from herdsman_tpu_torch.ops.decomp import unsigned_decompose
from herdsman_tpu_torch.ops.server_key import DeviceServerKey, conv_key_layout
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, resolve_device

I32 = torch.int32
I8 = torch.int8


def packing_key_conv(pk: PackingKey,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """The packing key in the correlation layout of ``conv_i8``, on
    ``device``: [n*t, (k+1)*4, 2N-1] int8, rows (j, t) (the construction of
    ``server_key.bsk_conv``)."""
    p = pk.params
    if p.ks_base_bits > 7:
        raise ValueError(f"unsigned key-switch digits of {p.ks_base_bits} "
                         f"bits do not fit int8 ({p.name})")
    rows = from_numpy_u32(pk.pksk, resolve_device(device))
    return conv_key_layout(rows.reshape(p.n * p.ks_levels, p.k + 1, p.N))


def pack_lwes_batch(params: TFHEParams, pkc: torch.Tensor,
                    cts: torch.Tensor) -> torch.Tensor:
    """Pack groups of LWE cts: [Gr, M <= N, n+1] -> [Gr, k+1, N].

    out_g = (0, sum_i b_i X^i) - sum_{j,t} D_{j,t}(X) (*) PKSK[j,t]
    (``core.reference.pack_lwes``); the double sum is one int8 correlation
    of the digits [Gr, n*t, N] against ``pkc``."""
    p = params
    Gr, M = cts.shape[0], cts.shape[1]
    if M > p.N:
        raise ValueError(f"at most N = {p.N} ciphertexts per group, not {M}")
    a = torch.zeros(Gr, p.n, p.N, dtype=I32, device=cts.device)
    a[:, :, :M] = cts[:, :, :p.n].transpose(1, 2)
    digits = unsigned_decompose(a, p.ks_base_bits, p.ks_levels)
    # [Gr, n, N, t] -> rows ordered (j, t), as pkc's
    d8 = digits.permute(0, 1, 3, 2).reshape(Gr, p.n * p.ks_levels, p.N)
    contrib = bs.conv_i8_correlate(d8.to(I8), pkc)       # [Gr, (k+1)*4, N]
    out = -poly.from_i32_limb_partials(
        contrib.reshape(Gr, p.k + 1, 4, p.N).permute(0, 1, 3, 2))
    out[:, p.k, :M] += cts[:, :, p.n]
    return out


def pack_lwe_rows(params: TFHEParams, pkc: torch.Tensor,
                  flat: torch.Tensor) -> torch.Tensor:
    """All the LWEs of a partition, [L, n+1], packed N to a group in one
    ``pack_lwes_batch`` call: [ceil(L / N), k+1, N].  The last group's
    missing cts are zeros, which add nothing: the JAX package packs that
    group with M < N and gets the same GLWE."""
    p = params
    G = -(-flat.shape[0] // p.N)
    if G == 0:
        return torch.zeros(0, p.k + 1, p.N, dtype=I32, device=flat.device)
    pad = G * p.N - flat.shape[0]
    if pad:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    return pack_lwes_batch(p, pkc, flat.reshape(G, p.N, p.n + 1))


def extract_all_batch(params: TFHEParams, glwes: torch.Tensor) -> torch.Tensor:
    """Sample-extract every coefficient of packed GLWEs: [Gr, k+1, N] ->
    [Gr, N, kN+1] (row i is the kN-LWE of coefficient i,
    ``core.reference.sample_extract``).  Row i's mask is a_out[j*N + m] =
    ext_j[(i - m) mod 2N], ext_j = concat(a_j, -a_j): one index gather."""
    p = params
    Gr = glwes.shape[0]
    ext = poly.negacyclic_extend(glwes[:, :p.k, :])     # [Gr, k, 2N]
    i = torch.arange(p.N, device=glwes.device)
    a_out = ext[..., (i[:, None] - i[None, :]) % (2 * p.N)]  # [Gr, k, i, m]
    a_out = a_out.permute(0, 2, 1, 3).reshape(Gr, p.N, p.kN)
    return torch.cat([a_out, glwes[:, p.k, :, None]], dim=-1)


def unpack_lwes_batch(dsk: DeviceServerKey, glwes: torch.Tensor,
                      count: int) -> torch.Tensor:
    """Invert ``pack_lwes_batch`` on the server: extract the first
    ``count`` coefficients of each packed GLWE and key-switch them back to
    the n-LWE key with the bootstrap KSK ([Gr, k+1, N] -> [Gr*count, n+1],
    group-major).  Noise: the original, plus the packing keyswitch, plus
    this keyswitch; the next gate bootstrap refreshes it."""
    p = dsk.params
    ext = extract_all_batch(p, glwes)[:, :count, :].reshape(-1, p.kN + 1)
    return bs.key_switch_batch(dsk, ext)
