"""Encrypted short integers over programmable bootstrapping (tfhe-rs
"shortint" analog) — the port of ``herdsman_tpu.shortint``.

Unlike `api.EncUint` (bitwise boolean circuits), an `EncShort` holds each
small integer in ONE LWE ciphertext with the padding-bit encoding of
`ops.pbs`: linear homomorphisms (add, scalar mul) are free LWE arithmetic,
and any unary function — including the modular reduction that keeps sums in
range — is one programmable bootstrap. Values are vectorized (a batch per
object) and live on the key's device as int32 carriers (``ops.u32``), whose
adds and products wrap mod 2^32 like the JAX package's uint32.

Carry discipline: values live in a working space of `space_bits` =
msg_bits + carry_bits; each ciphertext tracks its maximum possible plaintext
(`max_val`). Linear ops accumulate until the space would overflow, then a
PBS with the mod-LUT folds back. Ciphertext-by-ciphertext multiplication
packs both operands into one phase (x * m + y) and applies the bivariate
product LUT in a single bootstrap (requires space_bits >= 2 * msg_bits).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.mesh.sharding import (pbs_batch_sharded,
                                              pbs_many_batch_sharded,
                                              shard_server_key)
from herdsman_tpu_torch.ops import pbs
from herdsman_tpu_torch.ops.server_key import (DeviceServerKey,
                                               device_server_key, fit_engine,
                                               layouts_for_engine)
from herdsman_tpu_torch.ops.u32 import (from_numpy_u32, resolve_device,
                                        to_numpy_u32)


class ShortContext:
    def __init__(self, params: TFHEParams, msg_bits: int = 2,
                 carry_bits: int = 2, engine: str = "mega12",
                 seed: int = 0, keys=None, dsk=None,
                 many_lut: bool | None = None, mesh=None,
                 device: str | torch.device = "cuda"):
        if params.bool_only:
            raise ValueError(
                f"{params.name} is a bool-gate-only parameter set: its "
                "noise budget does not support shortint slot encodings "
                "(hardware-measured decrypt failure, docs/BENCH_LOG.md "
                "round 4); use std128_shortint instead")
        self.device = resolve_device(device)
        self.params = params
        self.msg_bits = msg_bits
        self.carry_bits = carry_bits
        self.space_bits = msg_bits + carry_bits  # working precision
        # many-LUT PBS: k LUTs per blind rotation where the rounding window
        # stays safe (auto-on when N leaves >= 32 fine indices per message
        # at k = 2; e.g. STD128_SHORTINT yes, TEST_PBS no)
        if many_lut is None:
            many_lut = pbs.many_lut_capacity(params, self.space_bits) >= 2
        self.many_lut = many_lut
        # Packed-input LUTs (x*m + y) never share a rotation (radix.py's
        # digit products run their low and high LUTs as two rotations): the
        # x*m noise scaling and many-LUT's reduced-precision mod switch are
        # BOTH margin penalties, and stacked they take the packed input to
        # ~3 sigma at STD128_SHORTINT (measured on hardware as ~1e-4
        # failures in chained radix multiplies).  Unary many-LUT paths
        # (carry splits, bit extraction) keep their slack and stay enabled.
        # tfhe-rs max_noise_level analog: a fresh x-operand packed as
        # x*m + y contributes level modulus, plus a fresh y -> modulus + 1
        self.max_noise = self.modulus + 1
        # each slot needs enough blind-rotation indices to absorb the
        # mod-switch rounding noise (~sqrt(n)/2 indices): require >= 16
        if 2 * params.N < (1 << (self.space_bits + 1)) * 16:
            raise ValueError("message+carry space too large for N (need "
                             "2N >= 16*2^(space+1))")
        self.engine = engine
        # blind-rotation work meter: per-ciphertext rotations issued
        # through this context (a many-LUT call is ONE rotation per input),
        # counted at the _pbs/_pbs_many chokepoints
        self.rotations = 0
        self._rng = np.random.default_rng(seed)
        if keys is None:
            self.ck, self.sk = ref.keygen(params, self._rng)
        else:
            self.ck, self.sk = keys
        if dsk is not None:
            self.dsk: DeviceServerKey = dsk
            self.dsk.check_device(self.device)
        else:
            self.engine = engine = fit_engine(engine, params)
            self.dsk = device_server_key(
                self.sk, layouts=layouts_for_engine(engine),
                device=self.device)
        # every PBS batch split over all positions of the mesh
        # (mesh.pbs_batch_sharded), bit-identical to one device; the whole
        # shortint and radix front end rides it.  The key is placed once.
        self.mesh = mesh
        self._mesh_key = (None if mesh is None
                          else shard_server_key(self.dsk, mesh))

    @property
    def modulus(self) -> int:
        return 1 << self.msg_bits

    @property
    def space(self) -> int:
        return 1 << self.space_bits

    def encrypt(self, values) -> "EncShort":
        vals = np.atleast_1d(np.asarray(values)) % self.modulus
        mu = pbs.encode(self.params, vals, self.space_bits)
        ct = ref.lwe_encrypt_raw(self.ck, mu, self._rng)
        return EncShort(self, from_numpy_u32(ct, self.device),
                        max_val=self.modulus - 1)

    def trivial(self, values, batch: int | None = None) -> "EncShort":
        """Trivial (noiseless, keyless) encryption of cleartext values —
        the tfhe-rs `trivial_encrypt` analog: mask = 0, body = encode(v).
        Decryptable by anyone; used for server-side constants and scalar
        comparisons.  `batch` broadcasts a python int to a batch."""
        vals = np.atleast_1d(np.asarray(values)) % self.modulus
        if batch is not None and vals.shape[0] == 1:
            vals = np.broadcast_to(vals, (batch,))
        mu = pbs.encode(self.params, vals, self.space_bits)
        ct = np.zeros((vals.shape[0], self.params.n + 1), dtype=np.uint32)
        ct[:, -1] = mu
        return EncShort(self, from_numpy_u32(ct, self.device),
                        max_val=self.modulus - 1, noise_level=0)

    def decrypt(self, x: "EncShort") -> list[int]:
        x = x.reduce() if x.max_val >= self.modulus else x
        phase = ref.lwe_phase(self.ck.lwe_key, to_numpy_u32(x.data))
        vals = pbs.decode(self.params, phase, self.space_bits)
        return [int(v) % self.modulus for v in vals]

    def _pbs(self, data: torch.Tensor, table) -> torch.Tensor:
        self.rotations += int(data.shape[0])
        if self.mesh is not None:
            return pbs_batch_sharded(self._mesh_key, self.mesh, data, table,
                                     self.space_bits, engine=self.engine)
        return pbs.pbs_batch(self.dsk, data, table, self.space_bits,
                             engine=self.engine, device=self.device)

    def _pbs_many(self, data: torch.Tensor, tables) -> list[torch.Tensor]:
        """k LUTs over the same batch: ONE blind rotation when many-LUT is
        enabled (k a power of two within capacity), else k rotations."""
        k = len(tables)
        if (self.many_lut and k > 1 and k & (k - 1) == 0
                and k <= pbs.many_lut_capacity(self.params, self.space_bits)):
            self.rotations += int(data.shape[0])
            if self.mesh is not None:
                return pbs_many_batch_sharded(
                    self._mesh_key, self.mesh, data, tables,
                    self.space_bits, engine=self.engine)
            return pbs.pbs_many_batch(self.dsk, data, tables,
                                      self.space_bits, engine=self.engine,
                                      device=self.device)
        return [self._pbs(data, t) for t in tables]


@dataclasses.dataclass
class EncShort:
    ctx: ShortContext
    data: torch.Tensor     # [B, n+1] int32 carrier
    max_val: int           # maximum possible plaintext in the working space
    noise_level: int = 1   # tfhe-rs NoiseLevel analog: 1 = fresh PBS/encrypt
    # output; linear sums add levels, scalar muls scale them. Packed
    # bivariate LUTs (x*m + y) scale x's noise by m, so packing requires
    # fresh operands — enforced at the pack sites via `reduce()`, which
    # refreshes noise to level 1.

    def reduce(self) -> "EncShort":
        """Fold back to [0, modulus): one PBS with the mod-LUT."""
        ctx = self.ctx
        table = [m % ctx.modulus for m in range(ctx.space)]
        return EncShort(ctx, ctx._pbs(self.data, table),
                        max_val=ctx.modulus - 1)

    def __add__(self, o: "EncShort") -> "EncShort":
        a, b = self, o
        mn = a.ctx.max_noise
        if a.max_val + b.max_val >= a.ctx.space or \
                a.noise_level + b.noise_level > mn:
            a = a.reduce()
            if a.max_val + b.max_val >= a.ctx.space or \
                    a.noise_level + b.noise_level > mn:
                b = b.reduce()
        return EncShort(a.ctx, a.data + b.data, a.max_val + b.max_val,
                        a.noise_level + b.noise_level)

    def scalar_mul(self, k: int) -> "EncShort":
        if k < 0:
            raise ValueError("scalar_mul takes k >= 0")
        if k == 0:
            return EncShort(self.ctx, torch.zeros_like(self.data), 0)
        x = self
        if x.max_val * k >= x.ctx.space or \
                x.noise_level * k > x.ctx.max_noise:
            x = x.reduce()
        if x.max_val * k >= x.ctx.space:
            raise ValueError("scalar too large for the space")
        return EncShort(x.ctx, x.data * k, x.max_val * k, x.noise_level * k)

    def apply_lut(self, fn) -> "EncShort":
        """Evaluate an arbitrary unary function f over [0, space) (the
        caller sees reduced values: f receives v mod modulus)."""
        ctx = self.ctx
        x = self if self.max_val < ctx.modulus else self.reduce()
        table = [fn(v % ctx.modulus) % ctx.modulus for v in range(ctx.space)]
        return EncShort(ctx, ctx._pbs(x.data, table),
                        max_val=ctx.modulus - 1)

    def __mul__(self, o: "EncShort") -> "EncShort":
        """Ciphertext product in ONE bootstrap: pack t = x*m + y (fits the
        carry space when space_bits >= 2*msg_bits) and apply the bivariate
        LUT table[t] = (t>>msg) * (t & (m-1)) mod m."""
        ctx = self.ctx
        if ctx.space_bits < 2 * ctx.msg_bits:
            raise ValueError("need carry_bits >= msg_bits for packed "
                             "multiplication")
        m = ctx.modulus
        # packing scales a's noise by m: both operands must be fresh
        a = self if (self.max_val < m and self.noise_level * m +
                     1 <= ctx.max_noise) else self.reduce()
        b = o if (o.max_val < m and a.noise_level * m +
                  o.noise_level <= ctx.max_noise) else o.reduce()
        packed = a.data * m + b.data
        table = [((t >> ctx.msg_bits) * (t & (m - 1))) % m
                 for t in range(ctx.space)]
        return EncShort(ctx, ctx._pbs(packed, table), max_val=m - 1)
