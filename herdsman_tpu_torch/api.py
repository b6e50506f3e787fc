"""Eager encrypted-integer API — the ergonomic front end; the port of
``herdsman_tpu.api``.

Where `circuit/` builds static circuits for the coordinator's Map/Reduce
plans, this module gives client-style eager computation on encrypted
integers (tfhe-rs "FheUint" ergonomics): every operator call immediately
executes batched gate bootstraps on the key's device (the card unless the
caller passes ``device="cpu"``).  Values are vectorized: one
`EncUint` holds a whole batch of encrypted integers, and a ripple-carry add
over a batch of 1000 u8s runs the same number of device programs as over
one (each bit level is ONE batched bootstrap).  Bit ciphertexts are int32
carriers (``ops.u32``).

Example:
    ctx = HerdContext(STD128, engine="bt_fused")
    a = ctx.encrypt([3, 200, 17], width=8)
    b = ctx.encrypt([5, 100, 4], width=8)
    assert ctx.decrypt(a + b) == [8, 44, 21]
    assert ctx.decrypt(a.min(b)) == [3, 100, 4]
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops import gates
from herdsman_tpu_torch.ops.server_key import (device_server_key, fit_engine,
                                               layouts_for_engine)
from herdsman_tpu_torch.ops.u32 import (from_numpy_u32, resolve_device,
                                        to_numpy_u32, u32_const)


class HerdContext:
    def __init__(self, params: TFHEParams, engine: str = "mega13",
                 seed: int = 0, keys=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = params
        self._rng = np.random.default_rng(seed)
        if keys is None:
            self.ck, self.sk = ref.keygen(params, self._rng)
        else:
            self.ck, self.sk = keys
        self.engine = engine = fit_engine(engine, params)
        self.dsk = device_server_key(self.sk,
                                     layouts=layouts_for_engine(engine),
                                     device=self.device)

    # ---- client ops ----

    def encrypt(self, values: Sequence[int] | int, width: int = 8) -> "EncUint":
        vals = np.atleast_1d(np.asarray(values, dtype=np.int64))
        bits = np.zeros((len(vals), width), dtype=bool)
        for i in range(width):
            bits[:, i] = (vals >> i) & 1
        ct = ref.encrypt_bool(self.ck, bits, self._rng)  # [B, width, n+1]
        return EncUint(self, from_numpy_u32(ct, self.device), width)

    def encrypt_bits(self, values: Sequence[bool]) -> "EncBit":
        bits = np.asarray(values, dtype=bool)
        ct = ref.encrypt_bool(self.ck, bits, self._rng)
        return EncBit(self, from_numpy_u32(ct, self.device))

    def decrypt(self, x: "EncUint | EncBit") -> list:
        if isinstance(x, EncBit):
            return [bool(v) for v in
                    ref.lwe_decrypt_bool(self.ck, to_numpy_u32(x.data))]
        bits = ref.lwe_decrypt_bool(self.ck, to_numpy_u32(x.data))
        vals = np.zeros(bits.shape[0], dtype=np.int64)
        for i in range(x.width):
            vals |= bits[:, i].astype(np.int64) << i
        return [int(v) for v in vals]

    # ---- eager gate plumbing ----

    def _gate(self, name: str, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
        """One heterogeneous-batch gate call on stacked bit ciphertexts
        [..., n+1] (leading dims flattened into the batch).  The JAX package
        pads the flat batch to a power of two so that jit reuses its
        programs; the port runs eagerly and its kernels mask ragged
        batches, so it does not pad (each gate's output is the same)."""
        shape = a.shape[:-1]
        width = a.shape[-1]
        flat_a = a.reshape(-1, width)
        flat_b = b.reshape(-1, width)
        ids = torch.full((flat_a.shape[0],), gates.GATE_IDS[name],
                         dtype=torch.int32, device=self.device)
        out = gates.gate_batch(
            self.dsk, gates.GateBatch(ids, flat_a, flat_b),
            engine=self.engine, device=self.device)
        return out.reshape(*shape, width)

    def _mux(self, sel, a, b):
        shape = a.shape[:-1]
        width = a.shape[-1]
        out = gates.mux_batch(
            self.dsk, sel.reshape(-1, width), a.reshape(-1, width),
            b.reshape(-1, width), engine=self.engine, device=self.device)
        return out.reshape(*shape, width)

    def _const_bit(self, batch: int, value: bool) -> torch.Tensor:
        mu = int(bs.BOOL_MU) if value else ((1 << 32) - int(bs.BOOL_MU))
        ct = torch.zeros(batch, self.params.n + 1, dtype=torch.int32,
                         device=self.device)
        ct[:, self.params.n] = u32_const(mu)
        return ct


@dataclasses.dataclass
class EncBit:
    ctx: HerdContext
    data: torch.Tensor  # [B, n+1] int32 carrier

    def _g(self, name, other):
        return EncBit(self.ctx, self.ctx._gate(name, self.data, other.data))

    def __and__(self, o): return self._g("AND", o)
    def __or__(self, o): return self._g("OR", o)
    def __xor__(self, o): return self._g("XOR", o)
    def __invert__(self):
        return EncBit(self.ctx, gates.gate_not(self.data))

    def mux(self, a: "EncUint", b: "EncUint") -> "EncUint":
        """self ? a : b (bitwise over words)."""
        sel = self.data[:, None, :].expand(a.data.shape)
        return EncUint(self.ctx, self.ctx._mux(sel, a.data, b.data), a.width)

    def mux_bit(self, a: "EncBit", b: "EncBit") -> "EncBit":
        """self ? a : b on single bits."""
        out = self.ctx._mux(self.data[:, None, :], a.data[:, None, :],
                            b.data[:, None, :])
        return EncBit(self.ctx, out[:, 0, :])


@dataclasses.dataclass
class EncUint:
    ctx: HerdContext
    data: torch.Tensor  # [B, width, n+1] int32 carrier
    width: int

    @property
    def batch(self) -> int:
        return self.data.shape[0]

    def _bit(self, i: int) -> torch.Tensor:
        return self.data[:, i, :]

    def __xor__(self, o): return EncUint(
        self.ctx, self.ctx._gate("XOR", self.data, o.data), self.width)

    def __and__(self, o): return EncUint(
        self.ctx, self.ctx._gate("AND", self.data, o.data), self.width)

    def __or__(self, o): return EncUint(
        self.ctx, self.ctx._gate("OR", self.data, o.data), self.width)

    def __invert__(self):
        return EncUint(self.ctx, gates.gate_not(self.data), self.width)

    def _ripple(self, other: "EncUint", subtract: bool,
                want_carry: bool = False):
        ctx = self.ctx
        y = (~other).data if subtract else other.data
        carry = ctx._const_bit(self.batch, subtract)
        out_bits = []
        for i in range(self.width):
            x = self._bit(i)
            yb = y[:, i, :]
            s = ctx._gate("XOR", x[:, None, :], yb[:, None, :])[:, 0, :]
            out_bits.append(
                ctx._gate("XOR", s[:, None, :], carry[:, None, :])[:, 0, :]
            )
            if i + 1 < self.width or want_carry:
                xy = ctx._gate("AND", x[:, None, :], yb[:, None, :])[:, 0, :]
                sc = ctx._gate("AND", s[:, None, :], carry[:, None, :])[:, 0, :]
                carry = ctx._gate("OR", xy[:, None, :], sc[:, None, :])[:, 0, :]
        word = EncUint(ctx, torch.stack(out_bits, dim=1), self.width)
        if want_carry:
            return word, EncBit(ctx, carry)
        return word

    def __add__(self, o: "EncUint") -> "EncUint":
        return self._ripple(o, subtract=False)

    def __sub__(self, o: "EncUint") -> "EncUint":
        return self._ripple(o, subtract=True)

    def __mul__(self, o: "EncUint") -> "EncUint":
        """Shift-and-add multiply, mod 2^width."""
        ctx = self.ctx
        w = self.width
        acc = None
        for i in range(w):
            yb = o._bit(i)[:, None, :].expand(
                self.batch, w - i, self.ctx.params.n + 1)
            masked = ctx._gate("AND", self.data[:, : w - i, :], yb)
            zeros = torch.stack(
                [ctx._const_bit(self.batch, False)] * i, dim=1
            ) if i else masked[:, :0, :]
            partial = EncUint(ctx, torch.cat([zeros, masked], dim=1), w)
            acc = partial if acc is None else acc + partial
        return acc

    def eq(self, o: "EncUint") -> EncBit:
        ctx = self.ctx
        x = ctx._gate("XNOR", self.data, o.data)  # [B, w, n+1]
        acc = x[:, 0, :]
        for i in range(1, self.width):
            acc = ctx._gate("AND", acc[:, None, :], x[:, i:i + 1, :])[:, 0, :]
        return EncBit(ctx, acc)

    def lt(self, o: "EncUint") -> EncBit:
        """Unsigned less-than (MSB-down ripple)."""
        ctx = self.ctx
        lt = None
        eq = None
        for i in reversed(range(self.width)):
            x = self._bit(i)[:, None, :]
            y = o._bit(i)[:, None, :]
            nx = gates.gate_not(x)
            bit_lt = ctx._gate("AND", nx, y)[:, 0, :]
            bit_eq = ctx._gate("XNOR", x, y)[:, 0, :]
            if lt is None:
                lt, eq = bit_lt, bit_eq
            else:
                t = ctx._gate("AND", eq[:, None, :],
                              bit_lt[:, None, :])[:, 0, :]
                lt = ctx._gate("OR", lt[:, None, :], t[:, None, :])[:, 0, :]
                eq = ctx._gate("AND", eq[:, None, :],
                               bit_eq[:, None, :])[:, 0, :]
        return EncBit(ctx, lt)

    def min(self, o: "EncUint") -> "EncUint":
        return self.lt(o).mux(self, o)

    def max(self, o: "EncUint") -> "EncUint":
        return self.lt(o).mux(o, self)

    # ---- comparisons (derived) ----

    def ne(self, o: "EncUint") -> EncBit:
        return ~self.eq(o)

    def le(self, o: "EncUint") -> EncBit:
        return ~o.lt(self)

    def gt(self, o: "EncUint") -> EncBit:
        return o.lt(self)

    def ge(self, o: "EncUint") -> EncBit:
        return ~self.lt(o)

    def lt_signed(self, o: "EncUint") -> EncBit:
        """Two's-complement less-than: if the sign bits differ the negative
        operand is smaller, else compare as unsigned."""
        ctx = self.ctx
        sa = EncBit(ctx, self._bit(self.width - 1))
        sb = EncBit(ctx, o._bit(self.width - 1))
        return (sa ^ sb).mux_bit(sa, self.lt(o))

    def le_signed(self, o: "EncUint") -> EncBit:
        return ~o.lt_signed(self)

    def gt_signed(self, o: "EncUint") -> EncBit:
        return o.lt_signed(self)

    def ge_signed(self, o: "EncUint") -> EncBit:
        return ~self.lt_signed(o)

    # ---- shifts / rotations ----

    def _const_bits(self, count: int, value: bool = False) -> torch.Tensor:
        ctx = self.ctx
        if count == 0:
            return self.data[:, :0, :]
        return torch.stack(
            [ctx._const_bit(self.batch, value)] * count, dim=1
        )

    def __lshift__(self, k: int) -> "EncUint":
        """Shift left by a cleartext constant (free: wire relabeling)."""
        if k < 0:
            raise ValueError("shift by a negative amount")
        k = min(k, self.width)
        data = torch.cat(
            [self._const_bits(k), self.data[:, : self.width - k, :]], dim=1
        )
        return EncUint(self.ctx, data, self.width)

    def __rshift__(self, k: int) -> "EncUint":
        """Logical right shift by a cleartext constant."""
        if k < 0:
            raise ValueError("shift by a negative amount")
        k = min(k, self.width)
        data = torch.cat(
            [self.data[:, k:, :], self._const_bits(k)], dim=1
        )
        return EncUint(self.ctx, data, self.width)

    def shift_right_arith(self, k: int) -> "EncUint":
        if k < 0:
            raise ValueError("shift by a negative amount")
        k = min(k, self.width)
        sign = self.data[:, self.width - 1: self.width, :]
        pad = sign.expand(self.batch, k, self.data.shape[-1])
        data = torch.cat([self.data[:, k:, :], pad], dim=1)
        return EncUint(self.ctx, data, self.width)

    def rotl(self, k: int) -> "EncUint":
        k %= self.width
        if not k:
            return self
        data = torch.cat(
            [self.data[:, -k:, :], self.data[:, :-k, :]], dim=1
        )
        return EncUint(self.ctx, data, self.width)

    def rotr(self, k: int) -> "EncUint":
        return self.rotl(self.width - (k % self.width))

    def shift_left_enc(self, amount: "EncUint") -> "EncUint":
        """Shift left by an ENCRYPTED amount (barrel shifter; amounts >=
        width yield 0)."""
        cur = self
        zero = EncUint(self.ctx, self._const_bits(self.width), self.width)
        for j in range(amount.width):
            sel = EncBit(self.ctx, amount._bit(j))
            shifted = zero if (1 << j) >= self.width else cur << (1 << j)
            cur = sel.mux(shifted, cur)
        return cur

    def shift_right_enc(self, amount: "EncUint") -> "EncUint":
        """Logical right shift by an ENCRYPTED amount (barrel shifter)."""
        cur = self
        zero = EncUint(self.ctx, self._const_bits(self.width), self.width)
        for j in range(amount.width):
            sel = EncBit(self.ctx, amount._bit(j))
            shifted = zero if (1 << j) >= self.width else cur >> (1 << j)
            cur = sel.mux(shifted, cur)
        return cur

    # ---- arithmetic extensions ----

    def neg(self) -> "EncUint":
        zero = EncUint(self.ctx, self._const_bits(self.width), self.width)
        return zero - self

    def abs_signed(self) -> "EncUint":
        sign = EncBit(self.ctx, self._bit(self.width - 1))
        return sign.mux(self.neg(), self)

    def divmod(self, o: "EncUint") -> tuple["EncUint", "EncUint"]:
        """Unsigned restoring division -> (quotient, remainder).

        Division by zero yields quotient 2^width - 1 and remainder = self
        (the natural output of the restoring array under FHE, matching the
        tfhe-rs convention)."""
        ctx = self.ctx
        w = self.width
        zero_bit = ctx._const_bit(self.batch, False)
        rem = [zero_bit] * w                       # LSB-first
        qbits: list = [None] * w

        def g(name, x, y):
            return ctx._gate(name, x[:, None, :], y[:, None, :])[:, 0, :]

        for i in range(w - 1, -1, -1):
            trial = [self._bit(i)] + rem           # width w+1
            borrow = zero_bit
            diff = []
            for j in range(w + 1):
                x = trial[j]
                y = o._bit(j) if j < w else zero_bit
                diff.append(g("XOR", g("XOR", x, y), borrow))
                nx = gates.gate_not(x)
                borrow = g("OR", g("AND", nx, g("OR", y, borrow)),
                           g("AND", y, borrow))
            ge = gates.gate_not(borrow)            # trial >= divisor
            qbits[i] = ge
            sel = ge[:, None, :].expand(self.batch, w, self.data.shape[-1])
            new_rem = ctx._mux(sel, torch.stack(diff[:w], dim=1),
                               torch.stack(trial[:w], dim=1))
            rem = [new_rem[:, j, :] for j in range(w)]
        return (
            EncUint(ctx, torch.stack(qbits, dim=1), w),
            EncUint(ctx, torch.stack(rem, dim=1), w),
        )

    def __floordiv__(self, o: "EncUint") -> "EncUint":
        return self.divmod(o)[0]

    def __mod__(self, o: "EncUint") -> "EncUint":
        return self.divmod(o)[1]

    def divmod_signed(self, o: "EncUint") -> tuple["EncUint", "EncUint"]:
        """Signed division, C semantics (quotient truncates toward zero,
        remainder takes the dividend's sign) — mirrors Word.divmod_signed."""
        ctx = self.ctx
        sa = EncBit(ctx, self._bit(self.width - 1))
        sb = EncBit(ctx, o._bit(self.width - 1))
        q, r = self.abs_signed().divmod(o.abs_signed())
        sq = sa ^ sb
        return sq.mux(q.neg(), q), sa.mux(r.neg(), r)

    def zero_extend(self, width: int) -> "EncUint":
        if width < self.width:
            raise ValueError("zero_extend to a narrower width")
        data = torch.cat(
            [self.data, self._const_bits(width - self.width)], dim=1
        )
        return EncUint(self.ctx, data, width)

    def mul_full(self, o: "EncUint") -> "EncUint":
        """Full double-width product (no truncation): returns a 2w EncUint."""
        if self.width != o.width:
            raise ValueError("mul_full of different widths")
        w2 = 2 * self.width
        return self.zero_extend(w2) * o.zero_extend(w2)

    def add_with_carry(self, o: "EncUint") -> tuple["EncUint", EncBit]:
        """(sum mod 2^w, carry-out)."""
        return self._ripple(o, subtract=False, want_carry=True)

    def overflowing_add(self, o: "EncUint") -> tuple["EncUint", EncBit]:
        """(sum mod 2^w, unsigned overflow flag) — tfhe-rs analog."""
        return self.add_with_carry(o)

    def overflowing_sub(self, o: "EncUint") -> tuple["EncUint", EncBit]:
        """(difference mod 2^w, borrow flag: 1 iff self < o)."""
        return self - o, self.lt(o)

    def shift_right_arith_enc(self, amount: "EncUint") -> "EncUint":
        """Arithmetic right shift by an ENCRYPTED amount (sign fills;
        amounts >= width saturate to all-sign)."""
        ctx = self.ctx
        w = self.width
        cur = self
        for j in range(amount.width):
            sel = EncBit(ctx, amount._bit(j))
            k = 1 << j
            if k >= w:
                sign = cur.data[:, w - 1: w, :]
                shifted = EncUint(
                    ctx, sign.expand(cur.batch, w, cur.data.shape[-1]), w)
            else:
                shifted = cur.shift_right_arith(k)
            cur = sel.mux(shifted, cur)
        return cur

    def rotl_enc(self, amount: "EncUint") -> "EncUint":
        """Rotate left by an ENCRYPTED amount (taken mod width)."""
        cur = self
        for j in range(amount.width):
            k = (1 << j) % self.width
            if not k:
                continue
            sel = EncBit(self.ctx, amount._bit(j))
            cur = sel.mux(cur.rotl(k), cur)
        return cur

    def rotr_enc(self, amount: "EncUint") -> "EncUint":
        """Rotate right by an ENCRYPTED amount (taken mod width)."""
        cur = self
        for j in range(amount.width):
            k = (1 << j) % self.width
            if not k:
                continue
            sel = EncBit(self.ctx, amount._bit(j))
            cur = sel.mux(cur.rotr(k), cur)
        return cur
