"""Circuit builder DSL — the client-side circuit-construction analog of the
(non-vendored) `herd` client library (SURVEY.md §2.5).

Wires are lightweight handles; multi-bit `Word`s support ripple-carry
arithmetic and comparisons, enough to express realistic map/reduce circuits
(sums, minima, equality filters) over encrypted columns.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from herdsman_tpu_torch.circuit.model import (
    Circuit,
    ColumnMeta,
    DataType,
    GateNode,
    GateOp,
    MappingError,
    OutputColumn,
)


@dataclasses.dataclass(frozen=True)
class Wire:
    builder: "CircuitBuilder" = dataclasses.field(repr=False)
    wire_id: int

    def _g(self, op: GateOp, *others: "Wire") -> "Wire":
        return self.builder.gate(op, self, *others)

    def __and__(self, o: "Wire") -> "Wire":
        return self._g(GateOp.AND, o)

    def __or__(self, o: "Wire") -> "Wire":
        return self._g(GateOp.OR, o)

    def __xor__(self, o: "Wire") -> "Wire":
        return self._g(GateOp.XOR, o)

    def __invert__(self) -> "Wire":
        return self._g(GateOp.NOT)

    def nand(self, o: "Wire") -> "Wire":
        return self._g(GateOp.NAND, o)

    def nor(self, o: "Wire") -> "Wire":
        return self._g(GateOp.NOR, o)

    def xnor(self, o: "Wire") -> "Wire":
        return self._g(GateOp.XNOR, o)

    def mux(self, a: "Wire", b: "Wire") -> "Wire":
        """self ? a : b"""
        return self.builder.gate(GateOp.MUX, self, a, b)


@dataclasses.dataclass(frozen=True)
class Word:
    """A multi-bit value, LSB-first."""

    bits: tuple[Wire, ...]

    def __len__(self) -> int:
        return len(self.bits)

    @property
    def builder(self) -> "CircuitBuilder":
        return self.bits[0].builder

    def __xor__(self, o: "Word") -> "Word":
        return Word(tuple(a ^ b for a, b in zip(self.bits, o.bits, strict=True)))

    def __and__(self, o: "Word") -> "Word":
        return Word(tuple(a & b for a, b in zip(self.bits, o.bits, strict=True)))

    def __or__(self, o: "Word") -> "Word":
        return Word(tuple(a | b for a, b in zip(self.bits, o.bits, strict=True)))

    def __invert__(self) -> "Word":
        return Word(tuple(~a for a in self.bits))

    def __add__(self, o: "Word") -> "Word":
        """Ripple-carry add (mod 2^width)."""
        assert len(self) == len(o)
        b = self.builder
        carry = b.const(False)
        out = []
        for x, y in zip(self.bits, o.bits):
            s = x ^ y
            out.append(s ^ carry)
            carry = (x & y) | (s & carry)
        return Word(tuple(out))

    def __sub__(self, o: "Word") -> "Word":
        """x - y = x + ~y + 1 (two's complement)."""
        assert len(self) == len(o)
        b = self.builder
        carry = b.const(True)
        out = []
        for x, y in zip(self.bits, o.bits):
            ny = ~y
            s = x ^ ny
            out.append(s ^ carry)
            carry = (x & ny) | (s & carry)
        return Word(tuple(out))

    def __lshift__(self, k: int) -> "Word":
        """Shift left by a constant, truncated to width (zeros shift in)."""
        assert 0 <= k
        b = self.builder
        w = len(self)
        k = min(k, w)
        return Word(tuple([b.const(False)] * k + list(self.bits[: w - k])))

    def __rshift__(self, k: int) -> "Word":
        """Logical right shift by a constant (zeros shift in)."""
        assert 0 <= k
        b = self.builder
        w = len(self)
        k = min(k, w)
        return Word(tuple(list(self.bits[k:]) + [b.const(False)] * k))

    def shift_right_arith(self, k: int) -> "Word":
        """Arithmetic right shift by a constant (sign bit shifts in)."""
        assert 0 <= k
        w = len(self)
        k = min(k, w)
        sign = self.bits[-1]
        return Word(tuple(list(self.bits[k:]) + [sign] * k))

    def rotl(self, k: int) -> "Word":
        k %= len(self)
        return Word(self.bits[-k:] + self.bits[:-k]) if k else self

    def rotr(self, k: int) -> "Word":
        k %= len(self)
        return Word(self.bits[k:] + self.bits[:k]) if k else self

    def shift_left_enc(self, amount: "Word") -> "Word":
        """Shift left by an ENCRYPTED amount (barrel shifter: one mux layer
        per amount bit; amounts >= width yield 0)."""
        b = self.builder
        w = len(self)
        cur = self
        for j, sel in enumerate(amount.bits):
            if (1 << j) >= w:
                # any set high amount bit zeroes the result
                zero = Word(tuple([b.const(False)] * w))
                cur = zero.mux(sel, cur)
            else:
                cur = (cur << (1 << j)).mux(sel, cur)
        return cur

    def shift_right_enc(self, amount: "Word") -> "Word":
        """Logical right shift by an ENCRYPTED amount (barrel shifter)."""
        b = self.builder
        w = len(self)
        cur = self
        for j, sel in enumerate(amount.bits):
            if (1 << j) >= w:
                zero = Word(tuple([b.const(False)] * w))
                cur = zero.mux(sel, cur)
            else:
                cur = (cur >> (1 << j)).mux(sel, cur)
        return cur

    def shift_right_arith_enc(self, amount: "Word") -> "Word":
        """Arithmetic right shift by an ENCRYPTED amount (sign fills;
        amounts >= width saturate to all-sign)."""
        w = len(self)
        cur = self
        for j, sel in enumerate(amount.bits):
            k = 1 << j
            if k >= w:
                shifted = Word(tuple([cur.bits[-1]] * w))
            else:
                shifted = cur.shift_right_arith(k)
            cur = shifted.mux(sel, cur)
        return cur

    def rotl_enc(self, amount: "Word") -> "Word":
        """Rotate left by an ENCRYPTED amount (taken mod width — rotations
        compose mod w, so every amount bit is honored)."""
        cur = self
        for j, sel in enumerate(amount.bits):
            k = (1 << j) % len(self)
            cur = cur.rotl(k).mux(sel, cur) if k else cur
        return cur

    def rotr_enc(self, amount: "Word") -> "Word":
        cur = self
        for j, sel in enumerate(amount.bits):
            k = (1 << j) % len(self)
            cur = cur.rotr(k).mux(sel, cur) if k else cur
        return cur

    def eq(self, o: "Word") -> Wire:
        assert len(self) == len(o)
        acc = self.bits[0].xnor(o.bits[0])
        for x, y in zip(self.bits[1:], o.bits[1:]):
            acc = acc & x.xnor(y)
        return acc

    def lt(self, o: "Word") -> Wire:
        """Unsigned less-than, MSB-down ripple."""
        assert len(self) == len(o)
        lt = None
        eq_so_far = None
        for x, y in zip(reversed(self.bits), reversed(o.bits)):
            bit_lt = ~x & y
            if lt is None:
                lt = bit_lt
                eq_so_far = x.xnor(y)
            else:
                lt = lt | (eq_so_far & bit_lt)
                eq_so_far = eq_so_far & x.xnor(y)
        return lt

    def ne(self, o: "Word") -> Wire:
        return ~self.eq(o)

    def le(self, o: "Word") -> Wire:
        return ~o.lt(self)

    def gt(self, o: "Word") -> Wire:
        return o.lt(self)

    def ge(self, o: "Word") -> Wire:
        return ~self.lt(o)

    def lt_signed(self, o: "Word") -> Wire:
        """Two's-complement less-than: if signs differ, the negative one is
        smaller; otherwise compare as unsigned."""
        sa, sb = self.bits[-1], o.bits[-1]
        return (sa ^ sb).mux(sa, self.lt(o))

    def le_signed(self, o: "Word") -> Wire:
        return ~o.lt_signed(self)

    def gt_signed(self, o: "Word") -> Wire:
        return o.lt_signed(self)

    def ge_signed(self, o: "Word") -> Wire:
        return ~self.lt_signed(o)

    def neg(self) -> "Word":
        """Two's-complement negation: ~x + 1."""
        b = self.builder
        zero = Word(tuple([b.const(False)] * len(self)))
        return zero - self

    def abs_signed(self) -> "Word":
        sign = self.bits[-1]
        return self.neg().mux(sign, self)

    def divmod(self, o: "Word") -> tuple["Word", "Word"]:
        """Unsigned restoring division: returns (quotient, remainder).

        Division by zero follows the tfhe-rs convention the hardware
        algorithm produces naturally: quotient = 2^width - 1, remainder =
        dividend (no data-dependent branching exists under FHE)."""
        assert len(self) == len(o)
        b = self.builder
        w = len(self)
        zero = b.const(False)
        rem: list[Wire] = [zero] * w          # remainder, LSB-first
        qbits: list[Wire | None] = [None] * w
        for i in range(w - 1, -1, -1):
            trial = [self.bits[i]] + rem      # (rem << 1) | a_i, width w+1
            borrow = zero
            diff: list[Wire] = []
            for j in range(w + 1):
                x = trial[j]
                y = o.bits[j] if j < w else zero
                diff.append(x ^ y ^ borrow)
                borrow = ((~x) & (y | borrow)) | (y & borrow)
            ge = ~borrow                      # trial >= divisor
            qbits[i] = ge
            # both branches fit in w bits (rem < divisor <= 2^w - 1)
            rem = [ge.mux(d, t) for d, t in zip(diff[:w], trial[:w])]
        return Word(tuple(qbits)), Word(tuple(rem))

    def __floordiv__(self, o: "Word") -> "Word":
        return self.divmod(o)[0]

    def __mod__(self, o: "Word") -> "Word":
        return self.divmod(o)[1]

    def divmod_signed(self, o: "Word") -> tuple["Word", "Word"]:
        """Signed division, C semantics (quotient truncates toward zero,
        remainder takes the dividend's sign): unsigned divmod on absolute
        values + conditional negation."""
        sa, sb = self.bits[-1], o.bits[-1]
        q, r = self.abs_signed().divmod(o.abs_signed())
        sq = sa ^ sb
        return q.neg().mux(sq, q), r.neg().mux(sa, r)

    def mux(self, sel: Wire, other: "Word") -> "Word":
        """sel ? self : other, bitwise."""
        return Word(
            tuple(sel.mux(a, b) for a, b in zip(self.bits, other.bits, strict=True))
        )

    def __mul__(self, o: "Word") -> "Word":
        """Shift-and-add multiply, mod 2^width."""
        assert len(self) == len(o)
        b = self.builder
        width = len(self)
        zero = b.const(False)
        acc: "Word | None" = None
        for i in range(width):
            # partial = (self & o.bits[i]) << i, truncated to width
            masked = [self.bits[k] & o.bits[i] for k in range(width - i)]
            partial = Word(tuple([zero] * i + masked))
            acc = partial if acc is None else acc + partial
        return acc

    def min(self, o: "Word") -> "Word":
        return self.mux(self.lt(o), o)

    def max(self, o: "Word") -> "Word":
        return o.mux(self.lt(o), self)

    def add_with_carry(self, o: "Word") -> tuple["Word", Wire]:
        """Ripple-carry add returning (sum mod 2^w, carry-out)."""
        assert len(self) == len(o)
        b = self.builder
        carry = b.const(False)
        out = []
        for x, y in zip(self.bits, o.bits):
            s = x ^ y
            out.append(s ^ carry)
            carry = (x & y) | (s & carry)
        return Word(tuple(out)), carry

    def overflowing_add(self, o: "Word") -> tuple["Word", Wire]:
        """(sum mod 2^w, unsigned overflow flag) — tfhe-rs analog."""
        return self.add_with_carry(o)

    def overflowing_sub(self, o: "Word") -> tuple["Word", Wire]:
        """(difference mod 2^w, borrow flag: 1 iff self < o)."""
        diff = self - o
        return diff, self.lt(o)

    def zero_extend(self, width: int) -> "Word":
        assert width >= len(self)
        b = self.builder
        return Word(self.bits + tuple(
            b.const(False) for _ in range(width - len(self))
        ))

    def mul_full(self, o: "Word") -> "Word":
        """Full double-width product (no truncation): returns a 2w Word."""
        assert len(self) == len(o)
        w = len(self)
        return self.zero_extend(2 * w) * o.zero_extend(2 * w)


class CircuitBuilder:
    def __init__(self, input_columns: Sequence[ColumnMeta]):
        self._inputs = tuple(input_columns)
        self._gates: list[GateNode] = []
        self._outputs: list[OutputColumn] = []
        self._n_input_bits = sum(c.dtype.bit_width for c in self._inputs)
        self._const_cache: dict[bool, Wire] = {}

    # ---- inputs ----

    def input_column(self, name: str) -> Word:
        off = 0
        for c in self._inputs:
            if c.name == name:
                return Word(
                    tuple(
                        Wire(self, off + i) for i in range(c.dtype.bit_width)
                    )
                )
            off += c.dtype.bit_width
        raise MappingError(f"no input column {name!r}")

    def input_column_at(self, index: int) -> Word:
        """Column by position — needed for reduce combiners, whose input
        schema is the row schema doubled (left row then right row) and thus
        has duplicate column names."""
        if not 0 <= index < len(self._inputs):
            raise MappingError(f"no input column index {index}")
        off = sum(c.dtype.bit_width for c in self._inputs[:index])
        w = self._inputs[index].dtype.bit_width
        return Word(tuple(Wire(self, off + i) for i in range(w)))

    def input_bit(self, name: str) -> Wire:
        w = self.input_column(name)
        if len(w) != 1:
            raise MappingError(f"column {name!r} is not a single bit")
        return w.bits[0]

    # ---- gates ----

    def gate(self, op: GateOp, *args: Wire) -> Wire:
        for a in args:
            if a.builder is not self:
                raise MappingError("wire from a different builder")
        self._gates.append(GateNode(op, tuple(a.wire_id for a in args)))
        return Wire(self, self._n_input_bits + len(self._gates) - 1)

    def const(self, value: bool) -> Wire:
        if value not in self._const_cache:
            op = GateOp.CONST_1 if value else GateOp.CONST_0
            self._const_cache[value] = self.gate(op)
        return self._const_cache[value]

    def const_word(self, value: int, width: int) -> Word:
        return Word(
            tuple(self.const(bool((value >> i) & 1)) for i in range(width))
        )

    # ---- outputs ----

    def output(self, name: str, value: Wire | Word,
               dtype: DataType | None = None) -> None:
        if isinstance(value, Wire):
            value = Word((value,))
        if dtype is None:
            dtype = {1: DataType.BIT, 8: DataType.UINT8,
                     16: DataType.UINT16, 32: DataType.UINT32}[len(value)]
        self._outputs.append(
            OutputColumn(name, dtype, tuple(w.wire_id for w in value.bits))
        )

    def build(self) -> Circuit:
        c = Circuit(self._inputs, tuple(self._gates), tuple(self._outputs))
        c.validate()
        return c
