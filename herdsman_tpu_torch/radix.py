"""Radix-encrypted integers over shortint blocks — the tfhe-rs "integer"
layer analog; the port of ``herdsman_tpu.radix``.

An `EncRadix` holds a W-bit unsigned integer as `n_blocks` shortint blocks
(LSB-first), each carrying `msg_bits` bits of message plus `carry_bits` of
headroom (`shortint`). Linear ops (add, complement, scalar
digit mul) are free LWE arithmetic on every block at once; carries are
repaid lazily — only when a subsequent op would overflow the working space —
by a *carry propagation* pass costing 2 programmable bootstraps per block
(message LUT + carry LUT).

Block data are the int32 carriers of ``ops.u32`` on the key's device: the
JAX package's uint32 products (``data * U32(m)``) are int32 products here,
which wrap the same mod 2^32.

Device shape: the batch axis is the throughput axis, and every PBS layer that
shares a LUT across blocks is STACKED into one batched bootstrap call
(partial products of a multiply: all nb^2 pairs in one blind rotation;
per-block compare LUTs of lt/eq likewise), so a radix multiply over a batch
of B integers costs the same number of device programs as over one.

Unlike `api.EncUint` (one LWE per *bit*, boolean gates), radix arithmetic
does digit arithmetic with LUT bootstraps: an 8-bit add is 1 free add + one
2-PBS-per-block propagation (8 bootstraps at msg=2) versus ~34 gate
bootstraps for the boolean ripple adder.

The reference has no integer layer at all (its workers evaluate boolean
circuits only, SURVEY.md §2.4 Circuit); this module exists for parity with
the tfhe-rs ecosystem the HERD clients come from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from herdsman_tpu_torch.ops import pbs as pbs_mod
from herdsman_tpu_torch.ops.u32 import u32_const
from herdsman_tpu_torch.shortint import EncShort, ShortContext

# three-way compare states
_LT, _EQ, _GT = 0, 1, 2


class RadixContext:
    """Factory/codec for radix integers over a ShortContext."""

    def __init__(self, short: ShortContext, n_blocks: int):
        if short.space_bits < 2 * short.msg_bits:
            raise ValueError("radix ops need carry_bits >= msg_bits (packed "
                             "bivariate LUTs)")
        self.short = short
        self.n_blocks = n_blocks

    @property
    def width(self) -> int:
        return self.n_blocks * self.short.msg_bits

    @property
    def modulus(self) -> int:
        return 1 << self.width

    def encrypt(self, values) -> "EncRadix":
        vals = np.atleast_1d(np.asarray(values, dtype=np.int64))
        vals = vals % self.modulus
        m_bits = self.short.msg_bits
        blocks = []
        for i in range(self.n_blocks):
            digit = (vals >> (i * m_bits)) & (self.short.modulus - 1)
            blocks.append(self.short.encrypt(digit))
        return EncRadix(self, blocks)

    def trivial(self, values, batch: int | None = None) -> "EncRadix":
        """Trivial (noiseless) encryption of cleartext integers — the
        tfhe-rs `trivial_encrypt` analog; enables scalar compares/min/max
        and server-side constants without the client key."""
        vals = np.atleast_1d(np.asarray(values, dtype=np.int64)) \
            % self.modulus  # accept negatives, like encrypt()
        vals = vals.astype(np.uint64)
        if batch is not None and vals.shape[0] == 1:
            vals = np.broadcast_to(vals, (batch,))
        m = self.short.modulus
        blocks = [
            self.short.trivial((vals >> (self.short.msg_bits * j)) % m)
            for j in range(self.n_blocks)
        ]
        return EncRadix(self, blocks)

    def decrypt(self, x: "EncRadix") -> list[int]:
        x = x.propagate()
        m_bits = self.short.msg_bits
        out = None
        for i, blk in enumerate(x.blocks):
            digits = np.asarray(self.short.decrypt(blk), dtype=np.int64)
            out = digits << (i * m_bits) if out is None else \
                out | (digits << (i * m_bits))
        return [int(v) for v in out]

    def decrypt_flag(self, flag: EncShort) -> list[bool]:
        return [bool(v) for v in self.short.decrypt(flag)]

    def decrypt_signed(self, x: "EncRadix") -> list[int]:
        """Two's-complement decode of the W-bit value."""
        half = 1 << (self.width - 1)
        return [v - self.modulus if v >= half else v
                for v in self.decrypt(x)]

    # ---- batched-PBS plumbing ----

    def _pbs_stack(self, datas: list[torch.Tensor], table) -> list[torch.Tensor]:
        """ONE batched bootstrap over a stack of [B, n+1] ciphertext groups
        sharing a LUT; returns the per-group results."""
        if not datas:
            return []
        sizes = [d.shape[0] for d in datas]
        out = self.short._pbs(torch.cat(datas), table)
        res, off = [], 0
        for s in sizes:
            res.append(out[off: off + s])
            off += s
        return res

    def _pbs_stack_many(self, datas: list[torch.Tensor], tables
                        ) -> list[list[torch.Tensor]]:
        """k LUTs over a shared stack: [k][len(datas)] results — ONE blind
        rotation total when the ShortContext has many-LUT enabled."""
        if not datas:
            return [[] for _ in tables]
        sizes = [d.shape[0] for d in datas]
        outs = self.short._pbs_many(torch.cat(datas), tables)
        res = []
        for out in outs:
            row, off = [], 0
            for s in sizes:
                row.append(out[off: off + s])
                off += s
            res.append(row)
        return res

    def _from_bits(self, bits: list[EncShort]) -> "EncRadix":
        """Assemble a radix value from LSB-first encrypted 0/1 bits — free
        (scalar-weighted LWE sums within each block)."""
        s = self.short
        if len(bits) != self.width:
            raise ValueError(f"{len(bits)} bits for a {self.width}-bit value")
        blocks = []
        for j in range(self.n_blocks):
            data = bits[j * s.msg_bits].data
            nl = bits[j * s.msg_bits].noise_level
            for t in range(1, s.msg_bits):
                data = data + bits[j * s.msg_bits + t].data * (1 << t)
                nl += bits[j * s.msg_bits + t].noise_level << t
            blocks.append(EncShort(s, data, s.modulus - 1, nl))
        return EncRadix(self, blocks)

    def _split(self, data: torch.Tensor, max_val: int
               ) -> tuple[EncShort, EncShort]:
        """(low digit, carry) of a working-space value — one blind rotation
        under many-LUT, else 2 PBS."""
        s = self.short
        lo_t = [t % s.modulus for t in range(s.space)]
        hi_t = [t >> s.msg_bits for t in range(s.space)]
        lo, hi = s._pbs_many(data, [lo_t, hi_t])
        return (EncShort(s, lo, s.modulus - 1),
                EncShort(s, hi, max_val >> s.msg_bits))

    def _accumulate_columns(self, cols: list[list[EncShort]],
                            like: torch.Tensor) -> "EncRadix":
        """Column-sum with carry splitting whenever the space would
        overflow; carries feed the next column. `like` fixes the batch
        shape for empty columns."""
        s = self.short
        blocks: list[EncShort] = []
        carry_terms: list[list[EncShort]] = [
            [] for _ in range(self.n_blocks + 1)
        ]
        for j in range(self.n_blocks):
            terms = cols[j] + carry_terms[j]
            acc_data = torch.zeros_like(like)
            acc_max = 0
            acc_nl = 0
            for t in terms:
                if acc_max + t.max_val >= s.space:
                    low, c = self._split(acc_data, acc_max)
                    carry_terms[j + 1].append(c)
                    acc_data, acc_max = low.data, low.max_val
                    acc_nl = low.noise_level
                acc_data = acc_data + t.data
                acc_max += t.max_val
                acc_nl += t.noise_level
            blocks.append(EncShort(s, acc_data, acc_max, max(acc_nl, 1)))
        return EncRadix(self, blocks)

    def sum(self, values: list["EncRadix"]) -> "EncRadix":
        """Multi-operand sum mod 2^W: carry-save accumulation — every
        carry split is a batched 2-PBS, carries feed the next column, so
        k-operand sums avoid k separate ripple propagations."""
        if not values:
            raise ValueError("empty sum")
        if any(v.ctx is not self for v in values):
            raise ValueError("sum of values from another RadixContext")
        cols = [[v.blocks[j] for v in values]
                for j in range(self.n_blocks)]
        return self._accumulate_columns(cols, values[0].blocks[0].data)


@dataclasses.dataclass
class EncRadix:
    ctx: RadixContext
    blocks: list[EncShort]  # LSB-first; invariant: max_val < space

    @property
    def batch(self) -> int:
        return self.blocks[0].data.shape[0]

    def _needs_prop(self) -> bool:
        return any(b.max_val >= self.ctx.short.modulus for b in self.blocks)

    def propagate(self) -> "EncRadix":
        """Repay all carries: every block back to max_val < modulus.
        Sequential in blocks (carries ripple), batched over the vector.
        The carry out of the top block is dropped (mod 2^W semantics)."""
        return self._propagate_carry()[0]

    def refresh(self) -> "EncRadix":
        """propagate() plus a noise refresh of any block whose
        noise_level exceeds 1 — ALL stale blocks in ONE extra batched PBS
        (the mod-LUT, value-identity for max_val < modulus). Operands of
        packed bivariate LUTs (x*m + y) must be refresh()ed: the packing
        scales x's noise by m, and carry-free blocks out of column
        accumulation carry level-3..4 summed noise that propagate() alone
        never repays (tfhe-rs NoiseLevel discipline; the radix-chain
        exact=False of docs/ROADMAP.md)."""
        ctx = self.ctx
        s = ctx.short
        x = self.propagate()
        stale = [j for j, b in enumerate(x.blocks) if b.noise_level > 1]
        if not stale:
            return x
        table = [t % s.modulus for t in range(s.space)]
        fresh = ctx._pbs_stack([x.blocks[j].data for j in stale], table)
        blocks = list(x.blocks)
        for j, data in zip(stale, fresh):
            blocks[j] = EncShort(s, data, x.blocks[j].max_val)
        return EncRadix(ctx, blocks)

    def _propagate_carry(self) -> tuple["EncRadix", EncShort | None]:
        """propagate() plus the top-block carry-out (None when the value
        was already fully reduced). A block already saturating the space is
        split BEFORE the incoming carry lands so the space never
        overflows."""
        ctx = self.ctx
        s = ctx.short
        if not self._needs_prop():
            return self, None
        out: list[EncShort] = []
        carry: EncShort | None = None
        for blk in self.blocks:
            data, maxv, nl = blk.data, blk.max_val, blk.noise_level
            cmax = carry.max_val if carry is not None else 0
            extra: EncShort | None = None
            if maxv + cmax >= s.space:
                low, extra = ctx._split(data, maxv)
                data, maxv, nl = low.data, low.max_val, low.noise_level
            if carry is not None:
                data = data + carry.data
                maxv += cmax
                nl += carry.noise_level
            if maxv >= s.space:
                raise RuntimeError("carry propagation overflowed the space")
            if maxv < s.modulus:
                out.append(EncShort(s, data, maxv, nl))
                carry = extra
            else:
                low2, c2 = ctx._split(data, maxv)
                out.append(low2)
                carry = c2 if extra is None else EncShort(
                    s, extra.data + c2.data, extra.max_val + c2.max_val,
                    extra.noise_level + c2.noise_level
                )
        return EncRadix(ctx, out), carry

    # ---- linear ops ----

    def overflowing_add(self, o: "EncRadix") -> tuple["EncRadix", EncShort]:
        """(sum mod 2^W, unsigned-overflow flag holding 0/1) — the tfhe-rs
        overflowing_add analog. The flag is derived from the top-block
        carry-out of full propagation (one extra PBS)."""
        ctx = self.ctx
        s = ctx.short
        a, b = self.propagate(), o.propagate()  # inputs reduced mod 2^W
        total = EncRadix(ctx, [
            EncShort(s, x.data + y.data, x.max_val + y.max_val,
                     x.noise_level + y.noise_level)
            for x, y in zip(a.blocks, b.blocks)
        ])
        out, carry = total._propagate_carry()
        if carry is None:
            flag = EncShort(s, torch.zeros_like(out.blocks[0].data), 0)
        else:
            nz_t = [1 if t else 0 for t in range(s.space)]
            flag = EncShort(s, s._pbs(carry.data, nz_t), 1)
        return out, flag

    def overflowing_sub(self, o: "EncRadix") -> tuple["EncRadix", EncShort]:
        """(difference mod 2^W, borrow flag: 1 iff self < o)."""
        return self - o, self.lt(o)

    def __add__(self, o: "EncRadix") -> "EncRadix":
        ctx = self.ctx
        s = ctx.short
        a, b = self, o
        if any(x.max_val + y.max_val >= s.space
               for x, y in zip(a.blocks, b.blocks)):
            a = a.propagate()
            if any(x.max_val + y.max_val >= s.space
                   for x, y in zip(a.blocks, b.blocks)):
                b = b.propagate()
        blocks = [EncShort(s, x.data + y.data, x.max_val + y.max_val,
                           x.noise_level + y.noise_level)
                  for x, y in zip(a.blocks, b.blocks)]
        return EncRadix(ctx, blocks)

    def scalar_add(self, k: int) -> "EncRadix":
        ctx = self.ctx
        s = ctx.short
        k %= ctx.modulus
        x = self
        digs = [(k >> (i * s.msg_bits)) & (s.modulus - 1)
                for i in range(ctx.n_blocks)]
        if any(b.max_val + d >= s.space for b, d in zip(x.blocks, digs)):
            x = x.propagate()
        blocks = []
        for blk, d in zip(x.blocks, digs):
            data = blk.data
            if d:
                mu = int(pbs_mod.encode(s.params, d, s.space_bits))
                data = data.clone()
                data[:, s.params.n] += u32_const(mu)
            blocks.append(EncShort(s, data, blk.max_val + d,
                                   blk.noise_level))
        return EncRadix(ctx, blocks)

    def __neg__(self) -> "EncRadix":
        """Two's complement: bitwise NOT (free), then +1."""
        return (~self).scalar_add(1)

    def __sub__(self, o: "EncRadix") -> "EncRadix":
        return self + (-o)

    def shift_blocks_left(self, k: int) -> "EncRadix":
        """Shift by whole digits (k * msg_bits bits) — free."""
        ctx = self.ctx
        s = ctx.short
        if k == 0:
            return self
        zero = EncShort(s, torch.zeros_like(self.blocks[0].data), 0)
        blocks = [zero] * min(k, ctx.n_blocks) + \
            self.blocks[: max(ctx.n_blocks - k, 0)]
        return EncRadix(ctx, blocks)

    def shift_blocks_right(self, k: int) -> "EncRadix":
        x = self.propagate()  # high bits must not leak down via carries
        ctx = self.ctx
        s = ctx.short
        if k == 0:
            return x
        zero = EncShort(s, torch.zeros_like(x.blocks[0].data), 0)
        blocks = x.blocks[min(k, ctx.n_blocks):] + \
            [zero] * min(k, ctx.n_blocks)
        return EncRadix(ctx, blocks)

    # ---- bit-granular shifts and rotations (cleartext amount) ----

    def _stitch(self, rem: int, src, right: bool) -> "EncRadix":
        """Blockwise sub-digit stitch: out block j combines src(j) and its
        neighbor via ONE batched packed-LUT bootstrap.
        left  (right=False): (src(j) << rem) | (src(j-1) >> (msg-rem))
        right (right=True):  (src(j) >> rem) | (src(j+1) << (msg-rem))
        `src` maps a block index (possibly out of range → zero) to an
        EncShort; all inputs must be reduced (max_val < modulus)."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        if right:
            def f(x, y):
                return ((x >> rem) | (y << (s.msg_bits - rem))) & (m - 1)
        else:
            def f(x, y):
                return ((x << rem) | (y >> (s.msg_bits - rem))) & (m - 1)
        table = [f(t >> s.msg_bits, t & (m - 1)) for t in range(s.space)]
        packed = []
        for j in range(ctx.n_blocks):
            cur = src(j)
            nbr = src(j + 1) if right else src(j - 1)
            base = cur.data * m
            packed.append(base if nbr is None else base + nbr.data)
        return EncRadix(ctx, [
            EncShort(s, v, m - 1) for v in ctx._pbs_stack(packed, table)
        ])

    def shift_bits_left(self, k: int) -> "EncRadix":
        """x << k (mod 2^W), cleartext k: free whole-block move + at most
        one batched stitch bootstrap for the sub-digit remainder."""
        ctx = self.ctx
        s = ctx.short
        if k >= ctx.width:
            zero = EncShort(s, torch.zeros_like(self.blocks[0].data), 0)
            return EncRadix(ctx, [zero] * ctx.n_blocks)
        qb, rem = divmod(k, s.msg_bits)
        x = self.shift_blocks_left(qb) if qb else self
        if rem == 0:
            return x
        x = x.propagate()

        def src(j):
            return x.blocks[j] if 0 <= j < ctx.n_blocks else None

        return x._stitch(rem, src, right=False)

    def shift_bits_right(self, k: int) -> "EncRadix":
        """x >> k (logical), cleartext k."""
        ctx = self.ctx
        s = ctx.short
        if k >= ctx.width:
            zero = EncShort(s, torch.zeros_like(self.blocks[0].data), 0)
            return EncRadix(ctx, [zero] * ctx.n_blocks)
        qb, rem = divmod(k, s.msg_bits)
        x = self.shift_blocks_right(qb) if qb else self
        if rem == 0:
            return x
        x = x.propagate()

        def src(j):
            return x.blocks[j] if 0 <= j < ctx.n_blocks else None

        return x._stitch(rem, src, right=True)

    def shift_bits_right_signed(self, k: int) -> "EncRadix":
        """Arithmetic right shift (sign-extending), cleartext k: logical
        shift + free sign-mask fill (flag-scaled cleartext digits)."""
        ctx = self.ctx
        s = ctx.short
        k = min(k, ctx.width - 1)
        sgn = self.sign_bit()
        x = self.shift_bits_right(k)
        mask = ((1 << k) - 1) << (ctx.width - k) if k else 0
        blocks = []
        for j, blk in enumerate(x.blocks):
            d = (mask >> (j * s.msg_bits)) & (s.modulus - 1)
            if d == 0:
                blocks.append(blk)
            else:  # blk < m and fill < m share no bits: sum stays < space
                blocks.append(EncShort(s, blk.data + sgn.data * d,
                                       blk.max_val + d,
                                       blk.noise_level +
                                       sgn.noise_level * d))
        return EncRadix(ctx, blocks)

    def rotate_bits_left(self, k: int) -> "EncRadix":
        """Rotate left by cleartext k (mod W)."""
        ctx = self.ctx
        s = ctx.short
        k %= ctx.width
        qb, rem = divmod(k, s.msg_bits)
        x = self.propagate()
        nb = ctx.n_blocks
        rot = [x.blocks[(j - qb) % nb] for j in range(nb)]
        if rem == 0:
            return EncRadix(ctx, rot)
        y = EncRadix(ctx, rot)
        return y._stitch(rem, lambda j: rot[j % nb], right=False)

    def rotate_bits_right(self, k: int) -> "EncRadix":
        return self.rotate_bits_left(-k % self.ctx.width)

    # ---- encrypted-amount shifts (barrel shifter) ----

    def _barrel(self, amount: "EncRadix", step) -> "EncRadix":
        """log2(W) mux layers: layer t applies step(x, 2^t) iff bit t of
        `amount` is set. Shift semantics follow tfhe-rs: the amount is
        taken mod W (W must be a power of two)."""
        ctx = self.ctx
        W = ctx.width
        nbits = W.bit_length() - 1
        if (1 << nbits) != W:
            raise ValueError("encrypted-amount shifts need a power-of-two "
                             "bit width")
        abits = amount.bits()[:nbits]
        x = self
        for t, bit in enumerate(abits):
            x = step(x, 1 << t).mux(bit, x)
        return x

    def shift_left(self, amount: "EncRadix") -> "EncRadix":
        return self._barrel(amount, lambda x, k: x.shift_bits_left(k))

    def shift_right(self, amount: "EncRadix") -> "EncRadix":
        return self._barrel(amount, lambda x, k: x.shift_bits_right(k))

    def shift_right_signed(self, amount: "EncRadix") -> "EncRadix":
        return self._barrel(amount,
                            lambda x, k: x.shift_bits_right_signed(k))

    def rotate_left(self, amount: "EncRadix") -> "EncRadix":
        return self._barrel(amount, lambda x, k: x.rotate_bits_left(k))

    def rotate_right(self, amount: "EncRadix") -> "EncRadix":
        return self._barrel(amount, lambda x, k: x.rotate_bits_right(k))

    # ---- multiplication ----

    def _digit_products(self, o: "EncRadix",
                        out_blocks: int | None = None
                        ) -> list[list[EncShort]]:
        """All packed digit products (low and high halves) gathered per
        output column — the low/high LUT layers each run as ONE batched
        bootstrap. `out_blocks` widens the column range (wide multiply);
        default truncates at n_blocks (mod-2^W product)."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        nb_out = out_blocks if out_blocks is not None else ctx.n_blocks
        a, b = self.refresh(), o.refresh()
        lo_t = [((t >> s.msg_bits) * (t & (m - 1))) % m for t in range(s.space)]
        hi_t = [((t >> s.msg_bits) * (t & (m - 1))) // m for t in range(s.space)]
        packed, lo_dst, hi_dst = [], [], []
        for i in range(ctx.n_blocks):
            for j in range(min(ctx.n_blocks, nb_out - i)):
                packed.append(a.blocks[i].data * m + b.blocks[j].data)
                lo_dst.append(i + j)
                hi_dst.append(i + j + 1)
        cols: list[list[EncShort]] = [[] for _ in range(nb_out)]
        # two rotations, never one many-LUT rotation: packed inputs lack
        # the noise margin for it (shortint.py, ShortContext.__init__)
        for dst, lo in zip(lo_dst, ctx._pbs_stack(packed, lo_t)):
            cols[dst].append(EncShort(s, lo, m - 1))
        hi_packed = [p for p, d in zip(packed, hi_dst) if d < nb_out]
        hi_keep = [d for d in hi_dst if d < nb_out]
        for dst, hi in zip(hi_keep, ctx._pbs_stack(hi_packed, hi_t)):
            cols[dst].append(EncShort(s, hi, m - 2))  # (m-1)^2 // m
        return cols

    def _accumulate_columns(self, cols: list[list[EncShort]]) -> "EncRadix":
        return self.ctx._accumulate_columns(cols, self.blocks[0].data)

    def __mul__(self, o: "EncRadix") -> "EncRadix":
        """Schoolbook digit multiply, mod 2^width: one batched low-LUT
        bootstrap + one batched high-LUT bootstrap for ALL digit pairs,
        then column accumulation with carry splitting."""
        return self._accumulate_columns(self._digit_products(o))

    def mul_wide(self, o: "EncRadix") -> "EncRadix":
        """Full 2W-bit product (tfhe-rs unsigned widening multiply): same
        batched low/high LUT layers, no column truncation; the result
        lives in a doubled RadixContext over the same ShortContext."""
        ctx2 = RadixContext(self.ctx.short, 2 * self.ctx.n_blocks)
        cols = self._digit_products(o, out_blocks=ctx2.n_blocks)
        return ctx2._accumulate_columns(cols, self.blocks[0].data)

    def scalar_mul(self, k: int) -> "EncRadix":
        """Multiply by a cleartext scalar: free per-digit scaling (with
        splitting) accumulated across shifted columns."""
        ctx = self.ctx
        s = ctx.short
        k %= ctx.modulus
        if k == 0:
            zero = EncShort(s, torch.zeros_like(self.blocks[0].data), 0)
            return EncRadix(ctx, [zero] * ctx.n_blocks)
        x = self.propagate()
        cols: list[list[EncShort]] = [[] for _ in range(ctx.n_blocks)]
        for j in range(ctx.n_blocks):
            d = (k >> (j * s.msg_bits)) & (s.modulus - 1)
            if d == 0:
                continue
            for i in range(ctx.n_blocks - j):
                blk = x.blocks[i]
                cols[i + j].append(
                    EncShort(s, blk.data * d, blk.max_val * d,
                             blk.noise_level * d)
                )
        return self._accumulate_columns(cols)

    # ---- bitwise ops ----

    def _bitwise(self, o: "EncRadix", fn) -> "EncRadix":
        """Blockwise bivariate bit-op: pack (x, y) per block and apply the
        LUT table[x*m+y] = fn(x, y) — ONE batched bootstrap for all
        blocks."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        a, b = self.refresh(), o.refresh()
        table = [fn(t >> s.msg_bits, t & (m - 1)) % m for t in range(s.space)]
        packed = [x.data * m + y.data
                  for x, y in zip(a.blocks, b.blocks)]
        return EncRadix(ctx, [
            EncShort(s, v, m - 1) for v in ctx._pbs_stack(packed, table)
        ])

    def __and__(self, o: "EncRadix") -> "EncRadix":
        return self._bitwise(o, lambda x, y: x & y)

    def __or__(self, o: "EncRadix") -> "EncRadix":
        return self._bitwise(o, lambda x, y: x | y)

    def __xor__(self, o: "EncRadix") -> "EncRadix":
        return self._bitwise(o, lambda x, y: x ^ y)

    def __invert__(self) -> "EncRadix":
        """Bitwise NOT = blockwise (m-1) - digit: free LWE arithmetic."""
        ctx = self.ctx
        s = ctx.short
        x = self.propagate()
        mu = int(pbs_mod.encode(s.params, s.modulus - 1, s.space_bits))
        blocks = []
        for blk in x.blocks:
            const = torch.zeros_like(blk.data)
            const[:, s.params.n] = u32_const(mu)
            blocks.append(EncShort(s, const - blk.data, s.modulus - 1,
                                   blk.noise_level))
        return EncRadix(ctx, blocks)

    # ---- bit access ----

    def bits(self) -> list[EncShort]:
        """LSB-first bit extraction: msg_bits LUT layers, each ONE batched
        bootstrap over all blocks."""
        ctx = self.ctx
        s = ctx.short
        x = self.propagate()
        datas = [b.data for b in x.blocks]
        out: list[list[EncShort]] = [[] for _ in range(ctx.n_blocks)]
        tables = [[(v >> t) & 1 for v in range(s.space)]
                  for t in range(s.msg_bits)]
        if s.many_lut and s.msg_bits & (s.msg_bits - 1) == 0:
            rows = ctx._pbs_stack_many(datas, tables)  # one rotation
        else:
            rows = [ctx._pbs_stack(datas, t) for t in tables]
        for row in rows:
            for j, bit in enumerate(row):
                out[j].append(EncShort(s, bit, 1))
        return [b for blk in out for b in blk]

    # ---- bit counting (tfhe-rs integer analogs) ----

    def count_ones(self) -> "EncRadix":
        """Population count: ONE batched popcount LUT over all blocks, then
        carry-save accumulation into a radix value."""
        ctx = self.ctx
        s = ctx.short
        x = self.propagate()
        pop_t = [bin(t % s.modulus).count("1") for t in range(s.space)]
        pops = ctx._pbs_stack([b.data for b in x.blocks], pop_t)
        cols: list[list[EncShort]] = [[] for _ in range(ctx.n_blocks)]
        cols[0] = [EncShort(s, v, s.msg_bits) for v in pops]
        return ctx._accumulate_columns(cols, self.blocks[0].data)

    def count_zeros(self) -> "EncRadix":
        """W - popcount (bitwise NOT is free, so this costs the same)."""
        return (~self).count_ones()

    def _directional_zeros(self, from_msb: bool) -> "EncRadix":
        """Shared core of leading/trailing_zeros. Per block, one (many-)LUT
        layer yields the in-block count and a nonzero indicator; the
        "all blocks before me (in scan order) are zero" gate is a FREE
        indicator sum + one batched is-zero LUT (no sequential prefix-AND
        chain); a final batched select LUT masks each block's count.
        Three LUT layers total, independent of block count."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        if ctx.n_blocks > m:
            raise ValueError("indicator-sum gate needs n_blocks <= carry "
                             "space")
        x = self.propagate()
        datas = [b.data for b in x.blocks]
        if from_msb:
            cnt_t = [s.msg_bits - (t % m).bit_length() for t in range(s.space)]
        else:
            cnt_t = [s.msg_bits if (t % m) == 0
                     else ((t % m) & -(t % m)).bit_length() - 1
                     for t in range(s.space)]
        nz_t = [1 if (t % m) else 0 for t in range(s.space)]
        if s.many_lut:
            cnts, nzs = ctx._pbs_stack_many(datas, [cnt_t, nz_t])
        else:
            cnts = ctx._pbs_stack(datas, cnt_t)
            nzs = ctx._pbs_stack(datas, nz_t)
        order = list(reversed(range(ctx.n_blocks))) if from_msb \
            else list(range(ctx.n_blocks))
        # S_j = number of nonzero blocks scanned before block j (free adds)
        gate_src, run = [], None
        for j in order[:-1]:
            run = nzs[j] if run is None else run + nzs[j]
            gate_src.append(run)
        is0_t = [1 if t == 0 else 0 for t in range(s.space)]
        gates_ = ctx._pbs_stack(gate_src, is0_t)  # p = all-prior-zero flag
        sel_t = [(t & (m - 1)) if (t >> s.msg_bits) == 1 else 0
                 for t in range(s.space)]
        packed = [g * m + cnts[j] for g, j in zip(gates_, order[1:])]
        masked = ctx._pbs_stack(packed, sel_t)
        terms = [EncShort(s, cnts[order[0]], s.msg_bits)] + [
            EncShort(s, v, s.msg_bits) for v in masked
        ]
        cols: list[list[EncShort]] = [[] for _ in range(ctx.n_blocks)]
        cols[0] = terms
        return ctx._accumulate_columns(cols, self.blocks[0].data)

    def leading_zeros(self) -> "EncRadix":
        """Count of leading (MSB-side) zero bits; W for the zero value."""
        return self._directional_zeros(from_msb=True)

    def trailing_zeros(self) -> "EncRadix":
        """Count of trailing (LSB-side) zero bits; W for the zero value."""
        return self._directional_zeros(from_msb=False)

    def ilog2(self) -> "EncRadix":
        """floor(log2(x)) = W - 1 - leading_zeros(x). For x = 0 the result
        wraps to 2^W - 1 (tfhe-rs leaves ilog2(0) unspecified)."""
        return (-self.leading_zeros()).scalar_add(self.ctx.width - 1)

    def _mask_by_flag(self, flag: EncShort) -> "EncRadix":
        """Blockwise value * flag (flag holds 0/1): one batched bootstrap."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        x = self.refresh()
        keep_t = [(t & (m - 1)) if (t >> s.msg_bits) == 1 else 0
                  for t in range(s.space)]
        packed = [flag.data * m + b.data for b in x.blocks]
        return EncRadix(ctx, [
            EncShort(s, v, m - 1) for v in ctx._pbs_stack(packed, keep_t)
        ])

    # ---- division ----

    def divmod(self, o: "EncRadix") -> tuple["EncRadix", "EncRadix"]:
        """Unsigned restoring division -> (quotient, remainder), bit-serial
        digit recurrence (the tfhe-rs integer div algorithm class): W
        iterations of shift-in / compare / masked subtract, every PBS layer
        batched across blocks AND the vector batch.

        Division by zero yields quotient 2^W - 1 and remainder = dividend
        (same convention as the boolean-circuit divider)."""
        ctx = self.ctx
        s = ctx.short
        d = o.propagate()
        a_bits = self.bits()
        zero = EncShort(s, torch.zeros_like(self.blocks[0].data), 0)
        rem = EncRadix(ctx, [zero] * ctx.n_blocks)
        qbits: list[EncShort] = [None] * ctx.width  # type: ignore
        for i in reversed(range(ctx.width)):
            rem = rem + rem                       # shift left one bit (free)
            lsb = rem.blocks[0]
            rem.blocks[0] = EncShort(
                s, lsb.data + a_bits[i].data, lsb.max_val + 1
            )
            rem = rem.propagate()
            ge = rem.ge(d)                        # rem >= divisor
            qbits[i] = ge
            rem = rem - d._mask_by_flag(ge)       # restore-free subtract
        return ctx._from_bits(qbits), rem.propagate()

    def __floordiv__(self, o: "EncRadix") -> "EncRadix":
        return self.divmod(o)[0]

    def __mod__(self, o: "EncRadix") -> "EncRadix":
        return self.divmod(o)[1]

    # ---- comparisons (flags are EncShort holding 0/1) ----

    def eq(self, o: "EncRadix") -> EncShort:
        """Per-block inequality indicators summed (free), then one PBS
        mapping sum==0 -> 1."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        if ctx.n_blocks >= s.space:
            raise ValueError("too many blocks for eq-sum")
        a, b = self.refresh(), o.refresh()
        neq_t = [1 if (t >> s.msg_bits) != (t & (m - 1)) else 0
                 for t in range(s.space)]
        packed = [x.data * m + y.data
                  for x, y in zip(a.blocks, b.blocks)]
        neqs = ctx._pbs_stack(packed, neq_t)
        total = neqs[0]
        for v in neqs[1:]:
            total = total + v
        is0_t = [1 if t == 0 else 0 for t in range(s.space)]
        return EncShort(s, s._pbs(total, is0_t), 1)

    def ne(self, o: "EncRadix") -> EncShort:
        ctx = self.ctx
        s = ctx.short
        flag = self.eq(o)
        not_t = [1 - (t & 1) if t <= 1 else 0 for t in range(s.space)]
        return EncShort(s, s._pbs(flag.data, not_t), 1)

    def _compare(self, o: "EncRadix", accept: tuple[int, ...]) -> EncShort:
        """Three-way radix compare, MSB-down state propagation; returns the
        0/1 flag for final state in `accept` (subset of {LT, EQ, GT})."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        a, b = self.refresh(), o.refresh()
        cmp_t = []
        for t in range(s.space):
            x, y = t >> s.msg_bits, t & (m - 1)
            cmp_t.append(_LT if x < y else (_EQ if x == y else _GT))
        packed = [x.data * m + y.data
                  for x, y in zip(a.blocks, b.blocks)]
        cmps = ctx._pbs_stack(packed, cmp_t)  # one batched bootstrap
        state = cmps[-1]  # MSB block
        comb_t = []
        for t in range(s.space):
            hi, lo = t >> 2, t & 3
            comb_t.append(lo if hi == _EQ else hi)
        for c in reversed(cmps[:-1]):
            state = s._pbs(state * 4 + c, comb_t)
        acc_t = [1 if t in accept else 0 for t in range(s.space)]
        return EncShort(s, s._pbs(state, acc_t), 1)

    def lt(self, o: "EncRadix") -> EncShort:
        return self._compare(o, (_LT,))

    def le(self, o: "EncRadix") -> EncShort:
        return self._compare(o, (_LT, _EQ))

    def gt(self, o: "EncRadix") -> EncShort:
        return self._compare(o, (_GT,))

    def ge(self, o: "EncRadix") -> EncShort:
        return self._compare(o, (_GT, _EQ))

    # ---- signed (two's complement) views ----

    # ---- scalar comparisons (tfhe-rs scalar_{eq,ne,lt,...} analogs):
    # the scalar becomes a trivial (noiseless) operand ----

    def _trivial_like(self, k: int) -> "EncRadix":
        return self.ctx.trivial(k, batch=self.batch)

    def scalar_eq(self, k: int) -> EncShort:
        return self.eq(self._trivial_like(k))

    def scalar_ne(self, k: int) -> EncShort:
        return self.ne(self._trivial_like(k))

    def scalar_lt(self, k: int) -> EncShort:
        return self.lt(self._trivial_like(k))

    def scalar_le(self, k: int) -> EncShort:
        return self.le(self._trivial_like(k))

    def scalar_gt(self, k: int) -> EncShort:
        return self.gt(self._trivial_like(k))

    def scalar_ge(self, k: int) -> EncShort:
        return self.ge(self._trivial_like(k))

    def scalar_min(self, k: int) -> "EncRadix":
        return self.min(self._trivial_like(k))

    def scalar_max(self, k: int) -> "EncRadix":
        return self.max(self._trivial_like(k))

    def sign_bit(self) -> EncShort:
        """0/1 flag = the two's-complement sign (top bit): one PBS on the
        top block."""
        ctx = self.ctx
        s = ctx.short
        x = self.propagate()
        half = s.modulus >> 1
        sgn_t = [1 if (t % s.modulus) >= half else 0 for t in range(s.space)]
        return EncShort(s, s._pbs(x.blocks[-1].data, sgn_t), 1)

    def _signed_bias(self) -> "EncRadix":
        """Add 2^(W-1) mod 2^W — maps signed order onto unsigned order."""
        return self.scalar_add(1 << (self.ctx.width - 1))

    def lt_signed(self, o: "EncRadix") -> EncShort:
        return self._signed_bias().lt(o._signed_bias())

    def le_signed(self, o: "EncRadix") -> EncShort:
        return self._signed_bias().le(o._signed_bias())

    def gt_signed(self, o: "EncRadix") -> EncShort:
        return self._signed_bias().gt(o._signed_bias())

    def ge_signed(self, o: "EncRadix") -> EncShort:
        return self._signed_bias().ge(o._signed_bias())

    def min_signed(self, o: "EncRadix") -> "EncRadix":
        return self.mux(self.lt_signed(o), o)

    def max_signed(self, o: "EncRadix") -> "EncRadix":
        return o.mux(self.lt_signed(o), self)

    def abs_signed(self) -> "EncRadix":
        """|x| under two's complement (|INT_MIN| wraps to itself)."""
        return (-self).mux(self.sign_bit(), self)

    def _neg_if(self, flag: EncShort) -> "EncRadix":
        """flag ? -self : self."""
        return (-self).mux(flag, self)

    def divmod_signed(self, o: "EncRadix") -> tuple["EncRadix", "EncRadix"]:
        """Signed division with C semantics (truncation toward zero;
        remainder takes the dividend's sign): unsigned restoring divmod on
        the absolute values + sign fix-ups via mux."""
        ctx = self.ctx
        s = ctx.short
        sa, sb = self.sign_bit(), o.sign_bit()
        q, r = self.abs_signed().divmod(o.abs_signed())
        # q negated iff signs differ: sa XOR sb via packed LUT (one PBS)
        xor_t = [(t >> s.msg_bits) ^ (t & 1) if (t >> s.msg_bits) <= 1
                 else 0 for t in range(s.space)]
        sq = EncShort(s, s._pbs(sa.data * s.modulus + sb.data, xor_t), 1)
        return q._neg_if(sq), r._neg_if(sa)

    # ---- selection ----

    def mux(self, sel: EncShort, other: "EncRadix") -> "EncRadix":
        """sel ? self : other (sel holds 0/1): per block, two packed LUTs
        (v*sel and v*(1-sel)) — each layer one batched bootstrap — then a
        free add."""
        ctx = self.ctx
        s = ctx.short
        m = s.modulus
        if sel.max_val > 1:
            raise ValueError("mux selector must hold 0/1")
        a, b = self.refresh(), other.refresh()
        keep_t = [(t & (m - 1)) if (t >> s.msg_bits) == 1 else 0
                  for t in range(s.space)]
        drop_t = [(t & (m - 1)) if (t >> s.msg_bits) == 0 else 0
                  for t in range(s.space)]
        pa = [sel.data * m + x.data for x in a.blocks]
        pb = [sel.data * m + y.data for y in b.blocks]
        kept = ctx._pbs_stack(pa, keep_t)
        dropped = ctx._pbs_stack(pb, drop_t)
        # exactly one of (kept, dropped) is an encryption of 0 per block
        blocks = [EncShort(s, u + v, m - 1, 2)
                  for u, v in zip(kept, dropped)]
        return EncRadix(ctx, blocks)

    def min(self, o: "EncRadix") -> "EncRadix":
        return self.mux(self.lt(o), o)

    def max(self, o: "EncRadix") -> "EncRadix":
        return o.mux(self.lt(o), self)
