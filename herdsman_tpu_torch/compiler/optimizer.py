"""Circuit optimizer — bootstrap-count reduction before levelization.

The reference evaluates circuits gate-by-gate exactly as submitted (workers
walk the DAG, one binfhe bootstrap per binary gate); it has no optimizer.
Here every removed gate is a removed *batched TPU bootstrap per row*, so a
simplification pass sits in front of the compiler (ROADMAP "circuit
optimizer"; cost model = `compiler.lower.circuit_cost`).

Representation: every wire value is a **literal** `(var, neg)` over a set of
canonical nodes — input bits, the constant, and canonical gates restricted to
{AND, OR, XOR, MUX}. NOT is free in TFHE (a linear negation, no bootstrap),
so negation lives in the literal, never in a node. This gives, in one pass:

- constant folding (CONST_0/1 propagated through every op),
- identity/annihilator/idempotence folds (x&x, x^x, x&~x, mux(s,a,a), ...),
- De Morgan canonicalization: AND(~a,~b) == ~OR(a,b), so NAND/NOR/AND/OR
  expressions that differ only by negation CSE to one node,
- XOR parity normal form: XOR nodes are flattened n-ary sets over non-XOR
  vars with negation pulled out (XOR(~a,b) == ~XOR(a,b)), so chains cancel
  exactly ((x^y)^x == y) regardless of association; re-emission reuses the
  largest already-emitted sub-parity before chaining the remaining terms,
- MUX strength reduction (a MUX costs 2 bootstraps, AND/OR/XOR cost 1):
  mux(s,a,~a) -> ~xor(s,a), mux(s,a,0) -> and(s,a), mux(s,1,b) -> or(s,b),
  mux(s,s,b) -> or(s,b), mux(~s,a,b) -> mux(s,b,a), ...
- common-subexpression elimination over canonical (op, sorted-literal) keys,
- dead-code elimination (only nodes reachable from outputs are re-emitted).

Re-emission picks the cheapest polarity: an AND/OR node consumed only
negated emits as its NAND/NOR form; XOR always emits positive (negation is
a free NOT, and an XNOR would hide the parity set from chain reuse); a node
needed in both polarities emits positive plus one free NOT.

Exactness: optimized circuits are logically equivalent wire-for-wire on the
output columns (`tests/test_optimizer.py` checks equivalence exhaustively
against `compiler.lower.evaluate_plain`), so encrypted evaluation results are
unchanged.
"""

from __future__ import annotations

import dataclasses

from herdsman_tpu_torch.circuit.model import (
    Circuit,
    GateNode,
    GateOp,
    OutputColumn,
)

# A literal: (var, neg). var -1 is the constant node (value == neg, i.e.
# (-1, False) is 0 and (-1, True) is 1); vars [0, num_input_bits) are input
# bits; vars >= num_input_bits are canonical gate nodes.
Lit = tuple[int, bool]

CONST_VAR = -1
FALSE: Lit = (CONST_VAR, False)
TRUE: Lit = (CONST_VAR, True)


def _inv(a: Lit) -> Lit:
    return (a[0], not a[1])


def _is_const(a: Lit) -> bool:
    return a[0] == CONST_VAR


@dataclasses.dataclass
class _Node:
    op: GateOp          # AND / OR / XOR / MUX only
    args: tuple[Lit, ...]


class _Builder:
    """Hash-consed canonical-node builder."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.nodes: dict[int, _Node] = {}   # var -> node
        self._next = n_inputs
        self._cse: dict[tuple, int] = {}

    def _emit(self, op: GateOp, args: tuple[Lit, ...]) -> Lit:
        key = (op, args)
        var = self._cse.get(key)
        if var is None:
            var = self._next
            self._next += 1
            self.nodes[var] = _Node(op, args)
            self._cse[key] = var
        return (var, False)

    # ---- op constructors (all folds live here) ----

    def mk_and(self, a: Lit, b: Lit) -> Lit:
        if _is_const(a):
            a, b = b, a
        if _is_const(b):
            return a if b == TRUE else FALSE
        if a == b:
            return a
        if a == _inv(b):
            return FALSE
        if a[1] and b[1]:  # AND(~x,~y) == ~OR(x,y)  (De Morgan)
            return _inv(self.mk_or(_inv(a), _inv(b)))
        return self._emit(GateOp.AND, tuple(sorted((a, b))))

    def mk_or(self, a: Lit, b: Lit) -> Lit:
        if _is_const(a):
            a, b = b, a
        if _is_const(b):
            return a if b == FALSE else TRUE
        if a == b:
            return a
        if a == _inv(b):
            return TRUE
        if a[1] and b[1]:  # OR(~x,~y) == ~AND(x,y)
            return _inv(self.mk_and(_inv(a), _inv(b)))
        return self._emit(GateOp.OR, tuple(sorted((a, b))))

    def _xor_terms(self, l: Lit) -> tuple[set[int], bool]:
        """Flatten a literal into (set of non-XOR term vars, parity)."""
        var, neg = l
        if var == CONST_VAR:
            return set(), neg
        node = self.nodes.get(var)
        if node is not None and node.op == GateOp.XOR:
            return {a[0] for a in node.args}, neg
        return {var}, neg

    def mk_xor(self, a: Lit, b: Lit) -> Lit:
        # Parity normal form: XOR nodes are flattened n-ary sets of non-XOR
        # vars with negation pulled out (XOR(~x,y) == ~XOR(x,y)), so chains
        # like (x^y)^x cancel exactly to y regardless of association order.
        sa, na = self._xor_terms(a)
        sb, nb = self._xor_terms(b)
        terms = sa ^ sb
        neg = na ^ nb
        if not terms:
            out = FALSE
        elif len(terms) == 1:
            out = (terms.pop(), False)
        else:
            out = self._emit(
                GateOp.XOR, tuple((v, False) for v in sorted(terms))
            )
        return _inv(out) if neg else out

    def mk_mux(self, s: Lit, a: Lit, b: Lit) -> Lit:
        """mux(s, a, b) == s ? a : b (GateOp.MUX arg order)."""
        if _is_const(s):
            return a if s == TRUE else b
        if s[1]:                   # mux(~s,a,b) == mux(s,b,a)
            s, a, b = _inv(s), b, a
        if a == b:
            return a
        if a == _inv(b):           # s ? a : ~a == XNOR(s, a)
            return _inv(self.mk_xor(s, a))
        if a == s or a == TRUE:    # s ? s : b == s ? 1 : b == OR(s, b)
            return self.mk_or(s, b)
        if a == _inv(s) or a == FALSE:   # s ? 0 : b == AND(~s, b)
            return self.mk_and(_inv(s), b)
        if b == s or b == FALSE:   # s ? a : s == s ? a : 0 == AND(s, a)
            return self.mk_and(s, a)
        if b == _inv(s) or b == TRUE:    # s ? a : 1 == OR(~s, a)
            return self.mk_or(_inv(s), a)
        return self._emit(GateOp.MUX, (s, a, b))


def _absorb(builder: _Builder, circuit: Circuit) -> list[Lit]:
    """Map every original wire to a literal over canonical nodes."""
    n_in = circuit.num_input_bits
    lit: list[Lit] = [(i, False) for i in range(n_in)]
    for g in circuit.gates:
        a = [lit[x] for x in g.args]
        if g.op == GateOp.AND:
            v = builder.mk_and(a[0], a[1])
        elif g.op == GateOp.NAND:
            v = _inv(builder.mk_and(a[0], a[1]))
        elif g.op == GateOp.OR:
            v = builder.mk_or(a[0], a[1])
        elif g.op == GateOp.NOR:
            v = _inv(builder.mk_or(a[0], a[1]))
        elif g.op == GateOp.XOR:
            v = builder.mk_xor(a[0], a[1])
        elif g.op == GateOp.XNOR:
            v = _inv(builder.mk_xor(a[0], a[1]))
        elif g.op == GateOp.NOT:
            v = _inv(a[0])
        elif g.op == GateOp.MUX:
            v = builder.mk_mux(a[0], a[1], a[2])
        elif g.op == GateOp.CONST_0:
            v = FALSE
        else:
            v = TRUE
        lit.append(v)
    return lit


_NEG_FORM = {GateOp.AND: GateOp.NAND, GateOp.OR: GateOp.NOR}


class _Emitter:
    """Re-emits kept canonical nodes as a flat SSA gate list."""

    _COMMUTATIVE = (GateOp.AND, GateOp.OR, GateOp.NAND, GateOp.NOR,
                    GateOp.XOR, GateOp.XNOR)

    def __init__(self, builder: _Builder):
        self.b = builder
        self.gates: list[GateNode] = []
        # var -> wire holding the node value, per polarity
        self.pos_wire: dict[int, int] = {
            i: i for i in range(builder.n_inputs)
        }
        self.neg_wire: dict[int, int] = {}
        self.const_wire: dict[bool, int] = {}
        self._gate_cse: dict[tuple, int] = {}
        # frozenset of term vars -> wire, for emitted XOR chains/prefixes
        self._xor_sets: dict[frozenset, int] = {}

    def _new_wire(self, gate: GateNode) -> int:
        key = (gate.op, tuple(sorted(gate.args))
               if gate.op in self._COMMUTATIVE else gate.args)
        w = self._gate_cse.get(key)
        if w is None:
            self.gates.append(gate)
            w = self.b.n_inputs + len(self.gates) - 1
            self._gate_cse[key] = w
        return w

    def wire_for(self, lit: Lit) -> int:
        var, neg = lit
        if var == CONST_VAR:
            if neg not in self.const_wire:
                op = GateOp.CONST_1 if neg else GateOp.CONST_0
                self.const_wire[neg] = self._new_wire(GateNode(op, ()))
            return self.const_wire[neg]
        table = self.neg_wire if neg else self.pos_wire
        if var in table:
            return table[var]
        # derive from the opposite polarity with a free NOT
        other = self.pos_wire if neg else self.neg_wire
        if var not in other:
            self._emit_node(var, want_neg=neg)
            if var in table:
                return table[var]
        w = self._new_wire(GateNode(GateOp.NOT, (other[var],)))
        table[var] = w
        return w

    def _emit_node(self, var: int, want_neg: bool) -> None:
        node = self.b.nodes[var]
        args = tuple(self.wire_for(a) for a in node.args)
        if node.op == GateOp.XOR:
            # Parity node: emitted as a positive binary-XOR chain (negation
            # is a free NOT, and XNOR forms would hide the parity set from
            # reuse). Start from the largest already-emitted sub-parity (an
            # original circuit may have shared any grouping), then fold in
            # the remaining terms, registering every prefix for later reuse.
            tset = {a[0] for a in node.args}
            best_set: frozenset = frozenset()
            best_wire = -1
            for s, wire in self._xor_sets.items():
                if len(s) > len(best_set) and s <= tset:
                    best_set, best_wire = s, wire
            if len(best_set) >= 2:
                w = best_wire
                acc_set = set(best_set)
                rest = [a for a in node.args if a[0] not in best_set]
            else:
                w = args[0]
                acc_set = {node.args[0][0]}
                rest = list(node.args[1:])
            for a in rest:
                w = self._new_wire(GateNode(GateOp.XOR, (w, self.wire_for(a))))
                acc_set.add(a[0])
                self._xor_sets.setdefault(frozenset(acc_set), w)
            self.pos_wire[var] = w
            self._xor_sets.setdefault(frozenset(tset), w)
            if want_neg:
                self.neg_wire[var] = self._new_wire(
                    GateNode(GateOp.NOT, (w,))
                )
        elif want_neg and node.op in _NEG_FORM:
            self.neg_wire[var] = self._new_wire(
                GateNode(_NEG_FORM[node.op], args)
            )
        else:
            self.pos_wire[var] = self._new_wire(GateNode(node.op, args))


def optimize_circuit(circuit: Circuit) -> Circuit:
    """Return an equivalent circuit with (weakly) fewer bootstraps.

    Input columns and output column names/dtypes/order are preserved;
    only the gate list and output wire indices change.
    """
    circuit.validate()
    b = _Builder(circuit.num_input_bits)
    lit = _absorb(b, circuit)

    out_lits = [
        [lit[w] for w in col.wires] for col in circuit.output_columns
    ]

    # polarity usage: nodes consumed ONLY negated emit their NAND/NOR/XNOR
    # form directly. Walk nodes top-down (args reference earlier vars only).
    used_pos: set[int] = set()
    used_neg: set[int] = set()
    live: set[int] = set()

    def mark(l: Lit) -> None:
        if l[0] >= b.n_inputs:
            live.add(l[0])
        (used_neg if l[1] else used_pos).add(l[0])

    for col in out_lits:
        for l in col:
            mark(l)
    for var in sorted(b.nodes, reverse=True):
        if var in live:
            for a in b.nodes[var].args:
                mark(a)

    em = _Emitter(b)
    for var in sorted(live):
        want_neg = var in used_neg and var not in used_pos
        em._emit_node(var, want_neg=want_neg)
    out_cols = tuple(
        OutputColumn(col.name, col.dtype,
                     tuple(em.wire_for(l) for l in lits))
        for col, lits in zip(circuit.output_columns, out_lits)
    )
    opt = Circuit(circuit.input_columns, tuple(em.gates), out_cols)
    opt.validate()
    return opt
