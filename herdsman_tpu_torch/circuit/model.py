"""Circuit domain model — the herd_common `Circuit` analog.

The reference's Circuit type lives in the empty herd_common submodule; its
surface is reconstructed from usage (SURVEY.md §2.4): a boolean-gate DAG over
the bit-decomposition of input columns, with named+typed output columns
(`circuit.output` used at reference src/service/execution_service.cpp:11-21),
evaluated gate-by-gate by workers with OpenFHE binfhe. Here a circuit is a
flat SSA list of gates over wire ids — the form the compiler levelizes into
batched device programs.

Wire numbering: input-column bits first (columns in declaration order, bits
LSB-first), then one wire per gate in list order. Gates may only reference
earlier wires (validated), so the list is topologically sorted by
construction.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Sequence


class MappingError(ValueError):
    """Invalid circuit/plan wire format (the herd::mapper::MappingError
    analog, reference src/controller/execution_controller.cpp:126-130)."""


class SchemaType(enum.IntEnum):
    """Cryptographic schema of a session's keys/frames (herd_common
    SchemaType, integer-backed — used as the key file name, reference
    src/service/key_service.cpp:28-31)."""

    TFHE_BOOL = 0
    TFHE_PACKING = 1   # LWE->GLWE packing keyswitch key (packed downloads)


class DataType(enum.IntEnum):
    BIT = 0
    UINT8 = 1
    UINT16 = 2
    UINT32 = 3
    INT8 = 4
    INT16 = 5
    INT32 = 6

    @property
    def bit_width(self) -> int:
        return {
            DataType.BIT: 1,
            DataType.UINT8: 8, DataType.INT8: 8,
            DataType.UINT16: 16, DataType.INT16: 16,
            DataType.UINT32: 32, DataType.INT32: 32,
        }[self]

    @property
    def signed(self) -> bool:
        return self in (DataType.INT8, DataType.INT16, DataType.INT32)


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    name: str
    dtype: DataType


class GateOp(enum.IntEnum):
    AND = 0
    OR = 1
    NAND = 2
    NOR = 3
    XOR = 4
    XNOR = 5
    NOT = 6
    MUX = 7      # args: (sel, a, b) -> sel ? a : b
    CONST_0 = 8
    CONST_1 = 9

    @property
    def arity(self) -> int:
        return {
            GateOp.NOT: 1,
            GateOp.MUX: 3,
            GateOp.CONST_0: 0,
            GateOp.CONST_1: 0,
        }.get(self, 2)


# Two-input gates that lower to one batched bootstrap
BOOTSTRAP_GATES = (
    GateOp.AND, GateOp.OR, GateOp.NAND, GateOp.NOR, GateOp.XOR, GateOp.XNOR
)


@dataclasses.dataclass(frozen=True)
class GateNode:
    op: GateOp
    args: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class OutputColumn:
    name: str
    dtype: DataType
    wires: tuple[int, ...]  # bit wires, LSB-first; len == dtype.bit_width


@dataclasses.dataclass(frozen=True)
class Circuit:
    input_columns: tuple[ColumnMeta, ...]
    gates: tuple[GateNode, ...]
    output_columns: tuple[OutputColumn, ...]

    @property
    def num_input_bits(self) -> int:
        return sum(c.dtype.bit_width for c in self.input_columns)

    @property
    def num_wires(self) -> int:
        return self.num_input_bits + len(self.gates)

    @property
    def output(self) -> tuple[ColumnMeta, ...]:
        """herd_common parity: output column metadata (name + dtype)."""
        return tuple(ColumnMeta(c.name, c.dtype) for c in self.output_columns)

    def input_bit_offset(self, column: int) -> int:
        return sum(c.dtype.bit_width for c in self.input_columns[:column])

    def validate(self) -> None:
        """Structural validation; raises MappingError (to_model analog)."""
        n_in = self.num_input_bits
        for gi, g in enumerate(self.gates):
            wire_id = n_in + gi
            if len(g.args) != g.op.arity:
                raise MappingError(
                    f"gate {gi} ({g.op.name}): arity {len(g.args)} != "
                    f"{g.op.arity}"
                )
            for a in g.args:
                if not 0 <= a < wire_id:
                    raise MappingError(
                        f"gate {gi} ({g.op.name}): arg {a} out of range "
                        f"[0, {wire_id})"
                    )
        n_wires = self.num_wires
        seen = set()
        for col in self.output_columns:
            if col.name in seen:
                raise MappingError(f"duplicate output column {col.name!r}")
            seen.add(col.name)
            if len(col.wires) != col.dtype.bit_width:
                raise MappingError(
                    f"output {col.name!r}: {len(col.wires)} wires != "
                    f"bit width {col.dtype.bit_width}"
                )
            for w in col.wires:
                if not 0 <= w < n_wires:
                    raise MappingError(
                        f"output {col.name!r}: wire {w} out of range"
                    )
        if not self.output_columns:
            raise MappingError("circuit has no outputs")

    # ---- serde (the proto round-trip analog) ----

    def to_dict(self) -> dict:
        return {
            "input_columns": [
                {"name": c.name, "dtype": int(c.dtype)}
                for c in self.input_columns
            ],
            "gates": [
                {"op": int(g.op), "args": list(g.args)} for g in self.gates
            ],
            "output_columns": [
                {"name": c.name, "dtype": int(c.dtype), "wires": list(c.wires)}
                for c in self.output_columns
            ],
        }

    @staticmethod
    def from_dict(d: dict) -> "Circuit":
        try:
            c = Circuit(
                input_columns=tuple(
                    ColumnMeta(x["name"], DataType(x["dtype"]))
                    for x in d["input_columns"]
                ),
                gates=tuple(
                    GateNode(GateOp(x["op"]), tuple(x["args"]))
                    for x in d["gates"]
                ),
                output_columns=tuple(
                    OutputColumn(
                        x["name"], DataType(x["dtype"]), tuple(x["wires"])
                    )
                    for x in d["output_columns"]
                ),
            )
        except (KeyError, ValueError, TypeError) as e:
            raise MappingError(f"malformed circuit: {e}") from e
        c.validate()
        return c

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Circuit":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise MappingError(f"malformed circuit json: {e}") from e
        return Circuit.from_dict(d)


def columns_as_map(columns: Sequence[ColumnMeta]) -> dict[str, tuple[int, DataType]]:
    """herd_common column_map_type analog: name -> (index, dtype)
    (reference src/controller/storage_controller.cpp:15-45)."""
    return {c.name: (i, c.dtype) for i, c in enumerate(columns)}
