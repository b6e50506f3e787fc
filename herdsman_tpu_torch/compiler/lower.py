"""Circuit -> levelized batched device evaluation — the port of
``herdsman_tpu.compiler.lower``.

All two-input gates at the same bootstrap depth, across all rows of the
batch, become one ``gate_batch`` (one blind-rotation launch); MUX gates of a
level become one ``mux_batch``; NOT and CONST are linear and free.

Data layout: a batch of encrypted rows is [rows, num_bits, n+1] (numpy
uint32 or the int32 carrier) — column bits concatenated in declaration
order, LSB-first (matching ``circuit.model`` wire numbering).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from herdsman_tpu_torch.circuit.model import BOOTSTRAP_GATES, Circuit, GateOp
from herdsman_tpu_torch.mesh import sharding
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops import gates as gate_ops
from herdsman_tpu_torch.ops.server_key import DeviceServerKey
from herdsman_tpu_torch.ops.u32 import resolve_device, to_device, u32_const
from herdsman_tpu_torch.utils import tracing

I32 = torch.int32

_OP_TO_GATE_ID = {
    GateOp.AND: gate_ops.GATE_IDS["AND"],
    GateOp.OR: gate_ops.GATE_IDS["OR"],
    GateOp.NAND: gate_ops.GATE_IDS["NAND"],
    GateOp.NOR: gate_ops.GATE_IDS["NOR"],
    GateOp.XOR: gate_ops.GATE_IDS["XOR"],
    GateOp.XNOR: gate_ops.GATE_IDS["XNOR"],
}

_LINEAR = (GateOp.NOT, GateOp.CONST_0, GateOp.CONST_1)


@dataclasses.dataclass(frozen=True)
class Level:
    """One bootstrap depth level: gate indices grouped by kind."""

    bootstrap_gates: tuple[int, ...]  # indices into circuit.gates
    mux_gates: tuple[int, ...]


def levelize(circuit: Circuit) -> tuple[list[Level], list[int]]:
    """Group bootstrapping gates by depth.

    Returns (levels, depth_per_wire).  NOT/CONST are depth-transparent
    (linear, no bootstrap).
    """
    n_in = circuit.num_input_bits
    depth = [0] * circuit.num_wires
    level_map: dict[int, dict[str, list[int]]] = {}
    for gi, g in enumerate(circuit.gates):
        wire = n_in + gi
        arg_depth = max((depth[a] for a in g.args), default=0)
        if g.op in BOOTSTRAP_GATES or g.op == GateOp.MUX:
            depth[wire] = arg_depth + 1
            bucket = level_map.setdefault(depth[wire], {"bs": [], "mux": []})
            bucket["mux" if g.op == GateOp.MUX else "bs"].append(gi)
        else:
            depth[wire] = arg_depth
    levels = [Level(tuple(level_map[d]["bs"]), tuple(level_map[d]["mux"]))
              for d in sorted(level_map)]
    return levels, depth


def circuit_cost(circuit: Circuit) -> dict:
    """Bootstrap counts per row, depth in levels and gate count."""
    n_bs = sum(1 for g in circuit.gates if g.op in BOOTSTRAP_GATES)
    n_mux = sum(1 for g in circuit.gates if g.op == GateOp.MUX)
    levels, _ = levelize(circuit)
    return {"bootstraps_per_row": n_bs + 2 * n_mux, "depth": len(levels),
            "gates": len(circuit.gates)}


def compile_circuit(circuit: Circuit, dsk: DeviceServerKey,
                    engine: str = "mega13",
                    device: str | torch.device = "cuda",
                    mesh: sharding.Mesh | None = None
                    ) -> Callable[[object], torch.Tensor]:
    """Returns fn: inputs [rows, num_input_bits, n+1] -> outputs [rows,
    num_output_bits, n+1] int32 carrier on ``device`` (output columns' bits
    concatenated in declaration order, LSB-first).  The levels are planned
    once here; each call runs one gate batch (and one mux batch where the
    level has MUX gates) per level.

    With a ``mesh`` (``dsk`` a ``DeviceServerKey`` or its
    ``mesh.sharding.shard_server_key``), the rows are padded with copies
    of row 0 to a multiple of the batch axis and split over it (a
    reduce fold's tail shrinks below the axis); each batch position runs
    the levels on its share, over its line's limb positions, and the
    output comes back to ``device``, cut to the rows given."""
    circuit.validate()
    if mesh is not None:
        return _compile_on_mesh(circuit, dsk, engine, device, mesh)
    dev = dsk.check_device(resolve_device(device))
    p = dsk.params
    n_in = circuit.num_input_bits
    levels, _ = levelize(circuit)
    level_ids = [torch.tensor([_OP_TO_GATE_ID[circuit.gates[gi].op]
                               for gi in lv.bootstrap_gates], device=dev)
                 for lv in levels]
    out_wires = [w for col in circuit.output_columns for w in col.wires]

    def run(inputs) -> torch.Tensor:
        inputs = to_device(inputs, dev)
        rows = inputs.shape[0]
        wires: dict[int, torch.Tensor] = {w: inputs[:, w, :]
                                          for w in range(n_in)}

        def sweep_linear() -> None:
            """Materialize NOT/CONST wires whose args are ready."""
            for gi, g in enumerate(circuit.gates):
                wire = n_in + gi
                if (g.op not in _LINEAR or wire in wires
                        or not all(a in wires for a in g.args)):
                    continue
                if g.op == GateOp.NOT:
                    wires[wire] = gate_ops.gate_not(wires[g.args[0]])
                else:
                    mu = bs.BOOL_MU if g.op == GateOp.CONST_1 else -bs.BOOL_MU
                    ct = torch.zeros(rows, p.n + 1, dtype=I32, device=dev)
                    ct[:, p.n] = u32_const(mu)
                    wires[wire] = ct

        def stack(gis: Sequence[int], arg: int) -> torch.Tensor:
            """[rows * G, n+1]: argument ``arg`` of gates ``gis``, row-major."""
            cols = [wires[circuit.gates[gi].args[arg]] for gi in gis]
            return torch.stack(cols, dim=1).reshape(rows * len(gis), p.n + 1)

        def store(gis: Sequence[int], out: torch.Tensor) -> None:
            out = out.reshape(rows, len(gis), p.n + 1)
            for j, gi in enumerate(gis):
                wires[n_in + gi] = out[:, j, :]

        sweep_linear()
        for level, ids in zip(levels, level_ids):
            with tracing.span("lower.level"):
                if level.bootstrap_gates:
                    gis = level.bootstrap_gates
                    batch = gate_ops.GateBatch(ids.repeat(rows),
                                               stack(gis, 0), stack(gis, 1))
                    store(gis, gate_ops.gate_batch(dsk, batch, engine=engine,
                                                   device=dev))
                if level.mux_gates:
                    gis = level.mux_gates
                    store(gis, gate_ops.mux_batch(
                        dsk, stack(gis, 0), stack(gis, 1), stack(gis, 2),
                        engine=engine, device=dev))
                sweep_linear()
        return torch.stack([wires[w] for w in out_wires], dim=1)

    return run


def _compile_on_mesh(circuit: Circuit, dsk, engine: str,
                     device: str | torch.device, mesh: sharding.Mesh
                     ) -> Callable[[object], torch.Tensor]:
    sk = sharding.as_sharded(dsk, mesh)
    dev = sk.source.check_device(resolve_device(device))
    sharding.check_engine(engine, mesh.shape["limb"])
    positions = sharding.batch_positions(mesh)
    lines = {b: sk.line(b) for b, _ in positions if mesh.is_local(b)}
    runs = {b: compile_circuit(circuit, key, engine=engine,
                               device=key.device)
            for b, key in lines.items()}

    def run(inputs) -> torch.Tensor:
        return sharding.map_shards(mesh, positions, to_device(inputs, dev),
                                   lambda pos, rows: runs[pos[0]](rows), dev)

    return run


# ---------------------------------------------------------------------------
# Plaintext evaluation (spec/test oracle)
# ---------------------------------------------------------------------------

def evaluate_plain(circuit: Circuit,
                   rows: Sequence[Sequence[int]]) -> list[dict[str, int]]:
    """Evaluate the circuit on cleartext rows (one int per input column).

    Returns one {output_column_name: int} dict per row: the oracle for
    encrypted evaluation.
    """
    circuit.validate()
    results = []
    for row in rows:
        assert len(row) == len(circuit.input_columns)
        bits: list[int] = []
        for val, col in zip(row, circuit.input_columns):
            bits.extend((int(val) >> i) & 1 for i in range(col.dtype.bit_width))
        for g in circuit.gates:
            a = [bits[x] for x in g.args]
            if g.op == GateOp.AND:
                v = a[0] & a[1]
            elif g.op == GateOp.OR:
                v = a[0] | a[1]
            elif g.op == GateOp.NAND:
                v = 1 - (a[0] & a[1])
            elif g.op == GateOp.NOR:
                v = 1 - (a[0] | a[1])
            elif g.op == GateOp.XOR:
                v = a[0] ^ a[1]
            elif g.op == GateOp.XNOR:
                v = 1 - (a[0] ^ a[1])
            elif g.op == GateOp.NOT:
                v = 1 - a[0]
            elif g.op == GateOp.MUX:
                v = a[1] if a[0] else a[2]
            elif g.op == GateOp.CONST_0:
                v = 0
            else:
                v = 1
            bits.append(v)
        out = {}
        for col in circuit.output_columns:
            val = 0
            for i, w in enumerate(col.wires):
                val |= bits[w] << i
            if col.dtype.signed and bits[col.wires[-1]]:
                val -= 1 << col.dtype.bit_width
            out[col.name] = val
        results.append(out)
    return results
