"""Execution-plan domain model — the herd_common ExecutionPlan analog.

Reconstructed surface (SURVEY.md §2.4; reference usage at
src/service/execution_service.cpp:242-310 and
src/execution/execution_plan/execution_plan_analyzer.cpp:6-22):
a DAG of stages — InputStage{data_frame_uuid} -> Mapper/Reduce stages
carrying circuits -> OutputStage — plus the reduce Policy enum
(reference src/service/execution_service.cpp:590,600,623).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import uuid as uuid_mod
from typing import Optional, Union

from herdsman_tpu_torch.circuit.dag import DAG
from herdsman_tpu_torch.circuit.model import Circuit, MappingError, SchemaType


class Policy(enum.IntEnum):
    SEQUENCED = 0
    PARALLEL = 1
    PARALLEL_FULL = 2


@dataclasses.dataclass(frozen=True)
class InputStage:
    data_frame_uuid: str


@dataclasses.dataclass(frozen=True)
class OutputStage:
    name: str = ""


@dataclasses.dataclass(frozen=True)
class MapperStage:
    circuit: Circuit


@dataclasses.dataclass(frozen=True)
class ReduceStage:
    """Tree/fold reduction. The circuit is a binary row combiner
    (row x row -> row over the same column schema) [inferred — the reference
    circuit internals live in the empty submodule]; per_node_count is the
    reduce-tree fan-in for PARALLEL_FULL (default 2, reference
    src/service/execution_service.cpp:625)."""

    circuit: Circuit
    policy: Policy = Policy.SEQUENCED
    per_node_count: Optional[int] = None


Stage = Union[InputStage, OutputStage, MapperStage, ReduceStage]

_STAGE_TAGS = {
    InputStage: "input",
    OutputStage: "output",
    MapperStage: "map",
    ReduceStage: "reduce",
}


@dataclasses.dataclass
class ExecutionPlan:
    schema_type: SchemaType
    execution_graph: DAG[Stage]

    def validate(self) -> None:
        """Plan-level validation (the to_model/InvalidExecutionPlanError
        analog, reference src/controller/execution_controller.cpp:126-137)."""
        g = self.execution_graph
        if len(g) == 0:
            raise MappingError("empty execution plan")
        g.topological_order()  # raises on cycles
        for node in g:
            st = node.value
            n_par = len(node.parents())
            if isinstance(st, InputStage):
                if n_par != 0:
                    raise MappingError("InputStage must be a source node")
            elif isinstance(st, (MapperStage, ReduceStage)):
                if n_par != 1:
                    raise MappingError(
                        f"{type(st).__name__} needs exactly 1 parent, "
                        f"got {n_par}"
                    )
                st.circuit.validate()
                if isinstance(st, ReduceStage):
                    if st.per_node_count is not None and st.per_node_count < 2:
                        raise MappingError("per_node_count must be >= 2")
            elif isinstance(st, OutputStage):
                if n_par != 1:
                    raise MappingError("OutputStage needs exactly 1 parent")
            else:
                raise MappingError(f"unknown stage {st!r}")
        for node in g.source_nodes():
            if not isinstance(node.value, InputStage):
                raise MappingError("all source stages must be InputStage")

    # ---- serde ----

    def to_dict(self) -> dict:
        g = self.execution_graph
        nodes = []
        for node in g:
            st = node.value
            d: dict = {"kind": _STAGE_TAGS[type(st)]}
            if isinstance(st, InputStage):
                d["data_frame_uuid"] = st.data_frame_uuid
            elif isinstance(st, OutputStage):
                d["name"] = st.name
            elif isinstance(st, MapperStage):
                d["circuit"] = st.circuit.to_dict()
            elif isinstance(st, ReduceStage):
                d["circuit"] = st.circuit.to_dict()
                d["policy"] = int(st.policy)
                if st.per_node_count is not None:
                    d["per_node_count"] = st.per_node_count
            nodes.append(d)
        edges = [
            [node.node_id(), c.node_id()] for node in g for c in node.children()
        ]
        return {
            "schema_type": int(self.schema_type),
            "nodes": nodes,
            "edges": edges,
        }

    @staticmethod
    def from_dict(d: dict) -> "ExecutionPlan":
        try:
            g: DAG[Stage] = DAG()
            for nd in d["nodes"]:
                kind = nd["kind"]
                if kind == "input":
                    st: Stage = InputStage(
                        str(uuid_mod.UUID(nd["data_frame_uuid"]))
                    )
                elif kind == "output":
                    st = OutputStage(nd.get("name", ""))
                elif kind == "map":
                    st = MapperStage(Circuit.from_dict(nd["circuit"]))
                elif kind == "reduce":
                    st = ReduceStage(
                        Circuit.from_dict(nd["circuit"]),
                        Policy(nd.get("policy", 0)),
                        nd.get("per_node_count"),
                    )
                else:
                    raise MappingError(f"unknown stage kind {kind!r}")
                g.emplace(st)
            for s, dst in d["edges"]:
                g.add_edge(g[s], g[dst])
            plan = ExecutionPlan(SchemaType(d["schema_type"]), g)
        except (KeyError, ValueError, TypeError, IndexError) as e:
            raise MappingError(f"malformed plan: {e}") from e
        plan.validate()
        return plan

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "ExecutionPlan":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise MappingError(f"malformed plan json: {e}") from e
        return ExecutionPlan.from_dict(d)
