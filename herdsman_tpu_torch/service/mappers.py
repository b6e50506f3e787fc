"""proto ⇄ model converters — the dto_mappers analog (the reference's
mappers/ submodule, reconstructed surface at SURVEY.md §2.4: to_proto /
to_model overloads raising MappingError on invalid enums/plans, usage at
reference src/controller/execution_controller.cpp:117-130), the port's copy
of ``herdsman_tpu.service.mappers`` on the port's own ``circuit`` model,
offload task model and generated module."""

from __future__ import annotations

from herdsman_tpu_torch.circuit.dag import DAG
from herdsman_tpu_torch.circuit.model import (
    Circuit,
    ColumnMeta,
    DataType,
    GateNode,
    GateOp,
    MappingError,
    OutputColumn,
    SchemaType,
)
from herdsman_tpu_torch.circuit.plan import (
    ExecutionPlan,
    InputStage,
    MapperStage,
    OutputStage,
    Policy,
    ReduceStage,
    Stage,
)
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb
from herdsman_tpu_torch.service.offload import (
    CryptoKeyPtr,
    DataFramePtr,
    InputDataFramePtr,
    MapTask,
    ReduceTask,
)


# ---------- columns ----------

def columns_to_proto(columns) -> list:
    return [
        pb.ColumnDescriptor(name=c.name, data_type=int(c.dtype))
        for c in columns
    ]


def columns_to_model(protos) -> tuple[ColumnMeta, ...]:
    try:
        return tuple(
            ColumnMeta(c.name, DataType(c.data_type)) for c in protos
        )
    except ValueError as e:
        raise MappingError(f"bad column data_type: {e}") from e


# ---------- circuit ----------

def circuit_to_proto(c: Circuit) -> "pb.Circuit":
    return pb.Circuit(
        input_columns=columns_to_proto(c.input_columns),
        gates=[pb.Gate(op=int(g.op), args=list(g.args)) for g in c.gates],
        output_columns=[
            pb.OutputColumn(
                name=o.name, data_type=int(o.dtype), wires=list(o.wires)
            )
            for o in c.output_columns
        ],
    )


def circuit_to_model(p: "pb.Circuit") -> Circuit:
    try:
        c = Circuit(
            input_columns=columns_to_model(p.input_columns),
            gates=tuple(
                GateNode(GateOp(g.op), tuple(g.args)) for g in p.gates
            ),
            output_columns=tuple(
                OutputColumn(o.name, DataType(o.data_type), tuple(o.wires))
                for o in p.output_columns
            ),
        )
    except ValueError as e:
        raise MappingError(f"bad circuit: {e}") from e
    c.validate()
    return c


# ---------- plan ----------

def plan_to_proto(plan: ExecutionPlan) -> "pb.ExecutionPlanProto":
    g = plan.execution_graph
    stages = []
    for node in g:
        st = node.value
        if isinstance(st, InputStage):
            stages.append(pb.Stage(
                input=pb.InputStageProto(data_frame_uuid=st.data_frame_uuid)
            ))
        elif isinstance(st, OutputStage):
            stages.append(pb.Stage(output=pb.OutputStageProto(name=st.name)))
        elif isinstance(st, MapperStage):
            stages.append(pb.Stage(
                map=pb.MapperStageProto(circuit=circuit_to_proto(st.circuit))
            ))
        elif isinstance(st, ReduceStage):
            rs = pb.ReduceStageProto(
                circuit=circuit_to_proto(st.circuit), policy=int(st.policy)
            )
            if st.per_node_count is not None:
                rs.per_node_count = st.per_node_count
            stages.append(pb.Stage(reduce=rs))
        else:
            raise MappingError(f"unknown stage {st!r}")
    edges = [
        pb.Edge(src=node.node_id(), dst=c.node_id())
        for node in g for c in node.children()
    ]
    return pb.ExecutionPlanProto(
        schema_type=int(plan.schema_type), stages=stages, edges=edges
    )


def plan_to_model(p: "pb.ExecutionPlanProto") -> ExecutionPlan:
    try:
        schema = SchemaType(p.schema_type)
    except ValueError as e:
        raise MappingError(f"bad schema_type: {e}") from e
    g: DAG[Stage] = DAG()
    for st in p.stages:
        kind = st.WhichOneof("stage")
        if kind == "input":
            g.emplace(InputStage(st.input.data_frame_uuid))
        elif kind == "output":
            g.emplace(OutputStage(st.output.name))
        elif kind == "map":
            g.emplace(MapperStage(circuit_to_model(st.map.circuit)))
        elif kind == "reduce":
            try:
                pol = Policy(st.reduce.policy)
            except ValueError as e:
                raise MappingError(f"bad policy: {e}") from e
            g.emplace(ReduceStage(
                circuit_to_model(st.reduce.circuit),
                pol,
                st.reduce.per_node_count
                if st.reduce.HasField("per_node_count") else None,
            ))
        else:
            raise MappingError("stage with no variant set")
    try:
        for e in p.edges:
            g.add_edge(g[e.src], g[e.dst])
    except IndexError as exc:
        raise MappingError(f"bad edge: {exc}") from exc
    plan = ExecutionPlan(schema, g)
    plan.validate()
    return plan


# ---------- worker tasks ----------
# (reference dto_mappers worker.hpp overloads, used at
# grpc_worker_group.cpp:84,93 to serialize MapTask/ReduceTask)

def task_to_proto(task: MapTask | ReduceTask):
    key = pb.CryptoKeyPtrProto(schema_type=int(task.key_ptr.schema_type))
    out = pb.DataFramePtrProto(uuid=task.output_ptr.uuid,
                               partition=task.output_ptr.partition)
    circ = circuit_to_proto(task.circuit)
    if isinstance(task, MapTask):
        return pb.MapTaskProto(
            session_uuid=task.session_uuid,
            input=pb.InputDataFramePtrProto(
                uuid=task.input_ptr.uuid,
                partition=task.input_ptr.partition,
                row_count=task.input_ptr.row_count),
            output=out, key=key, circuit=circ)
    if isinstance(task, ReduceTask):
        return pb.ReduceTaskProto(
            session_uuid=task.session_uuid,
            inputs=[pb.InputDataFramePtrProto(
                uuid=p.uuid, partition=p.partition, row_count=p.row_count)
                for p in task.input_ptrs],
            output=out, key=key, circuit=circ)
    raise MappingError(f"unknown task {task!r}")


def _key_schema(p) -> SchemaType:
    try:
        return SchemaType(p.key.schema_type)
    except ValueError as e:
        raise MappingError(f"bad key schema_type: {e}") from e


def map_task_to_model(p: "pb.MapTaskProto") -> MapTask:
    return MapTask(
        session_uuid=p.session_uuid,
        input_ptr=InputDataFramePtr(p.input.uuid, p.input.partition,
                                    p.input.row_count),
        output_ptr=DataFramePtr(p.output.uuid, p.output.partition),
        key_ptr=CryptoKeyPtr(_key_schema(p)),
        circuit=circuit_to_model(p.circuit))


def reduce_task_to_model(p: "pb.ReduceTaskProto") -> ReduceTask:
    return ReduceTask(
        session_uuid=p.session_uuid,
        input_ptrs=tuple(InputDataFramePtr(q.uuid, q.partition, q.row_count)
                         for q in p.inputs),
        output_ptr=DataFramePtr(p.output.uuid, p.output.partition),
        key_ptr=CryptoKeyPtr(_key_schema(p)),
        circuit=circuit_to_model(p.circuit))
