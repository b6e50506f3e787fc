"""The port's wire module and mappers (``herdsman_tpu_torch.service._proto``,
``service/proto_build.py``, ``service/mappers.py``) against the JAX
package's, on the CPU:

- the port's generated module is byte for byte the JAX package's, its
  descriptor byte-identical, and ``proto_build`` regenerates it as
  committed; both copies load side by side in one process (protobuf's
  default pool takes the second registration of ``herdsman.proto`` only
  because the descriptors are identical) and share the message classes;
- the same plans and tasks give byte-equal ``SerializeToString(
  deterministic=True)`` through both packages' mappers, and decode back to
  equal models (the dto_mappers round trip, reference
  grpc_worker_group.cpp:84,93);
- invalid enums, stages and edges raise ``MappingError`` in both packages.
"""

import pathlib

import pytest

from herdsman_tpu import circuit as jcircuit
from herdsman_tpu.service import mappers as jmappers
from herdsman_tpu.service import offload as joffload
from herdsman_tpu.service.proto_build import load_pb2
from herdsman_tpu_torch import circuit as tcircuit
from herdsman_tpu_torch.service import mappers, offload, proto_build
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb

ROOT = pathlib.Path(__file__).resolve().parent.parent
JPB = load_pb2()


def test_generated_module_is_the_jax_packages():
    port = ROOT / "herdsman_tpu_torch" / "service" / "_proto"
    jax = ROOT / "herdsman_tpu" / "service" / "_proto"
    assert (port / "herdsman_pb2.py").read_bytes() == \
        (jax / "herdsman_pb2.py").read_bytes()
    assert pb.DESCRIPTOR.serialized_pb == JPB.DESCRIPTOR.serialized_pb
    # one registration of herdsman.proto serves both copies
    assert pb.Empty is JPB.Empty and pb is not JPB
    assert pb.__name__ == "herdsman_tpu_torch.service._proto.herdsman_pb2"


def test_proto_build_regenerates_the_committed_module(tmp_path):
    generated = proto_build.build(tmp_path)
    assert generated.read_bytes() == (proto_build.OUT
                                      / "herdsman_pb2.py").read_bytes()


def plan(pkg, policy=None, per_node=2):
    """Input -> Mapper (x = a XOR b, odd = parity(x)) [-> Reduce] ->
    Output, built with package ``pkg``'s circuit model."""
    cols = (pkg.ColumnMeta("a", pkg.DataType.UINT8),
            pkg.ColumnMeta("b", pkg.DataType.UINT8))
    mid = (pkg.ColumnMeta("x", pkg.DataType.UINT8),
           pkg.ColumnMeta("odd", pkg.DataType.BIT))
    mb = pkg.CircuitBuilder(cols)
    xv = mb.input_column("a") ^ mb.input_column("b")
    parity = xv.bits[0]
    for bit in xv.bits[1:]:
        parity = parity ^ bit
    mb.output("x", xv)
    mb.output("odd", parity)
    g = pkg.DAG()
    stages = [g.emplace(pkg.InputStage("frame-uuid")),
              g.emplace(pkg.MapperStage(mb.build()))]
    if policy is not None:
        rb = pkg.CircuitBuilder(mid + mid)
        rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(2))
        rb.output("odd", rb.input_column_at(1).bits[0]
                  & ~rb.input_column_at(3).bits[0])
        stages.append(g.emplace(pkg.ReduceStage(
            rb.build(), pkg.Policy[policy], per_node)))
    stages.append(g.emplace(pkg.OutputStage("result")))
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return pkg.ExecutionPlan(pkg.SchemaType.TFHE_BOOL, g)


@pytest.mark.parametrize("shape", [
    (None, None), ("SEQUENCED", 2), ("PARALLEL", 2), ("PARALLEL", None),
    ("PARALLEL_FULL", 3)])
def test_plan_proto_equals_jax(shape):
    policy, per_node = shape
    ours = mappers.plan_to_proto(plan(tcircuit, policy, per_node))
    theirs = jmappers.plan_to_proto(plan(jcircuit, policy, per_node))
    raw = ours.SerializeToString(deterministic=True)
    assert raw == theirs.SerializeToString(deterministic=True)
    back = mappers.plan_to_model(pb.ExecutionPlanProto.FromString(raw))
    assert back.to_json() == plan(tcircuit, policy, per_node).to_json()
    # and the JAX mapper reads the port's bytes as its own plan
    assert jmappers.plan_to_model(JPB.ExecutionPlanProto.FromString(
        raw)).to_json() == back.to_json()


def tasks(pkg, off, kind):
    circuit = plan(pkg).execution_graph[1].value.circuit
    key = off.CryptoKeyPtr(pkg.SchemaType.TFHE_BOOL)
    out = off.DataFramePtr("frame-out", 3)
    if kind == "map":
        return off.MapTask("sess", off.InputDataFramePtr("frame-in", 1, 42),
                           out, key, circuit)
    return off.ReduceTask(
        "sess", (off.InputDataFramePtr("f1", 0, 7),
                 off.InputDataFramePtr("f2", 2, 1)), out, key, circuit)


@pytest.mark.parametrize("kind", ["map", "reduce"])
def test_task_proto_equals_jax_and_round_trips(kind):
    task = tasks(tcircuit, offload, kind)
    raw = mappers.task_to_proto(task).SerializeToString(deterministic=True)
    assert raw == jmappers.task_to_proto(tasks(
        jcircuit, joffload, kind)).SerializeToString(deterministic=True)
    to_model, proto = ((mappers.map_task_to_model, pb.MapTaskProto)
                       if kind == "map" else
                       (mappers.reduce_task_to_model, pb.ReduceTaskProto))
    assert to_model(proto.FromString(raw)) == task


def test_columns_round_trip():
    cols = (tcircuit.ColumnMeta("a", tcircuit.DataType.UINT8),
            tcircuit.ColumnMeta("flag", tcircuit.DataType.BIT),
            tcircuit.ColumnMeta("w", tcircuit.DataType.INT16))
    protos = mappers.columns_to_proto(cols)
    assert mappers.columns_to_model(protos) == cols
    assert [p.SerializeToString() for p in protos] == [
        p.SerializeToString() for p in jmappers.columns_to_proto(
            tuple(jcircuit.ColumnMeta(c.name, jcircuit.DataType(c.dtype))
                  for c in cols))]


def _bad(case):
    """A wire message of kind ``case`` with one invalid field, and the
    port's and the JAX package's mappers, which must both refuse it."""
    good = mappers.plan_to_proto(plan(tcircuit, "PARALLEL", 2))
    if case == "schema_type":
        good.schema_type = 99
    elif case == "policy":
        good.stages[2].reduce.policy = 99
    elif case == "column_data_type":
        good.stages[1].map.circuit.input_columns[0].data_type = 99
    elif case == "gate_op":
        good.stages[1].map.circuit.gates[0].op = 99
    elif case == "stage_without_variant":
        good.stages.add()
    elif case == "edge":
        good.edges.add(src=0, dst=17)
    elif case == "wire":
        good.stages[1].map.circuit.output_columns[0].wires[0] = 10_000
    elif case == "empty_plan":
        good = pb.ExecutionPlanProto(schema_type=0)
    elif case == "task_key":
        task = mappers.task_to_proto(tasks(tcircuit, offload, "map"))
        task.key.schema_type = 99
        return task, mappers.map_task_to_model, jmappers.map_task_to_model
    elif case == "reduce_task_circuit":
        task = mappers.task_to_proto(tasks(tcircuit, offload, "reduce"))
        task.circuit.gates[0].op = 99
        return (task, mappers.reduce_task_to_model,
                jmappers.reduce_task_to_model)
    return good, mappers.plan_to_model, jmappers.plan_to_model


@pytest.mark.parametrize("case", [
    "schema_type", "policy", "column_data_type", "gate_op",
    "stage_without_variant", "edge", "wire", "empty_plan", "task_key",
    "reduce_task_circuit"])
def test_invalid_messages_raise_mapping_error(case):
    msg, to_model, jax_to_model = _bad(case)
    with pytest.raises(tcircuit.MappingError):
        to_model(msg)
    with pytest.raises(jcircuit.MappingError):
        jax_to_model(type(msg).FromString(msg.SerializeToString()))
