"""Stage-DAG execution: lowers an ExecutionPlan to batched device programs —
the port of ``herdsman_tpu.compiler.stages``.

Replaces the reference's task-queue machinery (ExecutionService stage
progress + Executor event loop + worker dispatch, reference
src/service/execution_service.cpp:242-705, src/execution/executor/executor.cpp)
with direct dataflow execution: a Mapper stage is ONE batched circuit program
over all rows of the parent frame (the reference instead emits one task per
partition, reference :545-548 — partitioning here only affects storage
layout and reduce-tree shape); a Reduce stage folds rows following the exact
reference reduce-tree for its policy (compiler/reduce_tree.py).

Frames are int32 carrier tensors (``ops.u32``) [rows, bits, n+1] on the
server key's device; the durable disk-backed catalog lives in
``herdsman_tpu_torch.service.storage``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as fwait
from typing import Callable

import numpy as np
import torch

from herdsman_tpu_torch.circuit.dag import DAG
from herdsman_tpu_torch.circuit.model import Circuit, ColumnMeta, MappingError
from herdsman_tpu_torch.circuit.plan import (
    ExecutionPlan,
    InputStage,
    MapperStage,
    OutputStage,
    ReduceStage,
)
from herdsman_tpu_torch.compiler.lower import circuit_cost, compile_circuit
from herdsman_tpu_torch.compiler.optimizer import optimize_circuit
from herdsman_tpu_torch.compiler.reduce_tree import build_reduce_tree
from herdsman_tpu_torch.mesh.sharding import Mesh, shard_server_key
from herdsman_tpu_torch.ops.server_key import DeviceServerKey
from herdsman_tpu_torch.utils import tracing


def partition_sizes(row_count: int, partitions: int) -> list[int]:
    """The reference partition-size formula: rows//parts, first rows%parts
    partitions get +1 (reference src/service/storage_service.cpp:121-147,
    321-332)."""
    chunk = row_count // partitions
    rem = row_count % partitions
    return [chunk + (1 if i < rem else 0) for i in range(partitions)]


@dataclasses.dataclass
class FrameData:
    """An in-memory encrypted data frame: [rows, bits, n+1] int32 carrier."""

    columns: tuple[ColumnMeta, ...]
    data: torch.Tensor
    partitions: int

    @property
    def row_count(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass
class StageResult:
    frame: FrameData
    tasks: int              # reference-equivalent task count for the stage
    bootstraps: int         # total gate bootstraps executed


@dataclasses.dataclass
class PlanExecution:
    outputs: dict[int, FrameData]       # output-stage node_id -> frame
    intermediates: dict[int, FrameData]  # stage node_id -> produced frame
    total_tasks: int
    total_bootstraps: int


def _check_circuit_inputs(circuit: Circuit, columns: tuple[ColumnMeta, ...],
                          doubled: bool = False) -> None:
    expect = tuple(columns) * 2 if doubled else tuple(columns)
    got = tuple(circuit.input_columns)
    if tuple(c.dtype for c in got) != tuple(c.dtype for c in expect):
        raise MappingError(
            f"circuit input schema {[c.dtype.name for c in got]} does not "
            f"match frame schema {[c.dtype.name for c in expect]}"
        )


class PlanCompiler:
    """Compiles and executes ExecutionPlans against a device server key."""

    def __init__(self, dsk: DeviceServerKey, engine: str = "mega13",
                 optimize: bool = True, mesh: Mesh | None = None):
        self.dsk = dsk
        self.engine = engine
        self.optimize = optimize
        # shard plan rows over the mesh's batch axis (the key placed once)
        self.mesh = mesh
        self._key = dsk if mesh is None else shard_server_key(dsk, mesh)
        # circuit (STRUCTURAL key: Circuit is a frozen dataclass, equal
        # circuits hash equal) -> (planned fn, circuit actually compiled),
        # so a plan deserialized from the wire reuses the levels planned
        # for an equal one; kept across jobs by the runner
        self._circuit_cache: dict[Circuit, tuple[Callable, Circuit]] = {}
        self._cache_lock = threading.Lock()  # branch threads share the cache

    def _compiled(self, circuit: Circuit) -> tuple[Callable, Circuit]:
        key = circuit
        with self._cache_lock:
            if key not in self._circuit_cache:
                tracing.count("compiler.cache_miss")
                with tracing.span("compiler.compile"):
                    lowered = (optimize_circuit(circuit) if self.optimize
                               else circuit)
                    self._circuit_cache[key] = (
                        compile_circuit(lowered, self._key,
                                        engine=self.engine,
                                        device=self.dsk.device,
                                        mesh=self.mesh),
                        lowered,
                    )
            return self._circuit_cache[key]

    # ---- stage executors ----

    def run_mapper(self, stage: MapperStage, parent: FrameData) -> StageResult:
        _check_circuit_inputs(stage.circuit, parent.columns)
        fn, lowered = self._compiled(stage.circuit)
        # the result stays on the device; the sync point is the storage
        # boundary (runner._store_frame)
        out = fn(parent.data)
        cost = circuit_cost(lowered)  # bootstraps actually executed
        frame = FrameData(stage.circuit.output, out, parent.partitions)
        return StageResult(
            frame,
            tasks=parent.partitions,  # reference: one map task per partition
            bootstraps=cost["bootstraps_per_row"] * parent.row_count,
        )

    def run_reduce(self, stage: ReduceStage, parent: FrameData) -> StageResult:
        _check_circuit_inputs(stage.circuit, parent.columns, doubled=True)
        fn, lowered = self._compiled(stage.circuit)
        cost = circuit_cost(lowered)  # bootstraps actually executed
        n_combines = 0

        def combine(a, b):
            """Apply the binary combiner circuit to row batches [B, bits, n+1]."""
            nonlocal n_combines
            n_combines += a.shape[0]
            return fn(torch.cat([a, b], dim=1))

        def fold_rows(rows):
            """Left-fold a [R, bits, n+1] group to one row, pairwise-batched:
            each pass halves the count by combining adjacent pairs (the tree
            shape within a task is an implementation detail of the worker in
            the reference; pairwise balanced folding minimizes depth)."""
            while rows.shape[0] > 1:
                m = rows.shape[0] // 2
                combined = combine(rows[0:2 * m:2], rows[1:2 * m:2])
                rows = (torch.cat([combined, rows[2 * m:]], dim=0)
                        if rows.shape[0] % 2 else combined)
            return rows

        sizes = partition_sizes(parent.row_count, parent.partitions)
        tree = build_reduce_tree(sizes, stage.policy, stage.per_node_count)

        data = parent.data
        offsets = np.cumsum([0] + sizes)
        node_rows: dict[int, torch.Tensor] = {}
        # input-layer nodes carry their partition's rows
        for node in tree.tree:
            v = node.value
            if v.frame == "input":
                node_rows[node.node_id()] = data[
                    offsets[v.partition]: offsets[v.partition] + v.row_count
                ]

        # execute tasks honoring the dependency-release order
        ready = list(tree.initial_pending)
        done: set[int] = set()
        while ready:
            nid = ready.pop(0)
            parents = tree.tree[nid].parents()
            gathered = torch.cat([node_rows[p.node_id()] for p in parents],
                                 dim=0)
            node_rows[nid] = fold_rows(gathered)
            done.add(nid)
            ready.extend(tree.mark_completed(nid))
        assert tree.output_node in done or tree.total_tasks() == 0

        out_rows = node_rows[tree.output_node]
        frame = FrameData(stage.circuit.output, out_rows, 1)
        return StageResult(
            frame,
            tasks=tree.total_tasks(),
            bootstraps=cost["bootstraps_per_row"] * n_combines,
        )

    # ---- plan executor ----

    def _run_stage(self, st, nid: int,
                   produced: dict[int, FrameData], parents) -> StageResult:
        if isinstance(st, MapperStage):
            return self.run_mapper(st, produced[parents[0].node_id()])
        if isinstance(st, ReduceStage):
            return self.run_reduce(st, produced[parents[0].node_id()])
        raise MappingError(f"unexpected stage {type(st).__name__}")

    def execute(
        self,
        plan: ExecutionPlan,
        frames: dict[str, FrameData],
        max_parallel: int = 1,
    ) -> PlanExecution:
        """Dependency-ordered plan execution.

        ``max_parallel`` > 1 runs independent ready stages concurrently
        (bounded thread pool) — the reference's concurrent-stage semantics
        (ready stages of a job progress in parallel,
        execution_service.cpp:312-362) with the per-job concurrency_limit
        cap (:138-165).  Each stage's kernels launch on the current CUDA
        stream of its thread."""
        plan.validate()
        g: DAG = plan.execution_graph
        produced: dict[int, FrameData] = {}
        outputs: dict[int, FrameData] = {}
        total_tasks = 0
        total_bootstraps = 0

        # resolve inputs/outputs eagerly; compute stages go to the pool
        deps: dict[int, int] = {}          # nid -> unfinished compute parents
        children: dict[int, list] = {}
        compute_nodes = {}
        for node in g.topological_order():
            st = node.value
            nid = node.node_id()
            if isinstance(st, InputStage):
                if st.data_frame_uuid not in frames:
                    raise MappingError(
                        f"unknown data frame {st.data_frame_uuid}"
                    )
                produced[nid] = frames[st.data_frame_uuid]
            elif isinstance(st, (MapperStage, ReduceStage)):
                compute_nodes[nid] = node
                deps[nid] = sum(
                    1 for p in node.parents() if p.node_id() in compute_nodes
                )
                for p in node.parents():
                    children.setdefault(p.node_id(), []).append(node)

        if max_parallel <= 1 or len(compute_nodes) <= 1:
            for node in g.topological_order():
                st = node.value
                nid = node.node_id()
                if isinstance(st, (MapperStage, ReduceStage)):
                    res = self._run_stage(st, nid, produced, node.parents())
                    produced[nid] = res.frame
                    total_tasks += res.tasks
                    total_bootstraps += res.bootstraps
                elif isinstance(st, OutputStage):
                    outputs[nid] = produced[node.parents()[0].node_id()]
                    produced[nid] = outputs[nid]
            return PlanExecution(outputs, produced, total_tasks,
                                 total_bootstraps)

        # concurrent path: dependency-count release, bounded pool
        lock = threading.Lock()
        ready = [nid for nid, d in deps.items() if d == 0]
        with ThreadPoolExecutor(max_workers=max_parallel) as pool:
            futures = {}
            while ready or futures:
                while ready:
                    nid = ready.pop()
                    node = compute_nodes[nid]
                    # each stage in a copy of this context: its spans
                    # stay the job's (utils/tracing.job_scope)
                    futures[pool.submit(
                        contextvars.copy_context().run, self._run_stage,
                        node.value, nid, produced, node.parents())] = nid
                finished, _ = fwait(futures, return_when=FIRST_COMPLETED)
                for fut in finished:
                    nid = futures.pop(fut)
                    res = fut.result()  # re-raises stage failures
                    with lock:
                        produced[nid] = res.frame
                        total_tasks += res.tasks
                        total_bootstraps += res.bootstraps
                        for child in children.get(nid, []):
                            cid = child.node_id()
                            if cid in deps:
                                deps[cid] -= 1
                                if deps[cid] == 0:
                                    ready.append(cid)

        for node in g.topological_order():
            if isinstance(node.value, OutputStage):
                nid = node.node_id()
                outputs[nid] = produced[node.parents()[0].node_id()]
                produced[nid] = outputs[nid]
        return PlanExecution(outputs, produced, total_tasks, total_bootstraps)
