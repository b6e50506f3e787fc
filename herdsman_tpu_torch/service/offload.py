"""Offload worker group: the LambdaWorkerGroup + FilesystemWatch analog
(reference src/execution/worker/lambda/lambda_http_worker_group.cpp,
src/execution/worker/lambda/filesystem_watch.cpp), the port's copy of
``herdsman_tpu.service.offload``.

Where the coordinator's own runner executes a whole plan as one program
(``service/runner.StorageJobRunner``), this module reproduces the
reference's task-granular serverless dispatch:

- tasks are the reconstructed herd_common ``task_t`` variants, MapTask /
  ReduceTask with data-frame POINTERS, not payloads (the worker reads and
  writes partition files in the shared storage namespace, reference
  lambda_http_worker_group.cpp:69-74); their JSON wire form is the JAX
  package's, key for key;
- dispatch is an HTTP POST of the JSON task to a single endpoint with at
  most ``concurrency_limit`` concurrent connections (the curl-multi
  CURLMOPT_MAX_TOTAL_CONNECTIONS analog, reference :174-191, 282-318);
- completion is detected EITHER by HTTP 200 (reference :19-23) OR by the
  expected output file appearing in shared storage (FilesystemWatch
  polling, reference :244-259), covering fire-and-forget workers;
- a non-200 / connection failure is a TIME_OUT, which the job runner
  retries up to RETRY_LIMIT = 3 before failing the job (reference
  executor.cpp:136-178).

The module is host code: it touches no tensor.  The worker process is
``python -m herdsman_tpu_torch.service.offload_worker`` (the ``hived``
analog), which runs each task's circuit on the card.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import pathlib
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from herdsman_tpu_torch.circuit.model import Circuit, SchemaType
from herdsman_tpu_torch.circuit.plan import (
    ExecutionPlan,
    InputStage,
    MapperStage,
    OutputStage,
    ReduceStage,
)
from herdsman_tpu_torch.compiler.lower import circuit_cost
from herdsman_tpu_torch.compiler.reduce_tree import build_reduce_tree
from herdsman_tpu_torch.compiler.stages import partition_sizes
from herdsman_tpu_torch.service.errors import TaskFailedException
from herdsman_tpu_torch.service.execution import RETRY_LIMIT, JobDescriptor
from herdsman_tpu_torch.service.storage import StorageService

log = logging.getLogger("herdsman.offload")

POLL_INTERVAL_S = 5.0  # reference lambda_http_worker_group.cpp:218
REQUEST_TIMEOUT_S = 120.0  # one POST, the task's work included
TASK_DEADLINE_S = 300.0  # one attempt at a task, by either channel


# ---- the reconstructed herd_common task model (SURVEY.md §2.4) ----


@dataclasses.dataclass(frozen=True)
class TaskKey:
    """(session, job, stage node, part) — the global task identity
    (reference include/model/task.hpp:6-31)."""

    session_uuid: str
    job_uuid: str
    stage_node_id: int
    part: int


@dataclasses.dataclass(frozen=True)
class DataFramePtr:
    uuid: str
    partition: int


@dataclasses.dataclass(frozen=True)
class InputDataFramePtr:
    uuid: str
    partition: int
    row_count: int


@dataclasses.dataclass(frozen=True)
class CryptoKeyPtr:
    schema_type: SchemaType


@dataclasses.dataclass(frozen=True)
class MapTask:
    """reference execution_service.cpp:465-471 construction; fields re-read
    by the lambda worker at lambda_http_worker_group.cpp:70-73."""

    session_uuid: str
    input_ptr: InputDataFramePtr
    output_ptr: DataFramePtr
    key_ptr: CryptoKeyPtr
    circuit: Circuit


@dataclasses.dataclass(frozen=True)
class ReduceTask:
    """reference execution_service.cpp:506-512."""

    session_uuid: str
    input_ptrs: tuple[InputDataFramePtr, ...]
    output_ptr: DataFramePtr
    key_ptr: CryptoKeyPtr
    circuit: Circuit


def task_to_wire(task: MapTask | ReduceTask) -> dict:
    """JSON wire form — the {type, data} POST body of the reference
    (lambda_http_worker_group.cpp:282-318), with the protobuf payload
    replaced by a JSON task."""
    if isinstance(task, MapTask):
        inputs = [task.input_ptr]
        ttype = "MAP"
    else:
        inputs = list(task.input_ptrs)
        ttype = "REDUCE"
    return {
        "type": ttype,
        "session_uuid": task.session_uuid,
        "inputs": [
            {"uuid": p.uuid, "partition": p.partition,
             "row_count": p.row_count}
            for p in inputs
        ],
        "output": {"uuid": task.output_ptr.uuid,
                   "partition": task.output_ptr.partition},
        "key_schema": int(task.key_ptr.schema_type),
        "circuit": task.circuit.to_json(),
    }


class TaskStatus(enum.Enum):
    """reference include/execution/worker/i_worker_group.hpp:12-49."""

    PENDING = "PENDING"
    COMPLETED = "COMPLETED"
    TIME_OUT = "TIME_OUT"
    ERROR = "ERROR"


class TaskHandle:
    """Mutex-guarded, set-once status (reference
    src/execution/worker/i_worker_group.cpp:4-25)."""

    def __init__(self, key: TaskKey):
        self.key = key
        self._lock = threading.Lock()
        self._status = TaskStatus.PENDING
        self._done = threading.Event()

    @property
    def status(self) -> TaskStatus:
        with self._lock:
            return self._status

    def mark(self, status: TaskStatus) -> None:
        with self._lock:
            if self._status is not TaskStatus.PENDING:
                return  # first completion channel wins (HTTP vs file watch)
            self._status = status
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> TaskStatus:
        self._done.wait(timeout)
        return self.status


class FilesystemWatch:
    """Poll-based file-appearance watcher (reference
    src/execution/worker/lambda/filesystem_watch.cpp:33-71): each tick it
    checks which watched files now exist and fires their callbacks."""

    def __init__(self, poll_interval: float = POLL_INTERVAL_S):
        self._interval = poll_interval
        self._lock = threading.Lock()
        self._watched: dict[pathlib.Path, Callable[[], None]] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="herdsman-fswatch", daemon=True)
        self._thread.start()

    def watch_for(self, path: str | pathlib.Path,
                  callback: Callable[[], None]) -> None:
        p = pathlib.Path(path)
        with self._lock:
            self._watched[p] = callback

    def unwatch(self, path: str | pathlib.Path) -> None:
        with self._lock:
            self._watched.pop(pathlib.Path(path), None)

    def _scan_once(self) -> None:
        # Existence of EVERY watched file is checked each tick (cheap at
        # this scale), where the reference waits for a parent directory's
        # mtime to change: a file written within the same mtime-granularity
        # tick would otherwise be missed until some later directory change.
        fired: list[Callable[[], None]] = []
        with self._lock:
            for p in list(self._watched):
                if p.exists():
                    fired.append(self._watched.pop(p))
        for cb in fired:
            cb()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._scan_once()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


class OffloadWorkerGroup:
    """IWorkerGroup over an HTTP offload endpoint (the LambdaWorkerGroup
    analog).  `concurrency_limit` caps concurrent in-flight POSTs
    (reference CURLMOPT_MAX_TOTAL_CONNECTIONS, :185)."""

    def __init__(self, address: str, concurrency_limit: int,
                 storage: StorageService,
                 poll_interval: float = POLL_INTERVAL_S):
        self._address = address
        self._limit = max(1, int(concurrency_limit))
        self._storage = storage
        self._pool = ThreadPoolExecutor(max_workers=self._limit,
                                        thread_name_prefix="herdsman-offload")
        self._watch = FilesystemWatch(poll_interval)

    def concurrent_workers(self) -> int:
        return self._limit  # reference grpc_worker_group.cpp:107-110 analog

    def schedule_task(self, key: TaskKey,
                      task: MapTask | ReduceTask) -> TaskHandle:
        handle = TaskHandle(key)
        out_path = self._storage.partition_path(
            task.session_uuid, task.output_ptr.uuid,
            task.output_ptr.partition)
        # fire-and-forget completion channel: output file appears
        # (reference :244-259)
        self._watch.watch_for(out_path,
                              lambda: handle.mark(TaskStatus.COMPLETED))
        body = json.dumps(task_to_wire(task)).encode()

        def post() -> None:
            req = urllib.request.Request(
                f"http://{self._address}/task", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=REQUEST_TIMEOUT_S) as r:
                    if r.status == 200:
                        handle.mark(TaskStatus.COMPLETED)
                        self._watch.unwatch(out_path)
                        return
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                log.warning("offload dispatch failed: %s", e)
            # non-200 / connection failure -> retryable TIME_OUT unless the
            # file-watch channel already completed it (reference :19-23)
            if out_path.exists():
                handle.mark(TaskStatus.COMPLETED)
                self._watch.unwatch(out_path)
            else:
                handle.mark(TaskStatus.TIME_OUT)

        self._pool.submit(post)
        return handle

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._watch.stop()


class OffloadJobRunner:
    """Task-granular plan execution over an OffloadWorkerGroup — the
    reference's ExecutionService task decomposition (one map task per
    partition :545-548; reduce tree per policy :560-688) with per-task
    TIME_OUT retry up to RETRY_LIMIT (executor.cpp:136-167).

    Drop-in alternative to StorageJobRunner: the Coordinator selects it
    when the config carries workers.lambda (WORKER_TYPE=lambda)."""

    def __init__(self, storage: StorageService, group: OffloadWorkerGroup):
        self._storage = storage
        self._group = group
        self._job_limit = 1

    def _run_task(self, key: TaskKey, task: MapTask | ReduceTask) -> None:
        for attempt in range(1, RETRY_LIMIT + 1):
            handle = self._group.schedule_task(key, task)
            status = handle.wait(TASK_DEADLINE_S)
            if status is TaskStatus.COMPLETED:
                return
            if status is TaskStatus.ERROR:
                # reference executor.cpp:168-178: fail immediately
                raise TaskFailedException(f"task {key} worker ERROR")
            log.warning("task %s attempt %d/%d -> %s", key, attempt,
                        RETRY_LIMIT, status.value)
        raise TaskFailedException(
            f"task {key} failed after {RETRY_LIMIT} attempts")

    def __call__(self, job: JobDescriptor) -> tuple[int, int, dict[int, str]]:
        session = job.session_uuid
        plan: ExecutionPlan = job.plan
        # per-job concurrency_limit caps in-flight tasks (reference
        # execution_service.cpp:138-165)
        self._job_limit = max(1, job.concurrency_limit)
        key_ptr = CryptoKeyPtr(plan.schema_type)
        produced: dict[int, tuple[str, int, int]] = {}  # nid -> (uuid, rows, parts)
        outputs: dict[int, str] = {}
        total_tasks = 0
        total_bootstraps = 0

        for node in plan.execution_graph.topological_order():
            st = node.value
            nid = node.node_id()
            if isinstance(st, InputStage):
                entry = self._storage.get_data_frame(session,
                                                     st.data_frame_uuid)
                produced[nid] = (entry.uuid, entry.row_count,
                                 entry.partitions)
            elif isinstance(st, MapperStage):
                in_uuid, rows, parts = produced[node.parents()[0].node_id()]
                out_uuid = self._storage.create_data_frame(
                    session, f"intermediate-{job.job_uuid}-{nid}",
                    plan.schema_type, st.circuit.output, rows, parts)
                sizes = partition_sizes(rows, parts)
                tasks = []
                for part, size in enumerate(sizes):
                    tkey = TaskKey(session, job.job_uuid, nid, part)
                    tasks.append((tkey, MapTask(
                        session, InputDataFramePtr(in_uuid, part, size),
                        DataFramePtr(out_uuid, part), key_ptr, st.circuit)))
                self._run_parallel(tasks)
                self._storage.finalize_external_frame(session, out_uuid)
                produced[nid] = (out_uuid, rows, parts)
                total_tasks += len(tasks)
                total_bootstraps += (
                    circuit_cost(st.circuit)["bootstraps_per_row"] * rows)
            elif isinstance(st, ReduceStage):
                in_uuid, rows, parts = produced[node.parents()[0].node_id()]
                sizes = partition_sizes(rows, parts)
                tree = build_reduce_tree(sizes, st.policy, st.per_node_count)
                out_uuid = self._storage.create_data_frame(
                    session, f"reduce-{job.job_uuid}-{nid}",
                    plan.schema_type, st.circuit.output, 1, 1)
                hidden_uuid = None
                if tree.hidden_frame_rows:
                    hidden_uuid = self._storage.create_data_frame(
                        session, f"reduce-hidden-{job.job_uuid}-{nid}",
                        plan.schema_type, st.circuit.output,
                        tree.hidden_frame_rows, tree.hidden_frame_rows)

                def ptr_for(tn) -> InputDataFramePtr:
                    v = tn.value
                    if v.frame == "input":
                        return InputDataFramePtr(in_uuid, v.partition,
                                                 v.row_count)
                    # every completed reduce task folded its inputs to ONE
                    # row in its hidden-frame partition
                    return InputDataFramePtr(hidden_uuid, v.partition, 1)

                ready = list(tree.initial_pending)
                combines = 0
                while ready:
                    layer = []
                    for tree_nid in ready:
                        tn = tree.tree[tree_nid]
                        v = tn.value
                        inputs = tuple(ptr_for(p) for p in tn.parents())
                        out_ptr = (DataFramePtr(out_uuid, 0)
                                   if v.frame == "output"
                                   else DataFramePtr(hidden_uuid,
                                                     v.partition))
                        tkey = TaskKey(session, job.job_uuid, nid, tree_nid)
                        layer.append((tkey, ReduceTask(
                            session, inputs, out_ptr, key_ptr, st.circuit)))
                        combines += max(
                            0, sum(p.row_count for p in inputs) - 1)
                    self._run_parallel(layer)
                    next_ready = []
                    for tree_nid in ready:
                        next_ready.extend(tree.mark_completed(tree_nid))
                    ready = next_ready
                    total_tasks += len(layer)
                if hidden_uuid:
                    self._storage.finalize_external_frame(session,
                                                          hidden_uuid)
                self._storage.finalize_external_frame(session, out_uuid)
                produced[nid] = (out_uuid, 1, 1)
                total_bootstraps += (
                    circuit_cost(st.circuit)["bootstraps_per_row"] * combines)
            elif isinstance(st, OutputStage):
                outputs[nid] = produced[node.parents()[0].node_id()][0]
                produced[nid] = produced[node.parents()[0].node_id()]
        return total_tasks, total_bootstraps, outputs

    def _run_parallel(self, tasks: list[tuple[TaskKey, MapTask | ReduceTask]]
                      ) -> None:
        """Dispatch a dependency-free task layer; each task retries
        independently (the executor's slot refill, executor.cpp:96-113)."""
        if len(tasks) == 1:
            self._run_task(*tasks[0])
            return
        limit = min(max(1, self._group.concurrent_workers()),
                    self._job_limit)
        with ThreadPoolExecutor(max_workers=limit) as pool:
            futs = [pool.submit(self._run_task, k, t) for k, t in tasks]
            for f in futs:
                f.result()
