"""ExecutionService — job scheduling, bookkeeping and the executor loop.

Replaces the reference's ExecutionService + Executor pair (reference
src/service/execution_service.cpp, src/execution/executor/executor.cpp):

- schedule_job: validate plan, analyze + lock resources (keys, frames),
  build a job descriptor, FIFO-enqueue, wake the executor thread
  (reference :29-62);
- executor threads drain the queue (the reference's jthread event loop,
  executor.cpp:46-80; `concurrent_workers` threads = the greedy
  slot-filling up to concurrent_workers() of executor.cpp:96-113, so
  queued jobs overlap when the herd has capacity). Where the reference
  decomposes stages into per-partition tasks dispatched over gRPC
  workers, here a job is executed as XLA dataflow
  (compiler.stages.PlanCompiler) — the per-stage "task" counts are still
  recorded for API parity;
- retry classification matches executor.cpp:136-178: transient failures
  (the TIME_OUT class) retry up to RETRY_LIMIT = 3
  (include/execution/executor/executor.hpp:17); deterministic validation
  errors (the ERROR class — MappingError, missing objects) fail the job
  immediately without burning retries;
- job states WAITING_FOR_EXECUTION / PENDING / COMPLETED / FAILED
  (herd_common JobStatus, usage reference :41,235,360,370);
- on terminal states, locked resources are RELEASED — fixing the
  reference's key/frame lock leaks (SURVEY.md §2.1).

estimated_complexity is the job's total gate-bootstrap count (the reference
returns 0 with a TODO, reference :60).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import queue
import threading
import uuid as uuid_mod
from typing import Callable, Optional

from herdsman_tpu_torch.circuit.model import MappingError
from herdsman_tpu_torch.circuit.plan import ExecutionPlan
from herdsman_tpu_torch.compiler.analyzer import analyze_required_resources
from herdsman_tpu_torch.service.errors import (ObjectNotFoundException,
                                         TaskFailedException)
from herdsman_tpu_torch.service.keystore import KeyService
from herdsman_tpu_torch.service.storage import StorageService
from herdsman_tpu_torch.utils import tracing

log = logging.getLogger("herdsman.execution")

RETRY_LIMIT = 3  # reference include/execution/executor/executor.hpp:17

# The reference fails a job immediately on worker ERROR and retries only
# TIME_OUT (executor.cpp:136-178).  The analog here: deterministic
# validation/semantic errors are terminal; anything else is presumed
# transient and retried.
TERMINAL_ERRORS = (MappingError, ObjectNotFoundException,
                   TaskFailedException)


class JobStatus(enum.IntEnum):
    WAITING_FOR_EXECUTION = 0
    PENDING = 1
    COMPLETED = 2
    FAILED = 3


@dataclasses.dataclass
class JobDescriptor:
    job_uuid: str
    session_uuid: str
    plan: ExecutionPlan
    concurrency_limit: int
    status: JobStatus = JobStatus.WAITING_FOR_EXECUTION
    message: str = ""
    estimated_complexity: int = 0
    retries: int = 0
    tasks_executed: int = 0
    bootstraps_executed: int = 0
    wall_time_s: float = 0.0
    output_frames: dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def bootstraps_per_sec(self) -> float:
        return (
            self.bootstraps_executed / self.wall_time_s
            if self.wall_time_s > 0 else 0.0
        )


# A job runner executes the plan against storage and returns
# (tasks, bootstraps, {output_node_id: frame_uuid}).
JobRunner = Callable[[JobDescriptor], tuple[int, int, dict[int, str]]]


class ExecutionService:
    def __init__(
        self,
        key_service: KeyService,
        storage_service: StorageService,
        runner: Optional[JobRunner] = None,
        journal_path: Optional[str] = None,
        concurrent_workers: int = 1,
    ):
        self._keys = key_service
        self._storage = storage_service
        self._runner = runner
        self._lock = threading.RLock()
        self._jobs: dict[str, list[JobDescriptor]] = {}  # session -> jobs
        # (job, its open execution.queue span, seconds it waited before a
        # retry); None stops a thread
        self._queue: queue.Queue = queue.Queue()
        self._journal = journal_path
        self._load_journal()
        self._threads = [
            threading.Thread(target=self._executor_loop,
                             name=f"herdsman-executor-{i}", daemon=True)
            for i in range(max(1, int(concurrent_workers)))
        ]
        for t in self._threads:
            t.start()

    # ---- durability (the reference loses all job state on restart,
    #      SURVEY.md §5 checkpoint/resume) ----

    def _journal_write(self, job: JobDescriptor) -> None:
        if not self._journal:
            return
        import json

        rec = {
            "job_uuid": job.job_uuid,
            "session_uuid": job.session_uuid,
            "status": int(job.status),
            "message": job.message,
            "estimated_complexity": job.estimated_complexity,
            "tasks_executed": job.tasks_executed,
            "bootstraps_executed": job.bootstraps_executed,
            "wall_time_s": job.wall_time_s,
            "output_frames": job.output_frames,
            "plan": job.plan.to_json(),
        }
        with open(self._journal, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _load_journal(self) -> None:
        if not self._journal:
            return
        import json
        import os

        if not os.path.exists(self._journal):
            return
        latest: dict[str, JobDescriptor] = {}
        with open(self._journal) as f:
            for line in f:
                if not line.strip():
                    continue
                r = json.loads(line)
                status = JobStatus(r["status"])
                if status not in (JobStatus.COMPLETED, JobStatus.FAILED):
                    # a non-terminal record from a crashed run
                    status = JobStatus.FAILED
                    r["message"] = r.get("message") or "coordinator restarted"
                latest[r["job_uuid"]] = JobDescriptor(
                    job_uuid=r["job_uuid"],
                    session_uuid=r["session_uuid"],
                    plan=ExecutionPlan.from_json(r["plan"]),
                    concurrency_limit=1,
                    status=status,
                    message=r.get("message", ""),
                    estimated_complexity=r.get("estimated_complexity", 0),
                    tasks_executed=r.get("tasks_executed", 0),
                    bootstraps_executed=r.get("bootstraps_executed", 0),
                    wall_time_s=r.get("wall_time_s", 0.0),
                    output_frames={
                        int(k): v
                        for k, v in r.get("output_frames", {}).items()
                    },
                )
        for job in latest.values():
            self._jobs.setdefault(job.session_uuid, []).append(job)

    def set_runner(self, runner: JobRunner) -> None:
        """Closes the service<->executor wiring cycle (the reference wires
        set_worker_group/set_executor in src/main.cpp:122-128)."""
        self._runner = runner

    # ---- scheduling ----

    def schedule_job(self, session_uuid: str, plan: ExecutionPlan,
                     concurrency_limit: int = 1) -> JobDescriptor:
        plan.validate()
        req = analyze_required_resources(plan)

        with self._lock:
            for frame_uuid in req.required_data_frames:
                if not self._storage.data_frame_exists(session_uuid, frame_uuid):
                    raise ObjectNotFoundException(
                        f"no data frame {frame_uuid}"
                    )
                entry = self._storage.get_data_frame(session_uuid, frame_uuid)
                if not entry.uploaded:
                    raise MappingError(
                        f"data frame {frame_uuid} is not fully uploaded"
                    )
            for schema in req.required_keys:
                if not self._keys.key_exists(session_uuid, schema):
                    raise ObjectNotFoundException(
                        f"no {schema.name} key in session {session_uuid}"
                    )
            # lock resources (reference :120-131)
            for schema in req.required_keys:
                self._keys.lock_key(session_uuid, schema)
            for frame_uuid in req.required_data_frames:
                self._storage.lock_data_frame(session_uuid, frame_uuid)

            from herdsman_tpu_torch.compiler.lower import circuit_cost
            from herdsman_tpu_torch.circuit.plan import MapperStage, ReduceStage

            complexity = 0
            for node in plan.execution_graph:
                st = node.value
                if isinstance(st, (MapperStage, ReduceStage)):
                    complexity += circuit_cost(st.circuit)["bootstraps_per_row"]

            job = JobDescriptor(
                job_uuid=str(uuid_mod.uuid4()),
                session_uuid=session_uuid,
                plan=plan,
                concurrency_limit=concurrency_limit,
                estimated_complexity=complexity,
            )
            self._jobs.setdefault(session_uuid, []).append(job)
            self._journal_write(job)
        self._enqueue(job, 0.0)
        log.info("job %s scheduled (complexity %d)", job.job_uuid, complexity)
        return job

    def _enqueue(self, job: JobDescriptor, waited: float) -> None:
        self._queue.put((job, tracing.begin(
            "execution.queue", job=job.job_uuid, session=job.session_uuid),
            waited))

    # ---- monitoring (reference :66-118) ----

    def _find(self, session_uuid: str, job_uuid: str) -> JobDescriptor:
        for j in self._jobs.get(session_uuid, []):
            if j.job_uuid == job_uuid:
                return j
        raise ObjectNotFoundException(f"no job {job_uuid}")

    def get_job_state(self, session_uuid: str, job_uuid: str) -> JobDescriptor:
        with self._lock:
            return dataclasses.replace(self._find(session_uuid, job_uuid))

    def list_jobs(self, session_uuid: str) -> list[JobDescriptor]:
        with self._lock:
            return [
                dataclasses.replace(j)
                for j in self._jobs.get(session_uuid, [])
            ]

    def describe_job(self, session_uuid: str, job_uuid: str) -> JobDescriptor:
        """Implemented here; the reference leaves it unimplemented
        (reference src/controller/execution_controller.cpp:19-22)."""
        return self.get_job_state(session_uuid, job_uuid)

    def wait_for_job(self, session_uuid: str, job_uuid: str,
                     timeout: float = 300.0) -> JobDescriptor:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.get_job_state(session_uuid, job_uuid)
            if job.status in (JobStatus.COMPLETED, JobStatus.FAILED):
                return job
            time.sleep(0.02)
        raise TimeoutError(f"job {job_uuid} still running")

    # ---- executor loop ----

    def _release_resources(self, job: JobDescriptor) -> None:
        req = analyze_required_resources(job.plan)
        for schema in req.required_keys:
            self._keys.unlock_key(job.session_uuid, schema)
        for frame_uuid in req.required_data_frames:
            self._storage.unlock_data_frame(job.session_uuid, frame_uuid)

    def _executor_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            job, wait, waited = item
            wait.end()
            waited += wait.seconds
            with self._lock:
                job.status = JobStatus.PENDING
            try:
                if self._runner is None:
                    raise RuntimeError("no job runner attached")
                import time as _time

                t0 = _time.monotonic()
                with tracing.job_scope(job.job_uuid):
                    tasks, bootstraps, outputs = self._runner(job)
                wall = _time.monotonic() - t0
                with self._lock:
                    job.tasks_executed = tasks
                    job.bootstraps_executed = bootstraps
                    job.wall_time_s = wall
                    job.output_frames = outputs
                    job.status = JobStatus.COMPLETED
                    self._release_resources(job)
                    self._journal_write(job)
                log.info(
                    "job %s completed (%d tasks, %d bootstraps, %.2fs, "
                    "%.1f bootstraps/s, queued %.2fs)",
                    job.job_uuid, tasks, bootstraps, wall,
                    job.bootstraps_per_sec, waited,
                )
            except Exception as e:  # noqa: BLE001 — job isolation boundary
                with self._lock:
                    job.retries += 1
                    terminal = isinstance(e, TERMINAL_ERRORS)
                    if not terminal and job.retries < RETRY_LIMIT:
                        job.status = JobStatus.WAITING_FOR_EXECUTION
                        log.warning("job %s failed (%s); retry %d/%d",
                                    job.job_uuid, e, job.retries, RETRY_LIMIT)
                        self._enqueue(job, waited)
                    else:
                        # terminal = the reference's ERROR class (fail now,
                        # executor.cpp:168-178); otherwise retries exhausted
                        job.status = JobStatus.FAILED
                        job.message = str(e)
                        self._release_resources(job)
                        self._journal_write(job)
                        log.error("job %s FAILED: %s", job.job_uuid, e)

    def shutdown(self) -> None:
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)
