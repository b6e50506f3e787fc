"""Static gRPC worker fleet — the GrpcWorkerGroup + hived analog
(reference src/execution/worker/grpc/grpc_worker_group.cpp and the
reconstructed herd::proto::Worker contract, SURVEY.md §2.4), the port's
copy of ``herdsman_tpu.service.grpc_worker``.

The reference's PRIMARY worker flavor: a fixed fleet of gRPC workers from
config addresses, one channel + stub per worker with insecure credentials
and 32 MiB message caps (reference grpc_worker_group.cpp:18-30),
round-robin task placement (:102), and asynchronous unary
`Asyncmap`/`Asyncreduce` dispatch whose completions are reaped off a
CompletionQueue thread (:44-68, 85-97).  In Python the CompletionQueue +
reaper jthread collapse to `future.add_done_callback` — grpc-python runs
the callback on its own completion thread, which re-enters the runner
exactly like the reference's reaper re-enters the executor via
`send_event` (executor.cpp:88-93).

Tasks carry circuit + data-frame POINTERS (never payloads): workers share
the coordinator's storage/key namespace and read/write partition files by
path convention (reference lambda_http_worker_group.cpp:69-74 — the same
shared-filesystem data plane both worker flavors use).

The worker daemon half (`make_worker_server`, `python -m
herdsman_tpu_torch.service.grpc_worker`) serves Worker::{map,reduce} on the
card through the HTTP offload worker's engine (``offload_worker._Engine``:
its bounded key cache that follows the key files, its compiled circuits).
Without a card it refuses to start unless it is given ``--device cpu``; a
task whose kernel fails is answered INTERNAL, which fails the job, and the
worker never gives way to a plain version.  The default engine is ``bt``,
as the HTTP worker's, where the JAX worker's is ``conv_i8``; outputs are
array-equal across engines.

Status mapping at the dispatch boundary:
- rpc OK                    -> COMPLETED
- INTERNAL (worker raised)  -> ERROR     (terminal: fails the job,
                                          reference executor.cpp:168-178)
- anything else (UNAVAILABLE, DEADLINE_EXCEEDED, ...) -> TIME_OUT
                                         (retryable <= RETRY_LIMIT,
                                          reference executor.cpp:136-167)

Run: python -m herdsman_tpu_torch.service.grpc_worker \\
        --storage DIR --keys DIR --port P [--engine bt] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import grpc
import torch

from herdsman_tpu_torch.ops.u32 import resolve_device
from herdsman_tpu_torch.service import mappers
from herdsman_tpu_torch.service._proto import CHANNEL_OPTIONS
from herdsman_tpu_torch.service._proto import herdsman_pb2 as pb
from herdsman_tpu_torch.service.offload import (
    MapTask,
    ReduceTask,
    TaskHandle,
    TaskKey,
    TaskStatus,
    task_to_wire,
)
from herdsman_tpu_torch.service.offload_worker import _Engine

log = logging.getLogger("herdsman.grpc_worker")

WORKER_THREADS = 4


class GrpcWorkerGroup:
    """IWorkerGroup over a static gRPC fleet (reference
    grpc_worker_group.cpp:13-110).  Interface-compatible with
    OffloadWorkerGroup so OffloadJobRunner drives either flavor."""

    # RPC deadline: below the runner's 300 s task deadline so a hung
    # worker surfaces as DEADLINE_EXCEEDED -> TIME_OUT retry instead of
    # leaking the RPC (and a worker executor thread) forever
    RPC_TIMEOUT_S = 240.0

    def __init__(self, addresses: list[str]):
        if not addresses:
            raise ValueError("workers.grpc needs at least one address")
        self._channels = [
            grpc.insecure_channel(a, options=CHANNEL_OPTIONS)
            for a in addresses
        ]
        self._map_stubs = [
            ch.unary_unary(
                "/herdsman.Worker/map",
                request_serializer=pb.MapTaskProto.SerializeToString,
                response_deserializer=pb.Empty.FromString,
            )
            for ch in self._channels
        ]
        self._reduce_stubs = [
            ch.unary_unary(
                "/herdsman.Worker/reduce",
                request_serializer=pb.ReduceTaskProto.SerializeToString,
                response_deserializer=pb.Empty.FromString,
            )
            for ch in self._channels
        ]
        self._rr = 0  # round-robin cursor (reference :102)
        self._rr_lock = threading.Lock()

    def concurrent_workers(self) -> int:
        """Scheduler-side concurrency = fleet size — one in-flight task
        per worker slot (reference grpc_worker_group.cpp:107-110)."""
        return len(self._channels)

    def schedule_task(self, key: TaskKey,
                      task: MapTask | ReduceTask) -> TaskHandle:
        handle = TaskHandle(key)
        with self._rr_lock:
            worker = self._rr
            self._rr = (self._rr + 1) % len(self._channels)
        stub = (self._map_stubs if isinstance(task, MapTask)
                else self._reduce_stubs)[worker]
        fut = stub.future(mappers.task_to_proto(task),
                          timeout=self.RPC_TIMEOUT_S)

        def done(f) -> None:
            code = f.code()
            if code == grpc.StatusCode.OK:
                handle.mark(TaskStatus.COMPLETED)
            elif code == grpc.StatusCode.INTERNAL:
                log.warning("task %s worker error: %s", key, f.details())
                handle.mark(TaskStatus.ERROR)
            else:
                log.warning("task %s rpc %s: %s", key, code, f.details())
                handle.mark(TaskStatus.TIME_OUT)

        fut.add_done_callback(done)
        return handle

    def shutdown(self) -> None:
        for ch in self._channels:
            ch.close()


def make_worker_server(storage_dir: str, key_dir: str, port: int = 0,
                       engine: str = "bt", fail_first: int = 0,
                       host: str = "127.0.0.1",
                       device: str | torch.device = "cuda",
                       ) -> tuple[grpc.Server, int]:
    """The hived analog: a gRPC server for Worker::{map,reduce} over the
    shared storage/key namespace, its tasks run on ``device``.  ``engine``
    is a JAX package or port engine name (``service.config.port_engine``).
    ``device`` is resolved here, on the calling thread, before any task is
    served, and raises without a card unless it is ``"cpu"``.
    `fail_first` aborts the first N tasks with UNAVAILABLE (doing no work)
    to exercise the TIME_OUT retry path.  Returns (server, bound_port);
    caller starts/stops; ``server.task_counts["tasks"]`` counts the tasks
    it was sent.  `host` defaults to loopback (channels are insecure); pass
    0.0.0.0 explicitly for a multi-host fleet over a shared filesystem."""
    eng = _Engine(storage_dir, key_dir, engine, resolve_device(device))
    state = {"failed": 0, "tasks": 0}
    state_lock = threading.Lock()

    def _run(to_model, request, context):
        with state_lock:
            state["tasks"] += 1
            inject = state["failed"] < fail_first
            if inject:
                state["failed"] += 1
        if inject:
            context.abort(grpc.StatusCode.UNAVAILABLE, "injected failure")
        # conversion runs INSIDE the INTERNAL boundary: a malformed task
        # (MappingError) is deterministic and must be terminal, not a
        # retryable TIME_OUT
        try:
            eng.run_task(task_to_wire(to_model(request)))
        except Exception as e:  # noqa: BLE001 — worker rpc boundary
            log.exception("task failed")
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        return pb.Empty()

    def do_map(request, context):
        return _run(mappers.map_task_to_model, request, context)

    def do_reduce(request, context):
        return _run(mappers.reduce_task_to_model, request, context)

    handlers = {
        "map": grpc.unary_unary_rpc_method_handler(
            do_map,
            request_deserializer=pb.MapTaskProto.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
        "reduce": grpc.unary_unary_rpc_method_handler(
            do_reduce,
            request_deserializer=pb.ReduceTaskProto.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server = grpc.server(
        ThreadPoolExecutor(max_workers=WORKER_THREADS,
                           thread_name_prefix="herdsman-worker"),
        options=CHANNEL_OPTIONS,
    )
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("herdsman.Worker", handlers),
    ))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.task_counts = state
    return server, bound


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--storage", required=True)
    ap.add_argument("--keys", required=True)
    ap.add_argument("--port", type=int, default=8095)
    ap.add_argument("--engine", default="bt")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 for multi-host fleets; "
                         "default loopback — channels are insecure)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    server, port = make_worker_server(args.storage, args.keys, args.port,
                                      args.engine, host=args.host,
                                      device=args.device)
    server.start()
    log.info("grpc worker on %s:%d", args.host, port)
    try:
        server.wait_for_termination()
    finally:
        server.stop(None)


if __name__ == "__main__":
    main()
