"""Job runner — bridges disk frames to device execution (the port of
``herdsman_tpu.service.runner``, row frames only).

The device-side replacement for the reference's worker dispatch: where the
reference's executor round-robins MapTask/ReduceTask rpcs over a gRPC fleet
(reference src/execution/worker/grpc/grpc_worker_group.cpp), this runner
loads the input frames onto the server key's device, executes the plan
(compiler.stages.PlanCompiler) and writes intermediate/output frames back to
storage under the reference's naming scheme ("intermediate-<job>-<node>",
"reduce-<job>-<node>", reference src/service/execution_service.cpp:527,569).

The JAX package's GLWE-packed frames (``ops/pack.py``) are not ported yet;
the coordinator refuses a configuration that asks for them.
"""

from __future__ import annotations

import logging
import time

import torch

from herdsman_tpu_torch.circuit.model import MappingError
from herdsman_tpu_torch.circuit.plan import (
    InputStage,
    MapperStage,
    OutputStage,
    ReduceStage,
)
from herdsman_tpu_torch.compiler.stages import (
    FrameData,
    PlanCompiler,
    partition_sizes,
)
from herdsman_tpu_torch.ops.server_key import DeviceServerKey
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.execution import JobDescriptor
from herdsman_tpu_torch.service.storage import StorageService

log = logging.getLogger("herdsman.runner")


class StorageJobRunner:
    def __init__(self, storage: StorageService, dsk: DeviceServerKey,
                 engine: str = "mega13"):
        self._storage = storage
        self._dsk = dsk
        self._compiler = PlanCompiler(dsk, engine=engine)

    def _load_frame(self, session_uuid: str, frame_uuid: str) -> FrameData:
        entry = self._storage.get_data_frame(session_uuid, frame_uuid)
        if entry.glwe_packed:
            raise MappingError(
                f"frame {frame_uuid} is GLWE-packed; packed frames need "
                "ops/pack.py, which is not ported yet (ROADMAP queue 1, "
                "item 9)")
        total_bits = sum(c.dtype.bit_width for c in entry.columns)
        payloads: list[bytes] = []
        for part in range(entry.partitions):
            payloads.extend(
                self._storage.read_partition_rows(
                    session_uuid, frame_uuid, part
                )
            )
        data = frame_codec.payloads_to_rows(
            payloads, total_bits, self._dsk.params
        )
        return FrameData(entry.columns,
                         from_numpy_u32(data, self._dsk.device),
                         entry.partitions)

    def _store_frame(self, session_uuid: str, name: str,
                     schema_type, frame: FrameData) -> str:
        frame_uuid = self._storage.create_data_frame(
            session_uuid, name, schema_type, frame.columns,
            frame.row_count, frame.partitions,
        )
        sizes = partition_sizes(frame.row_count, frame.partitions)
        t0 = time.perf_counter()
        data = to_numpy_u32(frame.data)
        t_sync = time.perf_counter()
        off = 0
        for part, size in enumerate(sizes):
            self._storage.write_partition_rows(
                session_uuid, frame_uuid, part,
                frame_codec.rows_to_payloads(data[off:off + size]),
            )
            off += size
        self._storage.mark_data_frame_as_uploaded(session_uuid, frame_uuid)
        log.debug("store %s: device to host %.2fs, codec+write %.2fs",
                  name, t_sync - t0, time.perf_counter() - t_sync)
        return frame_uuid

    def __call__(self, job: JobDescriptor) -> tuple[int, int, dict[int, str]]:
        session = job.session_uuid
        plan = job.plan
        t0 = time.perf_counter()
        input_frames: dict[str, FrameData] = {}
        for node in plan.execution_graph:
            if isinstance(node.value, InputStage):
                fu = node.value.data_frame_uuid
                input_frames[fu] = self._load_frame(session, fu)
        t_load = time.perf_counter()

        # per-job concurrency_limit caps in-flight stages (the reference
        # caps a job's in-flight tasks, execution_service.cpp:138-165)
        result = self._compiler.execute(
            plan, input_frames,
            max_parallel=max(1, job.concurrency_limit))
        if self._dsk.device.type == "cuda":
            # kernels run asynchronously: wait for them here, so that the
            # exec phase below holds the device time and store only the copy
            torch.cuda.synchronize(self._dsk.device)
        t_exec = time.perf_counter()

        outputs: dict[int, str] = {}
        for node in plan.execution_graph:
            st = node.value
            nid = node.node_id()
            if isinstance(st, MapperStage):
                name = f"intermediate-{job.job_uuid}-{nid}"
            elif isinstance(st, ReduceStage):
                name = f"reduce-{job.job_uuid}-{nid}"
            else:
                continue
            self._store_frame(session, name, plan.schema_type,
                              result.intermediates[nid])
        for node in plan.execution_graph:
            st = node.value
            nid = node.node_id()
            if isinstance(st, OutputStage):
                name = st.name or f"output-{job.job_uuid}-{nid}"
                outputs[nid] = self._store_frame(
                    session, name, plan.schema_type, result.outputs[nid])
        t_store = time.perf_counter()
        log.debug("job %s phases: load %.2fs, compile+exec %.2fs, "
                  "store %.2fs", job.job_uuid, t_load - t0, t_exec - t_load,
                  t_store - t_exec)
        return result.total_tasks, result.total_bootstraps, outputs
