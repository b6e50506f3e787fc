"""Job runner — bridges disk frames to device execution (the port of
``herdsman_tpu.service.runner``).

The device-side replacement for the reference's worker dispatch: where the
reference's executor round-robins MapTask/ReduceTask rpcs over a gRPC fleet
(reference src/execution/worker/grpc/grpc_worker_group.cpp), this runner
loads the input frames onto the server key's device, executes the plan
(compiler.stages.PlanCompiler) and writes intermediate/output frames back to
storage under the reference's naming scheme ("intermediate-<job>-<node>",
"reduce-<job>-<node>", reference src/service/execution_service.cpp:527,569).

Frames are stored as rows of LWEs, or GLWE-packed (``ops/pack.py``): up to N
LWE bits per (k+1)*N-u32 GLWE, packed on the card from the device-resident
frame and expanded there again on load.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

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
from herdsman_tpu_torch.core.params import TFHEParams
from herdsman_tpu_torch.ops import pack
from herdsman_tpu_torch.ops.server_key import DeviceServerKey
from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.execution import JobDescriptor
from herdsman_tpu_torch.service.storage import StorageService
from herdsman_tpu_torch.utils import rowcodec

log = logging.getLogger("herdsman.runner")


def _packed_partition(p: TFHEParams, pkc: torch.Tensor,
                      flat: torch.Tensor) -> bytes:
    """A partition's LWEs [L, n+1] (on ``pkc``'s device) as the stored
    packed partition: one framed row per GLWE of N LWEs."""
    groups = to_numpy_u32(pack.pack_lwe_rows(p, pkc, flat))
    return rowcodec.frame_rows([g.tobytes() for g in groups])


def pack_frame_partitions_inplace(storage: StorageService,
                                  session_uuid: str, frame_uuid: str,
                                  pkc: torch.Tensor,
                                  params: TFHEParams) -> None:
    """Re-encode an uploaded row-format frame as packed GLWEs in place (per
    partition, keeping the partition row split): the coordinator's
    ``glwe_inputs`` ingest path.  The job runner then loads it through the
    packed branch (``_load_frame_packed``).

    All or nothing: every packed partition is written beside its row
    partition first; only when all of them are written are they renamed
    over the rows and the frame marked packed.  A failure on any partition
    removes what was written and raises, and the frame stays in the row
    format."""
    entry = storage.get_data_frame(session_uuid, frame_uuid)
    if entry.glwe_packed:
        return
    p = params
    staged = []
    try:
        for part in range(entry.partitions):
            payloads = storage.read_partition_rows(session_uuid, frame_uuid,
                                                   part)
            flat = (np.concatenate([
                np.frombuffer(pl, dtype="<u4").reshape(-1, p.n + 1)
                for pl in payloads]) if payloads
                else np.zeros((0, p.n + 1), np.uint32))
            path = storage.partition_path(session_uuid, frame_uuid, part)
            tmp = path.with_name(f"{part}.packed")
            staged.append((tmp, path))
            tmp.write_bytes(_packed_partition(
                p, pkc, from_numpy_u32(flat, pkc.device)))
    except BaseException:
        for tmp, _ in staged:
            tmp.unlink(missing_ok=True)
        raise
    for tmp, path in staged:
        tmp.replace(path)
    storage.set_glwe_packed(session_uuid, frame_uuid)


class StorageJobRunner:
    def __init__(self, storage: StorageService, dsk: DeviceServerKey,
                 engine: str = "mega13", packing_key=None,
                 glwe_frames: bool = True, glwe_outputs: bool = False):
        """``packing_key`` (the session's ``core.reference.PackingKey``)
        enables GLWE-domain intermediate frames: mapper and reduce outputs
        are stored as packed GLWEs ((k+1)*N u32 per N LWE bits, ~192x
        smaller at STD128_K2 than (n+1) u32 per bit) and expanded back to
        n-LWEs on load by extract-all and the key switch
        (``ops.pack.unpack_lwes_batch``).  Output-stage frames stay in the
        row format unless ``glwe_outputs`` is set, which stores them packed
        too (clients then download them with
        ``download_data_frame_packed``; the noise added is the packing
        keyswitch a packed download applies anyway)."""
        self._storage = storage
        self._dsk = dsk
        self._compiler = PlanCompiler(dsk, engine=engine)
        self._glwe_frames = glwe_frames    # pack intermediate frames
        self._glwe_outputs = glwe_outputs  # pack output frames too
        self._pkc = None
        if packing_key is not None:
            if packing_key.params.name != dsk.params.name:
                raise ValueError(
                    f"packing key params {packing_key.params.name} do not "
                    f"match the server key's {dsk.params.name}")
            self._pkc = pack.packing_key_conv(packing_key, device=dsk.device)

    def _load_frame(self, session_uuid: str, frame_uuid: str) -> FrameData:
        entry = self._storage.get_data_frame(session_uuid, frame_uuid)
        total_bits = sum(c.dtype.bit_width for c in entry.columns)
        if entry.glwe_packed:
            return self._load_frame_packed(session_uuid, entry, total_bits)
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

    def _load_frame_packed(self, session_uuid: str, entry,
                           total_bits: int) -> FrameData:
        """Expand a GLWE-packed frame on the card back to [rows, bits,
        n+1] LWEs."""
        p = self._dsk.params
        sizes = partition_sizes(entry.row_count, entry.partitions)
        lwes: list[torch.Tensor] = []
        for part in range(entry.partitions):
            blobs = self._storage.read_partition_rows(
                session_uuid, entry.uuid, part)
            n_lwes = sizes[part] * total_bits
            if not n_lwes:
                continue
            glwes = np.stack([
                np.frombuffer(b, dtype="<u4").reshape(p.k + 1, p.N)
                for b in blobs])
            out = pack.unpack_lwes_batch(
                self._dsk, from_numpy_u32(glwes, self._dsk.device), p.N)
            lwes.append(out[:n_lwes])
        data = torch.cat(lwes).reshape(entry.row_count, total_bits, p.n + 1)
        return FrameData(entry.columns, data, entry.partitions)

    def _store_frame(self, session_uuid: str, name: str,
                     schema_type, frame: FrameData,
                     pack: bool = False) -> str:
        frame_uuid = self._storage.create_data_frame(
            session_uuid, name, schema_type, frame.columns,
            frame.row_count, frame.partitions,
        )
        sizes = partition_sizes(frame.row_count, frame.partitions)
        if pack and self._pkc is not None:
            # packed on the card from the device-resident frame: the only
            # device -> host copy is the GLWEs
            self._store_frame_packed(session_uuid, frame_uuid, frame.data,
                                     sizes)
            return frame_uuid
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

    def _store_frame_packed(self, session_uuid: str, frame_uuid: str,
                            data: torch.Tensor, sizes: list[int]) -> None:
        """``data`` [rows, bits, n+1] on the card; each partition's LWEs
        packed in one call."""
        p = self._dsk.params
        off = 0
        for part, size in enumerate(sizes):
            flat = data[off:off + size].reshape(-1, p.n + 1)
            off += size
            path = self._storage.partition_path(session_uuid, frame_uuid,
                                                part)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(_packed_partition(p, self._pkc, flat))
        self._storage.set_glwe_packed(session_uuid, frame_uuid)

    def _copy_packed_frame(self, session_uuid: str, name: str, schema_type,
                           frame: FrameData, src_uuid: str) -> str:
        """A second catalog entry for an already-packed frame: its
        partition files copied (the same GLWEs, no device work)."""
        frame_uuid = self._storage.create_data_frame(
            session_uuid, name, schema_type, frame.columns,
            frame.row_count, frame.partitions,
        )
        for part in range(frame.partitions):
            src = self._storage.partition_path(session_uuid, src_uuid, part)
            dst = self._storage.partition_path(session_uuid, frame_uuid,
                                               part)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(src.read_bytes() if src.exists() else b"")
        self._storage.set_glwe_packed(session_uuid, frame_uuid)
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
        # an OutputStage's FrameData IS its parent compute stage's frame
        # (stages.py execute), so when both land packed the output store
        # copies the packed partition files instead of packing again
        packed_stored: dict[int, str] = {}  # id(FrameData) -> frame_uuid
        for node in plan.execution_graph:
            st = node.value
            nid = node.node_id()
            if isinstance(st, MapperStage):
                name = f"intermediate-{job.job_uuid}-{nid}"
            elif isinstance(st, ReduceStage):
                name = f"reduce-{job.job_uuid}-{nid}"
            else:
                continue
            fu = self._store_frame(session, name, plan.schema_type,
                                   result.intermediates[nid],
                                   pack=self._glwe_frames)
            if self._glwe_frames and self._pkc is not None:
                packed_stored[id(result.intermediates[nid])] = fu
        for node in plan.execution_graph:
            st = node.value
            nid = node.node_id()
            if isinstance(st, OutputStage):
                name = st.name or f"output-{job.job_uuid}-{nid}"
                frame = result.outputs[nid]
                src = packed_stored.get(id(frame))
                if (self._glwe_outputs and self._pkc is not None
                        and src is not None):
                    outputs[nid] = self._copy_packed_frame(
                        session, name, plan.schema_type, frame, src)
                else:
                    outputs[nid] = self._store_frame(
                        session, name, plan.schema_type, frame,
                        pack=self._glwe_outputs)
        t_store = time.perf_counter()
        log.debug("job %s phases: load %.2fs, compile+exec %.2fs, "
                  "store %.2fs", job.job_uuid, t_load - t0, t_exec - t_load,
                  t_store - t_exec)
        return result.total_tasks, result.total_bootstraps, outputs
