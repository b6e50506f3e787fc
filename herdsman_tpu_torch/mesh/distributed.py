"""Multi-process runtime start-up and the mesh across processes — the port
of ``herdsman_tpu.mesh.distributed`` on ``torch.distributed``.

The reference scales out by adding gRPC workers to a static fleet
(reference src/execution/worker/grpc/grpc_worker_group.cpp:18-30); here
the fleet is one process per host, each driving its own devices.  Two
pieces:

- ``init_multihost()`` joins the processes (``init_process_group`` on
  ``tcp://COORDINATOR_ADDRESS``, from arguments or the environment
  variables ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
  ``PROCESS_ID``); idempotent, and a no-op for a run of one process.
- ``make_pod_mesh()`` lays a ("batch", "limb") mesh over the positions of
  every process, host-major: the batch axis crosses processes and the
  limb axis never does, so the limb sum and the NTT's exchange stay
  inside a process.

Geometry (BASELINE configs: 1 chip / 8 chips 1 host / 16 chips 2 hosts):
``batch = processes * (local positions // limb)``; adding hosts grows the
batch axis, never the limb axis.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from herdsman_tpu_torch.mesh.sharding import Mesh, device_grid
from herdsman_tpu_torch.ops.u32 import resolve_device

log = logging.getLogger(__name__)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: str | torch.device = "cuda") -> bool:
    """Join the processes of a multi-process run.

    Arguments default to the environment variables; with neither (a run of
    one process) this does nothing and returns False.  Returns True when
    more than one process is joined after the call.  ``backend`` defaults
    to ``nccl`` when this process's positions are on CUDA (``device``, the
    card ``torch.cuda.current_device()`` names) and to ``gloo`` when they
    are on the CPU; a backend that cannot start raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("a multi-process run needs a coordinator address, "
                         "a process count and this process's id")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log.info("joined the distributed run: process %d/%d over %s",
             process_id, num_processes, backend)
    return num_processes > 1


def make_pod_mesh(limb: int = 1,
                  devices: Optional[Sequence] = None) -> Mesh:
    """A ("batch", "limb") mesh over the positions of every process,
    host-major.  ``devices`` are this process's positions (it may repeat a
    device), by default the visible cards.  Each process's count comes from
    one ``all_gather_object``; a ``ValueError`` if ``limb`` would cross a
    process."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    counts = [len(devices)] * world
    if world > 1:
        dist.all_gather_object(counts, len(devices))
    if any(c % limb for c in counts) or not all(counts):
        raise ValueError(f"limb={limb} would cross a process boundary "
                         f"(positions per process {counts})")
    # another process's positions are named by its rank only: this
    # process never places anything there
    everyone = [d for r, c in enumerate(counts)
                for d in (devices if r == rank
                          else [torch.device("meta")] * c)]
    owner = np.repeat(np.arange(world), counts)
    return Mesh(device_grid(everyone, limb), owner.reshape(-1, limb),
                rank=rank, backend=dist.get_backend() if world > 1 else None)
