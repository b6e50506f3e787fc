"""Multi-device sharding on torch — the port of
``herdsman_tpu.mesh.sharding``, the replacement for the reference's
worker-fleet parallelism (round-robin gRPC dispatch, reference
src/execution/worker/grpc/grpc_worker_group.cpp:76-102) and partition
parallelism (SURVEY.md §2.2).

Mesh axes:

- ``batch`` (data parallelism): the ciphertext batch is split into equal
  shares, one a position; no communication.
- ``limb`` (tensor parallelism): the external product's contraction rows,
  the (k+1)*levels GGSW rows, are split; each position holds its share of
  the bootstrapping key (``ROW_SHARDED`` layouts) and computes a partial
  product every step, and the partials are summed exactly in int32, whose
  adds wrap mod 2^32 (``ops.bootstrap.step_rotation``).  Only the
  per-step product engines ``conv_i8`` and ``gather_u32`` take a limb
  axis; the rotation and step engines (``mega*``, ``bt_fused``) and
  ``bt`` run whole on each batch position.

JAX's ``shard_map`` is a single-controller program, and so is this: one
process drives every position of its own, each on its device, and puts
the results back together on the key's device.  Positions on one device
run in order on that device's current stream (``csrc/megaS.cu`` and
``csrc/mega12.cu`` are cooperative launches: two must never contend for
one card), and share its tensors: a key replicated over positions of one
card is one tensor.  A mesh may repeat a device; that is how one card
holds a two-position mesh.  A mesh over several processes
(``mesh.distributed.make_pod_mesh``) runs each process's positions there
and gathers the batch outputs to every process with one ``all_gather``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops import gates as gate_ops
from herdsman_tpu_torch.ops import pbs
from herdsman_tpu_torch.ops.server_key import ROW_SHARDED, DeviceServerKey
from herdsman_tpu_torch.ops.u32 import resolve_device, to_device

_ALL_ENGINES = {**bs.ENGINES, **bs.STEP_ENGINES, **bs.ROTATION_ENGINES}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A [batch, limb] grid of positions.  ``devices[b, l]`` is the
    ``torch.device`` of position (b, l) and ``processes[b, l]`` the rank of
    the process that computes it; ``rank`` is this process's, and
    ``backend`` the ``torch.distributed`` backend that joins the processes
    (None for a mesh of one process)."""

    devices: np.ndarray     # [batch, limb] object array of torch.device
    processes: np.ndarray   # [batch, limb] int
    rank: int = 0
    backend: str | None = None

    axis_names = ("batch", "limb")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, b: int, l: int = 0) -> bool:
        return int(self.processes[b, l]) == self.rank


def device_grid(devices: list[torch.device], limb: int) -> np.ndarray:
    """``devices`` as a [len / limb, limb] object array, row-major."""
    grid = np.empty((len(devices) // limb, limb), dtype=object)
    for i, d in enumerate(devices):
        grid[i // limb, i % limb] = d
    return grid


def make_mesh(batch: int, limb: int = 1, devices=None,
              device: str | torch.device = "cuda") -> Mesh:
    """A (batch, limb) mesh of one process.  Without ``devices``: on CUDA
    the visible cards ``cuda:0 .. cuda:{batch*limb-1}``, and a
    ``ValueError`` naming both counts when fewer are visible; with
    ``device="cpu"``, ``batch*limb`` positions on the CPU.  An explicit
    ``devices`` list may repeat a device (two positions on one card)."""
    n = batch * limb
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * n
    else:
        devices = [resolve_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"a ({batch}, {limb}) mesh needs {n} devices, "
                         f"{len(devices)} are visible")
    return Mesh(device_grid(devices[:n], limb),
                np.zeros((batch, limb), dtype=np.int64))


@dataclasses.dataclass(eq=False)
class ShardedServerKey:
    """A ``DeviceServerKey`` placed on a mesh: ``keys[b, l]`` is position
    (b, l)'s, on its device, with its share of the GGSW rows of the
    ``ROW_SHARDED`` layouts (None at a position another process computes);
    ``source`` is the key placed."""

    source: DeviceServerKey
    mesh: Mesh
    keys: np.ndarray
    _full: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def params(self):
        return self.source.params

    @property
    def device(self) -> torch.device:
        return self.source.device

    def line(self, b: int) -> DeviceServerKey:
        """The key of batch position b: position (b, 0)'s, which with a
        limb axis carries the keys of the whole line (``limb_shards``) and
        none of the ``ROW_SHARDED`` layouts itself, so that a reader that
        ignores the shards fails instead of taking position 0's rows for
        the whole key."""
        line = tuple(self.keys[b])
        if len(line) == 1:
            return line[0]
        return dataclasses.replace(line[0], limb_shards=line,
                                   **dict.fromkeys(ROW_SHARDED))

    def full(self, b: int, l: int) -> DeviceServerKey:
        """Position (b, l)'s key with every GGSW row (batch-parallel work
        on a mesh with a limb axis)."""
        if self.mesh.shape["limb"] == 1:
            return self.keys[b, l]
        dev = self.mesh.devices[b, l]
        if dev not in self._full:
            self._full[dev] = _place(self.source, dev)
        return self._full[dev]


def _place(dsk: DeviceServerKey, device: torch.device,
           rows: slice | None = None) -> DeviceServerKey:
    """``dsk`` on ``device``, the ``ROW_SHARDED`` layouts cut to ``rows``
    (views: a tensor already on ``device`` is not copied)."""
    moved = {}
    for f in dataclasses.fields(dsk):
        t = getattr(dsk, f.name)
        if isinstance(t, torch.Tensor):
            if rows is not None and f.name in ROW_SHARDED:
                t = t[:, rows]
            moved[f.name] = t.to(device)
    return dataclasses.replace(dsk, device=device, **moved)


def shard_server_key(dsk: DeviceServerKey, mesh: Mesh) -> ShardedServerKey:
    """Place key material on the mesh: ``bsk_ext``, ``bsk_conv`` and
    ``bsk_bt`` row-split over ``limb`` on their GGSW-row axis 1, every other
    layout replicated."""
    if dsk.limb_shards is not None:
        raise ValueError("the key is already split over a limb axis")
    limb = mesh.shape["limb"]
    R = dsk.R
    if R % limb:
        raise ValueError(f"{R} GGSW rows of {dsk.params.name} do not split "
                         f"over a limb axis of {limb}")
    share = R // limb
    keys = np.empty(mesh.devices.shape, dtype=object)
    for (b, l), dev in np.ndenumerate(mesh.devices):
        if mesh.is_local(b, l):
            rows = slice(l * share, (l + 1) * share) if limb > 1 else None
            keys[b, l] = _place(dsk, dev, rows)
    return ShardedServerKey(dsk, mesh, keys)


def as_sharded(dsk, mesh: Mesh) -> ShardedServerKey:
    """``dsk`` placed on ``mesh``: as it is if ``shard_server_key`` placed
    it there, else placed now (shard once for repeated calls)."""
    if isinstance(dsk, ShardedServerKey):
        if dsk.mesh is mesh:
            return dsk
        dsk = dsk.source
    return shard_server_key(dsk, mesh)


def check_engine(engine: str, limb: int) -> None:
    """Raise unless ``engine`` serves a limb axis of ``limb`` positions:
    every engine takes a batch axis; only ``bootstrap.LIMB_ENGINES`` a limb
    axis above 1."""
    if engine not in _ALL_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; known: "
                         f"{sorted(_ALL_ENGINES)}")
    if limb > 1 and engine not in bs.LIMB_ENGINES:
        why = ("its kernel contracts all R GGSW rows of a step"
               if engine == "bt" else "it runs the whole rotation or step "
               "on one device")
        raise ValueError(f"engine {engine!r} shards over batch only "
                         f"({why}); a limb axis of {limb} needs one of "
                         f"{bs.LIMB_ENGINES}")


def map_shards(mesh: Mesh, positions: list[tuple[int, int]],
               x: torch.Tensor,
               fn: Callable[[tuple[int, int], torch.Tensor], torch.Tensor],
               out_device: torch.device) -> torch.Tensor:
    """Batch parallelism: x's rows, padded with copies of row 0 to a
    multiple of ``len(positions)``, in equal shares, share i to
    ``positions[i]``; each position of this process runs ``fn(position,
    share)`` (rows first in its output), and the outputs come back to
    ``out_device`` in position order, from every process of the mesh, cut
    to x's rows."""
    B = x.shape[0]
    pad = (-B) % len(positions)
    if pad:
        x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
    share = x.shape[0] // len(positions)
    outs = [fn(pos, x[i * share:(i + 1) * share]).to(out_device)
            for i, pos in enumerate(positions) if mesh.is_local(*pos)]
    out = torch.cat(outs)
    if mesh.backend is not None:
        out = _gather(mesh, positions, out, share)
    return out[:B]


def _gather(mesh: Mesh, positions: list[tuple[int, int]],
            local: torch.Tensor, share: int) -> torch.Tensor:
    """The outputs of every process in rank order, on ``local``'s device:
    one ``all_gather`` of each process's rows padded to the most any
    process holds.  Under gloo, which gathers CPU tensors only, through
    host copies; under nccl on the process's card."""
    ranks = [int(mesh.processes[b, l]) for b, l in positions]
    if ranks != sorted(ranks):
        raise ValueError("the mesh's positions are not in process order")
    world = dist.get_world_size()
    rows = [share * ranks.count(r) for r in range(world)]
    buf = torch.zeros((max(rows),) + tuple(local.shape[1:]),
                      dtype=local.dtype)
    if mesh.backend == "nccl":
        buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
    buf[:local.shape[0]] = local.to(buf.device)
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat([p[:n] for p, n in zip(parts, rows)]).to(local.device)


def batch_positions(mesh: Mesh) -> list[tuple[int, int]]:
    """The first position of each batch line: the shares of batch
    parallelism whose lines sum over their limb positions."""
    return [(b, 0) for b in range(mesh.shape["batch"])]


def bootstrap_bool_sharded(dsk, mesh: Mesh, ct,
                           engine: str = "mega13") -> torch.Tensor:
    """Full sign bootstrap sharded (batch, limb): [B, n+1] -> [B, n+1] on
    the key's device, equal to ``ops.bootstrap.bootstrap_bool_batch``.
    Each batch position runs its share: a rotation or step engine whole on
    its device, a per-step product engine with its line's limb positions
    summing their partial products.  ``ct`` is numpy uint32 or an int32
    carrier tensor."""
    sk = as_sharded(dsk, mesh)
    check_engine(engine, mesh.shape["limb"])
    ct = to_device(ct, sk.device)

    def run(pos, rows):
        key = sk.line(pos[0])
        return bs.bootstrap_bool_batch(key, rows, engine=engine,
                                       device=key.device)

    return map_shards(mesh, batch_positions(mesh), ct, run, sk.device)


def gate_step_sharded(dsk, mesh: Mesh, gate_ids, c1, c2,
                      engine: str = "mega13") -> torch.Tensor:
    """One full herd step on the mesh: the heterogeneous gate linear
    combine, then the sharded bootstrap (``gates.gate_batch``'s outputs)."""
    sk = as_sharded(dsk, mesh)
    dev = sk.device
    lin = gate_ops.gate_linear(sk.params.n,
                               torch.as_tensor(gate_ids, device=dev),
                               to_device(c1, dev), to_device(c2, dev))
    return bootstrap_bool_sharded(sk, mesh, lin, engine=engine)


def pbs_many_batch_sharded(dsk, mesh: Mesh, ct, tables, msg_bits: int,
                           engine: str = "mega12") -> list[torch.Tensor]:
    """k LUTs over the same batch, the batch split over every position of
    the mesh (batch parallelism, each position with the whole key): [B,
    n+1] -> k x [B, n+1] on the key's device, equal to
    ``ops.pbs.pbs_many_batch``.  The shortint and radix front ends take it
    through ``ShortContext(mesh=...)``."""
    sk = as_sharded(dsk, mesh)
    p = sk.params
    k = len(tables)
    if k == 1:
        tv = pbs.lut_test_poly(p, tables[0], msg_bits, device="cpu")
    else:
        tv = pbs.lut_test_poly_many(p, tables, msg_bits, device="cpu")
    ct = to_device(ct, sk.device)

    def run(pos, rows):
        key = sk.full(*pos)
        out = pbs.rotate_extract_switch(key, rows.to(key.device),
                                        tv.to(key.device), engine, k)
        return out.reshape(k, rows.shape[0], -1).transpose(0, 1)

    positions = [pos for pos, _ in np.ndenumerate(mesh.devices)]
    out = map_shards(mesh, positions, ct, run, sk.device)
    return [out[:, j].contiguous() for j in range(k)]


def pbs_batch_sharded(dsk, mesh: Mesh, ct, table, msg_bits: int,
                      engine: str = "mega12") -> torch.Tensor:
    """Single-LUT programmable bootstrap, the batch split over the mesh."""
    return pbs_many_batch_sharded(dsk, mesh, ct, [table], msg_bits,
                                  engine=engine)[0]
