"""A run across processes of the mesh path: the port of the JAX package's
``scripts/multiprocess_dcn.py``.

Each process joins the others (``init_multihost``: ``torch.distributed``
on ``tcp://COORDINATOR``, gloo on the CPU, nccl on CUDA unless
``--backend`` names one), contributes ``--local-devices`` positions, and
builds the host-major pod mesh over all of them.  Then it runs, across the
process boundary, the sharded gate step and a limb-sum bootstrap on
``conv_i8`` (limb axis 2, inside each process), a map + reduce plan under
the SEQUENCED and PARALLEL_FULL policies through ``PlanCompiler``, a
sharded programmable bootstrap and the ``mega13`` kernel's rotations on a
batch-only mesh.  Every process holds the same keys and plaintexts,
computes its own positions' shares, checks that the gathered outputs (its
shares among them) decrypt exactly, and prints one ``MULTIPROCESS OK``
line, which ends in ``counts=`` and a JSON object: the launches of each
kernel (``ops.kernels.launch_counts``) that this process's share of the
mesh path made, those of the one-device reference run left out.

    python -m herdsman_tpu_torch.mesh._dcn_check --coordinator HOST:PORT \\
        --num-processes 2 --process-id {0,1} [--local-devices 4] \\
        [--device cpu|cuda] [--backend gloo|nccl] [--key FILE]

On CUDA the positions take the visible cards in turn (on a machine with
one card, all of them are on ``cuda:0``; NCCL refuses two ranks on one
card, so such a run names ``--backend gloo``).  ``--key FILE`` (written by
``save_keys``) takes the client and server keys from a file instead of a
TOY keygen from a seed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from herdsman_tpu_torch.core import PARAM_SETS, TOY
from herdsman_tpu_torch.core import reference as ref

SPACE_BITS = 2   # the PBS leg's message space: 4 values and a padding bit


def save_keys(path, ck: ref.ClientKey, sk: ref.ServerKey) -> None:
    """Write a client and server key for ``--key``."""
    np.savez(path, params=ck.params.name, lwe_key=ck.lwe_key,
             glwe_key=ck.glwe_key, bsk=sk.bsk, ksk=sk.ksk)


def load_keys(path) -> tuple[ref.ClientKey, ref.ServerKey]:
    with np.load(path) as z:
        p = PARAM_SETS[str(z["params"])]
        return (ref.ClientKey(p, z["lwe_key"], z["glwe_key"]),
                ref.ServerKey(p, z["bsk"], z["ksk"]))


def _plan(map_c, red_c, frame: str, policy):
    from herdsman_tpu_torch.circuit import (DAG, ExecutionPlan, InputStage,
                                            MapperStage, OutputStage,
                                            ReduceStage, SchemaType)

    g = DAG()
    stages = [g.emplace(InputStage(frame)), g.emplace(MapperStage(map_c)),
              g.emplace(ReduceStage(red_c, policy)),
              g.emplace(OutputStage("out"))]
    for a, b in zip(stages, stages[1:]):
        g.add_edge(a, b)
    return ExecutionPlan(SchemaType.TFHE_BOOL, g)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--key", default=None)
    args = ap.parse_args(argv)

    from herdsman_tpu_torch.circuit import (CircuitBuilder, ColumnMeta,
                                            DataType, Policy)
    from herdsman_tpu_torch.compiler.stages import FrameData, PlanCompiler
    from herdsman_tpu_torch.mesh import (bootstrap_bool_sharded,
                                         gate_step_sharded, init_multihost,
                                         make_pod_mesh, pbs_batch_sharded)
    from herdsman_tpu_torch.ops import bootstrap as bs
    from herdsman_tpu_torch.ops import pbs
    from herdsman_tpu_torch.ops.kernels import launch_counts, wrappers
    from herdsman_tpu_torch.ops.server_key import device_server_key
    from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if not cards:
            raise SystemExit("_dcn_check: --device cuda and no card")
        local = [torch.device("cuda", i % cards)
                 for i in range(args.local_devices)]
        torch.cuda.set_device(local[0])
    else:
        local = [torch.device("cpu")] * args.local_devices
    key_device = local[0]
    if not init_multihost(args.coordinator, args.num_processes,
                          args.process_id, backend=args.backend,
                          device=args.device):
        raise SystemExit("_dcn_check: the run did not come up with more "
                         "than one process")
    pid = args.process_id

    # the same keys and plaintexts in every process
    rng = np.random.default_rng(0xD0C)
    if args.key is None:
        ck, sk = ref.keygen(TOY, rng)
    else:
        ck, sk = load_keys(args.key)
    p = ck.params
    dsk = device_server_key(sk, layouts=("bsk_conv", "bsk_btS"),
                            device=key_device)

    # the limb axis stays inside each process (make_pod_mesh refuses
    # otherwise); the batch axis crosses the process boundary
    limb = 2 if args.local_devices % 2 == 0 else 1
    mesh = make_pod_mesh(limb=limb, devices=local)
    n_global = mesh.size
    batch = mesh.shape["batch"]

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise SystemExit(f"_dcn_check: process {pid}: {what}")

    def decrypt(out: torch.Tensor) -> np.ndarray:
        return ref.lwe_decrypt_bool(ck, to_numpy_u32(out))

    check(n_global == args.num_processes * args.local_devices,
          f"the pod mesh has {n_global} positions")
    for fn in wrappers().values():   # count the mesh path's launches alone
        fn.launches = 0

    # A. the sharded herd step: gate combine + bootstrap with the limb sum
    B = 2 * batch
    bits1 = rng.integers(0, 2, B).astype(bool)
    bits2 = rng.integers(0, 2, B).astype(bool)
    ids = rng.integers(0, 6, B)
    c1 = ref.encrypt_bool(ck, bits1, rng)
    c2 = ref.encrypt_bool(ck, bits2, rng)
    out = gate_step_sharded(dsk, mesh, ids, c1, c2, engine="conv_i8")
    tables = [lambda x, y: x & y, lambda x, y: x | y,
              lambda x, y: not (x and y), lambda x, y: not (x or y),
              lambda x, y: x ^ y, lambda x, y: not (x ^ y)]
    expect = np.array([bool(tables[int(g)](bool(x), bool(y)))
                       for g, x, y in zip(ids, bits1, bits2)])
    check(out.shape == (B, p.n + 1) and np.array_equal(decrypt(out), expect),
          "wrong gate results")

    # B. a bootstrap: batch across processes, limb sum inside each
    out_b = bootstrap_bool_sharded(dsk, mesh, c1, engine="conv_i8")
    check(np.array_equal(decrypt(out_b), bits1), "wrong bootstrap")

    # C. map + reduce plans on the batch-only mesh, SEQUENCED over 2
    # partitions and PARALLEL_FULL over 3 (the k-ary remainder promotion of
    # the reduce tree, reference execution_service.cpp:664-686)
    dp = make_pod_mesh(limb=1, devices=local)
    cols = (ColumnMeta("a", DataType.UINT8),)
    cb = CircuitBuilder(cols)
    cb.output("x", ~cb.input_column("a"))
    rb = CircuitBuilder((ColumnMeta("x", DataType.UINT8),) * 2)
    rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(1))
    compiler = PlanCompiler(dsk, engine="mega13", mesh=dp)
    for policy, parts in ((Policy.SEQUENCED, 2), (Policy.PARALLEL_FULL, 3)):
        vals = rng.integers(0, 256, parts * n_global)
        enc = np.stack([ref.encrypt_bool(ck, (vals >> t) & 1 == 1, rng)
                        for t in range(8)], axis=1)
        frames = {"in": FrameData(cols, from_numpy_u32(enc, key_device),
                                  parts)}
        result = compiler.execute(_plan(cb.build(), rb.build(), "in",
                                        policy), frames)
        [frame] = result.outputs.values()
        got_bits = np.stack([decrypt(frame.data[:, t]) for t in range(8)],
                            axis=1)
        got = int((got_bits[0].astype(np.int64) << np.arange(8)).sum())
        want = 0
        for v in vals:
            want ^= ~int(v) & 0xFF
        check(got == want, f"{policy.name} plan output {got} != {want}")

    # D. a programmable bootstrap over every position, a batch that is not
    # a multiple of their count (padded and cut back)
    table = [(3 * m + 1) % 4 for m in range(4)]
    msgs = rng.integers(0, 4, n_global + 3)
    ct_p = ref.lwe_encrypt_raw(ck, pbs.encode(p, msgs, SPACE_BITS), rng)
    out_p = pbs_batch_sharded(dsk, dp, ct_p, table, SPACE_BITS,
                              engine="mega13")
    got_p = pbs.decode(p, ref.lwe_phase(ck.lwe_key, to_numpy_u32(out_p)),
                       SPACE_BITS)
    check(np.array_equal(got_p, [table[m] for m in msgs]), "wrong PBS")

    # E. the mega13 kernel's rotations on the batch-only mesh, equal to one
    # device's and decrypted
    bits13 = rng.integers(0, 2, 2 * n_global).astype(bool)
    ct13 = ref.encrypt_bool(ck, bits13, rng)
    out13 = bootstrap_bool_sharded(dsk, dp, ct13, engine="mega13")
    counts = launch_counts()   # the one-device run below is the reference
    single = bs.bootstrap_bool_batch(dsk, ct13, engine="mega13",
                                     device=key_device)
    check(torch.equal(out13, single), "mega13 shards != one device's")
    check(np.array_equal(decrypt(out13), bits13), "wrong mega13 decrypt")

    print(f"MULTIPROCESS OK: process {pid}/{args.num_processes}, "
          f"{n_global} positions, mesh {tuple(mesh.devices.shape)} over "
          f"{torch.distributed.get_backend()} at {p.name} on {args.device} "
          f"(herd step + limb-sum bootstrap on conv_i8 + map/reduce plan "
          f"[SEQUENCED + PARALLEL_FULL] + sharded PBS + mega13 DP) "
          f"counts={json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
