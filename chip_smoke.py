#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``herdsman_tpu_torch``) on one NVIDIA
GPU, at the parameter set of record, STD128_K2 (n=768, N=512, k=2, bg=2^8,
l=2), at the integer tier's, STD128_SHORTINT (n=768, N=2048, k=1, bg=2^7,
l=3, key switch 2^2 x 12), and at the N=2048 byte-aligned sets
STD128_SHORTINT_B8 (bg=2^8, l=3), STD128_SHORTINT_FAST (bg=2^8, l=2, key
switch 2^3 x 5) and STD128_SHORTINT_L4 (bg=2^8, l=4), at STD128_K4
(n=768, N=256, k=4, bg=2^8, l=2) and at the classic bool set STD128
(n=768, N=1024, k=1, bg=2^7, l=3), with keys made from a seed.  The six
host keygens of the N=2048 sets, STD128_K4 and STD128, path N's seeded
keygen and the packing keys run in worker processes while the card runs
the earlier paths.  Nineteen kernel wrappers
(all twenty TPU kernel bodies) from four CUDA sources; ``mega13``,
``mega14``, ``mega17``, ``mega15`` and ``mega16`` run ``csrc/megaS.cu``
(int8 tensor cores, the key a register operand built from its compact
stream; ``mega17``, ``mega15`` and ``mega16`` are ``mega13``'s kernel
through their own entries), ``mega12``, ``mega7``, ``mega5``, ``mega4``,
``mega6``, ``mega3``, ``mega2`` and ``mega`` (its single window on
``bsk_btk``, each wrapper counted apart) and ``mega11``, ``mega10``,
``mega8`` and ``mega9`` (its doubled window on ``bsk_btk2``) those of
``csrc/mega12.cu``.

    python3 chip_smoke.py [--seed S]

Phases, in order; any failure raises and exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name, the
   versions of grpc and protobuf;
2. build: every kernel under ``herdsman_tpu_torch/csrc/``, one nvcc each,
   all at once;
3. kernel vs plain: the blind-rotation kernel (mega13, on the stream key
   ``bsk_btS``) against its plain PyTorch version on the card, by array
   equality, on the rotation inputs of main path A's gate batch at every
   width the main paths give it (2048, and the adder's 256 and 128) and at
   9 and 1, and two ciphertexts against the NumPy reference;
4. main path A: ``gates.gate_batch`` on 2048 gates of all six kinds;
   decrypted against the truth table, two of them array-compared with the
   NumPy ``bootstrap_bool`` of the same linear combination;
5. main path B: ``compiler.lower.compile_circuit`` on an 8-bit ripple adder
   (a + b, UINT8) over 128 rows, decrypted against ``evaluate_plain``;
6. times (CUDA events, after warm-up) of the kernel at B=2048, 256 and
   128, the key switch, the plain version and both main paths end to end;
   the kernel in turns with its yardsticks at B = 2048 and 256: bt_fused's
   rotation on the same key (array-equal) and mega12 on a random key;
6b. path A's gate batch on ``conv_i8`` (the JAX package's default engine:
   one ``torch._int_mm`` a step against the Toeplitz expansion of the
   compact ``bsk_conv``, no hand-written kernel): the gate outputs
   array-equal to path A's on ``mega13`` and decrypted against the truth
   table, the rotation equal to ``mega13``'s, timed in turns with
   ``mega13`` and bt_fused's rotation at B = 2048 and 256, and one step
   split into the expansion, the product and the rest;
6c. main path S1 and S2, the mesh (``herdsman_tpu_torch.mesh``) with its
   positions on this card (``devices=[cuda:0, cuda:0, ...]``): path A's
   batch through ``gate_step_sharded`` on ``mega13`` over (2, 1) (one
   launch a position), array-equal to path A's output and decrypted, and
   on ``conv_i8`` over (1, 2) and (2, 2) (the limb positions' int32
   partial products summed each step), array-equal to phase 6b's; each
   sub-path of S prints its wall time beside its one-device counterpart's,
   its launches and its peak memory;
7. kernel vs plain for the block-Toeplitz kernels (tolerance 0):
   ``bt_external_product`` (unfused and fused) and ``rotate_decompose``
   against their plain PyTorch versions on the card, on step 0 of the
   gate batch's rotation at B = 2048, 288, 9 and 1, and on one random step
   at STD128's geometry (k=1, N=1024, bg=2^7, l=3) at B = 2048, 9 and 1;
   then
   ``blind_rotate_batch`` with engines ``bt`` and ``bt_fused`` at B=2048
   against mega13's output of phase 3;
8. main path C, the coordinator's job path: a ``Coordinator`` built from an
   in-code ``Config`` with ``workers.mesh.engine = pallas_bt`` (the config
   default) -> authorize -> session -> server key streamed in 64 KiB
   chunks -> 2048 rows of (a, b) UINT8 in 4 partitions, in ~1 MiB chunks
   -> a map (x = a XOR b, odd = parity(x)) + PARALLEL XOR-reduce plan sent
   as JSON -> wait (COMPLETED, no retry) -> download of the output and the
   map's intermediate frame, every row decrypted against the plaintext;
   then the same on a second coordinator with ``pallas_fused``, whose
   frames must equal the first's byte for byte, and which then takes a
   ``TFHE_PACKING`` key and downloads both row frames packed on the card
   (``pack_lwes_batch``, 4 x 512 rows), decrypted as their rows; each
   job's rotation widths with their counts and the host milliseconds per
   step at each width;
8b. the map circuit as submitted (the plan compiler runs the optimized
   one) evaluated in one batch on ``bt_fused`` over the same rows: the
   frame an offload worker must write (paths O, O');
9. times of the block-Toeplitz kernels per step at B=2048 (with bound,
   plain and library times), fused at path C's narrow widths B=288 and 9
   and unfused at STD128's geometry (each with its share of the bound and
   its library yardstick, a ``torch._int_mm`` of the same shapes), the
   per-step kernels also replayed from a CUDA graph (their device time
   without the launches' host cost), a
   B=2048 gate batch on ``bt`` and ``bt_fused``, and path C's jobs with
   the runner's load / exec / store split;
9b. main path H, the j-major family at STD128_K2: path A's gate batch on
    ``mega11``, ``mega10``, ``mega8`` and ``mega9`` (``mega12.cu``'s
    doubled window, on one ``bsk_btk2``), ``mega7``, ``mega5``, ``mega4``,
    ``mega6`` and ``mega3`` (``mega12.cu``'s single window, on one
    ``bsk_btk``), the key of one window built, used and freed in turn, each
    kernel against its plain version (tolerance 0) on the batch's rotation
    inputs at B = 2048, 256, 9 and 1, each output array-equal to
    path A's ``mega13`` output and decrypted against the truth table, with
    times (the kernels of one function in turns) and peak memory;
    ``mega11`` also in turns with ``mega12`` (on a ``bsk_btk`` of the same
    key) and with ``bt_fused``'s rotation on the same inputs at B = 2048
    and 256, all array-equal;
9b'. main path A': path A's gate batch on ``mega14`` (the extended key
    ``bsk_btTe``), the kernel against its plain version at B = 2048, 256,
    128, 9 and 1, the output array-equal to path A's and decrypted, and
    ``mega14``, ``mega16`` and ``mega13`` timed in turns at STD128_K2; then
    each kernel of the j-major family on random inputs and keys at B=9 at
    the geometries of STD128, STD128_FAST, STD128_SHORTINT and STD128_K4,
    ``mega14`` at STD128_FAST's, STD128_K4's, STD128_SHORTINT_FAST's and N
    = 256's, and ``mega13`` at STD128_SHORTINT_FAST's and TOY's, those two
    at B = 2048 and 9, ``mega17``, ``mega15`` and ``mega16`` at their own
    sets' at B = 2048, 300 and 9, and ``mega11`` and ``mega10``, and
    ``mega7``, ``mega5``, ``mega4``, ``mega2`` and ``mega`` (one key and
    one plain rotation shared by each window's wrappers) at STD128_K2's,
    STD128's and STD128_SHORTINT's at B = 2048, 300 (ragged) and 9 (K
    split) (n cut to 32 steps);
9b''. main path L, the classic bool set STD128 (n=768, N=1024, k=1,
    bg=2^7, l=3; host keygen in a worker): path A's 2048-gate batch (the
    same gates and plaintexts) on ``mega13``, decrypted against the truth
    table and one gate against the NumPy ``bootstrap_bool``, the kernel
    against its plain version at B = 2048, 256, 128, 9 and 1; then on
    ``mega10`` (``mega12.cu``'s doubled window, ``bsk_btk2``), then
    ``mega3``, ``mega5`` and ``mega4`` (``mega12.cu``'s single window, on
    one ``bsk_btk``), one key at a time (built, used, freed), each output
    array-equal to ``mega13``'s and decrypted, each kernel equal to
    ``mega13`` and to its plain version (tolerance 0) on the batch's
    rotation inputs at B = 2048, 256 and 9, and timed in turns with the
    others on its key and ``mega13`` at B = 2048 and 256; end-to-end
    seconds, gate bootstraps/s, the kernels' times and the path's peak
    memory;
9c. main path I: path C's job over the rows of its first partition (512
    rows, one partition) on a coordinator whose in-code config names
    ``pallas_mega11``: COMPLETED with no retry, every row decrypted, the
    intermediate frame byte-equal to the first partition of path C's on
    ``pallas_fused``;
9c'. main path S3: path I's plan over its 512 rows through
    ``PlanCompiler(mesh=(2, 1))`` on ``mega11``, both positions on this
    card: the output and intermediate frames equal to path I's;
9d. main path M, the JAX package's R-major legacy engines at STD128_K2:
    M1, path A's gate batch on ``mega`` and ``mega2`` (both
    ``mega12.cu``'s single window on the ``bsk_btk`` that
    ``mega12.kmajor_from_bt`` re-lays from path A's ``bsk_bt`` on the
    card), each kernel against its plain version (tolerance 0) on the
    batch's rotation inputs at B = 2048, 256 and 9 (and on random keys in
    phase 9b' with the others), each ``blind_rotate_batch`` equal to
    ``mega13``'s, each gate batch equal to path A's and decrypted; both
    timed in turns with ``bt_fused`` (the same function on ``bsk_bt``, 2n
    launches) and ``mega7`` (on the same ``bsk_btk``); M2, path I's job on
    ``pallas_mega2`` then ``pallas_mega`` (each ingests ``bsk_btk``), each
    COMPLETED with no retry, launching only its engine, its intermediate
    frame byte-equal to path C's first partition on ``pallas_fused``, with
    wall, load / exec / store seconds, the job's rotations summed (CUDA
    events around each) and peak memory;
10. path D setup: STD128_SHORTINT keys on the host, a ``ShortContext``
    (msg 2 + carry 2 bits) that routes to ``mega12`` and carries the key to
    the card as ``bsk_btk`` (``bsk_btjj`` in ``wgmma``'s byte order); then
    the whole-rotation kernel ``mega12`` (int8 ``wgmma``) against its plain
    PyTorch version (tolerance 0) on D1's first rotation inputs at B =
    2048, 256, 65, 9 and 1, and on random inputs and keys at B=9 at
    STD128_K2's, STD128's and STD128_SHORTINT_L4's geometries;
11. main path D1, shortint: (a*b)+a over 2048 encrypted 2-bit values
    (``bench.py``'s shortint metric), decrypted against the plaintext, then
    the same on a second context on ``mega13`` (same keys and seed), whose
    ciphertexts must equal the first's, ``mega13`` against its plain
    version on D1's first rotation inputs at B = 2048, 256, 128, 9 and 1;
    main path D2, radix: an 8-bit
    multiply (4 blocks of 2 bits) over 256 values on ``mega12``, decrypted
    against (a*b) mod 256, with its rotation widths;
11'. main path S4: D1 on a ``ShortContext(mesh=(2, 1))`` sharing path
    D's keys and key tensors, its ciphertexts equal to D1's, decrypted;
12. times of ``mega12`` per rotation at B=2048 (beside its bound and the
    plain version's time) and at D2's narrow width B=256, each with its
    share of the bound and its tile plan, in turns with ``bt_fused``'s
    rotation (2n launches of ``rotate_decompose`` and the tensor-core
    ``bt_external_product`` on ``bsk_bt``, built for it and freed) on the
    same inputs, whose outputs must be equal; D1 and D2 end to end with
    rotations/s, and the peak device memory of path D;
12b. main path J: D1 on a ``ShortContext(engine="mega7")`` (the JAX
    bench's ``mega12 -> mega7`` step) with path D's keys and seed (key
    ``bsk_btk``), ``mega7`` against its plain version on its first rotation
    inputs at B = 2048, 256, 9 and 1, ciphertexts equal to D1's on
    ``mega12``, ``mega7`` in turns with ``mega12`` on the same key and
    inputs at B = 2048 and 256, with times and peak memory;
13. main path E, the integer tier at STD128_SHORTINT_B8 on ``mega17``
    (``csrc/megaS.cu``): a ``ShortContext`` that routes to ``mega17`` and
    carries the compact ``bsk_btTc`` key to the card; the kernel against
    its plain version (tolerance 0) on E's first rotation inputs at B =
    2048, 256 and 9; D1's
    (a*b)+a over 2048 values, decrypted, then the same on a ``mega12``
    context (same keys and seed) over the first 256 of those ciphertexts,
    whose results must equal the first 256 of E's;
14. main path F, bool gates at STD128_SHORTINT_FAST on ``mega16``
    (``csrc/megaS.cu``): a heterogeneous ``gate_batch`` of 2048 gates, the
    kernel against its plain version on its rotation inputs at B = 2048,
    256 and 9, decrypted against the truth table, then the same batch on
    ``mega13``, whose outputs must be equal;
14b. main path F': F's batch on ``mega14``, the kernel against its plain
    version at B = 2048, 256, 128, 9 and 1, the outputs equal to F's on
    ``mega16``;
15. main path G, the integer tier at STD128_SHORTINT_L4 on ``mega15``, as
    E, with its rerun on ``mega12``;
16. for E, F and G: the kernel's time per rotation at B=2048 (beside its
    bound and the plain version's time) and B=256, the path end to end,
    and the path's peak device memory; the kernel in turns with
    ``mega13``'s entry on the same key bytes and inputs at B = 2048 and
    256 (the same kernel: outputs array-equal, and the spread of two
    timings of one kernel in turns);
17. main path K, the eager API at STD128_K4: ``HerdContext(engine=
    "mega14")`` (``fit_engine`` keeps ``mega14``, only ``bsk_btTe`` is
    built), a + b and min over 2048 encrypted u8 pairs, decrypted against
    (a+b) mod 256 and min(a, b); the kernel against its plain version on a
    + b's first rotation inputs at B = 2048, 256, 128, 9 and 1; a + b again
    on a ``HerdContext(engine="mega13")`` with the same keys and seed, whose
    ciphertexts must be equal; the kernel's time per rotation, in turns
    with ``mega13`` on the same inputs, bt_fused's rotation and ``mega12``
    (random keys) at B = 2048 and 256, the path's gate bootstraps per
    second and its peak device memory;
18. main path N, the coordinator's compact wire path at STD128_K2 on
    ``conv_i8`` (keys from ``keygen_seeded`` and ``make_packing_key`` in a
    worker process): a coordinator whose in-code config has
    ``workers.mesh {engine: conv_i8, glwe_inputs, glwe_frames,
    glwe_outputs}`` takes the compressed server key and the
    ``TFHE_PACKING`` key in 64 KiB chunks and path C's first partition
    (512 rows, as paths I and M2, in 2 partitions) uploaded seeded
    (``encrypt_rows_seeded``, one u32 a bit, in 8 KiB chunks cut
    mid-row, one across the partitions' boundary), packs them at ingest, runs path C's plan to
    COMPLETED with no retry and no hand-written kernel, every frame
    GLWE-packed, and the output and intermediate frames downloaded packed
    decrypt to the plaintext (``decrypt_rows_packed``); with the ingest
    time, the job's load / exec / store split, its rotation widths with the
    host ms per step and the path's peak memory.  Then ``pack_lwes_batch``
    against the NumPy ``pack_lwes`` (tolerance 0) on a group of 512 at
    STD128_K2 and of 512 at STD128 (each from a worker process; both
    groups decrypt), ``conv_i8_correlate`` on saturated inputs whose sums
    pass 2^31 (they wrap mod 2^32, where one ``torch._int_mm`` of them
    saturates), and the pack's time on one partition of path C (512
    rows);
19. main path O, task-granular dispatch: path C's job (2048 rows in 4
    partitions, the same key and upload) on a coordinator whose in-code
    config has ``workers.lambda`` (4 requests in flight), its map and
    reduce tasks served over HTTP by an offload worker
    (``service/offload_worker.make_server``, engine ``pallas_mega13``)
    from a thread of this process, so that its launches count here:
    COMPLETED with no retry, the task count the reduce tree implies,
    ``mega13`` alone launched, the intermediate frame byte-equal to phase
    8b's, every row decrypted; the job's wall time and its rotations' CUDA
    event spans (summed, and their union: the tasks overlap on the stream);
20. main path O', the worker in its own process: ``python -m
    herdsman_tpu_torch.service.offload_worker --device cuda --engine
    pallas_mega13`` serves a map-only job over path C's first partition
    (512 rows); this process launches no kernel, the worker process
    (read through its ``GET /counts`` before and after the job) launches
    ``mega13`` alone, the frame is byte-equal to that partition of phase
    8b's and decrypts; the worker is stopped at the end, also when a check
    fails;
21. main path P, a traced job: path I's job (512 rows, ``pallas_mega11``)
    on a coordinator with ``logging.profile_dir``: exactly one trace under
    ``<profile_dir>/<job_uuid>/``, which parses and holds CUDA kernel
    events of ``csrc/mega12.cu``'s ``mega12_kernel``; the frame byte-equal
    to path I's; the trace's size and the job's time beside path I's;
22. main path Q, the gRPC front end: ``service/api_server.build_server`` on
    a coordinator whose in-code config has ``workers.mesh.engine =
    pallas_fused``, on an insecure loopback port, and a ``HerdClient``
    that authorizes, opens a session, streams the server key (1 MiB
    messages) and C's packing key, uploads path C's 2048 rows in 4
    partitions over the bidi stream, sends C's plan as a proto, waits, and
    downloads the output and intermediate frames and the output packed:
    COMPLETED with no retry, every frame byte-equal to path C's on
    ``pallas_fused`` and decrypted, ``describe_job``'s plan equal to the
    plan sent, ``rotate_decompose`` and the fused ``bt_external_product``
    alone launched, each as often as in path C on ``pallas_fused``; the
    key, upload, job (load / exec / store) and download seconds beside
    C's in-process ones;
23. main path Q', the ``workers.grpc`` fleet: path C's job on a
    coordinator whose config names two ``service/grpc_worker``
    ``make_worker_server(..., engine="pallas_mega13")`` members served from
    threads of this process: COMPLETED with no retry, path O's 9 tasks
    round-robin over both (their ``task_counts``), ``mega13`` alone
    launched as often as in path O, the intermediate frame byte-equal to
    phase 8b's and path O's, every row decrypted; the job's wall time and
    its rotations' CUDA spans summed and in their union beside O's;
24. main path R, BASELINE config 3 (``ops/rns`` on the four-step NTT of
    ``ops/ntt``, whose DFT steps are int8 ``torch._int_mm`` products; no
    hand-written kernel): N = 4096, 3 primes, B = 2048 on the card, as the
    JAX package's ``bench.py --metric rns`` runs it, and N = 2048 (a
    non-square split) over 256: ``ntt_inv(ntt_fwd(x)) == x`` on every limb,
    ``polymul``'s first and last rows equal to the big-int product
    (computed in worker processes) and 8 rows to the port's CPU run;
    ``keyswitch_keygen`` equal to its CPU run; ``key_switch`` of
    [2, 3, 2048, 4096] ciphertexts under s2 (encrypted with the checked
    ``polymul``) to s1: 64 rows decoded through the CRT on the host, every
    message right and the noise below delta/16, two rows' phases equal to
    the big-int ones; times on CUDA events (``ntt_fwd``, its ``_int_mm``
    products, 6 chained dependent polymuls as polymuls/s, ``key_switch``)
    beside ``utils/bounds.py``'s bounds, and the path's peak memory;
25. main path S5: path R's ``ntt_fwd`` and polymul (N = 4096, L = 3, B =
    2048) through ``mesh/ntt_sharded`` with the coefficient matrix split
    over limb axes of 2 and 4 positions of this card, equal to ``ops/rns``'s;
    main path S6: two ``python -m herdsman_tpu_torch.mesh._dcn_check``
    processes, four positions each on this card, joined over gloo (NCCL
    refuses two ranks on one card) with path A's STD128_K2 keys handed over
    in a file: the sharded gate step and a limb-sum bootstrap on
    ``conv_i8``, two map + reduce plans, a sharded PBS and ``mega13`` across
    the process boundary, each process printing ``MULTIPROCESS OK`` and its
    launches, which S6's counts sum.  One card shows placement and
    exactness, not the speed of several cards.

TLS is not run here: the GPU machines have no ``cryptography`` to make
certificates with (the CPU tests run it).

Every kernel's launch counter is set to 0 before each main path and read
after it; the run fails if a path did not launch the kernels of its
engine, or launched another kernel.  The second-to-last line of output is
a JSON object describing every kernel; the last is
``{"ok": true, "device": {...}}``.  The script needs a CUDA card and the
repo's ``herdsman_tpu_torch`` beside it, and imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import logging
import multiprocessing
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B_MAIN = 2048
ROWS = 128
RADIX_VALUES = 256  # path D2: bench.py's radix metric uses B_MAIN
# the widths at which csrc/megaS.cu's kernels (mega13, mega14) are held to
# their plain versions on each path's rotation inputs
WIDTHS_S = (B_MAIN, RADIX_VALUES, ROWS, 9, 1)
JOB_ROWS = 2048
JOB_PARTITIONS = 4
# the parameter sets whose host keys the worker processes make
KEYGEN_SETS = ("std128", "std128_shortint", "std128_shortint_b8",
               "std128_shortint_fast", "std128_shortint_l4", "std128_k4")


def keygen(name: str, seed: int):
    """(client key, server key, seconds) of the parameter set ``name`` from
    ``seed``, on the host (a worker process's job)."""
    from herdsman_tpu_torch.core import PARAM_SETS
    from herdsman_tpu_torch.core import reference as ref
    t0 = time.perf_counter()
    ck, sk = ref.keygen(PARAM_SETS[name], np.random.default_rng(seed))
    return ck, sk, time.perf_counter() - t0


def seeded_keygen(seed: int):
    """Path N's keys at STD128_K2 on the host (a worker process's job): the
    client key and compressed server key of ``keygen_seeded``, the packing
    key, seconds, and one group of N fresh bits with its ciphertexts packed
    by the NumPy ``pack_lwes``."""
    from herdsman_tpu_torch.core import STD128_K2
    from herdsman_tpu_torch.core import reference as ref
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 20)
    ck, csk = ref.keygen_seeded(STD128_K2, rng, seed + 21)
    pk = ref.make_packing_key(ck, rng)
    secs = time.perf_counter() - t0
    bits = rng.integers(0, 2, STD128_K2.N).astype(bool)
    cts = ref.encrypt_bool(ck, bits, rng)
    return ck, csk, pk, secs, bits, cts, ref.pack_lwes(pk, cts)


def packing_group(name: str, seed: int, count: int):
    """A client key of the set ``name``, its packing key, ``count`` fresh
    bits, their ciphertexts and those packed by the NumPy ``pack_lwes`` (a
    worker process's job)."""
    from herdsman_tpu_torch.core import PARAM_SETS
    from herdsman_tpu_torch.core import reference as ref
    p = PARAM_SETS[name]
    rng = np.random.default_rng(seed + 30)
    ck = ref.ClientKey(p, rng.integers(0, 2, p.n, dtype=np.uint32),
                       rng.integers(0, 2, (p.k, p.N), dtype=np.uint32))
    pk = ref.make_packing_key(ck, rng)
    bits = rng.integers(0, 2, count).astype(bool)
    cts = ref.encrypt_bool(ck, bits, rng)
    return ck, pk, bits, cts, ref.pack_lwes(pk, cts)


def packing_key(ck, seed: int):
    """The packing key of client key ``ck`` (a worker process's job)."""
    from herdsman_tpu_torch.core import reference as ref
    return ref.make_packing_key(ck, np.random.default_rng(seed + 40))


def rns_bigint_rows(N: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The negacyclic products mod Q of residue rows ``a`` and ``b`` [L, r,
    N] by big ints on the host (CRT in, ``np.convolve`` on Python ints, CRT
    out; no NTT), as residues [L, r, N] (a worker process's job)."""
    from herdsman_tpu_torch.ops import rns
    ctx = rns.make_rns(N, a.shape[0], device="cpu")
    x, y = rns.from_rns(ctx, a), rns.from_rns(ctx, b)
    return rns.to_rns(ctx, np.stack([rns.host_negacyclic_polymul(ctx, u, v)
                                     for u, v in zip(x, y)]))


def rns_bigint_phases(N: int, a: np.ndarray, b: np.ndarray,
                      s1: np.ndarray) -> np.ndarray:
    """The phases b - a * s1 mod Q of key-switched rows (``a`` and ``b``
    residues [L, r, N]) by big ints on the host: object ints [r, N] (a
    worker process's job)."""
    from herdsman_tpu_torch.ops import rns
    ctx = rns.make_rns(N, a.shape[0], device="cpu")
    x, y = rns.from_rns(ctx, a), rns.from_rns(ctx, b)
    return np.stack([(v - rns.host_negacyclic_polymul(ctx, u, s1)) % ctx.Q
                     for u, v in zip(x, y)])


def check(ok: bool, what: str) -> None:
    """Fail the run (also under ``python -O``, unlike assert)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls replayed from one
    CUDA graph: the launches' host cost (the wrapper's checks, ctypes) is
    paid once, at capture."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(fn):
    """(result, device ms) of one call of ``fn``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def host_s(fn):
    """(result, host seconds) of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| of two integer tensors, int32 read as u32."""
    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.int32:
            return t.numpy().view(np.uint32).astype(np.int64)
        return t.numpy().astype(np.int64)
    return int(np.abs(host(a) - host(b)).max())


class PhaseLog(logging.Handler):
    """Keeps the job runner's load / exec / store split of each job."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.phases: dict[str, tuple[float, float, float]] = {}

    def emit(self, record: logging.LogRecord) -> None:
        if record.msg.startswith("job %s phases"):
            job_uuid, *split = record.args
            self.phases[job_uuid] = tuple(split)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import google.protobuf
        import grpc

        from herdsman_tpu_torch.api import HerdContext
        from herdsman_tpu_torch.circuit import (
            DAG, CircuitBuilder, ColumnMeta, DataType, ExecutionPlan,
            InputStage, MapperStage, OutputStage, Policy, ReduceStage,
            SchemaType)
        from herdsman_tpu_torch.client import HerdClient
        from herdsman_tpu_torch.compiler import lower
        from herdsman_tpu_torch.compiler.reduce_tree import build_reduce_tree
        from herdsman_tpu_torch.compiler.stages import partition_sizes
        from herdsman_tpu_torch.core import PARAM_SETS, STD128
        from herdsman_tpu_torch.core import STD128_K2 as P
        from herdsman_tpu_torch.core import client
        from herdsman_tpu_torch.core import reference as ref
        from herdsman_tpu_torch import mesh as tmesh
        from herdsman_tpu_torch.compiler.stages import FrameData, PlanCompiler
        from herdsman_tpu_torch.mesh import _dcn_check, ntt_sharded
        from herdsman_tpu_torch.ops import bootstrap as bs
        from herdsman_tpu_torch.ops import gates, ntt, pack, pbs, poly, rns
        from herdsman_tpu_torch.ops.decomp import signed_decompose
        from herdsman_tpu_torch.ops.kernels import (_build, bt, mega12, mega13,
                                                    megaJ, megaS, megaT)
        from herdsman_tpu_torch.ops.kernels import rotate_decompose as rd
        from herdsman_tpu_torch.ops.kernels import wrappers as kernel_wrappers
        from herdsman_tpu_torch.ops.server_key import (
            bt_tile, device_server_key, fit_engine, layouts_for_engine)
        from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
        from herdsman_tpu_torch.radix import RadixContext
        from herdsman_tpu_torch.service import frames as frame_codec
        from herdsman_tpu_torch.service import mappers
        from herdsman_tpu_torch.service.api_server import build_server
        from herdsman_tpu_torch.service.config import (
            Config, GrpcWorkersConfig, LambdaWorkersConfig, LoggingConfig,
            MeshWorkersConfig, SecurityConfig, ServerConfig)
        from herdsman_tpu_torch.service.coordinator import (
            Coordinator, serialize_packing_key, serialize_server_key,
            serialize_server_key_compressed)
        from herdsman_tpu_torch.service.execution import JobStatus
        from herdsman_tpu_torch.service.grpc_worker import make_worker_server
        from herdsman_tpu_torch.service.offload_worker import make_server
        from herdsman_tpu_torch.shortint import EncShort, ShortContext
        from herdsman_tpu_torch.utils import bounds, rowcodec
    except ImportError as e:
        print(f"chip_smoke: the herdsman_tpu_torch package must sit beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    # the N=2048 host keygens (30-60 s each), path N's seeded keygen and the
    # packing keys run beside paths A-D; the workers are killed at exit, also
    # when a check fails
    pool = multiprocessing.get_context("spawn").Pool(len(KEYGEN_SETS) + 3)
    atexit.register(pool.terminate)
    keys_of = {name: pool.apply_async(keygen, (name, args.seed))
               for name in KEYGEN_SETS}
    keys_n = pool.apply_async(seeded_keygen, (args.seed,))
    group_std128 = pool.apply_async(packing_group,
                                    ("std128", args.seed, JOB_ROWS // 4))
    dev = torch.device("cuda", 0)

    # path C's plan: the map and reduce of tests/test_e2e.py
    JOB_IN_COLS = (ColumnMeta("a", DataType.UINT8),
                   ColumnMeta("b", DataType.UINT8))
    JOB_MID_COLS = (ColumnMeta("x", DataType.UINT8),
                    ColumnMeta("odd", DataType.BIT))

    def map_circuit():
        """x = a XOR b, odd = parity(x)."""
        mb = CircuitBuilder(JOB_IN_COLS)
        xv = mb.input_column("a") ^ mb.input_column("b")
        parity = xv.bits[0]
        for bit in xv.bits[1:]:
            parity = parity ^ bit
        mb.output("x", xv)
        mb.output("odd", parity)
        return mb.build()

    def job_plan(frame_uuid: str, reduce: bool = True):
        """Input -> Mapper (``map_circuit``) -> Reduce (bitwise XOR,
        PARALLEL, 2 per node) -> Output; without the reduce if not
        ``reduce``."""
        rb = CircuitBuilder(JOB_MID_COLS + JOB_MID_COLS)
        rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(2))
        rb.output("odd", rb.input_column_at(1).bits[0]
                  ^ rb.input_column_at(3).bits[0])
        g = DAG()
        stages = [g.emplace(InputStage(frame_uuid)),
                  g.emplace(MapperStage(map_circuit()))]
        if reduce:
            stages.append(g.emplace(ReduceStage(rb.build(), Policy.PARALLEL,
                                                per_node_count=2)))
        stages.append(g.emplace(OutputStage("result")))
        for a, b in zip(stages, stages[1:]):
            g.add_edge(a, b)
        return ExecutionPlan(SchemaType.TFHE_BOOL, g)

    # 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = f"[{smi}]"
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}; grpc {grpc.__version__}, protobuf "
          f"{google.protobuf.__version__}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v[0]:.1f} s' for k, v in built.items())})")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    ck, sk = ref.keygen(P, rng)
    pk_c = pool.apply_async(packing_key, (ck, args.seed))  # path C's
    layouts = ("bsk_btS", "bsk_ext", "bsk_bt", "bsk_conv")
    dsk = device_server_key(sk, layouts=layouts, device=dev)
    torch.cuda.synchronize()
    print(f"keys: {P.name} keygen + carry to the card in layouts {layouts} "
          f"{time.perf_counter() - t0:.1f} s; bsk_bt "
          f"{dsk.bsk_bt.numel() / 2**30:.3f} GiB")
    counters = kernel_wrappers()

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict[str, int]:
        return {k: fn.launches for k, fn in counters.items()}

    def only(counts: dict[str, int], kernels: tuple[str, ...],
             path: str) -> None:
        """Fail unless ``path`` launched each of ``kernels`` and no other."""
        check(all(counts[k] > 0 for k in kernels)
              and not any(v for k, v in counts.items() if k not in kernels),
              f"{path} launched {counts}, not {' and '.join(kernels)} alone")
    tp = bs.make_test_poly(P, device=dev)

    def bt_fused_rotation(p, acc, a_t, key):
        """The bt_fused engine's rotation: 2n launches."""
        for i in range(p.n):
            acc = bt.external_product_bt(p, rd.rotate_decompose(p, acc,
                                                                a_t[i]),
                                         key[i], glwe=acc)
        return acc

    def in_turns(p, acc0, a_t, fns: dict, same=()) -> dict:
        """ms per rotation at B = 2048 and 256 of each of ``fns`` (name ->
        (fn(params, acc0, a_t, key), key)) on the same inputs, in turns
        (the names, then reversed, after a warm-up of each), best of two;
        the outputs of the rotations named in ``same`` must be equal."""
        res: dict[int, dict[str, float]] = {}
        for B in (B_MAIN, RADIX_VALUES):
            x = acc0[:B].contiguous(), a_t[:, :B].contiguous()
            outs_t = {k: fn(p, *x, key) for k, (fn, key) in fns.items()}
            check(all(torch.equal(outs_t[k], outs_t[same[0]])
                      for k in same), f"{same} differ at {p.name} B={B}")
            del outs_t
            ms = {k: [] for k in fns}
            for k in [*fns, *list(fns)[::-1]]:
                fn, key = fns[k]
                ms[k].append(timed_call(lambda: fn(p, *x, key))[1])
            res[B] = {k: min(v) for k, v in ms.items()}
        return res

    def report_turns(name, p, turns, key_bytes) -> None:
        for B, t in turns.items():
            b_ms, b_by = bounds.bound_ms(*bounds.rotation(p, B, key_bytes))
            print(f"time: {name} at {p.name} B={B} {t[name]:.3f} ms, "
                  f"{b_ms / t[name]:.4f} of the {b_ms:.4f} ms bound ({b_by}); "
                  f"in turns on the same inputs: "
                  + ", ".join(f"{k} {v:.3f} ms ({name} / {k} "
                              f"{t[name] / v:.4f})"
                              for k, v in t.items() if k != name)
                  + f" {card}")

    # the main path A's gate batch, made here so that phase 3 compares the
    # kernel on the rotation inputs the main path gives it
    names = list(gates.GATE_COEFFS)
    ids = np.arange(B_MAIN) % len(names)
    b1 = rng.integers(0, 2, B_MAIN).astype(bool)
    b2 = rng.integers(0, 2, B_MAIN).astype(bool)
    c1, c2 = ref.encrypt_bool(ck, b1, rng), ref.encrypt_bool(ck, b2, rng)
    batch = gates.GateBatch(ids, c1, c2)
    lin = gates.gate_linear(P.n, torch.as_tensor(ids, device=dev),
                            from_numpy_u32(c1, dev), from_numpy_u32(c2, dev))
    acc0, a_t = bs.rotation_inputs(P, lin, tp)

    # 3. kernel vs plain, tolerance 0 (exact mod 2^32 arithmetic) -----------
    # at every rotation width of the main paths (the adder's rows * 1, 2,
    # 16), a ragged tile and one ciphertext
    err, outs = 0, {}
    for B in WIDTHS_S:
        x = acc0[:B].contiguous(), a_t[:, :B].contiguous()
        outs[B] = mega13.mega13_blind_rotate(P, *x, dsk.bsk_btS)
        plain = mega13.blind_rotate_plain_btS(P, *x, dsk.bsk_btS)
        err = max(err, int(np.abs(to_numpy_u32(outs[B]).astype(np.int64)
                                  - to_numpy_u32(plain).astype(np.int64)).max()))
        check(torch.equal(outs[B], plain), f"mega13 != plain version at B={B}")
    lin_np = to_numpy_u32(lin)
    for i in (0, B_MAIN - 1):
        want = ref.blind_rotate(sk, lin_np[i], ref.make_test_poly(P))
        check(np.array_equal(to_numpy_u32(outs[B_MAIN][i]), want),
              f"mega13 != reference.blind_rotate for ciphertext {i}")
    print(f"kernel vs plain: mega13 (csrc/megaS.cu) == "
          f"blind_rotate_plain_btS at B in {list(outs)} "
          f"on the gate batch's rotation inputs (array equality, max_abs_err "
          f"{err}); ciphertexts 0 and {B_MAIN - 1} == reference.blind_rotate")

    # 4. main path A: one heterogeneous gate batch ---------------------------
    reset_counts()
    out, gate_s = host_s(lambda: gates.gate_batch(dsk, batch, device=dev))
    counts_a = read_counts()
    launches_a = counts_a["mega13"]
    only(counts_a, ("mega13",), "main path A")
    truth = {"AND": b1 & b2, "OR": b1 | b2, "NAND": ~(b1 & b2),
             "NOR": ~(b1 | b2), "XOR": b1 ^ b2, "XNOR": ~(b1 ^ b2)}
    expect = np.array([truth[names[g]][i] for i, g in enumerate(ids)])
    out_np = to_numpy_u32(out)
    check(out_np.shape == (B_MAIN, P.n + 1), f"gate output {out_np.shape}")
    dec = ref.lwe_decrypt_bool(ck, out_np)
    check(np.array_equal(dec, expect),
          f"{int((dec != expect).sum())} of {B_MAIN} gates decrypt wrong")
    for i in (0, B_MAIN - 1):
        w1, w2, bias = gates.GATE_COEFFS[names[ids[i]]]
        lin_i = (np.uint32(w1 & 0xFFFFFFFF) * c1[i]
                 + np.uint32(w2 & 0xFFFFFFFF) * c2[i])
        lin_i[P.n:] += np.uint32(bias & 0xFFFFFFFF)   # the body
        check(np.array_equal(out_np[i], ref.bootstrap_bool(sk, lin_i)),
              f"gate {i} != reference.bootstrap_bool")
    print(f"main path A: gate_batch of {B_MAIN} gates ({', '.join(names)}) "
          f"decrypts to the truth table; gates 0 and {B_MAIN - 1} == "
          f"reference.bootstrap_bool; mega13 launches {launches_a}")

    # 5. main path B: an 8-bit adder over 128 rows ---------------------------
    cb = CircuitBuilder((ColumnMeta("a", DataType.UINT8),
                         ColumnMeta("b", DataType.UINT8)))
    cb.output("sum", cb.input_column("a") + cb.input_column("b"))
    circuit = cb.build()
    cost = lower.circuit_cost(circuit)
    widths = [ROWS * (len(lv.bootstrap_gates) + 2 * len(lv.mux_gates))
              for lv in lower.levelize(circuit)[0]]
    rows = rng.integers(0, 256, (ROWS, 2))
    bits = ((rows[:, :, None] >> np.arange(8)) & 1).astype(bool).reshape(
        ROWS, 16)
    x = ref.encrypt_bool(ck, bits, rng)
    run = lower.compile_circuit(circuit, dsk, device=dev)
    reset_counts()
    y, job_s = host_s(lambda: run(x))
    counts_b = read_counts()
    launches_b = counts_b["mega13"]
    only(counts_b, ("mega13",), "main path B")
    y_np = to_numpy_u32(y)
    check(y_np.shape == (ROWS, 8, P.n + 1), f"adder output {y_np.shape}")
    dec = ref.lwe_decrypt_bool(ck, y_np)
    sums = (dec.astype(np.int64) << np.arange(8)).sum(axis=1)
    plain_rows = lower.evaluate_plain(circuit, rows.tolist())
    check(sums.tolist() == [r["sum"] for r in plain_rows]
          == ((rows[:, 0] + rows[:, 1]) & 0xFF).tolist(),
          "adder rows decrypt wrong")
    print(f"main path B: compile_circuit 8-bit adder, {ROWS} rows, "
          f"{cost['depth']} levels, {cost['bootstraps_per_row']} bootstraps "
          f"per row, rotation widths {widths}: every row decrypts to "
          f"(a+b) & 0xFF; mega13 launches {launches_b}")

    # 6. times ---------------------------------------------------------------
    def rotate(B):
        return lambda: mega13.mega13_blind_rotate(
            P, acc0[:B].contiguous(), a_t[:, :B].contiguous(), dsk.bsk_btS)

    kernel_ms = timed_ms(rotate(B_MAIN), reps=3)
    narrow_ms = {B: timed_ms(rotate(B), reps=3) for B in (ROWS, 2 * ROWS)}
    plain_ms = timed_ms(lambda: mega13.blind_rotate_plain_btS(
        P, acc0, a_t, dsk.bsk_btS), reps=1)
    bound_ms, bound_by = bounds.bound_ms(
        *bounds.rotation(P, B_MAIN, dsk.bsk_btS.numel()))
    print(f"time: mega13 B={B_MAIN} {kernel_ms:.3f} ms = "
          f"{B_MAIN / kernel_ms * 1e3:.1f} bootstraps/s, "
          f"{bound_ms / kernel_ms:.4f} of the {bound_ms:.2f} ms bound "
          f"({bound_by}) {card}")
    for B, ms in narrow_ms.items():  # the adder's narrow level widths
        print(f"time: mega13 B={B} {ms:.3f} ms = "
              f"{B / ms * 1e3:.1f} bootstraps/s {card}")
    print(f"time: blind_rotate_plain_btS B={B_MAIN} {plain_ms:.3f} ms {card}")

    # mega13 in turns with its yardsticks on the same inputs: bt_fused's
    # rotation (2n launches, the same function on bsk_bt, array-equal) and
    # mega12 (the persistent wgmma kernel on bsk_btjj's 3.4 GiB, random)
    gen_y = torch.Generator(device=dev)
    gen_y.manual_seed(args.seed + 3)
    key12_y = torch.randint(-128, 128, mega12.key_shape(P), dtype=torch.int8,
                            device=dev, generator=gen_y)
    turns13 = in_turns(P, acc0, a_t, {
        "mega13": (mega13.mega13_blind_rotate, dsk.bsk_btS),
        "bt_fused": (bt_fused_rotation, dsk.bsk_bt),
        "mega12": (mega12.mega12_blind_rotate, key12_y)}, same=("mega13",
                                                               "bt_fused"))
    del key12_y
    torch.cuda.empty_cache()
    report_turns("mega13", P, turns13, dsk.bsk_btS.numel())

    raw = bs.sample_extract_batch(P, rotate(B_MAIN)())
    ks_ms = timed_ms(lambda: bs.key_switch_batch(dsk, raw), reps=10)
    d8 = signed_decompose(raw[:, :P.kN], P.ks_base_bits, P.ks_levels
                          ).reshape(B_MAIN, -1).to(torch.int8)
    mm_ms = timed_ms(lambda: mega13.int8_matmul(d8, dsk.ksk_limbs), reps=10)
    ksk_row = dsk.ksk_limbs.contiguous()  # the same key stored row-major
    mm_row_ms = timed_ms(lambda: mega13.int8_matmul(d8, ksk_row), reps=10)
    del ksk_row
    ks_bound_ms, ks_by = bounds.bound_ms(
        2 * d8.numel() * dsk.ksk_limbs.shape[1],
        4 * raw.numel() + dsk.ksk_limbs.numel() + 4 * B_MAIN * (P.n + 1))
    print(f"time: key_switch_batch B={B_MAIN} {ks_ms:.3f} ms, of which "
          f"torch._int_mm [{B_MAIN}, {d8.shape[1]}] x "
          f"{list(dsk.ksk_limbs.shape)} {mm_ms:.3f} ms (the key K-major; "
          f"{mm_row_ms:.3f} ms on it row-major); bound "
          f"{ks_bound_ms:.4f} ms ({ks_by}) {card}")
    _, gate2_s = host_s(lambda: gates.gate_batch(dsk, batch, device=dev))
    print(f"time: main path A gate_batch B={B_MAIN} end to end {gate_s:.3f} s "
          f"first call, {gate2_s:.3f} s second = "
          f"{B_MAIN / gate2_s:.1f} bootstraps/s {card}")
    _, job2_s = host_s(lambda: run(x))
    n_bs = ROWS * cost["bootstraps_per_row"]
    print(f"time: main path B adder job {ROWS} rows end to end "
          f"{job_s:.3f} s first call, {job2_s:.3f} s second = "
          f"{n_bs / job2_s:.1f} bootstraps/s {card}")

    # 6b. path A's gate batch on conv_i8: the JAX package's default engine,
    # an int8 product per step (torch._int_mm) against the Toeplitz
    # expansion of bsk_conv, no hand-written kernel ------------------------
    reset_counts()
    out_conv, conv_s = host_s(lambda: gates.gate_batch(
        dsk, batch, engine="conv_i8", device=dev))
    counts_conv = read_counts()
    only(counts_conv, (), "path A on conv_i8")
    check(torch.equal(out_conv, out), "path A's gate batch on conv_i8 != on "
          "mega13")
    dec = ref.lwe_decrypt_bool(ck, to_numpy_u32(out_conv))
    check(np.array_equal(dec, expect), f"{int((dec != expect).sum())} of "
          f"{B_MAIN} gates on conv_i8 decrypt wrong")
    rot_conv = bs.blind_rotate_batch(dsk, lin, tp, engine="conv_i8")
    check(torch.equal(rot_conv, outs[B_MAIN]),
          "blind_rotate_batch on conv_i8 != mega13's rotation")
    del rot_conv
    R_c, O_c = (P.k + 1) * P.levels, (P.k + 1) * 4

    def conv_rotation(p, acc, a_t_, key):
        """The conv_i8 engine's rotation: n steps of PyTorch ops."""
        return bs.step_rotation(p, bs._ep_conv_i8, acc, a_t_, [key])

    def conv_expand(w):
        """A step's Toeplitz expansion, K-major: [O*N, R*N], the transpose
        of the B operand (conv_i8_correlate's)."""
        return w.flip(-1).unfold(-1, P.N, 1).permute(1, 3, 0, 2).reshape(
            O_c * P.N, R_c * P.N)

    def conv_step(acc, a_i, w):
        """One whole conv_i8 CMux step, as step_rotation runs it."""
        rot = poly.negacyclic_monomial_mul(acc, a_i[:, None])
        digits = signed_decompose(rot - acc, P.bg_bits, P.levels)
        digits = digits.permute(0, 1, 3, 2).reshape(acc.shape[0], R_c, P.N)
        return acc + bs._ep_conv_i8(P, digits, w)

    turns_conv = in_turns(P, acc0, a_t, {
        "conv_i8": (conv_rotation, dsk.bsk_conv),
        "mega13": (mega13.mega13_blind_rotate, dsk.bsk_btS),
        "bt_fused": (bt_fused_rotation, dsk.bsk_bt)},
        same=("conv_i8", "mega13", "bt_fused"))
    w0 = dsk.bsk_conv[0]
    digits0 = signed_decompose(
        poly.negacyclic_monomial_mul(acc0, a_t[0][:, None]) - acc0,
        P.bg_bits, P.levels).permute(0, 1, 3, 2).reshape(B_MAIN, R_c, P.N)
    d8_0, E0 = digits0.to(torch.int8).reshape(B_MAIN, -1), conv_expand(w0)
    conv_t = {"step": timed_ms(lambda: conv_step(acc0, a_t[0], w0), reps=5),
              "product": timed_ms(lambda: bs._ep_conv_i8(P, digits0, w0),
                                  reps=5),
              "expansion": timed_ms(lambda: conv_expand(w0), reps=5),
              "int_mm": timed_ms(lambda: mega13.int8_matmul(d8_0, E0.t()),
                                 reps=5),
              "int_mm_row_major": timed_ms(
                  lambda: mega13.int8_matmul(d8_0, E0.t().contiguous()),
                  reps=5)}
    del digits0, d8_0, E0
    conv_bound = bounds.bound_ms(*bounds.correlation(B_MAIN, R_c, P.N, O_c))
    print(f"path A on conv_i8: gate_batch of {B_MAIN} gates == path A's on "
          f"mega13 (array equality) and decrypts to the truth table; "
          f"blind_rotate_batch == mega13's rotation; {conv_s:.3f} s end to "
          f"end; launches {counts_conv} (no hand-written kernel) {card}")
    report_turns("conv_i8", P, turns_conv, dsk.bsk_conv.numel())
    print(f"time: conv_i8 step at {P.name} B={B_MAIN} {conv_t['step']:.4f} "
          f"ms, of which the product (_ep_conv_i8: expansion "
          f"{conv_t['expansion']:.4f} ms, torch._int_mm [{B_MAIN}, "
          f"{R_c * P.N}] x [{R_c * P.N}, {O_c * P.N}] "
          f"{conv_t['int_mm']:.4f} ms with B K-major, "
          f"{conv_t['int_mm_row_major']:.4f} ms with B row-major; the limb "
          f"recombine) "
          f"{conv_t['product']:.4f} ms; the product's bound "
          f"{conv_bound[0]:.4f} ms ({conv_bound[1]}); bsk_conv "
          f"{dsk.bsk_conv.numel() / 1e6:.1f} MB {card}")

    # 6c. main path S1 and S2: path A's batch on the mesh, its positions on
    # this card: S1 gate_step_sharded on mega13 over (2, 1) (one launch a
    # position), S2 on conv_i8 over (1, 2) and (2, 2) (the exact int32 limb
    # sum of the partial products) ---------------------------------------
    res_s: dict[str, dict] = {}

    def card_mesh(batch_axis: int, limb_axis: int = 1):
        """A mesh whose positions all sit on this card."""
        return tmesh.make_mesh(batch_axis, limb_axis,
                               devices=[dev] * (batch_axis * limb_axis))

    def path_s(name: str, fn, single_s: float, what: str, counts_of=None):
        """Path S's sub-path ``name``: ``fn()`` with every count set to 0
        just before and read just after (by ``counts_of(fn())`` where the
        launches are another process's), its wall time beside its
        single-device counterpart's, its launches and its peak memory."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out_, secs = host_s(fn)
        counts_ = read_counts() if counts_of is None else counts_of(out_)
        res_s[name] = {"counts": counts_, "s": secs, "single_s": single_s,
                       "peak": torch.cuda.max_memory_allocated()}
        beside = ("no one-device time on this line" if single_s is None
                  else f"beside {single_s:.3f} s on one device")
        print(f"time: main path {name} ({what}) end to end {secs:.3f} s "
              f"{beside}; launches "
              f"{ {k: v for k, v in counts_.items() if v} }; "
              f"torch.cuda.max_memory_allocated "
              f"{res_s[name]['peak'] / 2**30:.3f} GiB {card}")
        return out_

    out_s1 = path_s("S1", lambda: tmesh.gate_step_sharded(
        dsk, card_mesh(2), batch.gate_ids, batch.c1, batch.c2,
        engine="mega13"), gate2_s, "gate_step_sharded, mega13, mesh (2, 1)")
    only(res_s["S1"]["counts"], ("mega13",), "path S1")
    check(res_s["S1"]["counts"]["mega13"] == 2,
          f"path S1 launched mega13 {res_s['S1']['counts']['mega13']} "
          f"times, not once on each of its 2 positions")
    check(torch.equal(out_s1, out), "path S1's gates != path A's")
    check(np.array_equal(ref.lwe_decrypt_bool(ck, to_numpy_u32(out_s1)),
                         expect), "path S1's gates decrypt wrong")
    for shape in ((1, 2), (2, 2)):
        name = f"S2_{shape[0]}x{shape[1]}"
        out_s2 = path_s(name, lambda: tmesh.gate_step_sharded(
            dsk, card_mesh(*shape), batch.gate_ids, batch.c1, batch.c2,
            engine="conv_i8"), conv_s, f"gate_step_sharded, conv_i8, mesh "
            f"{shape}")
        only(res_s[name]["counts"], (), f"path {name}")
        check(torch.equal(out_s2, out_conv),
              f"path {name}'s gates != phase 6b's on conv_i8")
    del out_s1, out_s2, out_conv
    print(f"main path S1, S2: path A's {B_MAIN} gates through "
          f"gate_step_sharded on meshes of positions of one card: mega13 "
          f"over (2, 1) == path A's output (array equality) and decrypts "
          f"to the truth table, one launch a position; conv_i8 over (1, 2) "
          f"and (2, 2) (the limb positions' int32 partial products summed) "
          f"== phase 6b's conv_i8 output")

    # 7. kernel vs plain: the block-Toeplitz kernels, tolerance 0 ----------
    errs = {"bt_external_product": 0, "rotate_decompose": 0}

    def compare_step(p, acc, a_i, key, label):
        """Kernels 2 and 1 (unfused, fused) against their plain versions."""
        d8 = rd.rotate_decompose(p, acc, a_i)
        want = rd.rotate_decompose_plain(p, acc, a_i)
        errs["rotate_decompose"] = max(errs["rotate_decompose"],
                                       abs_err(d8, want))
        check(torch.equal(d8, want), f"rotate_decompose != plain at {label}")
        for glwe in (None, acc):
            got = bt.external_product_bt(p, d8, key, glwe=glwe)
            want = bt.external_product_bt_plain(p, d8, key, glwe=glwe)
            errs["bt_external_product"] = max(errs["bt_external_product"],
                                              abs_err(got, want))
            check(torch.equal(got, want), f"bt_external_product "
                  f"({'fused' if glwe is not None else 'unfused'}) != plain "
                  f"at {label}")

    # step 0 of the gate batch's rotation, at a width of every plan path C
    # runs: 128-row tiles, 64-row ones, and K split 2 and 5 ways
    step_widths = (B_MAIN, 288, 72, 9, 1)
    for B in step_widths:
        compare_step(P, acc0[:B], a_t[0, :B], dsk.bsk_bt[0],
                     f"{P.name} B={B}")
    Q = STD128  # the other gadget and N, on random inputs and key step
    PQ, HALFQ = bt_tile(Q)
    RQ = (Q.k + 1) * Q.levels
    key_q = torch.randint(-128, 128, (RQ, HALFQ, PQ, (Q.k + 1) * 4 * PQ),
                          dtype=torch.int8, device=dev)
    for B in (B_MAIN, 9, 1):
        acc_q = torch.randint(-2**31, 2**31, (B, Q.k + 1, Q.N),
                              dtype=torch.int32, device=dev)
        a_q = torch.randint(0, 2 * Q.N, (B,), dtype=torch.int32, device=dev)
        compare_step(Q, acc_q, a_q, key_q, f"{Q.name} B={B}")
    for engine in ("bt", "bt_fused"):
        got = bs.blind_rotate_batch(dsk, lin, tp, engine=engine)
        check(torch.equal(got, outs[B_MAIN]),
              f"blind_rotate_batch engine {engine} != mega13 at B={B_MAIN}")
    print(f"kernel vs plain: rotate_decompose == rotate_decompose_plain and "
          f"bt_external_product (unfused, fused) == external_product_bt_plain "
          f"at {P.name} (step 0 of the gate batch; B in {list(step_widths)})"
          f" and {Q.name} (random step; B in {[B_MAIN, 9, 1]}) (array "
          f"equality, max_abs_err "
          f"{errs}); blind_rotate_batch engines bt and bt_fused == mega13 "
          f"at B={B_MAIN}")

    # 8. main path C: the coordinator's job path, on pallas_bt then
    # pallas_fused ------------------------------------------------------------
    table = rng.integers(0, 256, (JOB_ROWS, 2))
    job_in = client.encrypt_rows(ck, JOB_IN_COLS, table.tolist(), rng)
    payloads = frame_codec.rows_to_payloads(job_in)
    per_chunk = max(1, (1 << 20) // (len(payloads[0]) + 4))
    key_bytes = serialize_server_key(sk)
    xs = table[:, 0] ^ table[:, 1]
    odd = np.array([bin(int(v)).count("1") & 1 for v in xs])
    want_rows = [{"x": int(a), "odd": int(b)} for a, b in zip(xs, odd)]
    phase_log = PhaseLog()
    runner_log = logging.getLogger("herdsman.runner")
    runner_log.setLevel(logging.DEBUG)
    runner_log.propagate = False
    runner_log.addHandler(phase_log)

    def recorded(run):
        """(result, host seconds, rotations, device seconds, union seconds)
        of ``run()``: each blind rotation it makes, as (width, host seconds
        of the call), and the spans of the CUDA events on the stream around
        each summed, and their union (less than the sum where rotations of
        several threads overlap on the stream)."""
        rotations: list[tuple[int, float]] = []
        events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        base = torch.cuda.Event(enable_timing=True)
        base.record()
        rotate_batch = bs.blind_rotate_batch

        def recording(dsk_, ct, *a, **kw):
            ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            ev[0].record()
            out = rotate_batch(dsk_, ct, *a, **kw)
            ev[1].record()
            rotations.append((int(ct.shape[0]), time.perf_counter() - t0))
            events.append(ev)
            return out

        bs.blind_rotate_batch = recording
        try:
            result, host = host_s(run)
        finally:
            bs.blind_rotate_batch = rotate_batch
        torch.cuda.synchronize()
        union, reach = 0.0, 0.0
        for start, end in sorted((base.elapsed_time(a), base.elapsed_time(b))
                                 for a, b in events):
            union += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        return (result, host, rotations,
                sum(a.elapsed_time(b) for a, b in events) / 1e3, union / 1e3)

    def widths_line(rotations, p) -> str:
        """A job's rotation widths with their counts and host ms per step."""
        by_width: dict[int, list[float]] = {}
        for B, secs in rotations:
            by_width.setdefault(B, []).append(secs)
        counts = {B: len(v) for B, v in sorted(by_width.items(),
                                                 reverse=True)}
        host_ms = {B: round(sum(v) / len(v) / p.n * 1e3, 4)
                   for B, v in sorted(by_width.items(), reverse=True)}
        return (f"rotation widths with their counts {counts} "
                f"({len(rotations)} rotations, {len(rotations) * p.n} "
                f"steps); host ms per step (the rotation's Python loop "
                f"issuing its {p.n} steps, host clock without a "
                f"synchronize) by width {host_ms}")

    def path_c(engine: str, workdir: str, rows: int = JOB_ROWS,
               partitions: int = JOB_PARTITIONS, pk_bytes=None,
               worker: str = "", fleet: tuple[str, ...] = (),
               profile_dir: str = "", reduce: bool = True) -> dict:
        """Path C's job on ``engine`` over the first ``rows`` rows of the
        table in ``partitions`` partitions; with ``pk_bytes`` (a packing
        key of the client key) the output and intermediate row frames are
        then also downloaded packed, on the card, and decrypted.  With
        ``worker`` (host:port) the coordinator's config has
        ``workers.lambda`` in place of ``workers.mesh``, with ``fleet``
        (host:port of each worker) ``workers.grpc``, and ``engine`` only
        names the run; with ``profile_dir`` it has
        ``logging.profile_dir``; without ``reduce`` the plan is the map
        alone."""
        upload = [rowcodec.frame_rows(payloads[i:min(i + per_chunk, rows)])
                  for i in range(0, rows, per_chunk)]
        want_out = [{"x": int(np.bitwise_xor.reduce(xs[:rows])),
                     "odd": int(np.bitwise_xor.reduce(odd[:rows]))}]
        cfg = Config(server=ServerConfig(key_directory=workdir + "/keys",
                                         storage_directory=workdir + "/st"),
                     security=SecurityConfig(secret_key="chip-smoke"),
                     logging=LoggingConfig(profile_dir=profile_dir))
        if worker:
            cfg.lambda_workers = LambdaWorkersConfig(worker, JOB_PARTITIONS)
        elif fleet:
            cfg.grpc_workers = GrpcWorkersConfig(list(fleet))
        else:
            cfg.mesh_workers = (MeshWorkersConfig() if engine == "pallas_bt"
                                else MeshWorkersConfig(engine=engine))
        coord = Coordinator(cfg, device=dev)
        tok = coord.authorize_connection("admin==true")
        sess = coord.create_session(tok, "chip-smoke").uuid
        t0 = time.perf_counter()
        coord.add_key(tok, sess, SchemaType.TFHE_BOOL, len(key_bytes),
                      (key_bytes[i:i + (1 << 16)]
                       for i in range(0, len(key_bytes), 1 << 16)))
        t1 = time.perf_counter()
        meta = coord.begin_data_frame_upload(
            tok, sess, "rows", SchemaType.TFHE_BOOL, JOB_IN_COLS, rows,
            partitions)
        for chunk in upload:
            coord.append_data_frame(tok, sess, meta.uuid, chunk)
        coord.finish_data_frame_upload(tok, sess, meta.uuid)
        key_s, upload_s = t1 - t0, time.perf_counter() - t1
        plan_json = job_plan(meta.uuid, reduce).to_json()

        def run_job():
            # an offload job keeps a task per partition in flight
            job = coord.schedule_job(tok, sess, plan_json,
                                     JOB_PARTITIONS if worker or fleet
                                     else 1)
            job = coord.wait_for_job(tok, sess, job.job_uuid, timeout=900)
            check(job.status == JobStatus.COMPLETED and job.retries == 0
                  and job.bootstraps_executed > 0,
                  f"path C ({engine}) job {job.status.name}, retries "
                  f"{job.retries}, {job.bootstraps_executed} bootstraps: "
                  f"{job.message}")
            return job

        reset_counts()
        job, host, rotations, rotation_s, union_s = recorded(run_job)
        counts = read_counts()
        res = {"job": job, "host_s": host, "counts": counts,
               "phases": phase_log.phases.get(job.job_uuid),
               "rotations": rotations, "rotation_s": rotation_s,
               "union_s": union_s, "key_s": key_s, "upload_s": upload_s}

        def frame_bytes(uuid):
            return list(coord.download_data_frame(tok, sess, uuid))

        (out_uuid,) = job.output_frames.values()
        (mid,) = [f.uuid for f in coord.list_data_frames(tok, sess)
                  if f.name.startswith(f"intermediate-{job.job_uuid}-")]
        res["out"], res["mid"] = frame_bytes(out_uuid), frame_bytes(mid)
        if not reduce:  # the map's frame is the output
            want_out = want_rows[:rows]
            check(out_uuid == mid, f"path C ({engine}) map-only job's "
                  f"output is not its intermediate frame")
        packed = {}
        if pk_bytes is not None:  # the row frames packed on the card
            coord.add_key(tok, sess, SchemaType.TFHE_PACKING, len(pk_bytes),
                          (pk_bytes[i:i + (1 << 16)]
                           for i in range(0, len(pk_bytes), 1 << 16)))
            for name, uuid in (("intermediate", mid), ("output", out_uuid)):
                packed[name] = host_s(lambda: list(
                    coord.download_data_frame_packed(tok, sess, uuid)))
            res["packed"] = {name: (secs, sum(map(len, parts)))
                             for name, (parts, secs) in packed.items()}
            res["packed_parts"] = {name: parts
                                   for name, (parts, _) in packed.items()}
        for name, parts, want in (("intermediate", res["mid"],
                                   want_rows[:rows]),
                                  ("output", res["out"], want_out)):
            payloads_ = [pl for part in parts
                         for pl in rowcodec.parse_rows(part)]
            cts = frame_codec.payloads_to_rows(payloads_, 9, P)
            got = client.decrypt_rows(ck, JOB_MID_COLS, cts)
            bad = sum(g != w for g, w in zip(got, want))
            check(len(got) == len(want) and bad == 0,
                  f"path C ({engine}) {name} frame: {len(got)} rows, {bad} "
                  f"decrypt wrong")
            if name in packed:
                check(client.decrypt_rows_packed(
                    ck, JOB_MID_COLS, packed[name][0]) == got,
                    f"path C ({engine}) {name} frame downloaded packed "
                    f"decrypts otherwise than its rows")
        coord.shutdown()
        return res

    runs = {}
    pk_bytes_c = serialize_packing_key(pk_c.get())  # C's and Q's
    for engine in ("pallas_bt", "pallas_fused"):
        with tempfile.TemporaryDirectory() as workdir:
            runs[engine] = path_c(
                engine, workdir, pk_bytes=(pk_bytes_c
                                           if engine == "pallas_fused"
                                           else None))
        torch.cuda.empty_cache()
        r = runs[engine]
        print(f"main path C ({engine}): {JOB_ROWS} rows in {JOB_PARTITIONS} "
              f"partitions, map + PARALLEL reduce: COMPLETED, retries 0, "
              f"{r['job'].bootstraps_executed} bootstraps; all {JOB_ROWS} "
              f"intermediate rows and the reduced row decrypt right; "
              f"launches {r['counts']}")
    c_bt, c_fused = runs["pallas_bt"]["counts"], runs["pallas_fused"]["counts"]
    # kept for paths O and Q, after runs is freed
    wall_c = {e: r["job"].wall_time_s for e, r in runs.items()}
    res_c = {k: runs["pallas_fused"][k]
             for k in ("mid", "out", "packed", "packed_parts", "phases",
                       "host_s", "key_s", "upload_s", "rotation_s")}
    only(c_bt, ("bt_external_product",), "path C on pallas_bt")
    only(c_fused, ("bt_external_product", "rotate_decompose"),
         "path C on pallas_fused")
    for frame in ("out", "mid"):
        check(runs["pallas_bt"][frame] == runs["pallas_fused"][frame],
              f"path C {frame} frame differs between pallas_bt and "
              f"pallas_fused")
    print("main path C: pallas_bt and pallas_fused output and intermediate "
          "frames are byte-equal")
    for engine, r in runs.items():  # the widths the job's rotations ran at
        print(f"main path C ({engine}): {widths_line(r['rotations'], P)}; "
              f"CUDA events around each rotation span "
              f"{r['rotation_s']:.3f} s of the stream in all {card}")
    # 8b. the map circuit as submitted, in one batch on bt_fused: what an
    # offload worker (paths O, O') writes.  Path C's runner plans the
    # optimized circuit (compiler/optimizer.py re-expands the parity
    # chain), whose ciphertexts differ, though they decrypt alike
    submitted = map_circuit()
    out_sub = to_numpy_u32(lower.compile_circuit(
        submitted, dsk, engine="bt_fused", device=dev)(job_in))
    bounds_sub = np.cumsum([0, *partition_sizes(JOB_ROWS, JOB_PARTITIONS)])
    mid_sub = [rowcodec.frame_rows(frame_codec.rows_to_payloads(
        out_sub[a:b])) for a, b in zip(bounds_sub, bounds_sub[1:])]
    del out_sub
    print(f"main path C: the map circuit as submitted "
          f"({lower.circuit_cost(submitted)}) evaluated in one batch on "
          f"bt_fused, the frame of paths O and O'; byte-equal to path C's, "
          f"whose runner plans the optimized circuit: "
          f"{mid_sub == runs['pallas_fused']['mid']}")
    print(f"main path C (pallas_fused): the TFHE_PACKING key uploaded, both "
          f"row frames downloaded packed on the card (pack_lwes_batch, "
          f"{JOB_PARTITIONS} x {JOB_ROWS // JOB_PARTITIONS} rows a frame) "
          f"decrypt as their rows: (seconds, bytes) "
          f"{runs['pallas_fused']['packed']} against "
          f"{sum(map(len, runs['pallas_fused']['mid']))} and "
          f"{sum(map(len, runs['pallas_fused']['out']))} bytes of rows "
          f"{card}")

    # 9. times of the block-Toeplitz engines --------------------------------
    R = (P.k + 1) * P.levels
    HALF = P.N // bt_tile(P)[0]
    acc_s, a_s = acc0, a_t[0]
    d8_s = rd.rotate_decompose(P, acc_s, a_s)
    steps = iter(range(1 << 30))  # a new step key per call, as in a rotation

    def step_key():
        return dsk.bsk_bt[next(steps) % P.n]

    rd_ms = timed_ms(lambda: rd.rotate_decompose(P, acc_s, a_s), reps=50)
    # replayed from one CUDA graph: the device time without the launches'
    # host cost, which the loop above pays once per launch
    rd_graph_ms = graph_ms(lambda: rd.rotate_decompose(P, acc_s, a_s),
                                   reps=50)
    rd_plain_ms = timed_ms(lambda: rd.rotate_decompose_plain(P, acc_s, a_s),
                           reps=5)
    rd_bound_ms, rd_by = bounds.bound_ms(
        *bounds.rotate_decompose_step(P, acc_s.shape[0]),
        bounds.PEAK_INT32_OPS)
    ep = {}
    for fused in (False, True):
        glwe = acc_s if fused else None
        ep[fused] = {
            "ms": timed_ms(lambda: bt.external_product_bt(
                P, d8_s, step_key(), glwe=glwe), reps=20),
            "graph_ms": graph_ms(lambda: bt.external_product_bt(
                P, d8_s, step_key(), glwe=glwe), reps=20),
            "plain_ms": timed_ms(lambda: bt.external_product_bt_plain(
                P, d8_s, step_key(), glwe=glwe), reps=3),
        }
        ep[fused]["bound_ms"], ep[fused]["bound_by"] = bounds.bound_ms(
            *bounds.external_product_step(P, d8_s.shape[1], fused))
    # the library yardstick: one int8 product on the fully expanded step
    # matrix [R*N, (k+1)*4*N] (no recombine); never called by the port
    idx = (torch.arange(P.N, device=dev)[None, :]
           - torch.arange(P.N, device=dev)[:, None]) % (2 * P.N)
    full = poly.to_i8_limbs(dsk.bsk_ext[0][..., idx]).permute(
        0, 2, 1, 3, 4).reshape(R * P.N, (P.k + 1) * P.N * 4)
    d_flat = d8_s.reshape(R, HALF, B_MAIN, -1).permute(2, 0, 1, 3).reshape(
        B_MAIN, R * P.N)
    # the same matrix stored K-major, which torch._int_mm reads faster
    full_t = full.t().contiguous()
    lib_ms = timed_ms(lambda: torch._int_mm(d_flat, full_t.t()), reps=20)
    lib_row_ms = timed_ms(lambda: torch._int_mm(d_flat, full), reps=20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for fused in (False, True):
        e = ep[fused]
        print(f"time: bt_external_product {'fused' if fused else 'unfused'} "
              f"one step B={B_MAIN} {e['ms']:.4f} ms ({e['graph_ms']:.4f} ms "
              f"replayed from a CUDA graph; {e['ms'] * P.n:.1f} ms "
              f"per {P.n}-step rotation); {e['bound_ms'] / e['ms']:.4f} of "
              f"the {e['bound_ms']:.4f} ms bound ({e['bound_by']}); plain "
              f"{e['plain_ms']:.4f} ms; torch._int_mm [{B_MAIN}, {R * P.N}] x "
              f"{list(full.shape)} {lib_ms:.4f} ms (B K-major; "
              f"{lib_row_ms:.4f} ms row-major); "
              f"{bt.plan(P, B_MAIN, sms)} {card}")
    narrow = {}
    for B in (288, 9):  # path C's narrow reduce levels
        acc_n, a_n = acc0[:B], a_t[0, :B]
        d8_n = rd.rotate_decompose(P, acc_n, a_n)
        n_ms = timed_ms(lambda: bt.external_product_bt(
            P, d8_n, step_key(), glwe=acc_n), reps=20)
        nrd_ms = timed_ms(lambda: rd.rotate_decompose(P, acc_n, a_n), reps=20)
        # the library call on the same product, rows padded to 32 as
        # mega13.int8_matmul pads them
        d_flat_n = d8_n.reshape(R, HALF, B, -1).permute(2, 0, 1, 3).reshape(
            B, R * P.N)
        nlib_ms = timed_ms(lambda: mega13.int8_matmul(d_flat_n, full_t.t()),
                           reps=20)
        # the same launches replayed from one CUDA graph: the device time
        # alone, without the wrapper's host cost per launch
        ng_ms = graph_ms(lambda: bt.external_product_bt(
            P, d8_n, step_key(), glwe=acc_n), reps=20)
        n_bound, n_by = bounds.bound_ms(
            *bounds.external_product_step(P, B, fused=True))
        narrow[B] = {"ms": n_ms, "graph_ms": ng_ms, "library_ms": nlib_ms,
                     "bound_ms": n_bound}
        print(f"time: bt_external_product fused one step B={B} {n_ms:.4f} "
              f"ms ({ng_ms:.4f} ms replayed from a CUDA graph), "
              f"{n_bound / n_ms:.4f} of the {n_bound:.4f} ms bound "
              f"({n_by}); mega13.int8_matmul (torch._int_mm, B K-major, rows "
              f"padded to "
              f"{max(32, -(-B // 8) * 8)}) x {list(full.shape)} "
              f"{nlib_ms:.4f} ms; rotate_decompose {nrd_ms:.4f} ms "
              f"({(n_ms + nrd_ms) * P.n:.1f} ms per rotation); "
              f"{bt.plan(P, B, sms)} {card}")
    print(f"time: rotate_decompose one step B={B_MAIN} {rd_ms:.4f} ms "
          f"({rd_graph_ms:.4f} ms replayed from a CUDA graph); "
          f"{rd_bound_ms / rd_ms:.4f} of the {rd_bound_ms:.4f} ms bound "
          f"({rd_by}); plain {rd_plain_ms:.4f} ms {card}")
    d8_q = rd.rotate_decompose(
        Q, torch.randint(-2**31, 2**31, (B_MAIN, Q.k + 1, Q.N),
                         dtype=torch.int32, device=dev),
        torch.randint(0, 2 * Q.N, (B_MAIN,), dtype=torch.int32, device=dev))
    q_ms = timed_ms(lambda: bt.external_product_bt(Q, d8_q, key_q), reps=10)
    q_bound, q_by = bounds.bound_ms(
        *bounds.external_product_step(Q, d8_q.shape[1], fused=False))
    # STD128's library yardstick: one int8 product of the same shapes
    # (expanded step matrix [R*N, (k+1)*4*N], random: the time does not
    # depend on the values)
    full_q = torch.randint(-128, 128, ((Q.k + 1) * 4 * Q.N, RQ * Q.N),
                           dtype=torch.int8, device=dev).t()  # K-major
    d_flat_q = d8_q.reshape(RQ, HALFQ, B_MAIN, -1).permute(
        2, 0, 1, 3).reshape(B_MAIN, RQ * Q.N)
    q_lib_ms = timed_ms(lambda: torch._int_mm(d_flat_q, full_q), reps=10)
    del full_q, d_flat_q
    print(f"time: bt_external_product unfused one step at {Q.name} B={B_MAIN} "
          f"{q_ms:.4f} ms; {q_bound / q_ms:.4f} of the {q_bound:.4f} ms "
          f"bound ({q_by}); torch._int_mm [{B_MAIN}, {RQ * Q.N}] x "
          f"[{RQ * Q.N}, {(Q.k + 1) * 4 * Q.N}] (K-major) {q_lib_ms:.4f} ms; "
          f"{bt.plan(Q, B_MAIN, sms)} {card}")
    for engine in ("bt", "bt_fused"):
        got, s1 = host_s(lambda: gates.gate_batch(dsk, batch, engine=engine,
                                                  device=dev))
        check(np.array_equal(to_numpy_u32(got), out_np),
              f"gate_batch on {engine} != on mega13")
        _, s2 = host_s(lambda: gates.gate_batch(dsk, batch, engine=engine,
                                                device=dev))
        print(f"time: gate_batch B={B_MAIN} on {engine} {s1:.3f} s first "
              f"call, {s2:.3f} s second = {B_MAIN / s2:.1f} bootstraps/s "
              f"(outputs == mega13's) {card}")
    for engine, r in runs.items():
        job = r["job"]
        load, exe, store = r["phases"]
        print(f"time: main path C job on {engine} wall {job.wall_time_s:.3f} "
              f"s (host {r['host_s']:.3f} s), {job.bootstraps_executed} "
              f"bootstraps = {job.bootstraps_per_sec:.1f} bootstraps/s; "
              f"runner load {load:.3f} s, exec {exe:.3f} s, store "
              f"{store:.3f} s, key ingest and the rest "
              f"{job.wall_time_s - load - exe - store:.3f} s {card}")
    print(f"memory: torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card}")

    def vs_plain(name, plain, p, acc0, a_t, key,
                 cache: dict | None = None,
                 widths=(B_MAIN, RADIX_VALUES, 9)) -> tuple[int, float]:
        """Kernel ``name`` against its plain version ``plain`` (tolerance 0)
        on a path's first rotation inputs at B = 2048, 256 and 9 (or
        ``widths``): (max_abs_err, plain ms at B=2048).  ``cache`` keeps
        the plain outputs for another kernel of the same function on the
        same key."""
        cache = {} if cache is None else cache
        err = 0
        for B in widths:
            x = acc0[:B].contiguous(), a_t[:, :B].contiguous()
            got = counters[name](p, *x, key)
            if B not in cache:
                cache[B] = timed_call(lambda: plain(p, *x, key))
            err = max(err, abs_err(got, cache[B][0]))
            check(torch.equal(got, cache[B][0]), f"{name} != plain version "
                  f"at {p.name} B={B}")
        return err, cache[B_MAIN][1]

    def rotation_times(names, p, acc0, a_t, keys, plans,
                       fns: dict | None = None) -> dict:
        """ms per rotation at B=2048 and at B=256 of each kernel of
        ``names`` (warm: each ran at these shapes in vs_plain) on the same
        inputs, in turns (``names``, then in reverse, where there are
        several); with each one's bound and the split of a batch
        ``plans[name]`` gives (None where the kernel has no such
        function).  ``fns`` names a rotation that is no kernel wrapper
        (fn(params, acc0, a_t, key))."""
        fns = fns or {}
        order = [*names, *names[::-1]] if len(names) > 1 else list(names)
        narrow = (acc0[:RADIX_VALUES].contiguous(),
                  a_t[:, :RADIX_VALUES].contiguous())
        runs = {name: {"ms": [], "narrow_ms": []} for name in names}
        for key_name, x in (("ms", (acc0, a_t)), ("narrow_ms", narrow)):
            for name in order:
                fn = fns.get(name, counters.get(name))
                runs[name][key_name].append(timed_call(
                    lambda: fn(p, *x, keys[name]))[1])
        out = {}
        for name in names:
            key = keys[name]
            ops, nbytes = bounds.rotation(p, B_MAIN,
                                          key.numel() * key.element_size())
            bound, by = bounds.bound_ms(ops, nbytes)
            ms = sum(runs[name]["ms"]) / len(runs[name]["ms"])
            pb = plans.get(name)
            out[name] = {
                "ms": ms,
                "narrow_ms": (sum(runs[name]["narrow_ms"])
                              / len(runs[name]["narrow_ms"])),
                "bound_ms": bound, "bound_by": by,
                "G": {B: pb(p, B, dev) if pb else None
                      for B in (B_MAIN, RADIX_VALUES, 9)}}
        return out

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def mega12_plan(p, B, dev_):
        """csrc/mega12.cu's split of a batch: its (rows a tile, K splits,
        blocks a cluster) plan."""
        return mega12.kernel_plan(p, B, n_sms)

    def megaS_units(name):
        """(work units, K splits) of csrc/megaS.cu's entry ``name``."""
        return lambda p, B, dev_: megaS.kernel_plan(p, B, name, n_sms)

    def print_times(name, p, t, plain_ms) -> None:
        print(f"time: {name} at {p.name} B={B_MAIN} {t['ms']:.3f} ms = "
              f"{B_MAIN / t['ms'] * 1e3:.1f} bootstraps/s, "
              f"{t['bound_ms'] / t['ms']:.4f} of the {t['bound_ms']:.4f} ms "
              f"bound ({t['bound_by']}), on tensor cores; B={RADIX_VALUES} "
              f"{t['narrow_ms']:.3f} ms; plain {plain_ms:.3f} ms at "
              f"B={B_MAIN}; plan by B {t['G']} {card}")

    # 9b. main path H: path A's gate batch on the j-major family, one
    # window's keys at a time (built, used, freed): mega11, mega10, mega8
    # and mega9 on one bsk_btk2 (mega12.cu's doubled window under four
    # wrappers, beside a bsk_btk for mega12 in turns); mega7, mega5, mega4,
    # mega6 and mega3 on one bsk_btk (mega12.cu's single window under five
    # wrappers); the kernels of one window, which share a key and a plain
    # version, are timed in turns ------------------------------------------
    errs_j = {name: 0 for name in megaJ.KERNELS}
    res_h = {}
    turns11 = {}
    for group in (("mega11", "mega10", "mega8", "mega9"),
                  ("mega7", "mega5", "mega4", "mega6", "mega3")):
        layouts_h = tuple(dict.fromkeys(megaJ.KEY_LAYOUTS[n] for n in group))
        if group[0] == "mega11":  # mega12's key, to time mega11 beside it
            layouts_h += ("bsk_btk",)
        for name in group:
            check(fit_engine(name, P) == name,
                  f"fit_engine({name!r}, {P.name}) -> {fit_engine(name, P)}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dsk_h, ingest_h_s = host_s(lambda: device_server_key(
            sk, layouts=layouts_h, device=dev))
        keys_h = {name: getattr(dsk_h, megaJ.KEY_LAYOUTS[name])
                  for name in group}
        print(f"main path H: keys to the card ("
              + ", ".join(f"{lay} {getattr(dsk_h, lay).numel() / 2**30:.3f} "
                          f"GiB" for lay in layouts_h)
              + f") {ingest_h_s:.1f} s")
        cache: dict = {}
        for name in group:
            err_h, plain_h_ms = vs_plain(
                name, megaJ.plain(name), P, acc0, a_t, keys_h[name], cache,
                widths=(B_MAIN, RADIX_VALUES, 9, 1))
            errs_j[name] = max(errs_j[name], err_h)
            reset_counts()
            out_h, h_s = host_s(lambda: gates.gate_batch(
                dsk_h, batch, engine=name, device=dev))
            counts_h = read_counts()
            only(counts_h, (name,), f"main path H on {name}")
            out_h_np = to_numpy_u32(out_h)
            check(np.array_equal(out_h_np, out_np),
                  f"H: gate_batch on {name} != on mega13 (path A)")
            check(np.array_equal(ref.lwe_decrypt_bool(ck, out_h_np), expect),
                  f"H: gate_batch on {name} decrypts wrong")
            res_h[name] = {"counts": counts_h, "plain_ms": plain_h_ms,
                           "path_s": h_s}
            print(f"main path H ({name}): {name} == its plain version on the "
                  f"gate batch's rotation inputs at B in {sorted(cache)} "
                  f"(array equality, max_abs_err "
                  f"{err_h}); gate_batch of {B_MAIN} gates == path A's "
                  f"mega13 output and decrypts to the truth table; launches "
                  f"{counts_h}")
            del out_h
        times = rotation_times(group, P, acc0, a_t, keys_h,
                               dict.fromkeys(group, mega12_plan))
        if group[0] == "mega11":
            # in turns on the same inputs: mega12 (the single window, on
            # this key in bsk_btk's order) and bt_fused's rotation (2n
            # launches on path A's bsk_bt), all array-equal
            turns11 = in_turns(P, acc0, a_t, {
                "mega11": (megaJ.mega11_blind_rotate, dsk_h.bsk_btk2),
                "mega12": (mega12.mega12_blind_rotate, dsk_h.bsk_btk),
                "bt_fused": (bt_fused_rotation, dsk.bsk_bt)},
                same=("mega11", "mega12", "bt_fused"))
            report_turns("mega11", P, turns11, dsk_h.bsk_btk2.numel())
        peak_h = torch.cuda.max_memory_allocated()
        for name in group:
            res_h[name].update(times[name])
            print_times(name, P, res_h[name], res_h[name]["plain_ms"])
            print(f"time: main path H gate_batch B={B_MAIN} on {name} end to "
                  f"end {res_h[name]['path_s']:.3f} s = "
                  f"{B_MAIN / res_h[name]['path_s']:.1f} bootstraps/s {card}")
        for other in group[1:]:
            a_, b_ = times[group[0]], times[other]
            print(f"time: {other} / {group[0]} at {P.name} (timed in turns "
                  f"{[*group, *group[::-1]]}): B={B_MAIN} "
                  f"{b_['ms'] / a_['ms']:.4f}, B={RADIX_VALUES} "
                  f"{b_['narrow_ms'] / a_['narrow_ms']:.4f} {card}")
        print(f"memory: path H on {', '.join(layouts_h)} "
              f"torch.cuda.max_memory_allocated {peak_h / 2**30:.3f} GiB "
              f"{card}")
        del dsk_h, keys_h

    # 9b'. main path A': path A's gate batch on mega14 (the extended key
    # bsk_btTe), and mega14 timed in turns with mega16 (the compact
    # bsk_btTc) and mega13 (the raw key) at STD128_K2 ----------------------
    check(fit_engine("mega14", P) == "mega14",
          f"fit_engine('mega14', {P.name}) -> {fit_engine('mega14', P)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dsk_t, ingest_t_s = host_s(lambda: device_server_key(
        sk, layouts=("bsk_btTe", "bsk_btTc"), device=dev))
    err14, plain14_k2_ms = vs_plain("mega14", megaT.plain("mega14"), P, acc0,
                                    a_t, dsk_t.bsk_btTe, widths=WIDTHS_S)
    reset_counts()
    out_t, t_s = host_s(lambda: gates.gate_batch(dsk_t, batch, engine="mega14",
                                                 device=dev))
    counts_a14 = read_counts()
    only(counts_a14, ("mega14",), "main path A' on mega14")
    out_t_np = to_numpy_u32(out_t)
    check(np.array_equal(out_t_np, out_np),
          "A': gate_batch on mega14 != on mega13 (path A)")
    check(np.array_equal(ref.lwe_decrypt_bool(ck, out_t_np), expect),
          "A': gate_batch on mega14 decrypts wrong")
    for B in (B_MAIN, RADIX_VALUES):  # mega16 at this set, and its warm-up
        got = megaT.mega16_blind_rotate(P, acc0[:B].contiguous(),
                                        a_t[:, :B].contiguous(),
                                        dsk_t.bsk_btTc)
        check(torch.equal(got, outs[B]), f"mega16 != mega13 at {P.name} B={B}")
    keys_t = {"mega14": dsk_t.bsk_btTe, "mega16": dsk_t.bsk_btTc,
              "mega13": dsk.bsk_btS}
    res_a14 = rotation_times(("mega14", "mega16", "mega13"), P, acc0, a_t,
                             keys_t, {name: megaS_units(name)
                                      for name in keys_t})
    peak_t = torch.cuda.max_memory_allocated()
    print(f"main path A' (mega14): keys to the card (bsk_btTe "
          f"{dsk_t.bsk_btTe.numel() / 2**20:.1f} MiB, bsk_btTc "
          f"{dsk_t.bsk_btTc.numel() / 2**20:.1f} MiB) {ingest_t_s:.1f} s; "
          f"mega14 == blind_rotate_plain_btTe on the gate batch's rotation "
          f"inputs at B in {list(WIDTHS_S)} (array equality, "
          f"max_abs_err {err14}); gate_batch of {B_MAIN} gates == path A's "
          f"mega13 output and decrypts to the truth table; launches "
          f"{counts_a14}; mega16 == mega13 at B in {[B_MAIN, RADIX_VALUES]}")
    for name in ("mega14", "mega16", "mega13"):
        t = res_a14[name]
        print(f"time: {name} at {P.name} (timed in turns mega14, mega16, "
              f"mega13, mega13, mega16, mega14) B={B_MAIN} {t['ms']:.3f} ms "
              f"= {B_MAIN / t['ms'] * 1e3:.1f} bootstraps/s, "
              f"{t['bound_ms'] / t['ms']:.4f} of the {t['bound_ms']:.4f} ms "
              f"bound ({t['bound_by']}); B={RADIX_VALUES} "
              f"{t['narrow_ms']:.3f} ms; (work units, K splits) by B "
              f"{t['G']} {card}")
    print(f"time: plain mega14 at {P.name} "
          f"{plain14_k2_ms:.3f} ms at B={B_MAIN}; main path A' gate_batch "
          f"B={B_MAIN} end to end {t_s:.3f} s = {B_MAIN / t_s:.1f} "
          f"bootstraps/s {card}")
    print(f"memory: path A' torch.cuda.max_memory_allocated "
          f"{peak_t / 2**30:.3f} GiB {card}")
    del dsk_t, keys_t, out_t

    # each kernel on random keys at B=9 at four more geometries (n cut to 32
    # steps: the step loop is the same at every n); mega14 at STD128_FAST's
    # and STD128_K4's
    gen_j = torch.Generator(device=dev)
    gen_j.manual_seed(args.seed + 5)
    geoms = [dataclasses.replace(PARAM_SETS[g], n=32)
             for g in ("std128", "std128_fast", "std128_shortint",
                       "std128_k4")]
    for Gp in geoms:
        acc_g = torch.randint(-2**31, 2**31, (9, Gp.k + 1, Gp.N),
                              dtype=torch.int32, device=dev, generator=gen_j)
        a_g = torch.randint(0, 2 * Gp.N, (Gp.n, 9), dtype=torch.int32,
                            device=dev, generator=gen_j)
        for name in megaJ.KERNELS:
            megaJ.check_params(Gp, name)  # every kernel takes these sets
            key_g = torch.randint(-128, 128, megaJ.key_shape(Gp, name),
                                  dtype=torch.int8, device=dev,
                                  generator=gen_j)
            got = counters[name](Gp, acc_g, a_g, key_g)
            want = megaJ.plain(name)(Gp, acc_g, a_g, key_g)
            errs_j[name] = max(errs_j[name], abs_err(got, want))
            check(torch.equal(got, want), f"{name} != plain version at "
                  f"{Gp.name}'s geometry, B=9, random inputs")
            del key_g
    # csrc/mega12.cu's wrappers (mega11 and mega10; mega7, mega5, mega4,
    # mega6, mega3, mega2 and mega on its single window, one key and one
    # plain rotation shared by each window's) also at STD128_K2's geometry and at a full (2048, 128-row tiles
    # in clusters) and a ragged batch (300: a cluster with a lone M tile at
    # N = 2048); B=9 splits K
    geoms_w = [dataclasses.replace(PARAM_SETS[g], n=32)
               for g in ("std128_k2", "std128", "std128_shortint")]
    plans_w = {}
    windows_w = {}
    for name, doubled in megaJ.KERNELS.items():
        windows_w.setdefault(doubled, []).append(name)
    for Gp in geoms_w:
        for doubled, names_w in windows_w.items():
            key_g = torch.randint(-128, 128, mega12.key_shape(Gp, doubled),
                                  dtype=torch.int8, device=dev,
                                  generator=gen_j)
            for Bg in (B_MAIN, 300, 9):
                acc_g = torch.randint(-2**31, 2**31, (Bg, Gp.k + 1, Gp.N),
                                      dtype=torch.int32, device=dev,
                                      generator=gen_j)
                a_g = torch.randint(0, 2 * Gp.N, (Gp.n, Bg),
                                    dtype=torch.int32, device=dev,
                                    generator=gen_j)
                want = megaJ.plain(names_w[0])(Gp, acc_g, a_g, key_g)
                for name in names_w:
                    got = counters[name](Gp, acc_g, a_g, key_g)
                    errs_j[name] = max(errs_j[name], abs_err(got, want))
                    check(torch.equal(got, want), f"{name} != plain version "
                          f"at {Gp.name}'s geometry, B={Bg}, random inputs")
                plans_w[(Gp.name, Bg)] = mega12.kernel_plan(Gp, Bg, n_sms)
            del key_g
    # csrc/megaS.cu's kernels on random keys: mega14 at STD128_FAST's,
    # STD128_K4's and STD128_SHORTINT_FAST's geometries and its least N
    # (256); mega13 at STD128_SHORTINT_FAST's and TOY's (N = 64: the tile is
    # N, the stream padded), at B = 2048 and 9; mega17, mega15 and mega16 at
    # their own sets' geometries, also at B = 300 (a ragged tile)
    geomsS = [("mega14", dataclasses.replace(PARAM_SETS[g], n=32))
              for g in ("std128_fast", "std128_k4", "std128_shortint_fast")]
    geomsS += [("mega14", dataclasses.replace(
        PARAM_SETS["std128_shortint_fast"], name="n256_b8l2", n=32, N=256))]
    geomsS += [("mega13", dataclasses.replace(PARAM_SETS[g], n=32))
               for g in ("std128_shortint_fast", "toy")]
    geomsS += [(name, dataclasses.replace(PARAM_SETS[g], n=32))
               for name, g in (("mega17", "std128_shortint_b8"),
                               ("mega15", "std128_shortint_l4"),
                               ("mega16", "std128_shortint_fast"))]
    errS_random = {name: 0 for name in megaS.KERNELS}
    for name, Gp in geomsS:
        extended = megaS.KERNELS[name]
        key_g = torch.randint(-128, 128, megaS.key_shape(Gp, extended),
                              dtype=torch.int8, device=dev, generator=gen_j)
        for Bg in ((B_MAIN, 300, 9) if name in megaS.GADGET
                   else (B_MAIN, 9)):
            acc_g = torch.randint(-2**31, 2**31, (Bg, Gp.k + 1, Gp.N),
                                  dtype=torch.int32, device=dev,
                                  generator=gen_j)
            a_g = torch.randint(0, 2 * Gp.N, (Gp.n, Bg), dtype=torch.int32,
                                device=dev, generator=gen_j)
            got = counters[name](Gp, acc_g, a_g, key_g)
            want = (mega13.blind_rotate_plain_btS if name == "mega13"
                    else megaT.plain(name))(Gp, acc_g, a_g, key_g)
            errS_random[name] = max(errS_random[name], abs_err(got, want))
            check(torch.equal(got, want), f"{name} != plain version at "
                  f"{Gp.name}'s geometry, B={Bg}, random inputs")
        del key_g
    err14 = max(err14, errS_random["mega14"])
    err = max(err, errS_random["mega13"])
    errS_b8 = {name: errS_random[name]
               for name in ("mega17", "mega15", "mega16")}
    torch.cuda.empty_cache()
    print(f"kernel vs plain: {', '.join(megaJ.KERNELS)} == their plain "
          f"versions on random inputs and keys at B=9 at the geometries of "
          f"{[g.name for g in geoms]} (n = 32; array equality, max_abs_err "
          f"{errs_j}); mega13, mega14 (and mega17, mega15, mega16, also at "
          f"B=300) == their plain versions on random inputs and keys at B "
          f"in {[B_MAIN, 9]} at "
          f"{[(k, g.name) for k, g in geomsS]} (n = 32; max_abs_err "
          f"{errS_random}); {', '.join(megaJ.KERNELS)} "
          f"(csrc/mega12.cu) == their "
          f"plain versions on random inputs and keys at B in "
          f"{[B_MAIN, 300, 9]} at {[g.name for g in geoms_w]} (n = 32; "
          f"plans (rows a tile, K splits, blocks a cluster) {plans_w})")

    # 9b''. main path L: path A's gate batch at STD128 on mega13, then on
    # mega10 (csrc/mega12.cu's doubled window, on bsk_btk2) and mega3, mega5
    # and mega4 (csrc/mega12.cu's single window, on one bsk_btk), one key at
    # a time (built, used, freed)
    PL = STD128
    groups_l = (("mega10",), ("mega3", "mega5", "mega4"))
    legacy_j = tuple(name for group in groups_l for name in group)
    for name in ("mega13", *legacy_j):
        check(fit_engine(name, PL) == name,
              f"fit_engine({name!r}, {PL.name}) -> {fit_engine(name, PL)}")
    ck_l, sk_l, keygen_l_s = keys_of[PL.name].get()
    rng_l = np.random.default_rng(args.seed + 7)
    c1_l, c2_l = ref.encrypt_bool(ck_l, b1, rng_l), ref.encrypt_bool(
        ck_l, b2, rng_l)
    batch_l = gates.GateBatch(ids, c1_l, c2_l)
    lin_l = gates.gate_linear(PL.n, torch.as_tensor(ids, device=dev),
                              from_numpy_u32(c1_l, dev),
                              from_numpy_u32(c2_l, dev))
    acc0_l, a_t_l = bs.rotation_inputs(PL, lin_l,
                                       bs.make_test_poly(PL, device=dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dsk_l = device_server_key(sk_l, layouts=("bsk_btS",), device=dev)
    reset_counts()
    out_l, l13_s = host_s(lambda: gates.gate_batch(dsk_l, batch_l,
                                                   device=dev))
    counts_l13 = read_counts()
    only(counts_l13, ("mega13",), "main path L on mega13")
    out_l_np = to_numpy_u32(out_l)
    check(out_l_np.shape == (B_MAIN, PL.n + 1),
          f"path L gate output {out_l_np.shape}")
    check(np.array_equal(ref.lwe_decrypt_bool(ck_l, out_l_np), expect),
          f"path L: gate_batch at {PL.name} on mega13 decrypts wrong")
    w1, w2, bias = gates.GATE_COEFFS[names[ids[0]]]
    lin_0 = (np.uint32(w1 & 0xFFFFFFFF) * c1_l[0]
             + np.uint32(w2 & 0xFFFFFFFF) * c2_l[0])
    lin_0[PL.n:] += np.uint32(bias & 0xFFFFFFFF)
    check(np.array_equal(out_l_np[0], ref.bootstrap_bool(sk_l, lin_0)),
          "path L: gate 0 != reference.bootstrap_bool")
    err13_l, plain13_l_ms = vs_plain("mega13", mega13.blind_rotate_plain_btS,
                                     PL, acc0_l, a_t_l, dsk_l.bsk_btS,
                                     widths=WIDTHS_S)
    err = max(err, err13_l)
    rot_l, m13_l_ms = timed_call(lambda: mega13.mega13_blind_rotate(
        PL, acc0_l, a_t_l, dsk_l.bsk_btS))
    peak_l = torch.cuda.max_memory_allocated()
    print(f"main path L ({PL.name}, host keygen {keygen_l_s:.1f} s): "
          f"gate_batch of {B_MAIN} gates on mega13 decrypts to the truth "
          f"table; gate 0 == reference.bootstrap_bool; launches "
          f"{counts_l13}; mega13 == blind_rotate_plain_btS on the batch's "
          f"rotation inputs at B in {list(WIDTHS_S)} (array equality, "
          f"max_abs_err {err13_l})")
    print(f"time: main path L gate_batch B={B_MAIN} on mega13 end to end "
          f"{l13_s:.3f} s = {B_MAIN / l13_s:.1f} bootstraps/s; mega13 "
          f"{m13_l_ms:.3f} ms per rotation; plain {plain13_l_ms:.3f} ms "
          f"{card}")
    res_l, turns_l = {}, {}
    for group in groups_l:
        layout_l = megaJ.KEY_LAYOUTS[group[0]]
        torch.cuda.empty_cache()
        dsk_lk, ingest_l_s = host_s(lambda: device_server_key(
            sk_l, layouts=(layout_l,), device=dev))
        key_l = getattr(dsk_lk, layout_l)
        print(f"main path L: keys to the card ({layout_l} "
              f"{key_l.numel() / 2**30:.3f} GiB) {ingest_l_s:.1f} s")
        plain_cache_l: dict = {}
        for name in group:
            reset_counts()
            out_lk, lk_s = host_s(lambda: gates.gate_batch(
                dsk_lk, batch_l, engine=name, device=dev))
            counts_lk = read_counts()
            only(counts_lk, (name,), f"main path L on {name}")
            out_lk_np = to_numpy_u32(out_lk)
            check(np.array_equal(out_lk_np, out_l_np),
                  f"L: gate_batch on {name} != on mega13")
            check(np.array_equal(ref.lwe_decrypt_bool(ck_l, out_lk_np),
                                 expect),
                  f"L: gate_batch on {name} decrypts wrong")
            got_l, kernel_l_ms = timed_call(lambda: counters[name](
                PL, acc0_l, a_t_l, key_l))
            check(torch.equal(got_l, rot_l),
                  f"L: {name} != mega13 on the batch's rotation inputs")
            widths_l = (B_MAIN, RADIX_VALUES, 9)
            err_l, plain_l_ms = vs_plain(name, megaJ.plain(name), PL, acc0_l,
                                         a_t_l, key_l, plain_cache_l,
                                         widths=widths_l)
            errs_j[name] = max(errs_j[name], err_l)
            bound_l, by_l = bounds.bound_ms(*bounds.rotation(
                PL, B_MAIN, key_l.numel() * key_l.element_size()))
            res_l[name] = {"counts": counts_lk, "path_s": lk_s,
                           "ms": kernel_l_ms, "plain_ms": plain_l_ms,
                           "bound_ms": bound_l, "bound_by": by_l}
            print(f"main path L ({name}): gate_batch of {B_MAIN} gates == "
                  f"mega13's and decrypts to the truth table; {name} == "
                  f"mega13 at B={B_MAIN} and its plain version at B in "
                  f"{list(widths_l)} on the batch's rotation inputs (array "
                  f"equality, max_abs_err {err_l}); launches {counts_lk}")
            print(f"time: main path L gate_batch B={B_MAIN} on {name} end to "
                  f"end {lk_s:.3f} s = {B_MAIN / lk_s:.1f} bootstraps/s; "
                  f"{name} {kernel_l_ms:.3f} ms per rotation, "
                  f"{bound_l / kernel_l_ms:.4f} of the {bound_l:.4f} ms "
                  f"bound ({by_l}); plain {plain_l_ms:.3f} ms; plan "
                  f"{mega12_plan(PL, B_MAIN, dev)} {card}")
            del out_lk, got_l
        # mega12.cu's window at N = 1024 under the group's wrappers, in
        # turns with each other and with mega13 on the same batch (outputs
        # array-equal)
        turns = in_turns(PL, acc0_l, a_t_l, {
            **{name: (counters[name], key_l) for name in group},
            "mega13": (mega13.mega13_blind_rotate, dsk_l.bsk_btS)},
            same=(*group, "mega13"))
        for name in group:
            turns_l[name] = turns
            report_turns(name, PL, turns, key_l.numel())
        peak_l = max(peak_l, torch.cuda.max_memory_allocated())
        del dsk_lk, key_l
    del rot_l, dsk_l
    torch.cuda.empty_cache()
    print(f"memory: path L torch.cuda.max_memory_allocated "
          f"{peak_l / 2**30:.3f} GiB {card}")

    # 9c. main path I: path C's job on pallas_mega11, over the rows of path
    # C's first partition in one partition ------------------------------
    torch.cuda.reset_peak_memory_stats()
    rows_i = JOB_ROWS // JOB_PARTITIONS
    with tempfile.TemporaryDirectory() as workdir:
        res_i = path_c("pallas_mega11", workdir, rows=rows_i, partitions=1)
    peak_i = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    res_i_counts = res_i["counts"]
    only(res_i_counts, ("mega11",), "path I on pallas_mega11")
    check(res_i["mid"] == runs["pallas_fused"]["mid"][:1],
          "path I intermediate frame differs from the first partition of "
          "path C's on pallas_fused")
    job_i = res_i["job"]
    load, exe, store = res_i["phases"]
    wall_i, mid_i = job_i.wall_time_s, res_i["mid"]
    print(f"main path I (pallas_mega11): {rows_i} rows (path C's first "
          f"partition) in 1 partition, map + PARALLEL reduce: COMPLETED, "
          f"retries 0, {job_i.bootstraps_executed} bootstraps; all {rows_i} "
          f"intermediate rows and the reduced row decrypt right; the "
          f"intermediate frame byte-equal to the first partition of path C's "
          f"on pallas_fused; launches {res_i['counts']}")
    print(f"time: main path I job on pallas_mega11 wall "
          f"{job_i.wall_time_s:.3f} s (host {res_i['host_s']:.3f} s), "
          f"{job_i.bootstraps_executed} bootstraps = "
          f"{job_i.bootstraps_per_sec:.1f} bootstraps/s; runner load "
          f"{load:.3f} s, exec {exe:.3f} s, store {store:.3f} s, key "
          f"ingest and the rest {job_i.wall_time_s - load - exe - store:.3f} "
          f"s; CUDA events around its {len(res_i['rotations'])} rotations "
          f"on mega11 span {res_i['rotation_s']:.3f} s in all {card}")
    print(f"memory: path I torch.cuda.max_memory_allocated "
          f"{peak_i / 2**30:.3f} GiB {card}")

    # 9c'. main path S3: path I's job (its 512 rows, its plan) through
    # PlanCompiler(mesh=(2, 1)) on mega11, both positions on this card: the
    # frames equal path I's --------------------------------------------------
    dsk_s3 = device_server_key(sk, layouts=layouts_for_engine("mega11"),
                               device=dev)
    rows_s3 = from_numpy_u32(frame_codec.payloads_to_rows(
        payloads[:rows_i], 16, P), dev)
    frame_s3 = "00000000-0000-0000-0000-0000000000c3"
    compiler_s3 = PlanCompiler(dsk_s3, engine="mega11", mesh=card_mesh(2))
    res_s3 = path_s("S3", lambda: compiler_s3.execute(
        job_plan(frame_s3), {frame_s3: FrameData(JOB_IN_COLS, rows_s3, 1)}),
        exe, "path I's plan through PlanCompiler(mesh=(2, 1)), mega11; "
        "beside path I's runner exec")
    only(res_s["S3"]["counts"], ("mega11",), "path S3")
    for label, got_s3, parts in (
            ("output", res_s3.outputs, res_i["out"]),
            ("intermediate", {k: v for k, v in res_s3.intermediates.items()
                              if tuple(v.data.shape[:2]) == (rows_i, 9)},
             res_i["mid"])):
        (frame_got,) = got_s3.values()
        want_s3 = frame_codec.payloads_to_rows(
            [pl for part in parts for pl in rowcodec.parse_rows(part)], 9, P)
        check(np.array_equal(to_numpy_u32(frame_got.data), want_s3),
              f"path S3's {label} frame != path I's")
    del dsk_s3, compiler_s3, res_s3, rows_s3
    print(f"main path S3: path I's plan ({rows_i} rows, map + PARALLEL "
          f"reduce) through PlanCompiler(mesh=(2, 1)) on mega11, the rows "
          f"split over two positions of this card: the output and "
          f"intermediate frames == path I's (array equality of every row)")

    # 9d. main path M: the JAX package's R-major legacy engines on path A's
    # key. M1: path A's gate batch on mega and mega2 (csrc/mega12.cu's
    # single window, on the bsk_btk that mega12.kmajor_from_bt re-lays from
    # that bsk_bt), timed in turns with bt_fused (the same function on
    # bsk_bt in 2n launches) and mega7 (the same kernel on the same
    # bsk_btk) ---------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    row_j = ("mega", "mega2")
    key_k, relay_s = host_s(lambda: mega12.kmajor_from_bt(dsk.bsk_bt,
                                                          P.k + 1))
    dsk_m = dataclasses.replace(dsk, bsk_btk=key_k)
    print(f"main path M1: bsk_btk re-laid from path A's bsk_bt on the card "
          f"(mega12.kmajor_from_bt, {key_k.numel() / 2**30:.3f} GiB) "
          f"{relay_s:.1f} s")
    res_m = {}
    plain_cache_m: dict = {}
    for name in row_j:
        check(fit_engine(name, P) == name and layouts_for_engine(name)
              == ("bsk_btk",), f"fit_engine({name!r}, "
              f"{P.name}) -> {fit_engine(name, P)}")
        err_m, plain_m_ms = vs_plain(name, megaJ.plain(name), P, acc0, a_t,
                                     key_k, plain_cache_m)
        errs_j[name] = max(errs_j[name], err_m)
        check(torch.equal(bs.blind_rotate_batch(dsk_m, lin, tp, engine=name),
                          outs[B_MAIN]),
              f"M: blind_rotate_batch on {name} != mega13 at B={B_MAIN}")
        reset_counts()
        out_m, m_s = host_s(lambda: gates.gate_batch(dsk_m, batch, engine=name,
                                                     device=dev))
        counts_m = read_counts()
        only(counts_m, (name,), f"main path M1 on {name}")
        out_m_np = to_numpy_u32(out_m)
        check(np.array_equal(out_m_np, out_np),
              f"M1: gate_batch on {name} != on mega13 (path A)")
        check(np.array_equal(ref.lwe_decrypt_bool(ck, out_m_np), expect),
              f"M1: gate_batch on {name} decrypts wrong")
        res_m[name] = {"counts": counts_m, "plain_ms": plain_m_ms,
                       "path_s": m_s}
        print(f"main path M1 ({name}): {name} == {megaJ.plain(name).__name__} "
              f"on the gate batch's rotation inputs at B in "
              f"{[B_MAIN, RADIX_VALUES, 9]} (array equality, max_abs_err "
              f"{err_m}); blind_rotate_batch == mega13's; gate_batch of "
              f"{B_MAIN} gates == path A's mega13 output and decrypts to the "
              f"truth table; launches {counts_m}")
        del out_m
    for B in (B_MAIN, RADIX_VALUES):  # mega7's warm-up at these shapes
        check(torch.equal(megaJ.mega7_blind_rotate(
            P, acc0[:B].contiguous(), a_t[:, :B].contiguous(), key_k),
            outs[B]), f"M1: mega7 on the re-laid bsk_btk != mega13 at B={B}")

    bt_fused_rotation(P, acc0[:RADIX_VALUES].contiguous(),
                      a_t[:, :RADIX_VALUES].contiguous(), dsk.bsk_bt)
    names_m = (*row_j, "bt_fused", "mega7")
    times_m = rotation_times(
        names_m, P, acc0, a_t, {"mega": key_k, "mega2": key_k,
                                "bt_fused": dsk.bsk_bt, "mega7": key_k},
        dict.fromkeys((*row_j, "mega7"), mega12_plan),
        fns={"bt_fused": bt_fused_rotation})
    del dsk_m, key_k
    torch.cuda.empty_cache()
    peak_m = torch.cuda.max_memory_allocated()
    for name in row_j:
        res_m[name].update(times_m[name])
        print_times(name, P, res_m[name], res_m[name]["plain_ms"])
        print(f"time: main path M1 gate_batch B={B_MAIN} on {name} end to "
              f"end {res_m[name]['path_s']:.3f} s = "
              f"{B_MAIN / res_m[name]['path_s']:.1f} bootstraps/s {card}")
    for other in ("bt_fused", "mega7"):
        t = times_m[other]
        print(f"time: {other} at {P.name} B={B_MAIN} {t['ms']:.3f} ms, "
              f"B={RADIX_VALUES} {t['narrow_ms']:.3f} ms (timed in turns "
              f"{[*names_m, *names_m[::-1]]}) {card}")
    for name in row_j:
        for other in ("bt_fused", "mega7", *(o for o in row_j if o != name)):
            a_, b_ = times_m[other], times_m[name]
            print(f"time: {name} / {other} at {P.name}: B={B_MAIN} "
                  f"{b_['ms'] / a_['ms']:.4f}, B={RADIX_VALUES} "
                  f"{b_['narrow_ms'] / a_['narrow_ms']:.4f} {card}")
    print(f"memory: path M1 torch.cuda.max_memory_allocated "
          f"{peak_m / 2**30:.3f} GiB {card}")

    # M2: path I's job (path C's first partition) on pallas_mega2, then on
    # pallas_mega ------------------------------------------------------------
    res_m2, res_m2_s = {}, {}
    for engine in ("pallas_mega2", "pallas_mega"):
        name = engine.removeprefix("pallas_")
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as workdir:
            r_m = path_c(engine, workdir, rows=rows_i, partitions=1)
        peak_m2 = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        only(r_m["counts"], (name,), f"path M2 on {engine}")
        check(r_m["mid"] == runs["pallas_fused"]["mid"][:1],
              f"path M2 ({engine}) intermediate frame differs from the "
              f"first partition of path C's on pallas_fused")
        job_m = r_m["job"]
        load, exe, store = r_m["phases"]
        res_m2[name] = r_m["counts"]
        print(f"main path M2 ({engine}): {rows_i} rows (path C's first "
              f"partition) in 1 partition, map + PARALLEL reduce: COMPLETED, "
              f"retries {job_m.retries}, {job_m.bootstraps_executed} "
              f"bootstraps; all {rows_i} intermediate rows and the reduced "
              f"row decrypt right; the intermediate frame byte-equal to the "
              f"first partition of path C's on pallas_fused; launches "
              f"{r_m['counts']}")
        widths_m2 = [B for B, _ in r_m["rotations"]]
        res_m2_s[name] = r_m["rotation_s"]
        print(f"time: main path M2 job on {engine} wall "
              f"{job_m.wall_time_s:.3f} s (host {r_m['host_s']:.3f} s), "
              f"{job_m.bootstraps_executed} bootstraps = "
              f"{job_m.bootstraps_per_sec:.1f} bootstraps/s; runner load "
              f"{load:.3f} s, exec {exe:.3f} s, store {store:.3f} s, key "
              f"ingest and the rest "
              f"{job_m.wall_time_s - load - exe - store:.3f} s; "
              f"{len(widths_m2)} rotations on {name} (widths "
              f"{sorted(widths_m2, reverse=True)}, "
              f"{sum(widths_m2) / len(widths_m2):.1f} on average) span "
              f"{r_m['rotation_s']:.3f} s of the stream in all (CUDA "
              f"events around each); torch.cuda.max_memory_allocated "
              f"{peak_m2 / 2**30:.3f} GiB {card}")
        del r_m, job_m

    # 10. path D setup: the integer tier at STD128_SHORTINT -----------------
    PS = PARAM_SETS["std128_shortint"]
    # path A-C's keys and inputs; the adder job and path C's jobs hold
    # STD128_K2 keys (3.4 GiB of bsk_bt each)
    del dsk, key_q, full, full_t, d8_q, run, runs, r, job, res_i, job_i
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    *keys_d, keygen_s = keys_of[PS.name].get()
    short, ingest_s = host_s(lambda: ShortContext(
        PS, msg_bits=2, carry_bits=2, keys=keys_d, seed=args.seed,
        device=dev))
    check(short.engine == "mega12" and short.many_lut,
          f"ShortContext at {PS.name} took engine {short.engine}, many-LUT "
          f"{short.many_lut}")
    key12 = short.dsk.bsk_btk
    print(f"setup: {PS.name} host keygen {keygen_s:.1f} s (worker "
          f"process); ShortContext "
          f"key ingest (fit_engine -> {short.engine}, bsk_btk "
          f"{key12.numel() / 2**30:.3f} GiB built on the card) "
          f"{ingest_s:.1f} s")
    vals = np.random.default_rng(args.seed + 99)
    av, bv = vals.integers(0, 4, B_MAIN), vals.integers(0, 4, B_MAIN)
    a, b = short.encrypt(av), short.encrypt(bv)
    m = short.modulus
    mul_t = [((t >> short.msg_bits) * (t & (m - 1))) % m
             for t in range(short.space)]
    # D1's first rotation: a*b's packed bivariate LUT (shortint.py __mul__)
    acc0_d, a_t_d = bs.rotation_inputs(
        PS, a.data * m + b.data,
        pbs.lut_test_poly(PS, mul_t, short.space_bits, device=dev))
    err12 = 0
    widths12 = (B_MAIN, RADIX_VALUES, 65, 9, 1)
    for B in widths12:
        x = acc0_d[:B].contiguous(), a_t_d[:, :B].contiguous()
        got = mega12.mega12_blind_rotate(PS, *x, key12)
        want, ms = timed_call(lambda: mega12.blind_rotate_plain_btk(
            PS, *x, key12))
        err12 = max(err12, abs_err(got, want))
        check(torch.equal(got, want), f"mega12 != plain version at {PS.name} "
              f"B={B} (D1's first rotation)")
        if B == B_MAIN:
            plain12_ms = ms
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # STD128_K2's, STD128's and STD128_SHORTINT_L4's geometries, random
    for Gp in (P, Q, PARAM_SETS["std128_shortint_l4"]):
        key_g = torch.randint(-128, 128, mega12.key_shape(Gp),
                              dtype=torch.int8, device=dev, generator=gen)
        acc_g = torch.randint(-2**31, 2**31, (9, Gp.k + 1, Gp.N),
                              dtype=torch.int32, device=dev, generator=gen)
        a_g = torch.randint(0, 2 * Gp.N, (Gp.n, 9), dtype=torch.int32,
                            device=dev, generator=gen)
        got = mega12.mega12_blind_rotate(Gp, acc_g, a_g, key_g)
        want = mega12.blind_rotate_plain_btk(Gp, acc_g, a_g, key_g)
        err12 = max(err12, abs_err(got, want))
        check(torch.equal(got, want), f"mega12 != plain version at "
              f"{Gp.name}'s geometry, B=9, random inputs")
        del key_g
    torch.cuda.empty_cache()
    plans12 = {B: mega12.kernel_plan(PS, B, n_sms)
               for B in (2560, B_MAIN, 1536, RADIX_VALUES, 65, 9, 1)}
    check(all(pl == tuple(mega12.plan(PS, B, n_sms))[:3]
              for B, pl in plans12.items()),
          f"mega12's plan {plans12} differs from mega12.plan")
    print(f"kernel vs plain: mega12 == blind_rotate_plain_btk at {PS.name} "
          f"on D1's first rotation inputs, B in {list(widths12)}, and on "
          f"random inputs and keys at B=9 at {P.name}'s, {Q.name}'s and "
          f"std128_shortint_l4's geometries (array equality, max_abs_err "
          f"{err12}); (rows a tile, K splits, blocks a cluster) by B: "
          f"{plans12}")

    # 11. main paths D1 (shortint) and D2 (radix) ---------------------------
    def d1(ctx, a, b):
        """(a*b)+a, reduced (the decrypt's PBS), then decrypted."""
        rr = ((a * b) + a).reduce()
        return rr, ctx.decrypt(rr)

    reset_counts()
    rot0 = short.rotations
    (r12, dec12), d1_s = host_s(lambda: d1(short, a, b))
    counts_d1 = read_counts()
    d1_rot = short.rotations - rot0
    check(dec12 == ((av * bv + av) % 4).tolist(),
          f"D1: {int((np.array(dec12) != (av * bv + av) % 4).sum())} of "
          f"{B_MAIN} shortint values decrypt wrong")
    only(counts_d1, ("mega12",), "D1 on mega12")
    check(tuple(r12.data.shape) == (B_MAIN, PS.n + 1),
          f"D1 output shape {tuple(r12.data.shape)}")
    short13, _ = host_s(lambda: ShortContext(
        PS, msg_bits=2, carry_bits=2, engine="mega13", keys=keys_d,
        seed=args.seed, device=dev))
    a13, b13 = short13.encrypt(av), short13.encrypt(bv)
    check(torch.equal(a13.data, a.data) and torch.equal(b13.data, b.data),
          "the mega13 context's encryptions differ from the mega12 one's")
    err13_d, plain13_d_ms = vs_plain("mega13", mega13.blind_rotate_plain_btS,
                                     PS, acc0_d, a_t_d, short13.dsk.bsk_btS,
                                     widths=WIDTHS_S)
    err = max(err, err13_d)
    _, m13_d_ms = timed_call(lambda: mega13.mega13_blind_rotate(
        PS, acc0_d, a_t_d, short13.dsk.bsk_btS))
    reset_counts()
    (r13, dec13), d1_13_s = host_s(lambda: d1(short13, a13, b13))
    counts_d1_13 = read_counts()
    only(counts_d1_13, ("mega13",), "D1 on mega13")
    check(torch.equal(r13.data, r12.data) and dec13 == dec12,
          "D1 on mega13 != D1 on mega12")
    del short13, a13, b13, r13
    print(f"main path D1: ShortContext (a*b)+a over {B_MAIN} encrypted 2-bit "
          f"values on mega12: every value decrypts right; {d1_rot} "
          f"rotations; launches {counts_d1}; the same on mega13 is "
          f"array-equal; launches {counts_d1_13}; mega13 == "
          f"blind_rotate_plain_btS on D1's first rotation inputs at B in "
          f"{list(WIDTHS_S)} (array equality, max_abs_err {err13_d}); mega13 "
          f"{m13_d_ms:.3f} ms per rotation at B={B_MAIN}, plain "
          f"{plain13_d_ms:.3f} ms {card}")

    # 11'. main path S4: D1 on ShortContext(mesh=(2, 1)) with path D's keys
    # and key tensors, both positions on this card ----------------------
    short_s4 = ShortContext(PS, msg_bits=2, carry_bits=2, keys=keys_d,
                            dsk=short.dsk, seed=args.seed, mesh=card_mesh(2),
                            device=dev)
    a4, b4 = short_s4.encrypt(av), short_s4.encrypt(bv)
    check(torch.equal(a4.data, a.data) and torch.equal(b4.data, b.data),
          "path S4's encryptions differ from D1's")
    r4, dec4 = path_s("S4", lambda: d1(short_s4, a4, b4), d1_s,
                      "D1 on ShortContext(mesh=(2, 1)), mega12")
    only(res_s["S4"]["counts"], ("mega12",), "path S4")
    check(torch.equal(r4.data, r12.data) and dec4 == dec12,
          "path S4 != D1 on one device")
    del short_s4, a4, b4, r4
    print(f"main path S4: D1 ((a*b)+a over {B_MAIN} values, reduced and "
          f"decrypted) on ShortContext(mesh=(2, 1)) sharing path D's key "
          f"tensors: every PBS batch split over two positions of this card; "
          f"the ciphertexts == D1's (array equality), every value decrypts "
          f"right")

    rctx = RadixContext(short, n_blocks=4)
    av2 = vals.integers(0, 256, RADIX_VALUES)
    bv2 = vals.integers(1, 256, RADIX_VALUES)
    x2, y2 = rctx.encrypt(av2), rctx.encrypt(bv2)
    widths: list[int] = []

    def recording(fn):
        def wrapped(data, tables):
            widths.append(int(data.shape[0]))
            return fn(data, tables)
        return wrapped

    short._pbs, short._pbs_many = recording(short._pbs), recording(
        short._pbs_many)

    def d2():
        prod = x2 * y2
        n_mul = len(widths)
        return rctx.decrypt(prod), n_mul

    reset_counts()
    rot0 = short.rotations
    (dec2, n_mul), d2_s = host_s(d2)
    counts_d2 = read_counts()
    d2_rot = short.rotations - rot0
    del short._pbs, short._pbs_many
    check(dec2 == ((av2 * bv2) % 256).tolist(),
          f"D2: {int((np.array(dec2) != (av2 * bv2) % 256).sum())} of "
          f"{RADIX_VALUES} 8-bit products decrypt wrong")
    only(counts_d2, ("mega12",), "D2 on mega12")
    print(f"main path D2: RadixContext(n_blocks=4) 8-bit multiply over "
          f"{RADIX_VALUES} values on mega12: every product decrypts to "
          f"(a*b) mod 256; rotation widths of the multiply "
          f"{widths[:n_mul]}, of the decrypt {widths[n_mul:]}; {d2_rot} "
          f"rotations; launches {counts_d2}")

    # 12. times of path D ---------------------------------------------------
    # mega12 in turns with bt_fused's rotation (2n launches of the per-step
    # kernels) on the same inputs; bsk_bt (9 GiB) is built for it and freed
    key_bt = device_server_key(keys_d[1], layouts=("bsk_bt",),
                               device=dev).bsk_bt
    step_fused = bs.STEP_ENGINES["bt_fused"][0]

    def fused_rotation(acc0, a_t):
        acc = acc0
        for i in range(PS.n):
            acc = step_fused(PS, acc, a_t[i], key_bt[i])
        return acc

    t12: dict[int, dict[str, float]] = {}
    for B in (B_MAIN, RADIX_VALUES):  # each engine's best of two turns
        x = acc0_d[:B].contiguous(), a_t_d[:, :B].contiguous()
        outs, ms = {}, {"mega12": [], "bt_fused": []}
        for name in ("mega12", "bt_fused", "bt_fused", "mega12"):
            outs[name], t = timed_call(
                (lambda: fused_rotation(*x)) if name == "bt_fused"
                else (lambda: mega12.mega12_blind_rotate(PS, *x, key12)))
            ms[name].append(t)
        check(torch.equal(outs["mega12"], outs["bt_fused"]),
              f"mega12 != bt_fused's rotation at {PS.name} B={B}")
        t12[B] = {k: min(v) for k, v in ms.items()}
    del key_bt, outs
    torch.cuda.empty_cache()
    m12_ms, narrow12_ms = t12[B_MAIN]["mega12"], t12[RADIX_VALUES]["mega12"]
    bound12_ms, bound12_by = bounds.bound_ms(
        *bounds.rotation(PS, B_MAIN, key12.numel()))
    for B, t in t12.items():
        b_ms, b_by = bounds.bound_ms(*bounds.rotation(PS, B, key12.numel()))
        print(f"time: mega12 B={B} {t['mega12']:.3f} ms = "
              f"{B / t['mega12'] * 1e3:.1f} bootstraps/s, "
              f"{b_ms / t['mega12']:.4f} of the {b_ms:.4f} ms bound ({b_by}), "
              f"plan (rows, splits, cluster) {plans12[B]}; bt_fused's "
              f"rotation (2n launches) {t['bt_fused']:.3f} ms in turns on "
              f"the same inputs, array-equal; mega12 / bt_fused "
              f"{t['mega12'] / t['bt_fused']:.4f}"
              + (f"; plain {plain12_ms:.3f} ms" if B == B_MAIN else "")
              + f" {card}")
    print(f"time: main path D1 (a*b)+a over {B_MAIN} values end to end "
          f"{d1_s:.3f} s on mega12 = {d1_rot / d1_s:.1f} rotations/s, "
          f"{d1_13_s:.3f} s on mega13 {card}")
    print(f"time: main path D2 8-bit multiply over {RADIX_VALUES} values end "
          f"to end {d2_s:.3f} s = {d2_rot / d2_s:.1f} rotations/s, "
          f"{RADIX_VALUES / d2_s:.2f} multiplies/s {card}")
    print(f"memory: path D torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card}")
    d1_out = r12.data  # path J's reference; r12 holds the mega12 context
    del short, key12, rctx, a, b, r12, x2, y2, acc0_d, a_t_d  # path D's
    d1_values = ((av * bv + av) % 4).tolist()

    # 12b. main path J: D1 on mega7 (the JAX chain's mega12 -> mega7) ------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx7, ingest7_s = host_s(lambda: ShortContext(
        PS, msg_bits=2, carry_bits=2, engine="mega7", keys=keys_d,
        seed=args.seed, device=dev))
    check(ctx7.engine == "mega7" and ctx7.dsk.bsk_btk is not None
          and ctx7.dsk.bsk_btj is None,
          f"ShortContext(engine='mega7') at {PS.name} took engine "
          f"{ctx7.engine}")
    key7 = ctx7.dsk.bsk_btk
    a7, b7 = ctx7.encrypt(av), ctx7.encrypt(bv)
    acc0_j, a_t_j = bs.rotation_inputs(
        PS, a7.data * m + b7.data,
        pbs.lut_test_poly(PS, mul_t, ctx7.space_bits, device=dev))
    err7, plain7_ms = vs_plain("mega7", mega12.blind_rotate_plain_btk, PS,
                               acc0_j, a_t_j, key7,
                               widths=(B_MAIN, RADIX_VALUES, 9, 1))
    errs_j["mega7"] = max(errs_j["mega7"], err7)
    reset_counts()
    rot0 = ctx7.rotations
    (r7, dec7), j_s = host_s(lambda: d1(ctx7, a7, b7))
    counts_j = read_counts()
    j_rot = ctx7.rotations - rot0
    peak_j = torch.cuda.max_memory_allocated()
    only(counts_j, ("mega7",), "main path J on mega7")
    wrong = sum(x != y for x, y in zip(dec7, d1_values))
    check(dec7 == d1_values, f"J: {wrong} of {B_MAIN} values decrypt wrong "
          f"on mega7")
    check(torch.equal(r7.data, d1_out), "J on mega7 != D1 on mega12")
    res_j = {"counts": counts_j, "plain_ms": plain7_ms,
             **rotation_times(("mega7",), PS, acc0_j, a_t_j, {"mega7": key7},
                              {"mega7": mega12_plan})["mega7"]}
    # mega7 in turns with mega12 on the same key and inputs: one kernel
    turns7 = in_turns(PS, acc0_j, a_t_j, {
        "mega7": (megaJ.mega7_blind_rotate, key7),
        "mega12": (mega12.mega12_blind_rotate, key7)},
        same=("mega7", "mega12"))
    report_turns("mega7", PS, turns7, key7.numel())
    print(f"main path J: ShortContext key ingest (fit_engine -> "
          f"{ctx7.engine}, bsk_btk {key7.numel() / 2**30:.3f} GiB built on "
          f"the card) {ingest7_s:.1f} s; mega7 == blind_rotate_plain_btk on "
          f"the first rotation's inputs at B in "
          f"{[B_MAIN, RADIX_VALUES, 9, 1]} (array equality, max_abs_err "
          f"{err7}); (a*b)+a over {B_MAIN} values: "
          f"every value decrypts right and the ciphertexts equal D1's on "
          f"mega12; {j_rot} rotations; launches {counts_j}")
    print_times("mega7", PS, res_j, plain7_ms)
    print(f"time: main path J (a*b)+a over {B_MAIN} values end to end "
          f"{j_s:.3f} s on mega7 = {j_rot / j_s:.1f} rotations/s, {d1_s:.3f} "
          f"s on mega12 (D1) {card}")
    print(f"memory: path J on mega7 torch.cuda.max_memory_allocated "
          f"{peak_j / 2**30:.3f} GiB {card}")
    del ctx7, key7, a7, b7, r7, d1_out, acc0_j, a_t_j

    # 13-16. paths E, F, G: the byte-aligned kernels (mega17, mega16 and
    # mega15, mega13's kernel of megaS.cu through their own entries) -------
    def integer_path(label: str, pset: str, engine: str) -> dict:
        """Main path E or G: D1's (a*b)+a over the same 2048 values at
        ``pset`` on ``engine``, then on mega12 with the same keys and
        seed, which must give the same ciphertexts; ``engine`` in turns
        with mega13's entry of the same kernel on the same key bytes and
        inputs."""
        PX = PARAM_SETS[pset]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        *keys_x, keygen_x_s = keys_of[pset].get()
        ctx, ingest_x_s = host_s(lambda: ShortContext(
            PX, msg_bits=2, carry_bits=2, engine=engine, keys=keys_x,
            seed=args.seed, device=dev))
        check(ctx.engine == engine and ctx.dsk.bsk_btTc is not None
              and ctx.dsk.bsk_btk is None,
              f"ShortContext(engine={engine!r}) at {PX.name} took engine "
              f"{ctx.engine}")
        key = ctx.dsk.bsk_btTc
        xa, xb = ctx.encrypt(av), ctx.encrypt(bv)
        acc0_x, a_t_x = bs.rotation_inputs(
            PX, xa.data * m + xb.data,
            pbs.lut_test_poly(PX, mul_t, ctx.space_bits, device=dev))
        err, plain_ms = vs_plain(engine, megaT.blind_rotate_plain_btTc, PX,
                                 acc0_x, a_t_x, key)
        reset_counts()
        rot0 = ctx.rotations
        (r, dec), path_s = host_s(lambda: d1(ctx, xa, xb))
        counts = read_counts()
        rotations = ctx.rotations - rot0
        peak = torch.cuda.max_memory_allocated()
        wrong = sum(x != y for x, y in zip(dec, d1_values))
        check(dec == d1_values, f"{label}: {wrong} of {B_MAIN} values "
              f"decrypt wrong at {PX.name}")
        only(counts, (engine,), f"main path {label} on {engine}")
        # the rerun on mega12 takes the first RADIX_VALUES of the same
        # ciphertexts (each value's result is its own row)
        ctx12 = ShortContext(PX, msg_bits=2, carry_bits=2, engine="mega12",
                             keys=keys_x, seed=args.seed, device=dev)
        ya, yb = ctx12.encrypt(av), ctx12.encrypt(bv)
        check(ctx12.engine == "mega12" and torch.equal(ya.data, xa.data)
              and torch.equal(yb.data, xb.data),
              f"{label}: the mega12 context differs from the {engine} one")
        ya, yb = (EncShort(ctx12, y.data[:RADIX_VALUES].contiguous(),
                           y.max_val) for y in (ya, yb))
        reset_counts()
        (r12x, dec12x), path12_s = host_s(lambda: d1(ctx12, ya, yb))
        counts12 = read_counts()
        only(counts12, ("mega12",), f"main path {label} on mega12")
        check(torch.equal(r12x.data, r.data[:RADIX_VALUES])
              and dec12x == dec[:RADIX_VALUES],
              f"{label} on mega12 != {label} on {engine} (first "
              f"{RADIX_VALUES} values)")
        del ctx12, ya, yb, r12x
        torch.cuda.empty_cache()
        t = rotation_times((engine,), PX, acc0_x, a_t_x, {engine: key},
                           {engine: megaS_units(engine)})[engine]
        turns = in_turns(PX, acc0_x, a_t_x, {
            engine: (counters[engine], key),
            "mega13": (lambda p, a, b, k: megaS.launch("mega13", p, a, b, k),
                       key)},
            same=(engine, "mega13"))
        report_turns(engine, PX, turns, key.numel())
        print(f"main path {label}: {PX.name} host keygen {keygen_x_s:.1f} s "
              f"(worker process); ShortContext key ingest (fit_engine -> "
              f"{ctx.engine}, bsk_btTc {key.numel() / 2**20:.1f} MiB built on "
              f"the card) {ingest_x_s:.1f} s; {engine} == "
              f"blind_rotate_plain_btTc on the first rotation's inputs at B "
              f"in {[B_MAIN, RADIX_VALUES, 9]} (array equality, max_abs_err "
              f"{err}); (a*b)+a over {B_MAIN} values: every value decrypts "
              f"right; {rotations} rotations; launches {counts}; the same on "
              f"mega12 over the first {RADIX_VALUES} values is array-equal; "
              f"launches {counts12}")
        print(f"time: {engine} B={B_MAIN} {t['ms']:.3f} ms = "
              f"{B_MAIN / t['ms'] * 1e3:.1f} bootstraps/s, "
              f"{t['bound_ms'] / t['ms']:.4f} of the {t['bound_ms']:.2f} ms "
              f"bound ({t['bound_by']}), on tensor cores; B={RADIX_VALUES} "
              f"{t['narrow_ms']:.3f} ms; plain {plain_ms:.3f} ms at "
              f"B={B_MAIN}; (work units, K splits) by B {t['G']} {card}")
        print(f"time: main path {label} (a*b)+a over {B_MAIN} values end to "
              f"end {path_s:.3f} s on {engine} = {rotations / path_s:.1f} "
              f"rotations/s; over {RADIX_VALUES} values {path12_s:.3f} s on "
              f"mega12 {card}")
        print(f"memory: path {label} on {engine} torch.cuda."
              f"max_memory_allocated {peak / 2**30:.3f} GiB {card}")
        return {"counts": counts, "counts12": counts12, "err": err,
                "plain_ms": plain_ms, "turns": turns, **t}

    res_e = integer_path("E", "std128_shortint_b8", "mega17")
    res_e["err"] = max(res_e["err"], errS_b8["mega17"])

    # F: bool gates at STD128_SHORTINT_FAST on mega16, then on mega13
    PF = PARAM_SETS["std128_shortint_fast"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck_f, sk_f, keygen_f_s = keys_of[PF.name].get()
    check(fit_engine("mega16", PF) == "mega16"
          and fit_engine("mega13", PF) == "mega13"
          and fit_engine("mega14", PF) == "mega14",
          f"fit_engine at {PF.name}: mega16 -> {fit_engine('mega16', PF)}, "
          f"mega13 -> {fit_engine('mega13', PF)}, mega14 -> "
          f"{fit_engine('mega14', PF)}")
    dsk_f, ingest_f_s = host_s(lambda: device_server_key(
        sk_f, layouts=layouts_for_engine("mega16") + layouts_for_engine(
            "mega13") + layouts_for_engine("mega14"), device=dev))
    rng_f = np.random.default_rng(args.seed + 7)
    f1 = rng_f.integers(0, 2, B_MAIN).astype(bool)
    f2 = rng_f.integers(0, 2, B_MAIN).astype(bool)
    cf1, cf2 = ref.encrypt_bool(ck_f, f1, rng_f), ref.encrypt_bool(ck_f, f2,
                                                                   rng_f)
    batch_f = gates.GateBatch(ids, cf1, cf2)
    lin_f = gates.gate_linear(PF.n, torch.as_tensor(ids, device=dev),
                              from_numpy_u32(cf1, dev),
                              from_numpy_u32(cf2, dev))
    acc0_f, a_t_f = bs.rotation_inputs(PF, lin_f,
                                       bs.make_test_poly(PF, device=dev))
    err16, plain16_ms = vs_plain("mega16", megaT.blind_rotate_plain_btTc, PF,
                                 acc0_f, a_t_f, dsk_f.bsk_btTc)
    reset_counts()
    out_f, f_s = host_s(lambda: gates.gate_batch(dsk_f, batch_f,
                                                 engine="mega16", device=dev))
    counts_f = read_counts()
    peak_f = torch.cuda.max_memory_allocated()
    only(counts_f, ("mega16",), "main path F on mega16")
    truth_f = {"AND": f1 & f2, "OR": f1 | f2, "NAND": ~(f1 & f2),
               "NOR": ~(f1 | f2), "XOR": f1 ^ f2, "XNOR": ~(f1 ^ f2)}
    expect_f = np.array([truth_f[names[g]][i] for i, g in enumerate(ids)])
    out_f_np = to_numpy_u32(out_f)
    check(out_f_np.shape == (B_MAIN, PF.n + 1), f"F output {out_f_np.shape}")
    dec_f = ref.lwe_decrypt_bool(ck_f, out_f_np)
    check(np.array_equal(dec_f, expect_f),
          f"F: {int((dec_f != expect_f).sum())} of {B_MAIN} gates decrypt "
          f"wrong at {PF.name}")
    reset_counts()
    out_f13, f13_s = host_s(lambda: gates.gate_batch(
        dsk_f, batch_f, engine="mega13", device=dev))
    counts_f13 = read_counts()
    only(counts_f13, ("mega13",), "main path F on mega13")
    check(torch.equal(out_f13, out_f), "F on mega13 != F on mega16")
    t_f = rotation_times(("mega16",), PF, acc0_f, a_t_f,
                         {"mega16": dsk_f.bsk_btTc},
                         {"mega16": megaS_units("mega16")})["mega16"]
    # in turns with mega13's entry of the same kernel on the same key bytes
    # (bsk_btTc is bsk_btS at N >= 128) and inputs
    turns_f = in_turns(PF, acc0_f, a_t_f, {
        "mega16": (megaT.mega16_blind_rotate, dsk_f.bsk_btTc),
        "mega13": (lambda p, a, b, k: megaS.launch("mega13", p, a, b, k),
                   dsk_f.bsk_btTc)},
        same=("mega16", "mega13"))
    report_turns("mega16", PF, turns_f, dsk_f.bsk_btTc.numel())
    res_f = {"counts": counts_f, "counts13": counts_f13,
             "err": max(err16, errS_b8["mega16"]),
             "plain_ms": plain16_ms, "turns": turns_f, **t_f}
    print(f"main path F: {PF.name} host keygen {keygen_f_s:.1f} s (worker "
          f"process); keys to the card (bsk_btTc "
          f"{dsk_f.bsk_btTc.numel() / 2**20:.1f} MiB, bsk_btS, bsk_btTe) "
          f"{ingest_f_s:.1f} "
          f"s; mega16 == blind_rotate_plain_btTc on the gate batch's "
          f"rotation inputs at B in {[B_MAIN, RADIX_VALUES, 9]} (array "
          f"equality, max_abs_err {err16}); gate_batch of {B_MAIN} gates "
          f"decrypts to the truth table; launches {counts_f}; the same "
          f"batch on mega13 is array-equal; launches {counts_f13}")
    print(f"time: mega16 B={B_MAIN} {t_f['ms']:.3f} ms = "
          f"{B_MAIN / t_f['ms'] * 1e3:.1f} bootstraps/s, "
          f"{t_f['bound_ms'] / t_f['ms']:.4f} of the {t_f['bound_ms']:.4f} ms "
          f"bound ({t_f['bound_by']}), on tensor cores; B={RADIX_VALUES} "
          f"{t_f['narrow_ms']:.3f} ms; plain {plain16_ms:.3f} ms at "
          f"B={B_MAIN}; (work units, K splits) by B {t_f['G']} {card}")
    print(f"time: main path F gate_batch B={B_MAIN} end to end {f_s:.3f} s "
          f"on mega16 = {B_MAIN / f_s:.1f} bootstraps/s, {f13_s:.3f} s on "
          f"mega13 {card}")
    print(f"memory: path F on mega16 torch.cuda.max_memory_allocated "
          f"{peak_f / 2**30:.3f} GiB {card}")
    # F': the same batch on mega14 (the extended key), equal to F's on mega16
    e14f, plain14_f_ms = vs_plain("mega14", megaT.blind_rotate_plain_btTe, PF,
                                  acc0_f, a_t_f, dsk_f.bsk_btTe,
                                  widths=WIDTHS_S)
    err14 = max(err14, e14f)
    reset_counts()
    out_f14, f14_s = host_s(lambda: gates.gate_batch(
        dsk_f, batch_f, engine="mega14", device=dev))
    counts_f14 = read_counts()
    only(counts_f14, ("mega14",), "main path F' on mega14")
    check(torch.equal(out_f14, out_f), "F' on mega14 != F on mega16")
    _, f14_ms = timed_call(lambda: megaT.mega14_blind_rotate(
        PF, acc0_f, a_t_f, dsk_f.bsk_btTe))
    print(f"main path F' (mega14): bsk_btTe "
          f"{dsk_f.bsk_btTe.numel() / 2**20:.1f} MiB; mega14 == "
          f"blind_rotate_plain_btTe on F's rotation inputs at B in "
          f"{list(WIDTHS_S)} (array equality, max_abs_err "
          f"{e14f}); gate_batch of {B_MAIN} gates == F's on mega16; "
          f"launches {counts_f14}")
    print(f"time: mega14 at {PF.name} B={B_MAIN} {f14_ms:.3f} ms (mega16 "
          f"{t_f['ms']:.3f} ms, not in turns); plain {plain14_f_ms:.3f} ms; "
          f"main path F' end to end {f14_s:.3f} s {card}")
    del dsk_f, lin_f, acc0_f, a_t_f, out_f, out_f13, out_f14

    res_g = integer_path("G", "std128_shortint_l4", "mega15")
    res_g["err"] = max(res_g["err"], errS_b8["mega15"])

    # 17. main path K: the eager HerdContext at STD128_K4 on mega14 --------
    PK = PARAM_SETS["std128_k4"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    *keys_k, keygen_k_s = keys_of[PK.name].get()
    pool.close()
    pool.join()
    ctx_k, ingest_k_s = host_s(lambda: HerdContext(
        PK, engine="mega14", keys=keys_k, seed=args.seed, device=dev))
    check(ctx_k.engine == "mega14" and ctx_k.dsk.bsk_btTe is not None
          and ctx_k.dsk.bsk_btS is None,
          f"HerdContext(engine='mega14') at {PK.name} took engine "
          f"{ctx_k.engine}")
    key14 = ctx_k.dsk.bsk_btTe
    rng_k = np.random.default_rng(args.seed + 11)
    ak, bk = rng_k.integers(0, 256, B_MAIN), rng_k.integers(0, 256, B_MAIN)
    xk, yk = ctx_k.encrypt(ak, width=8), ctx_k.encrypt(bk, width=8)
    # a + b's first rotation: the XOR of the two bits 0 (api.py _ripple)
    lin_k = gates.gate_linear(
        PK.n, torch.full((B_MAIN,), gates.GATE_IDS["XOR"], device=dev),
        xk.data[:, 0, :], yk.data[:, 0, :])
    acc0_k, a_t_k = bs.rotation_inputs(PK, lin_k,
                                       bs.make_test_poly(PK, device=dev))
    e14k, plain14_ms = vs_plain("mega14", megaT.blind_rotate_plain_btTe, PK,
                                acc0_k, a_t_k, key14, widths=WIDTHS_S)
    err14 = max(err14, e14k)
    rotations_k: list[int] = []

    def counting(ctx):
        """Record the bootstraps of each gate and mux call of ``ctx``."""
        gate, mux = ctx._gate, ctx._mux

        def _gate(name, a, b):
            rotations_k.append(a.numel() // (PK.n + 1))
            return gate(name, a, b)

        def _mux(sel, a, b):
            rotations_k.append(2 * a.numel() // (PK.n + 1))
            return mux(sel, a, b)
        ctx._gate, ctx._mux = _gate, _mux

    counting(ctx_k)
    reset_counts()
    sum_k, add_s = host_s(lambda: xk + yk)
    counts_k_add = read_counts()
    add_rot = sum(rotations_k)
    reset_counts()
    min_k, min_s = host_s(lambda: xk.min(yk))
    counts_k_min = read_counts()
    min_rot = sum(rotations_k) - add_rot
    peak_k = torch.cuda.max_memory_allocated()
    only(counts_k_add, ("mega14",), "main path K (a + b) on mega14")
    only(counts_k_min, ("mega14",), "main path K (min) on mega14")
    for what, got, want in (("a + b", sum_k, (ak + bk) % 256),
                            ("min", min_k, np.minimum(ak, bk))):
        check(tuple(got.data.shape) == (B_MAIN, 8, PK.n + 1),
              f"K: {what} output shape {tuple(got.data.shape)}")
        dec = ctx_k.decrypt(got)
        wrong = sum(x != y for x, y in zip(dec, want.tolist()))
        check(wrong == 0, f"K: {wrong} of {B_MAIN} values of {what} decrypt "
              f"wrong at {PK.name}")
    ctx13 = HerdContext(PK, engine="mega13", keys=keys_k, seed=args.seed,
                        device=dev)
    xk13, yk13 = ctx13.encrypt(ak, width=8), ctx13.encrypt(bk, width=8)
    check(ctx13.engine == "mega13" and torch.equal(xk13.data, xk.data)
          and torch.equal(yk13.data, yk.data),
          "K: the mega13 context differs from the mega14 one")
    reset_counts()
    sum13, add13_s = host_s(lambda: xk13 + yk13)
    counts_k13 = read_counts()
    only(counts_k13, ("mega13",), "main path K's rerun on mega13")
    check(torch.equal(sum13.data, sum_k.data),
          "K: a + b on mega13 != a + b on mega14")
    res_k = rotation_times(("mega14",), PK, acc0_k, a_t_k, {"mega14": key14},
                           {})["mega14"]
    # mega14 in turns with mega13 (on the same keys), bt_fused's rotation
    # and mega12 (random keys: bsk_bt and bsk_btk, 4.7 GiB each)
    gen_k = torch.Generator(device=dev)
    gen_k.manual_seed(args.seed + 13)
    HALF_K, R_K = PK.N // 128, (PK.k + 1) * PK.levels
    bt_k = torch.randint(-128, 128, (PK.n, R_K, HALF_K, 128,
                                     (PK.k + 1) * 4 * 128), dtype=torch.int8,
                         device=dev, generator=gen_k)
    key12_k = torch.randint(-128, 128, mega12.key_shape(PK),
                            dtype=torch.int8, device=dev, generator=gen_k)
    turns14 = in_turns(PK, acc0_k, a_t_k, {
        "mega14": (megaT.mega14_blind_rotate, key14),
        "mega13": (mega13.mega13_blind_rotate, ctx13.dsk.bsk_btS),
        "bt_fused": (bt_fused_rotation, bt_k),
        "mega12": (mega12.mega12_blind_rotate, key12_k)},
        same=("mega14", "mega13"))
    del bt_k, key12_k
    torch.cuda.empty_cache()
    print(f"main path K: {PK.name} host keygen {keygen_k_s:.1f} s (worker "
          f"process); HerdContext key ingest (fit_engine -> {ctx_k.engine}, "
          f"bsk_btTe {key14.numel() / 2**20:.1f} MiB built on the card) "
          f"{ingest_k_s:.1f} s; mega14 == blind_rotate_plain_btTe on a + b's "
          f"first rotation inputs at B in {list(WIDTHS_S)} (array "
          f"equality, max_abs_err {e14k}); a + b and min over {B_MAIN} "
          f"encrypted u8 pairs decrypt to (a+b) mod 256 and min(a, b); "
          f"launches {counts_k_add} and {counts_k_min}; a + b on mega13 is "
          f"array-equal; launches {counts_k13}")
    print_times("mega14", PK, res_k, plain14_ms)
    report_turns("mega14", PK, turns14, key14.numel())
    print(f"time: main path K a + b over {B_MAIN} u8 pairs end to end "
          f"{add_s:.3f} s on mega14 ({add_rot} gate bootstraps = "
          f"{add_rot / add_s:.1f}/s), {add13_s:.3f} s on mega13 "
          f"({add_rot / add13_s:.1f}/s); min {min_s:.3f} s on mega14 "
          f"({min_rot} gate bootstraps = {min_rot / min_s:.1f}/s) {card}")
    print(f"memory: path K on mega14 torch.cuda.max_memory_allocated "
          f"{peak_k / 2**30:.3f} GiB {card}")
    del ctx_k, ctx13, xk, yk, xk13, yk13, sum_k, min_k, sum13

    # 18. main path N: the coordinator's compact wire path on conv_i8 at
    # STD128_K2: a compressed server key, a seeded upload packed at ingest,
    # GLWE-packed frames end to end, packed downloads; over path C's first
    # partition (as paths I and M2, to keep the run's time) split in two
    # partitions, uploaded in 8 KiB chunks cut mid-row, one across the
    # partitions' boundary ----------------------------------------------
    rows_n, parts_n = rows_i, 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck_n, csk_n, pk_n, keygen_n_s, bits_n, cts_n, packed_ref_n = keys_n.get()
    key_n, pkn_bytes = (serialize_server_key_compressed(csk_n),
                        serialize_packing_key(pk_n))
    (bodies_n, seed_n), enc_n_s = host_s(lambda: client.encrypt_rows_seeded(
        ck_n, JOB_IN_COLS, table[:rows_n].tolist(), rng))
    seeded_n = rowcodec.frame_rows([row.tobytes() for row in bodies_n])
    want_out_n = {"x": int(np.bitwise_xor.reduce(xs[:rows_n])),
                  "odd": int(np.bitwise_xor.reduce(odd[:rows_n]))}
    flags_n = dict(glwe_inputs=True, glwe_frames=True, glwe_outputs=True)
    with tempfile.TemporaryDirectory() as workdir:
        coord = Coordinator(Config(
            server=ServerConfig(key_directory=workdir + "/keys",
                                storage_directory=workdir + "/st"),
            security=SecurityConfig(secret_key="chip-smoke"),
            mesh_workers=MeshWorkersConfig(engine="conv_i8", **flags_n)),
            device=dev)
        tok = coord.authorize_connection("admin==true")
        sess = coord.create_session(tok, "chip-smoke-n").uuid
        for schema, blob in ((SchemaType.TFHE_BOOL, key_n),
                             (SchemaType.TFHE_PACKING, pkn_bytes)):
            coord.add_key(tok, sess, schema, len(blob),
                          (blob[i:i + (1 << 16)]
                           for i in range(0, len(blob), 1 << 16)))
        meta = coord.begin_data_frame_upload(
            tok, sess, "rows", SchemaType.TFHE_BOOL, JOB_IN_COLS, rows_n,
            parts_n, seeded_seed=seed_n)
        for i in range(0, len(seeded_n), 1 << 13):  # cut mid-row
            coord.append_data_frame(tok, sess, meta.uuid,
                                    seeded_n[i:i + (1 << 13)])
        _, ingest_n_s = host_s(lambda: coord.finish_data_frame_upload(
            tok, sess, meta.uuid))
        check(coord.storage.get_data_frame(sess, meta.uuid).glwe_packed,
              "path N: the seeded upload was not packed at ingest")
        in_bytes = sum(
            coord.storage.partition_path(sess, meta.uuid, q).stat().st_size
            for q in range(parts_n))
        plan_n = job_plan(meta.uuid).to_json()

        def run_job_n():
            job = coord.schedule_job(tok, sess, plan_n)
            return coord.wait_for_job(tok, sess, job.job_uuid, timeout=900)

        reset_counts()
        job_n, job_n_s, rot_n, rot_n_s, _ = recorded(run_job_n)
        counts_n = read_counts()
        check(job_n.status == JobStatus.COMPLETED and job_n.retries == 0,
              f"path N job {job_n.status.name}, retries {job_n.retries}: "
              f"{job_n.message}")
        only(counts_n, (), "main path N on conv_i8")
        frames_n = {f.name: f for f in coord.list_data_frames(tok, sess)}
        check(all(f.glwe_packed for f in frames_n.values()),
              f"path N: frames in the row format "
              f"{[n for n, f in frames_n.items() if not f.glwe_packed]}")
        (out_n,) = job_n.output_frames.values()
        (mid_n,) = [f.uuid for n, f in frames_n.items()
                    if n.startswith(f"intermediate-{job_n.job_uuid}-")]
        down_n = {}
        for name, uuid, want in (("intermediate", mid_n,
                                  want_rows[:rows_n]),
                                 ("output", out_n, [want_out_n])):
            parts, secs = host_s(lambda: list(
                coord.download_data_frame_packed(tok, sess, uuid)))
            got = client.decrypt_rows_packed(ck_n, JOB_MID_COLS, parts)
            bad = sum(g != w for g, w in zip(got, want))
            check(len(got) == len(want) and bad == 0,
                  f"path N {name} frame: {len(got)} rows, {bad} decrypt "
                  f"wrong")
            down_n[name] = (secs, sum(map(len, parts)))
        peak_n = torch.cuda.max_memory_allocated()
        coord.shutdown()
        del coord
    phases_n = phase_log.phases[job_n.job_uuid]
    print(f"main path N (conv_i8; glwe_inputs, glwe_frames, glwe_outputs): "
          f"{P.name} keygen_seeded + make_packing_key {keygen_n_s:.1f} s "
          f"(worker process); compressed server key {len(key_n)} bytes "
          f"(the full key {len(key_bytes)}), packing key "
          f"{len(pkn_bytes)} bytes, both in 64 KiB chunks; {rows_n} rows "
          f"(path C's first partition) encrypted seeded in {enc_n_s:.3f} s, "
          f"{len(seeded_n)} bytes uploaded in {parts_n} partitions in 8 KiB "
          f"chunks, packed at ingest into {in_bytes} bytes; job COMPLETED, "
          f"retries 0, "
          f"{job_n.bootstraps_executed} bootstraps, every frame GLWE-packed; "
          f"all {rows_n} intermediate rows and the reduced row downloaded "
          f"packed decrypt right (decrypt_rows_packed); launches {counts_n} "
          f"(no hand-written kernel)")
    print(f"time: main path N ingest (finish_data_frame_upload: mark, read "
          f"and pack {parts_n} partitions on the card) "
          f"{ingest_n_s:.3f} s; job {job_n_s:.3f} s host (wall_time_s "
          f"{job_n.wall_time_s:.3f}), load / exec / store "
          f"{phases_n[0]:.3f} / {phases_n[1]:.3f} / {phases_n[2]:.3f} s = "
          f"{job_n.bootstraps_executed / job_n_s:.1f} bootstraps/s; packed "
          f"downloads (seconds, bytes) {down_n} {card}")
    print(f"main path N: {widths_line(rot_n, P)}; CUDA events around each "
          f"rotation span {rot_n_s:.3f} s of the stream in all {card}")
    print(f"memory: path N torch.cuda.max_memory_allocated "
          f"{peak_n / 2**30:.3f} GiB {card}")

    # pack_lwes_batch against the NumPy pack_lwes, tolerance 0, at
    # STD128_K2 (path N's key) and STD128's geometry, where the partial sums'
    # bound passes 2^31; conv_i8_correlate on saturated inputs past 2^31
    pkc_n = pack.packing_key_conv(pk_n, device=dev)
    got_n = to_numpy_u32(pack.pack_lwes_batch(
        P, pkc_n, from_numpy_u32(cts_n[None], dev)))[0]
    err_pack = abs_err(torch.from_numpy(got_n.view(np.int32)),
                       torch.from_numpy(packed_ref_n.view(np.int32)))
    check(np.array_equal(got_n, packed_ref_n),
          f"pack_lwes_batch != reference.pack_lwes at {P.name}")
    check(np.array_equal(ref.unpack_bools(ck_n, got_n, P.N), bits_n),
          f"a group packed at {P.name} decrypts wrong")
    ck_s, pk_s, bits_s, cts_s, packed_ref_s = group_std128.get()
    pkc_s = pack.packing_key_conv(pk_s, device=dev)
    got_s = to_numpy_u32(pack.pack_lwes_batch(
        STD128, pkc_s, from_numpy_u32(cts_s[None], dev)))[0]
    check(np.array_equal(got_s, packed_ref_s),
          f"pack_lwes_batch != reference.pack_lwes at {STD128.name}")
    check(np.array_equal(ref.unpack_bools(ck_s, got_s, len(bits_s)), bits_s),
          f"the {len(bits_s)}-row group packed at {STD128.name} decrypts "
          f"wrong")
    R_w, O_w = 260, (P.k + 1) * 4
    sat = bs.conv_i8_correlate(
        torch.full((2, R_w, P.N), -128, dtype=torch.int8, device=dev),
        torch.full((R_w, O_w, 2 * P.N - 1), -128, dtype=torch.int8,
                   device=dev))
    want_sat = (R_w * P.N * 128 * 128 + (1 << 31)) % (1 << 32) - (1 << 31)
    check(bool((sat == want_sat).all()),
          f"conv_i8_correlate on saturated inputs ({R_w * P.N} rows, sums "
          f"{R_w * P.N * 128 * 128} > 2^31) does not wrap mod 2^32")
    # what one product of those sums gives: the reason for the chunks
    raw_sat = int(mega13.int8_matmul(
        torch.full((1, R_w * P.N), -128, dtype=torch.int8, device=dev),
        torch.full((R_w * P.N, 8), -128, dtype=torch.int8, device=dev)
    )[0, 0])
    del sat
    groups_n = JOB_ROWS // JOB_PARTITIONS * 16 // P.N  # a partition's
    lwes_r = torch.randint(-2**31, 2**31, (groups_n, P.N, P.n + 1),
                           dtype=torch.int32, device=dev)
    pack_ms = timed_ms(lambda: pack.pack_lwes_batch(P, pkc_n, lwes_r),
                       reps=3)
    pack_bound = bounds.bound_ms(*bounds.pack_lwes(P, groups_n))
    lwes_s = torch.randint(-2**31, 2**31, (1, STD128.N, STD128.n + 1),
                           dtype=torch.int32, device=dev)
    pack_s_ms = timed_ms(lambda: pack.pack_lwes_batch(STD128, pkc_s, lwes_s),
                         reps=3)
    pack_s_bound = bounds.bound_ms(*bounds.pack_lwes(STD128, 1))
    print(f"pack: pack_lwes_batch == reference.pack_lwes (array equality, "
          f"max_abs_err {err_pack}) on a group of {P.N} at {P.name} and of "
          f"{len(bits_s)} at {STD128.name} (bounds on the partial sums "
          f"2^30.8 and 2^31.8), both groups decrypt right; "
          f"conv_i8_correlate wraps mod 2^32 past 2^31 on saturated inputs "
          f"({R_w * P.N} rows: {want_sat}), where one torch._int_mm of the "
          f"same sums gives {raw_sat}")
    print(f"time: pack_lwes_batch at {P.name} {groups_n} groups of {P.N} "
          f"(one path C partition) {pack_ms:.3f} ms, {pack_bound[0] / pack_ms:.4f}"
          f" of the {pack_bound[0]:.4f} ms bound ({pack_bound[1]}); at "
          f"{STD128.name} 1 group {pack_s_ms:.3f} ms, bound "
          f"{pack_s_bound[0]:.4f} ms ({pack_s_bound[1]}) {card}")
    del pkc_n, pkc_s, lwes_r, lwes_s

    # 19. main path O: path C's job dispatched task by task over HTTP to an
    # offload worker on mega13, served from a thread of this process -------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tree_o = build_reduce_tree(partition_sizes(JOB_ROWS, JOB_PARTITIONS),
                               Policy.PARALLEL, 2)
    with tempfile.TemporaryDirectory() as workdir:
        srv = make_server(workdir + "/st", workdir + "/keys",
                          engine="pallas_mega13", device=dev)
        serving = threading.Thread(target=srv.serve_forever, daemon=True)
        serving.start()
        try:
            res_o = path_c("offload to a mega13 worker", workdir,
                           worker=f"127.0.0.1:{srv.server_address[1]}")
        finally:
            srv.shutdown()
            srv.server_close()
            serving.join(30)
    peak_o = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    job_o = res_o["job"]
    only(res_o["counts"], ("mega13",), "path O (offload worker on mega13)")
    check(job_o.tasks_executed == JOB_PARTITIONS + tree_o.total_tasks(),
          f"path O ran {job_o.tasks_executed} tasks, not {JOB_PARTITIONS} "
          f"maps and the reduce tree's {tree_o.total_tasks()}")
    check(res_o["mid"] == mid_sub, "path O intermediate frame differs from "
          "the submitted map circuit's on bt_fused (phase 8b)")
    print(f"main path O (workers.lambda, an offload worker on pallas_mega13 "
          f"in a thread of this process): {JOB_ROWS} rows in "
          f"{JOB_PARTITIONS} partitions, map + PARALLEL reduce: COMPLETED, "
          f"retries 0, {job_o.tasks_executed} tasks ({JOB_PARTITIONS} maps, "
          f"{tree_o.total_tasks()} reduces), {job_o.bootstraps_executed} "
          f"bootstraps; all {JOB_ROWS} intermediate rows and the reduced "
          f"row decrypt right; the intermediate frame byte-equal to the "
          f"submitted map circuit's on bt_fused; launches {res_o['counts']}")
    print(f"time: main path O job wall {job_o.wall_time_s:.3f} s (host "
          f"{res_o['host_s']:.3f} s, the worker's key build included), "
          f"{job_o.bootstraps_executed / job_o.wall_time_s:.1f} "
          f"bootstraps/s; beside path C's wall on pallas_bt "
          f"{wall_c['pallas_bt']:.3f} s and pallas_fused "
          f"{wall_c['pallas_fused']:.3f} s and path I's (512 rows on "
          f"mega11) {wall_i:.3f} s; {widths_line(res_o['rotations'], P)}; "
          f"CUDA events around each of its {len(res_o['rotations'])} "
          f"rotations span {res_o['rotation_s']:.3f} s summed, "
          f"{res_o['union_s']:.3f} s in their union (the tasks' rotations "
          f"overlap on the stream); torch.cuda.max_memory_allocated "
          f"{peak_o / 2**30:.3f} GiB {card}")

    # 20. main path O': the worker in its own process on the card ----------
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as workdir:
        log_path = pathlib.Path(workdir) / "worker.log"
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "herdsman_tpu_torch.service.offload_worker", "--storage",
                 workdir + "/st", "--keys", workdir + "/keys", "--port", "0",
                 "--device", "cuda", "--engine", "pallas_mega13"],
                cwd=here, stdout=log_f, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": os.pathsep.join(
                    [here, *filter(None, [os.environ.get("PYTHONPATH")])])})
        try:
            t0 = time.perf_counter()
            while not (found := re.search(r"offload worker on port (\d+)",
                                          log_path.read_text())):
                check(proc.poll() is None and time.perf_counter() - t0 < 120,
                      f"path O': the worker process did not start: "
                      f"{log_path.read_text()[-3000:]}")
                time.sleep(0.2)
            start_o2 = time.perf_counter() - t0

            def worker_counts() -> dict[str, int]:
                """The worker process's launches, by kernel."""
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{found.group(1)}/counts",
                        timeout=30) as r:
                    return json.loads(r.read())

            before_o2 = worker_counts()
            res_o2 = path_c("offload to a mega13 worker process", workdir,
                            rows=rows_i, partitions=1,
                            worker=f"127.0.0.1:{found.group(1)}",
                            reduce=False)
            after_o2 = worker_counts()
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
    job_o2 = res_o2["job"]
    only(res_o2["counts"], (), "path O' (its worker in another process)")
    check(set(after_o2) == set(counters),
          f"path O': the worker counts {sorted(after_o2)}, this script "
          f"{sorted(counters)}")
    counts_o2 = {k: after_o2[k] - before_o2[k] for k in counters}
    only(counts_o2, ("mega13",), "path O' (its worker process)")
    check(job_o2.tasks_executed == 1 and res_o2["mid"] == mid_sub[:1],
          f"path O': {job_o2.tasks_executed} tasks; the frame differs from "
          f"the first partition of the submitted map circuit's (phase 8b)")
    print(f"main path O' (python -m herdsman_tpu_torch.service.offload_worker "
          f"--device cuda --engine pallas_mega13, serving after "
          f"{start_o2:.1f} s): a map-only job over {rows_i} rows (path C's "
          f"first partition): COMPLETED, retries 0, 1 task; all {rows_i} "
          f"rows decrypt right, the frame byte-equal to the first partition "
          f"of phase 8b's and of path O's; this process launched no kernel, "
          f"the worker process (its GET /counts before and after) "
          f"{counts_o2}; the worker process stopped (exit "
          f"{proc.returncode})")
    print(f"time: main path O' job wall {job_o2.wall_time_s:.3f} s (host "
          f"{res_o2['host_s']:.3f} s, the worker's key build included) "
          f"{card}")

    # 21. main path P: path I's job, traced (logging.profile_dir) ----------
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as workdir:
        traces = pathlib.Path(workdir) / "traces"
        res_p = path_c("pallas_mega11", workdir, rows=rows_i, partitions=1,
                       profile_dir=str(traces))
        job_p = res_p["job"]
        written = sorted(f.relative_to(traces) for f in traces.rglob("*")
                         if f.is_file())
        check(len(written) == 1
              and written[0].parent == pathlib.Path(job_p.job_uuid)
              and written[0].name.endswith(".pt.trace.json"),
              f"path P: traces {written}, not one under {job_p.job_uuid}/")
        trace_bytes = (traces / written[0]).stat().st_size
        events = json.loads((traces / written[0]).read_text())["traceEvents"]
    peak_p = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    mega12_events = [e for e in kernel_events
                     if "mega12_kernel" in e.get("name", "")]
    only(res_p["counts"], ("mega11",), "path P on pallas_mega11, traced")
    check(len(mega12_events) > 0,
          f"path P: the trace holds {len(kernel_events)} CUDA kernel events "
          f"and none of csrc/mega12.cu's mega12_kernel")
    check(res_p["mid"] == mid_i, "path P intermediate frame differs from "
          "path I's")
    load, exe, store = res_p["phases"]
    print(f"main path P (pallas_mega11, logging.profile_dir): path I's job "
          f"COMPLETED, retries 0, the frame byte-equal to path I's; one "
          f"trace under <profile_dir>/<job_uuid>/ ({written[0].name}, "
          f"{trace_bytes} bytes, {len(events)} events, "
          f"{len(kernel_events)} CUDA kernel events of which "
          f"{len(mega12_events)} {mega12_events[0]['name']!r}, "
          f"{sum(e.get('dur', 0) for e in mega12_events) / 1e6:.3f} s in "
          f"all); launches {res_p['counts']}")
    print(f"time: main path P job wall {job_p.wall_time_s:.3f} s traced "
          f"(host {res_p['host_s']:.3f} s; runner load {load:.3f} s, exec "
          f"{exe:.3f} s, store {store:.3f} s) beside path I's untraced "
          f"{wall_i:.3f} s; torch.cuda.max_memory_allocated "
          f"{peak_p / 2**30:.3f} GiB {card}")

    # 22. main path Q: path C's job through the gRPC front end: a HerdClient
    # against build_server on a coordinator on pallas_fused -----------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    want_out_c = [{"x": int(np.bitwise_xor.reduce(xs)),
                   "odd": int(np.bitwise_xor.reduce(odd))}]
    with tempfile.TemporaryDirectory() as workdir:
        coord_q = Coordinator(Config(
            server=ServerConfig(key_directory=workdir + "/keys",
                                storage_directory=workdir + "/st"),
            security=SecurityConfig(secret_key="chip-smoke"),
            mesh_workers=MeshWorkersConfig(engine="pallas_fused")),
            device=dev)
        server_q, port_q = build_server(coord_q, "127.0.0.1:0")
        server_q.start()
        herd = HerdClient(f"127.0.0.1:{port_q}")
        try:
            reset_counts()
            t0 = time.perf_counter()
            herd.authorize("admin==true")
            sess_q = herd.create_session("chip-smoke").uuid
            _, key_q_s = host_s(lambda: herd.add_key(
                sess_q, SchemaType.TFHE_BOOL, key_bytes))
            herd.add_key(sess_q, SchemaType.TFHE_PACKING, pk_bytes_c)
            meta_q, upload_q_s = host_s(lambda: herd.upload_data_frame(
                sess_q, "rows", SchemaType.TFHE_BOOL, JOB_IN_COLS, job_in,
                JOB_PARTITIONS, chunk_rows=per_chunk))
            plan_q = job_plan(meta_q.uuid)

            def run_job_q():
                desc = herd.schedule_job(sess_q, plan_q)
                return desc, herd.wait_for_job(sess_q, desc.uuid,
                                               timeout=900)

            (desc_q, state_q), host_q, rot_q, rot_q_s, _ = recorded(run_job_q)
            (out_q,) = state_q.output_frames
            (mid_q,) = [f.uuid for f in herd.list_data_frames(sess_q)
                        if f.name.startswith(f"intermediate-{desc_q.uuid}-")]
            frames_q, download_q_s = host_s(lambda: {
                name: herd.download_data_frame(sess_q, uuid, 9, P)
                for name, uuid in (("out", out_q), ("mid", mid_q))})
            packed_q, packed_q_s = host_s(
                lambda: herd.download_data_frame_packed(sess_q, out_q))
            path_q_s = time.perf_counter() - t0
            counts_q = read_counts()
            described_q = herd.describe_job(sess_q, desc_q.uuid)
            job_q = coord_q.get_job_state(
                coord_q.authorize_connection("admin==true"), sess_q,
                desc_q.uuid)
        finally:
            herd.close()
            server_q.stop(None).wait(30)
            coord_q.shutdown()
    peak_q = torch.cuda.max_memory_allocated()
    del coord_q, server_q, herd  # the coordinator holds Q's device key
    gc.collect()
    torch.cuda.empty_cache()
    check(state_q.status == int(JobStatus.COMPLETED) and job_q.retries == 0
          and state_q.bootstraps_executed > 0,
          f"path Q job {JobStatus(state_q.status).name}, retries "
          f"{job_q.retries}: {state_q.message}")
    only(counts_q, ("bt_external_product", "rotate_decompose"),
         "path Q (gRPC front end on pallas_fused)")
    check(all(counts_q[k] == c_fused[k] for k in counts_q),
          f"path Q launched {counts_q}, path C on pallas_fused {c_fused}")
    for name in ("mid", "out"):
        check(frame_codec.rows_to_payloads(frames_q[name])
              == [pl for part in res_c[name]
                  for pl in rowcodec.parse_rows(part)],
              f"path Q {name} frame differs from path C's on pallas_fused")
    check(packed_q == res_c["packed_parts"]["output"],
          "path Q's packed output differs from path C's")
    check(client.decrypt_rows(ck, JOB_MID_COLS, frames_q["mid"]) == want_rows
          and client.decrypt_rows(ck, JOB_MID_COLS, frames_q["out"])
          == want_out_c
          and client.decrypt_rows_packed(ck, JOB_MID_COLS, packed_q)
          == want_out_c, "path Q frames decrypt wrong")
    check(described_q.plan.SerializeToString(deterministic=True)
          == mappers.plan_to_proto(plan_q).SerializeToString(
              deterministic=True), "path Q: describe_job's plan differs from "
          "the plan sent")
    load_q, exe_q, store_q = phase_log.phases[desc_q.uuid]
    load_c, exe_c, store_c = res_c["phases"]
    print(f"main path Q (HerdClient -> build_server on 127.0.0.1, insecure "
          f"-> Coordinator on pallas_fused): authorize, session, the "
          f"{P.name} server key ({len(key_bytes)} bytes in "
          f"{-(-len(key_bytes) // (1 << 20))} messages of at most 1 MiB, "
          f"client-streamed) and the TFHE_PACKING key, {JOB_ROWS} rows in "
          f"{JOB_PARTITIONS} partitions over the bidi upload, the plan as a "
          f"proto: COMPLETED, retries 0, {state_q.bootstraps_executed} "
          f"bootstraps; the output and intermediate frames downloaded "
          f"(server-streamed, one message a partition) byte-equal to path "
          f"C's on pallas_fused and decrypting right, the output downloaded "
          f"packed byte-equal to C's; describe_job's plan equal to the plan "
          f"sent; launches {counts_q}, equal to path C's on pallas_fused")
    print(f"time: main path Q end to end {path_q_s:.3f} s: key over the wire "
          f"{key_q_s:.3f} s ({len(key_bytes) / key_q_s / 2**20:.1f} MiB/s; "
          f"C in process {res_c['key_s']:.3f} s), rows over the wire "
          f"{upload_q_s:.3f} s (C {res_c['upload_s']:.3f} s), job wall "
          f"{job_q.wall_time_s:.3f} s (host {host_q:.3f} s; C "
          f"{wall_c['pallas_fused']:.3f} s, host {res_c['host_s']:.3f} s), "
          f"runner load {load_q:.3f} s, exec {exe_q:.3f} s, store "
          f"{store_q:.3f} s (C {load_c:.3f}, {exe_c:.3f}, {store_c:.3f} s), "
          f"rotations' CUDA spans {rot_q_s:.3f} s summed (C "
          f"{res_c['rotation_s']:.3f} s), download of both row frames "
          f"{download_q_s:.3f} s, of the output packed {packed_q_s:.3f} s "
          f"(C {res_c['packed']['output'][0]:.3f} s); "
          f"torch.cuda.max_memory_allocated {peak_q / 2**30:.3f} GiB {card}")

    # 23. main path Q': path C's job on a workers.grpc fleet of two workers
    # on mega13, served from threads of this process -------------------------
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as workdir:
        fleet = [make_worker_server(workdir + "/st", workdir + "/keys",
                                    engine="pallas_mega13", device=dev)
                 for _ in range(2)]
        for srv, _ in fleet:
            srv.start()
        try:
            res_q2 = path_c("a workers.grpc fleet of two mega13 workers",
                            workdir,
                            fleet=tuple(f"127.0.0.1:{p}" for _, p in fleet))
        finally:
            for srv, _ in fleet:
                srv.stop(None).wait(30)
    peak_q2 = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    job_q2 = res_q2["job"]
    tasks_q2 = [srv.task_counts["tasks"] for srv, _ in fleet]
    only(res_q2["counts"], ("mega13",), "path Q' (a gRPC fleet on mega13)")
    check(res_q2["counts"]["mega13"] == res_o["counts"]["mega13"],
          f"path Q' launched mega13 {res_q2['counts']['mega13']} times, path "
          f"O {res_o['counts']['mega13']}")
    check(job_q2.tasks_executed == JOB_PARTITIONS + tree_o.total_tasks()
          and tasks_q2 == [-(-job_q2.tasks_executed // 2),
                           job_q2.tasks_executed // 2],
          f"path Q' ran {job_q2.tasks_executed} tasks, {tasks_q2} by worker, "
          f"not path O's {JOB_PARTITIONS + tree_o.total_tasks()} round-robin")
    check(res_q2["mid"] == mid_sub and res_q2["mid"] == res_o["mid"],
          "path Q' intermediate frame differs from phase 8b's and path O's")
    print(f"main path Q' (workers.grpc, two make_worker_server members on "
          f"pallas_mega13 in threads of this process): {JOB_ROWS} rows in "
          f"{JOB_PARTITIONS} partitions, map + PARALLEL reduce: COMPLETED, "
          f"retries 0, {job_q2.tasks_executed} tasks round-robin "
          f"{tasks_q2} by worker, {job_q2.bootstraps_executed} bootstraps; "
          f"all {JOB_ROWS} intermediate rows and the reduced row decrypt "
          f"right; the intermediate frame byte-equal to phase 8b's and path "
          f"O's; launches {res_q2['counts']}")
    print(f"time: main path Q' job wall {job_q2.wall_time_s:.3f} s (host "
          f"{res_q2['host_s']:.3f} s, both workers' key builds included; O "
          f"{res_o['job'].wall_time_s:.3f} s); CUDA events around each of its "
          f"{len(res_q2['rotations'])} rotations span "
          f"{res_q2['rotation_s']:.3f} s summed, {res_q2['union_s']:.3f} s "
          f"in their union (O {res_o['rotation_s']:.3f} s, "
          f"{res_o['union_s']:.3f} s); torch.cuda.max_memory_allocated "
          f"{peak_q2 / 2**30:.3f} GiB {card}")

    # 24. main path R: BASELINE config 3, the RNS/NTT path (ops/ntt and
    # ops/rns, no hand-written kernel: the DFT steps' int8 products are
    # torch._int_mm) at the JAX package's bench.py --metric rns defaults, N
    # = 4096, 3 primes, B = 2048, and at N = 2048 (N1 = 32, N2 = 64: the
    # transposes of a non-square split) over 256; the big-int oracles run
    # in worker processes beside the card's work --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    oracle = multiprocessing.get_context("spawn").Pool(4)
    atexit.register(oracle.terminate)
    rng_r = np.random.default_rng(args.seed + 50)
    reset_counts()
    t_r = time.perf_counter()

    def rns_products(N: int, B: int) -> dict:
        """ntt_inv(ntt_fwd(x)) == x on every limb of a batch [3, B, N], and
        ``rns.polymul`` of two batches: the first and last rows sent to the
        big-int oracle (read later), 8 rows equal to the port's CPU run."""
        ctx_r = rns.make_rns(N, 3, device=dev)
        a, b = (np.stack([rng_r.integers(0, q, (B, N)).astype(np.uint32)
                          for q in ctx_r.primes]) for _ in range(2))
        ends = [0, B - 1]
        oracles = [oracle.apply_async(rns_bigint_rows,
                                      (N, a[:, [r]], b[:, [r]]))
                   for r in ends]
        a_t, b_t = from_numpy_u32(a, dev), from_numpy_u32(b, dev)
        check(torch.equal(rns.ntt_inv(ctx_r, rns.ntt_fwd(ctx_r, a_t)), a_t),
              f"path R: ntt_inv(ntt_fwd(x)) != x at N={N} B={B}")
        prod = rns.polymul(ctx_r, a_t, b_t)
        sel = np.linspace(0, B - 1, 8).astype(int)
        cpu = rns.polymul(rns.make_rns(N, 3, device="cpu"), a[:, sel],
                          b[:, sel])
        check(torch.equal(prod[:, sel].cpu(), cpu),
              f"path R: polymul at N={N} differs from its CPU run on rows "
              f"{sel.tolist()}")
        return {"ctx": ctx_r, "a": a_t, "b": b_t, "B": B,
                "ends": list(zip(ends, oracles)),
                "got_ends": to_numpy_u32(prod[:, ends])}

    big = rns_products(4096, B_MAIN)
    small = rns_products(2048, 256)
    ctx_r, a_r, b_r = big["ctx"], big["a"], big["b"]
    N_R = ctx_r.N
    delta = ctx_r.Q // 256
    s1, s2 = rng_r.integers(0, 2, N_R), rng_r.integers(0, 2, N_R)
    ksk, keygen_r_s = host_s(lambda: rns.keyswitch_keygen(
        ctx_r, s1, s2, np.random.default_rng(args.seed + 51)))
    ksk_cpu = rns.keyswitch_keygen(rns.make_rns(N_R, 3, device="cpu"), s1,
                                   s2, np.random.default_rng(args.seed + 51))
    check(torch.equal(ksk.ksk_a.cpu(), ksk_cpu.ksk_a)
          and torch.equal(ksk.ksk_b.cpu(), ksk_cpu.ksk_b),
          "path R: keyswitch_keygen on the card differs from its CPU run")

    def s_res(s):
        return from_numpy_u32(rns.to_rns(ctx_r, s)[:, None], dev)

    # ciphertexts under s2 of 8-bit messages in the top bits, b = a * s2 +
    # msg * delta + e by the checked polymul (tests/test_ntt.py:100-137)
    msg = rng_r.integers(0, 256, (B_MAIN, N_R))
    e_r = np.rint(rng_r.normal(0, 3.2, (B_MAIN, N_R))).astype(np.int64)
    a_ks = from_numpy_u32(np.stack(
        [rng_r.integers(0, q, (B_MAIN, N_R)).astype(np.uint32)
         for q in ctx_r.primes]), dev)
    msg_t, e_t = torch.from_numpy(msg).to(dev), torch.from_numpy(e_r).to(dev)
    extra = torch.stack([((msg_t * (delta % q) + e_t) % q).to(torch.int32)
                         for q in ctx_r.primes])
    ct_r = torch.stack([a_ks, rns.add(ctx_r, rns.polymul(ctx_r, a_ks,
                                                         s_res(s2)), extra)])
    del msg_t, e_t, extra
    out_r = rns.key_switch(ctx_r, ksk, ct_r)
    check(out_r.shape == ct_r.shape, f"path R: key_switch gave "
          f"{tuple(out_r.shape)}, not {tuple(ct_r.shape)}")
    rows_ks = np.linspace(0, B_MAIN - 1, 64).astype(int)
    host_phases = [oracle.apply_async(rns_bigint_phases, (
        N_R, to_numpy_u32(out_r[0][:, [r]]), to_numpy_u32(out_r[1][:, [r]]),
        s1)) for r in (0, B_MAIN - 1)]
    phase_r = rns.sub(ctx_r, out_r[1],
                      rns.polymul(ctx_r, out_r[0], s_res(s1)))
    t0 = time.perf_counter()
    ph = rns.from_rns(ctx_r, to_numpy_u32(phase_r[:, rows_ks]))
    decoded = (ph + delta // 2) // delta % 256
    crt_s = time.perf_counter() - t0
    check((decoded.astype(np.int64) == msg[rows_ks]).all(),
          f"path R: key-switched messages wrong in "
          f"{int((decoded.astype(np.int64) != msg[rows_ks]).sum())} of "
          f"{decoded.size} coefficients")
    rem = ph % delta
    noise_r = int(np.minimum(rem, delta - rem).max())
    check(noise_r < delta / 16, f"path R: key-switch noise {noise_r} not "
          f"below delta/16 = {delta // 16}")
    del phase_r

    # times: CUDA events after warm-up (every function ran above)
    ntt_ms = timed_ms(lambda: rns.ntt_fwd(ctx_r, a_r), 3)
    N1_r, N2_r = ctx_r.plans[0].N1, ctx_r.plans[0].N2
    d1 = torch.randint(-128, 128, (3 * B_MAIN * N2_r, N1_r),
                       dtype=torch.int8, device=dev)
    d2 = torch.randint(-128, 128, (3 * B_MAIN * N1_r, N2_r),
                       dtype=torch.int8, device=dev)
    mm_ms = timed_ms(lambda: [(mega13.int8_matmul(d1, pl.w1_dig),
                               mega13.int8_matmul(d2, pl.w2_dig))
                              for pl in ctx_r.plans], 3)
    del d1, d2
    K_CHAIN = 6

    def chain():
        c = a_r
        for _ in range(K_CHAIN):
            c = rns.polymul(ctx_r, c, b_r)
        return c
    _, chain_ms = timed_call(chain)
    ks_ms = timed_ms(lambda: rns.key_switch(ctx_r, ksk, ct_r), 2)
    peak_r = torch.cuda.max_memory_allocated()

    # the big-int oracles
    for res in (big, small):
        for i, (r, fut) in enumerate(res["ends"]):
            check((res["got_ends"][:, i] == fut.get(timeout=600)[:, 0]).all(),
                  f"path R: polymul row {r} at N={res['ctx'].N} differs from "
                  f"the big-int product")
    for i, fut in enumerate(host_phases):
        r = rows_ks[0] if i == 0 else rows_ks[-1]
        check((fut.get(timeout=600)[0] == ph[0 if i == 0 else -1]).all(),
              f"path R: key-switched row {r}'s phase differs from the "
              f"big-int phase")
    oracle.close()
    oracle.join()
    counts_r = read_counts()
    only(counts_r, (), "main path R (the RNS/NTT path)")
    path_r_s = time.perf_counter() - t_r
    del big, small, a_r, b_r, a_ks, ct_r, out_r, ksk, ksk_cpu
    torch.cuda.empty_cache()
    b_ntt = bounds.bound_ms(*bounds.ntt(N_R, 3, B_MAIN))
    b_mm = bounds.bound_ms(*bounds.ntt_products(N_R, 3, B_MAIN))
    b_poly = bounds.bound_ms(*bounds.ntt_polymul(N_R, 3, B_MAIN))
    b_ks = bounds.bound_ms(*bounds.rns_key_switch(N_R, 3, B_MAIN))
    print(f"main path R (BASELINE config 3: ops/rns on ops/ntt, N={N_R}, "
          f"primes {ctx_r.primes}, B={B_MAIN}; and N=2048 over 256): "
          f"ntt_inv(ntt_fwd(x)) == x on every limb at both sizes; polymul's "
          f"first and last rows equal to the big-int product at both "
          f"sizes, 8 rows equal to the port's CPU run; keyswitch_keygen "
          f"({keygen_r_s:.3f} s) equal to its CPU run; key_switch of "
          f"[2, 3, {B_MAIN}, {N_R}]: {len(rows_ks)} rows decoded through "
          f"the CRT on the host ({crt_s:.3f} s), every message right, noise "
          f"at most 2^{np.log2(max(noise_r, 1)):.1f} of delta/16 = "
          f"2^{np.log2(delta / 16):.1f}, rows 0 and {B_MAIN - 1}'s phases "
          f"equal to the big-int ones; launches {counts_r} (no hand-written "
          f"kernel: torch._int_mm); path R {path_r_s:.1f} s")
    print(f"time: main path R at N={N_R} L=3 B={B_MAIN}: ntt_fwd "
          f"{ntt_ms:.3f} ms ({b_ntt[0] / ntt_ms:.4f} of the {b_ntt[0]:.4f} "
          f"ms bound, {b_ntt[1]}), its torch._int_mm products {mm_ms:.3f} ms "
          f"({mm_ms / ntt_ms:.4f} of the NTT; bound {b_mm[0]:.4f} ms, "
          f"{b_mm[1]}); {K_CHAIN} chained dependent polymuls "
          f"{chain_ms:.3f} ms, {chain_ms / K_CHAIN:.3f} ms a batch "
          f"({b_poly[0] / (chain_ms / K_CHAIN):.4f} of the {b_poly[0]:.4f} ms "
          f"bound, {b_poly[1]}), {B_MAIN * K_CHAIN / chain_ms * 1e3:.1f} "
          f"polymuls/s; key_switch {ks_ms:.3f} ms ({b_ks[0] / ks_ms:.4f} of "
          f"the {b_ks[0]:.4f} ms bound, {b_ks[1]}); "
          f"torch.cuda.max_memory_allocated {peak_r / 2**30:.3f} GiB {card}")

    # 25. main path S5: path R's ntt_fwd and polymul (N=4096, L=3, B=2048)
    # with each limb's coefficient matrix split over limb axes of 2 and 4
    # positions of this card (mesh/ntt_sharded: two all-to-all exchanges a
    # transform); S6: two mesh._dcn_check processes on this card ---------
    gen_s5 = torch.Generator(device=dev)
    gen_s5.manual_seed(args.seed + 25)
    a_s5, b_s5 = (torch.stack([
        torch.randint(0, q, (B_MAIN, N_R), dtype=torch.int32, device=dev,
                      generator=gen_s5) for q in ctx_r.primes])
        for _ in range(2))
    spec_s5 = rns.ntt_fwd(ctx_r, a_s5)
    prod_s5 = rns.polymul(ctx_r, a_s5, b_s5)
    # one device's times, CUDA events after a warm call, as the sharded
    # ones below
    spec_ms = timed_ms(lambda: rns.ntt_fwd(ctx_r, a_s5), 3)
    prod_ms = timed_ms(lambda: rns.polymul(ctx_r, a_s5, b_s5), 3)
    for limb in (2, 4):
        mesh_s5 = card_mesh(1, limb)

        def spec_fn():
            return torch.stack([ntt_sharded.ntt_fwd_sharded(pl, mesh_s5, a_j)
                                for pl, a_j in zip(ctx_r.plans, a_s5)])

        def prod_fn():
            return torch.stack([ntt_sharded.polymul_sharded(pl, mesh_s5, a_j,
                                                            b_j)
                                for pl, a_j, b_j in zip(ctx_r.plans, a_s5,
                                                        b_s5)])

        spec_m, prod_m = path_s(
            f"S5_limb{limb}", lambda: (spec_fn(), prod_fn()), None,
            f"ntt_fwd_sharded and polymul_sharded, N={N_R} L=3 B={B_MAIN}, "
            f"limb axis {limb}, one cold call; warm times beside one "
            f"device's follow")
        only(res_s[f"S5_limb{limb}"]["counts"], (), f"path S5 (limb {limb})")
        check(torch.equal(spec_m, spec_s5) and torch.equal(prod_m, prod_s5),
              f"path S5 (limb {limb}): the sharded NTT or polymul != ops/rns")
        print(f"time: main path S5 (limb axis {limb}) on CUDA events after "
              f"a warm call: ntt_fwd_sharded {timed_ms(spec_fn, 3):.3f} ms "
              f"beside ops/rns's ntt_fwd {spec_ms:.3f} ms, polymul_sharded "
              f"{timed_ms(prod_fn, 3):.3f} ms beside ops/rns's polymul "
              f"{prod_ms:.3f} ms {card}")
    del a_s5, b_s5, spec_s5, prod_s5, spec_m, prod_m
    print(f"main path S5: path R's ntt_fwd and polymul at N={N_R}, "
          f"L=3, B={B_MAIN} with the [64, 64] coefficient matrix split over "
          f"limb axes of 2 and 4 positions of this card == ops/rns's "
          f"(array equality)")

    def dcn_processes():
        """Two _dcn_check processes, four positions each on this card,
        joined over gloo (NCCL refuses two ranks on one card), on path A's
        STD128_K2 keys from a file (no keygen in the children)."""
        with tempfile.TemporaryDirectory() as keydir:
            key_file = os.path.join(keydir, "keys.npz")
            _dcn_check.save_keys(key_file, ck, sk)
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, "-m", "herdsman_tpu_torch.mesh._dcn_check",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 "2", "--process-id", str(i), "--local-devices", "4",
                 "--device", "cuda", "--backend", "gloo", "--key", key_file],
                cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env={**os.environ, "PYTHONPATH": os.pathsep.join(
                    [here, *filter(None, [os.environ.get("PYTHONPATH")])])})
                for i in range(2)]
            try:
                return [p.communicate(timeout=300)[0] for p in procs], procs
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()

    def dcn_counts(result) -> dict[str, int]:
        """Both processes' launches on the mesh path, summed: each ends its
        MULTIPROCESS OK line in counts= and a JSON object of its own."""
        check(read_counts() == dict.fromkeys(counters, 0),
              f"path S6: this process launched {read_counts()}")
        outs, procs = result
        total = dict.fromkeys(counters, 0)
        for i, (p_s6, out_s6) in enumerate(zip(procs, outs)):
            ok = [line for line in out_s6.splitlines()
                  if line.startswith(f"MULTIPROCESS OK: process {i}/2")]
            check(p_s6.returncode == 0 and len(ok) == 1,
                  f"path S6: process {i} exited {p_s6.returncode}:\n"
                  f"{out_s6[-3000:]}")
            print(f"main path S6: process {i}: {ok[0]}")
            for k, v in json.loads(ok[0].split(" counts=", 1)[1]).items():
                total[k] += v
        return total

    path_s("S6", dcn_processes, None, "two mesh._dcn_check processes on "
           "this card over gloo, 4 positions each, STD128_K2 keys from a "
           "file; launches summed from both processes' counts=",
           counts_of=dcn_counts)
    only(res_s["S6"]["counts"], ("mega13",), "path S6")

    # 17-18. result lines ---------------------------------------------------
    by_path = {"A_gate_batch": counts_a, "B_adder_job": counts_b,
               "C_job_pallas_bt": c_bt, "C_job_pallas_fused": c_fused,
               "D1_shortint": counts_d1, "D1_shortint_on_mega13": counts_d1_13,
               "D2_radix": counts_d2,
               "E_shortint_b8": res_e["counts"],
               "E_shortint_b8_on_mega12": res_e["counts12"],
               "F_gate_batch_fast": res_f["counts"],
               "F_gate_batch_fast_on_mega13": res_f["counts13"],
               "G_shortint_l4": res_g["counts"],
               "G_shortint_l4_on_mega12": res_g["counts12"],
               "H_gate_batch_mega11": res_h["mega11"]["counts"],
               "H_gate_batch_mega8": res_h["mega8"]["counts"],
               "H_gate_batch_mega7": res_h["mega7"]["counts"],
               "I_job_pallas_mega11": res_i_counts,
               "J_shortint_mega7": res_j["counts"],
               "H_gate_batch_mega9": res_h["mega9"]["counts"],
               "H_gate_batch_mega6": res_h["mega6"]["counts"],
               "A_gate_batch_mega14": counts_a14,
               "F_gate_batch_fast_mega14": counts_f14,
               "K_herd_add_mega14": counts_k_add,
               "K_herd_min_mega14": counts_k_min,
               "K_herd_add_on_mega13": counts_k13,
               **{f"H_gate_batch_{name}": res_h[name]["counts"]
                  for name in legacy_j},
               "L_gate_batch_on_mega13": counts_l13,
               **{f"L_gate_batch_{name}": res_l[name]["counts"]
                  for name in legacy_j},
               **{f"M1_gate_batch_{name}": res_m[name]["counts"]
                  for name in row_j},
               **{f"M2_job_pallas_{name}": res_m2[name] for name in row_j},
               "A_gate_batch_conv_i8": counts_conv,
               "N_job_conv_i8": counts_n,
               "O_job_offload_mega13": res_o["counts"],
               "O2_job_offload_process_mega13": counts_o2,
               "P_job_pallas_mega11_traced": res_p["counts"],
               "Q_job_grpc_front_end_pallas_fused": counts_q,
               "Q2_job_grpc_fleet_mega13": res_q2["counts"],
               "R_rns_ntt": counts_r,
               **{f"{name}_mesh": r["counts"] for name, r in res_s.items()}}

    def launches(name):
        per = {path: c[name] for path, c in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    kernels = [{
        "name": "mega12",
        "route": "cuda",
        "source": "herdsman_tpu_torch/csrc/mega12.cu",
        "replaces": "herdsman_tpu/ops/pallas/mega.py:625",
        **launches("mega12"),
        "matches_plain": err12 == 0,
        "max_abs_err": err12,
        "ms": m12_ms,
        "plain_ms": plain12_ms,
        "bound_ms": bound12_ms,
        "bound_by": bound12_by,
        "library_ms": None,
        "ms_b256": narrow12_ms,
        "ms_bt_fused": t12[B_MAIN]["bt_fused"],
        "ms_bt_fused_b256": t12[RADIX_VALUES]["bt_fused"],
        "plan": plans12[B_MAIN],
        "plan_b256": plans12[RADIX_VALUES],
    }, {
        "name": "mega13",
        "route": "cuda",
        "source": "herdsman_tpu_torch/csrc/megaS.cu",
        "replaces": "herdsman_tpu/ops/pallas/mega.py:793",
        **launches("mega13"),
        "matches_plain": err == 0,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_b256": narrow_ms[2 * ROWS],
        "ms_b128": narrow_ms[ROWS],
        **{f"ms_{k}_in_turns_b{B}": v for B, t in turns13.items()
           for k, v in t.items()},
        "ms_std128": m13_l_ms,
        "plain_ms_std128": plain13_l_ms,
        "ms_std128_shortint": m13_d_ms,
        "plain_ms_std128_shortint": plain13_d_ms,
        "ms_std128_k4_in_turns": turns14[B_MAIN]["mega13"],
    }, {
        "name": "bt_external_product",
        "route": "cuda",
        "source": "herdsman_tpu_torch/csrc/bt_external_product.cu",
        "replaces": "herdsman_tpu/ops/pallas/blind_rotate.py:153",
        "replaces_fused": "herdsman_tpu/ops/pallas/blind_rotate.py:189",
        **launches("bt_external_product"),
        "matches_plain": errs["bt_external_product"] == 0,
        "max_abs_err": errs["bt_external_product"],
        "ms": ep[False]["ms"],
        "plain_ms": ep[False]["plain_ms"],
        "bound_ms": ep[False]["bound_ms"],
        "bound_by": ep[False]["bound_by"],
        "library_ms": lib_ms,
        "library_ms_row_major": lib_row_ms,
        "graph_ms": ep[False]["graph_ms"],
        "ms_fused": ep[True]["ms"],
        "graph_ms_fused": ep[True]["graph_ms"],
        "plain_ms_fused": ep[True]["plain_ms"],
        "bound_ms_fused": ep[True]["bound_ms"],
        "library_ms_fused": lib_ms,
        **{f"{k}_fused_b{B}": v for B, n in narrow.items()
           for k, v in n.items()},
        "ms_std128": q_ms,
        "bound_ms_std128": q_bound,
        "library_ms_std128": q_lib_ms,
    }, {
        "name": "rotate_decompose",
        "route": "cuda",
        "source": "herdsman_tpu_torch/csrc/rotate_decompose.cu",
        "replaces": "herdsman_tpu/ops/pallas/rotate_decompose.py:38",
        **launches("rotate_decompose"),
        "matches_plain": errs["rotate_decompose"] == 0,
        "max_abs_err": errs["rotate_decompose"],
        "ms": rd_ms,
        "graph_ms": rd_graph_ms,
        "plain_ms": rd_plain_ms,
        "bound_ms": rd_bound_ms,
        "bound_by": rd_by,
        "library_ms": None,
    }]
    for name, line, res in (("mega17", 1495, res_e), ("mega16", 1323, res_f),
                            ("mega15", 1154, res_g)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "herdsman_tpu_torch/csrc/megaS.cu",
            "replaces": f"herdsman_tpu/ops/pallas/mega.py:{line}",
            **launches(name),
            "matches_plain": res["err"] == 0,
            "max_abs_err": res["err"],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
            "ms_b256": res["narrow_ms"],
            **{f"ms_{k}_in_turns_b{B}": v
               for B, t in res.get("turns", {}).items()
               for k, v in t.items()},
        })
    def vs_mega11(name) -> dict:
        """Kernel ``name``'s time beside ``mega11``'s, timed in turns on
        one bsk_btk2 in path H (csrc/mega12.cu's doubled window)."""
        a, b = res_h["mega11"], res_h[name]
        return {"ms_mega11_in_turns": a["ms"],
                "ratio_to_mega11": b["ms"] / a["ms"],
                "ratio_to_mega11_b256": b["narrow_ms"] / a["narrow_ms"]}

    # mega11 and mega8 (csrc/mega12.cu's doubled window) timed at STD128_K2
    # (path H), mega7 (its single window) at STD128_SHORTINT (path J),
    # beside its STD128_K2 time; mega11 and mega7 also in turns with mega12,
    # mega8 with mega11
    for name, line, res in (("mega11", 449, res_h["mega11"]),
                            ("mega8", 236, res_h["mega8"]),
                            ("mega7", 84, res_j)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "herdsman_tpu_torch/csrc/mega12.cu",
            "replaces": f"herdsman_tpu/ops/pallas/mega.py:{line}",
            **launches(name),
            "matches_plain": errs_j[name] == 0,
            "max_abs_err": errs_j[name],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
            "ms_b256": res["narrow_ms"],
        })
    kernels[-3].update({f"ms_{k}_in_turns_b{B}": v
                        for B, t in turns11.items() for k, v in t.items()})
    kernels[-2].update(vs_mega11("mega8"))
    kernels[-1]["ms_std128_k2"] = res_h["mega7"]["ms"]
    kernels[-1].update({f"ms_{k}_in_turns_b{B}": v
                        for B, t in turns7.items() for k, v in t.items()})
    # mega9 (csrc/mega12.cu's doubled window) timed at STD128_K2 in path H,
    # in turns with mega11; mega14 at STD128_K4 (path K), beside its
    # STD128_K2 time (A')
    for name, line, res, err_k in (
            ("mega9", "legacy.py:874", res_h["mega9"], errs_j["mega9"]),
            ("mega14", "mega.py:997", {**res_k, "plain_ms": plain14_ms},
             err14)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": ("herdsman_tpu_torch/csrc/megaS.cu" if name == "mega14"
                       else "herdsman_tpu_torch/csrc/mega12.cu"),
            "replaces": f"herdsman_tpu/ops/pallas/{line}",
            **launches(name),
            "matches_plain": err_k == 0,
            "max_abs_err": err_k,
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
            "ms_b256": res["narrow_ms"],
        })
    kernels[-2].update(vs_mega11("mega9"))
    kernels[-1]["ms_std128_k2"] = res_a14["mega14"]["ms"]
    kernels[-1]["ms_std128_shortint_fast"] = f14_ms
    kernels[-1].update({f"ms_{k}_in_turns_b{B}": v
                        for B, t in turns14.items() for k, v in t.items()})
    # mega10 (csrc/mega12.cu's doubled window) timed at STD128_K2 in path H,
    # in turns with mega11, and at STD128 in path L, in turns with mega13
    res, res_std = res_h["mega10"], res_l["mega10"]
    kernels.append({
        "name": "mega10",
        "route": "cuda",
        "source": "herdsman_tpu_torch/csrc/mega12.cu",
        "replaces": "herdsman_tpu/ops/pallas/legacy.py:1019",
        **launches("mega10"),
        "matches_plain": errs_j["mega10"] == 0,
        "max_abs_err": errs_j["mega10"],
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,
        "ms_b256": res["narrow_ms"],
        "ms_std128": res_std["ms"],
        "plain_ms_std128": res_std["plain_ms"],
        "bound_ms_std128": res_std["bound_ms"],
    })
    kernels[-1].update({
        **vs_mega11("mega10"),
        **{f"ms_{k}_in_turns_std128_b{B}": v
           for B, t in turns_l["mega10"].items() for k, v in t.items()}})
    # csrc/mega12.cu's single window under the wrappers of mega and mega2,
    # timed at STD128_K2 in path M1, in turns with bt_fused and mega7; under
    # those of mega5, mega4, mega6 and mega3 at STD128_K2 in path H, in
    # turns with mega7, and (mega5, mega4, mega3) at STD128 in path L, in
    # turns with each other and mega13
    for name, line, res, turns in (
            ("mega", 37, res_m["mega"], times_m),
            ("mega2", 165, res_m["mega2"], times_m),
            ("mega5", 575, res_h["mega5"], {"mega7": res_h["mega7"]}),
            ("mega4", 423, res_h["mega4"], {"mega7": res_h["mega7"],
                                            "mega5": res_h["mega5"]}),
            ("mega6", 705, res_h["mega6"], {"mega7": res_h["mega7"]}),
            ("mega3", 295, res_h["mega3"], {"mega7": res_h["mega7"]})):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "herdsman_tpu_torch/csrc/mega12.cu",
            "replaces": f"herdsman_tpu/ops/pallas/legacy.py:{line}",
            **launches(name),
            "matches_plain": errs_j[name] == 0,
            "max_abs_err": errs_j[name],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
            "ms_b256": res["narrow_ms"],
            **{f"ms_{k}": t["ms"] for k, t in turns.items() if k != name},
            **{f"ms_{k}_b256": t["narrow_ms"] for k, t in turns.items()
               if k != name},
            **{f"ratio_to_{k}": res["ms"] / t["ms"]
               for k, t in turns.items() if k != name},
            **{f"ratio_to_{k}_b256": res["narrow_ms"] / t["narrow_ms"]
               for k, t in turns.items() if k != name},
        })
        if name in res_l:  # mega5, mega4 and mega3 at STD128 (path L)
            kernels[-1].update({
                "ms_std128": res_l[name]["ms"],
                "plain_ms_std128": res_l[name]["plain_ms"],
                "bound_ms_std128": res_l[name]["bound_ms"],
                **{f"ms_{k}_in_turns_std128_b{B}": v
                   for B, t in turns_l[name].items() for k, v in t.items()},
                **{f"ratio_to_{k}_std128_b{B}": t[name] / t[k]
                   for B, t in turns_l[name].items() for k in t
                   if k != name}})
    for name in row_j:  # path M2: the job's rotations on the engine
        next(k for k in kernels if k["name"] == name)["m2_rotation_s"] = \
            res_m2_s[name]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
