#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``herdsman_tpu_torch``) on one NVIDIA
GPU, at the parameter set of record, STD128_K2 (n=768, N=512, k=2, bg=2^8,
l=2), with keys made from a seed.

    python3 chip_smoke.py [--seed S]

Phases, in order; any failure raises and exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: every kernel under ``herdsman_tpu_torch/csrc/``, one nvcc each,
   all at once;
3. kernel vs plain: the blind-rotation kernel (mega13) against its plain
   PyTorch version on the card, by array equality, on the rotation inputs
   of main path A's gate batch at every width the main paths give it
   (2048, and the adder's 256 and 128), and two ciphertexts against the
   NumPy reference;
4. main path A: ``gates.gate_batch`` on 2048 gates of all six kinds;
   decrypted against the truth table, two of them array-compared with the
   NumPy ``bootstrap_bool`` of the same linear combination;
5. main path B: ``compiler.lower.compile_circuit`` on an 8-bit ripple adder
   (a + b, UINT8) over 128 rows, decrypted against ``evaluate_plain``;
6. times (CUDA events, after warm-up) of the kernel at B=2048, the key
   switch, the plain version and both main paths end to end.

The kernel's launch counter is set to 0 before each main path and read
after it; the run fails if a path did not launch the kernel.  The
second-to-last line of output is a JSON object describing every kernel;
the last is ``{"ok": true, "device": {...}}``.  The script needs a CUDA
card and the repo's ``herdsman_tpu_torch`` beside it, and imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
B_MAIN = 2048
ROWS = 128


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


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for ``ops``
    int8 operations on inputs and outputs of ``nbytes`` in all."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes \
        else "bytes"


def host_s(fn):
    """(result, host seconds) of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from herdsman_tpu_torch.circuit import CircuitBuilder, ColumnMeta, DataType
        from herdsman_tpu_torch.compiler import lower
        from herdsman_tpu_torch.core import STD128_K2 as P
        from herdsman_tpu_torch.core import reference as ref
        from herdsman_tpu_torch.ops import bootstrap as bs
        from herdsman_tpu_torch.ops import gates
        from herdsman_tpu_torch.ops.decomp import signed_decompose
        from herdsman_tpu_torch.ops.kernels import _build, mega13
        from herdsman_tpu_torch.ops.server_key import device_server_key
        from herdsman_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32
    except ImportError as e:
        print(f"chip_smoke: the herdsman_tpu_torch package must sit beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    # 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = f"[{smi}]"
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v[0]:.1f} s' for k, v in built.items())})")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    ck, sk = ref.keygen(P, rng)
    dsk = device_server_key(sk, device=dev)
    print(f"keys: {P.name} keygen + carry to the card "
          f"{time.perf_counter() - t0:.1f} s")
    tp = bs.make_test_poly(P, device=dev)

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
    # at every rotation width of the main paths (the adder's rows * 1, 2, 16)
    err, outs = 0, {}
    for B in (B_MAIN, 2 * ROWS, ROWS):
        args = acc0[:B].contiguous(), a_t[:, :B].contiguous()
        outs[B] = mega13.mega13_blind_rotate(P, *args, dsk.bsk)
        plain = mega13.blind_rotate_plain(P, *args, dsk.bsk_ext)
        err = max(err, int(np.abs(to_numpy_u32(outs[B]).astype(np.int64)
                                  - to_numpy_u32(plain).astype(np.int64)).max()))
        check(torch.equal(outs[B], plain), f"mega13 != plain version at B={B}")
    lin_np = to_numpy_u32(lin)
    for i in (0, B_MAIN - 1):
        want = ref.blind_rotate(sk, lin_np[i], ref.make_test_poly(P))
        check(np.array_equal(to_numpy_u32(outs[B_MAIN][i]), want),
              f"mega13 != reference.blind_rotate for ciphertext {i}")
    print(f"kernel vs plain: mega13 == blind_rotate_plain at B in {list(outs)} "
          f"on the gate batch's rotation inputs (array equality, max_abs_err "
          f"{err}); ciphertexts 0 and {B_MAIN - 1} == reference.blind_rotate")

    # 4. main path A: one heterogeneous gate batch ---------------------------
    mega13.mega13_blind_rotate.launches = 0
    out, gate_s = host_s(lambda: gates.gate_batch(dsk, batch, device=dev))
    launches_a = mega13.mega13_blind_rotate.launches
    check(launches_a > 0, "main path A did not launch mega13")
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
    mega13.mega13_blind_rotate.launches = 0
    y, job_s = host_s(lambda: run(x))
    launches_b = mega13.mega13_blind_rotate.launches
    check(launches_b > 0, "main path B did not launch mega13")
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
            P, acc0[:B].contiguous(), a_t[:, :B].contiguous(), dsk.bsk)

    kernel_ms = timed_ms(rotate(B_MAIN), reps=3)
    narrow_ms = {B: timed_ms(rotate(B), reps=3) for B in (ROWS, 2 * ROWS)}
    plain_ms = timed_ms(lambda: mega13.blind_rotate_plain(P, acc0, a_t,
                                                          dsk.bsk_ext), reps=1)
    R = (P.k + 1) * P.levels
    bound_ms, bound_by = bound(
        2 * P.n * B_MAIN * (R * P.N) * ((P.k + 1) * P.N * 4),
        4 * (2 * acc0.numel() + a_t.numel() + dsk.bsk.numel()))
    print(f"time: mega13 B={B_MAIN} {kernel_ms:.3f} ms = "
          f"{B_MAIN / kernel_ms * 1e3:.1f} bootstraps/s, "
          f"{bound_ms / kernel_ms:.4f} of the {bound_ms:.2f} ms bound "
          f"({bound_by}) {card}")
    for B, ms in narrow_ms.items():  # the adder's narrow level widths
        print(f"time: mega13 B={B} {ms:.3f} ms = "
              f"{B / ms * 1e3:.1f} bootstraps/s {card}")
    print(f"time: blind_rotate_plain B={B_MAIN} {plain_ms:.3f} ms {card}")

    raw = bs.sample_extract_batch(P, rotate(B_MAIN)())
    ks_ms = timed_ms(lambda: bs.key_switch_batch(dsk, raw), reps=10)
    d8 = signed_decompose(raw[:, :P.kN], P.ks_base_bits, P.ks_levels
                          ).reshape(B_MAIN, -1).to(torch.int8)
    mm_ms = timed_ms(lambda: mega13.int8_matmul(d8, dsk.ksk_limbs), reps=10)
    ks_bound_ms, ks_by = bound(
        2 * d8.numel() * dsk.ksk_limbs.shape[1],
        4 * raw.numel() + dsk.ksk_limbs.numel() + 4 * B_MAIN * (P.n + 1))
    print(f"time: key_switch_batch B={B_MAIN} {ks_ms:.3f} ms, of which "
          f"torch._int_mm [{B_MAIN}, {d8.shape[1]}] x "
          f"{list(dsk.ksk_limbs.shape)} {mm_ms:.3f} ms; bound "
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

    # 7-8. result lines -------------------------------------------------------
    kernels = [{
        "name": "mega13",
        "route": "cuda",
        "source": "herdsman_tpu_torch/csrc/mega13.cu",
        "replaces": "herdsman_tpu/ops/pallas/mega.py:793",
        "launches": launches_a + launches_b,
        "launches_by_path": {"gate_batch": launches_a,
                             "adder_job": launches_b},
        "matches_plain": err == 0,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
