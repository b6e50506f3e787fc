"""The least time an NVIDIA H100 could take for a blind rotation's work.

The benchmark's own copy of the arithmetic of the program's
``utils/bounds.py``, with one change: the bytes count the raw
bootstrapping key, read once, so the work of a rotation depends only on
the parameter set and the width, whatever key layout a kernel reads.

A rotation of B ciphertexts is n steps; each step multiplies the digits of
B accumulators [B, (k+1)*l*N] by the step's key expanded into int8 limbs
[(k+1)*l*N, (k+1)*4*N]: n * B * (R*N) * ((k+1)*4*N) int8 multiply-adds
(R = (k+1)*l).  Its bytes: the trivial accumulators in and the results
out (int32), the switched masks in (int32), and the raw key
[n, R, k+1, N] of u32 once.  The bound is the larger of the operations
over the peak int8 rate and the bytes over the peak memory rate.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: 1,979 TOP/s int8,
3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def rotation(p: dict, B: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one blind rotation of width ``B`` at the
    parameter set ``p`` (a configuration's numbers)."""
    n, N, k, levels = p["n"], p["N"], p["k"], p["levels"]
    R = (k + 1) * levels
    ops = 2 * n * B * (R * N) * ((k + 1) * 4 * N)
    nbytes = 2 * 4 * B * (k + 1) * N + 4 * n * B + 4 * n * R * (k + 1) * N
    return ops, nbytes


def bound_s(p: dict, B: int) -> float:
    ops, nbytes = rotation(p, B)
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def share(run: dict) -> float | None:
    """The window's rotations' least time over their CUDA-event time, in
    %; None where the run recorded no rotation."""
    calls = run.get("rotations")
    if not calls:
        return None
    p = run["config"]["params"]
    bound = sum(bound_s(p, B) for B, _ in calls)
    spent = sum(ms for _, ms in calls) / 1e3
    return 100.0 * bound / spent
