"""Least times an NVIDIA H100 could take for the blind-rotation kernels' work.

A bound is the larger of two times: the bytes a function must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does over the card's peak rate for their type.  The
peaks are the H100 SXM's published ones (NVIDIA data sheet, dense, 700 W);
the 32-bit integer rate is 64 lanes per SM per clock at 132 SMs and the
1.98 GHz boost clock.  ``chip_smoke.py`` computes its kernels' bounds here
from its own inputs' shapes, and

    python -m herdsman_tpu_torch.utils.bounds

prints the bound of every TPU kernel of the JAX package at its own
parameter set and B = 2048 (the ``Bound ms`` column of ``PERF.md``'s kernel
table).  Every blind-rotation kernel is counted as the int8 limb product
the TPU kernels run: n * B * (R*N) * ((k+1)*4*N) MACs per rotation.
"""

from __future__ import annotations

from herdsman_tpu_torch.core.params import PARAM_SETS, TFHEParams
from herdsman_tpu_torch.ops.kernels import megaT

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 64 * 132 * 1.98e9


def bound_ms(ops: float, nbytes: float,
             peak_ops: float = PEAK_INT8_OPS) -> tuple[float, str]:
    """(ms, what bounds it) for ``ops`` operations (int8 by default) on
    inputs and outputs of ``nbytes`` in all."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _tile(p: TFHEParams) -> tuple[int, int]:
    P = min(128, p.N)
    return P, p.N // P


def key_layout_bytes(p: TFHEParams, layout: str) -> int:
    """Bytes of a JAX package key layout (int8), from the sizes its
    ``ops/server_key.py`` builds and ``fit_engine`` budgets, or of the
    port's ``bsk_btk`` and ``bsk_btk2`` (``bsk_btjj`` and ``bsk_btj2j``
    reordered for ``csrc/mega12.cu``) and ``bsk_btTc`` (the compact step
    key of ``csrc/megaS.cu``'s byte-aligned entries)."""
    P, HALF = _tile(p)
    kp1, R = p.k + 1, (p.k + 1) * p.levels
    single = p.n * R * kp1 * 4 * p.N * P
    sizes = {
        "bsk_bt": single, "bsk_btj": single, "bsk_btjj": single,
        "bsk_btk": single,
        "bsk_btj2": 2 * single, "bsk_btj2j": 2 * single,
        "bsk_btk2": 2 * single,
        "bsk_btT": p.n * kp1 * 4 * kp1 * P * (p.N // (2 * P) + HALF - 1)
        * P * 4,
        "bsk_btTs": p.n * kp1 * kp1 * 4 * P * 2 * p.N,
        "bsk_btT3": p.n * kp1 * kp1 * 4 * P * 3 * p.N,
        "bsk_btT4": p.n * kp1 * kp1 * 4 * P * 4 * p.N,
        "bsk_btTc": megaT.key_bytes(p),
    }
    sizes["bsk_btT2"] = sizes["bsk_btT"]
    return sizes[layout]


def rotation(p: TFHEParams, B: int, key_bytes: int) -> tuple[float, float]:
    """(int8 ops, bytes) of a whole n-step rotation of B ciphertexts: acc0
    and the switched masks in, the accumulators out, the key read once."""
    R = (p.k + 1) * p.levels
    ops = 2 * p.n * B * (R * p.N) * ((p.k + 1) * 4 * p.N)
    nbytes = 2 * 4 * B * (p.k + 1) * p.N + 4 * p.n * B + key_bytes
    return ops, nbytes


def external_product_step(p: TFHEParams, B: int,
                          fused: bool) -> tuple[float, float]:
    """(int8 ops, bytes) of one step's block-Toeplitz external product:
    digits and the step key in, (with ``fused``) the accumulators in, the
    product out."""
    P, HALF = _tile(p)
    R = (p.k + 1) * p.levels
    ops = 2 * B * (R * p.N) * ((p.k + 1) * 4 * p.N)
    glwe = 4 * B * (p.k + 1) * p.N
    nbytes = B * R * p.N + R * HALF * P * (p.k + 1) * 4 * P \
        + glwe * (2 if fused else 1)
    return ops, nbytes


def rotate_decompose_step(p: TFHEParams, B: int) -> tuple[float, float]:
    """(int32 ops, bytes) of one step's rotate + difference + decomposition:
    per coefficient about 8 operations for the rotation, difference and
    rounding and 4 per level for the digits; the accumulators and rotation
    amounts in, the int8 digits out."""
    R = (p.k + 1) * p.levels
    ops = B * (p.k + 1) * p.N * (8 + 4 * p.levels)
    nbytes = 4 * B * (p.k + 1) * p.N + 4 * B + B * R * p.N
    return ops, nbytes


# every function of the JAX package that reaches pl.pallas_call:
# (kernel body, parameter set of its tier, key layout it reads); a ported
# kernel's set is the one chip_smoke.py times it at (mega8 and mega7 serve
# any gadget: STD128_K2 in path H, STD128_SHORTINT in path J)
TPU_KERNELS = [
    ("mega.py:793 _mega13_kernel", "std128_k2", "bsk_btT"),
    ("mega.py:625 _mega12_kernel", "std128_shortint", "bsk_btk"),
    ("mega.py:1495 _mega17_kernel", "std128_shortint_b8", "bsk_btT3"),
    ("mega.py:1323 _mega16_kernel", "std128_shortint_fast", "bsk_btTc"),
    ("mega.py:449 _mega11_kernel", "std128_k2", "bsk_btk2"),
    ("mega.py:236 _mega8_kernel", "std128_k2", "bsk_btk2"),
    ("mega.py:84 _mega7_kernel", "std128_shortint", "bsk_btk"),
    ("mega.py:997 _mega14_kernel", "std128_k2", "bsk_btT2"),
    ("mega.py:1154 _mega15_kernel", "std128_shortint_l4", "bsk_btT4"),
    ("legacy.py:37 _mega_kernel", "std128_k2", "bsk_btk"),
    ("legacy.py:165 _mega2_kernel", "std128_k2", "bsk_btk"),
    ("legacy.py:295 _mega3_kernel", "std128_k2", "bsk_btk"),
    ("legacy.py:423 _mega4_kernel", "std128_k2", "bsk_btk"),
    ("legacy.py:575 _mega5_kernel", "std128_k2", "bsk_btk"),
    ("legacy.py:705 _mega6_kernel", "std128_k2", "bsk_btk"),
    ("legacy.py:874 _mega9_kernel", "std128_k2", "bsk_btk2"),
    ("legacy.py:1019 _mega10_kernel", "std128_k2", "bsk_btk2"),
]


# ported kernels the smoke run also times at another set: mega14 serves the
# eager API at STD128_K4 (path K) beside STD128_K2 (path A'); mega10, mega3,
# mega4 and mega5 serve path L's gate batch at STD128 beside path H's
FURTHER_SETS = [
    ("mega.py:997 _mega14_kernel", "std128_k4", "bsk_btT2"),
    ("legacy.py:1019 _mega10_kernel", "std128", "bsk_btk2"),
    ("legacy.py:295 _mega3_kernel", "std128", "bsk_btk"),
    ("legacy.py:423 _mega4_kernel", "std128", "bsk_btk"),
    ("legacy.py:575 _mega5_kernel", "std128", "bsk_btk"),
]


def table(B: int = 2048) -> list[tuple[str, str, float, str]]:
    """(kernel, parameter set, bound ms, what bounds it) of every TPU
    kernel: whole rotations per call, the two per-step kernels per step."""
    k2 = PARAM_SETS["std128_k2"]
    rows = [("rotate_decompose.py:38 _kernel (one step)", k2.name,
             *bound_ms(*rotate_decompose_step(k2, B), PEAK_INT32_OPS))]
    for fused, name in ((False, "_kernel"), (True, "_kernel_fused")):
        rows.append((f"blind_rotate.py:{189 if fused else 153} {name} "
                     f"(one step)", k2.name,
                     *bound_ms(*external_product_step(k2, B, fused))))
    for kernel, pset, layout in TPU_KERNELS:
        p = PARAM_SETS[pset]
        rows.append((kernel, pset, *bound_ms(
            *rotation(p, B, key_layout_bytes(p, layout)))))
    return rows


def further_table(B: int = 2048) -> list[tuple[str, str, float, str]]:
    """The rows of ``table`` for ``FURTHER_SETS``."""
    return [(kernel, pset, *bound_ms(*rotation(
        PARAM_SETS[pset], B, key_layout_bytes(PARAM_SETS[pset], layout))))
        for kernel, pset, layout in FURTHER_SETS]


if __name__ == "__main__":
    print(f"bounds on one H100 at B=2048 (int8 {PEAK_INT8_OPS:.4g} op/s, "
          f"int32 {PEAK_INT32_OPS:.4g} op/s, {PEAK_BYTES:.4g} B/s)")
    for kernel, pset, ms, by in table() + further_table():
        print(f"{kernel:45s} {pset:22s} {ms:12.4f} ms ({by})")
