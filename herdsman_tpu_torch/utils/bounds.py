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
It also prints the bounds of the NTT/RNS path (``ops/ntt``, ``ops/rns``,
no Pallas kernel) at BASELINE config 3, counted as its int8 digit-pair
products and its residues in and out.
"""

from __future__ import annotations

from herdsman_tpu_torch.core.params import PARAM_SETS, TFHEParams
from herdsman_tpu_torch.ops.kernels import megaT
from herdsman_tpu_torch.ops.ntt import split_n

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
        "bsk_conv": p.n * R * kp1 * 4 * (2 * p.N - 1),
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


def correlation(B: int, R: int, N: int, O: int) -> tuple[float, float]:
    """(int8 ops, bytes) of ``bootstrap.conv_i8_correlate``: digits [B, R,
    N] and the compact key [R, O, 2N-1] in, the int32 partials [B, O, N]
    out; B * R*N * O*N MACs.  A ``conv_i8`` step's product has R = (k+1)*l
    and O = (k+1)*4."""
    ops = 2 * B * R * N * O * N
    nbytes = B * R * N + R * O * (2 * N - 1) + 4 * B * O * N
    return ops, nbytes


def pack_lwes(p: TFHEParams, groups: int) -> tuple[float, float]:
    """(int8 ops, bytes) of ``ops.pack.pack_lwes_batch`` on ``groups``
    groups of N LWEs: the LWEs and the packing key [n*t, (k+1)*4, 2N-1] in,
    the GLWEs out; the correlation's MACs with R = n*t."""
    R, O = p.n * p.ks_levels, (p.k + 1) * 4
    ops = 2 * groups * R * p.N * O * p.N
    nbytes = (4 * groups * p.N * (p.n + 1) + R * O * (2 * p.N - 1)
              + 4 * groups * (p.k + 1) * p.N)
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


def ntt_ops(N: int) -> int:
    """int8 operations of one negacyclic NTT (forward or inverse) of one
    limb polynomial: 9 digit-pair products of 2 * N * (N1 + N2) (the two
    DFT steps, N2 rows of [N1] x [N1, N1] and N1 rows of [N2] x [N2,
    N2])."""
    return 9 * 2 * N * sum(split_n(N))


def ntt(N: int, L: int, B: int) -> tuple[float, float]:
    """(int8 ops, bytes) of ``rns.ntt_fwd`` on residues [L, B, N]: the
    residues in and the spectra out, int32."""
    return L * B * ntt_ops(N), 2 * 4 * L * B * N


def ntt_polymul(N: int, L: int, B: int) -> tuple[float, float]:
    """(int8 ops, bytes) of ``rns.polymul`` of two residue batches [L, B,
    N]: 3 NTTs a limb and polynomial (two forward, one inverse); both
    operands in, the product out."""
    return 3 * L * B * ntt_ops(N), 3 * 4 * L * B * N


def rns_key_switch(N: int, L: int, B: int) -> tuple[float, float]:
    """(int8 ops, bytes) of ``rns.key_switch`` of B ciphertexts [2, L, B,
    N]: L digit polynomials forward on every limb (L * L NTTs) and the two
    sums back (2 * L); the ciphertexts in and out, the key [2, L, L, N]
    in."""
    ops = (L * L + 2 * L) * B * ntt_ops(N)
    return ops, 2 * (2 * 4 * L * B * N) + 2 * 4 * L * L * N


def ntt_products(N: int, L: int, B: int) -> tuple[float, float]:
    """(int8 ops, bytes) of the ``torch._int_mm`` products alone of
    ``rns.ntt_fwd`` on [L, B, N]: per limb and step the three digit planes
    [3*B*M, K] in and the int32 products [3*B*M, 3*K] out (M, K = N2, N1
    and N1, N2)."""
    N1, N2 = split_n(N)
    nbytes = sum(L * 3 * B * M * K * (1 + 3 * 4)
                 for M, K in ((N2, N1), (N1, N2)))
    return L * B * ntt_ops(N), nbytes


def ntt_table(B: int = 2048) -> list[tuple[str, str, float, str]]:
    """(function, shape, bound ms, what bounds it) of the NTT/RNS path (no
    pl.pallas_call: its products are torch._int_mm) at BASELINE config 3
    (the JAX package's bench.py --metric rns: N = 4096, 3 primes, B =
    2048), which chip_smoke.py's path R runs, and at N = 2048."""
    fns = {"ntt_fwd": ntt, "polymul": ntt_polymul,
           "key_switch": rns_key_switch}
    return [(f"rns.{name}", f"N={N} L=3 B={B}", *bound_ms(*fn(N, 3, B)))
            for N in (4096, 2048) for name, fn in fns.items()]


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
    for kernel, pset, ms, by in table() + further_table() + ntt_table():
        print(f"{kernel:45s} {pset:22s} {ms:12.4f} ms ({by})")
