"""Where the time of ``csrc/megaS.cu`` goes, on the card: ``mega13`` (on
``bsk_btS``), ``mega14`` (on ``bsk_btTe``), or ``mega17``, ``mega15`` or
``mega16`` (on ``bsk_btTc``: ``mega13``'s kernel at the byte-aligned
gadget) timed in turns with variants built from the kernel's own source
with one part taken out, on the same inputs and random keys of one
parameter set:

- ``no_products``: the consumers skip their ``wgmma``s (the ring, the
  copies, the fragments, the digits and the barriers stay);
- ``no_fragments``: the consumers build their A fragments without reading
  the staged key slices (the funnel shifts stay);
- ``no_staging``: the producer issues no bulk copy and arrives on the full
  barrier itself (the products run on stale stages);
- ``no_digits``: phase (a) copies its rows into shared memory but computes
  and stores no digit (the products read stale ones).

The outputs of the variants are wrong by design, and no variant's output is
kept.  Beside each time: the share of the rotation's bound and the bytes
the stages read from L2 per rotation over the kernel's time.  Needs a CUDA
card and ``nvcc``:

    python -m herdsman_tpu_torch.utils.megaS_ablation \\
        [--kernel mega13] [--set std128_k2 ...] [--batch 2048 256 ...]
    python -m herdsman_tpu_torch.utils.megaS_ablation \\
        --kernel mega13 --set std128 --batch 2048 256

(the default set is the kernel's own: ``std128_k2`` for ``mega13`` and
``mega14``, ``std128_shortint_b8`` for ``mega17``, ``std128_shortint_l4``
for ``mega15``, ``std128_shortint_fast`` for ``mega16``; the second line
runs STD128, N = 1024, k = 1, bg = 2^7 and 3 levels, the geometry of the
benchmark's TFHE-lib set at n = 768 steps where that set has 630).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import tempfile

import torch

from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops.kernels import _build, megaS
from herdsman_tpu_torch.utils import bounds

# variant -> [(its text in csrc/megaS.cu, the replacement)], each text found
# once
VARIANTS = {
    "no_products": [
        ("wgmma_m64n128k32_rs(acc0, fa",
         "if (false) wgmma_m64n128k32_rs(acc0, fa"),
        ("wgmma_m64n128k32_rs(acc1, fa",
         "if (false) wgmma_m64n128k32_rs(acc1, fa")],
    "no_fragments": [
        ("for (int m = 0; m < 9; ++m) w[m] = src[m];",
         "for (int m = 0; m < 9; ++m) w[m] = 0x01010101u * m + rel;")],
    "no_staging": [
        ("mbar_expect_tx(&full[s], D_BYTES + 4 * len);",
         "mbar_arrive(&full[s]);"),
        ("bulk_copy(st,\n", "if (false) bulk_copy(st,\n"),
        ("bulk_copy(st + D_BYTES + j * KSLOT,",
         "if (false) bulk_copy(st + D_BYTES + j * KSLOT,")],
    "no_digits": [("for (int x = threadIdx.x; x < nq; x += THREADS) {",
                   "for (int x = threadIdx.x; x < 0; x += THREADS) {")],
}
# the kernel's default parameter set
DEFAULT_SET = {"mega13": "std128_k2", "mega14": "std128_k2",
               "mega17": "std128_shortint_b8",
               "mega15": "std128_shortint_l4",
               "mega16": "std128_shortint_fast"}


def build_variants(out_dir: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """Each variant: ``csrc/megaS.cu`` with its replacements, compiled with
    the port's flags into its own directory under ``out_dir`` (one ``nvcc``
    each, all at once) and loaded."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = out_dir / name
        d.mkdir()
        text = (_build.SRC_DIR / "megaS.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in megaS.cu once")
            text = text.replace(old, new)
        (d / "megaS.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR),
             "-o", str(d / "libmegaS.so"), str(d / "megaS.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = megaS.declare(
            ctypes.CDLL(str(out_dir / name / "libmegaS.so")))
    return libs


def rotate_ms(lib: ctypes.CDLL, kernel: str, p, acc0: torch.Tensor,
              a_t: torch.Tensor, key: torch.Tensor) -> float:
    """Device ms of one rotation through ``lib``'s entry point of ``kernel``
    (``megaS.rotate_with``, with another library)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    megaS.rotate_with(lib, kernel, p, acc0, a_t, key)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def staged_bytes(p, B: int, extended: bool) -> int:
    """Bytes the stages of one rotation read from L2: per K block of every
    item one 16 KB digit tile and four key slices (at most 414 bytes each,
    counted at their 16-byte-rounded length)."""
    pl = megaS.plan(p, B, extended)
    L = p.levels
    qi = min(megaS.QI, p.N)
    slice_bytes = -(-(L * (qi - 1) + megaS.KB + 4) // 16) * 16 + 16
    return p.n * pl.items * pl.kt * (megaS.NT * megaS.KB + 4 * slice_bytes)


def report(kernel: str, p, B: int, smi: str, key: torch.Tensor, run,
           libs: dict[str, ctypes.CDLL]) -> None:
    """Times ``run(lib)`` for the kernel and each variant in turns (kernel,
    variants, variants reversed, kernel, after one warm-up) and prints the
    best of each beside the bound and the staged bytes."""
    run(libs["kernel"])
    order = ["kernel", *VARIANTS, *reversed(VARIANTS), "kernel"]
    times: dict[str, list[float]] = {}
    for name in order:
        times.setdefault(name, []).append(run(libs[name]))
    bound, by = bounds.bound_ms(*bounds.rotation(p, B, key.numel()))
    staged = staged_bytes(p, B, megaS.KERNELS[kernel])
    for name, runs in times.items():
        ms = min(runs)
        print(f"{kernel} {p.name} B={B} {name}: {ms:.3f} ms (runs "
              f"{[round(t, 3) for t in runs]}), {bound / ms:.4f} of the "
              f"{bound:.4f} ms bound ({by}); stages read "
              f"{staged / 1e9:.2f} GB = {staged / ms / 1e9:.2f} TB/s; plan "
              f"{megaS.plan(p, B, megaS.KERNELS[kernel])} {smi}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(megaS.KERNELS),
                    default="mega13")
    ap.add_argument("--set", nargs="+")
    ap.add_argument("--batch", type=int, nargs="+", default=[2048, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("megaS_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    extended = megaS.KERNELS[args.kernel]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": megaS._lib(), **build_variants(pathlib.Path(tmp))}
        for name in args.set or [DEFAULT_SET[args.kernel]]:
            p = PARAM_SETS[name]
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            key = torch.randint(-128, 128, megaS.key_shape(p, extended),
                                dtype=torch.int8, device=dev, generator=gen)
            for B in args.batch:
                acc0 = torch.randint(-2**31, 2**31, (B, p.k + 1, p.N),
                                     dtype=torch.int32, device=dev,
                                     generator=gen)
                a_t = torch.randint(0, 2 * p.N, (p.n, B), dtype=torch.int32,
                                    device=dev, generator=gen)
                report(args.kernel, p, B, smi, key,
                       lambda lib: rotate_ms(lib, args.kernel, p, acc0, a_t,
                                             key), libs)
            del key


if __name__ == "__main__":
    main()
