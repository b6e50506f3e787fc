"""Where the time of ``csrc/mega12.cu`` goes, on the card: the kernel (its
single window, ``mega12``, ``mega7``, ``mega5`` and ``mega2``, or with
``--kernel mega11`` its doubled window on a ``bsk_btk2``-shaped key) timed
in turns with variants built from its own source with one part taken out
or changed, on the same inputs and random keys of one parameter set:

- ``no_products``: the consumers skip their ``wgmma``s (the ring, the
  copies, the digits and the barriers stay);
- ``no_staging``: the producer issues no bulk copy and arrives on the full
  barrier itself (the products run on stale stages);
- ``no_digits``: phase (a) stores no digit (the products read stale ones);
- ``no_clusters``: no two-block clusters (each block stages its own key
  tiles), and ``no_clusters_no_products`` / ``_no_staging`` with the
  parts above taken out too;
- ``release_cluster``: the arrivals on a peer block's barrier release at
  cluster scope (``.release.cluster``), not at the default one;
- ``no_prefetch``: the producer prefetches no next step's key into L2
  (the single window's prefetch: the doubled window has none);
- ``bm192``: 192-row tiles (three consumer warpgroups beside the producer
  warp, 416 threads, four stages) where the plan takes 128, in two-block
  clusters as before; where ptxas refuses it, its error is printed and the
  variant left out.

The outputs of the variants that take a part out are wrong by design, and
no variant's output is kept.  Beside each
time: the bytes the tiles read from L2 per rotation (A tiles and their
share of the B tiles, from ``mega12.plan``) over the kernel's time, and the
share of the rotation's bound.  Needs a CUDA card and ``nvcc``:

    python -m herdsman_tpu_torch.utils.mega12_ablation \
        [--kernel mega11] [--set std128_shortint ...] [--batch 2048 256 ...]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import tempfile

import torch

from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.ops.kernels import _build, mega12
from herdsman_tpu_torch.utils import bounds

# variant -> (source file under csrc/, its text, the replacement), each
# text found once
VARIANTS = {
    "no_products": [("mega12.cu", "      wgmma_m64n256k32(acc,",
                     "      if (false) wgmma_m64n256k32(acc,")],
    "no_staging": [("mega12.cu",
                    "            mbar_expect_tx(&full[s], G::STAGE);",
                    "            mbar_arrive(&full[s]);"),
                   ("mega12.cu", "            bulk_copy(at,\n",
                    "            if (false) bulk_copy(at,\n"),
                   ("mega12.cu", "              bulk_copy(at + G::A_BYTES,",
                    "              if (false) bulk_copy(at + G::A_BYTES,"),
                   ("mega12.cu", "              bulk_copy_multicast(",
                    "              if (false) bulk_copy_multicast(")],
    "no_digits": [("mega12.cu", "       e < items; e += stride) {",
                   "       e < 0; e += stride) {")],
    "no_clusters": [("mega12.cu",
                     "  const int cluster = bm == 128 && mts >= 2 ? 2 : 1;",
                     "  const int cluster = 1;")],
    "release_cluster": [("hopper.cuh",
                         '"mbarrier.arrive.shared::cluster.b64 _, [%0];"',
                         '"mbarrier.arrive.release.cluster.shared::cluster'
                         '.b64 _, [%0];"')],
    "no_prefetch": [("mega12.cu", "    prefetch_l2(key + x * B_BYTES,",
                     "    if (false) prefetch_l2(key + x * B_BYTES,")],
    "bm192": [("mega12.cu", "3 * n_sms ? 128 : 64;", "3 * n_sms ? 192 : 64;"),
              ("mega12.cu", "const int cluster = bm == 128 &&",
               "const int cluster = bm == 192 &&"),
              ("mega12.cu", "launch<2, 2, DBL>(a, n_sms, s)",
               "launch<3, 2, DBL>(a, n_sms, s)"),
              ("mega12.cu", "launch<2, 1, DBL>(a, n_sms, s)",
               "launch<3, 1, DBL>(a, n_sms, s)")],
}
# variants tried whose build may fail: the failure is printed, not raised
TRIALS = ("bm192",)
# rows of digit scratch beyond B that a variant's tiles may pad to (bm192's
# two-block clusters: 384 rows)
PAD_ROWS = 512
VARIANTS.update({f"no_clusters_{part}":
                 VARIANTS["no_clusters"] + VARIANTS[part]
                 for part in ("no_products", "no_staging")})


def build_variants(out_dir: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """Each variant: ``csrc/mega12.cu`` (and the headers it includes) with
    its replacements, compiled with the port's flags into its own directory
    under ``out_dir`` (one ``nvcc`` each, all at once) and loaded; a
    variant of ``TRIALS`` that does not build is left out, its errors
    printed."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = out_dir / name
        d.mkdir()
        files = {f: (_build.SRC_DIR / f).read_text()
                 for f in {f for f, _, _ in edits} | {"mega12.cu"}}
        for f, old, new in edits:
            if files[f].count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {f} once")
            files[f] = files[f].replace(old, new)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-I",
             str(_build.SRC_DIR), "-o", str(d / "libmega12.so"),
             str(d / "mega12.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode and name in TRIALS:
            print(f"{name} does not build:", *(line for line in
                                               log.splitlines()
                                               if "fatal" in line),
                  sep="\n    ", flush=True)
            continue
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / name / "libmega12.so"))
        lib.mega12_blind_rotate.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.mega12_blind_rotate.restype = ctypes.c_int
        libs[name] = lib
    return libs


def rotate_ms(lib: ctypes.CDLL, p, acc0: torch.Tensor, a_t: torch.Tensor,
              key: torch.Tensor, doubled: bool) -> float:
    """Device ms of one rotation through ``lib``'s entry point (the
    wrappers' launch, ``mega12.launch``, with another library)."""
    B = acc0.shape[0]
    out = acc0.clone()
    dig = torch.empty(mega12.scratch_bytes(p, B + PAD_ROWS),
                      dtype=torch.int8, device=acc0.device)
    bar = torch.empty(1, dtype=torch.int32, device=acc0.device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    err = lib.mega12_blind_rotate(
        a_t.data_ptr(), key.data_ptr(), out.data_ptr(), dig.data_ptr(),
        bar.data_ptr(), B, p.n, p.N, p.k + 1, p.bg_bits, p.levels,
        int(doubled), torch.cuda.current_stream().cuda_stream)
    end.record()
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return start.elapsed_time(end)


def staged_bytes(p, B: int, n_sms: int) -> int:
    """Bytes the tiles of one rotation read from L2 into shared memory: per
    K block of every tile an A tile (bm digit rows of 128 bytes) and its
    share of the 32 KB B tile (a cluster's blocks read one copy)."""
    pl = mega12.plan(p, B, n_sms)
    KB = (p.k + 1) * p.levels * (p.N // mega12.P)
    blocks = pl.tiles // pl.splits * pl.cluster * KB  # every block's K blocks
    return p.n * blocks * (pl.bm * mega12.P
                           + mega12.BN * mega12.P // pl.cluster)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("mega12", "mega11"),
                    default="mega12")
    ap.add_argument("--set", nargs="+", default=["std128_shortint"])
    ap.add_argument("--batch", type=int, nargs="+", default=[2048, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mega12_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    doubled = args.kernel == "mega11"
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": mega12._lib(), **build_variants(pathlib.Path(tmp))}
        for name in args.set:
            p = PARAM_SETS[name]
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            key = torch.randint(-128, 128, mega12.key_shape(p, doubled),
                                dtype=torch.int8, device=dev, generator=gen)
            for B in args.batch:
                acc0 = torch.randint(-2**31, 2**31, (B, p.k + 1, p.N),
                                     dtype=torch.int32, device=dev,
                                     generator=gen)
                a_t = torch.randint(0, 2 * p.N, (p.n, B), dtype=torch.int32,
                                    device=dev, generator=gen)
                report(args.kernel, p, B, n_sms, smi, key,
                       lambda lib: rotate_ms(lib, p, acc0, a_t, key, doubled),
                       libs)
            del key


def report(kernel: str, p, B: int, n_sms: int, smi: str, key: torch.Tensor,
           run, libs: dict[str, ctypes.CDLL]) -> None:
    """Times ``run(lib)`` for the kernel and each variant in turns (kernel,
    variants, variants reversed, kernel, after one warm-up) and prints the
    best of each beside the bound and the staged bytes."""
    run(libs["kernel"])
    built = [name for name in VARIANTS if name in libs]
    order = ["kernel", *built, *reversed(built), "kernel"]
    times: dict[str, list[float]] = {}
    for name in order:
        times.setdefault(name, []).append(run(libs[name]))
    bound, by = bounds.bound_ms(*bounds.rotation(p, B, key.numel()))
    staged = staged_bytes(p, B, n_sms)
    for name, runs in times.items():
        ms = min(runs)
        print(f"{kernel} {p.name} B={B} {name}: {ms:.3f} ms (runs "
              f"{[round(t, 3) for t in runs]}), {bound / ms:.4f} of the "
              f"{bound:.4f} ms bound ({by}); tiles stage "
              f"{staged / 1e9:.2f} GB = {staged / ms / 1e9:.2f} TB/s; plan "
              f"{mega12.plan(p, B, n_sms)} {smi}", flush=True)


if __name__ == "__main__":
    main()
