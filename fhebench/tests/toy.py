"""Toy-sized copies of the benchmark's cells, for the CPU tests: the same
drivers, readers and reference, the configuration's parameter set
replaced by the program's small test set and the traffic cut to a few
rows.  The files go to a folder of their own that the layout
searches before the benchmark's, and ``BENCHMARK.json``'s entries are
copied in memory: no file of the benchmark is edited.
"""

from __future__ import annotations

import copy
import json
import pathlib

from fhebench import run as bench

# the program's TEST_SMALL
HERD_SET = {"name": "test_small", "n": 128, "N": 256, "k": 1, "bg_bits": 7,
            "levels": 3, "ks_base_bits": 3, "ks_levels": 5, "lwe_std": 2.0,
            "glwe_std": 2.0}
# cell -> (its toy name, traffic changes)
CELLS = {
    "herd_tfhe_lib.batch": ("herd_toy.batch", {"rows": 16, "partitions": 2,
                                               "check_intermediate": 1}),
    "herd_tfhe_lib.small": ("herd_toy.small", {"rows": 8, "clients": 2}),
}
# at a test set's small n and N an int4 gadget (the cells' control) still
# decrypts right; digits of 1 bit (bg_bits 1 at the same levels) are the
# same kind of cut, deep enough to show at this size
CONTROL = {"bg_bits": 1}


def layout(folder: pathlib.Path) -> bench.Layout:
    """Write the toy cells' files into ``folder`` and return a layout that
    finds them first."""
    for kind in ("configs", "workloads"):
        (folder / kind).mkdir(parents=True, exist_ok=True)
    herd = json.loads(
        (bench.HERE / "configs/herd_tfhe_lib.json").read_text())
    (folder / "configs/herd_toy.json").write_text(json.dumps(
        herd | {"name": "herd_toy", "params": HERD_SET}))
    b = copy.deepcopy(json.loads(bench.BENCHMARK.read_text()))
    for cell, (toy, traffic) in CELLS.items():
        spec = json.loads((bench.HERE / f"workloads/{cell}.json").read_text())
        spec["config"] = "herd_toy"
        spec["traffic"] |= traffic
        spec["profile_seconds"] = 0.1
        (folder / f"workloads/{toy}.json").write_text(json.dumps(spec))
        b["workloads"].append({"name": toy, "config": "herd_toy",
                               "traffic": toy.split(".")[1], "chips": 1,
                               "why": "toy copy of " + cell})
        for m in b["end_to_end"] + b["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(toy)
    return bench.Layout(b, (folder, bench.HERE))


def run(lay: bench.Layout, cell: str, seed: int = 2**31 + 11,
        trace: bool = False, params: dict | None = None) -> dict:
    """One CPU run of a toy cell, with a window of one job a client; a
    traced run keeps its trace beside the toy files."""
    return bench.run_cell(lay, CELLS[cell][0], seed, 0.01, trace,
                          device="cpu", params=params,
                          out_dir=lay.dirs[0] / "traces")
