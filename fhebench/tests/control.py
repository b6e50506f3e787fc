"""Readings that set a cell's limits: the checks of sound runs of the
program on many seeds, and of its control, in one process.

    python -m fhebench.tests.control --workload <cell> --seed <first> \
        --sound 12 --control 3 --seconds 1

The control is the program run as the configuration states but with its
gadget's digits cut to int4: ``CONTROL``, bg_bits 4 at the same number of
levels (Bg^l = 2^12 where herd_tfhe_lib states 2^21), keys made for it by
the same reference; a cell file's ``control`` replaces it where a cell
needs other numbers.  Each run drives the cell's own traffic at its own
sizes for ``--seconds`` after its set-up, and prints one JSON line: the
kind of run, its seed and its checks.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

from fhebench import run as bench

CONTROL = {"bg_bits": 4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    layout = bench.Layout.default()
    control = layout.json("workloads", args.workload).get("control",
                                                          CONTROL)
    runs = ([("sound", None)] * args.sound
            + [("control", control)] * args.control)
    for i, (kind, params) in enumerate(runs):
        seed = args.seed + i
        res = bench.run_cell(layout, args.workload, seed, args.seconds,
                             False, params=params)
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
