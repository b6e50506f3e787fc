"""Run one cell of the benchmark once and print its result as one JSON line.

    python -m fhebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything it
needs is found by name: ``fhebench/workloads/<cell>.json`` names its
configuration (``fhebench/configs/<config>.json``) and its traffic driver
(``fhebench/drivers/<driver>.py``), and each metric is read by
``fhebench/metrics/<metric>.py`` or by the reader its name extends
(``reader``).  A run makes its keys and inputs from ``--seed`` on the
card, warms up (set-up), drives the cell's traffic for ``--seconds`` (the
window), then checks what the window produced against
the plain reference in ``fhebench/reference`` and prints
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"setup", "checks"}`` (``setup``: the seconds of each part of the set-up).
With ``--trace 0`` the metrics are the cell's end-to-end ones; with
``--trace 1`` its per-layer ones, read from CUDA events around every blind
rotation of the window and from a profiled sub-window after it.

Without a CUDA card, with fewer cards than the cell asks for, with a
metric the cell lists that finds nothing to read, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
# top-level module names that no run may load, compared whole: the port's
# own name, herdsman_tpu_torch, begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "herdsman_tpu")
OUT_DIR = HERE.parent / "fhebench_out"


class NoResult(Exception):
    """A run that must print no result: the message goes to stderr."""


@dataclasses.dataclass
class Layout:
    """Where the benchmark's files are: ``BENCHMARK.json``'s contents and
    the folders searched in turn for ``configs/``, ``workloads/``,
    ``drivers/`` and ``metrics/``."""

    bench: dict
    dirs: tuple[pathlib.Path, ...] = (HERE,)

    @classmethod
    def default(cls) -> "Layout":
        return cls(json.loads(BENCHMARK.read_text()))

    def path(self, kind: str, name: str, ext: str) -> pathlib.Path:
        for d in self.dirs:
            p = d / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise NoResult(f"fhebench: no {kind}/{name}{ext} in "
                       f"{[str(d) for d in self.dirs]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.path(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"fhebench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod   # dataclasses look their module up
        spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Cell:
    """One cell: its entry in ``BENCHMARK.json``, its file (traffic and
    limits), its configuration and the metrics it reports."""

    name: str
    entry: dict
    spec: dict
    config: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def find(cls, layout: Layout, name: str) -> "Cell":
        entries = [w for w in layout.bench["workloads"] if w["name"] == name]
        if not entries:
            raise NoResult(f"fhebench: no cell {name!r} in BENCHMARK.json")
        entry = entries[0]
        spec = layout.json("workloads", name)
        config = layout.json("configs", entry["config"])

        # a metric without "workloads": an end-to-end one is every cell's,
        # a per-layer one every cell's that reports the metric it moves
        end_to_end = [m for m in layout.bench["end_to_end"]
                      if name in m.get("workloads", [name])]
        reported = {m["name"] for m in end_to_end}
        per_layer = [m for m in layout.bench["per_layer"]
                     if name in m.get("workloads", [name] if m["moves"]
                                      in reported else [])]
        return cls(name, entry, spec, config, end_to_end, per_layer)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card(torch, chips: int) -> dict:
    """The card's description; raises NoResult without enough cards."""
    if not torch.cuda.is_available():
        raise NoResult("fhebench: no CUDA device; the benchmark runs on an "
                       "NVIDIA GPU only")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"fhebench: the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def reader(layout: Layout, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the
    reader of the name without its last dotted part, so a quantity split
    by the end-to-end metric it moves (``rotation_roofline.small``) reads
    with one file (``rotation_roofline.py``)."""
    base = name
    while True:
        try:
            return layout.module("metrics", base)
        except NoResult:
            if "." not in base:
                raise NoResult(f"fhebench: no reader for metric {name}")
            base = base.rsplit(".", 1)[0]


def read_metrics(layout: Layout, metrics: list[dict], run: dict) -> dict:
    """{name: {"value", "unit"}} of the cell's metrics.  A reader returns
    None where the run has nothing for it to read; in a cell that lists
    the metric that is a fault (a rotation routed around the recorded
    entry, say), and the run prints no result."""
    out, silent = {}, []
    for m in metrics:
        value = reader(layout, m["name"]).read(run)
        if value is None:
            silent.append(m["name"])
        else:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    if silent:
        raise NoResult(f"fhebench: {silent} found nothing to read in cell "
                       f"{run['cell']}, which they are listed for")
    return out


def run_cell(layout: Layout, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", params: dict | None = None,
             t_start: float = T_START, out_dir: pathlib.Path = OUT_DIR
             ) -> dict:
    """One run of cell ``name``: the result's dict, ``checks`` last.
    ``device`` "cpu" (tests only) skips the look for a card; ``params``
    replaces numbers of the configuration's parameter set (a control);
    a traced run keeps its profile's trace in ``out_dir``."""
    import torch

    from fhebench import trace as tracing
    cell = Cell.find(layout, name)
    chips = cell.entry["chips"]
    dev = torch.device(device)
    info = (card(torch, chips) if dev.type == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 1})
    driver = layout.module("drivers", cell.spec["driver"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    state = driver.setup(cell, seed, dev, params)
    try:
        run = {"cell": cell.name, "config": cell.config,
               "setup_s": time.perf_counter() - t_start}
        # where the set-up went: the start (imports, the card) and the
        # driver's phases
        setup = {"start": t_setup - t_start,
                 **getattr(state, "setup_phases", {})}
        recorder = tracing.RotationRecorder(dev) if trace else None
        with recorder or contextlib.nullcontext():
            run.update(driver.window(state, seconds))
        if recorder is not None:
            run["rotations"] = recorder.calls()
            out_dir.mkdir(exist_ok=True)
            run["profile"] = tracing.profile(
                lambda: driver.window(state, cell.spec["profile_seconds"]),
                dev, out_dir / f"{cell.name}.seed{seed}.trace.json",
                getattr(driver, "host_spans", None) and
                (lambda: driver.host_spans(state)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        driver.release(state)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = driver.check(state)
    finally:
        driver.close(state)
    metrics = read_metrics(layout, cell.per_layer if trace
                           else cell.end_to_end, run)
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in checks.values()),
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": info}
    if trace:
        prof = run["profile"]
        info["busy_s"], info["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    result["setup"] = setup
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(Layout.default(), args.workload, args.seed,
                          args.seconds, bool(args.trace))
        found = forbidden_modules()
        if found:
            raise NoResult(f"fhebench: the run loaded {found}; nothing it "
                           f"runs may import JAX or the JAX package")
    except NoResult as e:
        print(e, file=sys.stderr)
        return 2
    for k, v in result["setup"].items():
        print(f"setup {k} {v!r} s", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
