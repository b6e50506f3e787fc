"""The harness on the CPU: traffic made from the seed, cells, configs and
metrics found by name as files of their own, the command refusing to run
without a card, and the modules a run loads."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from fhebench import run as bench
from fhebench.tests import toy

REPO = bench.HERE.parent
FORBIDDEN = set(bench.FORBIDDEN)


@pytest.fixture(scope="module")
def lay(tmp_path_factory):
    return toy.layout(tmp_path_factory.mktemp("toy"))


@pytest.mark.parametrize("cell", list(toy.CELLS))
def test_traffic_is_the_seeds(lay, cell):
    """Two set-ups from one seed make the same inputs; another seed
    others."""
    c = bench.Cell.find(lay, toy.CELLS[cell][0])
    driver = lay.module("drivers", c.spec["driver"])

    def inputs(seed):
        st = driver.setup(c, seed, torch.device("cpu"))
        try:
            return [x for cl in st.clients for x in (cl.a, cl.b, cl.keys.bsk)]
        finally:
            driver.release(st)
            driver.close(st)
    one, two, other = inputs(2**31 + 3), inputs(2**31 + 3), inputs(5)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    assert not all(torch.equal(x, y) for x, y in zip(one, other))


@pytest.mark.parametrize("cell", list(toy.CELLS))
def test_toy_cells_run_and_are_correct(lay, cell):
    res = toy.run(lay, cell)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    c = bench.Cell.find(lay, toy.CELLS[cell][0])
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(res)[-1] == "checks"


def test_traced_run_reads_per_layer_metrics(lay):
    res = toy.run(lay, "herd_tfhe_lib.batch", trace=True)
    c = bench.Cell.find(lay, toy.CELLS["herd_tfhe_lib.batch"][0])
    # split by the end-to-end metric they move, each read by the reader
    # its name extends
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer} == {
        "service.io_s.batch", "compiler.bootstraps_per_row.batch",
        "rotation_roofline.batch", "device.idle_share.batch"}
    assert "window_s" in res["device"] and "breakdown" in res
    assert list(res)[-2:] == ["setup", "checks"]


def test_a_listed_metric_that_reads_nothing_is_no_result(lay, tmp_path):
    """A reader that finds nothing in a cell that lists it (a rotation
    routed around the recorded entry, say) stops the run: no result."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics/rotation_roofline.py").write_text(
        "def read(run):\n    return None\n")
    silent = bench.Layout(lay.bench, (tmp_path,) + lay.dirs)
    with pytest.raises(bench.NoResult, match="rotation_roofline"):
        bench.run_cell(silent, "herd_toy.batch", 3, 0.01, True,
                       device="cpu", out_dir=tmp_path)


def test_metrics_without_a_list_of_cells():
    """Without "workloads", an end-to-end metric is every cell's and a
    per-layer one every cell's that reports the metric it moves."""
    b = {"workloads": [{"name": c, "config": "x", "chips": 1}
                       for c in ("a.one", "a.two")],
         "end_to_end": [{"name": "rate", "workloads": ["a.one"]},
                        {"name": "setup_s"}],
         "per_layer": [{"name": "share", "moves": "rate"},
                       {"name": "io", "moves": "setup_s"}]}

    class Fixed(bench.Layout):
        def json(self, kind, name):
            return {}
    lay = Fixed(b)
    one, two = (bench.Cell.find(lay, c) for c in ("a.one", "a.two"))
    assert [m["name"] for m in one.end_to_end] == ["rate", "setup_s"]
    assert [m["name"] for m in one.per_layer] == ["share", "io"]
    assert [m["name"] for m in two.end_to_end] == ["setup_s"]
    assert [m["name"] for m in two.per_layer] == ["io"]


def test_files_dropped_in_are_found_by_name(tmp_path):
    """A new configuration, cell and metric, each a file of its own in
    another folder, run with no file of the benchmark edited."""
    before = {p: p.read_bytes() for p in bench.HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    lay = toy.layout(tmp_path / "toy")
    new = tmp_path / "new"
    for kind in ("configs", "workloads", "metrics"):
        (new / kind).mkdir(parents=True)
    cfg = json.loads((tmp_path / "toy/configs/herd_toy.json").read_text())
    (new / "configs/herd_new.json").write_text(json.dumps(
        cfg | {"name": "herd_new"}))
    spec = json.loads(
        (tmp_path / "toy/workloads/herd_toy.small.json").read_text())
    spec["config"] = "herd_new"
    spec["traffic"] |= {"rows": 4, "clients": 1}
    (new / "workloads/herd_new.tiny.json").write_text(json.dumps(spec))
    (new / "metrics/rows_per_job.py").write_text(
        "def read(run):\n"
        "    return sum(j['rows'] for j in run['jobs']) / len(run['jobs'])\n")
    b = lay.bench
    b["workloads"].append({"name": "herd_new.tiny", "config": "herd_new",
                           "traffic": "tiny", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "rows_per_job", "unit": "rows",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["herd_new.tiny"]})
    for m in b["end_to_end"]:
        if m["name"] == "rows_per_s.small":
            m["workloads"].append("herd_new.tiny")
    res = bench.run_cell(bench.Layout(b, (new,) + lay.dirs),
                         "herd_new.tiny", 3, 0.01, False, device="cpu")
    assert res["correct"]
    assert res["metrics"]["rows_per_job"]["value"] == 4
    assert "rows_per_s.small" in res["metrics"]
    after = {p: p.read_bytes() for p in bench.HERE.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def _command(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "fhebench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(["--workload", "herd_tfhe_lib.batch", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], REPO)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_command_beside_nothing_but_the_benchmark_fails(tmp_path):
    """In a folder holding only BENCHMARK.json and fhebench/, the program
    is missing: no result, another code than 0."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(["--workload", "herd_tfhe_lib.small", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


def test_a_run_loads_no_jax(tmp_path):
    """The modules a run loads, by top-level name compared whole: neither
    JAX nor the JAX package (the port's name begins with the JAX
    package's)."""
    code = (
        "import pathlib, sys\n"
        "from fhebench.tests import toy\n"
        f"lay = toy.layout(pathlib.Path({str(tmp_path)!r}))\n"
        "for cell in toy.CELLS:\n"
        "    assert toy.run(lay, cell)['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "herdsman_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path: pathlib.Path) -> set[str]:
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_reference_no_program():
    for path in bench.HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (bench.HERE / "reference").rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"herdsman_tpu_torch"}), \
            path
