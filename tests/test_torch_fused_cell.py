"""The benchmark's cell ``herd_tfhe_lib_fused.batch`` in small, and what
the per-step engine ``bt_fused`` (the config's ``pallas_fused``) records.

- A toy copy of the cell, run through ``fhebench.run.run_cell`` on the CPU
  against the benchmark's plain reference, is correct and runs every
  rotation on ``bt_fused``; with the harness's toy control (1-bit digits)
  it is not correct, nor with a step loop that skips its last step, nor
  with a step that reads another step's slice of the key.
- A ``bt_fused`` rotation counts in ``bootstrap.step_launches`` the device
  operations its steps issued and records one ``bootstrap.step_issue``
  host span inside its ``bootstrap.rotation``; a ``mega13`` rotation
  records neither.  On a card the count equals the two kernels' own
  launch counters plus the sets before K-split products (the card test,
  which skips here).
- The reader ``fhebench/metrics/bootstrap.launches_per_row.py`` returns
  None without the counter, and the counter over the rows with it (the
  toy layout lists its metric in memory).

The toy copy is the cell's configuration and traffic with the program's
TEST_SMALL widths (N = 256, so each step's product runs both of its
block-Toeplitz runs), n cut to 16 steps a rotation, and 8 rows in 2
partitions: at TEST_SMALL's n = 128 the two kernels' plain versions take
about 10 s a job on one CPU thread.  Its files go to a temporary folder
that the layout searches first, and ``BENCHMARK.json``'s entries are
copied in memory, as ``fhebench/tests/toy.py`` does for the other cells.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from fhebench import run as bench
from fhebench.reference import tfhe
from fhebench.tests import toy
from herdsman_tpu_torch.core import PARAM_SETS, TEST_SMALL
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops.kernels import bt
from herdsman_tpu_torch.ops.kernels import rotate_decompose as rd
from herdsman_tpu_torch.ops.server_key import (device_server_key,
                                               layouts_for_engine)
from herdsman_tpu_torch.ops.u32 import from_numpy_u32
from herdsman_tpu_torch.service.coordinator import Coordinator
from herdsman_tpu_torch.utils import tracing

CELL = "herd_tfhe_lib_fused.batch"
TOY_CELL = "herd_toy_fused.batch"
TOY_SET = {"name": "test_small_n16", "n": 16, "N": 256, "k": 1,
           "bg_bits": 7, "levels": 3, "ks_base_bits": 3, "ks_levels": 5,
           "lwe_std": 2.0, "glwe_std": 2.0}
TRAFFIC = {"rows": 8, "partitions": 2, "check_intermediate": 1}
SEED = 2**31 + 14   # its key has the bits both planted faults need
READER = "bootstrap.launches_per_row.fused"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors under parallel test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lay(tmp_path_factory):
    """The toy layout with the fused cell's toy copy beside the others.
    The harness registers the toy set and its control with the program
    (``fhebench/params.py``); they leave ``PARAM_SETS`` with the module,
    whose other users walk every named set."""
    before = dict(PARAM_SETS)
    yield toy_layout(tmp_path_factory.mktemp("toy_fused"))
    PARAM_SETS.clear()
    PARAM_SETS.update(before)


def toy_layout(folder):
    layout = toy.layout(folder)
    entry = next(w for w in layout.bench["workloads"] if w["name"] == CELL)
    cfg = layout.json("configs", entry["config"])
    (folder / "configs/herd_toy_fused.json").write_text(json.dumps(
        cfg | {"name": "herd_toy_fused", "params": TOY_SET}))
    spec = layout.json("workloads", CELL)
    spec["config"] = "herd_toy_fused"
    spec["traffic"] |= TRAFFIC
    spec["profile_seconds"] = 0.1
    (folder / f"workloads/{TOY_CELL}.json").write_text(json.dumps(spec))
    layout.bench["workloads"].append(
        entry | {"name": TOY_CELL, "config": "herd_toy_fused",
                 "why": "toy copy of " + CELL})
    for m in layout.bench["end_to_end"] + layout.bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TOY_CELL)
    # the reader's entry, which BENCHMARK.json takes once the parent of a
    # change counts bootstrap.step_launches
    layout.bench["per_layer"].append(
        {"name": READER, "unit": "launches/row", "better": "lower",
         "source": "program_counter", "layer": "blind-rotation kernels",
         "moves": "rows_per_s.batch", "workloads": [TOY_CELL]})
    return layout


def run(lay, trace=False, params=None):
    return bench.run_cell(lay, TOY_CELL, SEED, 0.01, trace, device="cpu",
                          params=params, out_dir=lay.dirs[0] / "traces")


def test_the_toy_cell_is_correct_and_every_rotation_is_bt_fused(
        lay, monkeypatch):
    engines = []
    orig = Coordinator._device_key

    def recording(self, session):
        engine, dsk = orig(self, session)
        engines.append(engine)
        return engine, dsk
    monkeypatch.setattr(Coordinator, "_device_key", recording)
    res = run(lay, trace=True)
    assert res["correct"], res["checks"]
    assert set(engines) == {"bt_fused"}
    # on the CPU a rotation of n steps issues 2n operations: the reader
    # gives a whole number of rotations' operations over the 8 rows
    per_row = res["metrics"][READER]["value"]
    assert per_row > 0 and (per_row * 8) % (2 * TOY_SET["n"]) == 0
    assert res["metrics"]["rotation_roofline.fused"]["value"] > 0


def test_the_toy_control_is_not_correct(lay):
    res = run(lay, params=toy.CONTROL)
    assert not res["correct"], res["checks"]


def skip_last_step(monkeypatch):
    """A step loop that skips its last step: each rotation's n-th call
    returns the accumulator as it came.  Visible where the key's last bit
    is 1."""
    step, layout = bs.STEP_ENGINES["bt_fused"]
    calls = itertools.count(1)

    def fault(p, acc, a_i, bsk_i):
        return acc if next(calls) % p.n == 0 else step(p, acc, a_i, bsk_i)
    monkeypatch.setitem(bs.STEP_ENGINES, "bt_fused", (fault, layout))
    return lambda s: s[-1] == 1


class FirstStepReadsSecond:
    """A key whose slice for step 0 is step 1's."""

    def __init__(self, key):
        self.key = key

    def __getitem__(self, i):
        return self.key[1 if i == 0 else i]


def wrong_key_slice(monkeypatch):
    """A step that reads the wrong slice of the key: step 0 multiplies by
    step 1's.  Visible where the key's first two bits differ."""
    key = bs._key
    monkeypatch.setattr(bs, "_key", lambda *a: FirstStepReadsSecond(key(*a)))
    return lambda s: s[0] != s[1]


@pytest.mark.parametrize("plant", [skip_last_step, wrong_key_slice])
def test_a_planted_step_fault_is_not_correct(lay, monkeypatch, plant):
    shows = plant(monkeypatch)
    # the seed's key has the bits that make the fault change the result
    assert shows(tfhe.keygen(tfhe.Params.of(TOY_SET), SEED * 64,
                             "cpu").lwe_key.tolist())
    res = run(lay)
    assert not res["correct"], res["checks"]


def random_key(p, device):
    """A server key of random words (the counts need no decryption)."""
    rng = np.random.default_rng(29)
    R = (p.k + 1) * p.levels
    sk = ref.ServerKey(
        p, rng.integers(0, 1 << 32, (p.n, R, p.k + 1, p.N), dtype=np.uint32),
        rng.integers(0, 1 << 32, (p.kN, p.ks_levels, p.n + 1),
                     dtype=np.uint32))
    return device_server_key(sk, layouts=layouts_for_engine("bt_fused")
                             + layouts_for_engine("mega13"), device=device)


def random_cts(p, B, device):
    rng = np.random.default_rng(B)
    return from_numpy_u32(rng.integers(0, 1 << 32, (B, p.n + 1),
                                       dtype=np.uint32), device)


@pytest.fixture(scope="module")
def small_key():
    return random_key(dataclasses.replace(TEST_SMALL, **TOY_SET), "cpu")


def test_bt_fused_counts_the_operations_its_steps_issued(small_key,
                                                         monkeypatch):
    p = small_key.params
    issued = []
    for module, name in ((bs, "rotate_decompose"),
                         (bt, "external_product_bt")):
        def counted(*a, _orig=getattr(module, name), **kw):
            issued.append(1)
            return _orig(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    job = "fused-rotations"
    with tracing.job_scope(job):
        for B in (5, 3):
            bs.blind_rotate_batch(small_key, random_cts(p, B, "cpu"),
                                  bs.make_test_poly(p), engine="bt_fused")
    acct = tracing.job(job)
    # on the CPU each kernel's plain version stands for its one launch
    assert len(issued) == 2 * 2 * p.n
    assert acct["counts"][tracing.STEP_LAUNCHES] == len(issued)
    assert acct["calls"][tracing.STEP_ISSUE] == 2
    assert acct["counts"]["bootstrap.rotations"] == 2
    mine = [s for s in tracing.spans() if s[4] == job]
    issue = [s for s in mine if s[2] == tracing.STEP_ISSUE]
    rot = [s for s in mine if s[2] == "bootstrap.rotation" and s[3] == "cpu"]
    assert len(issue) == len(rot) == 2
    assert all(r[0] <= s[0] <= s[1] <= r[1] for s, r in zip(issue, rot))


def test_mega13_counts_no_step_launches(small_key):
    p = small_key.params
    job = "mega13-rotation"
    with tracing.job_scope(job):
        bs.blind_rotate_batch(small_key, random_cts(p, 4, "cpu"),
                              bs.make_test_poly(p), engine="mega13")
    acct = tracing.job(job)
    assert acct["counts"]["bootstrap.rotations"] == 1
    assert tracing.STEP_LAUNCHES not in acct["counts"]
    assert tracing.STEP_ISSUE not in acct["calls"]


def cell_set():
    """The cell's parameter set as the program's ``TFHEParams``."""
    numbers = json.loads((bench.HERE / "configs/herd_tfhe_lib_fused.json")
                         .read_text())["params"]
    return dataclasses.replace(TEST_SMALL, **numbers)


@pytest.mark.parametrize("B,ops", [(2048, 1), (288, 1), (9, 2), (1, 2)])
def test_a_k_split_product_adds_its_set(monkeypatch, B, ops):
    """At the cell's set on a card of 132 SMs: one kernel where the plan
    does not split K, the set and the kernel where it does."""
    p = cell_set()
    monkeypatch.setattr(bt, "_sms", lambda device: 132)
    card = torch.device("cuda", 0)
    assert (bt.plan(p, B, 132).splits > 1) == (ops == 2)
    assert bt.operations(p, B, card) == ops
    assert bt.operations(p, B, torch.device("cpu")) == 1
    assert bs.STEP_LAUNCHES["bt_fused"](p, B, card) == 1 + ops


def test_reader_needs_the_counter(monkeypatch):
    read = bench.reader(bench.Layout.default(), READER).read
    accounts = {"a": {"counts": {tracing.STEP_LAUNCHES: 300}},
                "b": {"counts": {tracing.STEP_LAUNCHES: 100}},
                "c": {"counts": {}},
                "failed": {"counts": {tracing.STEP_LAUNCHES: 1000}}}
    monkeypatch.setattr(tracing, "job", accounts.get)

    def jobs(*uuids):
        return {"jobs": [{"job_uuid": u, "rows": 4,
                          "completed": u != "failed"} for u in uuids]}
    assert read(jobs("a", "b", "failed", "unknown")) == 400 / 8
    assert read(jobs("a", "c")) == 300 / 8
    assert read(jobs("c")) is None
    assert read(jobs("failed")) is None
    assert read({"jobs": []}) is None
    monkeypatch.delattr(tracing, "job")
    assert read(jobs("a")) is None


@pytest.mark.cuda
def test_card_counts_equal_the_kernels_launches():
    """On the card, at the cell's set and at widths on both sides of the
    K split: the counter equals the two kernels' launch counters plus one
    set for each K-split product."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    card = torch.device("cuda", 0)
    p = cell_set()
    dsk = random_key(p, card)
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    for B in (2048, 9):
        job = f"card-{B}"
        before = rd.rotate_decompose.launches \
            + bt.external_product_bt.launches
        with tracing.job_scope(job):
            bs.blind_rotate_batch(dsk, random_cts(p, B, card),
                                  bs.make_test_poly(p, device=card),
                                  engine="bt_fused")
        torch.cuda.synchronize()
        kernels = rd.rotate_decompose.launches \
            + bt.external_product_bt.launches - before
        sets = p.n * (bt.kernel_plan(p, B, n_sms)[1] > 1)
        assert kernels == 2 * p.n
        assert tracing.job(job)["counts"][tracing.STEP_LAUNCHES] \
            == kernels + sets
        assert sets == (0 if B == 2048 else p.n)
