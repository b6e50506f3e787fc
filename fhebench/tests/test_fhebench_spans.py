"""The readers of the program's spans (``metrics/service.queue_s.py``,
``compiler.rotation_gap_ms.py``, ``service.key_ingest_s.py``): their
arithmetic on a stubbed recorder, only the jobs of ``run["jobs"]``
counted, None where no listed job has the span or the program has no
recorder, and all three read from a toy cell's traced run on the CPU."""

import copy

import pytest

from fhebench import run as bench
from fhebench.tests import toy
from herdsman_tpu_torch.utils import tracing

READERS = ("service.queue_s", "compiler.rotation_gap_ms",
           "service.key_ingest_s")


def reader(name):
    return bench.reader(bench.Layout.default(), name)


def acct(session="s0", queue=None, rotations=(), between=None,
         ingest=None):
    return {"session": session,
            "phases": {} if queue is None else {"queue": queue},
            "rotations": list(rotations), "between_rotations_ms": between,
            "key_ingest_s": ingest}


def run_of(*uuids):
    return {"jobs": [{"job_uuid": u} for u in uuids]}


@pytest.fixture
def stub(monkeypatch):
    accounts = {}
    monkeypatch.setattr(tracing, "job", accounts.get)
    return accounts


def test_queue_wait_is_the_mean_over_the_window_jobs(stub):
    stub |= {"a": acct(queue=0.5), "b": acct(queue=1.5),
             "c": acct(), "warm-up": acct(queue=100.0)}
    assert reader("service.queue_s.small").read(run_of("a", "b", "c")) \
        == 1.0


def test_rotation_gap_is_per_gap_then_the_mean_over_jobs(stub):
    stub |= {"a": acct(rotations=[8, 8, 8], between=4.0),    # 2 ms a gap
             "b": acct(rotations=[4, 4], between=6.0),       # 6 ms
             "c": acct(rotations=[4], between=0.0),          # no gap
             "warm-up": acct(rotations=[2, 2], between=1e6)}
    assert reader("compiler.rotation_gap_ms.batch").read(
        run_of("a", "b", "c")) == 4.0


def test_key_ingest_is_the_mean_over_sessions(stub):
    stub |= {"a": acct("s0", ingest=1.0), "b": acct("s0", ingest=1.0),
             "c": acct("s1", ingest=3.0), "d": acct("s2"),
             "warm-up": acct("s9", ingest=50.0)}
    assert reader("service.key_ingest_s.small").read(
        run_of("a", "b", "c", "d")) == 2.0


@pytest.mark.parametrize("name", READERS)
def test_none_where_no_listed_job_has_the_span(stub, name):
    stub |= {"a": acct(), "warm-up": acct(queue=1.0, rotations=[2, 2],
                                          between=1.0, ingest=1.0)}
    r = reader(name)
    assert r.read(run_of("a", "unknown")) is None
    assert r.read({"jobs": []}) is None
    assert r.read(run_of("warm-up")) is not None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    monkeypatch.delattr(tracing, "job")
    assert reader(name).read(run_of("a")) is None


def test_a_toy_cells_traced_run_reads_all_three(tmp_path):
    """The toy small cell, its per-layer metrics joined by the three new
    ones in memory: each reads a number."""
    lay = toy.layout(tmp_path)
    b = copy.deepcopy(lay.bench)
    for name in READERS:
        b["per_layer"].append({"name": f"{name}.small", "unit": "x",
                               "better": "lower", "source": "program_span",
                               "layer": "coordinator",
                               "moves": "rows_per_s.small",
                               "workloads": ["herd_toy.small"]})
    res = toy.run(bench.Layout(b, lay.dirs), "herd_tfhe_lib.small",
                  trace=True)
    got = res["metrics"]
    assert all(got[f"{n}.small"]["value"] > 0 for n in READERS), got
