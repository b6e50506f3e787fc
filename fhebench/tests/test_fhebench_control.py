"""`correct` comes out false where the timed path is broken: the control
(the program with its gadget's digits cut, keys made for it by the
reference), each fault a cell can have, planted under the program's
entries, and a fault of the program's row codec made both ways, at toy
sizes on the CPU; and at the cells' own sizes on the card.

No cell spans cards, so none can lose an exchange between them.
"""

import contextlib
import dataclasses
import json

import pytest
import torch

from fhebench import run as bench
from fhebench.tests import control, toy
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.service import frames


@pytest.fixture(scope="module")
def lay(tmp_path_factory):
    return toy.layout(tmp_path_factory.mktemp("toy"))


@contextlib.contextmanager
def planted(module, name, fault):
    """``module.<name>`` replaced by ``fault(original)`` while entered."""
    orig = getattr(module, name)
    setattr(module, name, fault(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged(orig):
    """A rotation that returns its starting accumulator: no step taken."""
    def rotate(dsk, ct, test_poly, engine="mega13", coarse_bits=0):
        return bs.rotation_inputs(dsk.params, ct, test_poly, coarse_bits)[0]
    return rotate


def half_batch(orig):
    """A rotation of the batch's first half, its results given again for
    the second half."""
    def rotate(dsk, ct, *a, **kw):
        B = ct.shape[0]
        out = orig(dsk, ct[:(B + 1) // 2], *a, **kw)
        return torch.cat([out, out[:B // 2]])
    return rotate


def altered(orig):
    """A key switch whose first answer has q/2 added to its body."""
    def switch(dsk, ct):
        out = orig(dsk, ct).clone()
        out[0, -1] += -(1 << 31)
        return out
    return switch


def bits_reversed(orig):
    """A row codec that lays a row's bits out in reverse order (given both
    ways, the program's own codec reads back what it wrote)."""
    if orig is frames.row_to_bytes:
        return lambda row: orig(row[::-1])
    return lambda data, bits, params: orig(data, bits, params)[::-1].copy()


@pytest.mark.parametrize("cell", list(toy.CELLS))
def test_control_is_not_correct(lay, cell):
    assert toy.run(lay, cell)["correct"]
    res = toy.run(lay, cell, params=toy.CONTROL)
    assert not res["correct"]


@pytest.mark.parametrize("cell", list(toy.CELLS))
@pytest.mark.parametrize("name,fault", [
    ("blind_rotate_batch", unchanged), ("blind_rotate_batch", half_batch),
    ("key_switch_batch", altered)], ids=["unchanged", "half", "altered"])
def test_planted_fault_is_not_correct(lay, cell, name, fault):
    with planted(bs, name, fault):
        res = toy.run(lay, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(toy.CELLS))
def test_a_codec_fault_both_ways_is_not_correct(lay, cell):
    """The program's row codec reversing a row's bits where it writes and
    where it reads: the check parses downloads with the reference's wire
    form, so the fault shows."""
    with planted(frames, "row_to_bytes", bits_reversed), \
            planted(frames, "bytes_to_row", bits_reversed):
        row = frames.rows_to_payloads(
            torch.arange(6, dtype=torch.int32).reshape(1, 3, 2).numpy())[0]
        assert frames.bytes_to_row(row, 3, toy_params()).tolist() == [
            [0, 1], [2, 3], [4, 5]]
        res = toy.run(lay, cell)
    assert not res["correct"], res["checks"]


def toy_params():
    from herdsman_tpu_torch.core import PARAM_SETS
    return dataclasses.replace(PARAM_SETS[toy.HERD_SET["name"]], n=1)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    bench.BENCHMARK.read_text())["workloads"]])
def test_control_at_the_cells_size(cell, capsys):
    """On the card: a sound run of the cell is correct and its control is
    not (python -m fhebench.tests.control reads a dozen seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    control.main(["--workload", cell, "--seed", "12345", "--sound", "1",
                  "--control", "1", "--seconds", "0.001"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["correct"] for x in lines] == [True, False]
