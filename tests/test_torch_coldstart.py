"""The cold-start probe (``herdsman_tpu_torch.utils.probe_coldstart``) on the
CPU at TOY: its phases, in order, in its lines and in its closing JSON
object, each a time of its own (the parts of a call add up to the call);
and with ``--layouts-file`` the device key saved by one run and read back
by the next in place of ``device_server_key``, equal to the key built.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from herdsman_tpu_torch.core import TOY
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops.server_key import (device_server_key,
                                               layouts_for_engine)
from herdsman_tpu_torch.service.coordinator import serialize_server_key
from herdsman_tpu_torch.utils import probe_coldstart


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the port's other CPU test files pin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy_key(tmp_path_factory):
    _, sk = ref.keygen(TOY, np.random.default_rng(0))
    path = tmp_path_factory.mktemp("keys") / "1.key"
    path.write_bytes(serialize_server_key(sk))
    return path, sk


def run(capsys, *args):
    assert probe_coldstart.main([*args, "--device", "cpu",
                                 "--batch", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])["probe_coldstart"]


def phase_of(line: str) -> str:
    """The phase a printed line names: '[  1.2 s] name: 0.1 s (...)' or
    '    name: 0.1 s (...)'."""
    return re.match(r"(?:\[ *[0-9.]+ s\] | +)(.+?): [0-9.]+ s", line)[1]


@pytest.mark.parametrize("engine", ["mega13", "pallas_bt"])
def test_phases_in_order(capsys, toy_key, engine):
    lines, result = run(capsys, "--key", str(toy_key[0]), "--engine", engine)
    assert [phase_of(ln) for ln in lines[:-1]] == list(
        probe_coldstart.PHASES)
    secs = result["seconds"]
    assert list(secs) == list(probe_coldstart.PHASES)
    assert result["engine"] == engine.removeprefix("pallas_")
    assert result["device"] == "cpu" and result["batch"] == 2
    assert all(np.isfinite(v) and v >= 0 for v in secs.values())
    for call in ("first call", "second call"):
        parts = [v for k, v in secs.items() if k.startswith(f"{call}: ")]
        assert sum(parts) == pytest.approx(secs[call])
    # no CUDA here: no library is loaded and no CUDA time is printed
    assert secs["first call: _build.load"] == 0
    assert not any("CUDA events" in ln for ln in lines)


def test_layouts_file_round_trip(capsys, toy_key, tmp_path):
    key, sk = toy_key
    saved = tmp_path / "layouts.pt"
    lines, first = run(capsys, "--key", str(key), "--engine", "bt",
                       "--layouts-file", str(saved))
    assert "device_server_key" in first["seconds"] and saved.exists()
    assert any(ln.startswith("saved the device key's tensors") for ln in lines)
    lines, second = run(capsys, "--key", str(key), "--engine", "bt",
                        "--layouts-file", str(saved))
    phases = list(second["seconds"])
    assert phases == [name if name != "device_server_key"
                      else "device layouts from the file"
                      for name in probe_coldstart.PHASES]
    loaded = torch.load(saved, weights_only=True)
    built = device_server_key(sk, layouts=layouts_for_engine("bt"),
                              device="cpu")
    tensors = {f.name: getattr(built, f.name)
               for f in dataclasses.fields(built)
               if isinstance(getattr(built, f.name), torch.Tensor)}
    assert loaded.keys() == tensors.keys()
    for name, t in tensors.items():
        assert torch.equal(loaded[name], t) and loaded[name].stride() == \
            t.stride(), name
