"""The kernel cache of the port (``ops/kernels/_build.py``) without a card or
``nvcc``: a stub compiler stands in for ``nvcc``.  Two threads that build
one source together both return and compile it once; a ``_build/`` that is
group-writable or owned by another user is refused, and so is a library in
it that is; a change to ``NVCC_FLAGS`` changes the library's name.
"""

import os
import pathlib
import stat
import sys
import threading

import pytest

from herdsman_tpu_torch.ops.kernels import _build

# a stand-in for nvcc: waits a little (so that two builds overlap), writes
# the -o file and records one line per compile
STUB = """\
import pathlib, sys, time
time.sleep(0.3)
out = sys.argv[sys.argv.index("-o") + 1]
pathlib.Path(out).write_bytes(b"built")
with open(sys.argv[0] + ".log", "a") as log:
    log.write(out + "\\n")
"""


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A source directory with one source ``k.cu``, an empty build directory
    path, and a stub nvcc; returns the stub's log of compiles."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// a kernel\n")
    stub = tmp_path / "nvcc_stub.py"
    stub.write_text(STUB)
    wrapper = tmp_path / "nvcc"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {stub} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(wrapper))
    monkeypatch.setattr(_build, "_LOADED", {})
    return pathlib.Path(str(stub) + ".log")


def test_two_threads_build_one_source_once(cache, monkeypatch):
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or path)
    results, errors = [], []

    def worker(fn):
        try:
            results.append(fn("k") if fn is _build.load else fn(["k"]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(fn,))
               for fn in (_build.build, _build.build, _build.load,
                          _build.load)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(results) == 4
    assert len(cache.read_text().splitlines()) == 1  # one compile ran
    target = _build._target("k")
    assert target.read_bytes() == b"built"
    assert len(loaded) == 1 and loaded[0] == str(target)
    # no temporary file is left behind, and the library is the owner's only
    assert [p.name for p in _build.BUILD_DIR.iterdir()] == [target.name]
    assert not target.stat().st_mode & (stat.S_IWGRP | stat.S_IWOTH)
    assert _build.build(["k"]) == {}  # built: reused, not compiled again


def test_group_writable_build_dir_is_refused(cache):
    _build.BUILD_DIR.mkdir(mode=0o700)
    _build.BUILD_DIR.chmod(0o775)
    with pytest.raises(RuntimeError, match="writable by its group"):
        _build.build(["k"])
    with pytest.raises(RuntimeError, match="writable by its group"):
        _build.load("k")
    assert not cache.exists()  # nothing was compiled into it


def test_build_dir_of_another_user_is_refused(cache, monkeypatch):
    _build.BUILD_DIR.mkdir(mode=0o700)
    monkeypatch.setattr(_build.os, "getuid", lambda: os.stat(
        _build.BUILD_DIR).st_uid + 1)
    with pytest.raises(RuntimeError, match="owned by uid"):
        _build.build(["k"])


def test_writable_library_is_refused(cache, monkeypatch):
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    _build.build(["k"])
    _build._target("k").chmod(0o666)
    with pytest.raises(RuntimeError, match="writable by its group"):
        _build.load("k")


def test_flags_change_the_library_name(cache, monkeypatch):
    before = _build._target("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-G"])
    after = _build._target("k")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("libk-")
    (_build.SRC_DIR / "k.cu").write_text("// another kernel\n")
    assert _build._target("k") not in (before, after)


def test_header_change_renames_and_rebuilds(cache):
    """A source's library carries a hash of the headers ``csrc/*.cuh`` (the
    sources include them): editing one is a new library, built anew, and
    ``sources`` names no header."""
    (_build.SRC_DIR / "common.cuh").write_text("// shared device code\n")
    before = _build._target("k")
    _build.build(["k"])
    assert _build.sources() == ["k"]
    (_build.SRC_DIR / "common.cuh").write_text("// edited device code\n")
    after = _build._target("k")
    assert after != before and not after.exists()
    assert list(_build.build(["k"])) == ["k"]
    assert after.exists() and len(cache.read_text().splitlines()) == 2
