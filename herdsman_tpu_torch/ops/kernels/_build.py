"""Build and load the port's compiled code: its CUDA kernels and its host
code.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``;
each ``csrc/<name>.cpp`` is host code (the upload's row splitter,
``utils/rowcodec.py``), compiled the same way by the host compiler ``c++``
with ``HOST_FLAGS``, its warnings errors.
Libraries go to ``herdsman_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source, of every header
``csrc/*.cuh`` (which the ``.cu`` sources include), of the flags and of the
compiler's identity (its ``--version`` release line, read once a process),
so an edited source or header, a changed flag or another compiler is
rebuilt and a built one is reused.
Nothing is built at import time: ``load`` builds what it needs (a kernel's
wrapper loads its library once), and ``build`` compiles several sources at
once, one compiler process each.

This is the port's counterpart of the JAX package's ``ops/aot.py``: the
libraries here are the only artefacts the port compiles, and this cache
keeps them across processes.  The port compiles nothing at run time
(no XLA program, no JIT), so it has no executable cache of its own; what a
fresh process pays before its first result is measured by
``utils/probe_coldstart.py``.

One module lock serialises ``build`` and ``load``, so threads that launch a
kernel for the first time together (the plan compiler's stage pool, the
executor's concurrent job slots) compile it once; each compile writes to a
temporary file of its own in ``_build/`` and renames it into place, so
processes that build one source at once each install a whole library.  A
``_build/`` owned by another user, or writable by its group or by others,
is refused, and so is a library in it that is: ``load`` runs the code it
finds there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import stat
import subprocess
import tempfile
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the JAX package's native build (native/CMakeLists.txt): C++20, -O3 and
# its warning set, warnings as errors
HOST_FLAGS = ["-O3", "-std=c++20", "-shared", "-fPIC", "-Wall", "-Wextra",
              "-Wpedantic", "-Wshadow", "-Wconversion", "-Wsign-conversion",
              "-Wcast-align", "-Wunused", "-Wnull-dereference",
              "-Wdouble-promotion", "-Wformat=2", "-Wimplicit-fallthrough",
              "-Werror"]

_LOCK = threading.RLock()
_LOADED: dict[pathlib.Path, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every source under ``csrc/``: the kernels (``.cu``) and the
    host code (``.cpp``)."""
    return sorted(f.stem for pattern in ("*.cu", "*.cpp")
                  for f in SRC_DIR.glob(pattern))


def _source(name: str) -> pathlib.Path:
    cu = SRC_DIR / f"{name}.cu"
    return cu if cu.exists() else SRC_DIR / f"{name}.cpp"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _cxx() -> str:
    found = shutil.which("c++")
    if found:
        return found
    raise RuntimeError("c++ not found: a host C++ compiler is needed to build "
                       "the port's host code")


def _compiler(name: str) -> tuple[str, list[str]]:
    """The compiler and flags that build source ``name``."""
    if _source(name).suffix == ".cu":
        return _nvcc(), NVCC_FLAGS
    return _cxx(), HOST_FLAGS


@functools.cache
def _identity(compiler: str) -> str:
    """The compiler's release line (``nvcc``'s "release ..." line, the first
    line of ``c++ --version``), read once a process."""
    out = subprocess.run([compiler, "--version"], capture_output=True,
                         text=True, timeout=60)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode or not lines:
        raise RuntimeError(f"{compiler} --version failed: {out.stderr}")
    return next((ln for ln in lines if "release" in ln), lines[0])


def _target(name: str) -> pathlib.Path:
    source = _source(name)
    compiler, flags = _compiler(name)
    h = hashlib.sha256(source.read_bytes())
    if source.suffix == ".cu":
        for header in sorted(SRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join([*flags, _identity(compiler)]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _check_trusted(path: pathlib.Path) -> None:
    """Raise unless ``path`` is owned by this process's user and writable by
    no one else."""
    st = path.stat()
    if st.st_uid != os.getuid():
        raise RuntimeError(f"refusing {path}: it is owned by uid {st.st_uid}, "
                           f"not by this process's uid {os.getuid()}")
    if st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        raise RuntimeError(f"refusing {path}: it is writable by its group or "
                           f"by others (mode {stat.filemode(st.st_mode)}), so "
                           f"another user could replace the kernels it holds")


def _build_dir() -> pathlib.Path:
    """``BUILD_DIR``, made (mode 0700) if it is missing, once trusted."""
    BUILD_DIR.mkdir(mode=0o700, exist_ok=True)
    _check_trusted(BUILD_DIR)
    return BUILD_DIR


def build(names: list[str] | None = None) -> dict[str, tuple[float, str]]:
    """Compile the named sources (all by default) that are not built yet,
    all at once.  Returns name -> (seconds, compiler output) for each source
    compiled; raises if any compile fails."""
    names = sources() if names is None else names
    with _LOCK:
        build_dir = _build_dir()
        procs = {}
        for name in names:
            target = _target(name)
            if target.exists():
                continue
            fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".tmp",
                                       dir=build_dir)
            os.close(fd)
            compiler, flags = _compiler(name)
            cmd = [compiler, *flags, "-o", tmp, str(_source(name))]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           pathlib.Path(tmp), target, time.perf_counter())
        report, failed = {}, []
        for name, (proc, tmp, target, t0) in procs.items():
            log, _ = proc.communicate()
            report[name] = (time.perf_counter() - t0, log)
            if proc.returncode:
                failed.append(f"{name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                tmp.chmod(0o755)
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("build failed for " + "\n".join(failed))
        return report


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (or ``.cpp``), building it on
    first use."""
    with _LOCK:
        build([name])
        target = _target(name)
        if target not in _LOADED:
            _check_trusted(target)
            _LOADED[target] = ctypes.CDLL(str(target))
        return _LOADED[target]
