"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Libraries go to ``herdsman_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source, of every header
``csrc/*.cuh`` (which the sources include) and of ``NVCC_FLAGS``, so an
edited source or header or a changed flag is rebuilt and a built one is
reused.
Nothing is built at import time: ``load`` builds what it needs (a kernel's
wrapper loads its library once), and ``build`` compiles several sources at
once, one ``nvcc`` process each.

One module lock serialises ``build`` and ``load``, so threads that launch a
kernel for the first time together (the plan compiler's stage pool, the
executor's concurrent job slots) compile it once; each compile writes to a
temporary file of its own in ``_build/`` and renames it into place.  A
``_build/`` owned by another user, or writable by its group or by others,
is refused, and so is a library in it that is: ``load`` runs the code it
finds there.
"""

from __future__ import annotations

import ctypes
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

_LOCK = threading.RLock()
_LOADED: dict[pathlib.Path, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(f.stem for f in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
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
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return report


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    with _LOCK:
        build([name])
        target = _target(name)
        if target not in _LOADED:
            _check_trusted(target)
            _LOADED[target] = ctypes.CDLL(str(target))
        return _LOADED[target]
