"""The port stands alone and runs on the card by default.

- ``herdsman_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  ``herdsman_tpu``, checked both in a fresh interpreter and in the source;
  nor, when imported, ``cryptography`` or ``yaml``, which the GPU machines
  do not have.
- The offload worker and the tracing hooks load none of them at run time
  either: a job dispatched to a worker and traced, in a fresh interpreter.
- The gRPC surface (server, client, worker fleet, mappers, the generated
  module) imports none of them, nor a top-level ``herdsman_pb2``, and
  touches no ``sys.path``; a job through ``HerdClient``, the server and a
  ``workers.grpc`` fleet, in a fresh interpreter with every port module
  imported, leaves no module of the JAX package's files in
  ``sys.modules``, and no top-level ``herdsman_pb2``.
- The port's copy of ``core/numtheory.py`` gives the original's primes,
  roots and powers.
- The upload's row splitter loads the port's own library, built from
  ``csrc/rowcodec.cpp`` into ``herdsman_tpu_torch/_build/``; no port source
  names the JAX package's native build.  The splitter, the build module and
  the cold-start probe import nothing of JAX, the JAX package, PyYAML or
  cryptography.
- Without a CUDA device, every entry point called with its default device
  raises instead of running on the CPU (the offload worker's module and the
  cold-start probe refuse to start), and ``chip_smoke.py`` fails without
  printing a result.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from herdsman_tpu_torch.circuit import CircuitBuilder, ColumnMeta, DataType
from herdsman_tpu_torch.compiler import lower
from herdsman_tpu_torch.core import TOY
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.ops import bootstrap as bs
from herdsman_tpu_torch.ops import gates
from herdsman_tpu_torch.ops.server_key import device_server_key
from herdsman_tpu_torch.service.config import (Config, SecurityConfig,
                                               ServerConfig)
from herdsman_tpu_torch.service.coordinator import Coordinator
from herdsman_tpu_torch.service.offload_worker import make_server
from herdsman_tpu_torch.utils import rowcodec, tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "herdsman_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "herdsman_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


@pytest.mark.parametrize("forbidden,must_have", [
    (FORBIDDEN, None),
    (("cryptography", "yaml"), "herdsman_tpu_torch.service.coordinator")],
    ids=["no_jax", "without_cryptography_or_yaml"])
def test_port_modules_import(forbidden, must_have):
    """Every module of the port, imported in a fresh interpreter, loads
    none of ``forbidden``: JAX and the JAX package, or PyYAML and
    cryptography, which the GPU machines do not have."""
    code = (
        "import importlib, pkgutil, sys, herdsman_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
        "assert len(names) >= 15, names\n"
        f"assert {must_have!r} is None or {must_have!r} in names, names\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "herdsman_tpu_torch.ops.pbs", "herdsman_tpu_torch.shortint",
    "herdsman_tpu_torch.radix", "herdsman_tpu_torch.api",
    "herdsman_tpu_torch.ops.kernels.mega12",
    "herdsman_tpu_torch.ops.kernels.megaT",
    "herdsman_tpu_torch.ops.kernels.megaJ",
    "herdsman_tpu_torch.core.numtheory", "herdsman_tpu_torch.ops.modmath",
    "herdsman_tpu_torch.ops.ntt", "herdsman_tpu_torch.ops.rns",
    "herdsman_tpu_torch.mesh", "herdsman_tpu_torch.mesh.sharding",
    "herdsman_tpu_torch.mesh.ntt_sharded",
    "herdsman_tpu_torch.mesh.distributed",
    "herdsman_tpu_torch.service.offload",
    "herdsman_tpu_torch.service.offload_worker",
    "herdsman_tpu_torch.utils.tracing", "herdsman_tpu_torch.utils.rowcodec",
    "herdsman_tpu_torch.utils.probe_coldstart",
    "herdsman_tpu_torch.ops.kernels._build"])
def test_module_imports_alone(module):
    """Each module of the integer tier and of the mesh, the offload worker
    group, the worker and the tracing hooks, the row splitter, the build
    module and the cold-start probe, imported alone, loads nothing of JAX,
    the JAX package, PyYAML or cryptography."""
    code = (
        f"import importlib, sys; importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('cryptography', 'yaml')!r})\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048, 4096])
def test_numtheory_copy_equals_the_original(N):
    """The port's copy of ``core/numtheory.py`` gives the original's primes,
    roots and powers, and its source is the original's but the
    docstring."""
    from herdsman_tpu.core import numtheory as jnt
    from herdsman_tpu_torch.core import numtheory as nt

    assert nt.MAX_DIGIT3 == jnt.MAX_DIGIT3
    primes = nt.ntt_primes(2 * N, 3, cap=nt.MAX_DIGIT3)
    assert primes == jnt.ntt_primes(2 * N, 3, cap=jnt.MAX_DIGIT3)
    assert nt.ntt_primes(2 * N, 2, bits=20) == jnt.ntt_primes(2 * N, 2,
                                                                bits=20)
    for p in primes:
        assert nt.is_prime(p) and jnt.is_prime(p)
        assert nt.primitive_root(p) == jnt.primitive_root(p)
        psi = nt.root_of_unity(p, 2 * N)
        assert psi == jnt.root_of_unity(p, 2 * N)
        np.testing.assert_array_equal(nt.powers_mod(psi, N, p),
                                      jnt.powers_mod(psi, N, p))
    assert [nt.is_prime(k) for k in range(200)] == \
        [jnt.is_prime(k) for k in range(200)]

    def body(mod):
        src = pathlib.Path(mod.__file__).read_text()
        return src[src.index('"""', 3) + 3:]
    assert body(nt) == body(jnt)


OFFLOAD_JOB = """
import shutil, sys, tempfile, threading
import numpy as np
from herdsman_tpu_torch.circuit import (DAG, CircuitBuilder, ColumnMeta,
    DataType, ExecutionPlan, InputStage, MapperStage, OutputStage, SchemaType)
from herdsman_tpu_torch.core import TOY, client
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.service import frames
from herdsman_tpu_torch.service.config import (Config, LambdaWorkersConfig,
    LoggingConfig, SecurityConfig, ServerConfig)
from herdsman_tpu_torch.service.coordinator import (Coordinator,
    serialize_server_key)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.service.offload_worker import make_server
from herdsman_tpu_torch.utils import rowcodec

d = tempfile.mkdtemp()
srv = make_server(d + "/st", d + "/keys", device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
coord = Coordinator(Config(
    server=ServerConfig(key_directory=d + "/keys",
                        storage_directory=d + "/st"),
    security=SecurityConfig(secret_key="x"),
    logging=LoggingConfig(profile_dir=d + "/traces"),
    lambda_workers=LambdaWorkersConfig(f"127.0.0.1:{srv.server_address[1]}")),
    device="cpu")
rng = np.random.default_rng(0)
ck, sk = ref.keygen(TOY, rng)
cols = (ColumnMeta("a", DataType.BIT), ColumnMeta("b", DataType.BIT))
tok = coord.authorize_connection("admin==true")
sess = coord.create_session(tok, "s").uuid
key = serialize_server_key(sk)
coord.add_key(tok, sess, SchemaType.TFHE_BOOL, len(key), [key])
meta = coord.begin_data_frame_upload(tok, sess, "in", SchemaType.TFHE_BOOL,
                                     cols, 2, 1)
cts = client.encrypt_rows(ck, cols, [(1, 1), (0, 1)], rng)
coord.append_data_frame(tok, sess, meta.uuid,
                        rowcodec.frame_rows(frames.rows_to_payloads(cts)))
coord.finish_data_frame_upload(tok, sess, meta.uuid)
cb = CircuitBuilder(cols)
cb.output("x", cb.input_bit("a") & cb.input_bit("b"))
g = DAG()
st = [g.emplace(InputStage(meta.uuid)), g.emplace(MapperStage(cb.build())),
      g.emplace(OutputStage("out"))]
g.add_edge(st[0], st[1])
g.add_edge(st[1], st[2])
job = coord.schedule_job(tok, sess, ExecutionPlan(SchemaType.TFHE_BOOL, g))
job = coord.wait_for_job(tok, sess, job.job_uuid, timeout=120)
coord.shutdown()
srv.shutdown()
shutil.rmtree(d)
assert job.status == JobStatus.COMPLETED and job.tasks_executed == 1, job
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
"""


def test_offload_and_tracing_run_without_jax():
    """A traced job dispatched to an offload worker (both on the CPU), in a
    fresh interpreter, loads nothing of JAX, the JAX package, PyYAML or
    cryptography at run time."""
    code = (f"FORBIDDEN = {FORBIDDEN + ('cryptography', 'yaml')!r}\n"
            + OFFLOAD_JOB)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


GRPC_JOB = """
import importlib, pathlib, pkgutil, shutil, sys, tempfile
import herdsman_tpu_torch as p
for n in [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]:
    importlib.import_module(n)
import numpy as np
from herdsman_tpu_torch.circuit import (DAG, CircuitBuilder, ColumnMeta,
    DataType, ExecutionPlan, InputStage, MapperStage, OutputStage, SchemaType)
from herdsman_tpu_torch.client import HerdClient
from herdsman_tpu_torch.core import TOY, client
from herdsman_tpu_torch.core import reference as ref
from herdsman_tpu_torch.service.api_server import build_server
from herdsman_tpu_torch.service.config import (Config, GrpcWorkersConfig,
    SecurityConfig, ServerConfig)
from herdsman_tpu_torch.service.coordinator import (Coordinator,
    serialize_server_key)
from herdsman_tpu_torch.service.execution import JobStatus
from herdsman_tpu_torch.service.grpc_worker import make_worker_server

d = tempfile.mkdtemp()
worker, wport = make_worker_server(d + "/st", d + "/keys", device="cpu")
worker.start()
coord = Coordinator(Config(
    server=ServerConfig(key_directory=d + "/keys",
                        storage_directory=d + "/st"),
    security=SecurityConfig(secret_key="x"),
    grpc_workers=GrpcWorkersConfig([f"127.0.0.1:{wport}"])), device="cpu")
server, port = build_server(coord)
server.start()
c = HerdClient(f"127.0.0.1:{port}")
c.authorize()
rng = np.random.default_rng(0)
ck, sk = ref.keygen(TOY, rng)
cols = (ColumnMeta("a", DataType.BIT), ColumnMeta("b", DataType.BIT))
sess = c.create_session("s").uuid
c.add_key(sess, SchemaType.TFHE_BOOL, serialize_server_key(sk))
meta = c.upload_data_frame(sess, "in", SchemaType.TFHE_BOOL, cols,
                           client.encrypt_rows(ck, cols, [(1, 1), (0, 1)],
                                               rng), partitions=1)
cb = CircuitBuilder(cols)
cb.output("x", cb.input_bit("a") & cb.input_bit("b"))
g = DAG()
st = [g.emplace(InputStage(meta.uuid)), g.emplace(MapperStage(cb.build())),
      g.emplace(OutputStage("out"))]
g.add_edge(st[0], st[1])
g.add_edge(st[1], st[2])
job = c.schedule_job(sess, ExecutionPlan(SchemaType.TFHE_BOOL, g))
job = c.wait_for_job(sess, job.uuid, timeout=120)
rows = c.download_data_frame(sess, job.output_frames[0], 1, TOY)
c.close()
server.stop(None)
coord.shutdown()
worker.stop(None)
shutil.rmtree(d)
assert job.status == int(JobStatus.COMPLETED), job
assert [r["x"] for r in client.decrypt_rows(
    ck, (ColumnMeta("x", DataType.BIT),), rows)] == [1, 0]
assert worker.task_counts["tasks"] == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
assert "herdsman_pb2" not in sys.modules
jax_files = sorted(
    n for n, m in list(sys.modules.items())
    if getattr(m, "__file__", None)
    and pathlib.Path(m.__file__).resolve().is_relative_to(ROOT / "herdsman_tpu"))
assert not jax_files, jax_files
"""


def test_grpc_path_runs_without_jax():
    """Every port module imported, then a job through ``HerdClient``, the
    port's gRPC server and a ``workers.grpc`` fleet (all on the CPU), in a
    fresh interpreter: nothing of JAX, the JAX package's files (its
    generated ``herdsman_pb2`` under any name), PyYAML or cryptography is
    loaded."""
    code = (f"FORBIDDEN = {FORBIDDEN + ('cryptography', 'yaml')!r}\n"
            f"ROOT = __import__('pathlib').Path({str(ROOT)!r})\n" + GRPC_JOB)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


GRPC_SOURCES = ["herdsman_tpu_torch/client/__init__.py",
                "herdsman_tpu_torch/client/herd_client.py",
                "herdsman_tpu_torch/service/_proto/__init__.py",
                "herdsman_tpu_torch/service/_proto/herdsman_pb2.py",
                "herdsman_tpu_torch/service/api_server.py",
                "herdsman_tpu_torch/service/grpc_worker.py",
                "herdsman_tpu_torch/service/mappers.py",
                "herdsman_tpu_torch/service/proto_build.py"]


@pytest.mark.parametrize("path", GRPC_SOURCES)
def test_grpc_sources_import_nothing_forbidden(path):
    """The gRPC surface's sources import no ``jax``, ``herdsman_tpu``,
    ``cryptography``, ``yaml`` or top-level ``herdsman_pb2``, and touch no
    ``sys.path``: the generated module is imported by its package path."""
    tree = ast.parse((ROOT / path).read_text())
    forbidden = FORBIDDEN + ("cryptography", "yaml", "herdsman_pb2")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            assert not (isinstance(node, ast.Attribute)
                        and node.attr == "path"
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "sys"), path
            continue
        assert not any(n.split(".")[0] in forbidden for n in names), \
            (path, names)


@pytest.mark.parametrize("path", sorted(
    str(f.relative_to(ROOT)) for f in
    [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    if "_build" not in f.relative_to(ROOT).parts))  # build outputs, not source
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_row_splitter_loads_the_ports_own_library():
    """``split_rows`` runs ``csrc/rowcodec.cpp`` as built into the port's
    ``_build/``, not the JAX package's ``native/build`` library."""
    path = pathlib.Path(rowcodec._lib()._name).resolve()
    assert path.parent == (PKG / "_build").resolve()
    assert path.name.startswith("librowcodec-") and path.suffix == ".so"


@pytest.mark.parametrize("path", sorted(
    str(f.relative_to(ROOT)) for f in
    [*PKG.rglob("*.py"), *PKG.rglob("*.cu"), *PKG.rglob("*.cuh"),
     *PKG.rglob("*.cpp"), ROOT / "chip_smoke.py"]
    if "_build" not in f.relative_to(ROOT).parts))
def test_source_names_no_jax_native_build(path):
    """No port source loads or names the JAX package's native library."""
    text = (ROOT / path).read_text()
    assert "native/build" not in text and "libherdsman_native" not in text


@pytest.fixture(scope="module")
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    rng = np.random.default_rng(0)
    ck, sk = ref.keygen(TOY, rng)
    return ck, sk, rng


def test_device_server_key_defaults_to_card(no_card):
    _, sk, _ = no_card
    with pytest.raises(RuntimeError, match="GPU"):
        device_server_key(sk)
    assert device_server_key(sk, device="cpu").device.type == "cpu"


def test_entry_points_default_to_card(no_card):
    ck, sk, rng = no_card
    dsk = device_server_key(sk, device="cpu")
    c = ref.encrypt_bool(ck, np.array([True, False]), rng)
    with pytest.raises(RuntimeError, match="GPU"):
        gates.gate_batch(dsk, gates.GateBatch(np.array([0, 1]), c, c))
    with pytest.raises(RuntimeError, match="GPU"):
        gates.mux_batch(dsk, c, c, c)
    with pytest.raises(RuntimeError, match="GPU"):
        bs.bootstrap_bool_batch(dsk, c)
    cb = CircuitBuilder((ColumnMeta("a", DataType.BIT),
                         ColumnMeta("b", DataType.BIT)))
    cb.output("x", cb.input_bit("a") & cb.input_bit("b"))
    with pytest.raises(RuntimeError, match="GPU"):
        lower.compile_circuit(cb.build(), dsk)
    # a key on one device is refused for another
    with pytest.raises(ValueError):
        gates.gate_batch(dsk, gates.GateBatch(np.array([0, 1]), c, c),
                         device="meta")
    # the offload worker and a trace (of a job on the card)
    with pytest.raises(RuntimeError, match="GPU"):
        make_server("storage", "keys")
    with pytest.raises(RuntimeError, match="GPU"):
        with tracing.trace("traces"):
            pass


def test_integer_tier_defaults_to_card(no_card):
    from herdsman_tpu_torch.api import HerdContext
    from herdsman_tpu_torch.core import PARAM_SETS
    from herdsman_tpu_torch.ops import pbs
    from herdsman_tpu_torch.shortint import ShortContext

    ck, sk, rng = no_card
    with pytest.raises(RuntimeError, match="GPU"):
        HerdContext(TOY, keys=(ck, sk))
    with pytest.raises(RuntimeError, match="GPU"):
        ShortContext(PARAM_SETS["test_pbs"])
    dsk = device_server_key(sk, device="cpu")
    c = ref.encrypt_bool(ck, np.array([True, False]), rng)
    with pytest.raises(RuntimeError, match="GPU"):
        pbs.pbs_batch(dsk, c, [0, 1], 1)
    with pytest.raises(RuntimeError, match="GPU"):
        pbs.pbs_many_batch(dsk, c, [[0, 1], [1, 0]], 1)


def test_ntt_and_rns_default_to_card(no_card):
    """``make_plan`` and ``make_rns`` with their default device raise
    without a card; a context on the CPU refuses a tensor on another
    device rather than moving it."""
    from herdsman_tpu_torch.ops import ntt, rns

    p = ntt.ntt_primes_for(64, 1)[0]
    with pytest.raises(RuntimeError, match="GPU"):
        ntt.make_plan(p, 64)
    with pytest.raises(RuntimeError, match="GPU"):
        rns.make_rns(64)
    ctx = rns.make_rns(64, device="cpu")
    x = torch.zeros(3, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        rns.polymul(ctx, x, x)
    with pytest.raises(ValueError):
        ntt.ntt_fwd(ctx.plans[0], x[0])


def test_coordinator_defaults_to_card(no_card, tmp_path):
    cfg = Config(server=ServerConfig(key_directory=str(tmp_path / "k"),
                                     storage_directory=str(tmp_path / "s")),
                 security=SecurityConfig(secret_key="x"))
    with pytest.raises(RuntimeError, match="GPU"):
        Coordinator(cfg)
    Coordinator(cfg, device="cpu").shutdown()


def test_grpc_entry_points_default_to_card(no_card, tmp_path, monkeypatch):
    """``make_worker_server()``, ``grpc_worker.main`` and ``api_server.main``
    with their default device raise without a card, before they serve."""
    from herdsman_tpu_torch.service import api_server, grpc_worker

    with pytest.raises(RuntimeError, match="GPU"):
        grpc_worker.make_worker_server(str(tmp_path / "st"),
                                       str(tmp_path / "k"))
    monkeypatch.setattr(sys, "argv", [
        "grpc_worker", "--storage", str(tmp_path / "st"), "--keys",
        str(tmp_path / "k"), "--port", "0"])
    with pytest.raises(RuntimeError, match="GPU"):
        grpc_worker.main()
    cfg = tmp_path / "herdsman.yaml"
    cfg.write_text(
        "server:\n  hostname: 127.0.0.1\n  port: 0\n"
        f"  key_directory: {tmp_path / 'k'}\n"
        f"  storage_directory: {tmp_path / 'st'}\n"
        "security:\n  secret_key: x\n")
    monkeypatch.setattr(sys, "argv", ["api_server", str(cfg)])
    with pytest.raises(RuntimeError, match="GPU"):
        api_server.main()


def test_offload_worker_module_refuses_to_start_without_card(no_card,
                                                          tmp_path):
    """``python -m herdsman_tpu_torch.service.offload_worker`` without
    ``--device cpu`` exits non-zero here, before it serves."""
    out = subprocess.run(
        [sys.executable, "-m", "herdsman_tpu_torch.service.offload_worker",
         "--storage", str(tmp_path / "st"), "--keys", str(tmp_path / "k"),
         "--port", "0"],
        cwd=ROOT, env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "GPU" in out.stderr and "offload worker on port" not in out.stderr


def test_chip_smoke_fails_without_card(no_card, tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_env(PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_probe_refuses_to_start_without_card(no_card, tmp_path):
    """``python -m herdsman_tpu_torch.utils.probe_coldstart`` without
    ``--device cpu`` exits non-zero here and prints no result."""
    from herdsman_tpu_torch.service.coordinator import serialize_server_key

    _, sk, _ = no_card
    key = tmp_path / "1.key"
    key.write_bytes(serialize_server_key(sk))
    out = subprocess.run(
        [sys.executable, "-m", "herdsman_tpu_torch.utils.probe_coldstart",
         "--key", str(key)],
        cwd=ROOT, env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "GPU" in out.stderr and "probe_coldstart" not in out.stdout
