"""YAML config system — parity with the reference's schema and defaults
(reference include/utils/config.hpp:13-66, src/utils/config.cpp:237-300,
template.yaml):

    server:   {hostname, port (5000), key_directory, storage_directory}
    security: {secret_key, token_lifetime (43200 s)}
    logging:  {level (info)}
    workers:  one of
        grpc:   {addresses: [host:port, ...]}      # legacy shape, accepted
        lambda: {address, concurrency_limit (1)}   # legacy shape, accepted
        mesh:   {batch_axis, limb_axis, engine, max_batch}  # the TPU herd

The reference's env-var overrides for lambda workers
(src/utils/config.cpp:174-215: LAMBDA_WORKER_HOSTNAME/PORT,
LAMBDA_CONCURRENCY_LIMIT, WORKER_TYPE) are honored for the legacy shapes;
HERDSMAN_ENGINE overrides the mesh engine.

The port's copy of ``herdsman_tpu.service.config``.  Two differences:

- ``yaml`` is imported inside ``load_config`` only, so the ``Config``
  dataclasses (which code can build without a file) need no PyYAML: the
  GPU machines the port runs on do not have it.
- Engine names in a config stay the JAX package's.  ``ENGINE_NAMES`` maps
  the ones the port has to its own engines (``template.yaml`` loads as it
  is); ``port_engine`` raises at load for any other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


class ConfigError(ValueError):
    pass


# the JAX package's engine names -> the port's engines
ENGINE_NAMES = {"pallas_bt": "bt", "pallas_fused": "bt_fused",
                "pallas_mega13": "mega13", "pallas_mega12": "mega12",
                "pallas_mega16": "mega16", "pallas_mega17": "mega17",
                "pallas_mega15": "mega15", "pallas_mega11": "mega11",
                "pallas_mega8": "mega8", "pallas_mega7": "mega7",
                "pallas_mega14": "mega14", "pallas_mega9": "mega9",
                "pallas_mega6": "mega6", "pallas_mega10": "mega10",
                "pallas_mega3": "mega3", "pallas_mega4": "mega4",
                "pallas_mega5": "mega5", "pallas_mega": "mega",
                "pallas_mega2": "mega2", "gather_u32": "gather_u32",
                "conv_i8": "conv_i8"}


def port_engine(name: str) -> str:
    """The port's engine for a config's (JAX package) engine name.  A port
    engine name passes through; any other name raises."""
    if name in ENGINE_NAMES:
        return ENGINE_NAMES[name]
    if name in ENGINE_NAMES.values():
        return name
    raise ConfigError(
        f"engine {name!r} is not ported: the port has "
        f"{sorted(ENGINE_NAMES)}")


@dataclasses.dataclass
class ServerConfig:
    hostname: str = "0.0.0.0"
    port: int = 5000                      # reference src/utils/config.cpp:53
    key_directory: str = "./keys"
    storage_directory: str = "./storage"
    # frame-catalog persistence: "json" (atomic sidecar, default) or
    # "sqlite" (WAL database — crash-safe transactional saves; single
    # coordinator process either way).  The reference finds SQLite3 in
    # CMake but never links
    # it into logic (reference CMakeLists.txt:76,215) — evidently its
    # planned-but-unbuilt persistence layer; both backends here exceed
    # the reference's purely in-memory catalog (SURVEY.md §5).
    catalog_backend: str = "json"


@dataclasses.dataclass
class SslConfig:
    """server-side TLS (reference security.ssl, src/main.cpp:29-57)."""

    certificate_path: str = ""
    key_path: str = ""
    root_certificates_path: str = ""      # optional client-auth CA


@dataclasses.dataclass
class SecurityConfig:
    secret_key: str = ""
    token_lifetime: int = 43200           # reference src/utils/config.cpp:66
    ssl: Optional[SslConfig] = None


@dataclasses.dataclass
class LoggingConfig:
    level: str = "info"
    # when set, every job writes a jax.profiler trace (XLA/TPU timeline,
    # TensorBoard/Perfetto-viewable) under <profile_dir>/<job_uuid>/
    profile_dir: str = ""


@dataclasses.dataclass
class GrpcWorkersConfig:
    addresses: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LambdaWorkersConfig:
    address: str = ""
    concurrency_limit: int = 1            # reference src/utils/config.cpp:118


@dataclasses.dataclass
class MeshWorkersConfig:
    """The TPU worker herd: a device mesh instead of a gRPC fleet."""

    batch_axis: int = 1                   # data-parallel axis size
    limb_axis: int = 1                    # tensor-parallel axis size
    engine: str = "pallas_bt"             # a JAX name; see ENGINE_NAMES
    max_batch: int = 512
    param_set: str = "std128"
    concurrent_jobs: int = 1              # executor slots (the reference's
    # concurrent_workers() = fleet size, executor.cpp:96-113)
    # GLWE-domain intermediate frames: mapper/reduce outputs stored as
    # packed GLWEs when the session holds a TFHE_PACKING key
    glwe_frames: bool = False
    # also store OUTPUT-stage frames packed (noise-equivalent to a packed
    # download; frame bytes shrink (n+1)/((k+1)/N-per-bit) ~ 192x at
    # STD128_K2, which takes the device->host hop off the job's critical
    # path).  Clients must then use download_data_frame_packed — the row
    # download refuses packed frames with a pointer to it.
    glwe_outputs: bool = False
    # and pack INPUT frames at upload-finish (needs the session's
    # TFHE_PACKING key at ingest time; falls back to rows without it):
    # with all three set, frames live in the GLWE domain END-TO-END —
    # disk, device<->host, and wire
    glwe_inputs: bool = False


@dataclasses.dataclass
class Config:
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    security: SecurityConfig = dataclasses.field(default_factory=SecurityConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    grpc_workers: Optional[GrpcWorkersConfig] = None
    lambda_workers: Optional[LambdaWorkersConfig] = None
    mesh_workers: Optional[MeshWorkersConfig] = None


def _require(d: dict, key: str, ctx: str):
    if key not in d:
        raise ConfigError(f"missing required config node {ctx}.{key}")
    return d[key]


def load_config(path: str) -> Config:
    import yaml  # only here: the GPU machines have no PyYAML

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    cfg = Config()
    server = _require(raw, "server", "")
    cfg.server = ServerConfig(
        hostname=_require(server, "hostname", "server"),
        port=int(server.get("port", 5000)),
        key_directory=_require(server, "key_directory", "server"),
        storage_directory=_require(server, "storage_directory", "server"),
        catalog_backend=server.get("catalog_backend", "json"),
    )
    security = _require(raw, "security", "")
    ssl_node = security.get("ssl")
    ssl_cfg = None
    if ssl_node:
        ssl_cfg = SslConfig(
            certificate_path=_require(ssl_node, "certificate", "security.ssl"),
            key_path=_require(ssl_node, "key", "security.ssl"),
            root_certificates_path=ssl_node.get("root_certificates", ""),
        )
    cfg.security = SecurityConfig(
        secret_key=_require(security, "secret_key", "security"),
        token_lifetime=int(security.get("token_lifetime", 43200)),
        ssl=ssl_cfg,
    )
    logging_node = raw.get("logging", {})
    level = str(logging_node.get("level", "info")).lower()
    if level not in ("debug", "info", "warning", "error"):
        raise ConfigError(f"unknown logging level {level!r}")
    cfg.logging = LoggingConfig(
        level=level,
        profile_dir=str(logging_node.get("profile_dir", "")),
    )

    workers = raw.get("workers", {})
    worker_type = os.environ.get("WORKER_TYPE", "").lower()
    if "grpc" in workers and worker_type in ("", "grpc"):
        cfg.grpc_workers = GrpcWorkersConfig(
            addresses=list(_require(workers["grpc"], "addresses", "workers.grpc"))
        )
    if "lambda" in workers or worker_type == "lambda":
        lam = workers.get("lambda", {})
        address = os.environ.get("LAMBDA_WORKER_HOSTNAME", lam.get("address", ""))
        port = os.environ.get("LAMBDA_WORKER_PORT")
        if port:
            address = f"{address}:{port}"
        cfg.lambda_workers = LambdaWorkersConfig(
            address=address,
            concurrency_limit=int(
                os.environ.get(
                    "LAMBDA_CONCURRENCY_LIMIT", lam.get("concurrency_limit", 1)
                )
            ),
        )
    mesh = workers.get("mesh", {})
    cfg.mesh_workers = MeshWorkersConfig(
        batch_axis=int(mesh.get("batch_axis", 1)),
        limb_axis=int(mesh.get("limb_axis", 1)),
        engine=port_engine(os.environ.get("HERDSMAN_ENGINE",
                                          mesh.get("engine", "pallas_bt"))),
        max_batch=int(mesh.get("max_batch", 512)),
        param_set=str(mesh.get("param_set", "std128")),
        concurrent_jobs=int(mesh.get("concurrent_jobs", 1)),
        glwe_frames=bool(mesh.get("glwe_frames", False)),
        glwe_outputs=bool(mesh.get("glwe_outputs", False)),
        glwe_inputs=bool(mesh.get("glwe_inputs", False)),
    )
    if cfg.grpc_workers and cfg.lambda_workers:
        raise ConfigError("workers.grpc and workers.lambda are exclusive")
    return cfg
