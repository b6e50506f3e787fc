"""Offload worker daemon: the ``hived`` analog (SURVEY.md §2.5: serves the
Worker::{map,reduce} contract; reference
src/execution/worker/grpc/grpc_worker_group.cpp:85-97 is the rpc pair this
replaces, dispatched here over the lambda-style HTTP channel), the port's
copy of ``herdsman_tpu.service.offload_worker``.

Serves POST /task with the JSON task wire form (``service/offload.py``
``task_to_wire``): loads the session's server key from the shared key
directory, reads the input partition file(s) from the shared storage
namespace, evaluates the circuit on the worker's device with the port's
engine, and writes the output partition file; the file's appearance
doubles as the fire-and-forget completion signal (reference
filesystem_watch.cpp).

GET /counts answers each hand-written kernel's launches in the worker's
process (``ops.kernels.launch_counts``), so a caller can see which kernels
its tasks ran.

The worker runs on the card.  Without one it refuses to start unless it is
given ``--device cpu``; a task whose kernel fails is answered with a 500,
which the coordinator retries and then fails the job, and the worker never
gives way to a plain version.  The default engine is ``bt`` (the
coordinator's default with no ``workers.mesh`` section), where the JAX
worker's is ``conv_i8``; outputs are array-equal across engines.

Run: python -m herdsman_tpu_torch.service.offload_worker \\
        --storage DIR --keys DIR --port P [--engine bt] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import logging
import os
import pathlib
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from herdsman_tpu_torch.circuit.model import Circuit
from herdsman_tpu_torch.compiler.lower import compile_circuit
from herdsman_tpu_torch.ops.kernels import launch_counts
from herdsman_tpu_torch.ops.server_key import (
    DeviceServerKey,
    device_server_key,
    fit_engine,
    layouts_for_engine,
)
from herdsman_tpu_torch.ops.u32 import (
    from_numpy_u32,
    resolve_device,
    to_numpy_u32,
)
from herdsman_tpu_torch.service import frames as frame_codec
from herdsman_tpu_torch.service.config import port_engine
from herdsman_tpu_torch.service.coordinator import deserialize_server_key
from herdsman_tpu_torch.utils import rowcodec

log = logging.getLogger("herdsman.offload_worker")


# device keys kept at once, least recently used out first: bsk_bt alone is
# 3.4 GiB at STD128_K2
MAX_SESSIONS = 4


@dataclasses.dataclass
class _Session:
    """A session's server key on the device, built from the key file whose
    identity is ``stamp``, and ``fns``: circuit JSON -> (the circuit
    compiled on that key, the circuit)."""

    stamp: tuple[int, int, int]
    dsk: DeviceServerKey
    engine: str
    fns: dict = dataclasses.field(default_factory=dict)


class _Engine:
    """Per-process caches: device server keys and compiled circuits."""

    def __init__(self, storage_dir: str, key_dir: str, engine: str,
                 device: torch.device):
        self.storage = pathlib.Path(storage_dir)
        self.keys = pathlib.Path(key_dir)
        self.engine = port_engine(engine)
        self.device = device
        self._sessions: collections.OrderedDict[tuple[str, int],
                                                _Session] = (
            collections.OrderedDict())
        self._lock = threading.Lock()

    def _key_path(self, session: str, schema: int) -> pathlib.Path:
        return self.keys / session / f"{schema}.key"

    def _session(self, session: str, schema: int) -> _Session:
        """The session's cache entry, built anew when its key file changed
        (a key replaced through the coordinator's remove_key and add_key).
        The file's (inode, size, mtime) is its identity: two writes share
        it only within one tick of the file system's clock, and a new key
        comes from a keygen and an upload.  Entries whose key file has gone
        are dropped, and at most ``MAX_SESSIONS`` are kept."""
        k = (session, schema)
        path = self._key_path(*k)
        with self._lock:
            for gone in [g for g in self._sessions
                         if not self._key_path(*g).exists()]:
                del self._sessions[gone]
            st = path.stat()  # no key: the task fails
            stamp = (st.st_ino, st.st_size, st.st_mtime_ns)
            entry = self._sessions.get(k)
            if entry is None or entry.stamp != stamp:
                # the old key's tensors go before the new key is built
                self._sessions.pop(k, None)
                entry = None
                # a compressed key (seeded upload) is expanded here, as the
                # coordinator expands it
                sk = deserialize_server_key(path.read_bytes())
                eng = fit_engine(self.engine, sk.params)
                entry = _Session(stamp, device_server_key(
                    sk, layouts=layouts_for_engine(eng), device=self.device),
                    eng)
                self._sessions[k] = entry
                while len(self._sessions) > MAX_SESSIONS:
                    self._sessions.popitem(last=False)
            self._sessions.move_to_end(k)
            return entry

    def _compiled(self, entry: _Session, circuit_json: str):
        with self._lock:
            cached = entry.fns.get(circuit_json)
        if cached is None:
            circuit = Circuit.from_json(circuit_json)
            cached = (compile_circuit(circuit, entry.dsk, engine=entry.engine,
                                      device=self.device), circuit)
            with self._lock:
                entry.fns[circuit_json] = cached
        return cached

    def _read_rows(self, session: str, ptr: dict, total_bits: int,
                   params) -> np.ndarray:
        path = (self.storage / session / ptr["uuid"]
                / str(ptr["partition"]))
        payloads = rowcodec.parse_rows(path.read_bytes())
        return frame_codec.payloads_to_rows(payloads, total_bits, params)

    def run_task(self, task: dict) -> None:
        session = task["session_uuid"]
        entry = self._session(session, task["key_schema"])
        fn, circuit = self._compiled(entry, task["circuit"])
        p = entry.dsk.params
        if task["type"] == "MAP":
            bits_in = circuit.num_input_bits
            rows = self._read_rows(session, task["inputs"][0], bits_in, p)
            out = to_numpy_u32(fn(rows))
        else:  # REDUCE: doubled input schema, pairwise fold to one row
            bits_in = circuit.num_input_bits // 2
            gathered = np.concatenate(
                [self._read_rows(session, ptr, bits_in, p)
                 for ptr in task["inputs"]], axis=0)
            rows = from_numpy_u32(gathered, self.device)
            # pairwise balanced fold, the JAX worker's
            # (herdsman_tpu/service/offload_worker.py:107-120)
            while rows.shape[0] > 1:
                m = rows.shape[0] // 2
                stacked = torch.cat([rows[0:2 * m:2], rows[1:2 * m:2]],
                                    dim=1)
                combined = fn(stacked)
                rows = (torch.cat([combined, rows[2 * m:]])
                        if rows.shape[0] % 2 else combined)
            out = to_numpy_u32(rows)
        out_dir = self.storage / session / task["output"]["uuid"]
        out_dir.mkdir(parents=True, exist_ok=True)
        # write-then-rename so the watcher never sees a partial file; the
        # tmp name is unique per process and task, so a retried task running
        # beside a hung original (two workers, one output) cannot interleave
        # writes into one tmp file: the last rename wins with a whole file
        final = out_dir / str(task["output"]["partition"])
        tmp = final.with_name(
            f"{final.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        try:
            tmp.write_bytes(
                rowcodec.frame_rows(frame_codec.rows_to_payloads(out)))
            tmp.replace(final)
        finally:
            # a failure between write and replace leaves no tmp file behind
            tmp.unlink(missing_ok=True)


def make_server(storage_dir: str, key_dir: str, port: int = 0,
                engine: str = "bt", fail_first: int = 0,
                file_only: bool = False,
                device: str | torch.device = "cuda") -> ThreadingHTTPServer:
    """The worker's HTTP server on 127.0.0.1:``port`` (0: any free port),
    not yet serving.  ``engine`` is a JAX package or port engine name
    (``service.config.port_engine``).  ``device`` is resolved here, on the
    calling thread, before any request is served (CUDA is initialised
    here, not on a request thread), and raises without a card unless it is
    ``"cpu"``."""
    eng = _Engine(storage_dir, key_dir, engine, resolve_device(device))
    state = {"failed": 0}
    state_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path != "/counts":
                self.send_error(404)
                return
            body = json.dumps(launch_counts()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path != "/task":
                self.send_error(404)
                return
            with state_lock:
                if state["failed"] < fail_first:
                    state["failed"] += 1
                    self.send_error(500, "injected failure")
                    return
            body = self.rfile.read(int(self.headers["Content-Length"]))
            try:
                eng.run_task(json.loads(body))
            except Exception as e:  # noqa: BLE001 — worker boundary
                log.exception("task failed")
                self.send_error(500, str(e))
                return
            if file_only:
                # fire-and-forget mode: the output file is the only signal
                self.send_error(500, "file-only mode")
                return
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, fmt, *args):  # quiet
            log.debug(fmt, *args)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--storage", required=True)
    ap.add_argument("--keys", required=True)
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--engine", default="bt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    srv = make_server(args.storage, args.keys, args.port, args.engine,
                      device=args.device)
    log.info("offload worker on port %d", srv.server_address[1])
    srv.serve_forever()


if __name__ == "__main__":
    main()
