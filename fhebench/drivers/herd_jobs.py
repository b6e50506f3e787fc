"""Traffic of coordinator jobs: clients that each upload a key and a frame
of rows in set-up, then run a plan on their frame in a closed loop.

The cell's ``traffic`` gives ``clients``, ``rows``, ``partitions`` and
``plan`` (a name of ``PLANS``).  Each client submits its next job once its
previous job's output frame has downloaded; all share the coordinator's
executor.  A job's latency runs from ``schedule_job`` to the output frame
downloaded.  Keys, rows and every ciphertext come from the seed, made by
the benchmark's reference on the card; the program gets the server key
and the encrypted rows as a client of the coordinator would upload them,
framed by the reference's wire form (``reference/wire.py``), which also
parses what the check downloads.  Set-up runs one job per client (the
warm-up).

The check, after the window: the output frames of ``check_jobs`` jobs
and the map stage's intermediate frames of ``check_intermediate`` of them,
drawn from the seed, decrypted by the reference and held to the plaintext
plan; a job that failed counts whether drawn or not.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import random
import shutil
import tempfile
import threading
import time

import numpy as np
import torch
from herdsman_tpu_torch import circuit
from herdsman_tpu_torch.core import reference as pref
from herdsman_tpu_torch.service import config as sconf
from herdsman_tpu_torch.service.coordinator import (Coordinator,
                                                    serialize_server_key)
from herdsman_tpu_torch.service.execution import JobStatus

from fhebench.params import parameter_sets
from fhebench.reference import plans, tfhe, wire


def _map_xor_parity(cols):
    """x = a XOR b, odd = parity(x)."""
    mb = circuit.CircuitBuilder(cols)
    x = mb.input_column("a") ^ mb.input_column("b")
    odd = x.bits[0]
    for bit in x.bits[1:]:
        odd = odd ^ bit
    mb.output("x", x)
    mb.output("odd", odd)
    return mb.build()


def _map_add8(cols):
    """sum = a + b (the 8-bit ripple adder)."""
    mb = circuit.CircuitBuilder(cols)
    mb.output("sum", mb.input_column("a") + mb.input_column("b"))
    return mb.build()


def _xor_reduce(mid_cols):
    """x = x1 XOR x2, odd = odd1 XOR odd2."""
    rb = circuit.CircuitBuilder(mid_cols + mid_cols)
    rb.output("x", rb.input_column_at(0) ^ rb.input_column_at(2))
    rb.output("odd", rb.input_column_at(1).bits[0]
              ^ rb.input_column_at(3).bits[0])
    return rb.build()


def _truth_xor_parity(a, b):
    m = plans.xor_parity(a, b)
    mid = plans.row_bits([m["x"], m["odd"]], [8, 1])
    out = plans.row_bits([plans.xor_reduce(m["x"])[None],
                          (m["odd"].sum() & 1)[None]], [8, 1])
    return mid, out


def _truth_add8(a, b):
    out = plans.row_bits([plans.add8(a, b)], [8])
    return out, out


# plan name -> (map circuit, mid columns, reduce circuit or None, truth of
# (intermediate bits, output bits))
PLANS = {
    "xor_parity_reduce": (_map_xor_parity, (("x", "UINT8"), ("odd", "BIT")),
                          _xor_reduce, _truth_xor_parity),
    "add8": (_map_add8, (("sum", "UINT8"),), None, _truth_add8),
}


@dataclasses.dataclass
class Client:
    session: str
    keys: tfhe.Keys
    a: torch.Tensor
    b: torch.Tensor
    plan_json: str


@dataclasses.dataclass
class Job:
    client: int
    job_uuid: str
    t_submit: float
    t_done: float
    completed: bool
    rows: int
    bootstraps: int
    phases: tuple | None
    out_parts: list


class PhaseLog(logging.Handler):
    """The job runner's load / compile+exec / store seconds of each job,
    and when it logged them (``time.time()``)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.phases: dict[str, tuple[float, float, float]] = {}
        self.logged: dict[str, float] = {}

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("job %s phases"):
            job_uuid, *split = record.args
            self.phases[job_uuid] = tuple(split)
            self.logged[job_uuid] = record.created


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: torch.device
    prog_params: object   # the program's parameter set
    coord: object
    token: str
    clients: list
    workdir: str
    phase_log: PhaseLog
    setup_phases: dict = dataclasses.field(default_factory=dict)
    jobs: list = dataclasses.field(default_factory=list)
    checked: list = dataclasses.field(default_factory=list)
    mids: dict = dataclasses.field(default_factory=dict)


def _chunks(data: bytes, size: int = 1 << 16):
    return (data[i:i + size] for i in range(0, len(data), size))


def setup(cell, seed: int, device: torch.device,
          override: dict | None = None) -> State:
    t = time.perf_counter()
    cfg, traffic = cell.config, cell.spec["traffic"]
    prog_p, params = parameter_sets(cfg, override)
    workdir = tempfile.mkdtemp(prefix="fhebench-")   # under TMPDIR
    conf = sconf.Config(
        server=sconf.ServerConfig(key_directory=workdir + "/keys",
                                  storage_directory=workdir + "/st"),
        security=sconf.SecurityConfig(secret_key="fhebench"),
        mesh_workers=sconf.MeshWorkersConfig(
            engine=cfg["engine"], concurrent_jobs=cfg["concurrent_jobs"]))
    phase_log = PhaseLog()
    runner_log = logging.getLogger("herdsman.runner")
    runner_log.setLevel(logging.DEBUG)
    runner_log.propagate = False
    runner_log.addHandler(phase_log)
    coord = Coordinator(conf, device=device)
    token = coord.authorize_connection("admin==true")
    state = State(cell, seed, device, prog_p, coord, token, [],
                  workdir, phase_log)
    map_fn, _, reduce_fn, _ = PLANS[traffic["plan"]]
    dt = circuit.DataType
    in_cols = (circuit.ColumnMeta("a", dt.UINT8),
               circuit.ColumnMeta("b", dt.UINT8))
    mid_cols = tuple(circuit.ColumnMeta(n, dt[t])
                     for n, t in PLANS[traffic["plan"]][1])
    rows = traffic["rows"]
    phases = state.setup_phases

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        phases[name] = phases.get(name, 0.0) + now - t
        t = now
    lap("coordinator")
    for c in range(traffic["clients"]):
        keys = tfhe.keygen(params, seed * 64 + c, device)
        sk = pref.ServerKey(prog_p, keys.bsk.cpu().numpy().astype(np.uint32),
                            keys.ksk.cpu().numpy().astype(np.uint32))
        key_bytes = serialize_server_key(sk)
        del sk
        sess = coord.create_session(token, f"client-{c}").uuid
        coord.add_key(token, sess, circuit.SchemaType.TFHE_BOOL,
                      len(key_bytes), _chunks(key_bytes))
        lap("keys")
        gen = tfhe.generator(seed * 64 + c, 2, device)
        a = torch.randint(0, 256, (rows,), generator=gen, device=device)
        b = torch.randint(0, 256, (rows,), generator=gen, device=device)
        cts = tfhe.encrypt(keys.lwe_key,
                           tfhe.encode_bool(plans.row_bits([a, b], [8, 8])),
                           params.lwe_std, gen)
        meta = coord.begin_data_frame_upload(
            token, sess, "rows", circuit.SchemaType.TFHE_BOOL, in_cols, rows,
            traffic["partitions"])
        per_chunk = max(1, (1 << 20) // (4 * cts[0].numel() + 4))
        for i in range(0, rows, per_chunk):
            coord.append_data_frame(token, sess, meta.uuid,
                                    wire.frame(cts[i:i + per_chunk]))
        coord.finish_data_frame_upload(token, sess, meta.uuid)
        del cts
        g = circuit.DAG()
        stages = [g.emplace(circuit.InputStage(meta.uuid)),
                  g.emplace(circuit.MapperStage(map_fn(in_cols)))]
        if reduce_fn is not None:
            stages.append(g.emplace(circuit.ReduceStage(
                reduce_fn(mid_cols), circuit.Policy.PARALLEL,
                per_node_count=2)))
        stages.append(g.emplace(circuit.OutputStage("result")))
        for x, y in zip(stages, stages[1:]):
            g.add_edge(x, y)
        plan = circuit.ExecutionPlan(circuit.SchemaType.TFHE_BOOL, g)
        state.clients.append(Client(sess, keys, a, b, plan.to_json()))
        lap("upload")
    for c in range(len(state.clients)):   # the warm-up: one job a client
        job = _run_job(state, c)
        if not job.completed:
            raise RuntimeError(f"the warm-up job of client {c} failed")
        _remove_frames(state, state.clients[c].session, job.job_uuid)
    lap("warm-up")
    state.phase_log.phases.clear()
    return state


def _run_job(state: State, c: int) -> Job:
    coord, tok = state.coord, state.token
    cl = state.clients[c]
    t0 = time.perf_counter()
    job = coord.schedule_job(tok, cl.session, cl.plan_json, 1)
    job = coord.wait_for_job(tok, cl.session, job.job_uuid, timeout=600)
    done = job.status == JobStatus.COMPLETED
    parts = []
    if done:
        (out_uuid,) = job.output_frames.values()
        parts = list(coord.download_data_frame(tok, cl.session, out_uuid))
    t1 = time.perf_counter()
    traffic = state.cell.spec["traffic"]
    if not traffic["check_intermediate"]:
        # nothing left to check on disk: the client removes the job's
        # frames, so the catalog stays the same size through the window
        _remove_frames(state, cl.session, job.job_uuid)
    return Job(c, job.job_uuid, t0, t1, done, traffic["rows"],
               job.bootstraps_executed, None, parts)


def _remove_frames(state: State, session: str, job_uuid: str) -> None:
    """Remove the frames a job wrote (its stages' frames carry its uuid in
    their names; the output frame is named by the plan)."""
    for f in state.coord.list_data_frames(state.token, session):
        if job_uuid in f.name or f.name == "result":
            state.coord.remove_data_frame(state.token, session, f.uuid)


def window(state: State, seconds: float) -> dict:
    """Each client's closed loop until ``seconds`` have passed; a job
    submitted before then runs to its end, and each client runs one at
    least."""
    deadline = time.perf_counter() + seconds
    jobs: list[Job] = []
    lock = threading.Lock()

    def client(c):
        while True:   # at least one job, however short the window
            job = _run_job(state, c)
            with lock:
                jobs.append(job)
            if time.perf_counter() >= deadline:
                return

    n = len(state.clients)
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        for f in [pool.submit(client, c) for c in range(n)]:
            f.result()
    for job in jobs:
        job.phases = state.phase_log.phases.get(job.job_uuid)
    state.jobs.extend(jobs)
    t0 = min(j.t_submit for j in jobs)
    t1 = max(j.t_done for j in jobs)
    return {"window_s": t1 - t0, "attempted": len(jobs),
            "failed": sum(not j.completed for j in jobs),
            "jobs": [dataclasses.asdict(j) | {"out_parts": None}
                     for j in jobs]}


def host_spans(state: State) -> list[tuple[float, float, str]]:
    """The runner's phases of every job logged so far, as host spans on
    ``time.time()``: the coordinator's executor thread, which the profiler
    does not see."""
    out = []
    for job, (load, exe, store) in state.phase_log.phases.items():
        end = state.phase_log.logged[job]
        t = [end - store - exe - load, end - store - exe, end - store, end]
        out += [(t[0], t[1], "coordinator runner: frame load"),
                (t[1], t[2], "coordinator runner: compile+exec"),
                (t[2], t[3], "coordinator runner: frame store")]
    return out


def release(state: State) -> None:
    """Download the intermediate frames to check, remove every frame,
    shut the coordinator down and free the card."""
    traffic = state.cell.spec["traffic"]
    draw = random.Random(state.seed)
    done = [j for j in state.jobs if j.completed]
    state.checked = draw.sample(done, min(traffic["check_jobs"], len(done)))
    coord, tok = state.coord, state.token
    for job in state.checked[:traffic["check_intermediate"]]:
        sess = state.clients[job.client].session
        (mid,) = [f.uuid for f in coord.list_data_frames(tok, sess)
                  if f.name.startswith(f"intermediate-{job.job_uuid}-")]
        state.mids[job.job_uuid] = list(coord.download_data_frame(tok, sess,
                                                                  mid))
    for job in state.jobs:
        _remove_frames(state, state.clients[job.client].session, job.job_uuid)
    coord.shutdown()
    state.coord = None


def _cts(state: State, parts: list, bits: int) -> torch.Tensor:
    """A downloaded frame's ciphertexts [rows, bits, n+1], parsed by the
    reference's wire form."""
    n = state.prog_params.n
    return torch.cat([wire.parse(part, bits, n) for part in parts]
                     or [torch.zeros((0, bits, n + 1), dtype=torch.int64)]
                     ).to(state.device)


def check(state: State) -> dict:
    """wrong bits (missing rows count all their bits), the largest phase
    error as a share of q/8, and the failed jobs, each with its limit."""
    limits = state.cell.spec["limits"]
    truth = PLANS[state.cell.spec["traffic"]["plan"]][3]
    wrong, worst = 0, 0.0
    failed = sum(not j.completed for j in state.jobs)
    for job in state.checked:
        cl = state.clients[job.client]
        want_mid, want_out = truth(cl.a, cl.b)
        pairs = [(job.out_parts, want_out)]
        if job.job_uuid in state.mids:
            pairs.append((state.mids[job.job_uuid], want_mid))
        for parts, want in pairs:
            try:
                got = _cts(state, parts, want.shape[-1])
            except ValueError:   # rows of another size: all bits wrong
                got = want[:0]
            if got.shape[0] != want.shape[0]:
                wrong += int(want.numel())
                continue
            w, e = tfhe.judge_bool(tfhe.phase(cl.keys.lwe_key, got), want)
            wrong, worst = wrong + w, max(worst, e)
    return {"jobs_failed": {"value": failed, "limit": limits["jobs_failed"]},
            "wrong_bits": {"value": wrong, "limit": limits["wrong_bits"]},
            "phase_err_max": {"value": worst,
                              "limit": limits["phase_err_max"]}}


def close(state: State) -> None:
    if state.coord is not None:
        state.coord.shutdown()
    logging.getLogger("herdsman.runner").removeHandler(state.phase_log)
    shutil.rmtree(state.workdir, ignore_errors=True)
