"""Spans, counters and per-job traces of the port.

SURVEY.md §5 marks tracing and profiling absent in the reference's
coordinator; the only instrument there is leveled logging.  Here one
process-wide recorder, always on, takes:

- ``span(name, job=None, device=None, **attrs)``: a context manager that
  stamps the block's host time with ``time.perf_counter_ns()``.  With a
  ``device``, the span also records a pair of CUDA events on that device's
  current stream around the block (on a CPU device its host time stands
  for the device time).  ``settle(device)``, which the job runner calls
  after its own ``torch.cuda.synchronize``, records one reference event
  there, on the idle stream, and waits for it; the finished spans' events
  are read against it when the recorder is next read, off the job's path,
  which places them on the unix clock.  Where ``torch.profiler`` is
  active on the calling thread, the profiler records the span too, by
  name, beside the kernels.  ``begin(...)`` opens a span that another
  thread ends (``Span.end()``).
- ``count(name, n=1, job=None)``: adds to a counter.  The program counts
  ``bootstrap.rotations`` (every blind rotation), ``MEGAS_TURNS``
  (``bootstrap.megaS_turns``: the warpgroup turns on the tensor cores of
  each ``csrc/megaS.cu`` launch, from ``ops/kernels/megaS.py::turns``)
  and ``STEP_LAUNCHES`` (``bootstrap.step_launches``: the device
  operations a per-step engine's rotation issued one at a time, beside
  its loop's host span ``STEP_ISSUE``, ``bootstrap.step_issue``), among
  others.
- ``job_scope(uuid)``: spans and counts in the block, and in threads
  started with a copy of its context, belong to job ``uuid`` unless they
  name another.

Host times convert to unix-epoch seconds through one anchor pair
(``perf_counter_ns``, ``time_ns``), the time base of ``torch.profiler``'s
Chrome trace.  The recorder reads:

- ``job(uuid)``: the job's account: host seconds and calls of each span
  name, its phases (``queue``, ``load``, ``exec``, ``store``), its
  counters, its session and that session's key-ingest seconds, the width
  of each blind rotation, the device ms of rotations and key switches, and
  the device ms between its first rotation's start and its last one's end
  not spent in rotations.
- ``spans(since)``: raw spans (start, end, name, thread, job) on the unix
  clock; a device span appears twice, under its host thread and under its
  device.
- ``counters()``.

Memory is bounded: a ring of ``RING`` raw spans, accounts of the last
``JOBS`` jobs and sessions, and as many device spans awaiting ``settle``,
and as many settled ones awaiting a read, as the ring holds.  Whatever is
pushed out counts in ``tracing.dropped``.

``trace(dir, device)`` is the deep-dive capture: ``torch.profiler`` over a
whole job, wired to the ``logging.profile_dir`` config key (every job
writes a trace under ``<profile_dir>/<job_uuid>/``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import pathlib
import threading
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity

from herdsman_tpu_torch.ops.u32 import resolve_device

RING = 65536   # raw spans kept
JOBS = 4096    # job and session accounts kept
DROPPED = "tracing.dropped"

# the summary's phases: span name -> phase
PHASES = {"execution.queue": "queue", "runner.load": "load",
          "runner.exec": "exec", "runner.store": "store"}
ROTATION = "bootstrap.rotation"
KEY_SWITCH = "bootstrap.key_switch"
KEY_INGEST = ("coordinator.add_key", "coordinator.device_key")
# counter: the turns of csrc/megaS.cu's consumer warpgroups on the tensor
# cores, each a warpgroup's group of wgmma on one K block
# (ops/kernels/megaS.py::turns), beside bootstrap.rotations
MEGAS_TURNS = "bootstrap.megaS_turns"
# host span: a per-step engine's Python loop over the n CMux steps of one
# rotation (ops/bootstrap.STEP_ENGINES), attributes B and steps
STEP_ISSUE = "bootstrap.step_issue"
# counter: the device operations that loop issued one at a time (kernels,
# and the set before a K-split product; a graph's replay would be one)
STEP_LAUNCHES = "bootstrap.step_launches"

_job: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "herdsman_job", default=None)


class _Account:
    """What one job recorded."""

    __slots__ = ("session", "seconds", "calls", "counts", "widths",
                 "rotation_ms", "key_switch_ms", "first_ns", "last_ns")

    def __init__(self):
        self.session = None
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self.widths: list[int] = []
        self.rotation_ms = 0.0
        self.key_switch_ms = 0.0
        self.first_ns: Optional[int] = None   # first rotation's start
        self.last_ns: Optional[int] = None    # last rotation's end


class Span:
    """One timed block; a context manager, or ``Recorder.begin`` and
    ``end()`` across threads.  ``seconds`` is its host time once ended."""

    __slots__ = ("_rec", "name", "job", "attrs", "device", "thread", "t0",
                 "t1", "_ev", "_rf")

    def __init__(self, rec: "Recorder", name: str, job, device, attrs):
        self._rec = rec
        self.name = name
        self.job = job if job is not None else _job.get()
        self.device = device
        self.attrs = attrs
        self.thread = None
        self.t0 = self.t1 = 0
        self._ev = None
        self._rf = None

    def start(self, profiled: bool = True) -> "Span":
        self.thread = threading.current_thread().name
        # a profiler region where this thread's profiler is on, and only
        # for a span that ends on the thread that started it
        if profiled and torch._C._autograd._profiler_enabled():
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self._ev = self._rec._events(self.device)
            self._ev[0].record(self._ev[2])
        self.t0 = time.perf_counter_ns()
        return self

    def end(self) -> None:
        if self._ev is not None:
            self._ev[1].record(self._ev[2])
        self.t1 = time.perf_counter_ns()   # after the end event's record
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._rec._close(self)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.end()


class Recorder:
    """Spans and counters of one process, bounded (see the module)."""

    def __init__(self, ring: int = RING, jobs: int = JOBS):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._pending: list[Span] = []   # device spans before settle
        # settled device spans awaiting a read: (reference event, its host
        # ns, spans), and how many spans they hold
        self._settled: collections.deque = collections.deque()
        self._waiting = 0
        self._jobs: collections.OrderedDict[str, _Account] = \
            collections.OrderedDict()
        self._sessions: collections.OrderedDict[str, dict[str, float]] = \
            collections.OrderedDict()
        self._max_jobs = jobs
        self._counts: collections.Counter = collections.Counter()
        # read CUDA event pairs for reuse, by device; streams by raw handle
        self._free: dict[torch.device, list] = {}
        self._streams: dict[tuple, torch.cuda.Stream] = {}
        # the one anchor pair: perf_counter_ns -> unix-epoch ns
        self._offset = time.time_ns() - time.perf_counter_ns()

    # ---- recording ----

    def span(self, name: str, job: Optional[str] = None,
             device: Optional[torch.device] = None, **attrs) -> Span:
        return Span(self, name, job, device, attrs)

    def begin(self, name: str, job: Optional[str] = None, **attrs) -> Span:
        """A host span started now and ended by ``end()``, on any thread."""
        return Span(self, name, job, None, attrs).start(profiled=False)

    def count(self, name: str, n: int = 1, job: Optional[str] = None) -> None:
        job = job if job is not None else _job.get()
        with self._lock:
            self._counts[name] += n
            if job is not None:
                acct = self._account(job)
                acct.counts[name] = acct.counts.get(name, 0) + n

    def _events(self, device: torch.device) -> tuple:
        """(start, end, stream): a pair of timing events, reused once
        settled, and the device's current stream."""
        try:
            start, end = self._free[device].pop()
        except (KeyError, IndexError):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        return start, end, self._stream(device)

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        """The device's current stream, one object per stream."""
        key = (device.index,
               torch._C._cuda_getCurrentRawStream(device.index))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(device)
        return stream

    def _account(self, job: str) -> _Account:
        """The job's account (the lock held), the oldest pushed out."""
        acct = self._jobs.get(job)
        if acct is None:
            acct = self._jobs[job] = _Account()
            if len(self._jobs) > self._max_jobs:
                self._jobs.popitem(last=False)
                self._counts[DROPPED] += 1
        return acct

    def _keep(self, entry: tuple) -> None:
        if len(self._ring) == self._ring.maxlen:
            self._counts[DROPPED] += 1
        self._ring.append(entry)

    def _close(self, s: Span) -> None:
        with self._lock:
            self._keep((s.t0, s.t1, s.name, s.thread, s.job))
            session = s.attrs.get("session")
            if session is not None and s.name in KEY_INGEST:
                acct_s = self._sessions.setdefault(session, {})
                acct_s[s.name] = acct_s.get(s.name, 0.0) + s.seconds
                self._sessions.move_to_end(session)
                if len(self._sessions) > self._max_jobs:
                    self._sessions.popitem(last=False)
                    self._counts[DROPPED] += 1
            if s.job is None:
                acct = None
            else:
                acct = self._account(s.job)
                if session is not None and s.name in PHASES:
                    acct.session = session
                acct.seconds[s.name] = acct.seconds.get(s.name, 0.0) \
                    + s.seconds
                acct.calls[s.name] = acct.calls.get(s.name, 0) + 1
                if s.name == ROTATION:
                    acct.widths.append(int(s.attrs.get("B", 0)))
            if s.device is None:
                return
            if s._ev is None:   # a CPU device: its host time
                self._place(s, acct, s.t0, s.t1)
                return
            self._pending.append(s)
            if len(self._pending) > self._ring.maxlen:
                del self._pending[0]
                self._counts[DROPPED] += 1

    def _place(self, s: Span, acct: Optional[_Account], t0: int,
               t1: int) -> None:
        """A device span's device interval, host ns (the lock held)."""
        self._keep((t0, t1, s.name, str(s.device), s.job))
        if acct is None:
            return
        ms = (t1 - t0) / 1e6
        if s.name == ROTATION:
            acct.rotation_ms += ms
            acct.first_ns = t0 if acct.first_ns is None else min(
                acct.first_ns, t0)
            acct.last_ns = t1 if acct.last_ns is None else max(
                acct.last_ns, t1)
        elif s.name == KEY_SWITCH:
            acct.key_switch_ms += ms

    def settle(self, device: torch.device) -> None:
        """Take the finished device spans of ``device``.  Call it right
        after a ``torch.cuda.synchronize`` of the device: the reference
        event it records and waits for there finds the stream idle."""
        if device.type != "cuda":
            return
        with self._lock:
            mine = [s for s in self._pending if s.device == device]
        if not mine:
            return
        stream = self._stream(device)
        ref = torch.cuda.Event(enable_timing=True)
        t_rec = time.perf_counter_ns()
        ref.record(stream)
        ref.synchronize()
        t_ref = time.perf_counter_ns()
        # a span ended before the reference was recorded has finished: on
        # this stream the reference follows it, on another its end event
        # says so
        done = [s for s in mine if s.t1 < t_rec
                and (s._ev[2] is stream or s._ev[1].query())]
        with self._lock:
            gone = {id(s) for s in done}
            self._pending = [s for s in self._pending if id(s) not in gone]
            self._settled.append((ref, t_ref, done))
            self._waiting += len(done)
            while self._waiting > self._ring.maxlen:
                _, _, old = self._settled.popleft()
                self._waiting -= len(old)
                self._counts[DROPPED] += len(old)

    def _read_settled(self) -> None:
        """Place the settled device spans on the unix clock: their events
        read against their reference event."""
        with self._lock:
            batches, self._settled = self._settled, collections.deque()
            self._waiting = 0
        placed = [(s, t_ref - round(s._ev[0].elapsed_time(ref) * 1e6),
                   t_ref - round(s._ev[1].elapsed_time(ref) * 1e6))
                  for ref, t_ref, done in batches for s in done]
        with self._lock:
            for s, t0, t1 in placed:
                free = self._free.setdefault(s.device, [])
                if len(free) < self._ring.maxlen:
                    free.append(s._ev[:2])
                s._ev = None
                acct = None if s.job is None else self._account(s.job)
                self._place(s, acct, t0, t1)

    # ---- reading ----

    def job(self, uuid: str) -> Optional[dict]:
        """The job's account (the module says what it holds), or None."""
        self._read_settled()
        with self._lock:
            acct = self._jobs.get(uuid)
            if acct is None:
                return None
            ingest = self._sessions.get(acct.session)
            between = (None if acct.first_ns is None else
                       (acct.last_ns - acct.first_ns) / 1e6
                       - acct.rotation_ms)
            return {
                "session": acct.session,
                "phases": {ph: acct.seconds[name]
                           for name, ph in PHASES.items()
                           if name in acct.seconds},
                "seconds": dict(acct.seconds),
                "calls": dict(acct.calls),
                "counts": dict(acct.counts),
                "rotations": list(acct.widths),
                "rotation_ms": acct.rotation_ms,
                "key_switch_ms": acct.key_switch_ms,
                "between_rotations_ms": between,
                "key_ingest_s": (None if ingest is None
                                 else sum(ingest.values())),
            }

    def spans(self, since: float = 0.0) -> list[tuple]:
        """Raw spans (start, end, name, thread, job), unix seconds,
        starting at ``since`` or later."""
        self._read_settled()
        since_ns = since * 1e9 - self._offset
        off = self._offset
        with self._lock:
            return [((t0 + off) / 1e9, (t1 + off) / 1e9, name, thread, job)
                    for t0, t1, name, thread, job in self._ring
                    if t0 >= since_ns]

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


RECORDER = Recorder()
span = RECORDER.span
begin = RECORDER.begin
count = RECORDER.count
settle = RECORDER.settle
job = RECORDER.job
spans = RECORDER.spans
counters = RECORDER.counters


@contextlib.contextmanager
def job_scope(uuid: str) -> Iterator[None]:
    """Spans and counts of the block belong to job ``uuid``."""
    token = _job.set(uuid)
    try:
        yield
    finally:
        _job.reset(token)


@contextlib.contextmanager
def trace(log_dir: Optional[str],
          device: str | torch.device = "cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (a no-op if it is None or empty).  ``device`` is the device the block
    runs on: on CUDA the card's activity is recorded too, and a profiler
    that cannot record it raises rather than record the host alone.  Like
    every entry point, ``device`` defaults to the card and raises without
    one unless it is ``"cpu"``."""
    if not log_dir:
        yield
        return
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity in this build; "
                "a trace of the host alone would miss the card's kernels")
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield
