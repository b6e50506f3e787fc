"""Profiling and tracing hooks, the port's copy of
``herdsman_tpu.utils.tracing`` on ``torch.profiler`` (SURVEY.md §5 marks
tracing and profiling absent in the reference's coordinator; the only
instrument there is leveled logging).

Two levels:

- ``trace(dir, device)``: a context manager around
  ``torch.profiler.profile``.  It records the host's operators and, on a
  CUDA device, the card's kernels and copies, and writes one Chrome trace
  (``*.pt.trace.json``, which TensorBoard's profiler plugin and Perfetto
  open) into ``dir``.  Wired into job execution via the
  ``logging.profile_dir`` config key: when set, every job writes a trace
  under ``<profile_dir>/<job_uuid>/``.
- ``annotate(name)``: ``torch.profiler.record_function``, a named region
  inside an active trace (cheap when no trace is active).

These complement the counters (per-job tasks, bootstraps and wall time on
``JobDescriptor``; ``utils.bounds``' least times): counters answer "how
fast", traces answer "where did the time go".
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity

from herdsman_tpu_torch.ops.u32 import resolve_device


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


def annotate(name: str):
    """Named region inside an active trace (cheap when not tracing)."""
    return torch.profiler.record_function(name)
