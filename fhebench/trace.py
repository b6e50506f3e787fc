"""What a traced run records: the device time of every blind rotation of
the window, and a profiled sub-window after it.

- ``RotationRecorder`` wraps the program's one entry to a blind rotation,
  ``ops.bootstrap.blind_rotate_batch``, for the window: each call's width
  and the CUDA events around it (the host clock on a CPU device, in
  tests).
- ``profile`` runs a sub-window under ``torch.profiler`` and reduces its
  trace: the union of the device's kernel, copy and set intervals inside
  the sub-window (busy), the sub-window's length, the device operations
  that took most time and the longest idle gaps by what the host was
  doing: the host span that overlapped each gap most, among the profiled
  thread's operators and the spans a driver reports from the program's
  other threads (the coordinator's runner phases).
"""

from __future__ import annotations

import bisect
import json
import pathlib
import time

import torch
from herdsman_tpu_torch.ops import bootstrap as bs

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "fhebench.window"
TOP = 10


class RotationRecorder:
    """Records (width, device ms) of each blind rotation while entered."""

    def __init__(self, device: torch.device):
        self.device = device
        self._calls: list[tuple[int, object, object]] = []

    def __enter__(self):
        self._orig = bs.blind_rotate_batch
        cuda = self.device.type == "cuda"

        def recording(dsk, ct, *a, **kw):
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                out = self._orig(dsk, ct, *a, **kw)
                end.record()
            else:
                start = time.perf_counter()
                out = self._orig(dsk, ct, *a, **kw)
                end = time.perf_counter()
            self._calls.append((int(ct.shape[0]), start, end))
            return out

        bs.blind_rotate_batch = recording
        return self

    def __exit__(self, *exc):
        bs.blind_rotate_batch = self._orig

    def calls(self) -> list[tuple[int, float]]:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            return [(B, s.elapsed_time(e)) for B, s, e in self._calls]
        return [(B, (e - s) * 1e3) for B, s, e in self._calls]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Disjoint, sorted intervals covering the same points."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(events: list[dict], spans=()) -> dict:
    """busy_s, window_s and the breakdown of a Chrome trace's events;
    ``spans`` are further host spans (start, end, label), in microseconds
    from the sub-window's start."""
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") in HOST_CATS]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])

    def clipped(e):
        a = max(w0, float(e["ts"]))
        return a, min(w1, float(e["ts"]) + float(e.get("dur", 0)))

    dev = [(clipped(e), e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS and "dur" in e]
    dev = [(iv, nm) for iv, nm in dev if iv[1] > iv[0]]
    busy = union([iv for iv, _ in dev])
    by_name: dict[str, float] = {}
    for (a, b), nm in dev:
        by_name[nm] = by_name.get(nm, 0.0) + (b - a)
    host = [(clipped(e), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
            and "dur" in e]
    host += [((max(w0, w0 + a), min(w1, w0 + b)), label)
             for a, b, label in spans]
    gaps, reach = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    # each gap's host operator of largest overlap; the gaps are sorted and
    # disjoint, so an operator overlaps a contiguous run of them
    ends = [g1 for _, g1 in gaps]
    best = [(0.0, "host code outside torch operators")] * len(gaps)
    for (a, b), nm in host:
        i = bisect.bisect_right(ends, a)
        while i < len(gaps) and gaps[i][0] < b:
            over = min(b, gaps[i][1]) - max(a, gaps[i][0])
            if over > best[i][0]:
                best[i] = (over, nm)
            i += 1
    by_host: dict[str, float] = {}
    for (g0, g1), (_, label) in zip(gaps, best):
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0)

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(by_host)}}


def profile(fn, device: torch.device, path: pathlib.Path,
            spans=None) -> dict:
    """Run ``fn`` under ``torch.profiler``, keep its Chrome trace at
    ``path`` and reduce it (``reduce_trace``); ``spans()``, called after,
    gives host spans (start, end, label) on ``time.time()``."""
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t_w = time.time()
        with record_function(WINDOW):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    rel = [((a - t_w) * 1e6, (b - t_w) * 1e6, label)
           for a, b, label in (spans() if spans else ())]
    return reduce_trace(json.loads(path.read_text())["traceEvents"], rel)
