"""Seconds a window job waited in the coordinator's queue (the program's
``execution.queue`` spans, ``utils/tracing.job``), the mean over the
window's jobs that have one."""

from herdsman_tpu_torch.utils import tracing


def read(run: dict) -> float | None:
    job = getattr(tracing, "job", None)   # a program without the recorder
    if job is None:
        return None
    waits = [acct["phases"]["queue"]
             for acct in (job(j["job_uuid"]) for j in run.get("jobs") or [])
             if acct and "queue" in acct["phases"]]
    return sum(waits) / len(waits) if waits else None
