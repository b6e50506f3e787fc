"""Seconds of a session's key ingest: the program's
``coordinator.add_key`` and ``coordinator.device_key`` spans
(``utils/tracing.job``'s ``key_ingest_s``), the mean over the sessions of
the window's jobs."""

from herdsman_tpu_torch.utils import tracing


def read(run: dict) -> float | None:
    job = getattr(tracing, "job", None)   # a program without the recorder
    if job is None:
        return None
    ingest = {acct["session"]: acct["key_ingest_s"]
              for acct in (job(j["job_uuid"]) for j in run.get("jobs") or [])
              if acct and acct["key_ingest_s"] is not None}
    return sum(ingest.values()) / len(ingest) if ingest else None
