"""Device ms between one blind rotation of a job and the next (the
program's ``bootstrap.rotation`` device spans, ``utils/tracing.job``): per
job, the device time from its first rotation's start to its last one's
end, less the rotations' own, over its rotations less one; the mean over
the window's jobs with two rotations or more."""

from herdsman_tpu_torch.utils import tracing


def read(run: dict) -> float | None:
    job = getattr(tracing, "job", None)   # a program without the recorder
    if job is None:
        return None
    gaps = [acct["between_rotations_ms"] / (len(acct["rotations"]) - 1)
            for acct in (job(j["job_uuid"]) for j in run.get("jobs") or [])
            if acct and len(acct["rotations"]) > 1
            and acct["between_rotations_ms"] is not None]
    return sum(gaps) / len(gaps) if gaps else None
