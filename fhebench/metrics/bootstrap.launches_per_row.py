"""Device operations the host issued one at a time inside the per-step
engines' blind rotations, per frame row: the program's
``bootstrap.step_launches`` counter (``utils/tracing.job``) summed over
the window's completed jobs that have an account, over those jobs' rows.
None where the program has no recorder or the counter is absent or zero
(a rotation engine, or a program that does not count)."""

from herdsman_tpu_torch.utils import tracing

COUNTER = "bootstrap.step_launches"


def read(run: dict) -> float | None:
    job = getattr(tracing, "job", None)   # a program without the recorder
    if job is None:
        return None
    launches = rows = 0
    for j in run.get("jobs") or []:
        acct = job(j["job_uuid"]) if j["completed"] else None
        if acct:
            launches += acct["counts"].get(COUNTER, 0)
            rows += j["rows"]
    return launches / rows if launches else None
