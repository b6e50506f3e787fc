"""Bootstraps a job executes per frame row (JobDescriptor's
bootstraps_executed over its rows), the mean over the window's jobs."""


def read(run: dict) -> float | None:
    jobs = [j for j in run.get("jobs") or [] if j["completed"]]
    if not jobs:
        return None
    return sum(j["bootstraps"] / j["rows"] for j in jobs) / len(jobs)
