"""Frame rows carried through the whole plan by the window's completed
jobs, over the window (first submission to the last job's output
downloaded)."""


def read(run: dict) -> float | None:
    jobs = run.get("jobs")
    if not jobs:
        return None
    return sum(j["rows"] for j in jobs if j["completed"]) / run["window_s"]
