"""The 90th percentile (nearest rank) of the window's job latencies, from
schedule_job to the output frame downloaded, over all clients; a failed
job counts as missing every limit: its latency reads 1e9 s (JSON holds
no infinity)."""

import math


def read(run: dict) -> float | None:
    jobs = run.get("jobs")
    if not jobs:
        return None
    lat = sorted(j["t_done"] - j["t_submit"] if j["completed"] else 1e9
                 for j in jobs)
    return lat[math.ceil(0.9 * len(lat)) - 1]
