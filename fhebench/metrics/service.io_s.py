"""The coordinator's frame load and store seconds per job (its runner's
phase log), the mean over the window's jobs."""


def read(run: dict) -> float | None:
    ph = [j["phases"] for j in run.get("jobs") or [] if j["phases"]]
    if not ph:
        return None
    return sum(load + store for load, _, store in ph) / len(ph)
