"""The share of the profiled sub-window in which no kernel, copy or set
ran on the card, in %."""


def read(run: dict) -> float | None:
    prof = run.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
