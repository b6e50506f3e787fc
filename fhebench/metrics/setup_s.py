"""Seconds from the start of the process to the window's first operation:
import, keys, uploads, the build and the warm-up."""


def read(run: dict) -> float:
    return run["setup_s"]
