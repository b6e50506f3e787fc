"""The blind rotations' share of their roofline over the window, in %:
the least time of each call's work (fhebench/roofline.py) summed, over
the CUDA-event time of the same calls summed."""

from fhebench import roofline


def read(run: dict) -> float | None:
    return roofline.share(run)
