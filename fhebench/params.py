"""A configuration's parameter set, on both sides of the comparison."""

from __future__ import annotations

import dataclasses

from herdsman_tpu_torch.core import PARAM_SETS
from herdsman_tpu_torch.core.params import TFHEParams

from fhebench.reference import tfhe


def parameter_sets(cfg: dict, override: dict | None = None):
    """(the program's set, the reference's ``Params``) of the configuration
    ``cfg``, both built from the numbers the configuration states.

    The program's set is registered under the configuration's set name, as
    a deployment registers the set its keys name (the coordinator looks a
    key's set up by name); a set of that name that the program already
    holds has to have the numbers the configuration states.  With
    ``override`` (a control), both take its numbers, and the program's set
    is registered under the name with ``_control`` added."""
    numbers = dict(cfg["params"]) | (override or {})
    if override:
        numbers["name"] += "_control"
    fields = {f.name for f in dataclasses.fields(TFHEParams)}
    extra = set(numbers) - fields
    if extra:
        raise ValueError(f"the configuration's set has keys the program's "
                         f"TFHEParams has not: {sorted(extra)}")
    prog = PARAM_SETS.setdefault(numbers["name"], TFHEParams(**numbers))
    for key, value in numbers.items():
        if getattr(prog, key) != value:
            raise ValueError(f"the program's set {prog.name} has {key}="
                             f"{getattr(prog, key)}, the configuration "
                             f"{value}")
    return prog, tfhe.Params.of(numbers)
