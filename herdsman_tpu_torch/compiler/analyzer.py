"""Execution-plan resource analyzer — parity with the reference
(reference src/execution/execution_plan/execution_plan_analyzer.cpp:6-22):
a plan always requires its schema's key, plus every InputStage's data frame."""

from __future__ import annotations

import dataclasses

from herdsman_tpu_torch.circuit.model import SchemaType
from herdsman_tpu_torch.circuit.plan import ExecutionPlan, InputStage


@dataclasses.dataclass
class ResourceRequirements:
    required_keys: set[SchemaType]
    required_data_frames: set[str]


def analyze_required_resources(plan: ExecutionPlan) -> ResourceRequirements:
    req = ResourceRequirements({plan.schema_type}, set())
    for node in plan.execution_graph:
        if isinstance(node.value, InputStage):
            req.required_data_frames.add(node.value.data_frame_uuid)
    return req
