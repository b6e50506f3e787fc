from herdsman_tpu_torch.compiler.lower import (  # noqa: F401
    circuit_cost,
    compile_circuit,
    evaluate_plain,
    levelize,
)
from herdsman_tpu_torch.compiler.optimizer import optimize_circuit  # noqa: F401
