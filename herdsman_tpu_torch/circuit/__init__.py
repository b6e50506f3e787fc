from herdsman_tpu_torch.circuit.builder import CircuitBuilder  # noqa: F401
from herdsman_tpu_torch.circuit.dag import DAG  # noqa: F401
from herdsman_tpu_torch.circuit.model import (  # noqa: F401
    Circuit,
    ColumnMeta,
    DataType,
    GateNode,
    GateOp,
    MappingError,
    OutputColumn,
    SchemaType,
)
from herdsman_tpu_torch.circuit.plan import (  # noqa: F401
    ExecutionPlan,
    InputStage,
    MapperStage,
    OutputStage,
    Policy,
    ReduceStage,
)
