from herdsman_tpu_torch.circuit.builder import CircuitBuilder  # noqa: F401
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
