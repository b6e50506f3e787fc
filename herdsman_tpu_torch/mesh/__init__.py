"""Multi-device sharding on ``torch.distributed``: the port of
``herdsman_tpu.mesh``."""

from herdsman_tpu_torch.mesh.sharding import (  # noqa: F401
    make_mesh,
    shard_server_key,
    bootstrap_bool_sharded,
    gate_step_sharded,
    pbs_batch_sharded,
    pbs_many_batch_sharded,
)
from herdsman_tpu_torch.mesh.distributed import (  # noqa: F401
    init_multihost,
    make_pod_mesh,
)
