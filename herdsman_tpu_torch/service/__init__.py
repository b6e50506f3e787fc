from herdsman_tpu_torch.service.errors import (  # noqa: F401
    ObjectAlreadyExistsException,
    ObjectNotFoundException,
    ResourceLockedException,
)
from herdsman_tpu_torch.service.config import Config, load_config  # noqa: F401
from herdsman_tpu_torch.service.session import SessionService  # noqa: F401
from herdsman_tpu_torch.service.keystore import KeyService  # noqa: F401
from herdsman_tpu_torch.service.storage import StorageService  # noqa: F401
from herdsman_tpu_torch.service.execution import (  # noqa: F401
    ExecutionService,
    JobStatus,
)
from herdsman_tpu_torch.service.auth import AuthService  # noqa: F401
from herdsman_tpu_torch.service.coordinator import Coordinator  # noqa: F401
