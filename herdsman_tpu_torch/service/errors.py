"""Service-layer exception types (the common_exceptions analogs, reference
src/service/common_exceptions.hpp usage throughout src/service/)."""


class ObjectNotFoundException(KeyError):
    pass


class ObjectAlreadyExistsException(ValueError):
    pass


class ResourceLockedException(RuntimeError):
    pass


class InvalidTokenException(PermissionError):
    pass


class TaskFailedException(RuntimeError):
    """A dispatched task exhausted its per-task retries (or hit a worker
    ERROR).  Terminal at the job level: the reference fails the whole job
    once a task burns RETRY_LIMIT (executor.cpp:158-178) — the job is NOT
    re-queued on top of the per-task retries."""
