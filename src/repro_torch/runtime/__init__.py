"""Runtime layer: executor-backend registry + synchronous serving Session.

Importing this package registers the built-in backends (``baremetal``,
``ref``).
"""

from repro_torch.core.executor import ExecutorCapabilities, ExecResult
from repro_torch.runtime import backends as _backends  # noqa: F401  (registers builtins)
from repro_torch.runtime.registry import backend_names, create as create_executor, \
    register_backend
from repro_torch.runtime.session import Session

__all__ = ["Session", "ExecResult", "ExecutorCapabilities",
           "register_backend", "create_executor", "backend_names"]
